"""The split of the arena copy (``copy_plan``) that the CUDA write and read
kernels run, on the CPU.

The kernel cannot run here; what surrounds it can:

  * ``copy_plan`` covers ``[0, nbytes)`` exactly once, head < 16 and tail
    < 16 bytes, with every store of the body 16-byte aligned, at every
    (destination, source) phase mod 16 and lengths of 0-70 bytes and
    those of the main paths;
  * a plain emulation of the kernel's body on bytes (aligned 16-byte
    loads joined by the funnel shift of ``csrc/arena.cu``) equals the
    port's ``arena_write_torch`` / ``arena_read_torch`` and ``repro``'s
    ``arena_write_ref`` / ``arena_read_ref`` on the same numpy inputs, and
    reads no 16-byte block that holds no source byte;
  * the served decode-state leaves of the full ``llama3.2-1b``,
    ``rwkv6-7b`` and ``recurrentgemma-2b`` plans, and the f32 slices of
    the full paper networks, take a word-phased vector mode;
  * ``impl="cuda"`` on a CPU arena raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.kernels.arena import ref as jref  # noqa: E402
from repro_torch.kernels import arena as ta  # noqa: E402
from repro_torch.kernels.arena import kernel as tk  # noqa: E402
from repro_torch.kernels.arena import ref as tref  # noqa: E402

# a base address as the CUDA caching allocator hands them out (512-aligned)
BASE = 0x7F12_3456_0000
LLAMA_LEAF = 17_301_504     # 16 layers x 1056 x 8 KV heads x 64 x bf16
NBYTES = list(range(71)) + [4097 * 4, 150528 * 4, LLAMA_LEAF]


@pytest.mark.parametrize("dst_phase", range(16))
def test_copy_plan_covers_each_byte_once(dst_phase):
    dst = BASE + dst_phase
    for src_phase in range(16):
        src = BASE + 4096 + src_phase
        for nbytes in NBYTES:
            p = tk.copy_plan(dst, src, nbytes)
            assert 0 <= p.head < 16 and 0 <= p.tail < 16 and p.nvec >= 0
            assert p.head + 16 * p.nvec + p.tail == nbytes
            assert p.nvec == 0 or (dst + p.head) % 16 == 0
            # the head stops at the first aligned address, so the body is
            # as long as it can be
            assert p.head == min(-dst % 16, nbytes)
            assert p.phase == (src - dst) % 16
            if nbytes <= 70:
                cover = np.zeros(nbytes, np.int64)
                cover[:p.head] += 1
                cover[p.head:p.head + 16 * p.nvec] += 1
                cover[nbytes - p.tail:] += 1
                assert (cover == 1).all()


def _funnelshift_r(lo, hi, bits):
    return ((hi.astype(np.uint64) << np.uint64(32) | lo) >> np.uint64(bits)) \
        & np.uint64(0xFFFFFFFF)


def emulate_copy(mem, dst, src, nbytes):
    """The kernel's copy on a byte array ``mem`` whose index is the address
    mod anything (index 0 is 16-aligned): head bytes, the body's 16-byte
    stores built as ``csrc/arena.cu`` builds them, tail bytes.  Asserts
    that every 16-byte block it loads holds a byte of the source."""
    p = tk.copy_plan(dst, src, nbytes)
    out = mem.copy()
    out[dst:dst + p.head] = mem[src:src + p.head]
    d, s = dst + p.head, src + p.head
    if p.nvec and p.phase == 0:
        out[d:d + 16 * p.nvec] = mem[s:s + 16 * p.nvec]
    elif p.nvec:
        sa = s - p.phase                       # aligned down
        # the first and the last block loaded hold source bytes
        assert sa % 16 == 0 and sa <= s < sa + 16
        assert sa + 16 * p.nvec < src + nbytes
        words = mem[sa:sa + 16 * (p.nvec + 1)].view("<u4").reshape(-1, 4)
        w = np.concatenate([words[:-1], words[1:]], axis=1)   # a:b
        k, bits = p.phase >> 2, 8 * (p.phase & 3)
        body = np.stack([_funnelshift_r(w[:, k + j], w[:, k + j + 1], bits)
                         for j in range(4)], axis=1).astype("<u4")
        out[d:d + 16 * p.nvec] = body.reshape(-1).view(np.uint8)
    t = nbytes - p.tail
    out[dst + t:dst + nbytes] = mem[src + t:src + nbytes]
    return out


def _case(rng, dtype, dst_phase, src_phase, n):
    """(mem, arena at, offset, x at) in bytes: an arena whose slice at
    ``offset`` elements has ``dst_phase`` and an ``x`` at ``src_phase``,
    in one byte array."""
    esz = np.dtype(dtype).itemsize
    offset = (16 + dst_phase) // esz               # 16 B of guard
    src = -(-(48 + n * esz) // 16) * 16 + 16 + src_phase
    mem = rng.integers(0, 256, src + n * esz + 32, dtype=np.uint8)
    return mem, 0, offset, src


@pytest.mark.parametrize("n", [0, 1, 3, 15, 16, 17, 63, 64, 65, 4097])
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_emulated_write_and_read_match_references(dtype, n):
    esz = np.dtype(dtype).itemsize
    rng = np.random.default_rng(n * 3 + esz)
    for dst_phase in range(0, 16, esz):
        for src_phase in range(0, 16, esz):
            mem, a0, offset, x0 = _case(rng, dtype, dst_phase, src_phase, n)
            alen = offset + n + 16 // esz
            arena = mem[a0:a0 + alen * esz].view(dtype)
            x = mem[x0:x0 + n * esz].view(dtype)
            # write: arena + offset <- x
            got = emulate_copy(mem, a0 + offset * esz, x0, n * esz)
            got_arena = got[a0:a0 + alen * esz].view(dtype)
            want = tref.arena_write_torch(torch.from_numpy(arena.copy()),
                                          torch.from_numpy(x.copy()), offset)
            np.testing.assert_array_equal(got_arena.view(np.uint8),
                                          want.numpy().view(np.uint8))
            np.testing.assert_array_equal(
                got_arena.view(np.uint8),
                jref.arena_write_ref(arena, x, offset).view(np.uint8))
            assert (got[alen * esz:] == mem[alen * esz:]).all()
            # read: x's bytes <- arena + offset (x stands for out)
            got = emulate_copy(mem, x0, a0 + offset * esz, n * esz)
            got_out = got[x0:x0 + n * esz]
            want = tref.arena_read_torch(torch.from_numpy(arena.copy()),
                                         offset, n)
            np.testing.assert_array_equal(got_out,
                                          want.numpy().view(np.uint8))
            np.testing.assert_array_equal(
                got_out, jref.arena_read_ref(arena, offset, n).view(np.uint8))
            assert (got[:x0] == mem[:x0]).all()
            assert (got[x0 + n * esz:] == mem[x0 + n * esz:]).all()


# each full config's decode plan is the one chip_smoke.py serves
SERVED = {"llama3.2-1b": 1056, "rwkv6-7b": 1056, "recurrentgemma-2b": 2592}


@pytest.mark.parametrize("arch", sorted(SERVED))
def test_served_leaves_take_a_vector_mode(arch):
    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.params import is_def, tree_leaves
    from repro_torch.models.zoo import build_model

    model = build_model(configs.get(arch))
    plan = S.plan_decode_arena(model, 1, SERVED[arch])
    defs = tree_leaves(model.make_cache_defs(1, SERVED[arch]), is_leaf=is_def)
    assert len(defs) == plan["n_cache"]
    leaf_base = BASE + (1 << 30)      # a fresh leaf or out: 512-aligned
    for i, d in enumerate(defs):
        o = plan["plan"].offset_of(i)
        nbytes = int(np.prod(d.shape)) * d.dtype.itemsize
        for p in (tk.copy_plan(BASE + o, leaf_base, nbytes),     # write
                  tk.copy_plan(leaf_base, BASE + o, nbytes)):    # read
            assert p.mode in ("aligned", "word_shift")


@pytest.mark.parametrize("net", ["darts_net_x6", "randwire_net_32x8"])
def test_executor_slices_take_a_word_mode(net):
    import repro_torch as rt
    from repro_torch.graphs import FULL_NETWORKS

    p = rt.plan(FULL_NETWORKS[net](), rt.PlanConfig())
    g = p.graph
    for u in p.order:
        o = p.arena.offset_of(u)          # bytes; the executor's f32
        assert o % 4 == 0                 # element offset is o // 4
        for plan in (tk.copy_plan(BASE + o, BASE + (1 << 30), g.sizes[u]),
                     tk.copy_plan(BASE + (1 << 30), BASE + o, g.sizes[u])):
            assert plan.mode in ("aligned", "word_shift")


@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8])
@pytest.mark.parametrize("op", ["write", "read"])
def test_cuda_impl_on_a_cpu_arena_raises(op, dtype):
    arena, x = torch.zeros(64, dtype=dtype), torch.ones(5, dtype=dtype)
    tk.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        if op == "write":
            ta.arena_write(arena, x, 3, impl="cuda")
        else:
            ta.arena_read(arena, 3, 5, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if op == "write":
            tk.arena_write_cuda(arena, x, 3)
        else:
            tk.arena_read_cuda(arena, 3, 5)
    assert tk.LAUNCHES[op] == 0
