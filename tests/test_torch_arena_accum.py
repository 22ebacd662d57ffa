"""The split of the arena accumulate that the CUDA accum kernel runs, on
the CPU.

The kernel (``accum_kernel`` in ``csrc/arena.cu``) cannot run here; what
surrounds it can:

  * a plain emulation of its body (``copy_plan`` of the arena's and x's
    byte addresses: head and tail floats one by one, float4
    read-modify-writes at 16-byte-aligned arena addresses, x loaded at its
    phase as one aligned vector or two joined by a word select, four f32
    adds a vector) equals the port's ``arena_accum_torch`` and ``repro``'s
    ``arena_accum_ref`` bit for bit, at every (arena, x) byte phase pair
    mod 16 that f32 allows, at lengths 0-70 and those of the main paths;
    it reads no 16-byte block of x that holds none of x's bytes and
    touches nothing outside the slice;
  * every accumulation of the ``darts_net_x6`` executor takes whole
    floats in its split (head, tail and phase multiples of 4 bytes);
  * ``impl="cuda"`` on a CPU arena raises and launches nothing.
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
# 4097 and the DARTS feature map (28 x 28 x 48) as in chip_smoke.py's sweep
LENGTHS = list(range(71)) + [4097, 150528]


def _darts_accums():
    """(arena byte offset, floats) of every accumulation one slice execute
    of ``darts_net_x6`` makes: its rewritten partial convs with an alias."""
    import repro_torch as rt
    from repro_torch.graphs import FULL_NETWORKS

    p = rt.plan(FULL_NETWORKS["darts_net_x6"](), rt.PlanConfig())
    g = p.graph
    return [(p.arena.offset_of(u), g.sizes[u] // 4) for u in p.order
            if g.nodes[u].op == "partial_conv" and g.nodes[u].alias_preds]


def emulate_accum(mem, dst, src, n):
    """The kernel's accumulate of ``n`` floats at byte ``src`` into byte
    ``dst`` of the byte array ``mem`` (index 0 is 16-aligned).  Asserts
    that every 16-byte block of x it loads holds a byte of x."""
    p = tk.copy_plan(dst, src, 4 * n)
    assert p.head % 4 == 0 and p.tail % 4 == 0 and p.phase % 4 == 0
    out = mem.copy()

    def f32(a, i, m):
        return a[i:i + 4 * m].view("<f4")

    def add(at_dst, at_src, m):
        out[at_dst:at_dst + 4 * m] = (f32(mem, at_dst, m)
                                      + f32(mem, at_src, m)).view(np.uint8)

    add(dst, src, p.head // 4)
    d, s = dst + p.head, src + p.head
    if p.nvec:
        assert d % 16 == 0
        if p.phase == 0:
            xs = mem[s:s + 16 * p.nvec].view("<u4").reshape(-1, 4)
        else:
            sa = s - p.phase                     # aligned down
            assert sa % 16 == 0 and sa <= s < sa + 16
            assert sa + 16 * p.nvec < src + 4 * n
            words = mem[sa:sa + 16 * (p.nvec + 1)].view("<u4").reshape(-1, 4)
            ab = np.concatenate([words[:-1], words[1:]], axis=1)   # a:b
            W = p.phase // 4                     # join<W>, bits 0
            xs = ab[:, W:W + 4]
        arena = mem[d:d + 16 * p.nvec].view("<f4").reshape(-1, 4)
        body = arena + np.ascontiguousarray(xs).view("<f4")
        out[d:d + 16 * p.nvec] = body.reshape(-1).view(np.uint8)
    t = 4 * n - p.tail
    add(dst + t, src + t, p.tail // 4)
    return out


def _check(rng, dst_phase, src_phase, n, offset=None):
    """One accumulate of n floats with the arena's slice at ``dst_phase``
    and x at ``src_phase`` (bytes mod 16), both in one byte array."""
    if offset is None:
        offset = (16 + dst_phase) // 4           # 16 B of guard
    alen = offset + n + 4
    x0 = -(-(4 * alen) // 16) * 16 + 16 + src_phase
    vals = rng.standard_normal((x0 + 4 * n + 32) // 4).astype("<f4")
    mem = vals.view(np.uint8).copy()
    arena = mem[:4 * alen].view("<f4")
    x = mem[x0:x0 + 4 * n].view("<f4")
    got = emulate_accum(mem, 4 * offset, x0, n)
    want = tref.arena_accum_torch(torch.from_numpy(arena.copy()),
                                  torch.from_numpy(x.copy()), offset)
    np.testing.assert_array_equal(got[:4 * alen],
                                  want.numpy().view(np.uint8))
    np.testing.assert_array_equal(
        got[:4 * alen], jref.arena_accum_ref(arena, x, offset).view(np.uint8))
    assert (got[4 * alen:] == mem[4 * alen:]).all()   # x and beyond
    assert (got[:4 * offset] == mem[:4 * offset]).all()


@pytest.mark.parametrize("src_phase", [0, 4, 8, 12])
@pytest.mark.parametrize("dst_phase", [0, 4, 8, 12])
def test_emulated_accum_matches_references(dst_phase, src_phase):
    rng = np.random.default_rng(dst_phase * 16 + src_phase)
    for n in LENGTHS:
        _check(rng, dst_phase, src_phase, n)


@pytest.mark.parametrize("src_phase", [0, 4, 8, 12])
def test_emulated_accum_at_the_darts_offsets(src_phase):
    rng = np.random.default_rng(100 + src_phase)
    accums = _darts_accums()
    assert len(accums) == 18                      # per slice execute
    for off_bytes, n in accums:
        assert off_bytes % 4 == 0
        _check(rng, off_bytes % 16, src_phase, n, offset=off_bytes // 4)


def test_darts_accums_split_into_whole_floats():
    fresh = BASE + (1 << 30)                      # x: a fresh tensor
    for off_bytes, n in _darts_accums():
        p = tk.copy_plan(BASE + off_bytes, fresh, 4 * n)
        assert p.head % 4 == 0 and p.tail % 4 == 0 and p.phase % 4 == 0
        assert p.head + 16 * p.nvec + p.tail == 4 * n
        assert p.mode in ("aligned", "word_shift")


def test_cuda_impl_on_a_cpu_arena_raises():
    arena, x = torch.zeros(64), torch.ones(5)
    tk.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ta.arena_accum(arena, x, 3, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.arena_accum_cuda(arena, x, 3)
    assert tk.LAUNCHES["accum"] == 0
