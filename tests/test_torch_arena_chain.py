"""The split of the fused chain write that the CUDA chain_write kernel runs,
on the CPU.

The kernel (``chain_write_kernel`` in ``csrc/arena.cu``) cannot run here;
what surrounds it can:

  * a plain emulation of its body (``copy_plan`` of the arena's and x's
    byte addresses: head and tail floats one by one, float4 stores at
    16-byte-aligned arena addresses, x loaded at its phase as one aligned
    vector or two joined by a word select, the chain applied to each lane
    by the canonical callables) equals the port's
    ``arena_chain_write_torch`` and ``repro``'s ``arena_chain_write(...,
    impl="xla")`` bit for bit for the exact chains (allclose to both and
    to ``arena_chain_write_ref`` for the rest), at
    every (arena, x) byte phase pair mod 16 that f32 allows, at lengths
    0-20 and those of the main paths, and at the offsets of the fused
    ``darts_net_x6`` chains; it touches nothing outside the slice;
  * the fused ``darts_net_x6`` execute makes 42 chain writes, 30 of
    ``("bn", "relu")`` and 12 of ``("bn",)``, all exact ops (the
    ``randwire_net_32x8`` execute makes none);
  * ``impl="cuda"`` on a CPU arena raises and launches nothing.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.kernels.arena as ja  # noqa: E402
from repro.kernels.arena import ref as jref  # noqa: E402
from repro_torch.kernels import arena as ta  # noqa: E402
from repro_torch.kernels.arena import kernel as tk  # noqa: E402
from repro_torch.kernels.arena import ref as tref  # noqa: E402
from repro_torch.kernels.arena.elemwise import (  # noqa: E402
    EXACT_OPS,
    apply_chain,
)

RTOL, ATOL = 1e-5, 1e-6           # transcendentals of two libraries
LENGTHS = list(range(21)) + [4097, 150528]
CHAINS = [("bn", "relu"), ("bn",), ("relu", "bn", "relu", "bn"),
          ("bn", "scale", "bias_add", "relu6"), ("gelu", "silu", "tanh"),
          ("sigmoid",), ()]


def _fused_chains(name):
    """(arena byte offset, floats, ops) of every chain write one fused
    execute of the full network ``name`` makes."""
    import repro_torch as rt
    from repro_torch.core.executor import compile_plan
    from repro_torch.graphs import FULL_NETWORKS

    p = rt.plan(FULL_NETWORKS[name](), rt.PlanConfig())
    prog = compile_plan(p.graph, p.order, p.arena, fuse=True, device="cpu")
    return [(p.arena.offset_of(tail), p.graph.sizes[tail] // 4, ops)
            for _, ops, tail in prog._groups.values()]


def emulate_chain(mem, dst, src, n, ops):
    """The kernel's chain write of ``n`` floats from byte ``src`` to byte
    ``dst`` of the byte array ``mem`` (index 0 is 16-aligned)."""
    p = tk.copy_plan(dst, src, 4 * n)
    assert p.head % 4 == 0 and p.tail % 4 == 0 and p.phase % 4 == 0
    out = mem.copy()

    def chain(words):
        v = torch.from_numpy(np.ascontiguousarray(words).view("<f4"))
        return apply_chain(v, ops).numpy().view(np.uint8)

    def edge(at_dst, at_src, m):
        for k in range(m):           # one float a thread
            w = mem[at_src + 4 * k:at_src + 4 * k + 4].view("<u4")
            out[at_dst + 4 * k:at_dst + 4 * k + 4] = chain(w)

    edge(dst, src, p.head // 4)
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
        for lane in range(4):                    # the chain on each lane
            col = chain(xs[:, lane].copy()).view("<u4")
            body = out[d:d + 16 * p.nvec].view("<u4").reshape(-1, 4)
            body[:, lane] = col
    t = 4 * n - p.tail
    edge(dst + t, src + t, p.tail // 4)
    return out


def _check(rng, dst_phase, src_phase, n, ops, offset=None):
    """One chain write of n floats with the arena's slice at ``dst_phase``
    and x at ``src_phase`` (bytes mod 16), both in one byte array."""
    if offset is None:
        offset = (16 + dst_phase) // 4           # 16 B of guard
    alen = offset + n + 4
    x0 = -(-(4 * alen) // 16) * 16 + 16 + src_phase
    vals = (3 * rng.standard_normal((x0 + 4 * n + 32) // 4)).astype("<f4")
    mem = vals.view(np.uint8).copy()
    arena = mem[:4 * alen].view("<f4")
    x = mem[x0:x0 + 4 * n].view("<f4")
    got = emulate_chain(mem, 4 * offset, x0, n, ops)
    want = tref.arena_chain_write_torch(torch.from_numpy(arena.copy()),
                                        torch.from_numpy(x.copy()), offset,
                                        ops)
    got_f = got[:4 * alen].view("<f4")
    xla = np.asarray(ja.arena_chain_write(jnp.asarray(arena), jnp.asarray(x),
                                          offset, ops, impl="xla"))
    if set(ops) <= EXACT_OPS:
        np.testing.assert_array_equal(got[:4 * alen],
                                      want.numpy().view(np.uint8))
        np.testing.assert_array_equal(got_f, xla)
    else:
        # torch's CPU transcendentals round differently in vector and
        # scalar code, so an edge float and a body lane may differ by ulps
        np.testing.assert_allclose(got_f, want.numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got_f, xla, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(
            got_f, jref.arena_chain_write_ref(arena, x, offset, ops),
            rtol=RTOL, atol=ATOL)
    assert (got[4 * alen:] == mem[4 * alen:]).all()   # x and beyond
    assert (got[:4 * offset] == mem[:4 * offset]).all()


@pytest.mark.parametrize("ops", CHAINS)
@pytest.mark.parametrize("src_phase", [0, 4, 8, 12])
@pytest.mark.parametrize("dst_phase", [0, 4, 8, 12])
def test_emulated_chain_matches_references(dst_phase, src_phase, ops):
    rng = np.random.default_rng(dst_phase * 16 + src_phase + len(ops))
    for n in LENGTHS:
        _check(rng, dst_phase, src_phase, n, ops)


@pytest.mark.parametrize("src_phase", [0, 4, 8, 12])
def test_emulated_chain_at_the_darts_offsets(src_phase):
    rng = np.random.default_rng(200 + src_phase)
    for off_bytes, n, ops in _fused_chains("darts_net_x6")[::5]:
        assert off_bytes % 4 == 0
        _check(rng, off_bytes % 16, src_phase, n, ops,
               offset=off_bytes // 4)


def test_darts_fused_chains_are_pinned():
    chains = _fused_chains("darts_net_x6")
    assert len(chains) == 42                      # per fused execute
    assert Counter(ops for _, _, ops in chains) == {("bn", "relu"): 30,
                                                    ("bn",): 12}
    assert all(set(ops) <= EXACT_OPS for _, _, ops in chains)
    assert _fused_chains("randwire_net_32x8") == []


def test_cuda_impl_on_a_cpu_arena_raises():
    arena, x = torch.zeros(64), torch.ones(5)
    tk.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        ta.arena_chain_write(arena, x, 3, ("bn", "relu"), impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.arena_chain_write_cuda(arena, x, 3, ("bn", "relu"))
    assert tk.LAUNCHES["chain_write"] == 0
