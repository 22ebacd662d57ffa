"""The CUDA WKV-6 kernel's decomposition, on the CPU.

The kernel (``csrc/wkv6.cu``) cannot run here.  ``wkv6_tiled_torch``
repeats its decomposition in plain PyTorch, with the tile, row split and
chunk that ``kernels/rwkv6/kernel.py`` exports and the kernel is built
with.  On numpy inputs from a seed it is held:

  * against the port's ``wkv6_ref``: final states bit-equal, outputs
    within ``chip_smoke.py``'s phase-4 bound (the flash tolerances plus
    2 (N + 1) 2^-24 times the output's summed magnitudes);
  * against ``repro``'s ``wkv6_ref`` within ``test_torch_rwkv6.py``'s
    tolerances (f32 1e-5; bf16 one ulp of the output + 1e-5);
at B 2, N 16 and 64, T 1, 7 and 1000 (both ragged against the chunk).
A run split at a step that is no chunk boundary, or one step at a time,
the state threaded, is bit-equal to the whole run, outputs included.  The grid rule covers every
(b, h, column) once, and the constants are the source's.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wk  # noqa: E402
from repro_torch.kernels.rwkv6.ref import wkv6_ref, wkv6_tiled_torch  # noqa: E402

TOL32 = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, T, H, N, dtype=jnp.float32):
    """numpy inputs as test_torch_rwkv6.py draws them, rounded to
    ``dtype`` by JAX; returns the JAX arrays, their float32 numpy values
    and a float32 initial state."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, N))))
    u = 0.5 * rng.standard_normal((H, N))
    jx = [jnp.asarray(a, jnp.float32).astype(dtype) for a in (r, k, v, w, u)]
    s0 = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return jx, [np.array(a, np.float32) for a in jx], s0


def _bf16_ulp(x):
    _, e = np.frexp(x)
    return np.ldexp(np.ones_like(x), e - 8)


def _within_phase4_bound(got, want, mag, N):
    """chip_smoke.py's wkv6_err: the flash tolerance plus the rounding
    bound of two f32 sums of N + 1 terms taken in different orders."""
    a, b = got.float().numpy(), want.float().numpy()
    slack = 2 * (N + 1) * 2.0 ** -24 * mag.float().numpy()
    if got.dtype == torch.float32:
        allowed = 1e-5 + 1e-5 * np.abs(b) + slack
    else:
        allowed = _bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + 1e-5 + slack
    return bool(np.all(np.abs(a - b) <= allowed))


CASES = [(N, T) for N in (16, 64) for T in (1, 7, 1000)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,T", CASES)
def test_tiled_against_both_refs(N, T, dtype):
    B, H = 2, 2
    tdt = getattr(torch, dtype)
    jx, nx, s0 = _inputs(N * 1000 + T, B, T, H, N, getattr(jnp, dtype))
    r, k, v, w, u = (torch.from_numpy(a).to(tdt) for a in nx)
    s0t = torch.from_numpy(s0)
    o, s = wkv6_tiled_torch(r, k, v, w, u, s0t)
    assert o.dtype == tdt and s.dtype == torch.float32
    # the port's plain version: the state to the bit
    ow, sw = wkv6_ref(r, k, v, w, u, s0t)
    assert torch.equal(s, sw)
    mag = wkv6_ref(r.abs(), k.abs(), v.abs(), w, u.abs(), s0t.abs())[0]
    assert _within_phase4_bound(o, ow, mag, N)
    # repro's: the tolerances of test_torch_rwkv6.py
    jo, js = jax_wkv6_ref(*jx, jnp.asarray(s0))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL32)
    if tdt == torch.float32:
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL32)
    else:
        g, wj = o.float().numpy(), np.asarray(jo, np.float32)
        assert np.all(np.abs(g - wj) <= _bf16_ulp(
            np.maximum(np.abs(g), np.abs(wj))) + 1e-5)


@pytest.mark.parametrize("N", [16, 64])
def test_tiled_without_initial_state(N):
    _, nx, _ = _inputs(5, 2, 9, 3, N)
    xs = [torch.from_numpy(a) for a in nx]
    o, s = wkv6_tiled_torch(*xs)
    ow, sw = wkv6_ref(*xs)
    assert torch.equal(s, sw)
    np.testing.assert_allclose(o.numpy(), ow.numpy(), **TOL32)


@pytest.mark.parametrize("T,cut", [(37, 18), (1000, 500), (7, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_run_is_bit_equal(T, cut, dtype):
    _, nx, s0 = _inputs(T + cut, 2, T, 2, 64)
    r, k, v, w, u = (torch.from_numpy(a).to(dtype) for a in nx)
    s0 = torch.from_numpy(s0)
    o, s = wkv6_tiled_torch(r, k, v, w, u, s0)
    o1, s1 = wkv6_tiled_torch(r[:, :cut], k[:, :cut], v[:, :cut],
                              w[:, :cut], u, s0)
    o2, s2 = wkv6_tiled_torch(r[:, cut:], k[:, cut:], v[:, cut:],
                              w[:, cut:], u, s1, state_out=s1)
    assert s2 is s1
    assert torch.equal(s2, s)
    assert torch.equal(torch.cat([o1, o2], 1), o)


@pytest.mark.parametrize("N", [16, 64])
def test_one_step_a_run_is_bit_equal(N):
    # the kernel's one-step (decode) launches merge their sums in the
    # same order as its chunks: a run one step at a time equals the whole
    _, nx, s0 = _inputs(11 + N, 2, 7, 2, N)
    r, k, v, w, u = (torch.from_numpy(a).to(torch.bfloat16) for a in nx)
    s_step = torch.from_numpy(s0)
    o, s = wkv6_tiled_torch(r, k, v, w, u, s_step)
    outs = []
    for t in range(7):
        o_t, s_step = wkv6_tiled_torch(r[:, t:t + 1], k[:, t:t + 1],
                                       v[:, t:t + 1], w[:, t:t + 1], u,
                                       s_step)
        outs.append(o_t)
    assert torch.equal(s_step, s)
    assert torch.equal(torch.cat(outs, 1), o)


@pytest.mark.parametrize("B,H", [(1, 64), (2, 3), (4, 1)])
@pytest.mark.parametrize("N", wk.HEAD_SIZES)
def test_grid_covers_every_column_once(B, H, N):
    jt = wk.tile_cols(N)
    assert N % jt == 0 and N % wk.ROW_SPLIT == 0
    assert (jt * wk.ROW_SPLIT) % 32 == 0          # whole warps a block
    seen = np.zeros((B, H, N), np.int64)
    for blk in range(wk.grid(B, H, N)):
        b, h, j0, j1 = wk.block_tile(blk, H, N)
        assert j1 - j0 == jt
        seen[b, h, j0:j1] += 1
    assert (seen == 1).all()


def test_rwkv6_7b_grid_fills_the_card():
    # 64 heads of 64 at batch 1: 256 blocks, about two on each of 132 SMs
    assert wk.grid(1, 64, 64) == 256


def test_constants_are_the_sources():
    text = wk.SOURCE.read_text()
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
           for name in ("kTileCols", "kRowSplit", "kChunk", "kBonusSplit")}
    assert got == {"kTileCols": wk.TILE_COLS, "kRowSplit": wk.ROW_SPLIT,
                   "kChunk": wk.CHUNK, "kBonusSplit": wk.BONUS_SPLIT}
