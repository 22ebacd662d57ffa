"""The flash backward's route rule, the tensor-core kernel's launch
geometry and its decomposition, on the CPU (``kernels/flash_attention/
kernel.py`` and ``ops.py``; the kernels themselves run on the card only).

  * ``pick_backward_route``: bf16 at (64, 64) takes the tensor-core kernel
    (``csrc/flash_backward_sm90.cu``), f32 the CUDA-core one
    (``csrc/flash_backward.cu``); any other dtype or (D, Dv) raises;
  * ``backward_grid``, ``dq_block`` and ``dkdv_block``: each launch covers
    every (batch row, head, tile) exactly once, the blocks with the most
    tiles to visit issued first;
  * ``backward_smem_bytes`` equals the source's ``kDqSmem`` and
    ``kDkdvSmem`` and stays within a block's 232,448 bytes, and the
    constants of ``kernel.py`` are the source's;
  * every backward wrapper raises on CPU tensors and launches nothing;
  * ``flash_backward_tiled_torch`` (the kernel's two kernels, tile by tile,
    in plain torch) without rounding against ``jax.vjp`` of ``repro``'s
    ``_flash_xla`` (f32, rtol/atol 1e-5, as ``test_torch_train.py`` holds
    the plain backward), and with the kernel's bf16 rounding of P and dS
    within 4 bf16 ulps of each gradient's largest value of
    ``flash_attention_backward_torch`` (the card's limit), at ragged S
    (17, 64, 200) and G 1 and 4, inputs made with numpy from a seed.
"""

import functools
import math
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import _flash_xla  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention_backward_torch,
    flash_backward_tiled_torch,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

SOURCE = fk.CSRC / "flash_backward_sm90.cu"
SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)


def test_pick_backward_route():
    assert fk.pick_backward_route(torch.bfloat16, 64, 64) == "sm90"
    assert fk.pick_backward_route(torch.float32, 64, 64) == "simple"
    for dims in fk.HEAD_DIMS:
        if dims in fk.BACKWARD_HEAD_DIMS:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            with pytest.raises(NotImplementedError, match=r"\(64, 64\)"):
                fk.pick_backward_route(dtype, *dims)
    with pytest.raises(NotImplementedError):
        fk.pick_backward_route(torch.float16, 64, 64)


@pytest.mark.parametrize("B,S,H,KV", [(1, 17, 4, 4), (2, 64, 8, 2),
                                      (2, 200, 8, 2), (8, 256, 32, 8),
                                      (3, 129, 4, 1)])
def test_grids_cover_every_tile_once_heaviest_first(B, S, H, KV):
    n = fk.backward_tiles(S)
    assert (n - 1) * fk.BACKWARD_TILE < S <= n * fk.BACKWARD_TILE
    n_dq, n_dkdv = fk.backward_grid(B, S, H, KV)
    assert (n_dq, n_dkdv) == (n * B * H, n * B * KV)
    G = H // KV
    seen, work = set(), []
    for i in range(n_dq):
        b, h, qt = fk.dq_block(i, B, S, H)
        assert 0 <= b < B and 0 <= h < H and 0 <= qt < n
        seen.add((b, h, qt))
        work.append(qt + 1)                 # key tiles at or before its rows
    assert len(seen) == n_dq
    assert work == sorted(work, reverse=True) and work[0] == n
    seen, work = set(), []
    for i in range(n_dkdv):
        b, kvh, kt = fk.dkdv_block(i, B, S, KV)
        assert 0 <= b < B and 0 <= kvh < KV and 0 <= kt < n
        seen.add((b, kvh, kt))
        work.append(G * (n - kt))           # G heads x query tiles at or after
    assert len(seen) == n_dkdv
    assert work == sorted(work, reverse=True) and work[0] == G * n


def _source_ints():
    text = SOURCE.read_text()
    return text, {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                      text).group(1))
                  for name in ("kThreads", "kTile", "kD", "kDqStages",
                               "kDkdvStages")}


def test_constants_are_the_sources():
    _, got = _source_ints()
    assert got == {"kThreads": 128, "kTile": fk.BACKWARD_TILE,
                   "kD": fk.BACKWARD_HEAD_DIMS[0][0],
                   "kDqStages": fk.BACKWARD_DQ_STAGES,
                   "kDkdvStages": fk.BACKWARD_DKDV_STAGES}
    assert fk.BACKWARD_HEAD_DIMS == ((64, 64),)
    # a tile is whole k-steps of wgmma (16) and one 64-row wgmma M
    assert fk.BACKWARD_TILE == 64


def test_smem_bytes_are_the_sources_and_fit_a_block():
    text, ints = _source_ints()
    ints["kTileBytes"] = ints["kTile"] * ints["kD"] * 2
    ints["kStatBytes"] = 2 * ints["kTile"] * 4
    got = []
    for name in ("kDqSmem", "kDkdvSmem"):
        expr = re.search(rf"constexpr int {name} =\s*([^;]+);", text).group(1)
        for k, val in sorted(ints.items(), key=lambda kv: -len(kv[0])):
            expr = expr.replace(k, str(val))
        assert re.fullmatch(r"[\d\s()+*]+", expr), expr
        got.append(eval(expr))
    assert tuple(got) == fk.backward_smem_bytes()
    for b in got:
        assert b <= SMEM_LIMIT
    # an SM's 228 KB holds the blocks its registers allow: four of the dQ
    # kernel (128 registers a thread), two of the dK/dV kernel
    assert 4 * (got[0] + 1024) <= 228 * 1024
    assert 2 * (got[1] + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_wrappers_raise_on_cpu_tensors(dtype):
    q, o, do = (torch.zeros(1, 64, 4, 64, dtype=dtype) for _ in range(3))
    k, v = (torch.zeros(1, 64, 2, 64, dtype=dtype) for _ in range(2))
    fk.reset_launches()
    for fn in (fk.flash_backward_cuda, fk.flash_backward_sm90_cuda,
               fk.flash_backward_simple_cuda):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(q, k, v, o, do)
    assert fk.LAUNCHES["flash_backward"] == 0
    assert fk.BACKWARD_ROUTES == {"sm90": 0, "simple": 0}


def _inputs(seed, S, G, B=2, KV=2, D=64):
    rng = np.random.default_rng(seed)
    H = KV * G
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


@pytest.mark.parametrize("S", [17, 64, 200])
@pytest.mark.parametrize("G", [1, 4])
def test_tiled_emulation_matches_jax_vjp(S, G):
    qn, kn, vn, don = _inputs(10 * S + G, S, G)
    fx = functools.partial(_flash_xla, causal=True, window=None, q_start=0,
                           kv_len=None, softmax_scale=None, kv_chunk=64,
                           skip_masked_blocks=False)
    out, vjp = jax.vjp(fx, jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = vjp(jnp.asarray(don))
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = torch.from_numpy(np.array(out))
    got = flash_backward_tiled_torch(q, k, v, o, do)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.array(w), rtol=1e-5,
                                   atol=1e-5, err_msg=what)


@pytest.mark.parametrize("S", [17, 64, 200])
@pytest.mark.parametrize("G", [1, 4])
def test_tiled_emulation_rounded_within_card_limit(S, G):
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(10 * S + G + 1, S, G))
    o = attention_ref(q.float(), k.float(), v.float(),
                      causal=True).bfloat16()
    want = flash_attention_backward_torch(q, k, v, o, do)
    got = flash_backward_tiled_torch(q, k, v, o, do, round_bf16=True)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        scale = float(w.float().abs().max())
        tol = 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol, (what, err, tol)
