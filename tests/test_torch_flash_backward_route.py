"""The flash backward's route rule, the tensor-core kernel's launch
geometry and its decomposition, on the CPU (``kernels/flash_attention/
kernel.py`` and ``ops.py``; the kernels themselves run on the card only).

  * ``pick_backward_route``: bf16 at (64, 64), (128, 128), (192, 128) and
    (256, 256) causal, and at (64, 64) non-causal, takes the tensor-core
    kernel (``csrc/flash_backward_sm90.cu``), f32 the CUDA-core one
    (``csrc/flash_backward.cu``); any other dtype or (D, Dv) raises;
    ``check_backward`` takes a window (an int >= 1) on a causal call, a
    non-causal call with any Sq and Skv, and refuses the other forms;
  * ``backward_grid``, ``dq_block`` and ``dkdv_block``: each launch covers
    every (batch row, head, tile, column block) exactly once, the blocks
    with the most tiles to visit issued first; with a window,
    ``backward_key_tiles`` and ``backward_query_tiles`` cover each live
    (query tile, key tile) pair once and no dead one, and the order stays
    heaviest first; non-causal, every block visits every tile of the
    other sequence (Sq != Skv, both ragged);
  * ``backward_smem_bytes`` at (64, 64), (128, 128), (192, 128) and (256,
    256) equals the source's
    ``dq_smem`` and ``dkdv_smem`` and stays within a block's 232,448
    bytes, and the constants of ``kernel.py`` are the source's;
  * every backward wrapper raises on CPU tensors and launches nothing;
  * ``flash_backward_tiled_torch`` (the kernel's two kernels, tile by tile,
    in plain torch) without rounding against ``jax.vjp`` of ``repro``'s
    ``_flash_xla`` (f32, rtol/atol 1e-5, as ``test_torch_train.py`` holds
    the plain backward), and with the kernel's bf16 rounding of P and dS
    within 4 bf16 ulps of each gradient's largest value of
    ``flash_attention_backward_torch`` (the card's limit), at ragged S
    (17, 64, 200) and G 1 and 4, inputs made with numpy from a seed; at
    D 128 with starcoder2-7b's G 9 and granite-20b's G 48 over one KV
    head, with and without a window, against the plain backward;
  * the two forms of deepseek-v3-671b's and seamless-m4t-medium's
    training: non-causal with (Sq, Skv) (17, 40), (64, 200) and (200, 64),
    and causal at (192, 128) with MLA's softmax scale: the plain backward
    and the tiled emulation against ``jax.vjp`` of ``_flash_xla`` (1e-5 of
    each gradient's largest), the emulation with the kernel's bf16
    rounding within 4 bf16 ulps of it;
  * with a window (1, 16, 50), at (D, Dv) (16, 16) and (256, 256), G 1
    and 10: the plain backward and the tiled emulation against
    ``jax.vjp`` of ``_flash_xla(window=w)``, each gradient within 1e-5 of
    its largest (at least 1: at window 1, dq and dk are 0 but for
    rounding).
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
    for dims in ((64, 64), (128, 128), (192, 128), (256, 256)):
        assert fk.pick_backward_route(torch.bfloat16, *dims) == "sm90"
        assert fk.pick_backward_route(torch.float32, *dims) == "simple"
    assert fk.BACKWARD_HEAD_DIMS == ((64, 64), (128, 128), (192, 128),
                                     (256, 256))
    assert fk.NONCAUSAL_HEAD_DIMS == ((64, 64),)
    for dtype in (torch.bfloat16, torch.float32):
        assert fk.pick_backward_route(dtype, 64, 64, causal=False) == (
            "sm90" if dtype == torch.bfloat16 else "simple")
    for dims in fk.HEAD_DIMS:
        for causal, ported in ((True, fk.BACKWARD_HEAD_DIMS),
                               (False, fk.NONCAUSAL_HEAD_DIMS)):
            if dims in ported:
                continue
            for dtype in (torch.bfloat16, torch.float32):
                with pytest.raises(NotImplementedError,
                                   match=r"\(64, 64\)"):
                    fk.pick_backward_route(dtype, *dims, causal=causal)
    with pytest.raises(NotImplementedError):
        fk.pick_backward_route(torch.float16, 64, 64)


@pytest.mark.parametrize("B,S,H,KV,D", [(1, 17, 4, 4, 64), (2, 64, 8, 2, 64),
                                        (2, 200, 8, 2, 64),
                                        (8, 256, 32, 8, 64),
                                        (3, 129, 4, 1, 64),
                                        (8, 256, 10, 1, 256),
                                        (1, 300, 10, 1, 256),
                                        (8, 256, 36, 4, 128),
                                        (2, 200, 48, 1, 128)])
def test_grids_cover_every_tile_once_heaviest_first(B, S, H, KV, D):
    n, c = fk.backward_tiles(S), fk.backward_cols(D)
    assert (n - 1) * fk.BACKWARD_TILE < S <= n * fk.BACKWARD_TILE
    assert c * fk.BACKWARD_COLS == D
    n_dq, n_dkdv = fk.backward_grid(B, S, H, KV, D)
    assert (n_dq, n_dkdv) == (n * B * H * c, n * B * KV * c)
    G = H // KV
    seen, work = set(), []
    for i in range(n_dq):
        b, h, qt, col = fk.dq_block(i, B, S, H, D)
        assert 0 <= b < B and 0 <= h < H and 0 <= qt < n and 0 <= col < c
        seen.add((b, h, qt, col))
        work.append(qt + 1)                 # key tiles at or before its rows
    assert len(seen) == n_dq
    assert work == sorted(work, reverse=True) and work[0] == n
    seen, work = set(), []
    for i in range(n_dkdv):
        b, kvh, kt, col = fk.dkdv_block(i, B, S, KV, D)
        assert 0 <= b < B and 0 <= kvh < KV and 0 <= kt < n and 0 <= col < c
        seen.add((b, kvh, kt, col))
        work.append(G * (n - kt))           # G heads x query tiles at or after
    assert len(seen) == n_dkdv
    assert work == sorted(work, reverse=True) and work[0] == G * n


@pytest.mark.parametrize("B,Sq,Skv,H,KV,D", [(8, 256, 256, 16, 16, 64),
                                             (8, 256, 384, 16, 16, 64),
                                             (2, 200, 64, 8, 2, 64),
                                             (2, 17, 100, 8, 2, 64),
                                             (8, 256, 256, 128, 128, 192)])
def test_grids_cover_every_tile_once_sq_ne_skv(B, Sq, Skv, H, KV, D):
    # the dQ grid over Sq's query tiles, the dK/dV grid over Skv's key
    # tiles, each (batch row, head, tile, column block) once: D's column
    # blocks in both (at (192, 128) the dK/dV kernel's third holds dK's
    # columns alone)
    nq, nk, c = fk.backward_tiles(Sq), fk.backward_tiles(Skv), \
        fk.backward_cols(D)
    n_dq, n_dkdv = fk.backward_grid(B, Sq, H, KV, D, Skv=Skv)
    assert (n_dq, n_dkdv) == (nq * B * H * c, nk * B * KV * c)
    got = {fk.dq_block(i, B, Sq, H, D) for i in range(n_dq)}
    assert got == {(b, h, t, col) for b in range(B) for h in range(H)
                   for t in range(nq) for col in range(c)}
    got = {fk.dkdv_block(i, B, Skv, KV, D) for i in range(n_dkdv)}
    assert got == {(b, h, t, col) for b in range(B) for h in range(KV)
                   for t in range(nk) for col in range(c)}


@pytest.mark.parametrize("Sq,Skv", [(17, 40), (64, 200), (200, 64),
                                    (256, 384), (130, 130)])
def test_noncausal_tiles_cover_every_pair_once(Sq, Skv):
    # non-causal: every dQ block visits all of Skv's key tiles, every
    # dK/dV block all of Sq's query tiles, each (query tile, key tile)
    # pair once
    nq, nk = fk.backward_tiles(Sq), fk.backward_tiles(Skv)
    live = {(i, j) for i in range(nq) for j in range(nk)}
    by_dq = [(t, j) for t in range(nq) for j in range(
        *(lambda a, n: (a, a + n))(*fk.backward_key_tiles(
            t, Skv, None, causal=False)))]
    by_dkdv = [(j, t) for t in range(nk) for j in range(
        *(lambda a, n: (a, a + n))(*fk.backward_query_tiles(
            t, Sq, None, causal=False)))]
    for got in (by_dq, by_dkdv):
        assert len(got) == len(set(got)) and set(got) == live


@pytest.mark.parametrize("S,window", [(17, 1), (64, 16), (200, 50),
                                      (256, 2048), (300, 64), (300, 65),
                                      (4096, 2048), (129, None)])
def test_windowed_tiles_cover_each_live_tile_once(S, window):
    n = fk.backward_tiles(S)
    T = fk.BACKWARD_TILE
    w = S if window is None else window
    live = {(q // T, k // T) for q in range(S)
            for k in range(max(0, q - w + 1), q + 1)}
    by_dq, by_dkdv, work_dq, work_dkdv = [], [], [], []
    for t in range(n):
        t0, m = fk.backward_key_tiles(t, S, window)
        by_dq += [(t, j) for j in range(t0, t0 + m)]
        work_dq.append(m)
        q0, m = fk.backward_query_tiles(t, S, window)
        by_dkdv += [(j, t) for j in range(q0, q0 + m)]
        work_dkdv.append(m)
    for got in (by_dq, by_dkdv):
        assert len(got) == len(set(got)) and set(got) == live
    # the kernels' block order stays heaviest first: the dQ grid from the
    # last query tile, the dK/dV grid from key tile 0
    assert work_dq == sorted(work_dq)
    assert work_dkdv == sorted(work_dkdv, reverse=True)


def _source_ints():
    text = SOURCE.read_text()
    ints = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kThreads", "kTile", "kCol")}
    stages = {}
    for d, dv, body in re.findall(r"template <> struct Config<(\d+), "
                                  r"(\d+)> \{\s*static constexpr int "
                                  r"([^;]+);", text):
        kv = dict(x.split("=") for x in body.replace(" ", "").split(","))
        stages[int(d), int(dv)] = (int(kv["kDqStages"]),
                                   int(kv["kDkdvStages"]),
                                   int(kv["kDqBlocks"]))
    return text, ints, stages


def test_constants_are_the_sources():
    _, got, stages = _source_ints()
    assert got == {"kThreads": 128, "kTile": fk.BACKWARD_TILE,
                   "kCol": fk.BACKWARD_COLS}
    assert {d: s[:2] for d, s in stages.items()} == fk.BACKWARD_STAGES
    assert fk.BACKWARD_HEAD_DIMS == tuple(sorted(stages))
    assert fk.SM90_CONSTANTS[:2] == (got["kThreads"], got["kTile"])
    assert len(fk.SM90_CONSTANTS) == 2 + 4 * len(stages)
    # the constants entry reports each pair of BACKWARD_HEAD_DIMS in order
    text = SOURCE.read_text()
    body = text[text.index("void repro_flash_backward_sm90_constants"):]
    pairs = re.findall(r"Config<(\d+), (\d+)>::kDqStages", body)
    assert [tuple(map(int, p)) for p in pairs] == list(fk.BACKWARD_HEAD_DIMS)
    # a tile is whole k-steps of wgmma (16) and one 64-row wgmma M; an
    # accumulator block is 64 columns (n64)
    assert fk.BACKWARD_TILE == fk.BACKWARD_COLS == 64


@pytest.mark.parametrize("D", [64, 128, 256, 192])
def test_smem_bytes_are_the_sources_and_fit_a_block(D):
    # D 192 is MLA's (192, 128); the other pairs have Dv = D
    Dv = 128 if D == 192 else D
    text, ints, stages = _source_ints()
    dq_stages, dkdv_stages, dq_blocks = stages[D, Dv]
    ints.update(kStatBytes=2 * ints["kTile"] * 4,
                **{"tile_bytes<kD>()": ints["kTile"] * D * 2,
                   "tile_bytes<kDv>()": ints["kTile"] * Dv * 2,
                   "Config<kD, kDv>::kDqStages": dq_stages,
                   "Config<kD, kDv>::kDkdvStages": dkdv_stages})
    got = []
    for name in ("dq_smem", "dkdv_smem"):
        expr = re.search(rf"constexpr int {name}\(\) \{{\s*return ([^;]+);",
                         text).group(1)
        for k, val in sorted(ints.items(), key=lambda kv: -len(kv[0])):
            expr = expr.replace(k, str(val))
        assert re.fullmatch(r"[\d\s()+*]+", expr), expr
        got.append(eval(" ".join(expr.split())))
    assert tuple(got) == fk.backward_smem_bytes(D, Dv)
    for b in got:
        assert b <= SMEM_LIMIT
    # an SM's 228 KB holds the blocks its registers allow: at D 64 four of
    # the dQ kernel (128 registers a thread), two of the dK/dV kernel; at
    # D 128 two of each; at (192, 128) and D 256 one of each
    assert dq_blocks == {64: 4, 128: 2, 192: 1, 256: 1}[D]
    dkdv_blocks = 1 if D in (192, 256) else 2
    assert dq_blocks * (got[0] + 1024) <= 228 * 1024
    assert dkdv_blocks * (got[1] + 1024) <= 228 * 1024


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


@pytest.mark.parametrize("S", [17, 200])
@pytest.mark.parametrize("G", [9, 48])
@pytest.mark.parametrize("window", [None, 100])
def test_tiled_emulation_d128_rounded_within_card_limit(S, G, window):
    # (128, 128), at starcoder2-7b's G 9 and granite-20b's G 48 over one KV
    # head, with and without a window: the emulation unrounded within 1e-5
    # of the plain backward's largest, rounded within the card's 4 bf16
    # ulps of it
    qn, kn, vn, don = _inputs(7 * S + G, S, G, B=1, KV=1, D=128)
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = attention_ref(q, k, v, causal=True, window=window)
    want = flash_attention_backward_torch(q, k, v, o, do, window=window)
    got = flash_backward_tiled_torch(q, k, v, o, do, window=window)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        scale = float(w.abs().max())
        assert float((g - w).abs().max()) <= 1e-5 * scale, what
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    ob = attention_ref(q, k, v, causal=True, window=window).bfloat16()
    want = flash_attention_backward_torch(qb, kb, vb, ob, dob, window=window)
    got = flash_backward_tiled_torch(qb, kb, vb, ob, dob, window=window,
                                     round_bf16=True)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        scale = float(w.float().abs().max())
        tol = 4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
        err = float((g.float() - w.float()).abs().max())
        assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("D", [16, 256])
@pytest.mark.parametrize("G", [1, 10])
@pytest.mark.parametrize("S", [17, 64, 200])
@pytest.mark.parametrize("window", [1, 16, 50])
def test_windowed_backward_matches_jax_vjp(D, G, S, window):
    qn, kn, vn, don = _inputs(1000 * window + 10 * S + G, S, G, B=1, KV=1,
                              D=D)
    fx = functools.partial(_flash_xla, causal=True, window=window,
                           q_start=0, kv_len=None, softmax_scale=None,
                           kv_chunk=64, skip_masked_blocks=False)
    out, vjp = jax.vjp(fx, jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = [np.array(w) for w in vjp(jnp.asarray(don))]
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    o = torch.from_numpy(np.array(out))
    for name, fn in (("plain", flash_attention_backward_torch),
                     ("tiled", flash_backward_tiled_torch)):
        got = fn(q, k, v, o, do, window=window)
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
            # at window 1 every row attends to its own key alone: P = 1,
            # dS = 0, and dq and dk are 0 but for rounding, so the scale
            # is at least 1
            scale = max(float(np.abs(w).max()), 1.0)
            err = float(np.abs(g.numpy() - w).max())
            assert err <= 1e-5 * scale, (name, what, err, scale)


def test_check_backward_takes_a_window_only_in_the_training_form():
    q, k, v = (torch.zeros(1, 8, 2, 16) for _ in range(3))
    for w in (1, 4, 100, None):
        fk.check_backward(q, k, v, window=w)
    for bad in (0, -1, 2.5, True):
        with pytest.raises(ValueError, match="window"):
            fk.check_backward(q, k, v, window=bad)
    for kw in (dict(causal=False), dict(q_start=2), dict(kv_len=4)):
        with pytest.raises(NotImplementedError):
            fk.check_backward(q, k, v, window=4, **kw)
    # non-causal: any Sq and Skv, no window; causal: Sq = Skv
    k2, v2 = (torch.zeros(1, 13, 2, 16) for _ in range(2))
    fk.check_backward(q, k2, v2, causal=False)
    fk.check_backward(q, k, v, causal=False)
    with pytest.raises(NotImplementedError):
        fk.check_backward(q, k2, v2, causal=True)
    with pytest.raises(NotImplementedError):
        fk.check_backward(q, k2, v2, causal=False, kv_len=12)


def _vjp_case(seed, B, Sq, Skv, H, KV, D, Dv, causal, scale):
    rng = np.random.default_rng(seed)
    qn, kn, vn, don = (rng.standard_normal(sh).astype(np.float32) for sh in (
        (B, Sq, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv), (B, Sq, H, Dv)))
    fx = functools.partial(_flash_xla, causal=causal, window=None,
                           q_start=0, kv_len=None, softmax_scale=scale,
                           kv_chunk=64, skip_masked_blocks=False)
    out, vjp = jax.vjp(fx, jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = [np.array(w) for w in vjp(jnp.asarray(don))]
    q, k, v, do = (torch.from_numpy(a) for a in (qn, kn, vn, don))
    return (q, k, v, torch.from_numpy(np.array(out)), do), want


# (Sq, Skv, H, KV, D, Dv, causal, softmax scale): seamless-m4t-medium's
# non-causal forms, ragged both ways; MLA's (192, 128) at its scale (nope +
# rope) ** -0.5, G 1 and 4
NEW_FORMS = [(17, 40, 4, 4, 64, 64, False, None),
             (64, 200, 8, 2, 64, 64, False, None),
             (200, 64, 8, 2, 64, 64, False, None),
             (17, 17, 4, 4, 192, 128, True, 192 ** -0.5),
             (130, 130, 8, 2, 192, 128, True, 192 ** -0.5)]


@pytest.mark.parametrize("form", NEW_FORMS)
@pytest.mark.parametrize("name", ["plain", "tiled"])
def test_new_forms_match_jax_vjp(form, name):
    Sq, Skv, H, KV, D, Dv, causal, scale = form
    args, want = _vjp_case(Sq + 3 * Skv + D, 1, Sq, Skv, H, KV, D, Dv,
                           causal, scale)
    fn = {"plain": flash_attention_backward_torch,
          "tiled": flash_backward_tiled_torch}[name]
    got = fn(*args, softmax_scale=scale, causal=causal)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-5 * float(np.abs(w).max()), (what, err)


@pytest.mark.parametrize("form", NEW_FORMS)
def test_new_forms_tiled_rounded_within_card_limit(form):
    # the emulation with the kernel's bf16 rounding of P and dS against
    # jax.vjp of _flash_xla: within 4 bf16 ulps of each gradient's largest
    Sq, Skv, H, KV, D, Dv, causal, scale = form
    args, want = _vjp_case(Sq + 3 * Skv + D + 1, 1, Sq, Skv, H, KV, D, Dv,
                           causal, scale)
    got = flash_backward_tiled_torch(*args, softmax_scale=scale,
                                     causal=causal, round_bf16=True)
    for g, w, what in zip(got, want, ("dq", "dk", "dv")):
        scale_w = float(np.abs(w).max())
        tol = 4 * 2.0 ** (math.floor(math.log2(scale_w)) - 7)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, (what, err, tol)
