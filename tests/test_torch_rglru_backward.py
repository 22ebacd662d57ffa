"""The RG-LRU's gradient in the port (``kernels/rglru``), on the CPU.

The backward kernel (``csrc/rglru.cu:rglru_backward_kernel``) runs on the
card only; what it is held against and what surrounds it run here:

  * ``rglru_backward_torch`` (the reverse scan in plain torch, the f32
    carries recomputed) against ``jax.vjp`` of ``repro``'s ``rglru_ref`` and
    of ``repro``'s ``rglru(impl="xla")`` (the associative scan the JAX
    train step differentiates), and against torch's autograd of the
    port's ``rglru_ref``: f32, B 2, T 1, 7, 256 and 300, D 64, with and
    without h0 and dhT, numpy inputs from a seed, each gradient within
    1e-5 of its largest magnitude (sums in another order);
  * ``rglru_backward_chunked_torch`` (the kernel's order: a forward pass
    keeping the carry entering each chunk in dlog_a's first row of the
    chunk, then the chunks in reverse, each chunk's carries walked again
    from its checkpoint) bit-equal to the sequential plain backward, f32
    and bf16 gx, chunks of the kernel's size and ragged ones;
  * the backward kernel's layout against the source: its constants equal
    the wrapper's, every channel owned by one walker lane of one block,
    every (step, channel) of a chunk by one compute thread's cell and one
    copy unit, its shared memory the wrapper's and at most 227 KB (five
    blocks an SM at bf16), a raw slot alive from its copy to its output;
  * ``rglru_backward_cuda`` raises on CPU tensors and launches nothing;
  * ``RGLRUFn`` on a mocked card (the device test answering "on the
    card", the kernel entries the plain versions run without autograd, as
    a ctypes launch is): ``rglru(impl="cuda")`` under autograd returns
    outputs with a ``grad_fn`` whose gradients equal autograd's of the
    plain recurrence, an in-place ``state_out`` under autograd is refused,
    and under ``torch.no_grad()`` the in-place threading serving uses
    still runs.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ops import rglru as jax_rglru  # noqa: E402
from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref  # noqa: E402
from repro_torch.kernels import _grad  # noqa: E402
from repro_torch.kernels.rglru import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru import ops as rops  # noqa: E402
from repro_torch.kernels.rglru.ref import (  # noqa: E402
    rglru_backward_chunked_torch,
    rglru_backward_torch,
    rglru_ref,
)

D = 64


def _inputs(seed, B, T, D, with_h0):
    rng = np.random.default_rng(seed)
    la = (-0.5 * np.exp(rng.standard_normal((B, T, D)))).astype(np.float32)
    gx, dh = (rng.standard_normal((B, T, D)).astype(np.float32)
              for _ in range(2))
    h0 = dhT = None
    if with_h0:
        h0, dhT = (rng.standard_normal((B, D)).astype(np.float32)
                   for _ in range(2))
    return la, gx, h0, dh, dhT


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _close(got, want, what):
    w = np.asarray(want, np.float32)
    scale = max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float32) - w).max())
    assert err <= 1e-5 * scale, (what, err, scale)


@pytest.mark.parametrize("T", [1, 7, 256, 300])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_backward_matches_jax_vjp_and_autograd(T, with_h0):
    la, gx, h0, dh, dhT = _inputs(10 * T + with_h0, 2, T, D, with_h0)
    got = rglru_backward_torch(_t(la), _t(gx), _t(h0), _t(dh), _t(dhT))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    assert (got[2] is None) == (h0 is None)
    cot = (jnp.asarray(dh), jnp.zeros((2, D), jnp.float32)
           if dhT is None else jnp.asarray(dhT))
    wants = {}
    for name, fn in (("rglru_ref", jax_rglru_ref),
                     ("rglru xla", lambda *a: jax_rglru(*a, impl="xla"))):
        prim = (jnp.asarray(la), jnp.asarray(gx)) + (
            () if h0 is None else (jnp.asarray(h0),))
        _, vjp = jax.vjp(fn, *prim)
        wants[name] = [np.asarray(g) for g in vjp(cot)]
    lt, gt = _t(la).requires_grad_(True), _t(gx).requires_grad_(True)
    ht = None if h0 is None else _t(h0).requires_grad_(True)
    h, hT = rglru_ref(lt, gt, ht)
    loss = (h * _t(dh)).sum() + (0 if dhT is None else (hT * _t(dhT)).sum())
    wants["torch autograd"] = [g.numpy() for g in torch.autograd.grad(
        loss, [x for x in (lt, gt, ht) if x is not None])]
    for name, want in wants.items():
        for g, w, what in zip(got, want, ("dlog_a", "dgx", "dh0")):
            _close(g.numpy(), w, f"{what} vs {name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,chunk", [(300, rk.BACKWARD_CHUNK),
                                     (7, rk.BACKWARD_CHUNK), (33, 8),
                                     (256, rk.BACKWARD_CHUNK)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_emulation_bit_equal(dtype, T, chunk, with_h0):
    la, gx, h0, dh, dhT = (_t(a) for a in _inputs(T + chunk, 2, T, D,
                                                   with_h0))
    gx, dh = gx.to(dtype), dh.to(dtype)
    want = rglru_backward_torch(la, gx, h0, dh, dhT)
    got = rglru_backward_chunked_torch(la, gx, h0, dh, dhT, chunk=chunk)
    assert got[1].dtype == dtype
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


def _constexprs(esz):
    """The source's namespace-level ``constexpr int`` constants and
    ``struct BwdSmem``'s, evaluated in order with ``sizeof(T)`` = esz."""
    text = rk.SOURCE.read_text()
    env = {}
    for name, expr in re.findall(r"^constexpr int (\w+) = ([^;]+);", text,
                                 re.M):
        env[name] = eval(expr.replace("/", "//"), {}, dict(env))
    body = text[text.index("struct BwdSmem {"):]
    body = body[:body.index("};")]
    for name, expr in re.findall(r"static constexpr int (\w+) = ([^;]+);",
                                 body):
        expr = expr.replace("(int)sizeof(T)", str(esz)).replace("/", "//")
        env[name] = eval(expr, {}, dict(env))
    return text, env


def test_backward_constants_and_grid_are_the_sources():
    text, env = _constexprs(2)
    assert (env["kChannels"], env["kBwdChunk"], env["kBwdStages"],
            env["kBwdThreads"]) == (rk.CHANNELS, rk.BACKWARD_CHUNK,
                                    rk.BACKWARD_STAGES, rk.BACKWARD_THREADS)
    assert rk.CONSTANTS[4:] == (rk.BACKWARD_CHUNK, rk.BACKWARD_STAGES,
                                rk.BACKWARD_THREADS)
    # a raw slot lives from its copy to its output: the stages in flight,
    # then gated, walked and written
    assert env["kBwdRing"] == rk.BACKWARD_STAGES + 2
    for esz in (2, 4):
        _, e = _constexprs(esz)
        assert e["kBytes"] == rk.backward_smem_bytes(esz) <= 227 * 1024
    # the blocks an SM the registers are bounded for fit its shared memory
    # at bf16 (five: Griffin's 640 blocks in one wave)
    assert env["kBwdBlocksSM"] * (rk.backward_smem_bytes(2) + 1024) \
        <= 228 * 1024
    # the walker warp is warp 0, lane = channel; a compute thread (ct =
    # threadIdx.x - 32) owns the cell (quad ct / 32, channel ct % 32) and
    # copies unit ct (step ct / 4, channels 8 (ct % 4) ..) of each chunk
    assert "const int ch = threadIdx.x, ct = threadIdx.x - 32;" in text
    assert "const int q = ct / kChannels, ch = ct % kChannels;" in text
    assert "const int s = ct / kGroups, e = (ct % kGroups) * kUnit;" in text
    C, W = rk.BACKWARD_CHUNK, rk.CHANNELS
    cells = np.zeros((C, W), np.int64)
    units = np.zeros((C, W), np.int64)
    for ct in range(rk.BACKWARD_THREADS - 32):
        q, ch = divmod(ct, W)
        cells[4 * q:4 * q + 4, ch] += 1
        if ct < env["kBwdUnits"]:
            s, g = divmod(ct, env["kGroups"])
            units[s, g * env["kUnit"]:(g + 1) * env["kUnit"]] += 1
    assert (cells == 1).all() and (units == 1).all()
    # a block a batch row and CHANNELS channels: every channel once
    for B, Dm in ((8, 2560), (1, 2560), (2, 37), (3, 1)):
        seen = np.zeros((B, Dm), np.int64)
        for blk in range(rk.grid(B, Dm)):
            b, d0, d1 = rk.block_channels(blk, Dm)
            lanes = d0 + np.arange(32)
            seen[b, lanes[lanes < Dm]] += 1
            assert d1 - d0 == min(32, Dm - d0)
        assert (seen == 1).all()
    assert "const long long blocks = B * ((D + kChannels - 1) / kChannels);" \
        in text
    for sfx in ("bf16", "f32"):
        assert f"int repro_rglru_backward_{sfx}(" in text


def test_backward_wrapper_raises_on_cpu_tensors():
    la, gx, h0, dh, dhT = (_t(a) for a in _inputs(1, 1, 9, 16, True))
    rk.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rk.rglru_backward_cuda(la, gx, h0, dh, dhT)
    assert rk.LAUNCHES == {"rglru": 0, "rglru_backward": 0}


def _detached(fn):
    def run(*a, **kw):
        with torch.no_grad():
            return fn(*a, **kw)
    return run


@pytest.fixture
def on_card(monkeypatch):
    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    monkeypatch.setattr(rk, "rglru_cuda", _detached(
        lambda la, gx, h0=None, *, state_out=None:
        rglru_ref(la, gx, h0, state_out)))
    monkeypatch.setattr(rk, "rglru_backward_cuda",
                        _detached(rglru_backward_torch))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_on_mocked_card_matches_autograd(on_card, with_h0, dtype):
    la, gx, h0, dh, dhT = (_t(a) for a in _inputs(5, 2, 19, 8, with_h0))
    gx, dh = gx.to(dtype), dh.to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (la, gx, h0)
              if x is not None]
    h, hT = rops.rglru(*leaves, impl="cuda")
    assert h.grad_fn is not None and "RGLRUFn" in type(h.grad_fn).__name__
    loss = (h.float() * dh.float()).sum() + (
        0 if dhT is None else (hT * dhT).sum())
    got = torch.autograd.grad(loss, leaves)
    ref = [x.clone().requires_grad_(True) for x in leaves]
    hr, hTr = rglru_ref(*ref)
    loss_r = (hr.float() * dh.float()).sum() + (
        0 if dhT is None else (hTr * dhT).sum())
    want = torch.autograd.grad(loss_r, ref)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_state_out_under_autograd_refused_and_served_in_place(on_card):
    la, gx, h0, _, _ = (_t(a) for a in _inputs(6, 1, 5, 8, True))
    gxg = gx.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="state_out"):
        rops.rglru(la, gxg, h0, impl="cuda", state_out=h0)
    # serving: no autograd, the cache's h0 threaded in place
    state = h0.clone()
    with torch.no_grad():
        h, hT = rops.rglru(la, gxg, state, impl="cuda", state_out=state)
    want_h, want_hT = rglru_ref(la, gx, h0)
    assert hT is state and torch.equal(state, want_hT)
    assert h.grad_fn is None and torch.equal(h, want_h)
