"""The port's training path on the card (marked ``cuda``; skipped without
one): ``python -m pytest -m cuda tests/test_torch_train_card.py``.  It
imports no JAX, which the card's machine does not have; the CPU tests of
the same path against ``repro`` are in ``test_torch_train.py``.

  * both backward kernels against their plain version
    ``flash_attention_backward_torch`` on the same inputs, at S 17, 200 and
    256 (G 4, D 64): the routed call (``kernel.flash_backward_cuda``: the
    tensor-core kernel in bf16, the CUDA-core kernel in f32) and each
    kernel's own wrapper where it takes the dtype (the CUDA-core kernel
    in bf16 too); f32 within 1e-4 of each gradient's largest magnitude
    (sums in another order), bf16 within 4 ulps of it (both round one f32
    sum to bf16); the routed call counts one launch on the dtype's route;
  * two runs of the tensor-core kernel bit-equal (no atomics);
  * ``FlashAttentionFn`` (what ``flash_attention`` takes under autograd on
    the card) against autograd of the plain forward, in f32;
  * both backward kernels at Griffin's heads ((256, 256), G 10, KV 1) with
    a window against the plain version, as above;
  * both backward kernels at (128, 128), at starcoder2-7b's heads (G 9
    over KV 4) and granite-20b's (G 48 over one KV head), S 17, 200 and
    256, without a window and with one of 100 keys, against the plain
    version at the same limits; the routed call counts one launch on its
    route, the tensor-core kernel's two runs are bit-equal, and its output
    with KV head 0's dK zeroed reads above the bf16 limit;
  * both backward kernels non-causal at (64, 64) (seamless-m4t-medium's
    encoder and cross-attention), at its heads (16 over 16) and G 4 (8
    over 2), (B, Sq, Skv) (8, 256, 256), (2, 200, 384), (2, 384, 200) and
    (2, 17, 100), and causal at (192, 128) with MLA's softmax scale
    (deepseek-v3-671b), at its heads (128 over 128) and G 4, (B, S) (8,
    256), (2, 200) and (2, 17), against the plain version at the same
    limits; the routed call counts one launch on its route, the
    tensor-core kernel's two runs are bit-equal; ``FlashAttentionFn`` of
    each form against autograd of the plain forward in f32;
  * the WKV-6 backward kernel (``kernel.wkv6_backward_cuda``) against its
    plain version ``wkv6_backward_torch`` at N 64, f32 (1e-5 of each
    gradient's largest) and bf16 (one ulp of each element plus 1e-5 of the
    largest), with and without s0 and dsT, two runs bit-equal; the smoke
    rwkv6-7b's ``loss_fn`` under autograd has a ``grad_fn`` (``WKV6Fn``)
    and its gradient equals ``impl="torch"``'s (f32, 1e-4 of each leaf's
    largest); ``rglru`` under autograd is
    ``RGLRUFn``, its gradient (the backward kernel) against autograd of
    the plain recurrence in f32 (1e-5 of each gradient's largest), and the
    ``loss_fn`` gradient of Griffin at its published width and the smoke
    depth (window 16) through the kernels against ``impl="torch"`` in f32,
    leaf by leaf within 1e-4 of each leaf's largest.
"""

import math

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention,
    flash_attention_backward_torch,
)
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rwkv6 import ops as rwkv6_ops  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _card_inputs(card, dtype, B, S, H, KV, D=64, seed=0, Dv=None, Skv=None):
    # q (B, S, H, D), k (B, Skv, KV, D), v (B, Skv, KV, Dv), dO (B, S, H,
    # Dv); Dv and Skv default to D and S
    Dv, Skv = Dv or D, Skv or S
    g = torch.Generator(device=card).manual_seed(seed)
    return [torch.randn(*s, generator=g, device=card).to(dtype)
            for s in ((B, S, H, D), (B, Skv, KV, D), (B, Skv, KV, Dv),
                      (B, S, H, Dv))]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("routed", "float32"), ("routed", "bfloat16"), ("sm90", "bfloat16"),
    ("simple", "float32"), ("simple", "bfloat16")])
@pytest.mark.parametrize("S", [17, 200, 256])
def test_backward_kernel_matches_plain_on_card(card, kernel, dtype, S):
    from repro_torch.kernels.flash_attention import kernel as fk
    dt = getattr(torch, dtype)
    fn = {"routed": fk.flash_backward_cuda,
          "sm90": fk.flash_backward_sm90_cuda,
          "simple": fk.flash_backward_simple_cuda}[kernel]
    q, k, v, do = _card_inputs(card, dt, 2, S, 8, 2)
    o = flash_attention(q, k, v, causal=True)
    fk.reset_launches()
    got = fn(q, k, v, o, do)
    route = fk.pick_backward_route(dt, 64, 64) if kernel == "routed" \
        else kernel
    assert fk.BACKWARD_ROUTES == {"sm90": 0, "simple": 0, route: 1}
    assert fk.LAUNCHES["flash_backward"] == 1
    want = flash_attention_backward_torch(q, k, v, o, do)
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        tol = 1e-4 * scale if dt == torch.float32 else \
            4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
        assert float((g.float() - w.float()).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("S", [17, 200, 256])
def test_backward_sm90_runs_bit_equal_on_card(card, S):
    from repro_torch.kernels.flash_attention import kernel as fk
    q, k, v, do = _card_inputs(card, torch.bfloat16, 2, S, 8, 2, seed=S)
    o = flash_attention(q, k, v, causal=True)
    a = fk.flash_backward_sm90_cuda(q, k, v, o, do)
    b = fk.flash_backward_sm90_cuda(q, k, v, o, do)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_function_grads_match_plain_on_card(card):
    q, k, v, do = (t.requires_grad_(i < 3) for i, t in
                   enumerate(_card_inputs(card, torch.float32, 2, 64, 8, 2)))
    o = flash_attention(q, k, v, causal=True)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = flash_attention(q, k, v, causal=True, impl="torch")
    want = torch.autograd.grad(ref, (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("sm90", "bfloat16"), ("simple", "float32"), ("simple", "bfloat16")])
@pytest.mark.parametrize("S,window", [(256, 64), (200, 50), (130, 2048)])
def test_windowed_backward_matches_plain_on_card(card, kernel, dtype, S,
                                                 window):
    from repro_torch.kernels.flash_attention import kernel as fk
    dt = getattr(torch, dtype)
    fn = {"sm90": fk.flash_backward_sm90_cuda,
          "simple": fk.flash_backward_simple_cuda}[kernel]
    q, k, v, do = _card_inputs(card, dt, 2, S, 10, 1, D=256, seed=S)
    o = flash_attention(q, k, v, causal=True, window=window)
    got = fn(q, k, v, o, do, window=window)
    want = flash_attention_backward_torch(q, k, v, o, do, window=window)
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        tol = 1e-4 * scale if dt == torch.float32 else \
            4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
        assert float((g.float() - w.float()).abs().max()) <= tol


def _within(got, want, dt):
    # (all within the limit, the worst share of it)
    worst = 0.0
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        tol = 1e-4 * scale if dt == torch.float32 else \
            4 * 2.0 ** (math.floor(math.log2(scale)) - 7)
        worst = max(worst, float((g.float() - w.float()).abs().max()) / tol)
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("routed", "bfloat16"), ("routed", "float32"), ("simple", "bfloat16")])
@pytest.mark.parametrize("heads", [(36, 4), (48, 1)])
@pytest.mark.parametrize("S", [17, 200, 256])
@pytest.mark.parametrize("window", [None, 100])
def test_d128_backward_matches_plain_on_card(card, kernel, dtype, heads, S,
                                             window):
    from repro_torch.kernels.flash_attention import kernel as fk
    dt = getattr(torch, dtype)
    fn = {"routed": fk.flash_backward_cuda,
          "simple": fk.flash_backward_simple_cuda}[kernel]
    H, KV = heads
    q, k, v, do = _card_inputs(card, dt, 2, S, H, KV, D=128, seed=S + H)
    o = flash_attention(q, k, v, causal=True, window=window)
    fk.reset_launches()
    got = fn(q, k, v, o, do, window=window)
    route = fk.pick_backward_route(dt, 128, 128) if kernel == "routed" \
        else kernel
    assert fk.BACKWARD_ROUTES == {"sm90": 0, "simple": 0, route: 1}
    want = flash_attention_backward_torch(q, k, v, o, do, window=window)
    assert _within(got, want, dt) <= 1.0
    if route == "sm90":
        again = fk.flash_backward_sm90_cuda(q, k, v, o, do, window=window)
        for x, y in zip(got, again):
            assert torch.equal(x, y)
        # the control: KV head 0's dK zeroed reads above the limit
        bad = got[1].clone()
        bad[:, :, 0] = 0
        assert _within([bad], [want[1]], dt) > 1.0


@pytest.mark.cuda
def test_recurrences_raise_under_grad_on_card(card):
    # The name is kept from when this held the raise; it now holds that
    # wkv6 under autograd on the card is WKV6Fn, whose gradient matches
    # autograd of the plain loop
    r, k, v = (torch.randn(1, 4, 2, 16, device=card, requires_grad=True)
               for _ in range(3))
    w = torch.rand(1, 4, 2, 16, device=card)
    u = torch.randn(2, 16, device=card)
    out, _ = rwkv6_ops.wkv6(r, k, v, w, u)
    assert out.grad_fn is not None and "WKV6Fn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out.sum(), (r, k, v))
    ref, _ = rwkv6_ops.wkv6(r, k, v, w, u, impl="torch")
    want = torch.autograd.grad(ref.sum(), (r, k, v))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [4, 300])
def test_rglru_grads_match_plain_on_card(card, T):
    g = torch.Generator(device=card).manual_seed(T)
    la = (-0.5 * torch.exp(torch.randn(2, T, 32, device=card, generator=g))
          ).requires_grad_(True)
    gx, h0 = (torch.randn(*s, device=card, generator=g).requires_grad_(True)
              for s in ((2, T, 32), (2, 32)))
    dh = torch.randn(2, T, 32, device=card, generator=g)
    h, hT = rglru_ops.rglru(la, gx, h0)
    assert h.grad_fn is not None and "RGLRUFn" in type(h.grad_fn).__name__
    got = torch.autograd.grad((h * dh).sum() + hT.sum(), (la, gx, h0))
    hr, hTr = rglru_ops.rglru(la, gx, h0, impl="torch")
    want = torch.autograd.grad((hr * dh).sum() + hTr.sum(), (la, gx, h0))
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_griffin_loss_grads_match_plain_on_card(card):
    # Griffin's heads (the smoke config's head dim 32 has no backward
    # kernel) at the smoke depth, its window cut to 16 so that it bites
    import dataclasses
    cfg = tconfigs.get("recurrentgemma-2b")
    tm = build_model(dataclasses.replace(
        cfg, n_layers=tconfigs.smoke("recurrentgemma-2b").n_layers,
        local_window=16))
    params = tm.init(torch.Generator(device=card).manual_seed(0), card)
    leaves = [p.float() for p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    from repro_torch.models.params import tree_unflatten, tree_flatten
    tree = tree_unflatten(tree_flatten(params)[1], leaves)
    tokens = torch.randint(0, tm.cfg.vocab_size, (2, 24), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    grads = {}
    for impl in ("auto", "torch"):
        loss, _ = tm.loss_fn(tree, {"tokens": tokens}, impl=impl)
        grads[impl] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["auto"], grads["torch"]):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_backward_matches_plain_on_card(card, dtype, with_s0):
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6.ref import wkv6_backward_torch
    dt = getattr(torch, dtype)
    g = torch.Generator(device=card).manual_seed(3)
    B, T, H, N = 2, 37, 4, 64
    r, k, v, do = (torch.randn(B, T, H, N, device=card, generator=g)
                   .to(dt) for _ in range(4))
    w = torch.exp(-torch.exp(torch.empty(B, T, H, N, device=card).uniform_(
        -12.0, 6.0, generator=g))).to(dt)
    u = torch.randn(H, N, device=card, generator=g).to(dt)
    s0 = dsT = None
    if with_s0:
        s0, dsT = (torch.randn(B, H, N, N, device=card, generator=g)
                   for _ in range(2))
    wk.reset_launches()
    got = wk.wkv6_backward_cuda(r, k, v, w, u, s0, do, dsT)
    again = wk.wkv6_backward_cuda(r, k, v, w, u, s0, do, dsT)
    assert wk.LAUNCHES["wkv6_backward"] == 2
    want = wkv6_backward_torch(r, k, v, w, u, s0, do, dsT)
    for a, b, c in zip(got, want, again):
        if b is None:
            assert a is None and c is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, c)
        af, bf = a.float(), b.float()
        scale = float(bf.abs().max())
        if a.dtype == torch.float32:
            assert float((af - bf).abs().max()) <= 1e-5 * scale
        else:
            ulp = torch.where(bf == 0, torch.zeros_like(bf), 2.0 ** (
                torch.floor(torch.log2(bf.abs())) - 7))
            assert bool(((af - bf).abs() <= ulp + 1e-5 * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-7b"])
def test_recurrent_loss_raises_under_grad_on_card(card, arch):
    # The name is kept from when this held the raise; it now holds that
    # the smoke rwkv6 (head size 16) trains on the card through WKV6Fn: its
    # loss has a grad_fn and its gradient is impl="torch"'s
    tm = build_model(tconfigs.smoke(arch))
    params = tm.init(torch.Generator(device=card).manual_seed(0), card)
    leaves = [p.float() for p in tree_leaves(params)]
    for p in leaves:
        p.requires_grad_(True)
    from repro_torch.models.params import tree_flatten, tree_unflatten
    tree = tree_unflatten(tree_flatten(params)[1], leaves)
    tokens = torch.randint(0, tm.cfg.vocab_size, (2, 24), device=card,
                           generator=torch.Generator(device=card)
                           .manual_seed(1))
    grads = {}
    for impl in ("auto", "torch"):
        loss, _ = tm.loss_fn(tree, {"tokens": tokens}, impl=impl)
        assert loss.grad_fn is not None
        grads[impl] = torch.autograd.grad(loss, leaves)
    for a, b in zip(grads["auto"], grads["torch"]):
        scale = max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= 1e-4 * scale


NONCAUSAL_SHAPES = [(8, 256, 256), (2, 200, 384), (2, 384, 200),
                    (2, 17, 100)]
MLA_SCALE = 192 ** -0.5


def _new_form_case(card, fk, kernel, dtype, heads, shape, form):
    dt = getattr(torch, dtype)
    fn = {"routed": fk.flash_backward_cuda,
          "simple": fk.flash_backward_simple_cuda}[kernel]
    H, KV = heads
    if form == "non-causal":
        B, Sq, Skv = shape
        kw = dict(causal=False, softmax_scale=None)
        q, k, v, do = _card_inputs(card, dt, B, Sq, H, KV, Skv=Skv,
                                   seed=Sq + 3 * Skv + H)
        dims = (64, 64)
    else:
        B, S = shape
        kw = dict(causal=True, softmax_scale=MLA_SCALE)
        q, k, v, do = _card_inputs(card, dt, B, S, H, KV, D=192, Dv=128,
                                   seed=S + H)
        dims = (192, 128)
    o = flash_attention(q, k, v, **kw)
    fk.reset_launches()
    got = fn(q, k, v, o, do, **kw)
    route = fk.pick_backward_route(dt, *dims, causal=kw["causal"]) \
        if kernel == "routed" else kernel
    assert fk.BACKWARD_ROUTES == {"sm90": 0, "simple": 0, route: 1}
    assert fk.LAUNCHES["flash_backward"] == 1
    want = flash_attention_backward_torch(q, k, v, o, do, **kw)
    assert _within(got, want, dt) <= 1.0
    if route == "sm90":
        again = fk.flash_backward_sm90_cuda(q, k, v, o, do, **kw)
        for x, y in zip(got, again):
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("routed", "bfloat16"), ("routed", "float32"), ("simple", "bfloat16")])
@pytest.mark.parametrize("heads", [(16, 16), (8, 2)])
@pytest.mark.parametrize("shape", NONCAUSAL_SHAPES)
def test_noncausal_backward_matches_plain_on_card(card, kernel, dtype,
                                                  heads, shape):
    from repro_torch.kernels.flash_attention import kernel as fk
    _new_form_case(card, fk, kernel, dtype, heads, shape, "non-causal")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,dtype", [
    ("routed", "bfloat16"), ("routed", "float32"), ("simple", "bfloat16")])
@pytest.mark.parametrize("heads", [(128, 128), (8, 2)])
@pytest.mark.parametrize("shape", [(8, 256), (2, 200), (2, 17)])
def test_mla_backward_matches_plain_on_card(card, kernel, dtype, heads,
                                            shape):
    from repro_torch.kernels.flash_attention import kernel as fk
    _new_form_case(card, fk, kernel, dtype, heads, shape, "(192, 128)")


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["non-causal", "(192, 128)"])
def test_new_form_function_grads_match_plain_on_card(card, form):
    if form == "non-causal":
        kw = dict(causal=False)
        ins = _card_inputs(card, torch.float32, 2, 200, 8, 2, Skv=384)
    else:
        kw = dict(causal=True, softmax_scale=MLA_SCALE)
        ins = _card_inputs(card, torch.float32, 2, 200, 8, 2, D=192, Dv=128)
    q, k, v, do = (t.requires_grad_(i < 3) for i, t in enumerate(ins))
    o = flash_attention(q, k, v, **kw)
    assert o.grad_fn is not None and "FlashAttentionFn" in \
        type(o.grad_fn).__name__
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = flash_attention(q, k, v, impl="torch", **kw)
    want = torch.autograd.grad(ref, (q, k, v), do)
    assert _within(got, want, torch.float32) <= 1.0
