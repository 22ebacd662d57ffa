"""Plain PyTorch version of the RG-LRU gated linear recurrence (Griffin,
arXiv:2402.19427).

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

where a_t = exp(log_a_t) is the data-dependent per-channel gate computed by
the block (log_a = -c * softplus(Lambda) * sigma(W_a x), c = 8).  The
recurrence consumes precomputed ``log_a`` and gated input ``gx = i_t * x_t``.
Shapes: log_a, gx: (B, T, D); h0: (B, D).

The counterpart of ``repro.kernels.rglru.ref.rglru_ref``: the exact
sequential loop with an f32 carry, each operation rounded in f32 in the
reference's order, which the CUDA kernel repeats without FMA contraction.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def rglru_ref(log_a, gx, h0=None, state_out=None):
    """Returns ``(h (B,T,D) in gx's dtype, hT (B,D) f32)``.  With
    ``state_out`` the final carry is written into it (which may be ``h0``
    itself) and it is returned."""
    B, T, D = log_a.shape
    la = log_a.to(f32)
    a = torch.exp(la)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * la), 0.0, 1.0)) \
        * gx.to(f32)
    h = (torch.zeros((B, D), dtype=f32, device=gx.device)
         if h0 is None else h0.to(f32))
    hs = torch.empty((B, T, D), dtype=f32, device=gx.device)
    for t in range(T):
        h = a[:, t] * h + b[:, t]
        hs[:, t] = h
    if state_out is not None:
        h = state_out.copy_(h)
    return hs.to(gx.dtype), h


def _gates(la, x):
    """The forward's per-element terms in f32, in its order: ``a = exp(la)``,
    ``e2 = exp(2 la)``, ``one_m = 1 - e2``, ``c = sqrt(clip(one_m, 0, 1))``
    and ``b = c x``."""
    a = torch.exp(la)
    e2 = torch.exp(2.0 * la)
    one_m = 1.0 - e2
    c = torch.sqrt(torch.clamp(one_m, 0.0, 1.0))
    return a, e2, one_m, c, c * x


def _carries(a, b, h0, B, D, device):
    """The f32 carry entering each step, ``(B, T, D)``: h0 (zeros when
    None), then each step's ``a h + b`` as the forward rounds it."""
    T = a.shape[1]
    h = (torch.zeros((B, D), dtype=f32, device=device)
         if h0 is None else h0.to(f32))
    hp = torch.empty((B, T, D), dtype=f32, device=device)
    for t in range(T):
        hp[:, t] = h
        h = a[:, t] * h + b[:, t]
    return hp


def _step_grads(g, hp, x, a, e2, one_m, c):
    """dlog_a and dgx (f32) of the steps given their gradients ``g``: the
    terms of torch's autograd of :func:`rglru_ref`, each rounded in f32 in
    this order (the kernel repeats it):

        dgx = g c
        dla = (g h_{t-1}) a + ((-(g x) / (2 c)) e2) 2

    the second term only where ``0 <= 1 - e2 <= 1`` (the clip's gradient:
    0 where it clipped)."""
    dgx = g * c
    da = (g * hp) * a
    dcl = torch.where((one_m >= 0.0) & (one_m <= 1.0),
                      (g * x) / (2.0 * c), 0.0)
    return da + (-dcl * e2) * 2.0, dgx


def rglru_backward_torch(log_a, gx, h0, dh, dhT=None):
    """The RG-LRU's gradient in plain torch: the reverse scan, given ``dh``
    ``(B, T, D)`` (in gx's dtype) and ``dhT`` ``(B, D)`` (f32, or None:
    zero), the gradients of :func:`rglru_ref`'s two outputs.  Returns
    ``(dlog_a f32, dgx in gx's dtype, dh0 f32 or None)``.

    The carries ``h_{t-1}`` are recomputed in f32 from log_a, gx and h0 as
    the forward computes them (not read from its output h, which is bf16 in
    training).  With ``G = dhT`` (or 0) and, from the last step down,
    ``g_t = dh_t + G`` and then ``G = a_t g_t``, each step's dlog_a and
    dgx are :func:`_step_grads`'s and ``dh0`` the last ``G`` (``a_0
    g_0``)."""
    B, T, D = log_a.shape
    la, x = log_a.to(f32), gx.to(f32)
    a, e2, one_m, c, b = _gates(la, x)
    hp = _carries(a, b, h0, B, D, gx.device)
    G = (torch.zeros((B, D), dtype=f32, device=gx.device)
         if dhT is None else dhT.to(f32))
    dhf = dh.to(f32)
    g = torch.empty((B, T, D), dtype=f32, device=gx.device)
    for t in range(T - 1, -1, -1):
        g[:, t] = dhf[:, t] + G
        G = a[:, t] * g[:, t]
    dla, dgx = _step_grads(g, hp, x, a, e2, one_m, c)
    return dla, dgx.to(gx.dtype), (None if h0 is None else G)


def rglru_backward_chunked_torch(log_a, gx, h0, dh, dhT=None, *,
                                 chunk: int = 32):
    """:func:`rglru_backward_torch` in the kernel's order
    (``csrc/rglru.cu:rglru_backward_kernel``): a forward pass over the
    chunks but the last that keeps only the carry entering each chunk, in
    dlog_a's first row of that chunk, then a reverse pass over the chunks
    from the last, each chunk's gates recomputed, its carries walked again
    from its checkpoint, its adjoint walked from its last step down and
    its dlog_a written over its rows (the checkpoint row among them).
    Every element sees the same f32 operations as in
    :func:`rglru_backward_torch`, so the two agree bit for bit."""
    B, T, D = log_a.shape
    la, x = log_a.to(f32), gx.to(f32)
    dla = torch.empty((B, T, D), dtype=f32, device=gx.device)
    dgx = torch.empty((B, T, D), dtype=gx.dtype, device=gx.device)
    h0f = (torch.zeros((B, D), dtype=f32, device=gx.device)
           if h0 is None else h0.to(f32))
    starts = list(range(0, T, chunk))
    h = h0f
    for t0 in starts[:-1]:                              # pass 1
        if t0:
            dla[:, t0] = h
        a, _, _, _, b = _gates(la[:, t0:t0 + chunk], x[:, t0:t0 + chunk])
        for s in range(a.shape[1]):
            h = a[:, s] * h + b[:, s]
    if len(starts) > 1:
        dla[:, starts[-1]] = h
    G = (torch.zeros((B, D), dtype=f32, device=gx.device)
         if dhT is None else dhT.to(f32))
    dhf = dh.to(f32)
    for t0 in reversed(starts):                         # pass 2
        sl = slice(t0, min(T, t0 + chunk))
        a, e2, one_m, c, b = _gates(la[:, sl], x[:, sl])
        h = h0f if t0 == 0 else dla[:, t0].clone()
        hp = torch.empty_like(a)
        for s in range(a.shape[1]):
            hp[:, s] = h
            h = a[:, s] * h + b[:, s]
        g = torch.empty_like(a)
        for s in range(a.shape[1] - 1, -1, -1):
            g[:, s] = dhf[:, t0 + s] + G
            G = a[:, s] * g[:, s]
        dla[:, sl], d = _step_grads(g, hp, x[:, sl], a, e2, one_m, c)
        dgx[:, sl] = d.to(gx.dtype)
    return dla, dgx, (None if h0 is None else G)
