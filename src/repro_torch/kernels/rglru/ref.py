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
