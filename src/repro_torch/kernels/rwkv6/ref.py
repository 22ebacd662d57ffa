"""Plain PyTorch version of the RWKV-6 (Finch) WKV recurrence.

The counterpart of ``repro.kernels.rwkv6.ref.wkv6_ref``: an exact
sequential loop in f32.  Per head (key dim N, value dim N), with
data-dependent per-channel decay w_t in (0,1)^N and bonus u in R^N
(arXiv:2404.05892):

    out_t = r_t @ S_{t-1}  +  ((r_t * u) . k_t) * v_t
    S_t   = diag(w_t) @ S_{t-1} + k_t^T v_t

Shapes: r,k,v,w: (B, T, H, N); u: (H, N); state: (B, H, N, N).  The state
update is spelled ``w * S + k * v`` (two products and a sum, each rounded
in f32), which the CUDA kernel repeats without FMA contraction, so the
final states agree to the bit.
"""

from __future__ import annotations

import torch

f32 = torch.float32


def wkv6_ref(r, k, v, w, u, initial_state=None, state_out=None):
    """Returns ``(out (B,T,H,N) in r's dtype, state (B,H,N,N) f32)``.  With
    ``state_out`` the final state is written into it (which may be
    ``initial_state`` itself) and it is returned."""
    B, T, H, N = r.shape
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    S = (torch.zeros((B, H, N, N), dtype=f32, device=r.device)
         if initial_state is None else initial_state.to(f32))
    out = torch.empty((B, T, H, N), dtype=f32, device=r.device)
    for t in range(T):
        rt, kt, vt, wt = rf[:, t], kf[:, t], vf[:, t], wf[:, t]
        inter = torch.einsum("bhn,bhnm->bhm", rt, S)
        bonus = (rt * uf * kt).sum(-1)
        out[:, t] = inter + bonus[..., None] * vt
        S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
    if state_out is not None:
        S = state_out.copy_(S)
    return out.to(r.dtype), S
