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

``wkv6_tiled_torch`` computes the same function in the CUDA kernel's
decomposition (``csrc/wkv6.cu``), with its tile, row split and chunk from
``kernel.py``: each tile of columns walks all steps on its own, chunk by
chunk; a step's bonus is the in-order sums of ``BONUS_SPLIT`` runs of
consecutive rows merged by a butterfly, and a column's output its row
groups' FMA sums merged by a butterfly.  Its state
is bit-equal to ``wkv6_ref``'s and its outputs agree to f32 rounding.

The gradient.  ``wkv6_backward_torch`` is the plain version of the
backward kernel (``csrc/wkv6_backward.cu``): given the forward's inputs and
the gradients ``do`` of the output and ``dsT`` of the final state, the
states ``S_{t-1}`` are recomputed forward in f32 as the forward rounds them
and the state's adjoint ``G`` runs back from ``G = dsT``:

    dr_t = S_{t-1} do_t + u k_t (v_t . do_t)
    dk_t = G_t v_t + u r_t (v_t . do_t)
    dv_t = G_t^T k_t + b_t do_t                (b_t = (r_t u) . k_t)
    dw_t = rowsum(G_t * S_{t-1})
    G_{t-1} = diag(w_t) G_t + r_t do_t^T,   ds0 = G_{-1}
    du = sum over batch and time of r_t k_t (v_t . do_t)

The kernel sums in another order (per-thread FMA chains merged by
butterflies), so the card holds it to this version within a limit, not
bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.rwkv6.kernel import (
    BONUS_SPLIT,
    CHUNK,
    ROW_SPLIT,
    tile_cols,
)

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


def _fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as ``__fmaf_rn`` (the product is
    exact in f64; the sum is rounded there and again to f32, which differs
    from one rounding only at a tie of the second)."""
    return (a.double() * b.double() + c.double()).float()


def _butterfly(x, masks):
    """Each lane of the last dim adds its partner ``lane ^ m`` for each
    mask in turn, as ``__shfl_xor_sync`` merges do (every lane ends with
    the same sum)."""
    idx = torch.arange(x.shape[-1], device=x.device)
    for m in masks:
        x = x + x[..., idx ^ m]
    return x


def wkv6_tiled_torch(r, k, v, w, u, initial_state=None, state_out=None):
    """``wkv6_ref``'s function in the CUDA kernel's decomposition; returns
    ``(out (B,T,H,N) in r's dtype, state (B,H,N,N) f32)``."""
    B, T, H, N = r.shape
    jt, R = tile_cols(N), ROW_SPLIT
    rt_ = N // R                             # rows a thread
    rf, kf, vf, wf = (x.to(f32) for x in (r, k, v, w))
    uf = u.to(f32)
    S0 = (torch.zeros((B, H, N, N), dtype=f32, device=r.device)
          if initial_state is None else initial_state.to(f32))
    S_out = torch.empty((B, H, N, N), dtype=f32, device=r.device)
    out = torch.empty((B, T, H, N), dtype=f32, device=r.device)
    bs = BONUS_SPLIT
    split_masks = [1 << q for q in range(bs.bit_length() - 1)]
    for j0 in range(0, N, jt):               # one block's columns
        S = S0[..., j0:j0 + jt].clone()      # (B, H, N, jt)
        for t0 in range(0, T, CHUNK):
            cs = min(CHUNK, T - t0)
            # the chunk's bonuses: lane l sums (r u) k over its N / bs
            # consecutive rows in order, then the lanes merge
            prod = ((rf[:, t0:t0 + cs] * uf) * kf[:, t0:t0 + cs]).view(
                B, cs, H, bs, N // bs)
            p = torch.zeros((B, cs, H, bs), dtype=f32, device=r.device)
            for m in range(N // bs):
                p = p + prod[..., m]
            bon = _butterfly(p, split_masks)[..., 0]         # (B, cs, H)
            for s in range(cs):
                t = t0 + s
                rt, kt, wt = rf[:, t], kf[:, t], wf[:, t]    # (B, H, N)
                vt = vf[:, t, :, j0:j0 + jt]                  # (B, H, jt)
                Sg = S.view(B, H, R, rt_, jt)
                rg = rt.view(B, H, R, rt_)
                a = torch.zeros((B, H, R, jt), dtype=f32, device=r.device)
                for m in range(rt_):
                    a = _fma(rg[..., m, None], Sg[:, :, :, m], a)
                masks = [1 << q for q in range(R.bit_length() - 1)]
                tot = _butterfly(a.transpose(-1, -2), masks)[..., 0]
                out[:, t, :, j0:j0 + jt] = tot + bon[:, s, :, None] * vt
                S = wt[..., None] * S + kt[..., None] * vt[..., None, :]
        S_out[..., j0:j0 + jt] = S
    if state_out is not None:
        S_out = state_out.copy_(S_out)
    return out.to(r.dtype), S_out


def _states(kf, vf, wf, s0, B, H, N, device):
    """The f32 state entering each step, ``(B, T, H, N, N)``: s0 (zeros
    when None), then each step's ``w S + k v`` as the forward rounds it."""
    T = kf.shape[1]
    S = (torch.zeros((B, H, N, N), dtype=f32, device=device)
         if s0 is None else s0.to(f32))
    Sp = torch.empty((B, T, H, N, N), dtype=f32, device=device)
    for t in range(T):
        Sp[:, t] = S
        S = wf[:, t, ..., None] * S + kf[:, t, ..., None] * \
            vf[:, t, :, None, :]
    return Sp


def wkv6_backward_torch(r, k, v, w, u, s0, do, dsT=None):
    """The WKV-6 gradient in plain torch: the reverse scan, given ``do``
    ``(B, T, H, N)`` (in r's dtype) and ``dsT`` ``(B, H, N, N)`` (f32, or
    None: zero), the gradients of :func:`wkv6_ref`'s two outputs.  Returns
    ``(dr, dk, dv, dw in r's dtype, du in u's dtype, ds0 f32 or None when
    s0 is None)``; the states are recomputed forward in f32."""
    B, T, H, N = r.shape
    rf, kf, vf, wf, dof = (x.to(f32) for x in (r, k, v, w, do))
    uf = u.to(f32)
    Sp = _states(kf, vf, wf, s0, B, H, N, r.device)
    G = (torch.zeros((B, H, N, N), dtype=f32, device=r.device)
         if dsT is None else dsT.to(f32))
    vdo = (vf * dof).sum(-1)                             # (B, T, H)
    bonus = (rf * uf * kf).sum(-1)
    dr, dk, dv, dw = (torch.empty((B, T, H, N), dtype=f32, device=r.device)
                      for _ in range(4))
    for t in range(T - 1, -1, -1):
        S = Sp[:, t]
        dr[:, t] = torch.einsum("bhij,bhj->bhi", S, dof[:, t]) \
            + uf * kf[:, t] * vdo[:, t, :, None]
        dk[:, t] = torch.einsum("bhij,bhj->bhi", G, vf[:, t]) \
            + uf * rf[:, t] * vdo[:, t, :, None]
        dv[:, t] = torch.einsum("bhij,bhi->bhj", G, kf[:, t]) \
            + bonus[:, t, :, None] * dof[:, t]
        dw[:, t] = (G * S).sum(-1)
        G = wf[:, t, ..., None] * G + rf[:, t, ..., None] * \
            dof[:, t, :, None, :]
    du = (rf * kf * vdo[..., None]).sum((0, 1))
    return (*(x.to(r.dtype) for x in (dr, dk, dv, dw)), du.to(u.dtype),
            None if s0 is None else G)
