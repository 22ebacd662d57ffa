"""Plain PyTorch oracle for GQA attention (materializes the full scores).

The counterpart of ``repro.kernels.flash_attention.ref.attention_ref``:
O(S²) memory, ``-inf`` masking, non-finite probabilities zeroed (a fully
masked row gives 0), the denominator floored at 1e-30.
"""

from __future__ import annotations

import torch


def attention_ref(
    q: torch.Tensor,         # (B, Sq, H, D)
    k: torch.Tensor,         # (B, Skv, KV, D)
    v: torch.Tensor,         # (B, Skv, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_start=0,
    kv_len=None,
    softmax_scale: float | None = None,
) -> torch.Tensor:
    """O(S^2)-memory reference.  ``q_start``: absolute position of q[0]
    (decode: cache length).  ``kv_len``: #valid cache entries (rest masked).
    Either may be an int or a 0-d integer tensor (a position on the
    device), which the mask is built from; either also a ``(B,)``
    integer tensor, a position or a length per batch row.
    """
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]                 # may differ from D (e.g. MLA: 192 vs 128)
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else D ** -0.5

    qh = q.reshape(B, Sq, KV, G, D).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qh, kf) * scale

    dev = q.device
    if not torch.is_tensor(q_start):
        q_start = int(q_start)
    if torch.is_tensor(q_start) and q_start.dim() == 1:
        q_start = q_start.reshape(-1, 1, 1)               # a row's own
    qpos = q_start + torch.arange(Sq, device=dev)[:, None]   # (1|B,) Sq, 1
    kpos = torch.arange(Skv, device=dev)[None, :]            # (1, Skv)
    mask = torch.ones((1, Sq, Skv), dtype=torch.bool, device=dev)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if torch.is_tensor(kv_len) and kv_len.dim() == 1:
        kv_len = kv_len.reshape(-1, 1, 1)                 # a row's own
    if kv_len is not None:
        mask = mask & (kpos < (kv_len if torch.is_tensor(kv_len)
                               else int(kv_len)))
    scores = torch.where(mask[:, None, None], scores, -torch.inf)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    p = torch.where(torch.isfinite(scores), p, 0.0)
    denom = p.sum(-1, keepdim=True)
    p = p / torch.clamp(denom, min=1e-30)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
    return out.reshape(B, Sq, H, Dv).to(q.dtype)
