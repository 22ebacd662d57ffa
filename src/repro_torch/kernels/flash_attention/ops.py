"""Public attention op: impl dispatch + the plain chunked PyTorch version.

``flash_attention(..., impl=...)``:

  * ``"auto"``  -- the CUDA kernel for tensors on the card, ``"torch"``
                   for tensors on the CPU;
  * ``"cuda"``  -- the CUDA kernel (``csrc/flash_attention.cu``); raises
                   for a tensor on the CPU;
  * ``"torch"`` -- chunked online-softmax loop over KV chunks in plain
                   PyTorch: O(S·C) memory, a line-for-line counterpart of
                   ``repro``'s ``_flash_xla`` (the plain version the kernel
                   is held against; the CPU path);
  * ``"ref"``   -- the O(S²) oracle (tests only).

No environment variable changes the choice: a CUDA tensor under
``"auto"`` launches the kernel or raises; it never falls back.
``q_start`` and ``kv_len`` are host integers (the serving loop keeps the
decode position on the host).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

IMPLS = ("auto", "cuda", "torch", "ref")

_NEG_INF = -1e30


def _pick_impl(impl: str, q) -> str:
    if impl == "auto":
        return "cuda" if q.is_cuda else "torch"
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; expected one of "
                         f"{IMPLS}")
    return impl


def flash_attention(
    q: torch.Tensor,                    # (B, Sq, H, D)
    k: torch.Tensor,                    # (B, Skv, KV, D)
    v: torch.Tensor,                    # (B, Skv, KV, Dv)
    *,
    causal: bool = True,
    window: int | None = None,
    q_start: int = 0,
    kv_len: int | None = None,
    softmax_scale: float | None = None,
    impl: str = "auto",
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """GQA attention of ``q`` over ``k``/``v`` (query head ``h`` reads KV
    head ``h // (H/KV)``); returns ``(B, Sq, H, Dv)`` in ``q``'s dtype.

    ``q_start`` is the absolute position of ``q[:, 0]``; keys at or beyond
    ``kv_len`` (default ``Skv``) are masked, as are keys after the causal
    diagonal and, with ``window``, keys at or before ``qpos - window``.
    """
    impl = _pick_impl(impl, q)
    q_start = int(q_start)
    kv_len = None if kv_len is None else int(kv_len)
    if impl == "ref":
        return attention_ref(
            q, k, v, causal=causal, window=window, q_start=q_start,
            kv_len=kv_len, softmax_scale=softmax_scale,
        )
    if impl == "cuda":
        if not q.is_cuda:
            raise ValueError("impl='cuda' needs CUDA tensors; got q on "
                             f"{q.device}")
        return _kernel.flash_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, q_start=q_start,
            kv_len=k.shape[1] if kv_len is None else kv_len,
            softmax_scale=softmax_scale,
        )
    return _flash_torch(
        q, k, v, causal=causal, window=window, q_start=q_start,
        kv_len=kv_len, softmax_scale=softmax_scale, kv_chunk=kv_chunk,
    )


def _flash_torch(q, k, v, *, causal, window, q_start, kv_len, softmax_scale,
                 kv_chunk):
    """Online-softmax loop over KV chunks (the flash algorithm in eager
    PyTorch).  Fully-masked chunks are skipped with the same test as the
    kernel's (beyond ``kv_len``, after the causal diagonal, before the
    window)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]                 # may differ from D (e.g. MLA: 192 vs 128)
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    C = min(kv_chunk, Skv)
    if Skv % C:
        pad = C - Skv % C
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_len = Skv if kv_len is None else kv_len
        Skv = Skv + pad
    n_chunks = Skv // C
    dev = q.device

    qh = (q.float() * scale).reshape(B, Sq, KV, G, D)
    qpos = q_start + torch.arange(Sq, device=dev)             # (Sq,)
    q_hi = q_start + Sq - 1

    kc = k.reshape(B, n_chunks, C, KV, D)
    vc = v.reshape(B, n_chunks, C, KV, Dv)

    m = torch.full((B, Sq, KV, G), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, Dv), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        lo = ci * C                     # first kv position in chunk
        hi = lo + C - 1
        alive = True
        if causal:
            alive &= lo <= q_hi
        if window is not None:
            alive &= hi > q_start - window
        if kv_len is not None:
            alive &= lo < kv_len
        if not alive:
            continue
        ks = kc[:, ci].float()                                # (B, C, KV, D)
        vs = vc[:, ci].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, ks)         # (B,Sq,KV,G,C)
        kpos = lo + torch.arange(C, device=dev)
        mask = torch.ones((Sq, C), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        if kv_len is not None:
            mask &= kpos[None, :] < kv_len
        s = torch.where(mask[None, :, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, Dv).to(q.dtype)
