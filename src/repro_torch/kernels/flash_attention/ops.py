"""Public attention op: impl dispatch + the plain chunked PyTorch version.

``flash_attention(..., impl=...)``:

  * ``"auto"``  -- the CUDA kernel for tensors on the card, ``"torch"``
                   for tensors on the CPU;
  * ``"cuda"``  -- the CUDA kernels; raises for a tensor on the CPU.  A
                   fixed rule by dtype and shape (``kernel.pick_route``)
                   picks one of three: the split-K decode
                   (``csrc/flash_decode.cu``) for every call with
                   ``Sq * G <= 16`` (bf16 or f32, any (D, Dv)) and
                   every call at a device position or length; the
                   ``wgmma`` prefill (``csrc/flash_prefill_sm90.cu``) for
                   bf16 calls with ``Sq * G > 16`` at (D, Dv) in
                   {(64, 64), (128, 128), (192, 128), (256, 256)}; the
                   simple kernel (``csrc/flash_attention.cu``) for the
                   rest, f32 with ``Sq * G > 16`` and the (16, 16) pair
                   with ``Sq * G > 16``.  The rule is a route, not a
                   fallback: each call has one kernel;
  * ``"torch"`` -- chunked online-softmax loop over KV chunks in plain
                   PyTorch: O(S·C) memory, a line-for-line counterpart of
                   ``repro``'s ``_flash_xla`` (the plain version the kernel
                   is held against; the CPU path);
  * ``"ref"``   -- the O(S²) oracle (tests only).

Under autograd (grad enabled and an input that requires a gradient),
``"auto"`` on the card and ``"cuda"`` take :class:`FlashAttentionFn`: the
routed forward kernel, and the hand-written backward
(``kernel.flash_backward_cuda``, routed by ``kernel.pick_backward_route``:
``csrc/flash_backward_sm90.cu`` on the tensor cores for bf16,
``csrc/flash_backward.cu`` for f32) for the gradient.  It takes the
training forms only (``q_start`` 0, ``kv_len = Skv``; causal with ``Sq =
Skv``, with or without a window, at (64, 64), (128, 128), (192, 128) and
(256, 256) heads, or non-causal with any ``Sq`` and ``Skv`` at (64, 64):
``kernel.check_backward``) and raises for any other call that needs a
gradient on the card.
Without autograd
(serving, under ``torch.no_grad()``) the call is the plain kernel launch
it always was, so captured graphs and launch counts do not change.  The
backward's plain version is :func:`flash_attention_backward_torch`, and
:func:`flash_backward_tiled_torch` emulates the tensor-core kernel's
tiles, sweeps and bf16 roundings;
``"torch"`` on any device differentiates ``_flash_torch`` with autograd.

The split-K decode's plain versions are :func:`flash_decode_partials_torch`
(each split's partial m, l and acc, split as the kernel splits) and
:func:`flash_decode_combine_torch` (their merge); together they compute
what ``_flash_torch`` computes, except for a row with no live key among
the keys visited: they give it 0, as ``attention_ref`` and the CUDA
kernels do, where ``_flash_torch`` (like ``repro``'s ``_flash_xla``,
which masks with a finite -1e30) gives the mean of the masked values.

No environment variable changes the choice: a CUDA tensor under
``"auto"`` launches the kernel or raises; it never falls back.

``q_start`` and ``kv_len`` are host integers, or 0-d integer tensors: a
decode step's position on the device, so that one launch, and one captured
graph, serves every position.  ``kv_len`` may also be a ``(B,)`` integer
tensor, a length per batch row (the encoder-decoder's cross-attention,
whose padded encoder buffer holds ``enc_len`` valid rows: 0-d for a
request, ``(B,)`` in the batched step); the CUDA route takes it as int32
and sends the call to the split-K decode, which reads it on the card,
with ``q_start`` a host int (or a device position) as before.  ``q_start`` may also be a ``(B,)`` integer
tensor, a position per batch row (the batched decode step): row ``b`` is
masked at its own ``q_start[b]``.  The kernel then takes ``kv_len =
q_start + Sq`` whatever is passed, so pass that, or ``None`` under a
causal mask, which keeps the same keys.  The CUDA route then is the
split-K decode, which reads the positions on the card; the plain versions
mask from the tensors (``_flash_torch`` skips no chunk then, since which
chunks are dead is not known on the host), and a CPU run with a tensor
position gives what the same run with an int gives (see ``_flash_torch``
for the one row it would not: a row with no live key).
:func:`flash_decode_partials_torch` reads a tensor position on the host
and splits as the kernel does at a device position.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _grad, _local
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention.ref import attention_ref

IMPLS = ("auto", "cuda", "torch", "ref")

_NEG_INF = -1e30
_INF = float("inf")


def _row_lens(kv_len, device):
    """``kv_len`` as the plain versions mask with it: an int or a 0-d
    tensor as it is, a ``(B,)`` tensor (a length per batch row) as ``(B, 1,
    1)``, against key positions of shape ``(1, Sq, C)``."""
    if torch.is_tensor(kv_len) and kv_len.dim() == 1:
        return kv_len.to(device)[:, None, None]
    return kv_len


def _row_positions(q_start, Sq: int, device) -> torch.Tensor:
    """The absolute positions of the ``Sq`` queries as a ``(1, Sq)`` tensor
    (an int or 0-d ``q_start``: every batch row alike) or a ``(B, Sq)`` one
    (a ``(B,)`` ``q_start``: a position per row)."""
    ar = torch.arange(Sq, device=device)
    if torch.is_tensor(q_start) and q_start.dim() == 1:
        return q_start.to(device)[:, None] + ar
    return (q_start + ar)[None]



def _pick_impl(impl: str, q) -> str:
    if impl == "auto":
        return "cuda" if _grad.on_card(q) else "torch"
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
    q_start=0,
    kv_len=None,
    softmax_scale: float | None = None,
    impl: str = "auto",
    kv_chunk: int = 1024,
) -> torch.Tensor:
    """GQA attention of ``q`` over ``k``/``v`` (query head ``h`` reads KV
    head ``h // (H/KV)``); returns ``(B, Sq, H, Dv)`` in ``q``'s dtype.

    ``q_start`` is the absolute position of ``q[:, 0]``; keys at or beyond
    ``kv_len`` (default ``Skv``) are masked, as are keys after the causal
    diagonal and, with ``window``, keys at or before ``qpos - window``.
    Both are ints, or 0-d integer tensors on ``q``'s device; either also a
    ``(B,)`` one, a position or a length per batch row (the module
    docstring).

    DTensor inputs run on their local shards (``kernels/_local.py``):
    batch and heads sharded where they divide, everything else (the
    sequence) gathered; a ``(B,)`` ``q_start`` or ``kv_len`` keeps the
    batch whole.
    """
    if _local.has_dtensor(q, k, v):
        per_row = any(torch.is_tensor(a) and a.dim() == 1
                      for a in (q_start, kv_len))
        dims = {"heads": 2} if per_row else {"batch": 0, "heads": 2}

        def run(q, k, v):
            return flash_attention(
                q, k, v, causal=causal, window=window, q_start=q_start,
                kv_len=kv_len, softmax_scale=softmax_scale, impl=impl,
                kv_chunk=kv_chunk)

        return _local.call_local("flash_attention", run, (q, k, v),
                                 (dims, dims, dims), dims)
    impl = _pick_impl(impl, q)
    if not torch.is_tensor(q_start):
        q_start = int(q_start)
    if kv_len is not None and not torch.is_tensor(kv_len):
        kv_len = int(kv_len)
    if impl == "ref":
        return attention_ref(
            q, k, v, causal=causal, window=window, q_start=q_start,
            kv_len=kv_len, softmax_scale=softmax_scale,
        )
    if impl == "cuda":
        if not _grad.on_card(q):
            raise ValueError("impl='cuda' needs CUDA tensors; got q on "
                             f"{q.device}")
        if _grad.needs_grad(q, k, v):
            _kernel.check_backward(q, k, v, causal=causal, window=window,
                                   q_start=q_start, kv_len=kv_len)
            return FlashAttentionFn.apply(q, k, v, softmax_scale, window,
                                          causal)
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
    window) where the positions are host ints.  With tensor positions
    every chunk is visited: for a row with a live key and finite keys and
    values the result is the same, since a chunk the mask kills leaves m,
    l and acc as they were once a live key was seen, and before one its
    sums are wiped by the first live chunk's correction exp(-1e30 - m) =
    0.  (A row with no live key at all gives 0 when its chunks are
    skipped, the mean of the masked values when they are visited.)"""
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
    qpos = _row_positions(q_start, Sq, dev)[..., None]   # (1 or B, Sq, 1)
    kvl = _row_lens(kv_len, dev)

    kc = k.reshape(B, n_chunks, C, KV, D)
    vc = v.reshape(B, n_chunks, C, KV, Dv)

    m = torch.full((B, Sq, KV, G), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, KV, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Sq, KV, G, Dv), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        lo = ci * C                     # first kv position in chunk
        hi = lo + C - 1
        alive = True
        if not torch.is_tensor(q_start):
            if causal:
                alive &= lo <= q_start + Sq - 1
            if window is not None:
                alive &= hi > q_start - window
        if kv_len is not None and not torch.is_tensor(kv_len):
            alive &= lo < kv_len
        if not alive:
            continue
        ks = kc[:, ci].float()                                # (B, C, KV, D)
        vs = vc[:, ci].float()
        s = torch.einsum("bqkgd,bckd->bqkgc", qh, ks)         # (B,Sq,KV,G,C)
        kpos = lo + torch.arange(C, device=dev)
        mask = torch.ones((1, Sq, C), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (kpos <= qpos)
        if window is not None:
            mask = mask & (kpos > qpos - window)
        if kv_len is not None:
            mask = mask & (kpos < kvl)
        s = torch.where(mask[:, :, None, None, :], s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckd->bqkgd", p, vs)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def flash_decode_partials_torch(q, k, v, *, splits=None, causal=True,
                                window=None, q_start=0, kv_len=None,
                                softmax_scale=None):
    """Each split's partial softmax state of the split-K decode, in f32:
    ``(m, l, acc)`` with ``m`` and ``l`` ``(B, KV, S, Sq, G)`` and ``acc``
    ``(B, KV, S, Sq, G, Dv)``.

    The live keys are cut as the kernel cuts them (``kernel.decode_splits``:
    ``splits=None`` is its rule, else S splits): split s covers the tiles
    ``[t0 + s * tpc, t0 + (s + 1) * tpc)`` of ``DECODE_TILE`` keys, clipped
    to the live range.  With ``q_start`` a tensor (a device position: 0-d,
    or ``(B,)``, a position per batch row), it is read on the host, each
    row's ``kv_len`` is its ``q_start + Sq`` (cut to the cache) and its t0
    its own, and S and tpc are ``kernel.capacity_splits``'s, as the
    kernel's are at a device position.  With ``kv_len`` a tensor (a device
    length: 0-d, or ``(B,)``, one per batch row) it is each row's
    ``kv_len`` (cut to the cache), read on the host, whatever ``q_start``
    is, and S and tpc are ``kernel.capacity_splits``'s too.  ``m`` is the
    split's max of the
    scaled live scores (``-inf`` where no key of the split is live for the
    row, an empty split included), ``l = sum exp(s - m)`` and ``acc = sum
    exp(s - m) v`` (both 0 where ``m = -inf``)."""
    B, Sq, H, D = q.shape
    _, Skv, KV, _ = k.shape
    Dv = v.shape[-1]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    if torch.is_tensor(q_start) or torch.is_tensor(kv_len):
        S, tpc = _kernel.capacity_splits(B, KV, Sq, H, Dv, Skv=Skv,
                                         causal=causal, window=window,
                                         splits=splits)
        starts = [int(p) for p in q_start.reshape(-1).tolist()] \
            if torch.is_tensor(q_start) else [int(q_start)]
        lens = [min(max(int(n), 0), Skv) for n in kv_len.reshape(-1)
                .tolist()] if torch.is_tensor(kv_len) else None
        n = max(len(starts), len(lens or ()))
        pick = lambda xs, b: xs[b if len(xs) > 1 else 0]
        # (batch rows, q_start, kv_len): every row alike, or one per row
        groups = [(slice(None) if n == 1 else slice(b, b + 1),
                   pick(starts, b),
                   pick(lens, b) if lens is not None
                   else min(pick(starts, b) + Sq, Skv)) for b in range(n)]
    else:
        kv_len = Skv if kv_len is None else min(int(kv_len), Skv)
        S, _, tpc = _kernel.decode_splits(B, KV, Sq, H, Dv, causal=causal,
                                          window=window, q_start=q_start,
                                          kv_len=kv_len, splits=splits)
        groups = [(slice(None), int(q_start), kv_len)]
    tile, dev = _kernel.DECODE_TILE, q.device
    qh = (q.float() * scale).reshape(B, Sq, KV, G, D)
    m = torch.full((B, KV, S, Sq, G), -_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, S, Sq, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KV, S, Sq, G, Dv), dtype=torch.float32,
                      device=dev)
    for rows, qs, kvl in groups:
        t0, n = _kernel.live_tiles(Sq, causal=causal, window=window,
                                   q_start=qs, kv_len=kvl)
        qpos = qs + torch.arange(Sq, device=dev)
        for s in range(S):
            lo = (t0 + s * tpc) * tile
            hi = min((t0 + min((s + 1) * tpc, n)) * tile, Skv)
            if lo >= hi:
                continue                              # an empty split
            sc = torch.einsum("bqkgd,bckd->bkqgc", qh[rows],
                              k[rows, lo:hi].float())
            kpos = lo + torch.arange(hi - lo, device=dev)
            mask = (kpos[None, :] < kvl).expand(Sq, -1)
            if causal:
                mask = mask & (kpos[None, :] <= qpos[:, None])
            if window is not None:
                mask = mask & (kpos[None, :] > qpos[:, None] - window)
            sc = torch.where(mask[None, None, :, None, :], sc, -_INF)
            ms = sc.amax(-1)                          # (b, KV, Sq, G)
            p = torch.where(torch.isinf(ms)[..., None], 0.0,
                            torch.exp(sc - ms[..., None]))
            m[rows, :, s] = ms
            l[rows, :, s] = p.sum(-1)
            acc[rows, :, s] = torch.einsum("bkqgc,bckd->bkqgd", p,
                                           v[rows, lo:hi].float())
    return m, l, acc


def flash_decode_combine_torch(m, l, acc, *, dtype=torch.float32):
    """Merge the splits' partials of :func:`flash_decode_partials_torch`:
    ``M = max_s m_s``, ``out = sum_s e^(m_s - M) acc_s / max(sum_s
    e^(m_s - M) l_s, 1e-30)``.  A split with ``m_s = -inf`` weighs exactly
    0 (never ``exp(-inf - (-inf))``), and a row whose splits are all
    ``-inf`` gives 0.  Returns ``(B, Sq, KV * G, Dv)`` in ``dtype``."""
    B, KV, _, Sq, G, Dv = acc.shape
    M = m.amax(2, keepdim=True)
    dead = torch.isinf(m) & (m < 0)
    w = torch.where(dead, 0.0, torch.exp(torch.where(dead, 0.0, m - M)))
    num = (w[..., None] * acc).sum(2)                 # (B, KV, Sq, G, Dv)
    den = torch.clamp((w * l).sum(2), min=1e-30)
    out = num / den[..., None]
    return out.permute(0, 2, 1, 3, 4).reshape(B, Sq, KV * G, Dv).to(dtype)


class FlashAttentionFn(torch.autograd.Function):
    """GQA attention in a training form (``q_start`` 0, ``kv_len = Skv``:
    causal with ``Sq = Skv``, with or without a window, keys at or before
    ``q - window`` masked; or non-causal, any ``Sq`` and ``Skv``) on the
    card, with a hand-written gradient: the forward is the routed forward
    kernel (``kernel.flash_attention_cuda``: the ``wgmma`` prefill in
    bf16, the simple kernel in f32) and the backward the routed backward
    kernel (``kernel.flash_backward_cuda``: the tensor-core kernel in
    bf16, the CUDA-core one in f32), both given the window and the mask.
    It saves q, k, v and the output for the backward (the log-sum-exp is
    recomputed there).  ``apply(q, k, v, softmax_scale, window,
    causal=True)``; the caller (:func:`flash_attention`) has checked the
    form with ``kernel.check_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale=None, window=None, causal=True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o = _kernel.flash_attention_cuda(
            q, k, v, causal=causal, window=window, q_start=0,
            kv_len=k.shape[1], softmax_scale=softmax_scale)
        ctx.save_for_backward(q, k, v, o)
        ctx.softmax_scale = softmax_scale
        ctx.window = window
        ctx.causal = causal
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        dq, dk, dv = _kernel.flash_backward_cuda(
            q, k, v, o, do.contiguous(), softmax_scale=ctx.softmax_scale,
            window=ctx.window, causal=ctx.causal)
        return dq, dk, dv, None, None, None


def _live_pairs(Sq, Skv, window, causal, device):
    """``(query, key)`` -> live, queries and keys from position 0: every
    pair without the causal mask; causal, the keys at or before the
    query, and with a window the keys after ``q - window`` only."""
    qp = torch.arange(Sq, device=device)[:, None]
    kp = torch.arange(Skv, device=device)[None, :]
    live = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        live = live & (kp <= qp)
    if window is not None:
        live = live & (kp > qp - window)
    return live


def flash_attention_backward_torch(q, k, v, o, do, *, softmax_scale=None,
                                   window=None, causal=True):
    """The backward kernels' algorithm in plain torch ops: the gradient of
    attention ``o = attn(q, k, v)`` (``q_start`` 0; causal, with
    ``window`` keys at or before ``q - window`` masked too, or with
    ``causal=False`` every key of ``Skv``) given ``do``, from the
    recomputed log-sum-exp of each query row.

    With ``s = scale q k^T`` under the mask, ``lse`` its row-wise
    log-sum-exp, ``P = exp(s - lse)`` and ``D = rowsum(do * o)``:
    ``dv = P^T do``, ``dS = P * (do v^T - D)``, ``dq = scale dS k``,
    ``dk = scale dS^T q``, summed over the query heads of each KV head; in
    f32 (O(Sq Skv) memory), returned in the inputs' dtypes.  q ``(B, Sq,
    H, D)``, k ``(B, Skv, KV, D)``, v ``(B, Skv, KV, Dv)``, o and do
    ``(B, Sq, H, Dv)``."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qf = q.float().reshape(B, Sq, KV, G, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Sq, KV, G, Dv)
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf) * scale
    live = _live_pairs(Sq, Skv, window, causal, q.device)      # (q, s)
    s = torch.where(live, s, -torch.inf)
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    p = torch.exp(s - lse)                                    # 0 where dead
    delta = (dof * o.float().reshape(B, Sq, KV, G, Dv)).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dof, vf)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dof)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_backward_tiled_torch(q, k, v, o, do, *, softmax_scale=None,
                               round_bf16=False, window=None, causal=True):
    """The tensor-core backward's decomposition (``csrc/flash_backward_
    sm90.cu``) in plain torch ops, on tiles of ``kernel.BACKWARD_TILE``
    rows, rows past Sq (queries) and Skv (keys) zero as the kernel's
    copies fill them:

      * the dQ kernel, query tile by query tile: a first sweep over the
        live key tiles (``kernel.backward_key_tiles``: causal, the
        window's first to the diagonal; non-causal, every key tile) for
        each row's log-sum-exp (base 2, of the scores times ``scale *
        log2 e``, by an online max and sum) and, non-causal, ``D = sum P
        dP`` by an online sum beside it (causal, ``D = rowsum(dO * o)``),
        a second for ``dS = P (dP - D)`` and ``dQ += dS K``;
      * the dK/dV kernel, key tile by key tile: the G query heads of its
        KV head in order, each over the live query tiles
        (``kernel.backward_query_tiles``: causal, the diagonal to the last
        the window reaches; non-causal, every query tile), ``dV += P^T
        dO`` and ``dK += dS^T Q``.

    (The kernel splits each tile's D columns over blocks of 64; the
    columns of a product are independent sums, so the emulation keeps them
    whole.)

    ``round_bf16`` rounds P and dS to bf16 where they enter a product, as
    the kernel does; without it every value stays f32.  Sums are f32;
    returns ``(dq, dk, dv)`` in the inputs' dtypes."""
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // KV
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    sl2 = scale * 1.4426950408889634
    T = _kernel.BACKWARD_TILE
    nq, nk = _kernel.backward_tiles(Sq), _kernel.backward_tiles(Skv)
    rnd = (lambda t: t.bfloat16().float()) if round_bf16 else (lambda t: t)
    pad = lambda t, n: F.pad(t.float(), (0, 0, 0, 0, 0, n * T - t.shape[1]))
    qf = pad(q, nq).reshape(B, nq * T, KV, G, D)
    dof = pad(do, nq).reshape(B, nq * T, KV, G, Dv)
    kf, vf = pad(k, nk), pad(v, nk)
    delta = (dof * pad(o, nq).reshape(B, nq * T, KV, G, Dv)).sum(-1)
    pos = torch.arange(max(nq, nk) * T, device=q.device)
    tile = lambda t: slice(t * T, (t + 1) * T)

    def live(rows, keys):                               # (queries, keys)
        qp, kp = pos[rows][:, None], pos[keys][None, :]
        m = (qp < Sq) & (kp < Skv)
        if causal:
            m = m & (kp <= qp)
        if window is not None:
            m = m & (kp > qp - window)
        return m

    lse = torch.zeros((B, nq * T, KV, G), device=q.device)
    dq = torch.zeros_like(qf)
    for qt in range(nq):
        rows = tile(qt)
        m = torch.full((B, T, KV, G), -_INF, device=q.device)
        l = torch.zeros((B, T, KV, G), device=q.device)
        dsum = torch.zeros_like(l)
        t0, nt = _kernel.backward_key_tiles(qt, Skv, window, causal=causal)
        for t in range(t0, t0 + nt):                     # sweep 1
            s = torch.einsum("bqkgd,bckd->bqkgc", qf[:, rows],
                             kf[:, tile(t)]) * sl2
            s = torch.where(live(rows, tile(t))[:, None, None], s, -_INF)
            m_new = torch.maximum(m, s.amax(-1))
            ok = m_new > -_INF
            ref = torch.where(ok, m_new, 0.0)
            e = torch.exp2(s - ref[..., None])
            c = torch.exp2(m - ref)
            l = torch.where(ok, l * c + e.sum(-1), l)
            if not causal:
                dp = torch.einsum("bqkgd,bckd->bqkgc", dof[:, rows],
                                  vf[:, tile(t)])
                dsum = torch.where(ok, dsum * c + (e * dp).sum(-1), dsum)
            m = m_new
        ok = (pos[rows] < Sq)[:, None, None]
        lse[:, rows] = torch.where(ok, m + torch.log2(l), 0.0)
        if not causal:
            delta[:, rows] = torch.where(ok, dsum / l, 0.0)
        for t in range(t0, t0 + nt):                     # sweep 2
            s = torch.einsum("bqkgd,bckd->bqkgc", qf[:, rows],
                             kf[:, tile(t)]) * sl2
            dp = torch.einsum("bqkgd,bckd->bqkgc", dof[:, rows],
                              vf[:, tile(t)])
            p = torch.where(live(rows, tile(t))[:, None, None],
                            torch.exp2(s - lse[:, rows, ..., None]), 0.0)
            ds = rnd(p * (dp - delta[:, rows, ..., None]))
            dq[:, rows] += torch.einsum("bqkgc,bckd->bqkgd", ds,
                                        kf[:, tile(t)])
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for kt in range(nk):
        keys = tile(kt)
        q0, n = _kernel.backward_query_tiles(kt, Sq, window, causal=causal)
        for g in range(G):
            for qt in range(q0, q0 + n):
                rows = tile(qt)
                st = torch.einsum("bckd,bqkd->bkcq", kf[:, keys],
                                  qf[:, rows, :, g]) * sl2
                dpt = torch.einsum("bckd,bqkd->bkcq", vf[:, keys],
                                   dof[:, rows, :, g])
                lq = lse[:, rows, :, g].permute(0, 2, 1)[:, :, None]
                dl = delta[:, rows, :, g].permute(0, 2, 1)[:, :, None]
                pt = torch.where(live(rows, keys).T, torch.exp2(st - lq),
                                 0.0)
                dst = rnd(pt * (dpt - dl))
                dv[:, keys] += torch.einsum("bkcq,bqkd->bckd", rnd(pt),
                                            dof[:, rows, :, g])
                dk[:, keys] += torch.einsum("bkcq,bqkd->bckd", dst,
                                            qf[:, rows, :, g])
    return ((dq[:, :Sq] * scale).reshape(B, Sq, H, D).to(q.dtype),
            (dk[:, :Skv] * scale).to(k.dtype), dv[:, :Skv].to(v.dtype))
