"""Plain PyTorch versions of the optimizer kernels, and emulations of the
kernels' order.

``sumsq_torch`` and ``adamw_update_torch`` are the train step's clip and
AdamW update as torch ops, in ``repro``'s order of operations
(``src/repro/launch/steps.py:42-50``, ``src/repro/optim/adamw.py:48-70``):
what the CPU and ``impl="torch"`` run, and what the kernels are held
against on the card.  Each op rounds on its own in f32, so the update
kernel (``csrc/adamw.cu``), which repeats the ops one rounding each, gives
the same bits.

``sumsq_chunked_torch`` and ``adamw_update_chunked_torch`` repeat the
kernels' decomposition -- the leaf table (``kernel.leaf_rows``), a block
a chunk of ``kernel.CHUNK`` elements (``kernel.chunk_span``), 16-byte
groups where the addresses allow -- in torch: the squared sums in the
kernel's summation order (a thread's groups in order, the block's tree,
the leaf's partials in chunk order by the same tree), the update chunk by
chunk.  ``visits`` counts how often each element was taken, so a test can
show that the table covers every element exactly once.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.optim.kernel import (
    CHUNK,
    DTYPE_CODES,
    GROUP,
    THREADS,
    chunk_span,
    first_chunks,
)

f32 = torch.float32


def sumsq_torch(grads) -> list:
    """Each gradient leaf's squared sum in f32, a 0-d tensor each."""
    return [torch.sum(torch.square(g.to(f32))) for g in grads]


@torch.no_grad()
def adamw_update_torch(grads, params, ms, vs, *, scale, lr, bc1, bc2,
                       b1: float, b2: float, eps: float,
                       weight_decay: float) -> None:
    """The clip's scaling (``scale``, or None for none: each gradient
    scaled in place in its own dtype) and the AdamW update of every leaf,
    writing ``params``, ``ms`` and ``vs`` in place."""
    if scale is not None:
        for g in grads:                 # autograd's own: scaled in place
            g.mul_(scale.to(g.dtype))
    for g, m, v, p in zip(grads, ms, vs, params):
        g = g.to(f32)
        m.copy_(b1 * m + (1 - b1) * g)
        v.copy_(b2 * v + (1 - b2) * g * g)
        del g
        upd = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        pf = p.to(f32)
        upd.add_(weight_decay * pf)
        p.copy_(pf - lr * upd)


# ---------------------------------------------------- the kernels' order

def _tree_sum(x):
    """``csrc/adamw.cu:block_sum`` over the last dim (THREADS values):
    shuffles down within each warp of 32, then the warps' sums by the same
    tree; returns thread 0's value."""
    x = x.reshape(*x.shape[:-1], THREADS // 32, 32)

    def warp(x):
        x = x.clone()
        for o in (16, 8, 4, 2, 1):
            x[..., :32 - o] = x[..., :32 - o] + x[..., o:]
        return x[..., 0]

    w = warp(x)                                   # (..., warps)
    pad = torch.zeros(*w.shape[:-1], 32 - w.shape[-1], dtype=f32)
    return warp(torch.cat([w, pad], -1))


def _aligned(addr: int, esz: int, e: int) -> bool:
    return (addr + e * esz) % 16 == 0


def sumsq_chunked_torch(grads, visits=None):
    """The per-leaf squared sums in ``sumsq_kernel``'s order: an ``(L,)``
    f32 tensor.  ``visits`` (a list of int tensors shaped as the leaves),
    where given, is incremented at every element read."""
    numels = [g.numel() for g in grads]
    first = first_chunks(numels)
    total = sum(-(-n // CHUNK) for n in numels)
    partials = torch.zeros(max(total, 1), dtype=f32)
    for c in range(total):
        leaf, start, count = chunk_span(first, numels, c)
        x = grads[leaf].reshape(-1)[start:start + count].to(f32)
        if visits is not None:
            visits[leaf].view(-1)[start:start + count] += 1
        groups = count // GROUP
        # thread t's elements: its groups t, t + THREADS, ... in order, and
        # the tail after them for thread groups % THREADS
        rows = [[] for _ in range(THREADS)]
        for j in range(groups):
            rows[j % THREADS].append(x[j * GROUP:(j + 1) * GROUP])
        if count > groups * GROUP:
            rows[groups % THREADS].append(x[groups * GROUP:])
        seqs = [torch.cat(r) if r else torch.zeros(0, dtype=f32)
                for r in rows]
        width = max(len(s) for s in seqs)
        sq = torch.zeros(THREADS, width, dtype=f32)
        for t, s in enumerate(seqs):
            sq[t, :len(s)] = s * s
        acc = torch.zeros(THREADS, dtype=f32)
        for j in range(width):           # + 0 past a thread's last element
            acc = acc + sq[:, j]
        partials[c] = _tree_sum(acc)
    out = torch.zeros(len(grads), dtype=f32)
    for leaf, n in enumerate(numels):
        nc = -(-n // CHUNK)
        acc = torch.zeros(THREADS, dtype=f32)
        for i in range(0, nc, THREADS):
            part = partials[first[leaf] + i:first[leaf] + min(nc, i + THREADS)]
            acc[:len(part)] = acc[:len(part)] + part
        out[leaf] = _tree_sum(acc)
    return out


@torch.no_grad()
def adamw_update_chunked_torch(grads, params, ms, vs, *, scale, lr, bc1,
                               bc2, b1: float, b2: float, eps: float,
                               weight_decay: float, addrs=None,
                               visits=None) -> None:
    """``adamw_update_kernel`` chunk by chunk, in place: each chunk's
    16-byte groups (where the four leaves' addresses at its start are
    aligned; ``addrs``, the leaves' ``(g, p, m, v)`` addresses, default
    their ``data_ptr``s) and its scalar rest, each element's operations in
    the kernel's order with one rounding each."""
    numels = [g.numel() for g in grads]
    first = first_chunks(numels)
    total = sum(-(-n // CHUNK) for n in numels)
    if addrs is None:
        addrs = [tuple(t.data_ptr() for t in four)
                 for four in zip(grads, params, ms, vs)]
    b1f, omb1, b2f, omb2 = (torch.tensor(x, dtype=f32)
                            for x in (b1, 1 - b1, b2, 1 - b2))
    epsf, wdf = torch.tensor(eps, dtype=f32), torch.tensor(weight_decay,
                                                           dtype=f32)
    lr, bc1, bc2 = (torch.as_tensor(x, dtype=f32) for x in (lr, bc1, bc2))

    def one(g, p, m, v, g_dtype):
        if scale is not None:
            g = (g * scale.to(g_dtype).to(f32)).to(g_dtype).to(f32)
        m = b1f * m + omb1 * g
        v = b2f * v + (omb2 * g) * g
        u = (m / bc1) / (torch.sqrt(v / bc2) + epsf)
        u = u + wdf * p
        return p - lr * u, m, v

    for c in range(total):
        leaf, start, count = chunk_span(first, numels, c)
        g, p, m, v = (t.view(-1) for t in (grads[leaf], params[leaf],
                                           ms[leaf], vs[leaf]))
        esz = (g.element_size(), p.element_size(), 4, 4)
        vec = all(_aligned(a, e, start) for a, e in zip(addrs[leaf], esz))
        groups = count // GROUP if vec else 0
        spans = [(start, start + groups * GROUP),
                 (start + groups * GROUP, start + count)]
        for lo, hi in spans:             # the groups, then the scalar rest
            if hi <= lo:
                continue
            pn, mn, vn = one(g[lo:hi].to(f32), p[lo:hi].to(f32), m[lo:hi],
                             v[lo:hi], g.dtype)
            p[lo:hi] = pn.to(p.dtype)
            m[lo:hi] = mn
            v[lo:hi] = vn
            if visits is not None:
                visits[leaf].view(-1)[lo:hi] += 1


__all__ = ["DTYPE_CODES", "adamw_update_chunked_torch", "adamw_update_torch",
           "sumsq_chunked_torch", "sumsq_torch"]
