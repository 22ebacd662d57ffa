"""Plain PyTorch versions of the optimizer kernels, and emulations of the
kernels' order.

``sumsq_torch``, ``adamw_update_torch`` and ``adafactor_update_torch`` are
the train step's clip and its AdamW and Adafactor updates as torch ops, in
``repro``'s order of operations (``src/repro/launch/steps.py:42-50``,
``src/repro/optim/adamw.py:48-70``, ``src/repro/optim/adafactor.py:67-98``):
what the CPU and ``impl="torch"`` run, and what the kernels are held
against on the card.  Each op rounds on its own in f32, so the AdamW update
kernel (``csrc/adamw.cu``), which repeats the ops one rounding each, gives
the same bits; the Adafactor kernels (``csrc/adafactor.cu``) repeat them
too but sum in another order.

``sumsq_chunked_torch`` and ``adamw_update_chunked_torch`` repeat the
kernels' decomposition -- the leaf table (``kernel.leaf_rows``), a block
a chunk of ``kernel.CHUNK`` elements (``kernel.chunk_span``), 16-byte
groups where the addresses allow -- in torch: the squared sums in the
kernel's summation order (a thread's groups in order, the block's tree,
the leaf's partials in chunk order by the same tree), the update chunk by
chunk.  ``visits`` counts how often each element was taken, so a test can
show that the table covers every element exactly once.

``adafactor_update_chunked_torch`` repeats the Adafactor kernels' tiles
(``kernel.adafactor_geometry``) and summation order in torch, a leaf at a
time and its tiles at once; it is the composition of one emulation a
launch (``adafactor_sums_emulated``, ``adafactor_finish_emulated``,
``adafactor_rms_emulated``, ``adafactor_update_emulated``), each with the
signature of its kernel's wrapper in ``kernel.py``.  On the card, where
torch's f32 ops round as the kernels' do (``rsqrt`` the same ``rsqrtf``),
it gives the kernels' bits.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.optim.kernel import (
    CHUNK,
    DTYPE_CODES,
    GROUP,
    THREADS,
    TILE_COLS,
    TILE_ROWS,
    adafactor_geometry,
    chunk_span,
    first_chunks,
    leaf_states,
    whole_counts,
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


def _factored(shape) -> bool:
    return len(shape) >= 2


@torch.no_grad()
def adafactor_update_torch(grads, params, vs, *, scale, lr, beta2,
                           eps: float, clip_threshold: float,
                           weight_decay: float) -> None:
    """The clip's scaling (``scale``, or None for none: each gradient
    scaled in place in its own dtype) and the Adafactor update of every
    leaf (``vs``: a leaf's state, ``{"vr", "vc"}`` for a factored leaf,
    ``{"v"}`` otherwise), writing ``params`` and ``vs`` in place.
    ``beta2``: a 0-d f32 tensor; ``lr``: one, or a number."""
    if scale is not None:
        for g in grads:                 # autograd's own: scaled in place
            g.mul_(scale.to(g.dtype))
    for g, v, p in zip(grads, vs, params):
        g = g.to(f32)
        g2 = g * g + eps
        if _factored(p.shape):
            v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * g2.mean(-1))
            v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * g2.mean(-2))
            denom = torch.clamp(v["vr"].mean(-1, keepdim=True), min=eps)
            u = (g * torch.rsqrt(v["vr"] / denom)[..., None]
                 * torch.rsqrt(v["vc"])[..., None, :])
        else:
            v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
            u = g * torch.rsqrt(v["v"])
        del g2
        rms = torch.sqrt(torch.mean(u * u) + eps)
        u = u / torch.clamp(rms / clip_threshold, min=1.0)
        pf = p.to(f32)
        p.copy_(pf - lr * (u + weight_decay * pf))


# ---------------------------------------------------- the kernels' order

def _warp_sum(x):
    """A warp's shuffle-down tree over the last dim (32 lanes); lane 0's
    value."""
    x = x.clone()
    for o in (16, 8, 4, 2, 1):
        x[..., :32 - o] = x[..., :32 - o] + x[..., o:]
    return x[..., 0]


def _tree_sum(x):
    """``csrc/adamw.cu:block_sum`` over the last dim (THREADS values):
    shuffles down within each warp of 32, then the warps' sums by the same
    tree; returns thread 0's value."""
    x = x.reshape(*x.shape[:-1], THREADS // 32, 32)
    w = _warp_sum(x)                              # (..., warps)
    pad = torch.zeros(*w.shape[:-1], 32 - w.shape[-1], dtype=f32,
                      device=w.device)
    return _warp_sum(torch.cat([w, pad], -1))


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


# ------------------------------------------------- Adafactor's order

def _f(x, dev) -> torch.Tensor:
    """``x`` as a 0-d f32 tensor on ``dev`` (rounded to f32 as the
    kernels' float arguments and the library's ``(float)`` casts are):
    torch divides by a host number as a product by its reciprocal, so
    the emulation's operands are tensors."""
    return torch.tensor(float(np.float32(x)), dtype=f32, device=dev)


def _scaled(g, scale):
    """The gradient scaled as ``g.mul_(scale.to(g.dtype))`` does, in f32."""
    if scale is not None:
        g = g * scale.to(g.dtype)
    return g.to(f32)


def _tiled(x, geo):
    """A leaf's f32 values (shaped as the leaf) in their tiles, zero past
    the edges: ``(m, n_rt, n_ct, TILE_ROWS, TILE_COLS)`` in tile order."""
    if geo.factored:
        x = x.reshape(geo.m, geo.r, geo.c)
    else:
        x = F.pad(x.reshape(1, geo.n), (0, geo.r * TILE_COLS - geo.n))
        x = x.reshape(1, geo.r, TILE_COLS)
    x = F.pad(x, (0, geo.n_ct * TILE_COLS - geo.c,
                  0, geo.n_rt * TILE_ROWS - geo.r))
    return x.reshape(geo.m, geo.n_rt, TILE_ROWS, geo.n_ct,
                     TILE_COLS).permute(0, 1, 3, 2, 4)


def _in_order(x, dim: int):
    """The sum over ``dim`` taken in index order, one rounding an add."""
    x = x.movedim(dim, 0)
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _thread_sum(x, width: int):
    """Thread t's sum of x's last dim at t, t + width, ... in order: the
    last dim zero-padded to a multiple of ``width`` -> ``(..., width)``."""
    n = x.shape[-1]
    x = F.pad(x, (0, -(-n // width) * width - n))
    return _in_order(x.reshape(*x.shape[:-1], -1, width), -2)


def _moment(beta2, omb2, v, mean):
    return beta2 * v + omb2 * mean


def _counts(grads, counts):
    counts = whole_counts([g.shape for g in grads]) if counts is None \
        else list(counts)
    return [counts[3 * i:3 * i + 3] for i in range(len(grads))]


def _finish_leaf(geo, vr, vc, rowsum, colsum, beta2, omb2, R, C):
    """``finish_rows`` / ``finish_cols`` of one leaf: vr and vc in place
    from each row's and column's sum; returns each matrix's sum of vr."""
    dev = vr.device
    if geo.m * geo.r == 0:
        return torch.zeros(geo.m, dtype=f32, device=dev)
    vr.copy_(_moment(beta2, omb2, vr.reshape(geo.m, geo.r),
                     rowsum / _f(C, dev)).reshape(vr.shape))
    vc.copy_(_moment(beta2, omb2, vc.reshape(geo.m, geo.c),
                     colsum / _f(R, dev)).reshape(vc.shape))
    return _tree_sum(_thread_sum(vr.reshape(geo.m, geo.r), THREADS))


@torch.no_grad()
def adafactor_sums_emulated(grads, states, *, scale, beta2, eps: float,
                            counts=None, fused: bool = True):
    """``adafactor_sums_kernel`` (kernel.py's ``adafactor_sums_cuda``) in
    torch: a tile's row partials (a lane's 8 g2 in order, the warp's
    tree), its column partials (a warp's rows in order, the warps in
    order), a row's and a column's partials in tile order; ``fused``
    updates vr and vc and returns ``(empty, vrsum)``, else ``(sums,
    empty)``; a 1-D leaf's v is updated either way."""
    geos, tot = adafactor_geometry([g.shape for g in grads])
    dev = grads[0].device
    omb2 = 1 - beta2
    epsf = _f(eps, dev)
    sums = torch.zeros(0 if fused else tot.sums, dtype=f32, device=dev)
    vrsum = torch.zeros(tot.mats if fused else 0, dtype=f32, device=dev)
    pairs = leaf_states([g.shape for g in grads], states)
    for g, (a, b), geo, (R, C, _) in zip(grads, pairs, geos,
                                          _counts(grads, counts)):
        if geo.n == 0:
            continue                    # an empty shard: no tile
        x = _scaled(g, scale)
        if not geo.factored:
            a.copy_(_moment(beta2, omb2, a, x * x + epsf))
            continue
        t = _tiled(x, geo)
        del x
        mask = _tiled(torch.ones(g.shape, dtype=f32, device=dev), geo) > 0
        g2 = torch.where(mask, t * t + epsf, 0.0)
        del t, mask
        rowpart = _warp_sum(_in_order(g2.reshape(*g2.shape[:-1], 32, GROUP),
                                      -1))           # (m, rt, ct, rows)
        colpart = _in_order(_in_order(g2.reshape(
            *g2.shape[:3], TILE_ROWS // 8, 8, TILE_COLS), 3), 3)
        del g2
        rowsum = _in_order(rowpart, 2).reshape(geo.m, -1)[:, :geo.r]
        colsum = _in_order(colpart, 1).reshape(geo.m, -1)[:, :geo.c]
        if fused:
            vrsum[geo.first_mat:geo.first_mat + geo.m] = _finish_leaf(
                geo, a, b, rowsum, colsum, beta2, omb2, R, C)
        else:
            k = geo.sums + geo.m * geo.r
            sums[geo.sums:k] = rowsum.reshape(-1)
            sums[k:k + geo.m * geo.c] = colsum.reshape(-1)
    return sums, vrsum


@torch.no_grad()
def adafactor_finish_emulated(sums, grads, states, *, beta2, counts=None):
    """``adafactor_sums_kernel``'s finishing mode (``adafactor_finish_
    cuda``) in torch: vr and vc from ``sums``, each matrix's sum of vr."""
    geos, tot = adafactor_geometry([g.shape for g in grads])
    omb2 = 1 - beta2
    vrsum = torch.zeros(tot.mats, dtype=f32, device=grads[0].device)
    pairs = leaf_states([g.shape for g in grads], states)
    for (a, b), geo, (R, C, _) in zip(pairs, geos, _counts(grads, counts)):
        if not geo.factored:
            continue
        k = geo.sums + geo.m * geo.r
        vrsum[geo.first_mat:geo.first_mat + geo.m] = _finish_leaf(
            geo, a, b, sums[geo.sums:k].reshape(geo.m, geo.r),
            sums[k:k + geo.m * geo.c].reshape(geo.m, geo.c), beta2, omb2,
            R, C)
    return vrsum


def _u(g, geo, a, b, vrsum, scale, epsf, R):
    """u of one leaf, shaped as it: (g rsqrt(vr / den)) rsqrt(vc), or
    g rsqrt(v)."""
    x = _scaled(g, scale)
    if not geo.factored:
        return x * torch.rsqrt(a)
    den = torch.maximum(vrsum[geo.first_mat:geo.first_mat + geo.m]
                        / _f(R, x.device), epsf)
    rr = torch.rsqrt(a.reshape(geo.m, geo.r) / den[:, None])
    rc = torch.rsqrt(b.reshape(geo.m, geo.c))
    u = (x.reshape(geo.m, geo.r, geo.c) * rr[..., None]) * rc[:, None, :]
    return u.reshape(g.shape)


@torch.no_grad()
def adafactor_rms_emulated(grads, states, vrsum, *, scale, eps: float,
                           counts=None):
    """``adafactor_rms_kernel`` (``adafactor_rms_cuda``) in torch: a
    thread's u u in its rows' order, 8 elements a row in order, the
    block's tree a tile, the leaf's tiles by thread and tree."""
    geos, _ = adafactor_geometry([g.shape for g in grads])
    dev = grads[0].device
    epsf = _f(eps, dev)
    out = torch.zeros(len(grads), dtype=f32, device=dev)
    pairs = leaf_states([g.shape for g in grads], states)
    for i, (g, (a, b), geo, (R, _, _)) in enumerate(zip(
            grads, pairs, geos, _counts(grads, counts))):
        if geo.n == 0:
            continue
        u = _u(g, geo, a, b, vrsum, scale, epsf, R)
        t = _tiled(u * u, geo)
        del u
        t = t.reshape(*t.shape[:3], TILE_ROWS // 8, 8, 32, GROUP)
        acc = t[..., 0, :, :, 0]
        for q in range(TILE_ROWS // 8):
            for k in range(GROUP):
                if q or k:
                    acc = acc + t[..., q, :, :, k]
        del t
        parts = _tree_sum(acc.reshape(*acc.shape[:3], THREADS)).reshape(-1)
        out[i] = _tree_sum(_thread_sum(parts, THREADS))
    return out


@torch.no_grad()
def adafactor_update_emulated(grads, params, states, vrsum, u2sum, *, scale,
                              lr, eps: float, clip_threshold: float,
                              weight_decay: float, counts=None) -> None:
    """``adafactor_update_kernel`` (``adafactor_update_cuda``) in torch:
    each leaf's rms from its sum of u u, u again, the parameter in place."""
    geos, _ = adafactor_geometry([g.shape for g in grads])
    dev = grads[0].device
    epsf, wdf, one = _f(eps, dev), _f(weight_decay, dev), _f(1.0, dev)
    inv_clip = _f(np.float32(1.0) / np.float32(clip_threshold), dev)
    lr = torch.as_tensor(lr, dtype=f32, device=dev)
    pairs = leaf_states([g.shape for g in grads], states)
    for i, (g, p, (a, b), geo, (R, _, N)) in enumerate(zip(
            grads, params, pairs, geos, _counts(grads, counts))):
        if geo.n == 0:
            continue
        rms = torch.sqrt(u2sum[i] / _f(N, dev) + epsf)
        d = torch.maximum(rms * inv_clip, one)
        u = _u(g, geo, a, b, vrsum, scale, epsf, R) / d
        pf = p.to(f32)
        p.copy_((pf - lr * (u + wdf * pf)).to(p.dtype))


def flat_states(vs) -> list:
    """Adafactor's per-leaf states (``{"vr", "vc"}`` or ``{"v"}``) as the
    kernels' flat list: a factored leaf's vr and vc, a 1-D leaf's v."""
    return [t for v in vs for t in ((v["vr"], v["vc"]) if "vr" in v
                                    else (v["v"],))]


@torch.no_grad()
def adafactor_update_chunked_torch(grads, params, vs, *, scale, lr, beta2,
                                   eps: float, clip_threshold: float,
                                   weight_decay: float) -> None:
    """The three Adafactor kernels' launches of a step in torch (the moments
    fused), in place; the gradients are read, not written."""
    states = flat_states(vs)
    _, vrsum = adafactor_sums_emulated(grads, states, scale=scale,
                                       beta2=beta2, eps=eps)
    u2sum = adafactor_rms_emulated(grads, states, vrsum, scale=scale,
                                   eps=eps)
    adafactor_update_emulated(grads, params, states, vrsum, u2sum,
                              scale=scale, lr=lr, eps=eps,
                              clip_threshold=clip_threshold,
                              weight_decay=weight_decay)


__all__ = ["DTYPE_CODES", "adafactor_finish_emulated",
           "adafactor_rms_emulated", "adafactor_sums_emulated",
           "adafactor_update_chunked_torch", "adafactor_update_emulated",
           "adafactor_update_torch", "adamw_update_chunked_torch",
           "adamw_update_torch", "flat_states", "sumsq_chunked_torch",
           "sumsq_torch"]
