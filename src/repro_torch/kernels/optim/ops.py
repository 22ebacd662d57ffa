"""Public optimizer ops: impl dispatch.

``sumsq(grads, impl=)``, ``global_norm(grads, impl=)``,
``adamw_update(grads, params, ms, vs, ..., impl=)`` and
``adafactor_update(grads, params, vs, ..., impl=)``:

  * ``"auto"``            -- the CUDA kernels (``csrc/adamw.cu``,
                             ``csrc/adafactor.cu``) for leaves on the card,
                             ``"torch"`` for leaves on the CPU;
  * ``"cuda"``            -- the CUDA kernels; raises for leaves on the CPU;
  * ``"torch"``/``"ref"`` -- the plain torch ops (``ref.sumsq_torch``,
                             ``ref.adamw_update_torch``,
                             ``ref.adafactor_update_torch``): the CPU path
                             and the version the kernels are held against.

No environment variable changes the choice, and a CUDA leaf never falls
back: a library that fails to build or load raises.

DTensor leaves (a train step under sharding rules) run the kernels on each
rank's local shards (``kernels/_local.py:local``).  A gradient that
autograd hands back ``Partial`` (a parameter replicated over a mesh
dimension that shards the batch: each rank holds a term of the sum) is
reduced first, since the squared sum needs the whole gradient: the ranks'
sums of g_r^2 are not the square of the sum of g_r.  ``make_train_step``
does it once (``placed_like``), so that the norm and the update read the
same reduced gradients; ``sumsq`` and ``adamw_update`` reduce any that
they are still given.  The update is elementwise, so each rank updates its
shards of the gradient, parameter and moments (placed alike); each leaf's
local squared sum becomes a DTensor that is ``Partial`` over the mesh
dimensions that shard the leaf and replicated over the rest -- the
placements ``torch.sum`` of the squared DTensor gives -- so the norm's sum
and square root reduce across ranks as the plain ops' do.  At world size
1 that is the unsharded run's bits.

Adafactor's sums are partial on a shard: a row's sum of g2 where the
leaf's columns are sharded, a column's where its rows are, a matrix's sum
of vr where its rows are, a leaf's sum of u u where any dimension is.  So
under sharding its moments take two launches (the raw sums, then the
moments from them: ``adafactor_sums_cuda(fused=False)``,
``adafactor_finish_cuda``), and each partial sum is reduced across the
mesh dimensions that shard it between launches (``_reduce_over``); the
means divide by the whole leaf's counts.  Unsharded, a step is three
launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _grad, _local
from repro_torch.kernels.optim import kernel as _kernel
from repro_torch.kernels.optim.ref import (
    adafactor_update_torch,
    adamw_update_torch,
    flat_states,
    sumsq_torch,
)

IMPLS = ("auto", "cuda", "torch", "ref")


def use_kernels(impl: str, leaf) -> bool:
    """Whether ``impl`` takes the CUDA kernels for leaves like ``leaf``."""
    if impl not in IMPLS:
        raise ValueError(f"unknown optimizer impl {impl!r}; expected one "
                         f"of {IMPLS}")
    if impl == "auto":
        return _grad.on_card(leaf)
    if impl == "cuda" and not _grad.on_card(leaf):
        raise ValueError(f"impl='cuda' needs CUDA tensors; got a leaf on "
                         f"{_local.local(leaf).device}")
    return impl == "cuda"


def _dense(grads) -> list:
    """Each gradient's local tensor in its parameter's (row-major) layout:
    autograd may hand a gradient back strided (a product's transpose), and
    the kernels read a leaf element for element beside its parameter and
    moments.  A contiguous gradient is taken as it is."""
    return [_local.local(g).contiguous() for g in grads]


def placed_like(grads, params) -> list:
    """Each DTensor gradient redistributed to its parameter's placements
    where they differ (a ``Partial`` gradient reduced, a gradient placed
    otherwise resharded); plain tensors as they are."""
    from torch.distributed.tensor import DTensor

    return [g.redistribute(p.device_mesh, p.placements)
            if isinstance(g, DTensor) and g.placements != p.placements
            else g for g, p in zip(grads, params)]


def _whole_terms(g):
    """``g`` with every ``Partial`` placement reduced (to ``Replicate``):
    a squared sum needs the gradient's value, not a rank's term of it."""
    from torch.distributed.tensor import Replicate

    if not any(p.is_partial() for p in g.placements):
        return g
    return g.redistribute(g.device_mesh, [
        Replicate() if p.is_partial() else p for p in g.placements])


def _partial_like(local_sum, like):
    """``local_sum`` (a rank's squared sum of its shard of the DTensor
    ``like``) as the DTensor ``torch.sum`` would give: ``Partial`` over
    the mesh dimensions that shard ``like``."""
    from torch.distributed.tensor import DTensor, Partial

    placements = [Partial() if p.is_shard() else p for p in like.placements]
    return DTensor.from_local(local_sum, like.device_mesh, placements,
                              run_check=False)


def sumsq(grads, *, impl: str = "auto") -> list:
    """Each gradient leaf's squared sum in f32, a 0-d tensor each (a
    DTensor each for DTensor leaves): one ``sumsq_kernel`` launch over all
    leaves on the card, ``torch.sum(torch.square(g.float()))`` a leaf
    otherwise."""
    grads = list(grads)
    if not use_kernels(impl, grads[0]):
        return sumsq_torch(grads)
    if _local.has_dtensor(*grads):
        grads = [_whole_terms(g) for g in grads]
    sums = _kernel.sumsq_cuda(_dense(grads)).unbind(0)
    if _local.has_dtensor(*grads):
        return [_partial_like(s, g) for s, g in zip(sums, grads)]
    return list(sums)


def global_norm(grads, *, impl: str = "auto"):
    """The global norm of ``grads``: the square root of the leaves' squared
    sums (:func:`sumsq`) added in leaf order, in f32."""
    return torch.sqrt(sum(sumsq(grads, impl=impl)))


def adamw_update(grads, params, ms, vs, *, scale, lr, bc1, bc2, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 impl: str = "auto") -> None:
    """The clip's scaling by ``scale`` (a 0-d f32 tensor, or None) and the
    AdamW update of every leaf, in place: one ``adamw_update_kernel``
    launch on the card (the gradients read, not written), the plain ops of
    ``ref.adamw_update_torch`` otherwise (which scale the gradients in
    place).  ``lr``, ``bc1``, ``bc2``: 0-d f32 tensors (``lr`` may be a
    number)."""
    grads, params, ms, vs = (list(x) for x in (grads, params, ms, vs))
    kw = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    if not use_kernels(impl, grads[0]):
        adamw_update_torch(grads, params, ms, vs, scale=scale, lr=lr,
                           bc1=bc1, bc2=bc2, **kw)
        return
    if _local.has_dtensor(*grads, *params):
        grads = placed_like(grads, params)
    loc = lambda ts: [_local.local(t) for t in ts]  # noqa: E731
    dev = _local.local(params[0]).device
    if not isinstance(lr, torch.Tensor):
        lr = torch.tensor(lr, dtype=torch.float32, device=dev)
    scalars = [None if t is None else _local.local(t)
               for t in (scale, lr, bc1, bc2)]
    _kernel.adamw_update_cuda(_dense(grads), loc(params), loc(ms), loc(vs),
                              scale=scalars[0], lr=scalars[1],
                              bc1=scalars[2], bc2=scalars[3], **kw)


def _reduce_over(local, like, dims):
    """``local`` (a rank's partial sums, a plain tensor) summed across the
    mesh dimensions that shard the DTensor ``like`` along any of the
    tensor dimensions ``dims`` (``Partial`` there, reduced to
    ``Replicate``); as it is where none does."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(like, DTensor):
        return local
    nd = like.dim()
    part = [p.is_shard() and p.dim % nd in dims for p in like.placements]
    if not any(part):
        return local
    mesh = like.device_mesh
    d = DTensor.from_local(local, mesh, [Partial() if q else Replicate()
                                         for q in part], run_check=False)
    return d.redistribute(mesh, [Replicate()] * len(part)).to_local()


def adafactor_update(grads, params, vs, *, scale, lr, beta2, eps: float,
                     clip_threshold: float, weight_decay: float,
                     impl: str = "auto") -> None:
    """The clip's scaling by ``scale`` (a 0-d f32 tensor, or None) and the
    Adafactor update of every leaf (``vs``: ``{"vr", "vc"}`` or ``{"v"}`` a
    leaf), in place: on the card three launches (``adafactor_sums_kernel``,
    ``adafactor_rms_kernel``, ``adafactor_update_kernel``; the gradients
    read, not written), under sharding four with the partial sums reduced
    between them; the plain ops of ``ref.adafactor_update_torch`` otherwise
    (which scale the gradients in place).  ``beta2``: a 0-d f32 tensor;
    ``lr``: one, or a number."""
    grads, params, vs = list(grads), list(params), list(vs)
    kw = dict(eps=eps, clip_threshold=clip_threshold,
              weight_decay=weight_decay)
    if not use_kernels(impl, grads[0]):
        adafactor_update_torch(grads, params, vs, scale=scale, lr=lr,
                               beta2=beta2, **kw)
        return
    adafactor_kernels(grads, params, vs, scale=scale, lr=lr, beta2=beta2,
                      split=_local.has_dtensor(*grads, *params), **kw)


def adafactor_kernels(grads, params, vs, *, scale, lr, beta2, eps: float,
                      clip_threshold: float, weight_decay: float,
                      split: bool) -> None:
    """:func:`adafactor_update`'s kernel route on the card.  ``split``: the
    moments in two launches (the raw row and column sums, then the moments
    from them), each partial sum reduced across the mesh dimensions that
    shard its leaf between launches -- the route DTensor leaves take; on
    plain tensors nothing is reduced and the route gives the fused one's
    bits (``chip_smoke.adafactor_check_set`` holds it so on the card)."""
    kw = dict(eps=eps, clip_threshold=clip_threshold,
              weight_decay=weight_decay)
    if _local.has_dtensor(*grads, *params):
        grads = placed_like(grads, params)
    states = flat_states(vs)
    counts = _kernel.whole_counts([p.shape for p in params])
    g, p, s = _dense(grads), [_local.local(t) for t in params], \
        [_local.local(t) for t in states]
    dev = p[0].device
    if not isinstance(lr, torch.Tensor):
        lr = torch.tensor(lr, dtype=torch.float32, device=dev)
    scale, lr, beta2 = (None if t is None else _local.local(t)
                        for t in (scale, lr, beta2))
    if not split:
        _, vrsum = _kernel.adafactor_sums_cuda(g, s, scale=scale,
                                               beta2=beta2, eps=eps)
        u2sum = _kernel.adafactor_rms_cuda(g, s, vrsum, scale=scale,
                                           eps=eps)
    else:
        geos, _ = _kernel.adafactor_geometry([t.shape for t in g])
        sums, _ = _kernel.adafactor_sums_cuda(g, s, scale=scale, beta2=beta2,
                                              eps=eps, counts=counts,
                                              fused=False)
        for geo, like in zip(geos, params):
            if geo.factored:            # rows over the columns' shards,
                nd = like.dim()         # columns over the rows'
                a, b = geo.sums, geo.sums + geo.m * geo.r
                c = b + geo.m * geo.c
                sums[a:b] = _reduce_over(sums[a:b], like, {nd - 1})
                sums[b:c] = _reduce_over(sums[b:c], like, {nd - 2})
        vrsum = _kernel.adafactor_finish_cuda(sums, g, s, beta2=beta2,
                                              counts=counts)
        for geo, like in zip(geos, params):
            if geo.factored:
                a = slice(geo.first_mat, geo.first_mat + geo.m)
                vrsum[a] = _reduce_over(vrsum[a], like, {like.dim() - 2})
        u2sum = _kernel.adafactor_rms_cuda(g, s, vrsum, scale=scale,
                                           eps=eps, counts=counts)
        u2sum = torch.stack([
            _reduce_over(u2sum[i], like, set(range(like.dim())))
            for i, like in enumerate(params)])
    _kernel.adafactor_update_cuda(g, p, s, vrsum, u2sum, scale=scale, lr=lr,
                                  counts=counts, **kw)
