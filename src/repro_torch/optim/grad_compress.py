"""Error-feedback int8 gradient compression: the counterpart of
``repro.optim.grad_compress``.

``quantize``/``dequantize`` (symmetric per-tensor int8 with one f32
scale), ``ef_compress`` (g' = Q(g + err), err' = (g + err) - g') and
``init_error``: the same codes and scales as ``repro`` on the same input
(``torch.round`` rounds half to even, as ``jnp.round`` does).
``compressed_psum`` is the collective that sums the codes across the ranks
of a group (``repro``'s inside ``shard_map`` over an axis name): the
amax exchanged first (an all-reduce MAX) so every rank quantizes onto one
grid, the int8 codes summed in int32, then rescaled.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.params import (
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
)

f32 = torch.float32


def quantize(x: torch.Tensor, *, bits: int = 8):
    """Symmetric per-tensor int quantization; returns ``(q, scale)``."""
    lim = float(2 ** (bits - 1) - 1)
    xf = x.to(f32)
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp(amax, min=1e-12) / lim
    q = torch.clamp(torch.round(xf / scale), -lim, lim).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(f32) * scale


def ef_compress(grads, err):
    """Error feedback over a tree: returns ``(grads', err')``, each leaf of
    ``grads'`` in its gradient's dtype, ``err'`` in f32."""
    g_leaves, treedef = tree_flatten(grads)
    out_g, out_e = [], []
    for g, e in zip(g_leaves, tree_leaves(err)):
        ge = g.to(f32) + e
        deq = dequantize(*quantize(ge))
        out_g.append(deq.to(g.dtype))
        out_e.append(ge - deq)
    return tree_unflatten(treedef, out_g), tree_unflatten(treedef, out_e)


def init_error(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=f32,
                                          device=p.device), params)


def _group(group):
    """A process group from a ``DeviceMesh`` of one dimension, a
    ``(mesh, dim name)`` pair, or a process group (None: the default)."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The int8-payload sum of ``x`` over the ranks of ``group`` (a
    ``DeviceMesh`` dimension -- a one-dimensional mesh or ``(mesh, name)``
    -- or a process group): the counterpart of ``repro``'s
    ``compressed_psum(x, axis_name)``.  Every rank passes its local ``x``
    and gets the sum in ``x``'s dtype.

    The amax is all-reduced (MAX) first, so every rank quantizes onto the
    same grid; the codes are summed in int32 (no overflow for up to 2^23
    ranks) and rescaled."""
    pg = _group(group)
    xf = x.to(f32)
    amax = torch.max(torch.abs(xf))
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=pg)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=pg)
    return (total.to(f32) * scale).to(x.dtype)
