"""Parameter definitions and the pytree helpers of the port.

Every module describes its parameters as a tree (nested dicts and lists)
of :class:`ParamDef` (shape + per-dimension *logical* axis names +
initializer + torch dtype), as ``repro.models.params`` does.  From one
definition tree:

  * ``init_params``       -- tensors drawn from a ``torch.Generator`` on a
                             device (the weights are random and seeded);
  * ``params_from_numpy`` -- the same tree filled from ``repro``'s
                             parameter pytree as numpy arrays (the parity
                             tests carry JAX-initialized weights across,
                             and, over ``opt.state_defs``, its optimizer
                             state).

  * ``param_pspecs``      -- the :class:`~repro_torch.parallel.sharding.P`
                             of every leaf under ``ShardingRules`` on a
                             mesh (a ``DeviceMesh``, or a ``MeshShape`` of
                             names and sizes), ``repro``'s rule;
  * ``abstract_params``   -- :class:`AbstractLeaf` (shape, dtype and
                             sharding; nothing allocated): the dry-run's
                             stand-ins;
  * ``distribute_params`` -- a full tree placed on a live mesh as DTensors
                             at those specs, leaf by leaf.

The tree helpers flatten dicts in **sorted-key order, as ``jax.tree``
does**: ``launch/serve.py:decode_state_graph`` numbers the decode state's
cache nodes by that leaf order, so any other order would give other arena
offsets than ``repro``'s.  ``None`` is an empty subtree, as in JAX.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.parallel.sharding import (
    NamedSharding,
    P,
    divisible_axes,
    place,
    placements,
    spec_entry,
)


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    logical: tuple[Any, ...]            # one logical name (or None) per dim
    init: str = "normal"                # normal | zeros | ones | embed
    dtype: torch.dtype = torch.bfloat16
    scale_axis: int = 0                 # fan-in axis for init scaling

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in length")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


# ------------------------------------------------------------ tree helpers

_LEAF = object()


def tree_flatten(tree, is_leaf: Callable | None = None):
    """``(leaves, treedef)`` in ``jax.tree`` order: dict keys sorted, lists
    and tuples in order, ``None`` an empty node."""
    leaves = []
    return leaves, _flatten(tree, is_leaf, leaves)


# the recursions are module functions, not closures: a nested function
# that calls itself is a reference cycle, which would keep the leaves (a
# decode state's tensors) alive until the garbage collector runs


def _flatten(t, is_leaf, leaves: list):
    if is_leaf is not None and is_leaf(t):
        leaves.append(t)
        return _LEAF
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, keys, [_flatten(t[k], is_leaf, leaves) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t), None, [_flatten(c, is_leaf, leaves) for c in t])
    if t is None:
        return (None, None, [])
    leaves.append(t)
    return _LEAF


def tree_unflatten(treedef, leaves):
    return _unflatten(treedef, iter(leaves))


def _unflatten(d, it):
    if d is _LEAF:
        return next(it)
    kind, keys, kids = d
    if kind is dict:
        return {k: _unflatten(c, it) for k, c in zip(keys, kids)}
    if kind is None:
        return None
    return kind(_unflatten(c, it) for c in kids)


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``, which must have the same structure)."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [tree_flatten(r, is_leaf)[0] for r in rest]
    for o in others:
        if len(o) != len(leaves):
            raise ValueError(f"tree_map: trees have {len(leaves)} and "
                             f"{len(o)} leaves")
    return tree_unflatten(treedef,
                          [fn(*xs) for xs in zip(leaves, *others)])


# ------------------------------------------------------------ parameters

#: a normal leaf of more elements than this is drawn one index of its
#: leading (layer) axis at a time: the f32 draw of a whole stacked leaf
#: would need 4 bytes an element beside the model (chameleon-34b's
#: ``mlp.wi_gate``, 8.7e9 elements, would want 35 GB of f32 next to its
#: 69 GB of bf16 weights).  Every leaf of the models served before this
#: limit existed is below it, so their draws are unchanged.
DRAW_LIMIT = 1 << 32


def _init_leaf(d: ParamDef, generator: torch.Generator, device):
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    fan_in = d.shape[d.scale_axis] if d.shape else 1
    std = 1.0 / math.sqrt(max(fan_in, 1))
    if d.init == "embed":
        std = 0.02          # GPT-style: keeps tied-logit scales sane
    if math.prod(d.shape) > DRAW_LIMIT:
        out = torch.empty(d.shape, dtype=d.dtype, device=device)
        for i in range(d.shape[0]):
            out[i] = torch.randn(d.shape[1:], generator=generator,
                                 dtype=torch.float32, device=device).mul_(std)
        return out
    x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(d.dtype)


def init_params(defs, generator: torch.Generator, device=None):
    """Materialize ``defs`` on ``device``, drawing every normal leaf from
    ``generator`` in leaf order (the generator must live on ``device``)."""
    leaves, treedef = tree_flatten(defs, is_leaf=is_def)
    return tree_unflatten(treedef,
                          [_init_leaf(d, generator, device) for d in leaves])


def zeros_from_defs(defs, device=None):
    """A tensor of zeros for every ``ParamDef`` of ``defs`` (its shape and
    dtype) on ``device``: a zeroed decode state."""
    return tree_map(
        lambda d: torch.zeros(d.shape, dtype=d.dtype, device=device), defs,
        is_leaf=is_def)


def params_from_numpy(defs, tree, device=None):
    """Fill ``defs`` from a tree of numpy arrays of the same structure
    (``repro``'s parameter pytree after ``np.asarray``), each leaf cast to
    its ``ParamDef`` dtype.  Floating leaves travel as float32, which
    holds bfloat16 exactly."""
    def leaf(d: ParamDef, a):
        a = np.asarray(a)
        if a.shape != tuple(d.shape):
            raise ValueError(f"leaf of shape {a.shape}, defined {d.shape}")
        if d.dtype.is_floating_point:
            a = np.asarray(a, dtype=np.float32)
        # a C-ordered copy: np.ascontiguousarray would make a 0-d leaf
        # (an optimizer's step) 1-d
        return torch.from_numpy(np.array(a, order="C")).to(
            device=device, dtype=d.dtype)

    d_leaves, treedef = tree_flatten(defs, is_leaf=is_def)
    a_leaves = tree_leaves(tree)
    if len(a_leaves) != len(d_leaves):
        raise ValueError(f"{len(a_leaves)} arrays for {len(d_leaves)} "
                         f"parameter definitions")
    return tree_unflatten(treedef,
                          [leaf(d, a) for d, a in zip(d_leaves, a_leaves)])


def stack_defs(defs, n: int):
    """Add a leading layer axis of size ``n`` to every ParamDef."""
    def st(d: ParamDef) -> ParamDef:
        return ParamDef(
            shape=(n, *d.shape),
            logical=(None, *d.logical),
            init=d.init,
            dtype=d.dtype,
            scale_axis=d.scale_axis + 1,
        )
    return tree_map(st, defs, is_leaf=is_def)


def leaf_count(defs) -> int:
    return sum(math.prod(d.shape) for d in tree_leaves(defs, is_leaf=is_def))


# ------------------------------------------------------------ sharding

def is_spec(x) -> bool:
    """A leaf of a :func:`param_pspecs` tree (a ``P`` is a tuple)."""
    return isinstance(x, P)


def _mesh_sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape))) if mesh \
        else {}


def param_pspecs(defs, rules, mesh=None):
    """Resolve logical axes -> :class:`P` for every leaf of ``defs``:
    ``repro``'s ``param_pspecs``.

    When ``mesh`` is given (a ``DeviceMesh`` or a ``MeshShape``), any mesh
    axis whose size does not evenly divide the tensor dimension is dropped
    (replicated) -- e.g. 8 GQA KV heads under 16-way TP stay replicated
    rather than failing to shard.  Two passes: ``sequence`` only takes the
    mesh axes the other dimensions leave free, so a cache whose KV heads
    do not divide the ``model`` axis shards its sequence over it instead.
    Trailing unsharded dimensions are dropped from the spec.
    """
    sizes = _mesh_sizes(mesh)

    def spec(d: ParamDef) -> P:
        axes: list = [None] * len(d.shape)
        used: set = set()

        def claim(i: int, dim: int, name) -> None:
            mesh_axis = rules.resolve(name)
            if mesh_axis is None:
                return
            flat = (mesh_axis,) if isinstance(mesh_axis, str) \
                else tuple(mesh_axis)
            free = divisible_axes(flat, dim, sizes, used)
            used.update(free)
            axes[i] = spec_entry(free)

        for i, (dim, name) in enumerate(zip(d.shape, d.logical)):
            if name != "sequence":
                claim(i, dim, name)
        for i, (dim, name) in enumerate(zip(d.shape, d.logical)):
            if name == "sequence":
                claim(i, dim, name)
        while axes and axes[-1] is None:
            axes.pop()
        return P(*axes)

    return tree_map(spec, defs, is_leaf=is_def)


@dataclasses.dataclass(frozen=True)
class AbstractLeaf:
    """A leaf's shape, dtype and sharding, with no storage: the counterpart
    of ``jax.ShapeDtypeStruct(shape, dtype, sharding=NamedSharding(...))``.
    It needs no live mesh."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding


def is_abstract(x) -> bool:
    return isinstance(x, AbstractLeaf)


def abstract_params(defs, rules, mesh):
    """An :class:`AbstractLeaf` for every leaf of ``defs``: shape and
    dtype of its definition, spec by :func:`param_pspecs` on ``mesh``."""
    specs = param_pspecs(defs, rules, mesh)
    d_leaves, treedef = tree_flatten(defs, is_leaf=is_def)
    return tree_unflatten(treedef, [
        AbstractLeaf(tuple(d.shape), d.dtype, NamedSharding(mesh, s))
        for d, s in zip(d_leaves, tree_leaves(specs, is_leaf=is_spec))])


def distribute_params(tree, defs, rules, mesh):
    """Place the full tree ``tree`` (laid out as ``defs``) on ``mesh`` as
    DTensors at :func:`param_pspecs`' specs, one leaf at a time, each
    replacing its full leaf rather than standing beside it.  Every rank
    holds the same full leaf (built from the same seed, or by
    ``params_from_numpy``) and keeps its own shard of it
    (``parallel.sharding.place``), so the sharded weights equal the
    unsharded ones bit for bit.  Each leaf must lie on the mesh's device
    type."""
    specs = tree_leaves(param_pspecs(defs, rules, mesh), is_leaf=is_spec)
    leaves, treedef = tree_flatten(tree)
    if len(leaves) != len(specs):
        raise ValueError(f"{len(leaves)} leaves for {len(specs)} parameter "
                         f"definitions")
    for i, s in enumerate(specs):
        leaf = leaves[i]
        leaves[i] = None
        leaves[i] = place(leaf, mesh, placements(s, mesh))
        del leaf
    return tree_unflatten(treedef, leaves)
