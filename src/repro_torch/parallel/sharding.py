"""Partition specs, activation sharding and their DTensor placements: the
counterpart of ``repro.parallel.sharding``.

``repro`` shards with ``jax.sharding``: a :class:`P` (``PartitionSpec``)
per array names, for each dimension, the mesh axes that split it, and
``with_sharding_constraint`` pins an activation to one.  The port keeps
the specs and the rules that make them (``act_spec`` here,
``models.params.param_pspecs`` for parameters) as they are, so that both
packages give the same tuples, and turns a spec into ``torch.distributed``
placements on a ``DeviceMesh`` (:func:`placements`): mesh dimension ``j``
takes ``Shard(i)`` where its axis name appears in entry ``i``, and
``Replicate()`` elsewhere.  :func:`shard_act` is the constraint: a
``DTensor.redistribute`` to the spec's placements.

Everything is a no-op when ``rules is None`` (one device, no mesh).

A DTensor writes in place only where the write keeps its placements.
:func:`write_rows` is the in-place write of new rows into a decode cache
that the model code uses under rules: each rank writes the rows of its
own shard (a cache whose sequence dimension is split holds only some of
the positions), where ``buf[:, t:t + S] = new`` on a DTensor would write
into a temporary and be lost.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch.distributed.tensor import (
    DTensor,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import implicit_replication


class P(tuple):
    """``jax.sharding.PartitionSpec``: one entry per tensor dimension (a
    mesh-axis name, a tuple of names, or None), kept as given; a spec
    shorter than the tensor leaves the remaining dimensions replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: ``jax.sharding.NamedSharding``.  ``mesh`` is a
    ``DeviceMesh`` or a :class:`~repro_torch.launch.mesh.MeshShape`;
    :attr:`placements` needs only its axis names."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def _flatten(axis):
    if axis is None:
        return None
    if isinstance(axis, str):
        return axis
    if len(axis) == 0:
        return None
    return tuple(axis) if len(axis) > 1 else axis[0]


def act_spec(rules, kind: str) -> P:
    """kind: per-dim letters -- b(atch) s(equence) d/e(mbed) h(eads)
    v(ocab) x (experts) n(one).  A mesh axis is used at most once (first
    dim wins)."""
    table = {
        "b": rules.batch,
        "s": rules.sequence,
        "d": rules.act_embed,
        "e": rules.act_embed,
        "h": rules.tensor,
        "v": rules.tensor,
        "x": rules.expert,
        "n": None,
    }
    used: set = set()
    axes = []
    for c in kind:
        ax = _flatten(table[c])
        flat = () if ax is None else ((ax,) if isinstance(ax, str)
                                      else tuple(ax))
        free = tuple(a for a in flat if a not in used)
        used.update(free)
        axes.append(free[0] if len(free) == 1
                    else (free if free else None))
    return P(*axes)


def placements(spec, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: mesh dimension
    ``j`` shards tensor dimension ``i`` where ``spec[i]`` names its axis,
    and replicates where no entry names it.  DTensor splits a dimension
    sharded over several mesh dimensions in mesh order, as JAX splits a
    tuple entry in the tuple's order, so a tuple must list its axes in the
    mesh's order; any other order raises.  A mesh dimension of size 1
    replicates: its one shard is the whole tensor, and DTensor will not
    reshape a dimension it counts as sharded even there."""
    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out: list = [Replicate()] * len(names)
    used: set = set()
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        js = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not an "
                                 f"axis of the mesh {names}")
            js.append(names.index(a))
        if js != sorted(js):
            raise ValueError(f"spec entry {entry} lists its axes out of the "
                             f"mesh's order {names}: DTensor shards in mesh "
                             f"order")
        for j in js:
            if isinstance(out[j], Shard) or j in used:
                raise ValueError(f"spec {spec} uses axis {names[j]!r} twice")
            used.add(j)
            if sizes[j] > 1:
                out[j] = Shard(i)
    return tuple(out)


def check_device(x, mesh) -> None:
    """Raise unless the plain tensor ``x`` lies on the device type of
    ``mesh``.  DTensor would move it there without a word (a copy of a
    weight or an activation on the card to the host, where the wrappers
    would then run their plain versions)."""
    if x.device.type != mesh.device_type:
        raise ValueError(f"a tensor on {x.device.type} given to a mesh on "
                         f"{mesh.device_type}: build the mesh on the "
                         f"tensors' device (launch.mesh)")


def as_dtensor(x, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: itself if it is one, else a
    replicated wrapper of the local tensor (every rank holds the same
    values: the batch, positions, a state built the same way on each),
    which must lie on the mesh's device type (:func:`check_device`)."""
    if isinstance(x, DTensor):
        return x
    check_device(x, mesh)
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def place(t, mesh, pl) -> DTensor:
    """The whole tensor ``t``, held alike by every rank, as a DTensor of
    placements ``pl`` on ``mesh``: each rank keeps its own shard, without a
    collective, in a storage of its own (``distribute_tensor`` hands back
    a shard along dim 0 as a view of the whole tensor, which would keep
    every other rank's shard alive too).  ``t`` must lie on the mesh's
    device type (:func:`check_device`)."""
    check_device(t, mesh)
    dt = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
    loc = dt.to_local()
    if loc.untyped_storage().nbytes() > loc.nbytes:
        dt = DTensor.from_local(loc.clone(), mesh, dt.placements,
                                run_check=False, shape=dt.shape,
                                stride=dt.stride())
    return dt


def divisible_axes(axes, dim: int, sizes: dict, used=frozenset()) -> list:
    """The mesh axes of ``axes``, in order, that can split a dimension of
    size ``dim``: an axis in ``used`` is skipped, and so is one whose size
    does not divide what the axes kept before it leave (JAX pads an uneven
    shard, DTensor would hand ranks shards of unequal sizes).  An axis not
    in ``sizes`` is kept."""
    keep, rem = [], dim
    for a in axes:
        if a in used:
            continue
        sz = sizes.get(a)
        if sz is not None and rem % sz != 0:
            continue
        keep.append(a)
        if sz:
            rem //= sz
    return keep


def axis_size(rules, axes) -> int:
    """Ranks along ``axes`` (a mesh-axis name, a tuple of them, or None) of
    ``rules.mesh``: 1 for None or an axis the mesh lacks."""
    if axes is None:
        return 1
    sizes = dict(zip(rules.mesh.mesh_dim_names, tuple(rules.mesh.shape)))
    n = 1
    for a in (axes,) if isinstance(axes, str) else axes:
        n *= sizes.get(a, 1)
    return n


def spec_entry(axes):
    """A spec entry of the mesh axes ``axes``: None, one name, or a
    tuple."""
    return None if not axes else axes[0] if len(axes) == 1 else tuple(axes)


def shard_act(x, rules, kind: str):
    """``with_sharding_constraint(x, act_spec(rules, kind))``: ``x``
    itself without rules, else ``x`` redistributed to the spec's
    placements on ``rules.mesh``, less the axes that do not divide their
    dimension of ``x`` (:func:`divisible_axes`, as ``param_pspecs`` drops
    them); a plain tensor is taken as replicated first.

    Every projection flattens an activation's (batch, sequence) into the
    rows of one product.  Where this torch's DTensor cannot flatten a
    sequence split inside a split batch (:func:`flattens_split_rows`:
    torch 2.11 refuses), an activation whose batch and sequence are both
    split (``kind`` ``"bs..."``) takes the sequence's axes on its batch
    instead, if the batch divides over them all; each rank holds as many
    rows either way."""
    if rules is None:
        return x
    mesh = rules.mesh
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    axes = [divisible_axes(() if e is None else (e,) if isinstance(e, str)
                           else e, dim, sizes)
            for e, dim in zip(act_spec(rules, kind), x.shape)]
    if kind.startswith("bs") and axes[0] and axes[1] \
            and not flattens_split_rows(mesh):
        both = sorted(axes[0] + axes[1],
                      key=lambda a: mesh.mesh_dim_names.index(a))
        if x.shape[0] % math.prod(sizes[a] for a in both) == 0:
            axes[0], axes[1] = both, []
    spec = P(*(spec_entry(a) for a in axes))
    return as_dtensor(x, mesh).redistribute(mesh, placements(spec, mesh))


#: :func:`flattens_split_rows`' answer, found once a process
_FLATTENS: list = []


def flattens_split_rows(mesh) -> bool:
    """Whether this torch's DTensor flattens two dimensions split over two
    mesh dimensions (a sequence split inside a split batch) into one:
    later versions do, in strided shards; torch 2.11 refuses.  Found once
    a process by flattening such a DTensor over a meta tensor on two mesh
    dimensions of ``mesh`` with more than one rank (True where ``mesh``
    has fewer: nothing is split twice there), outside every dispatch mode
    (no collective: a view is metadata)."""
    js = [j for j, n in enumerate(tuple(mesh.shape)) if n > 1][:2]
    if len(js) < 2:
        return True
    if not _FLATTENS:
        from torch.utils._python_dispatch import _disable_current_modes
        pl = [Replicate()] * mesh.ndim
        pl[js[0]], pl[js[1]] = Shard(0), Shard(1)
        n0, n1 = mesh.size(js[0]), mesh.size(js[1])
        with _disable_current_modes():
            probe = DTensor.from_local(
                torch.empty((1, 1, 1), device="meta"), mesh, pl,
                run_check=False, shape=torch.Size((n0, n1, 1)),
                stride=(n1, 1, 1))
            try:
                probe.view(n0 * n1, 1)
                _FLATTENS.append(True)
            except (RuntimeError, AssertionError):
                _FLATTENS.append(False)
    return _FLATTENS[0]


#: how many :func:`sharded` contexts are open
_DEPTH = 0


@contextlib.contextmanager
def _implicit_replication():
    """``implicit_replication()``, entered by the outermost of nested
    contexts only: the library's turns the setting off on exit, which
    would end it for the context around it."""
    global _DEPTH
    _DEPTH += 1
    try:
        if _DEPTH == 1:
            with implicit_replication():
                yield
        else:
            yield
    finally:
        _DEPTH -= 1


def check_rules(rules) -> None:
    """Raise unless ``rules`` is None or carries the mesh it shards over
    (``launch.mesh.rules_for_mesh`` makes such rules)."""
    if rules is not None and getattr(rules, "mesh", None) is None:
        raise ValueError("sharding rules need a mesh to shard over: make "
                         "them with launch.mesh.rules_for_mesh(mesh)")


def sharded(rules):
    """The context a model function runs in under ``rules``: DTensor's
    implicit replication, so that the plain tensors a step makes (the
    positions, masks, constants) take part in operations on DTensors as
    replicated ones.  It nests; a no-op without rules; rules without a
    mesh raise (:func:`check_rules`)."""
    check_rules(rules)
    return contextlib.nullcontext() if rules is None \
        else _implicit_replication()


def full(x):
    """The whole tensor of ``x``: ``full_tensor()`` of a DTensor (every
    rank gets all of it), ``x`` itself otherwise."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# ------------------------------------------------------------ cache writes

def copy_into(dst, src) -> None:
    """``dst.copy_(src)`` in place, where ``dst`` may be a DTensor (a
    decode state's leaf, a kernel's ``state_out``): ``src`` is
    redistributed to ``dst``'s placements and each rank copies its own
    shard.  A DTensor's own ``copy_`` may write a temporary instead when
    the placements differ.  A plain tensor on one side must lie on the
    other side's mesh device type (:func:`check_device`)."""
    if isinstance(dst, DTensor):
        src = as_dtensor(src, dst.device_mesh).redistribute(
            dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        if isinstance(src, DTensor):
            check_device(dst, src.device_mesh)
        dst.copy_(full(src))


def _split_dims(buf: DTensor) -> set:
    """The dimensions of ``buf`` that some mesh dimension of size > 1
    splits."""
    mesh = buf.device_mesh
    return {p.dim for j, p in enumerate(buf.placements)
            if isinstance(p, Shard) and mesh.size(j) > 1}


def _chunk(n: int, k: int, i: int) -> tuple[int, int]:
    """(offset, size) of chunk ``i`` of ``k`` of a dimension of ``n``, as
    ``torch.chunk`` and DTensor's ``Shard`` cut it: chunks of ``ceil(n /
    k)``, the last ones short or empty."""
    c = -(-n // k)
    lo = min(i * c, n)
    return lo, min(n, lo + c) - lo


def local_extent(shape, mesh, pl, coord=None) -> tuple[list, list]:
    """``(local shape, global offsets)`` of the shard of a tensor of
    ``shape`` at placements ``pl`` on ``mesh`` that the rank at mesh
    coordinate ``coord`` (default this rank's) holds, on the host: each
    mesh dimension that shards a tensor dimension cuts what the mesh
    dimensions before it left (DTensor shards in mesh order).  No tensor
    is made, so it holds under a ``FakeTensorMode`` too."""
    coord = mesh.get_coordinate() if coord is None else coord
    off, size = [0] * len(shape), list(shape)
    for j, p in enumerate(pl):
        if isinstance(p, Shard):
            lo, size[p.dim] = _chunk(size[p.dim], mesh.size(j), coord[j])
            off[p.dim] += lo
    return size, off


def write_rows(buf, new, *, rows=None, positions=None, start=None) -> None:
    """Write ``new`` ``(B, S, ...)`` into ``buf`` ``(B, Smax, ...)`` in
    place, at sequence positions ``start + arange(S)`` (``start`` an int),
    at ``positions`` (a 1-D index of S consecutive positions, every row
    alike) or, with ``rows``, at ``(rows, positions)`` (both ``(B, S)``):
    the three forms of ``layers.attn_apply``'s cache write, for a DTensor
    ``buf``.

    ``new`` is redistributed to ``buf``'s placements except in the
    dimensions the write indexes (batch with ``rows``, sequence always),
    where it is replicated; each rank writes the entries that fall in its
    own shard.  Where no indexed dimension is split (one device, or
    batch- and head-sharded caches) that is the plain write on the local
    tensors, the same operation as without a mesh.  Where one is split the
    rank keeps the entries of its shard: by host arithmetic for an int
    ``start``, on the device for ``positions`` (no more than the shard
    holds), and otherwise by reading the index on the host (under rules
    the decode is eager: ``launch/steps.py``); none reads data on the host
    but the last, so the first two run on fake tensors too."""
    mesh = buf.device_mesh
    indexed = {0, 1} if rows is not None else {1}
    pl = [Replicate() if isinstance(p, Shard) and p.dim in indexed else p
          for p in buf.placements]
    new_l = as_dtensor(new.to(buf.dtype), mesh).redistribute(
        mesh, pl).to_local()
    buf_l = buf.to_local()
    S = new_l.shape[1]
    split = _split_dims(buf) & indexed
    if not split:
        if rows is not None:
            buf_l.index_put_((rows, positions), new_l)
        elif start is not None:
            buf_l[:, start:start + S] = new_l
        else:
            buf_l.index_copy_(1, positions, new_l)
        return
    off = local_extent(buf.shape, mesh, buf.placements)[1]
    n0, n1 = buf_l.shape[0], buf_l.shape[1]
    if start is not None:
        # the rows [start, start + S) that fall in this rank's shard, by
        # host arithmetic
        lo, hi = max(start - off[1], 0), min(start + S - off[1], n1)
        if lo < hi:
            a = lo - (start - off[1])
            buf_l[:, lo:hi] = new_l[:, a:a + hi - lo]
        return
    if rows is None and S <= n1:
        # consecutive positions (a decode step's t + arange(S)) fall on
        # distinct slots mod n1: each slot outside the shard is written
        # back with what it holds, so nothing is read on the host
        lp = positions.to(torch.long) - off[1]
        keep = ((lp >= 0) & (lp < n1)).view(1, S, *[1] * (new_l.dim() - 2))
        idx = lp % n1
        buf_l.index_copy_(1, idx, torch.where(keep, new_l,
                                              buf_l.index_select(1, idx)))
        return
    if rows is None:
        lp = positions.to(torch.long) - off[1]
        keep = ((lp >= 0) & (lp < n1)).nonzero()[:, 0]
        buf_l.index_copy_(1, lp[keep], new_l.index_select(1, keep))
        return
    lr = rows.to(torch.long) - off[0]
    lp = positions.to(torch.long) - off[1]
    keep = (lr >= 0) & (lr < n0) & (lp >= 0) & (lp < n1)
    buf_l.index_put_((lr[keep], lp[keep]), new_l[keep])
