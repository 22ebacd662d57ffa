"""Kernel wrappers under DTensor: run a kernel on each rank's local shards.

A DTensor is a wrapper: its ``data_ptr()`` is 0, ``is_contiguous()`` says
True and ``is_cuda`` follows its mesh, so a ctypes launch handed one would
read a null pointer, or the global shape over a local buffer.  So every
kernel entry point that computes (``flash_attention``, ``wkv6``,
``rglru``) and is given a DTensor calls :func:`call_local` instead of its
kernel: the inputs are redistributed to placements that shard only the
dimensions the kernel treats independently -- the batch, and the heads
(or channels) where every input's head dimension divides the mesh axis --
and the entry point runs again on the local shards through
``torch.distributed.tensor.experimental.local_map`` (``jax.shard_map`` in
``repro``), which returns DTensors of the matching placements and carries
autograd through.  Every other dimension is replicated: a sequence
sharded over ``model`` is gathered before the attention, and a head count
the axis does not divide (GQA's KV heads under wider tensor parallelism)
keeps all heads on every rank, since local query head ``h`` would read
local KV head ``h // G`` and find another rank's.

The rule follows the first DTensor input's placements: a mesh dimension
that shards its batch (or head) dimension shards every input's batch (or
head) dimension, if it divides all of them; any other mesh dimension
replicates.  :data:`LOCAL_CALLS` counts the calls by op.

The arena ops take no DTensor (they raise ``TypeError``): an arena is one
replicated buffer, and ``core.executor.pack_buffers`` gathers a sharded
state whole before it packs it.
"""

from __future__ import annotations

from collections import Counter

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.parallel.sharding import as_dtensor

#: calls that went through ``local_map``, by op name
LOCAL_CALLS: Counter = Counter()

ROLES = ("batch", "heads")


def has_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def local(t):
    """The tensor a device test should read: a DTensor's local shard."""
    return t.to_local() if isinstance(t, DTensor) else t


def _roles_of(lead: DTensor, dims: dict, args, arg_dims) -> list:
    """For each mesh dimension, the role it shards (``"batch"``,
    ``"heads"``) or None (replicate)."""
    mesh = lead.device_mesh
    factor = dict.fromkeys(ROLES, 1)
    roles = []
    for j, p in enumerate(lead.placements):
        role = None
        if isinstance(p, Shard):
            role = next((r for r, d in dims.items() if d == p.dim), None)
        if role is not None:
            n = factor[role] * mesh.size(j)
            if all(a.shape[dd[role]] % n == 0
                   for a, dd in zip(args, arg_dims)
                   if torch.is_tensor(a) and dd and role in dd):
                factor[role] = n
            else:
                role = None
        roles.append(role)
    return roles


def call_local(op: str, fn, args, arg_dims, out_dims):
    """``fn(*local args)`` on every rank through ``local_map``.

    ``arg_dims[i]`` maps the roles ``"batch"``/``"heads"`` to the
    dimensions of ``args[i]`` that ``fn`` treats independently (``{}``: a
    tensor it needs whole; None: an argument passed as it is, such as
    None); ``out_dims`` does the same for each output of ``fn`` (a single
    dict for a single output; None for one that is not a tensor).  Plain
    tensors among ``args`` with dims are taken as replicated on every
    rank.  Returns DTensors."""
    lead_i = next(i for i, a in enumerate(args)
                  if isinstance(a, DTensor) and arg_dims[i] is not None)
    lead = args[lead_i]
    mesh = lead.device_mesh
    roles = _roles_of(lead, arg_dims[lead_i], args, arg_dims)

    def pl(dd):
        return tuple(Shard(dd[r]) if r is not None and r in dd
                     else Replicate() for r in roles)

    args = [as_dtensor(a, mesh) if torch.is_tensor(a)
            and arg_dims[i] is not None else a for i, a in enumerate(args)]
    in_pl = tuple(pl(dd) if isinstance(a, DTensor) else None
                  for a, dd in zip(args, arg_dims))
    single = isinstance(out_dims, dict)
    # one output's placements are a list: local_map reads a tuple as one
    # placement sequence per output
    out_pl = list(pl(out_dims)) if single else tuple(
        None if d is None else pl(d) for d in out_dims)
    LOCAL_CALLS[op] += 1
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     device_mesh=mesh, redistribute_inputs=True)(*args)
