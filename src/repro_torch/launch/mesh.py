"""Meshes of the port: the counterpart of ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
current process group (``jax.make_mesh`` over devices in ``repro``), with
named dimensions.  Planning needs only the names and sizes:
:class:`MeshShape` carries them for meshes no process group here has (the
production 16 x 16 and 2 x 16 x 16), and ``models.params.param_pspecs``
takes either.

:func:`init_single_process` starts a process group of one rank in this
process (an in-process ``HashStore``: no port, no network), NCCL on the
card and gloo on the CPU, so that a mesh of one device, and with it the
sharded steps, runs without a launcher.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShardingRules
from repro_torch.core.executor import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh given by axis names and sizes only, with the attributes of a
    ``DeviceMesh`` that planning reads."""
    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.shape) if dim is None else self.shape[dim]


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's axes and sizes: ``(data 16, model 16)``, or
    ``(pod 2, data 16, model 16)`` across pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _device_type(device) -> str:
    """The device type of a mesh for ``device``: ``None`` means the card,
    as for every entry point of the port (``core.executor.resolve_device``,
    which raises where there is no card)."""
    return resolve_device(device).type


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The production mesh over the current process group, which must have
    exactly its 256 (512 across pods) ranks: ``jax.make_mesh`` fails the
    same way without those devices.  On the card unless ``device`` says
    otherwise."""
    shape = production_shape(multi_pod=multi_pod)
    need = shape.size()
    if world_size() != need:
        dims = dict(zip(shape.mesh_dim_names, shape.shape))
        raise ValueError(f"the production mesh {dims} needs a world of "
                         f"{need} ranks; this process group has "
                         f"{world_size()}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(_device_type(device), shape.shape,
                            mesh_dim_names=shape.mesh_dim_names)


def make_host_mesh(data: int = 4, model: int = 2, *, device=None):
    """A ``(data, model)`` mesh over the ranks of the current process group
    (``data * model`` of them): on the card unless ``device`` says
    otherwise, and then on the CPU (gloo).  The tensors placed on it must
    lie on the same device type (``parallel.sharding.check_device``)."""
    from torch.distributed.device_mesh import init_device_mesh
    if world_size() != data * model:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; this process group has {world_size()}")
    return init_device_mesh(_device_type(device), (data, model),
                            mesh_dim_names=("data", "model"))


def init_single_process(device=None) -> None:
    """Start a process group of one rank in this process, if none is
    started: NCCL on the card (``device`` None or CUDA), gloo on the CPU,
    over an in-process ``HashStore``."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)


def rules_for_mesh(mesh, **overrides) -> ShardingRules:
    """Default DP(+pod) x FSDP x TP rules adapted to the mesh's axis names."""
    axes = set(mesh.mesh_dim_names)
    kw = dict(
        batch=tuple(a for a in ("pod", "data") if a in axes),
        fsdp="data" if "data" in axes else None,
        tensor="model" if "model" in axes else None,
        expert="model" if "model" in axes else None,
        # caches: sequence dim takes whatever the KV-head dim leaves free
        # (two-pass resolution in param_pspecs)
        sequence="model" if "model" in axes else None,
        act_embed=None,
    )
    kw.update(overrides)
    return ShardingRules(mesh=mesh, **kw)
