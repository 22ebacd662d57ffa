"""Parallelism of the port: partition specs, activation sharding and their
DTensor placements (``sharding.py``), the counterpart of
``repro.parallel``.  The meshes are in ``launch/mesh.py``, the parameter
specs in ``models/params.py``, the expert-parallel MoE in
``models/moe_ep.py`` and the int8 collective in
``optim/grad_compress.py``.
"""

from repro_torch.parallel.sharding import (
    P,
    NamedSharding,
    act_spec,
    placements,
    shard_act,
)

__all__ = ["NamedSharding", "P", "act_spec", "placements", "shard_act"]
