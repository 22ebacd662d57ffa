"""PyTorch functions of irregular wiring for the graph bridge
(:mod:`repro_torch.core.fx_bridge`).

Each is the torch counterpart of a function the JAX package schedules
through its jaxpr bridge, written op for op so both lift to the same
graph: ``jnp.ones`` becomes ``torch.ones`` on the input's device and
dtype, ``jax.nn.gelu`` becomes ``F.gelu(..., approximate="tanh")`` (its
default form).

  wide              -- ``tests/test_jax_bridge.py:_wide``
  nas_cell          -- ``benchmarks/bench_jaxpr_sched.py:nas_cell`` (six
                       expand/project branches into one concat)
  nas_like          -- ``tests/test_executor.py``'s ``nas_like`` (four
                       branches)
  moe_fanout        -- ``bench_jaxpr_sched.py:moe_fanout``
  branchy_residual  -- ``bench_jaxpr_sched.py:branchy_residual``
  mixed             -- ``tests/test_executor.py``'s ``mixed``: bf16 and
                       f32 tensors, a bool intermediate, a dict output

``PROGRAMS`` maps each name to ``(fn, args)``: ``args(x)`` builds the
call's arguments from one f32 tensor ``x``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _ones(x, *shape):
    return torch.ones(shape, dtype=x.dtype, device=x.device)


def wide(x):
    hs = [torch.tanh(x * i) @ _ones(x, 64, 256) for i in range(1, 5)]
    return sum((h @ _ones(x, 256, 4)).sum() for h in hs)


def nas_cell(x):
    branches = []
    for i in range(6):
        h = torch.tanh(x * (i + 1.0))
        h = h @ _ones(x, x.shape[-1], 4 * x.shape[-1])
        h = torch.relu(h)
        h = h @ _ones(x, 4 * x.shape[-1], 16)
        branches.append(h)
    return torch.sum(torch.cat(branches, -1) ** 2)


def nas_like(x):
    branches = []
    for i in range(4):
        h = torch.tanh(x * (i + 1.0))
        h = h @ _ones(x, x.shape[-1], 2 * x.shape[-1])
        h = torch.relu(h) @ _ones(x, 2 * x.shape[-1], 8)
        branches.append(h)
    return torch.sum(torch.cat(branches, -1) ** 2)


def moe_fanout(x):
    outs = []
    for e in range(8):
        h = x @ _ones(x, x.shape[-1], 256) * (e + 1)
        outs.append(F.gelu(h, approximate="tanh") @ _ones(x, 256, 64))
    return sum(o.sum() for o in outs)


def branchy_residual(x):
    hs = [torch.tanh(x * i) @ _ones(x, x.shape[-1], 512)
          for i in range(1, 7)]
    return sum((h @ _ones(x, 512, 8)).sum() for h in hs)


def mixed(a, b):
    c = (a * 2).to(torch.bfloat16)
    d = torch.sum(c.to(torch.float32)) + b
    return {"c": c, "d": d, "count": (a > 0).sum()}


PROGRAMS = {
    "wide": (wide, lambda x: (x,)),
    "nas_cell": (nas_cell, lambda x: (x,)),
    "nas_like": (nas_like, lambda x: (x,)),
    "moe_fanout": (moe_fanout, lambda x: (x,)),
    "branchy_residual": (branchy_residual, lambda x: (x,)),
    "mixed": (mixed, lambda x: (x, x[0, 0] * 0 + 3.0)),
}
