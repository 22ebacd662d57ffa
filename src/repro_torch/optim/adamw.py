"""AdamW: the counterpart of ``repro.optim.adamw``.

The math is ``repro``'s: ``m`` and ``v`` in f32, bias correction by the
step, decoupled weight decay, the new parameter computed in f32 and
stored in the parameter's own dtype.  ``update`` writes the new
parameters and moments **into the given tensors** and returns them: the
counterpart of ``repro``'s ``jax.jit(step, donate_argnums=(0,))``, which
lets XLA reuse the old state's buffers.  Nothing of the old state is kept,
so a caller that needs it (a checkpoint, a comparison) copies it first.
``step`` is a 0-d int32 tensor, as in ``repro``, so that checkpoints of
the two packages hold the same leaves.  Sharded state (ZeRO-3) is the same
update on DTensors: the moments placed as their parameters
(``models.params.distribute_params`` of ``state_defs``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.params import ParamDef, is_def, tree_leaves, tree_map

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class adamw:
    lr: Any = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params):
        p0 = tree_leaves(params)[0]
        zeros = lambda p: torch.zeros(p.shape, dtype=f32, device=p.device)
        return {
            "step": torch.zeros((), dtype=torch.int32, device=p0.device),
            "m": tree_map(zeros, params),
            "v": tree_map(zeros, params),
        }

    def state_defs(self, param_defs):
        as_f32 = lambda d: ParamDef(d.shape, d.logical, init="zeros",
                                    dtype=f32)
        return {
            "step": ParamDef((), (), init="zeros", dtype=torch.int32),
            "m": tree_map(as_f32, param_defs, is_leaf=is_def),
            "v": tree_map(as_f32, param_defs, is_leaf=is_def),
        }

    @torch.no_grad()
    def update(self, grads, state, params, lr_scale=1.0):
        """One AdamW step, in place; returns ``(params, state)``, the given
        tensors updated (``state["step"]`` a new 0-d tensor)."""
        step = state["step"] + 1
        b1, b2 = self.b1, self.b2
        lr = self.lr * lr_scale
        t = step.to(f32)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(params)):
            g = g.to(f32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            del g
            upd = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            pf = p.to(f32)
            upd.add_(self.weight_decay * pf)
            p.copy_(pf - lr * upd)
        return params, {"step": step, "m": state["m"], "v": state["v"]}
