"""AdamW: the counterpart of ``repro.optim.adamw``.

The math is ``repro``'s: ``m`` and ``v`` in f32, bias correction by the
step, decoupled weight decay, the new parameter computed in f32 and
stored in the parameter's own dtype.  ``update`` writes the new
parameters and moments **into the given tensors** and returns them: the
counterpart of ``repro``'s ``jax.jit(step, donate_argnums=(0,))``, which
lets XLA reuse the old state's buffers.  Nothing of the old state is kept,
so a caller that needs it (a checkpoint, a comparison) copies it first.
``step`` is a 0-d int32 tensor, as in ``repro``, so that checkpoints of
the two packages hold the same leaves; it too advances in place, so that a
captured train step (``launch/steps.py:CapturedTrainStep``) advances it on
every replay.

``update`` takes the global-norm clip's scale as well (``clip_scale``, a
0-d f32 tensor: each gradient scaled in its own dtype first, as
``repro``'s step does).  On the card the scaling and the update of every
leaf are one launch of ``adamw_update_kernel`` (``kernels/optim``),
bit-equal to the plain ops; on the CPU, or with ``impl="torch"``, the
plain ops of ``kernels/optim/ref.py:adamw_update_torch``.

Sharded state (ZeRO-3) is the same update on DTensors: the moments placed
as their parameters (``models.params.distribute_params`` of
``state_defs``); on the card the kernel updates each rank's shards.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.optim.ops import adamw_update
from repro_torch.models.params import ParamDef, is_def, tree_leaves, tree_map

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class adamw:
    lr: Any = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    #: the clip's scaling is part of this optimizer's update (one launch
    #: with it on the card); ``make_train_step`` takes the norm through the
    #: squared-sum kernel for such an optimizer
    fused_clip = True

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
    def update(self, grads, state, params, lr_scale=1.0, *,
               clip_scale=None, impl: str = "auto"):
        """One AdamW step, in place, the gradients first scaled by
        ``clip_scale`` (None: not scaled); returns ``(params, state)``, the
        given tensors updated (``state["step"]`` advanced in place).
        ``impl``: ``kernels/optim/ops.py``'s (the kernel on the card under
        ``"auto"``)."""
        step = state["step"]
        step.add_(1)
        b1, b2 = self.b1, self.b2
        lr = self.lr * lr_scale
        t = step.to(f32)
        bc1 = 1.0 - torch.pow(b1, t)
        bc2 = 1.0 - torch.pow(b2, t)
        adamw_update(tree_leaves(grads), tree_leaves(params),
                     tree_leaves(state["m"]), tree_leaves(state["v"]),
                     scale=clip_scale, lr=lr, bc1=bc1, bc2=bc2, b1=b1,
                     b2=b2, eps=self.eps, weight_decay=self.weight_decay,
                     impl=impl)
        return params, {"step": step, "m": state["m"], "v": state["v"]}
