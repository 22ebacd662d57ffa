"""Adafactor (Shazeer & Stern 2018), factored second moments: the
counterpart of ``repro.optim.adafactor``.

Memory per parameter: O(rows + cols) instead of O(rows*cols) for >=2-D
tensors.  No first moment.  The math is ``repro``'s (``vr``/``vc`` for
>=2-D leaves, ``v`` for the rest, the update's RMS clipped at
``clip_threshold``); as in :mod:`repro_torch.optim.adamw`, ``update``
writes parameters and moments into the given tensors, the counterpart of
``repro``'s donated train state; ``step`` advances in place too, so that
a captured train step advances it on every replay.

``update`` takes the global-norm clip's scale as well (``clip_scale``, a
0-d f32 tensor: each gradient scaled in its own dtype first, as
``repro``'s step does).  On the card the scaling and the update of every
leaf are three launches (``adafactor_sums_kernel``,
``adafactor_rms_kernel``, ``adafactor_update_kernel`` of
``csrc/adafactor.cu``, through ``kernels/optim``), within a limit of the
plain ops (their sums in another order); on the CPU, or with
``impl="torch"``, the plain ops of
``kernels/optim/ref.py:adafactor_update_torch``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.optim.ops import adafactor_update
from repro_torch.models.params import (
    ParamDef,
    is_def,
    tree_flatten,
    tree_leaves,
    tree_map,
)

f32 = torch.float32


def _factored(shape) -> bool:
    return len(shape) >= 2


def _is_vstate(x) -> bool:
    return isinstance(x, dict) and ("v" in x or "vr" in x)


@dataclasses.dataclass(frozen=True)
class adafactor:
    lr: Any = 1e-3
    decay: float = 0.8          # \hat{beta2}_t = 1 - t^{-decay}
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    #: the clip's scaling is part of this optimizer's update (on the card
    #: in its kernels); ``make_train_step`` takes the norm through the
    #: squared-sum kernel for such an optimizer
    fused_clip = True

    def init(self, params):
        def st(p):
            z = lambda shape: torch.zeros(shape, dtype=f32, device=p.device)
            if _factored(p.shape):
                return {"vr": z(p.shape[:-1]),
                        "vc": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}

        p0 = tree_leaves(params)[0]
        return {"step": torch.zeros((), dtype=torch.int32, device=p0.device),
                "v": tree_map(st, params)}

    def state_defs(self, param_defs):
        def st(d: ParamDef):
            if _factored(d.shape):
                return {
                    "vr": ParamDef(d.shape[:-1], d.logical[:-1],
                                   init="zeros", dtype=f32),
                    "vc": ParamDef(d.shape[:-2] + d.shape[-1:],
                                   d.logical[:-2] + d.logical[-1:],
                                   init="zeros", dtype=f32),
                }
            return {"v": ParamDef(d.shape, d.logical, init="zeros",
                                  dtype=f32)}

        return {"step": ParamDef((), (), init="zeros", dtype=torch.int32),
                "v": tree_map(st, param_defs, is_leaf=is_def)}

    @torch.no_grad()
    def update(self, grads, state, params, lr_scale=1.0, *,
               clip_scale=None, impl: str = "auto"):
        """One Adafactor step, in place, the gradients first scaled by
        ``clip_scale`` (None: not scaled); returns ``(params, state)``, the
        given tensors updated (``state["step"]`` advanced in place).
        ``impl``: ``kernels/optim/ops.py``'s (the kernels on the card under
        ``"auto"``)."""
        step = state["step"]
        step.add_(1)
        t = step.to(f32)
        beta2 = 1.0 - t ** (-self.decay)
        lr = self.lr * lr_scale
        flat_v = tree_flatten(state["v"], is_leaf=_is_vstate)[0]
        adafactor_update(tree_leaves(grads), tree_leaves(params), flat_v,
                         scale=clip_scale, lr=lr, beta2=beta2, eps=self.eps,
                         clip_threshold=self.clip_threshold,
                         weight_decay=self.weight_decay, impl=impl)
        return params, {"step": step, "v": state["v"]}
