"""Adafactor (Shazeer & Stern 2018), factored second moments: the
counterpart of ``repro.optim.adafactor``.

Memory per parameter: O(rows + cols) instead of O(rows*cols) for >=2-D
tensors.  No first moment.  The math is ``repro``'s (``vr``/``vc`` for
>=2-D leaves, ``v`` for the rest, the update's RMS clipped at
``clip_threshold``); as in :mod:`repro_torch.optim.adamw`, ``update``
writes parameters and moments into the given tensors, the counterpart of
``repro``'s donated train state; ``step`` advances in place too, so that
a captured train step advances it on every replay.  Its update runs on
plain torch ops on the card as well (the fused Adafactor kernel is ROADMAP
B4's next item); the global-norm clip's scale (``clip_scale``) is applied
to the gradients in place first.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

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
    #: the clip's norm and scaling stay plain torch ops for this optimizer
    fused_clip = False

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
        ``clip_scale`` (None: not scaled); returns ``(params, state)``.
        ``impl`` is taken for the interface's sake: plain ops always."""
        if clip_scale is not None:
            for g in tree_leaves(grads):     # autograd's own: in place
                g.mul_(clip_scale.to(g.dtype))
        step = state["step"]
        step.add_(1)
        t = step.to(f32)
        beta2 = 1.0 - t ** (-self.decay)
        lr = self.lr * lr_scale
        flat_v = tree_flatten(state["v"], is_leaf=_is_vstate)[0]
        for g, v, p in zip(tree_leaves(grads), flat_v, tree_leaves(params)):
            g = g.to(f32)
            g2 = g * g + self.eps
            if _factored(p.shape):
                v["vr"].copy_(beta2 * v["vr"] + (1 - beta2) * g2.mean(-1))
                v["vc"].copy_(beta2 * v["vc"] + (1 - beta2) * g2.mean(-2))
                denom = torch.clamp(v["vr"].mean(-1, keepdim=True),
                                    min=self.eps)
                u = (g * torch.rsqrt(v["vr"] / denom)[..., None]
                     * torch.rsqrt(v["vc"])[..., None, :])
            else:
                v["v"].copy_(beta2 * v["v"] + (1 - beta2) * g2)
                u = g * torch.rsqrt(v["v"])
            rms = torch.sqrt(torch.mean(u * u) + self.eps)
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            pf = p.to(f32)
            p.copy_(pf - lr * (u + self.weight_decay * pf))
        return params, {"step": step, "v": state["v"]}
