"""Residual blocks of the port: the dense transformer block.

The counterpart of ``repro.models.blocks`` for the dense family:

    defs  = transformer_block_defs(cfg)               # one layer's ParamDefs
    x, cache, aux = transformer_block_apply(p, x, ctx, cache)

``cache`` is the layer's decode state ({'k', 'v'} views into the stacked
cache, updated in place) or None.  MoE, MLA and the recurrent blocks wait
for their families (ROADMAP A5/A6).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import (
    Ctx,
    attn_apply,
    attn_defs,
    mlp_apply,
    mlp_defs,
    norm_defs,
    rms_norm,
)


def _dense_only(cfg: ArchConfig) -> None:
    if cfg.n_experts or cfg.mla is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE and MLA blocks are not ported yet "
            f"(ROADMAP A6); the port builds dense transformer blocks only")


def transformer_block_defs(cfg: ArchConfig) -> dict:
    _dense_only(cfg)
    return {
        "ln1": norm_defs(cfg.d_model),
        "attn": attn_defs(cfg),
        "ln2": norm_defs(cfg.d_model),
        "mlp": mlp_defs(cfg),
    }


def transformer_block_apply(p, x, ctx: Ctx, cache=None, *,
                            window: int | None = None):
    """Pre-norm attention + MLP residual block; returns (x, cache, aux)
    with ``aux`` 0.0 (the MoE balance loss of ``repro``; dense has none)."""
    h = rms_norm(x, p["ln1"])
    a, new_cache = attn_apply(p["attn"], h, ctx, cache=cache, window=window)
    x = x + a
    h = rms_norm(x, p["ln2"])
    return x + mlp_apply(p["mlp"], h, ctx.cfg), new_cache, 0.0
