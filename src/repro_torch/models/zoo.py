"""Model zoo of the port: the dense decoder LM.

``build_model(cfg) -> Model`` with:
    defs        ParamDef tree (layers stacked on a leading axis)
    init(generator, device)                            materialized params
    make_cache_defs(batch_size, max_len)               ParamDef tree (decode state)
    init_cache(batch_size, max_len, device)            zeroed decode state
    prefill_fn(params, cache, batch, *, impl, rules)   -> (logits_last, cache)
    decode_fn(params, cache, tokens, t, *, impl, rules) -> (logits, cache)

The counterpart of ``repro.models.zoo.build_decoder_lm`` for dense configs,
with the same parameter tree (names and stacked shapes), so that
``params_from_numpy`` maps ``repro``'s parameters one to one.  The layer
stack is a Python loop over the stacked parameters (the counterpart of
``_scan_stack``); the cache is updated in place and returned.  ``loss_fn``
waits for training (ROADMAP A7).  ``build_model`` raises for the families
the port does not build yet (ROADMAP A5/A6).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks as B
from repro_torch.models.layers import (
    Ctx,
    embed_apply,
    embed_defs,
    logits_apply,
    norm_defs,
    rms_norm,
)
from repro_torch.models.params import (
    ParamDef,
    init_params,
    is_def,
    stack_defs,
    tree_map,
)


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    defs: Any
    init: Callable
    make_cache_defs: Callable
    init_cache: Callable
    prefill_fn: Callable
    decode_fn: Callable


def _kv_cache_defs(cfg: ArchConfig, n_layers, bsz, smax, window=None):
    eff = min(smax, window) if window else smax
    shape = (n_layers, bsz, eff, cfg.n_kv_heads, cfg.head_dim)
    logical = (None, "batch", "sequence", "tensor", None)
    return {
        "k": ParamDef(shape, logical, init="zeros"),
        "v": ParamDef(shape, logical, init="zeros"),
    }


def _layer(stacked, i: int):
    """Layer ``i``'s parameters (or cache) as views of the stacked tree."""
    return tree_map(lambda a: a[i], stacked)


def build_decoder_lm(cfg: ArchConfig) -> Model:
    if cfg.n_experts or cfg.mla is not None or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: MoE, MLA and MTP decoders are not ported yet "
            f"(ROADMAP A6)")
    n_layers = cfg.n_layers
    defs = {"embed": embed_defs(cfg), "ln_f": norm_defs(cfg.d_model),
            "dense": stack_defs(B.transformer_block_defs(cfg), n_layers)}

    def init(generator: torch.Generator, device=None):
        return init_params(defs, generator, device)

    def backbone(params, x, ctx, caches):
        dense = params["dense"]
        cache = caches["dense"] if caches else None
        for i in range(n_layers):
            c = _layer(cache, i) if cache is not None else None
            x, _, _ = B.transformer_block_apply(_layer(dense, i), x, ctx, c)
        return x

    def make_cache_defs(bsz, smax):
        return {"dense": _kv_cache_defs(cfg, n_layers, bsz, smax)}

    def init_cache(bsz, smax, device=None):
        return tree_map(
            lambda d: torch.zeros(d.shape, dtype=d.dtype, device=device),
            make_cache_defs(bsz, smax), is_leaf=is_def)

    def _fwd_cached(params, cache, tokens, t, *, impl, rules, decode):
        Bz, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None]
        if decode:
            pos = pos + int(t)
        ctx = Ctx(cfg=cfg, impl=impl, positions=pos.expand(Bz, S),
                  decode=decode, cache_len=t, rules=rules)
        x = embed_apply(params["embed"], tokens, cfg)
        x = backbone(params, x, ctx, cache)
        h = rms_norm(x[:, -1:], params["ln_f"])
        logits = logits_apply(params["embed"], h, cfg)
        return logits[:, 0], cache

    def prefill_fn(params, cache, batch, *, impl="auto", rules=None):
        return _fwd_cached(params, cache, batch["tokens"], 0,
                           impl=impl, rules=rules, decode=False)

    def decode_fn(params, cache, tokens, t, *, impl="auto", rules=None):
        return _fwd_cached(params, cache, tokens, t,
                           impl=impl, rules=rules, decode=True)

    return Model(cfg, defs, init, make_cache_defs, init_cache,
                 prefill_fn, decode_fn)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.attn_free:
        raise NotImplementedError(
            f"{cfg.name}: the RWKV-6 LM is not ported yet (ROADMAP A5)")
    if cfg.family == "hybrid":
        raise NotImplementedError(
            f"{cfg.name}: the Griffin LM is not ported yet (ROADMAP A5)")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet (ROADMAP A6)")
    return build_decoder_lm(cfg)
