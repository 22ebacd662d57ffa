"""Model zoo of the port: the dense and MoE decoders, RWKV-6 and Griffin
LMs.

``build_model(cfg) -> Model`` with:
    defs        ParamDef tree (layers stacked on a leading axis)
    init(generator, device)                            materialized params
    loss_fn(params, batch, *, impl, rules)             -> (loss, metrics)
    make_cache_defs(batch_size, max_len)               ParamDef tree (decode state)
    init_cache(batch_size, max_len, device)            zeroed decode state
    prefill_fn(params, cache, batch, *, impl, rules)   -> (logits_last, cache)
    decode_fn(params, cache, tokens, t, *, impl, rules) -> (logits, cache)

``decode_fn``'s position ``t`` is an int or a 0-d integer tensor (the
counterpart of ``repro``'s traced ``jnp.int32(t)``).  On the card an int is
made a device tensor first, so that an eager decode step and a captured
one (``repro_torch.launch.steps.make_captured_decode_step``) launch the
same kernels.  ``t`` may also be a ``(B,)`` integer tensor, a position per
batch row: the counterpart of ``repro``'s ``jax.vmap`` of the decode step
over requests at their own positions (the batched decode step,
``repro_torch.launch.steps.CapturedBatchedDecodeStep``).  Only the
attention reads the position; the recurrent state of RWKV-6 and of
Griffin's RG-LRU layers is per row already.

The counterparts of ``repro.models.zoo``'s ``build_decoder_lm`` (dense
and MoE configs), ``build_rwkv_lm`` and ``build_griffin_lm``, with the same
parameter and cache trees (names, stacked shapes, leaf order), so that
``params_from_numpy`` maps ``repro``'s parameters one to one and the
decode-state plans agree.  Each layer stack is a Python loop over the
stacked parameters (the counterpart of ``_scan_stack``); the cache is
updated in place and returned.  ``build_model`` raises for the families
the port does not build yet: MLA, MTP and the encoder-decoder (ROADMAP
A7).

``loss_fn`` is the counterpart of ``repro``'s: the next-token
cross-entropy over every position, in f32, with ``metrics`` ``loss`` and
``lm_loss``, and for the decoder ``aux_loss``, the MoE balance loss summed
over the MoE layers (0 for a dense config), added to the loss at 0.01
where the config has experts.  Under autograd each
stacked leaf is cut into its layers once (``unbind``), so that the
backward stacks the layers' gradients in one pass.  On the card the
attention's gradient runs the hand-written backward kernel
(``kernels.flash_attention.ops.FlashAttentionFn``); the recurrences have
no backward kernel yet and raise under autograd on the card (ROADMAP B),
so RWKV-6 and Griffin train on the CPU only.
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
    loss_fn: Callable
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


class _Unstacked:
    """A stacked leaf cut into its layers once: ``[i]`` gives layer ``i``
    as ``unbind`` made it.  Indexing the stacked tensor per layer instead
    would give each layer's gradient the stacked shape, zeros but for its
    slice, and the backward would add them all up."""

    def __init__(self, t: torch.Tensor):
        self.layers = t.unbind(0)

    def __getitem__(self, i: int) -> torch.Tensor:
        return self.layers[i]


def _xent(logits, targets, mask):
    lz = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(lz, -1, targets[..., None])[..., 0]
    n = torch.clamp(mask.sum(), min=1)
    return -(ll * mask).sum() / n


def _lm_loss(logits, tokens):
    """next-token CE: logits[:, :-1] predicts tokens[:, 1:]."""
    targets = tokens[:, 1:].long()
    return _xent(logits[:, :-1], targets, torch.ones_like(targets))


def _lm(cfg: ArchConfig, defs, make_cache_defs, backbone, *,
        stacked: tuple[str, ...], aux_loss: bool = False) -> Model:
    """A Model over ``backbone(params, x, ctx, cache) -> (x, aux)``: the
    embedding in front, the final norm and the logits behind; prefill
    (positions from 0) and decode (positions from ``t``) give the last
    position's logits, ``loss_fn`` the next-token loss over all of them.
    ``stacked`` names the top-level subtrees whose leaves stack the
    layers; ``aux_loss``: the decoder's ``aux_loss`` metric (the MoE
    balance loss summed over layers, 0 without experts), added to the
    loss at 0.01 where the config has experts, as in ``repro``."""
    def init(generator: torch.Generator, device=None):
        return init_params(defs, generator, device)

    def loss_fn(params, batch, *, impl="auto", rules=None):
        if rules is not None:
            raise NotImplementedError(
                "sharding rules wait for parallelism (ROADMAP A8)")
        tokens = batch["tokens"]
        Bz, S = tokens.shape
        if torch.is_grad_enabled():
            params = {k: tree_map(_Unstacked, v) if k in stacked else v
                      for k, v in params.items()}
        pos = torch.arange(S, device=tokens.device)[None].expand(Bz, S)
        ctx = Ctx(cfg=cfg, impl=impl, positions=pos, rules=rules)
        x = embed_apply(params["embed"], tokens, cfg)
        x, aux = backbone(params, x, ctx, None)
        logits = logits_apply(params["embed"], rms_norm(x, params["ln_f"]),
                              cfg)
        lm = _lm_loss(logits, tokens)
        metrics = {"lm_loss": lm}
        loss = lm
        if aux_loss:
            metrics["aux_loss"] = torch.as_tensor(
                aux, dtype=torch.float32, device=tokens.device)
            if cfg.n_experts:
                loss = lm + 0.01 * aux
        metrics["loss"] = loss
        return loss, metrics

    def init_cache(bsz, smax, device=None):
        return tree_map(
            lambda d: torch.zeros(d.shape, dtype=d.dtype, device=device),
            make_cache_defs(bsz, smax), is_leaf=is_def)

    def _fwd_cached(params, cache, tokens, t, *, impl, rules, decode):
        Bz, S = tokens.shape
        pos = torch.arange(S, device=tokens.device)[None]
        rows = None
        if decode and torch.is_tensor(t) and t.dim() == 1:
            # a position per batch row
            t = t.to(device=tokens.device, dtype=torch.long)
            pos = pos + t[:, None]
            rows = torch.arange(Bz, device=tokens.device)[:, None].expand(
                Bz, S)
        elif decode:
            if torch.is_tensor(t):
                t = t.to(device=tokens.device, dtype=torch.long)
            elif tokens.is_cuda:
                # the card's decode reads its position on the device
                t = torch.full((), int(t), dtype=torch.long,
                               device=tokens.device)
            else:
                t = int(t)
            pos = pos + t
        ctx = Ctx(cfg=cfg, impl=impl, positions=pos.expand(Bz, S),
                  decode=decode, cache_len=t, rows=rows, rules=rules)
        x = embed_apply(params["embed"], tokens, cfg)
        x, _ = backbone(params, x, ctx, cache)
        h = rms_norm(x[:, -1:], params["ln_f"])
        logits = logits_apply(params["embed"], h, cfg)
        return logits[:, 0], cache

    def prefill_fn(params, cache, batch, *, impl="auto", rules=None):
        return _fwd_cached(params, cache, batch["tokens"], 0,
                           impl=impl, rules=rules, decode=False)

    def decode_fn(params, cache, tokens, t, *, impl="auto", rules=None):
        return _fwd_cached(params, cache, tokens, t,
                           impl=impl, rules=rules, decode=True)

    return Model(cfg, defs, init, loss_fn, make_cache_defs, init_cache,
                 prefill_fn, decode_fn)


def build_decoder_lm(cfg: ArchConfig) -> Model:
    """The dense and MoE decoders: ``cfg.n_dense_layers`` dense blocks
    (all of them without experts), then the MoE blocks, each stack under
    its own key (``"dense"``, ``"moe"``) in the parameters and the cache,
    present only where it has layers, as in ``repro``."""
    if cfg.mla is not None or cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: MLA and MTP decoders are not ported yet "
            f"(ROADMAP A7)")
    n_dense = cfg.n_dense_layers if cfg.n_experts else cfg.n_layers
    n_moe = cfg.n_layers - n_dense
    stacks = [(k, n, moe) for k, n, moe in (("dense", n_dense, False),
                                            ("moe", n_moe, True)) if n]
    defs = {"embed": embed_defs(cfg), "ln_f": norm_defs(cfg.d_model)}
    for key, n, moe in stacks:
        defs[key] = stack_defs(B.transformer_block_defs(cfg, moe=moe), n)

    def backbone(params, x, ctx, caches):
        aux = 0.0          # a tensor once an MoE block adds its loss; a
                           # dense block's 0.0 adds no launch to a step
        for key, n, moe in stacks:
            cache = caches[key] if caches else None
            for i in range(n):
                c = _layer(cache, i) if cache is not None else None
                x, _, a = B.transformer_block_apply(_layer(params[key], i),
                                                    x, ctx, c, moe=moe)
                aux = aux + a
        return x, aux

    def make_cache_defs(bsz, smax):
        return {key: _kv_cache_defs(cfg, n, bsz, smax)
                for key, n, _ in stacks}

    return _lm(cfg, defs, make_cache_defs, backbone,
               stacked=tuple(key for key, _, _ in stacks), aux_loss=True)


# ----------------------------------------------------------------- RWKV-6 LM

def build_rwkv_lm(cfg: ArchConfig) -> Model:
    n_layers = cfg.n_layers
    defs = {
        "embed": embed_defs(cfg),
        "blocks": stack_defs(B.rwkv6_block_defs(cfg), n_layers),
        "ln_f": norm_defs(cfg.d_model),
    }
    H, N = cfg.d_model // cfg.head_dim, cfg.head_dim

    def backbone(params, x, ctx, cache):
        blocks = params["blocks"]
        for i in range(n_layers):
            c = _layer(cache, i) if cache is not None else None
            x, _, _ = B.rwkv6_block_apply(_layer(blocks, i), x, ctx, c)
        return x, None

    def make_cache_defs(bsz, smax):
        L, D = n_layers, cfg.d_model
        return {
            "tm_x": ParamDef((L, bsz, D), (None, "batch", None),
                             init="zeros"),
            "cm_x": ParamDef((L, bsz, D), (None, "batch", None),
                             init="zeros"),
            "wkv": ParamDef((L, bsz, H, N, N),
                            (None, "batch", "tensor", None, None),
                            init="zeros", dtype=torch.float32),
        }

    return _lm(cfg, defs, make_cache_defs, backbone, stacked=("blocks",))


# ----------------------------------------------------------------- Griffin

def build_griffin_lm(cfg: ArchConfig) -> Model:
    """recurrentgemma: pattern (rec, rec, attn) repeating over n_layers,
    the remainder as a list of tail layers."""
    pattern = cfg.block_pattern            # e.g. ("rec", "rec", "attn")
    period = len(pattern)
    n_groups = cfg.n_layers // period
    n_tail = cfg.n_layers - n_groups * period
    tail_pattern = pattern[:n_tail]
    n_rec_g = sum(1 for b in pattern if b == "rec")
    n_rec, n_attn = n_groups * n_rec_g, n_groups * (period - n_rec_g)

    rec_defs = B.griffin_rec_block_defs(cfg)
    attn_defs_ = B.griffin_attn_block_defs(cfg)
    defs = {
        "embed": embed_defs(cfg),
        "groups": {"rec": stack_defs(rec_defs, n_rec),
                   "attn": stack_defs(attn_defs_, n_attn)},
        "tail": [(rec_defs if b == "rec" else attn_defs_)
                 for b in tail_pattern],
        "ln_f": norm_defs(cfg.d_model),
    }
    W = cfg.lru_width or cfg.d_model
    apply = {"rec": B.griffin_rec_block_apply,
             "attn": B.griffin_attn_block_apply}

    def backbone(params, x, ctx, caches):
        groups = params["groups"]
        seen = {"rec": 0, "attn": 0}      # layer index within each stack
        for b in pattern * n_groups:
            i = seen[b]
            c = _layer(caches[b], i) if caches else None
            x, _, _ = apply[b](_layer(groups[b], i), x, ctx, c)
            seen[b] += 1
        for i, b in enumerate(tail_pattern):
            c = caches["tail"][i] if caches else None
            x, _, _ = apply[b](params["tail"][i], x, ctx, c)
        return x, None

    def make_cache_defs(bsz, smax):
        # as in repro: the local-attention cache is indexed by absolute
        # position, smax long (a ring buffer of local_window rows is the
        # production layout)
        def conv(*lead):
            return ParamDef((*lead, bsz, B._CONV_W - 1, W),
                            (*(None,) * len(lead), "batch", None, "tensor"),
                            init="zeros")

        def hstate(*lead):
            return ParamDef((*lead, bsz, W),
                            (*(None,) * len(lead), "batch", "tensor"),
                            init="zeros", dtype=torch.float32)

        kv = ParamDef((bsz, smax, cfg.n_kv_heads, cfg.head_dim),
                      ("batch", None, "tensor", None), init="zeros")
        return {
            "rec": {"conv": conv(n_rec), "h": hstate(n_rec)},
            "attn": _kv_cache_defs(cfg, n_attn, bsz, smax),
            "tail": [{"conv": conv(), "h": hstate()} if b == "rec"
                     else {"k": kv, "v": kv} for b in tail_pattern],
        }

    return _lm(cfg, defs, make_cache_defs, backbone, stacked=("groups",))


def build_model(cfg: ArchConfig) -> Model:
    if cfg.attn_free:
        return build_rwkv_lm(cfg)
    if cfg.family == "hybrid":
        return build_griffin_lm(cfg)
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder is not ported yet (ROADMAP A7)")
    return build_decoder_lm(cfg)
