"""Model zoo of the port: the dense and MoE decoders (MHA or MLA, with
DeepSeek-V3's MTP head), RWKV-6 and Griffin LMs, and the encoder-decoder.

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
and MoE configs, MHA or MLA, with or without MTP), ``build_rwkv_lm``,
``build_griffin_lm`` and ``build_encdec``, with the same parameter and
cache trees (names, stacked shapes, leaf order), so that
``params_from_numpy`` maps ``repro``'s parameters one to one and the
decode-state plans agree.  Each layer stack is a Python loop over the
stacked parameters (the counterpart of ``_scan_stack``); the cache is
updated in place and returned.

The encoder-decoder's batch carries ``frames`` ``(B, S_enc, d_model)``
beside ``tokens`` (the audio frontend is a stub).  Its decode state is the
decoder's self-attention cache (``self``), the encoder's output padded to
``max_len`` rows (``enc_out``) and the number of valid rows, a 0-d int32
(``enc_len``), which prefill writes and every decode step's
cross-attention reads as its ``kv_len`` (on the card, on the device: one
captured step serves every request).  In a batched step's tree
(``launch.steps.init_batched_cache``) ``enc_len`` is one ``(B,)`` leaf, a
length per row.

``loss_fn`` is the counterpart of ``repro``'s: the next-token
cross-entropy over every position, in f32, with ``metrics`` ``loss`` and
``lm_loss``, and for the decoder ``aux_loss``, the MoE balance loss summed
over the MoE layers (0 for a dense config), added to the loss at 0.01
where the config has experts, and with MTP ``mtp_loss``, the multi-token
prediction's loss (token t + 2 from h_t and the embedding of token t + 1
through one more block), added at 0.3.  Under autograd each
stacked leaf is cut into its layers once (``unbind``), so that the
backward stacks the layers' gradients in one pass, and ``cfg.remat``
wraps what ``repro``'s ``_maybe_remat`` wraps: each block of the dense and
MoE stacks, each RWKV-6 block, each Griffin group of ``pattern`` (not the
unrolled tail), each encoder and each decoder block
(``_maybe_remat``).  On the card the
attention's gradient runs the hand-written backward kernel
(``kernels.flash_attention.ops.FlashAttentionFn``), and so do the
recurrences': RWKV-6's through ``kernels.rwkv6.ops.WKV6Fn``
(``csrc/wkv6_backward.cu``) and Griffin's through
``kernels.rglru.ops.RGLRUFn`` (``rglru_backward_kernel`` in
``csrc/rglru.cu``), so both train on the card.

Under sharding ``rules`` (``launch.mesh.rules_for_mesh``) every entry
point runs on DTensors (``parallel.sharding.sharded``: the plain tensors a
step makes take part as replicated ones): the embedding's output is
pinned to ``act_spec(rules, "bsd")``, as are the decoder stack's output
and the encoder's input, at ``repro``'s sites; the decode cache is
written rank by rank (``parallel.sharding.write_rows``); the kernels run
on local shards (``kernels/_local.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

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
    stack_defs,
    tree_map,
    zeros_from_defs,
)
from repro_torch.models.remat import dots_contexts
from repro_torch.parallel.sharding import shard_act, sharded, write_rows


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


def _maybe_remat(body, remat):
    """``repro``'s remat policy around one scanned block (or Griffin
    group), in a non-reentrant ``torch.utils.checkpoint``: False/'none' ->
    off; True/'block' -> full recompute; 'dots' -> selective (keep the
    outputs of the products without batch dimensions that the backward
    needs, recompute the rest: ``models/remat.py``).

    Only where autograd records: under ``torch.no_grad()`` ``body`` is
    returned as it is, so that prefill, decode and every captured serving
    step launch exactly what they launched before; a forward that carries
    a cache (prefill, decode) passes 'none', as ``repro``'s decode does.
    The non-reentrant form runs the forward with the gradient on, so a
    kernel without a backward (``kernels/_grad.py``) still raises there
    rather than being recomputed into a detached graph."""
    if not remat or remat == "none" or not torch.is_grad_enabled():
        return body
    # the blocks draw no random numbers: there is no RNG state to replay
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        kw["context_fn"] = dots_contexts
    return functools.partial(checkpoint, body, **kw)


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


def _mtp_loss(params, h, tokens, pos, cfg: ArchConfig, impl: str):
    """DeepSeek-V3's multi-token prediction (``repro``'s): h_t (after the
    final norm) normed again and joined with the embedding of token t + 1,
    projected, one more dense block, the shared final norm and logits
    predicting token t + 2."""
    mtp = params["mtp"]
    emb_next = embed_apply(params["embed"], tokens, cfg)
    cat = torch.cat([rms_norm(h[:, :-1], mtp["ln"]), emb_next[:, 1:]], -1)
    xm = torch.einsum("bsd,de->bse", cat, mtp["proj"])
    ctx_m = Ctx(cfg=cfg, impl=impl, positions=pos[:, :-1])
    xm, _, _ = B.transformer_block_apply(mtp["block"], xm, ctx_m, None,
                                         moe=False)
    lg = logits_apply(params["embed"], rms_norm(xm, params["ln_f"]), cfg)
    targets = tokens[:, 2:].long()
    return _xent(lg[:, :-1], targets, torch.ones_like(targets))


def _positions(tokens):
    """Positions ``0..S-1`` of every row of ``tokens`` ``(B, S)``."""
    Bz, S = tokens.shape
    return torch.arange(S, device=tokens.device)[None].expand(Bz, S)


def _decode_position(t, tokens):
    """A decode step's ``(t, positions (B, S), rows)``: ``t`` an int on the
    CPU; on the card an int becomes a 0-d int64 tensor (the card's decode
    reads its position on the device); a tensor ``t`` is int64 on the
    tokens' device, and a ``(B,)`` one (a position per batch row) also
    gives each position's batch row (``rows``, else None)."""
    Bz, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None]
    rows = None
    if torch.is_tensor(t) and t.dim() == 1:
        # a position per batch row
        t = t.to(device=tokens.device, dtype=torch.long)
        pos = pos + t[:, None]
        rows = torch.arange(Bz, device=tokens.device)[:, None].expand(Bz, S)
    else:
        if torch.is_tensor(t):
            t = t.to(device=tokens.device, dtype=torch.long)
        elif tokens.is_cuda:
            t = torch.full((), int(t), dtype=torch.long,
                           device=tokens.device)
        else:
            t = int(t)
        pos = pos + t
    return t, pos.expand(Bz, S), rows


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
        with sharded(rules):
            return _loss(params, batch, impl=impl, rules=rules)

    def _loss(params, batch, *, impl, rules):
        tokens = batch["tokens"]
        Bz, S = tokens.shape
        if torch.is_grad_enabled():
            params = {k: tree_map(_Unstacked, v) if k in stacked else v
                      for k, v in params.items()}
        pos = _positions(tokens)
        ctx = Ctx(cfg=cfg, impl=impl, positions=pos, rules=rules)
        x = embed_apply(params["embed"], tokens, cfg)
        x = shard_act(x, rules, "bsd")
        x, aux = backbone(params, x, ctx, None)
        h = rms_norm(x, params["ln_f"])
        logits = logits_apply(params["embed"], h, cfg)
        lm = _lm_loss(logits, tokens)
        metrics = {"lm_loss": lm}
        loss = lm
        if aux_loss:
            # made on the device (a model without experts sums no tensor):
            # a host-to-device copy cannot be captured in a CUDA graph
            metrics["aux_loss"] = (
                aux.to(torch.float32) if torch.is_tensor(aux) else
                torch.full((), float(aux), dtype=torch.float32,
                           device=tokens.device))
            if cfg.n_experts:
                loss = lm + 0.01 * aux
        if cfg.mtp:
            mtp = _mtp_loss(params, h, tokens, pos, cfg, impl)
            metrics["mtp_loss"] = mtp
            loss = loss + 0.3 * mtp
        metrics["loss"] = loss
        return loss, metrics

    def init_cache(bsz, smax, device=None):
        return zeros_from_defs(make_cache_defs(bsz, smax), device)

    def _fwd_cached(params, cache, tokens, t, *, impl, rules, decode):
        Bz, S = tokens.shape
        if decode:
            t, pos, rows = _decode_position(t, tokens)
        else:
            pos, rows = _positions(tokens), None
        ctx = Ctx(cfg=cfg, impl=impl, positions=pos, decode=decode,
                  cache_len=t, rows=rows, rules=rules)
        x = embed_apply(params["embed"], tokens, cfg)
        x = shard_act(x, rules, "bsd")
        x, _ = backbone(params, x, ctx, cache)
        h = rms_norm(x[:, -1:], params["ln_f"])
        logits = logits_apply(params["embed"], h, cfg)
        return logits[:, 0], cache

    def prefill_fn(params, cache, batch, *, impl="auto", rules=None):
        with sharded(rules):
            return _fwd_cached(params, cache, batch["tokens"], 0,
                               impl=impl, rules=rules, decode=False)

    def decode_fn(params, cache, tokens, t, *, impl="auto", rules=None):
        with sharded(rules):
            return _fwd_cached(params, cache, tokens, t,
                               impl=impl, rules=rules, decode=True)

    return Model(cfg, defs, init, loss_fn, make_cache_defs, init_cache,
                 prefill_fn, decode_fn)


def build_decoder_lm(cfg: ArchConfig) -> Model:
    """The dense and MoE decoders: ``cfg.n_dense_layers`` dense blocks
    (all of them without experts), then the MoE blocks, each stack under
    its own key (``"dense"``, ``"moe"``) in the parameters and the cache,
    present only where it has layers, as in ``repro``.  With MLA the
    blocks attend through ``mla_apply`` and the cache holds each layer's
    latent ``ckv`` and shared ``krope`` rows instead of ``k``/``v``; with
    MTP the parameters carry ``mtp`` (a projection, one dense block, a
    norm), which only ``loss_fn`` runs."""
    n_dense = cfg.n_dense_layers if cfg.n_experts else cfg.n_layers
    n_moe = cfg.n_layers - n_dense
    stacks = [(k, n, moe) for k, n, moe in (("dense", n_dense, False),
                                            ("moe", n_moe, True)) if n]
    defs = {"embed": embed_defs(cfg), "ln_f": norm_defs(cfg.d_model)}
    for key, n, moe in stacks:
        defs[key] = stack_defs(B.transformer_block_defs(cfg, moe=moe), n)
    if cfg.mtp:
        defs["mtp"] = {
            "proj": ParamDef((2 * cfg.d_model, cfg.d_model),
                             ("fsdp", "tensor")),
            "block": B.transformer_block_defs(cfg, moe=False),
            "ln": norm_defs(cfg.d_model),
        }

    def backbone(params, x, ctx, caches):
        aux = 0.0          # a tensor once an MoE block adds its loss; a
                           # dense block's 0.0 adds no launch to a step
        remat = cfg.remat if caches is None else "none"
        for key, n, moe in stacks:
            cache = caches[key] if caches else None
            block = _maybe_remat(functools.partial(
                B.transformer_block_apply, moe=moe), remat)
            for i in range(n):
                c = _layer(cache, i) if cache is not None else None
                x, _, a = block(_layer(params[key], i), x, ctx, c)
                aux = aux + a
        return shard_act(x, ctx.rules, "bsd"), aux

    def make_cache_defs(bsz, smax):
        if cfg.mla is None:
            return {key: _kv_cache_defs(cfg, n, bsz, smax)
                    for key, n, _ in stacks}
        m = cfg.mla
        return {key: {
            "ckv": ParamDef((n, bsz, smax, m.kv_lora_rank),
                            (None, "batch", "sequence", "tensor"),
                            init="zeros"),
            "krope": ParamDef((n, bsz, smax, m.qk_rope_head_dim),
                              (None, "batch", "sequence", None),
                              init="zeros"),
        } for key, n, _ in stacks}

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
        block = _maybe_remat(B.rwkv6_block_apply,
                             cfg.remat if cache is None else "none")
        for i in range(n_layers):
            c = _layer(cache, i) if cache is not None else None
            x, _, _ = block(_layer(blocks, i), x, ctx, c)
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

    def group(x, ps, cs, ctx):
        """One group of ``pattern``: remat wraps a group, not a block."""
        for b, p, c in zip(pattern, ps, cs):
            x, _, _ = apply[b](p, x, ctx, c)
        return x

    def backbone(params, x, ctx, caches):
        groups = params["groups"]
        seen = {"rec": 0, "attn": 0}      # layer index within each stack
        run = _maybe_remat(group, cfg.remat if caches is None else "none")
        for _ in range(n_groups):
            ps, cs = [], []
            for b in pattern:
                i = seen[b]
                ps.append(_layer(groups[b], i))
                cs.append(_layer(caches[b], i) if caches else None)
                seen[b] += 1
            x = run(x, ps, cs, ctx)
        # the tail is unrolled and not wrapped, as in repro
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


# ----------------------------------------------------------------- enc-dec

def build_encdec(cfg: ArchConfig) -> Model:
    """seamless-m4t's backbone: an encoder over frame embeddings (the
    frontend stub supplies them, ``batch["frames"]``) and a text decoder
    with cross-attention; ``repro``'s ``build_encdec``.  The frames are
    rounded to bf16, as ``repro`` casts them, and the encoder runs in the
    parameters' dtype from there (bf16 as served, as in ``repro``; an f32
    model runs an f32 encoder on the rounded frames, where ``repro``'s
    layer scan, which carries bf16, takes no f32 parameters).  It attends
    without a causal mask; the decoder's cross-attention reads the
    encoder's output, fresh at prefill and from the padded ``enc_out``
    buffer, masked at ``enc_len`` rows, at decode."""
    n_enc, n_dec = cfg.encoder_layers, cfg.n_layers
    defs = {
        "embed": embed_defs(cfg),
        "enc": stack_defs(B.encoder_block_defs(cfg), n_enc),
        "dec": stack_defs(B.decoder_block_defs(cfg), n_dec),
        "ln_enc": norm_defs(cfg.d_model),
        "ln_f": norm_defs(cfg.d_model),
    }

    def init(generator: torch.Generator, device=None):
        return init_params(defs, generator, device)

    def encode(params, frames, impl, rules):
        ctx = Ctx(cfg=cfg, impl=impl, positions=_positions(frames[..., 0]))
        x = frames.to(torch.bfloat16).to(params["ln_enc"]["scale"].dtype)
        x = shard_act(x, rules, "bsd")
        block = _maybe_remat(B.encoder_block_apply, cfg.remat)
        for i in range(n_enc):
            x = block(_layer(params["enc"], i), x, ctx)
        return rms_norm(x, params["ln_enc"])

    def run_decoder(params, x, enc_out, ctx, cache, enc_len=None):
        block = _maybe_remat(B.decoder_block_apply,
                             cfg.remat if cache is None else "none")
        for i in range(n_dec):
            c = None if cache is None else {"self": _layer(cache, i)}
            x, _, _ = block(_layer(params["dec"], i), x, ctx, enc_out, c,
                            enc_len=enc_len)
        return x

    def head(params, x):
        return logits_apply(params["embed"], rms_norm(x, params["ln_f"]),
                            cfg)

    def loss_fn(params, batch, *, impl="auto", rules=None):
        with sharded(rules):
            return _loss(params, batch, impl=impl, rules=rules)

    def _loss(params, batch, *, impl, rules):
        frames, tokens = batch["frames"], batch["tokens"]
        if torch.is_grad_enabled():
            params = {k: tree_map(_Unstacked, v) if k in ("enc", "dec")
                      else v for k, v in params.items()}
        enc_out = encode(params, frames, impl, rules)
        ctx = Ctx(cfg=cfg, impl=impl, positions=_positions(tokens),
                  rules=rules)
        x = embed_apply(params["embed"], tokens, cfg)
        x = run_decoder(params, x, enc_out, ctx, None)
        loss = _lm_loss(head(params, x), tokens)
        return loss, {"loss": loss, "lm_loss": loss}

    def make_cache_defs(bsz, smax):
        return {
            "self": _kv_cache_defs(cfg, n_dec, bsz, smax),
            "enc_out": ParamDef((bsz, smax, cfg.d_model),
                                ("batch", None, None), init="zeros"),
            "enc_len": ParamDef((), (), init="zeros", dtype=torch.int32),
        }

    def init_cache(bsz, smax, device=None):
        return zeros_from_defs(make_cache_defs(bsz, smax), device)

    def prefill_fn(params, cache, batch, *, impl="auto", rules=None):
        """Encode the frames into ``cache["enc_out"]`` (its first S_enc
        rows) and set ``cache["enc_len"]`` to S_enc, then run the decoder
        over the prompt, its self-attention cache written from 0."""
        with sharded(rules):
            return _prefill(params, cache, batch, impl=impl, rules=rules)

    def _prefill(params, cache, batch, *, impl, rules):
        frames, tokens = batch["frames"], batch["tokens"]
        Se = frames.shape[1]
        enc_out = encode(params, frames, impl, rules)
        if isinstance(cache["enc_out"], DTensor):
            write_rows(cache["enc_out"], enc_out, start=0)
        else:
            cache["enc_out"][:, :Se] = enc_out
        cache["enc_len"].fill_(Se)
        ctx = Ctx(cfg=cfg, impl=impl, positions=_positions(tokens),
                  cache_len=0)
        x = embed_apply(params["embed"], tokens, cfg)
        x = run_decoder(params, x, enc_out, ctx, cache["self"])
        return head(params, x[:, -1:])[:, 0], cache

    def decode_fn(params, cache, tokens, t, *, impl="auto", rules=None):
        with sharded(rules):
            return _decode(params, cache, tokens, t, impl=impl)

    def _decode(params, cache, tokens, t, *, impl):
        t, pos, rows = _decode_position(t, tokens)
        ctx = Ctx(cfg=cfg, impl=impl, positions=pos, decode=True,
                  cache_len=t, rows=rows)
        x = embed_apply(params["embed"], tokens, cfg)
        x = run_decoder(params, x, cache["enc_out"], ctx, cache["self"],
                        enc_len=cache["enc_len"])
        return head(params, x[:, -1:])[:, 0], cache

    return Model(cfg, defs, init, loss_fn, make_cache_defs, init_cache,
                 prefill_fn, decode_fn)


def build_model(cfg: ArchConfig) -> Model:
    if cfg.attn_free:
        return build_rwkv_lm(cfg)
    if cfg.family == "hybrid":
        return build_griffin_lm(cfg)
    if cfg.is_encoder_decoder:
        return build_encdec(cfg)
    return build_decoder_lm(cfg)
