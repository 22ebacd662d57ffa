"""Residual blocks of the port: dense/MoE transformer (MHA or MLA), RWKV-6,
RG-LRU hybrid, and the encoder-decoder's two blocks.

The counterpart of ``repro.models.blocks``:

    defs  = <family>_block_defs(cfg)                  # one layer's ParamDefs
    x, cache, aux = <family>_block_apply(p, x, ctx, cache)

``cache`` is the layer's decode state (views into the stacked cache,
updated in place and returned) or None.  The recurrences run through
``kernels.rwkv6.wkv6`` and ``kernels.rglru.rglru`` (the CUDA kernels on
the card), which write the layer's final state straight into its cache
view.  The transformer block takes an MoE MLP (``moe=True``) and, where
the config has one, MLA attention.  The encoder block attends without a
causal mask and takes no cache; the decoder block runs causal
self-attention against its cache, then cross-attention over the
encoder's output (``enc_len`` its valid rows).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.models.layers import (
    Ctx,
    attn_apply,
    attn_defs,
    mla_apply,
    mla_defs,
    mlp_apply,
    mlp_defs,
    moe_apply,
    moe_defs,
    norm_defs,
    proj_rows,
    rms_norm,
)
from repro_torch.models.moe_ep import moe_apply_ep
from repro_torch.models.params import ParamDef
from repro_torch.parallel.sharding import copy_into

f32 = torch.float32


def transformer_block_defs(cfg: ArchConfig, *, moe: bool = False) -> dict:
    return {
        "ln1": norm_defs(cfg.d_model),
        "attn": mla_defs(cfg) if cfg.mla is not None else attn_defs(cfg),
        "ln2": norm_defs(cfg.d_model),
        "mlp": moe_defs(cfg) if moe else mlp_defs(cfg),
    }


def transformer_block_apply(p, x, ctx: Ctx, cache=None, *, moe: bool = False,
                            window: int | None = None):
    """Pre-norm attention + MLP (or MoE) residual block; returns (x, cache,
    aux) with ``aux`` the MoE's balance loss (0.0 for a dense block, and
    for an MoE block with a ``cache``: a serving step, which reads no loss,
    skips its launches).  At a position per batch row (the batched decode
    step) the MoE dispatches each row on its own
    (``moe_apply(per_row=True)``).  With ``cfg.moe_impl == "ep_shardmap"``
    and rules with a mesh the MoE is the expert-parallel
    ``moe_ep.moe_apply_ep``, as in ``repro``."""
    h = rms_norm(x, p["ln1"])
    if ctx.cfg.mla is not None:
        a, new_cache = mla_apply(p["attn"], h, ctx, cache)
    else:
        a, new_cache = attn_apply(p["attn"], h, ctx, cache=cache,
                                  window=window)
    x = x + a
    h = rms_norm(x, p["ln2"])
    if not moe:
        return x + mlp_apply(p["mlp"], h, ctx.cfg), new_cache, 0.0
    per_row = torch.is_tensor(ctx.cache_len) and ctx.cache_len.dim() == 1
    if ctx.cfg.moe_impl == "ep_shardmap" and ctx.rules is not None \
            and getattr(ctx.rules, "mesh", None) is not None:
        m, aux = moe_apply_ep(p["mlp"], h, ctx.cfg, ctx.rules,
                              per_row=per_row, with_aux=cache is None)
    else:
        m, aux = moe_apply(p["mlp"], h, ctx.cfg, rules=ctx.rules,
                           per_row=per_row, with_aux=cache is None)
    return x + m, new_cache, aux


# ------------------------------------------------------------ RWKV-6

_RWKV_LORA = 32
_RWKV_DECAY_LORA = 64


def rwkv6_block_defs(cfg: ArchConfig) -> dict:
    D, Fd = cfg.d_model, cfg.d_ff
    H = D // cfg.head_dim
    N = cfg.head_dim
    return {
        "ln1": norm_defs(D),
        "tmix": {
            "mu_x": ParamDef((D,), (None,), init="zeros"),
            "mu": ParamDef((5, D), (None, None), init="zeros"),
            "lora_a": ParamDef((D, 5 * _RWKV_LORA), ("fsdp", None)),
            "lora_b": ParamDef((5, _RWKV_LORA, D), (None, None, None),
                               init="zeros"),
            "w0": ParamDef((D,), (None,), init="zeros"),
            "wa": ParamDef((D, _RWKV_DECAY_LORA), ("fsdp", None)),
            "wb": ParamDef((_RWKV_DECAY_LORA, D), (None, None), init="zeros"),
            "wr": ParamDef((D, D), ("fsdp", "tensor")),
            "wk": ParamDef((D, D), ("fsdp", "tensor")),
            "wv": ParamDef((D, D), ("fsdp", "tensor")),
            "wg": ParamDef((D, D), ("fsdp", "tensor")),
            "wo": ParamDef((D, D), ("tensor", "fsdp")),
            "u": ParamDef((H, N), (None, None), init="zeros"),
            "gn": norm_defs(D),
        },
        "ln2": norm_defs(D),
        "cmix": {
            "mu_k": ParamDef((D,), (None,), init="zeros"),
            "mu_r": ParamDef((D,), (None,), init="zeros"),
            "wk": ParamDef((D, Fd), ("fsdp", "tensor")),
            "wv": ParamDef((Fd, D), ("tensor", "fsdp")),
            "wr": ParamDef((D, D), ("fsdp", None)),
        },
    }


def _token_shift(x, last_x):
    """Shift right by one; the first position comes from the decode
    state."""
    return torch.cat([last_x[:, None, :], x[:, :-1, :]], dim=1)


def rwkv6_block_apply(p, x, ctx: Ctx, cache=None):
    """cache = {'tm_x','cm_x': (B,D), 'wkv': (B,H,N,N) f32} or None; the
    three are updated in place (the WKV kernel writes the final state
    straight into ``cache['wkv']``)."""
    cfg = ctx.cfg
    B, T, D = x.shape
    H, N = D // cfg.head_dim, cfg.head_dim

    # ---- time mix -----------------------------------------------------------
    tm = p["tmix"]
    h = rms_norm(x, p["ln1"])
    last = cache["tm_x"] if cache is not None else \
        torch.zeros((B, D), dtype=h.dtype, device=h.device)
    xx = _token_shift(h, last) - h
    xxx = h + xx * tm["mu_x"]
    lo = torch.tanh(proj_rows(xxx, tm["lora_a"], ctx.rules, 5))
    lo = lo.reshape(B, T, 5, _RWKV_LORA)
    mix = tm["mu"][None, None] + torch.einsum("btfr,frd->btfd", lo,
                                              tm["lora_b"])
    xr, xk, xv, xw, xg = [h + xx * mix[:, :, i] for i in range(5)]

    r = torch.einsum("btd,de->bte", xr, tm["wr"]).reshape(B, T, H, N)
    k = torch.einsum("btd,de->bte", xk, tm["wk"]).reshape(B, T, H, N)
    v = torch.einsum("btd,de->bte", xv, tm["wv"]).reshape(B, T, H, N)
    g = torch.einsum("btd,de->bte", xg, tm["wg"])
    logw = -torch.exp(
        tm["w0"].to(f32)
        + torch.einsum("btd,dr->btr", xw.to(f32), tm["wa"].to(f32))
        @ tm["wb"].to(f32))
    w = torch.exp(logw).reshape(B, T, H, N)

    s0 = cache["wkv"] if cache is not None else None
    # w in r's dtype, as repro does (bf16 as served)
    o, _ = wkv6(r, k, v, w.to(r.dtype), tm["u"], initial_state=s0,
                impl=ctx.impl, state_out=s0)
    o = o.reshape(B, T, D)
    o = rms_norm(o, tm["gn"]) * F.silu(g)
    x = x + torch.einsum("btd,de->bte", o, tm["wo"])

    # ---- channel mix ---------------------------------------------------------
    cm = p["cmix"]
    h2 = rms_norm(x, p["ln2"])
    last2 = cache["cm_x"] if cache is not None else \
        torch.zeros((B, D), dtype=h2.dtype, device=h2.device)
    xx2 = _token_shift(h2, last2) - h2
    hk = h2 + xx2 * cm["mu_k"]
    hr = h2 + xx2 * cm["mu_r"]
    kk = torch.square(torch.relu(torch.einsum("btd,df->btf", hk, cm["wk"])))
    out = torch.sigmoid(torch.einsum("btd,de->bte", hr, cm["wr"])) * \
        torch.einsum("btf,fd->btd", kk, cm["wv"])
    x = x + out

    if cache is not None:
        copy_into(cache["tm_x"], h[:, -1])
        copy_into(cache["cm_x"], h2[:, -1])
    return x, cache, 0.0


# ------------------------------------------------------------ RG-LRU (Griffin)

_CONV_W = 4
_LRU_C = 8.0


def griffin_rec_block_defs(cfg: ArchConfig) -> dict:
    D = cfg.d_model
    W = cfg.lru_width or D
    return {
        "ln1": norm_defs(D),
        "rec": {
            "wx": ParamDef((D, W), ("fsdp", "tensor")),
            "wy": ParamDef((D, W), ("fsdp", "tensor")),
            "conv_w": ParamDef((_CONV_W, W), (None, "tensor"), init="zeros"),
            "conv_b": ParamDef((W,), ("tensor",), init="zeros"),
            "wa_gate": ParamDef((W, W), ("tensor", None)),
            "wx_gate": ParamDef((W, W), ("tensor", None)),
            "lam": ParamDef((W,), ("tensor",), init="ones"),
            "wo": ParamDef((W, D), ("tensor", "fsdp")),
        },
        "ln2": norm_defs(D),
        "mlp": mlp_defs(cfg),
    }


def griffin_rec_block_apply(p, x, ctx: Ctx, cache=None):
    """cache = {'conv': (B, CONV_W-1, W), 'h': (B, W) f32} or None; both
    are updated in place (the RG-LRU kernel writes h_T straight into
    ``cache['h']``)."""
    cfg = ctx.cfg
    B, T, D = x.shape
    W = cfg.lru_width or D
    rec = p["rec"]
    h = rms_norm(x, p["ln1"])
    gate = F.gelu(torch.einsum("btd,dw->btw", h, rec["wy"]),
                  approximate="tanh")
    u = torch.einsum("btd,dw->btw", h, rec["wx"])

    # causal depthwise temporal conv, width 4
    prev = cache["conv"] if cache is not None else \
        torch.zeros((B, _CONV_W - 1, W), dtype=u.dtype, device=u.device)
    upad = torch.cat([prev, u], dim=1)                    # (B, T+3, W)
    conv = sum(upad[:, i:i + T, :] * rec["conv_w"][i][None, None]
               for i in range(_CONV_W)) + rec["conv_b"]

    # RG-LRU gates
    ra = torch.sigmoid(torch.einsum("btw,wv->btv", conv, rec["wa_gate"]))
    ix = torch.sigmoid(torch.einsum("btw,wv->btv", conv, rec["wx_gate"]))
    log_a = (-_LRU_C * F.softplus(rec["lam"].to(f32)))[None, None] \
        * ra.to(f32)
    gx = ix * conv
    h0 = cache["h"] if cache is not None else None
    hs, _ = rglru(log_a, gx, h0, impl=ctx.impl, state_out=h0)

    y = hs * gate
    x = x + torch.einsum("btw,wd->btd", y, rec["wo"])
    h2 = rms_norm(x, p["ln2"])
    x = x + mlp_apply(p["mlp"], h2, cfg)

    if cache is not None:
        copy_into(cache["conv"], upad[:, -(_CONV_W - 1):, :])
    return x, cache, 0.0


def griffin_attn_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg.d_model),
        "attn": attn_defs(cfg),
        "ln2": norm_defs(cfg.d_model),
        "mlp": mlp_defs(cfg),
    }


def griffin_attn_block_apply(p, x, ctx: Ctx, cache=None):
    """Local (sliding-window, ``cfg.local_window``) attention + MLP."""
    h = rms_norm(x, p["ln1"])
    a, new_cache = attn_apply(p["attn"], h, ctx, cache=cache,
                              window=ctx.cfg.local_window)
    x = x + a
    x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"]), ctx.cfg)
    return x, new_cache, 0.0


# ------------------------------------------------------------ encoder (bidi)

def encoder_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg.d_model),
        "attn": attn_defs(cfg),
        "ln2": norm_defs(cfg.d_model),
        "mlp": mlp_defs(cfg),
    }


def encoder_block_apply(p, x, ctx: Ctx):
    """Non-causal self-attention (with RoPE) + MLP; no cache."""
    h = rms_norm(x, p["ln1"])
    a, _ = attn_apply(p["attn"], h, ctx, causal=False)
    x = x + a
    return x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"]), ctx.cfg)


def decoder_block_defs(cfg: ArchConfig) -> dict:
    return {
        "ln1": norm_defs(cfg.d_model),
        "self_attn": attn_defs(cfg),
        "ln_x": norm_defs(cfg.d_model),
        "cross_attn": attn_defs(cfg, cross=True),
        "ln2": norm_defs(cfg.d_model),
        "mlp": mlp_defs(cfg),
    }


def decoder_block_apply(p, x, ctx: Ctx, enc_out, cache=None, enc_len=None):
    """Causal self-attention against ``cache = {'self': kv-cache}`` (or
    None), cross-attention over ``enc_out`` (no RoPE, no causal mask; the
    first ``enc_len`` rows valid where it is a padded buffer), MLP;
    returns (x, cache, 0.0)."""
    h = rms_norm(x, p["ln1"])
    a, _ = attn_apply(p["self_attn"], h, ctx,
                      cache=None if cache is None else cache["self"])
    x = x + a
    h = rms_norm(x, p["ln_x"])
    c, _ = attn_apply(p["cross_attn"], h, ctx, kv_src=enc_out,
                      kv_src_len=enc_len, causal=False, use_rope=False)
    x = x + c
    x = x + mlp_apply(p["mlp"], rms_norm(x, p["ln2"]), ctx.cfg)
    return x, cache, 0.0
