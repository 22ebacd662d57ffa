"""Shared model primitives of the port: norms, RoPE, attention, MLP,
embedding.

The counterpart of ``repro.models.layers`` for the dense decoder: each
sub-module exposes ``<name>_defs(cfg) -> ParamDef tree`` and
``<name>_apply(params, ...) -> outputs``, with the same parameter names,
shapes and numerics (f32 norms and RoPE, attention through
:func:`~repro_torch.kernels.flash_attention.flash_attention`).  ``moe_*``
and ``mla_*`` wait for their families (ROADMAP A6).

Unlike JAX, the port updates the KV cache **in place**: ``attn_apply``
writes the layer's new keys and values into the cache tensors it is given
(the counterpart of ``dynamic_update_slice``) and returns that same dict.
A decode step's position may be a host int or a 0-d integer tensor on the
device (``jnp.int32(t)`` traced under ``jax.jit`` in ``repro``): with a
tensor, no op of the step reads the position on the host, so one captured
graph serves every position.  It may also be a ``(B,)`` integer tensor, a
position per batch row (``repro``'s ``jax.vmap`` of the decode step over
requests at their own positions).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.params import ParamDef

f32 = torch.float32


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context threaded through blocks."""
    cfg: ArchConfig
    impl: str = "auto"                # attention implementation
    decode: bool = False
    positions: Any = None             # (B, S) absolute positions
    cache_len: Any = None             # #valid cache entries: an int, a 0-d
                                      # integer tensor on the device, or a
                                      # (B,) one (a position per row)
    rows: Any = None                  # (B, S) batch row of each position,
                                      # with a (B,) cache_len
    rules: Any = None                 # sharding rules (ROADMAP A8; unused)


# ---------------------------------------------------------------- norms/rope

def norm_defs(d: int) -> dict:
    return {"scale": ParamDef((d,), (None,), init="zeros")}  # (1+s) parametrization


def rms_norm(x, p, eps: float = 1e-6):
    xf = x.to(f32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + p["scale"].to(f32))).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rope_freq(theta: float, half: int, device: torch.device):
    """``exp(-log(theta) * arange(half) / half)`` in f32, made once per
    (theta, half, device): a decode step would otherwise spend four
    launches per call on it.  Never evicted: a captured decode graph reads
    it by its address."""
    log_theta = torch.log(torch.tensor(theta, dtype=f32))
    return torch.exp(
        -log_theta * torch.arange(half, dtype=f32) / half).to(device)


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D) with D even; positions: (B, S).  Split halves, not
    interleaved pairs, as in ``repro``."""
    B, S, H, D = x.shape
    half = D // 2
    freq = _rope_freq(float(theta), half, x.device)     # (half,)
    ang = positions.to(f32)[..., None] * freq            # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(f32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def attn_defs(cfg: ArchConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = {
        "wq": ParamDef((D, H, hd), ("fsdp", "tensor", None)),
        "wk": ParamDef((D, KV, hd), ("fsdp", "tensor", None)),
        "wv": ParamDef((D, KV, hd), ("fsdp", "tensor", None)),
        "wo": ParamDef((H, hd, D), ("tensor", None, "fsdp")),
    }
    if cfg.qk_norm:
        d["qnorm"] = norm_defs(hd)
        d["knorm"] = norm_defs(hd)
    return d


def attn_apply(p, x, ctx: Ctx, *, window: int | None = None,
               cache: dict | None = None):
    """Causal self-attention with RoPE; returns (y, cache).  Cache:
    {'k','v'}: (B, Smax, KV, hd).  (``repro``'s cross-attention and
    non-causal options come with the encoder-decoder, ROADMAP A6.)

    Prefill (``ctx.decode`` false) writes k/v into the cache from position
    0 and attends over the fresh k/v; decode writes them at
    ``ctx.cache_len`` and attends over the whole buffer with
    ``q_start = t``, ``kv_len = t + S``.  Both writes go into the given
    cache tensors in place (the port's counterpart of JAX's
    ``dynamic_update_slice``); the returned cache is the same dict.  With
    ``t`` a device tensor the decode write is one ``index_copy_`` at the
    step's positions (``ctx.positions[0]``, ``t + arange(S)``), the
    attention takes ``q_start = t`` and leaves ``kv_len`` to the causal
    mask, and the check that the write fits the cache is the device's: an
    index past the cache fails there, not on the host.  With ``t`` of shape
    ``(B,)`` (row ``b`` at its own position) the write is one
    ``index_put_`` at ``(row, ctx.positions)`` and the attention masks each
    row at its own ``q_start = t[b]``.
    """
    cfg = ctx.cfg
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    q = apply_rope(q, ctx.positions, cfg.rope_theta)
    k = apply_rope(k, ctx.positions, cfg.rope_theta)

    S = x.shape[1]
    if cache is not None and not ctx.decode:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        q_start, kv_len, ks, vs = 0, None, k, v
    elif cache is not None and torch.is_tensor(ctx.cache_len):
        t = ctx.cache_len
        if t.dim() == 0:
            idx = ctx.positions[0]
            cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
        else:
            idx = (ctx.rows, ctx.positions)
            cache["k"].index_put_(idx, k.to(cache["k"].dtype))
            cache["v"].index_put_(idx, v.to(cache["v"].dtype))
        # kv_len = t + S is what the causal mask already keeps (the last
        # query sits at t + S - 1), and the kernel derives it on the
        # device: a tensor t + S would cost a launch a layer
        q_start, kv_len, ks, vs = t, None, cache["k"], cache["v"]
    elif cache is not None:
        t = int(ctx.cache_len)
        if t + S > cache["k"].shape[1]:
            raise ValueError(f"decode at position {t} of {S} tokens "
                             f"overruns a cache of {cache['k'].shape[1]}")
        cache["k"][:, t:t + S] = k
        cache["v"][:, t:t + S] = v
        q_start, kv_len, ks, vs = t, t + S, cache["k"], cache["v"]
    else:
        q_start, kv_len, ks, vs = 0, None, k, v

    y = flash_attention(
        q, ks, vs,
        causal=True,
        window=window,
        q_start=q_start,
        kv_len=kv_len,
        impl=ctx.impl,
        kv_chunk=cfg.attn_kv_chunk,
    )
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    return out, cache


# ---------------------------------------------------------------- MLP

def mlp_defs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    D = cfg.d_model
    Fd = d_ff or cfg.d_ff
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "wi_gate": ParamDef((D, Fd), ("fsdp", "tensor")),
            "wi_up": ParamDef((D, Fd), ("fsdp", "tensor")),
            "wo": ParamDef((Fd, D), ("tensor", "fsdp")),
        }
    return {
        "wi": ParamDef((D, Fd), ("fsdp", "tensor")),
        "wo": ParamDef((Fd, D), ("tensor", "fsdp")),
    }


def mlp_apply(p, x, cfg: ArchConfig):
    if cfg.mlp_kind in ("swiglu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
        a = F.silu(g) if cfg.mlp_kind == "swiglu" else \
            F.gelu(g, approximate="tanh")
        h = a * torch.einsum("bsd,df->bsf", x, p["wi_up"])
    else:
        h = F.gelu(torch.einsum("bsd,df->bsf", x, p["wi"]),
                   approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["wo"])


# ---------------------------------------------------------------- embedding

def embed_defs(cfg: ArchConfig) -> dict:
    d = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), ("tensor", "fsdp"),
                         init="embed")}
    if not cfg.tie_embeddings:
        d["out"] = ParamDef((cfg.d_model, cfg.vocab_size), ("fsdp", "tensor"))
    return d


def embed_apply(p, tokens, cfg: ArchConfig):
    x = p["tok"][tokens]
    if cfg.name.startswith("gemma") or cfg.name.startswith("recurrentgemma"):
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def logits_apply(p, x, cfg: ArchConfig):
    """Logits in f32.  With tied embeddings the product runs in the
    embedding's dtype (bf16 as served) and is cast afterwards, as in
    ``repro``."""
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["tok"]).to(f32)
    return torch.einsum("bsd,dv->bsv", x, p["out"]).to(f32)
