"""Shared model primitives of the port: norms, RoPE, attention, MLP, MoE,
MLA, embedding.

The counterpart of ``repro.models.layers``: each sub-module exposes
``<name>_defs(cfg) -> ParamDef tree`` and ``<name>_apply(params, ...) ->
outputs``, with the same parameter names, shapes and numerics (f32 norms,
RoPE and router, attention through
:func:`~repro_torch.kernels.flash_attention.flash_attention`).
``attn_apply`` also takes ``repro``'s cross-attention (``kv_src``, a
padded encoder buffer masked by ``kv_src_len``) and non-causal options;
``mla_apply`` is DeepSeek-V3's latent attention, expanded through the
flash kernel at prefill and absorbed (plain torch, as ``repro`` computes
it outside any kernel) at decode.

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
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import _local
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.params import ParamDef
from repro_torch.parallel.sharding import axis_size, shard_act, write_rows

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
    rules: Any = None                 # ShardingRules for act constraints


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

def attn_defs(cfg: ArchConfig, *, cross: bool = False) -> dict:
    """``cross`` marks a cross-attention's projections, as ``repro``'s
    signature does; they have the self-attention's shapes."""
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


def proj_rows(x, w, rules, groups: int):
    """``einsum("bsd,d...->bs...", x, w)``: a projection of each row of
    ``x`` whose features the caller splits into ``groups`` (heads, say).
    Under rules whose tensor axis does not divide ``groups``, ``w`` keeps
    them whole, and DTensor may split the einsum's flattened features over
    that axis instead -- where ``x``'s rows are split in strides (a
    sequence split inside a split batch) it cannot keep the rows split --
    and no view splits such features back into groups.  There the product
    is a ``bmm`` with the batch kept apart, whose rows stay split as
    ``x``'s (batch, sequence) are."""
    if rules is None or groups % axis_size(rules, rules.tensor) == 0:
        return torch.einsum("bsd,d...->bs...", x, w)
    y = torch.bmm(x, w.flatten(1).expand(x.shape[0], -1, -1))
    return y.unflatten(-1, tuple(w.shape[1:]))


def proj_heads(y, w, rules, groups: int):
    """``einsum("bshk,hkd->bsd", y, w)``: the output projection of the
    ``groups`` heads of ``y``.  Under rules whose tensor axis does not
    divide ``groups``, DTensor may split the einsum's flattened heads over
    that axis in the backward, and no view splits such features back into
    heads; there the product is a ``bmm`` over the flattened heads with
    the batch kept apart (:func:`proj_rows`' counterpart)."""
    if rules is None or groups % axis_size(rules, rules.tensor) == 0:
        return torch.einsum("bshk,hkd->bsd", y, w)
    return torch.bmm(y.flatten(2), w.flatten(0, 1).expand(y.shape[0], -1, -1))


def attn_apply(p, x, ctx: Ctx, *, window: int | None = None,
               cache: dict | None = None, kv_src=None, kv_src_len=None,
               causal: bool = True, use_rope: bool = True):
    """Self-attention with RoPE (causal unless ``causal=False``) or, with
    ``kv_src`` (an encoder's output, possibly a padded buffer of which the
    first ``kv_src_len`` rows are valid: an int, or an integer tensor, 0-d
    or a length per batch row), cross-attention; returns (y, cache).
    ``repro``'s rule: RoPE only when ``use_rope and kv_src is None``,
    causal only when ``causal and kv_src is None``.  Cache: {'k','v'}:
    (B, Smax, KV, hd); a cross-attention (like ``repro``'s) takes none and
    recomputes its keys and values from ``kv_src`` at every call.

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
    row at its own ``q_start = t[b]``.  A cross-attention's
    ``kv_src_len`` goes to the attention as ``kv_len`` as it is: on the
    card an int32 tensor there is read by the split-K decode on the
    device.
    """
    cfg = ctx.cfg
    src = x if kv_src is None else kv_src
    q = proj_rows(x, p["wq"], ctx.rules, cfg.n_heads)
    k = proj_rows(src, p["wk"], ctx.rules, cfg.n_kv_heads)
    v = proj_rows(src, p["wv"], ctx.rules, cfg.n_kv_heads)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"])
        k = rms_norm(k, p["knorm"])
    if use_rope and kv_src is None:
        q = apply_rope(q, ctx.positions, cfg.rope_theta)
        k = apply_rope(k, ctx.positions, cfg.rope_theta)

    S = x.shape[1]
    if cache is not None and not ctx.decode:
        if isinstance(cache["k"], DTensor):
            write_rows(cache["k"], k, start=0)
            write_rows(cache["v"], v, start=0)
        else:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        q_start, kv_len, ks, vs = 0, None, k, v
    elif cache is not None and torch.is_tensor(ctx.cache_len):
        t = ctx.cache_len
        _write_at(cache["k"], k, ctx)
        _write_at(cache["v"], v, ctx)
        # kv_len = t + S is what the causal mask already keeps (the last
        # query sits at t + S - 1), and the kernel derives it on the
        # device: a tensor t + S would cost a launch a layer
        q_start, kv_len, ks, vs = t, None, cache["k"], cache["v"]
    elif cache is not None:
        t = int(ctx.cache_len)
        _write_at(cache["k"], k, ctx)
        _write_at(cache["v"], v, ctx)
        q_start, kv_len, ks, vs = t, t + S, cache["k"], cache["v"]
    else:
        q_start, kv_len, ks, vs = 0, kv_src_len, k, v

    y = flash_attention(
        q, ks, vs,
        causal=causal and kv_src is None,
        window=window,
        q_start=q_start,
        kv_len=kv_len,
        impl=ctx.impl,
        kv_chunk=cfg.attn_kv_chunk,
    )
    out = proj_heads(y, p["wo"], ctx.rules, cfg.n_heads)
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


def moe_defs(cfg: ArchConfig) -> dict:
    D, Fd, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    d = {
        "router": ParamDef((D, E), (None, None), dtype=f32),
        "wi_gate": ParamDef((E, D, Fd), ("expert", "fsdp", None)),
        "wi_up": ParamDef((E, D, Fd), ("expert", "fsdp", None)),
        "wo": ParamDef((E, Fd, D), ("expert", None, "fsdp")),
    }
    if cfg.n_shared_experts:
        d["shared"] = mlp_defs(cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
    return d


def moe_capacity(n_tokens: int, cfg: ArchConfig,
                 capacity_factor: float) -> int:
    """Slots per expert for ``n_tokens`` tokens dispatched together:
    ``repro``'s ``max(8, round(N K / E cf / 8) * 8)``, at most N, with
    Python's ``round`` (half to even) as there."""
    E, K = cfg.n_experts, cfg.n_experts_per_tok
    cap = max(8, int(round(n_tokens * K / E * capacity_factor / 8)) * 8)
    return min(cap, n_tokens)


def moe_route(probs, K: int):
    """The top-``K`` experts of each token and their gates, normalised over
    the K: ``(gate_vals, expert_idx)``, each ``probs.shape[:-1] + (K,)``."""
    gate_vals, expert_idx = torch.topk(probs, K, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, expert_idx


def moe_slots(expert_idx, cfg: ArchConfig, capacity_factor: float):
    """Each group's ``N * K`` (token, expert) slots in expert order (a
    stable sort of the flat expert ids, ``sort_idx``) for ``expert_idx``
    ``(G, N, K)``: ``(dest, keep, tok_of_slot, sort_idx, cap)``, ``dest``
    the slot's row of the ``(E * cap + 1)`` dispatch buffer (``E * cap``,
    the drop row, where its expert is full).  The expert counts are a
    comparison sum, not ``bincount``, whose output size the device would
    have to read back: nothing here leaves the device."""
    Gp, N, K = expert_idx.shape
    E = cfg.n_experts
    flat_e = expert_idx.reshape(Gp, N * K)
    sort_idx = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, sort_idx)
    tok_of_slot = sort_idx // K
    counts = (flat_e[..., None] == torch.arange(
        E, device=flat_e.device)).sum(1)                          # (G, E)
    group_start = torch.cumsum(counts, -1) - counts
    rank = torch.arange(N * K, device=flat_e.device) - torch.gather(
        group_start, 1, sorted_e)
    cap = moe_capacity(N, cfg, capacity_factor)
    keep = rank < cap
    dest = torch.where(keep, sorted_e * cap + rank,
                       torch.full_like(rank, E * cap))
    return dest, keep, tok_of_slot, sort_idx, cap


def moe_dispatch(probs, cfg: ArchConfig, capacity_factor: float):
    """The sort-based top-k dispatch of ``repro``'s ``moe_apply`` for
    ``probs`` ``(G, N, E)``: G groups of N tokens, each group with its own
    capacity; :func:`moe_route`, then :func:`moe_slots`.  Returns
    ``(gate_vals, expert_idx, dest, keep, tok_of_slot, sort_idx, cap)``."""
    gate_vals, expert_idx = moe_route(probs, cfg.n_experts_per_tok)
    return (gate_vals, expert_idx,
            *moe_slots(expert_idx, cfg, capacity_factor))


def moe_route_dispatch(xt, router, cfg: ArchConfig, capacity_factor: float,
                       with_aux: bool = True):
    """Router, top-k dispatch and balance loss of ``xt`` ``(G, N, D)``, G
    groups of N tokens each with its own capacity: returns ``(buf, gates,
    dest_nk, aux)``, ``buf`` ``(G, E, cap, D)`` the experts' input slots
    (zeros where unused), ``gates`` ``(G, N, K)`` each token's normalised
    top-K gates and ``dest_nk`` ``(G, N * K)`` each (token, k) slot's row
    of the ``(E * cap + 1)`` rows of expert outputs (``E * cap``, the drop
    row, where its expert was full); ``aux`` 0.0 unless ``with_aux``."""
    G, N, D = xt.shape
    E = cfg.n_experts
    logits = (xt.to(f32) @ router).to(f32)                        # (G, N, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx, dest, keep, tok_of_slot, sort_idx, cap = \
        moe_dispatch(probs, cfg, capacity_factor)

    aux = 0.0
    if with_aux:
        # load-balance aux loss (Switch): E * sum_e f_e * p_e, per group
        me = (expert_idx[..., 0, None] == torch.arange(
            E, device=xt.device)).to(f32).mean(1)
        ce = probs.mean(1)
        aux = (E * (me * ce).sum(-1)).mean()

    # dispatch: slot i of group g lands in row dest[g, i] of the group's
    # buffer; the drop row E * cap takes every dropped slot's zeros
    gathered = torch.where(keep[..., None],
                           torch.gather(xt, 1, tok_of_slot[..., None]
                                        .expand(-1, -1, D)),
                           torch.zeros((), dtype=xt.dtype, device=xt.device))
    rows = dest + (E * cap + 1) * torch.arange(
        G, device=xt.device)[:, None]
    buf = torch.zeros((G * (E * cap + 1), D), dtype=xt.dtype,
                      device=xt.device)
    buf.index_put_((rows.reshape(-1),), gathered.reshape(-1, D))
    buf = buf.view(G, E * cap + 1, D)[:, :-1].reshape(G, E, cap, D)
    dest_nk = torch.empty_like(dest).scatter_(1, sort_idx, dest)  # (G, N*K)
    return buf, gate_vals, dest_nk, aux


def moe_experts(buf, p, rules=None):
    """The experts' SwiGLU over their slots: ``buf`` ``(G, E, cap, D)`` with
    ``p``'s ``(E, ...)`` weights -> ``(G, E, cap, D)``; with ``rules`` the
    hidden slots are pinned as ``repro`` pins them."""
    g = torch.einsum("xecd,edf->xecf", buf, p["wi_gate"])
    h = F.silu(g) * torch.einsum("xecd,edf->xecf", buf, p["wi_up"])
    if rules is not None:
        h = shard_act(h, rules, "nxbn")
    return torch.einsum("xecf,efd->xecd", h, p["wo"])


def moe_combine(yb, gates, dest_nk, cfg: ArchConfig):
    """Each (token, k) slot reads its expert's row of ``yb`` ``(G, E * cap,
    D)`` (the zero row where it was dropped), weighted by its gate, summed
    over k in one fixed-order reduction -> ``(G, N, D)``."""
    G, _, D = yb.shape
    yb = torch.cat([yb, torch.zeros((G, 1, D), dtype=yb.dtype,
                                    device=yb.device)], 1)
    y_nk = torch.gather(yb, 1, dest_nk[..., None].expand(-1, -1, D))
    K = cfg.n_experts_per_tok
    y_nk = y_nk.view(G, -1, K, D) * gates[..., None].to(yb.dtype)
    return y_nk.sum(2)


def moe_apply(p, x, cfg: ArchConfig, capacity_factor: float | None = None,
              rules=None, *, per_row: bool = False, with_aux: bool = True):
    """Sort-based top-k dispatch with per-expert capacity (GShard-style
    drop), the Switch load-balance aux loss and the shared experts:
    ``repro``'s ``moe_apply``; returns ``(y, aux)``.

    The expert products run over the dense ``(E, cap, D)`` buffer with
    ``torch.einsum``, as ``repro`` computes them outside any kernel.  The
    combine gathers each (token, k) slot's expert output back into ``(N,
    K)`` order and sums over K in one fixed-order reduction, where
    ``repro`` scatter-adds into the tokens (``.at[].add``, float atomics
    on the card): two runs give the same bits.

    ``per_row``: each batch row is its own dispatch group, with the
    capacity of its own ``S`` tokens -- what ``repro``'s ``jax.vmap`` of the
    decode step over requests computes (each row there is a batch-1
    call), so that rows, padding rows included, never compete for slots.
    ``aux`` is then the mean of the rows' aux losses.  ``with_aux=False``
    returns 0.0 for it and launches none of its ops (a serving step; under
    ``jax.jit`` ``repro``'s unused aux is dead code too).

    Under ``rules`` the routing, dispatch and combine (index arithmetic)
    run on whole tensors through ``local_map``, every rank the same, and
    the expert products on DTensors; ``cfg.moe_dispatch_sharding`` pins
    the tokens and the dispatch buffers where ``repro`` pins them (tokens
    and capacity over the batch axes, experts over the expert axis)."""
    if capacity_factor is None:
        capacity_factor = cfg.moe_capacity_factor
    constrain = cfg.moe_dispatch_sharding and rules is not None
    B, S, D = x.shape
    E = cfg.n_experts
    Gp = B if per_row else 1
    N = B * S // Gp
    xt = x.reshape(Gp, N, D)
    if constrain:
        xt = shard_act(xt, rules, "nbn")

    if rules is None:
        buf, gates, dest_nk, aux = moe_route_dispatch(
            xt, p["router"], cfg, capacity_factor, with_aux)
    else:
        buf, gates, dest_nk, aux = _local.call_local(
            "moe_dispatch", lambda xt, r: moe_route_dispatch(
                xt, r, cfg, capacity_factor, with_aux),
            (xt, p["router"]), ({}, {}),
            ({}, {}, {}, {} if with_aux else None))
    if constrain:
        buf = shard_act(buf, rules, "nxbn")   # experts x EP, capacity x DP
    yb = moe_experts(buf, p, rules if constrain else None).reshape(
        Gp, -1, D)
    if constrain:
        yb = shard_act(yb, rules, "nbn")
    if rules is None:
        y = moe_combine(yb, gates, dest_nk, cfg)
    else:
        y = _local.call_local(
            "moe_combine", lambda yb, g, d: moe_combine(yb, g, d, cfg),
            (yb, gates, dest_nk), ({}, {}, {}), {})
    y = y.reshape(B * S, D)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg).reshape(B * S, D)
    return y.reshape(B, S, D), aux


# ---------------------------------------------------------------- MLA

def mla_defs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    D, H = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": ParamDef((D, m.q_lora_rank), ("fsdp", None)),
        "q_norm": norm_defs(m.q_lora_rank),
        "w_uq": ParamDef((m.q_lora_rank, H, qk), (None, "tensor", None)),
        "w_dkv": ParamDef(
            (D, m.kv_lora_rank + m.qk_rope_head_dim), ("fsdp", None)),
        "kv_norm": norm_defs(m.kv_lora_rank),
        "w_uk": ParamDef(
            (m.kv_lora_rank, H, m.qk_nope_head_dim), (None, "tensor", None)),
        "w_uv": ParamDef(
            (m.kv_lora_rank, H, m.v_head_dim), (None, "tensor", None)),
        "wo": ParamDef((H, m.v_head_dim, D), ("tensor", None, "fsdp")),
    }


def _write_at(buf, new, ctx: Ctx):
    """Write ``new`` ``(B, S, ...)`` into ``buf`` ``(B, Smax, ...)`` at the
    decode step's positions, in place: ``t + arange(S)`` for an int ``t``
    (checked against the buffer), one ``index_copy_`` for a 0-d tensor, an
    ``index_put_`` at ``(row, position)`` for a ``(B,)`` one; into each
    rank's shard of a DTensor ``buf`` (``parallel.sharding.write_rows``)."""
    t, S = ctx.cache_len, new.shape[1]
    new = new.to(buf.dtype)
    dt = isinstance(buf, DTensor)
    if not torch.is_tensor(t):
        t = int(t)
        if t + S > buf.shape[1]:
            raise ValueError(f"decode at position {t} of {S} tokens "
                             f"overruns a cache of {buf.shape[1]}")
        if dt:
            write_rows(buf, new, start=t)
        else:
            buf[:, t:t + S] = new
    elif t.dim() == 0:
        if dt:
            write_rows(buf, new, positions=ctx.positions[0])
        else:
            buf.index_copy_(1, ctx.positions[0], new)
    elif dt:
        write_rows(buf, new, rows=ctx.rows, positions=ctx.positions)
    else:
        buf.index_put_((ctx.rows, ctx.positions), new)


def mla_apply(p, x, ctx: Ctx, cache: dict | None = None):
    """Multi-head latent attention; returns (y, cache).  The cache holds
    the *latent* c_kv and the shared k_rope (``{'ckv': (B, Smax, r),
    'krope': (B, Smax, rope)}``), written in place.

    Prefill and training: the expanded MHA through
    :func:`~repro_torch.kernels.flash_attention.flash_attention` at (D,
    Dv) = (nope + rope, v), causal, with the softmax scale ``(nope +
    rope) ** -0.5``.  Decode: the absorbed form (q projected into the
    latent space; no per-head K/V), in plain torch ops as ``repro``
    computes it, the scores masked at the step's positions on the device
    (``ctx.positions``: an int, 0-d or ``(B,)`` position alike)."""
    cfg = ctx.cfg
    m = cfg.mla
    B, S, D = x.shape
    H = cfg.n_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = (nope + rope) ** -0.5

    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["w_dq"]), p["q_norm"])
    q = torch.einsum("bsr,rhk->bshk", cq, p["w_uq"])
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], ctx.positions, cfg.rope_theta)

    dkv = torch.einsum("bsd,dr->bsr", x, p["w_dkv"])
    c_kv = rms_norm(dkv[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = apply_rope(dkv[..., m.kv_lora_rank:][:, :, None, :],
                        ctx.positions, cfg.rope_theta)[:, :, 0]  # (B,S,rope)

    if cache is not None and not ctx.decode:
        if isinstance(cache["ckv"], DTensor):
            write_rows(cache["ckv"], c_kv, start=0)
            write_rows(cache["krope"], k_rope, start=0)
        else:
            cache["ckv"][:, :S] = c_kv
            cache["krope"][:, :S] = k_rope
    if cache is None or not ctx.decode:
        # expanded attention (training / prefill)
        k_nope = torch.einsum("bsr,rhk->bshk", c_kv, p["w_uk"])
        v = torch.einsum("bsr,rhv->bshv", c_kv, p["w_uv"])
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                      -1)
        qq = torch.cat([q_nope, q_rope], -1)
        y = flash_attention(qq, k, v, causal=True, impl=ctx.impl,
                            softmax_scale=scale)
    else:
        # absorbed decode: score via the latent space
        _write_at(cache["ckv"], c_kv, ctx)
        _write_at(cache["krope"], k_rope, ctx)
        ckv_s = cache["ckv"].to(f32)
        q_lat = torch.einsum("bshk,rhk->bshr", q_nope, p["w_uk"])
        scores = (
            torch.einsum("bshr,btr->bhst", q_lat.to(f32), ckv_s)
            + torch.einsum("bshk,btk->bhst", q_rope.to(f32),
                           cache["krope"].to(f32))) * scale
        kpos = torch.arange(ckv_s.shape[1], device=x.device)
        qpos = ctx.positions[:, None, :, None]             # (B, 1, S, 1)
        scores = torch.where(kpos <= qpos, scores, -1e30)
        w = torch.softmax(scores, dim=-1)
        ctx_lat = torch.einsum("bhst,btr->bshr", w, ckv_s)
        y = torch.einsum("bshr,rhv->bshv", ctx_lat.to(x.dtype), p["w_uv"])
    out = torch.einsum("bshv,hvd->bsd", y, p["wo"])
    return out, cache


# ---------------------------------------------------------------- embedding

def embed_defs(cfg: ArchConfig) -> dict:
    d = {"tok": ParamDef((cfg.vocab_size, cfg.d_model), ("tensor", "fsdp"),
                         init="embed")}
    if not cfg.tie_embeddings:
        d["out"] = ParamDef((cfg.d_model, cfg.vocab_size), ("fsdp", "tensor"))
    return d


def embed_apply(p, tokens, cfg: ArchConfig):
    w = p["tok"]
    if isinstance(w, DTensor):
        # the table whole on every rank, looked up by F.embedding, whose
        # gradient DTensor places; indexing's backward (an index_put_)
        # torch 2.11 cannot place, and a vocabulary split leaves masked
        # partial sums that later torch cannot reduce
        w = w.redistribute(w.device_mesh, [Replicate()] * w.device_mesh.ndim)
    x = F.embedding(tokens, w)
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
