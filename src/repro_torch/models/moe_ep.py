"""Expert-parallel MoE through ``local_map``: the counterpart of
``repro.models.moe_ep`` (``jax.shard_map`` there).

The communication schedule is written out rather than left to DTensor's
propagation over the dispatch scatter:

  * the tokens are sharded over the batch axes and *replicated over the
    expert axis*, so every rank already holds the tokens of its batch
    shard: routing and building the per-expert dispatch buffer is local,
    and each rank slices out its own experts -- dispatch moves no bytes;
  * expert weights are sharded (expert -> the expert axis, fsdp -> the
    data axis); each rank all-gathers the fsdp shards of its experts'
    weights per layer, as ZeRO-3 does for dense weights
    (``all_gather_tensor_autograd``: its backward is the reduce-scatter of
    the weights' gradient);
  * each rank computes its ``E / tp`` experts over its local capacity
    slots, with ``repro``'s capacity ``max(8, round(N_l K / E cf / 8) 8)``
    (at most ``N_l``) of its ``N_l`` local tokens;
  * combine: the port's fixed-order gather-and-sum into the local tokens
    (``layers.moe_combine``; no float atomics), then an all-reduce sum over
    the expert axis.

The balance loss is each batch shard's, averaged over the batch axes.  At a
mesh of one rank the ops are those of ``layers.moe_apply`` in the same
order: the two forms give the same bits.

Gradients: the all-reduces are Megatron's "g" (sum forward, identity
backward: every rank downstream holds the same replicated gradient), and
``local_map`` is told that the local gradients of the tokens and the router
are partial sums over the ranks that computed different experts (and, for
the router, different tokens), so DTensor adds them up.  The balance loss
is identical on the expert ranks of a batch shard, so each contributes
``1 / tp`` of it to the sum.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed._functional_collectives import (
    all_gather_tensor_autograd,
)
from torch.distributed.tensor import Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import _local
from repro_torch.models.layers import (
    mlp_apply,
    moe_combine,
    moe_experts,
    moe_route_dispatch,
)
from repro_torch.parallel.sharding import as_dtensor


class _SumOver(torch.autograd.Function):
    """All-reduce sum over ``groups`` forward, the gradient as it is
    backward."""

    @staticmethod
    def forward(ctx, x, groups):
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, op=dist.ReduceOp.SUM, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _flat(ax) -> tuple:
    if ax is None:
        return ()
    return (ax,) if isinstance(ax, str) else tuple(ax)


def moe_apply_ep(p, x, cfg: ArchConfig, rules, *, per_row: bool = False,
                 with_aux: bool = True):
    """Expert-parallel MoE over ``rules.mesh``; returns ``(y, aux)`` as
    ``layers.moe_apply`` does (``per_row``: each batch row its own dispatch
    group; ``with_aux=False``: aux 0.0, none of its ops)."""
    if rules is None or rules.mesh is None:
        raise ValueError("the expert-parallel MoE needs rules with a mesh")
    mesh = rules.mesh
    names = tuple(mesh.mesh_dim_names)
    data_js = [names.index(a) for a in _flat(rules.batch) if a in names]
    ep_j = names.index(rules.expert) if rules.expert in names else None
    E = cfg.n_experts
    B, S, D = x.shape
    tp = mesh.size(ep_j) if ep_j is not None else 1
    n_data = 1
    for j in data_js:
        n_data *= mesh.size(j)
    if E % tp:
        raise ValueError(f"{E} experts do not divide over the expert axis "
                         f"of {tp} ranks")
    if B % n_data:
        raise ValueError(f"a batch of {B} does not divide over the batch "
                         f"axes' {n_data} ranks")
    # the fsdp shards of the experts' weights, where D divides them
    fsdp_j = names.index(rules.fsdp) if rules.fsdp in names \
        and D % mesh.size(names.index(rules.fsdp)) == 0 else None
    if fsdp_j is not None and fsdp_j == ep_j:
        fsdp_j = None
    cf = cfg.moe_capacity_factor
    m = mesh.get_local_rank(ep_j) if ep_j is not None and tp > 1 else 0
    e_loc = E // tp

    def spec(shard: dict) -> tuple:
        """Placements sharding dim ``shard[j]`` over mesh dim ``j`` (a
        mesh dim of one rank replicates, as ``parallel.placements``)."""
        return tuple(Shard(shard[j]) if j in shard and mesh.size(j) > 1
                     else Replicate() for j in range(mesh.ndim))

    xspec = spec(dict.fromkeys(data_js, 0))
    wspec_i = spec({**({ep_j: 0} if ep_j is not None else {}),
                    **({fsdp_j: 1} if fsdp_j is not None else {})})
    wspec_o = spec({**({ep_j: 0} if ep_j is not None else {}),
                    **({fsdp_j: 2} if fsdp_j is not None else {})})
    split = [j for j in (*data_js, ep_j)
             if j is not None and mesh.size(j) > 1]
    # the local gradients of x (each expert rank's experts) and of the
    # router (also each batch shard's tokens) are partial sums
    x_grad = tuple(Partial() if j == ep_j and tp > 1 else pl
                   for j, pl in enumerate(xspec))
    r_grad = tuple(Partial() if j in split else Replicate()
                   for j in range(mesh.ndim))
    ep_groups = [mesh.get_group(ep_j)] if ep_j is not None and tp > 1 \
        else []
    aux_groups = [mesh.get_group(j) for j in split]

    def gather(w, dim):
        if fsdp_j is None or mesh.size(fsdp_j) == 1:
            return w
        return all_gather_tensor_autograd(w, dim, (mesh, fsdp_j))

    def local_fn(x_l, router, wg_l, wu_l, wo_l):
        B_l, S_l, _ = x_l.shape
        G = B_l if per_row else 1
        xt = x_l.reshape(G, B_l * S_l // G, D)
        buf, gates, dest_nk, aux = moe_route_dispatch(
            xt, router, cfg, cf, with_aux)
        if tp > 1:                    # my experts only (no comms)
            buf = buf[:, m * e_loc:(m + 1) * e_loc]
        w = {"wi_gate": gather(wg_l, 1), "wi_up": gather(wu_l, 1),
             "wo": gather(wo_l, 2)}
        yb = moe_experts(buf, w)                       # (G, e_loc, cap, D)
        if tp > 1:                    # the other experts' rows are zero
            cap = yb.shape[2]
            yb = torch.cat([
                yb.new_zeros((G, m * e_loc, cap, D)), yb,
                yb.new_zeros((G, (tp - 1 - m) * e_loc, cap, D))], 1)
        y = moe_combine(yb.reshape(G, -1, D), gates, dest_nk, cfg)
        if ep_groups:                 # the sum over the experts
            y = _SumOver.apply(y, ep_groups)
        if with_aux and aux_groups:   # the mean over the batch shards
            aux = _SumOver.apply(aux / (n_data * tp), aux_groups)
        return y.reshape(B_l, S_l, D), aux

    _local.LOCAL_CALLS["moe_ep"] += 1
    fn = local_map(
        local_fn, out_placements=(xspec, spec({}) if with_aux else None),
        in_placements=(xspec, spec({}), wspec_i, wspec_i, wspec_o),
        in_grad_placements=(x_grad, r_grad, wspec_i, wspec_i, wspec_o),
        device_mesh=mesh, redistribute_inputs=True)
    y, aux = fn(as_dtensor(x, mesh), as_dtensor(p["router"], mesh),
                as_dtensor(p["wi_gate"], mesh), as_dtensor(p["wi_up"], mesh),
                as_dtensor(p["wo"], mesh))
    if cfg.n_shared_experts:
        y = y + mlp_apply(p["shared"], x, cfg)
    return y, aux
