"""One rank of the port's sharded checks on a gloo host mesh (CPU).

    python tests/torch_parallel_worker.py DATA MODEL STORE OUT RANK [moe IN]

``DATA * MODEL`` processes, one per rank, meet through the ``FileStore``
at ``STORE`` (no port), build ``make_host_mesh(DATA, MODEL)`` and
``rules_for_mesh``, and run every check on every rank; rank 0 writes the
readings to ``OUT`` as JSON, which ``tests/test_torch_parallel*.py`` read.
Imports no JAX.

Readings (all in f32, ``impl="torch"``):

  * ``train[name]``: the loss and gradients of a smoke family, and two
    train steps from the same state and batch, sharded against the
    unsharded port -- the loss's and ``grad_norm``'s relative errors,
    every gradient leaf's and every updated parameter's and optimizer
    leaf's largest error over that leaf's largest magnitude, the calls
    that went through ``local_map`` (``kernels/_local.py``), and whether
    every sharded parameter's local shard has a storage of its own size
    (``distribute_params`` keeps no rank's view of the whole leaf).  The
    expert-parallel MoE's capacity and balance loss are each batch
    shard's, so its unsharded reference is the mean of the loss over the
    data shards (``_per_shard``);
  * ``wrong_shard``: the loss and gradient readings of smoke
    ``llama3.2-1b`` with two KV-head slices of one layer's ``wk`` swapped
    in the sharded copy only (a control: it must read above the limits);
  * ``serve``: the tokens of smoke ``llama3.2-1b`` served unsharded and
    under rules (CPU, eager), in serial and vmap mode, with f32 weights
    and an f32 KV cache: a bf16 cache rounds the sharded keys' last-bit
    differences (sums in another order) to a whole bf16 ulp now and then,
    enough to flip a token whose top-2 logits are within 1e-4;
  * ``cache_specs``: the placements of the served decode state;
  * ``optim``: two train steps of smoke ``llama3.2-1b`` under rules with
    the optimizer kernels' route taken (``kernels/optim/ops.py``) and the
    kernels emulated on the CPU in their own order (``sumsq_chunked_torch``
    and the plain update on each rank's local shards), against the
    unsharded plain steps: ``grad_norm``'s relative error and the largest
    parameter and optimizer-leaf errors, and each leaf's squared sum by
    the kernels' route against the plain sum of the same DTensor
    gradient (``leaf_sumsq_rel``); how many gradient leaves autograd
    handed back ``Partial``; and the same readings with the reduction of
    those gradients taken out (a control: the ranks' local squared sums
    of Partial terms must read above the limits);
  * ``adafactor``: the same for Adafactor (smoke ``llama3.2-1b`` under
    ``optim.adafactor``): two sharded train steps with its kernels' route
    taken (``ops.adafactor_update``: the raw sums, their reduction across
    the mesh, the moments, the sums of u u and their reduction, the
    update) and the kernels emulated on the CPU in their own order
    (``ref.adafactor_*_emulated`` on each rank's local shards), against the
    unsharded plain steps: ``grad_norm``'s relative error and the largest
    parameter and optimizer-leaf errors; how many leaves are sharded; and
    the same readings with the cross-rank reduction of the partial sums
    taken out (a control: a shard's row, column and u u sums alone must
    read above the limits);
  * ``ckpt``: a sharded train state of smoke ``llama3.2-1b`` saved (every
    leaf whole) and restored with ``shardings=`` (each rank into its own
    directory): bit-equal, at the same placements, and a checkpoint
    restored into a state of other shapes raises; every restored shard
    has a storage of its own size.

With ``moe IN`` the ranks only run ``models.moe_ep.moe_apply_ep`` of smoke
``granite-moe-3b-a800m`` on the f32 inputs of the ``.npz`` file ``IN``
(``x``, ``router``, ``wi_gate``, ``wi_up``, ``wo``) and
``optim.grad_compress.compressed_psum`` of rank ``i``'s ``g<i>`` over the
``data`` dimension (2 ranks), and rank 0 writes ``y``, ``aux`` and the
sums to ``OUT`` (``.npz``), for ``tests/test_torch_moe_ep.py`` to hold
against ``repro``'s.

:func:`launch` starts the ranks of one mesh and kills them all after
``timeout`` seconds, so that a hung rank fails a test instead of holding
the suite.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.kernels import _local  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_host_mesh,
    rules_for_mesh,
)
from repro_torch.launch.serve import run_server, synth_requests  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    make_optimizer,
    make_train_step,
)
from repro_torch.models.params import (  # noqa: E402
    distribute_params,
    is_def,
    is_spec,
    param_pspecs,
    tree_leaves,
    tree_map,
)
from repro_torch.models import zoo  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.parallel.sharding import sharded  # noqa: E402

B, S = 4, 16
STEPS = 2           # the first step's learning rate is 0 (warmup)

_KV_CACHE_DEFS = zoo._kv_cache_defs

#: (name, arch, config overrides) of the train checks
FAMILIES = (
    ("llama", "llama3.2-1b", {}),
    ("granite20b", "granite-20b", {}),
    ("moe_scatter", "granite-moe-3b-a800m", {}),
    ("moe_ep", "granite-moe-3b-a800m", {"moe_impl": "ep_shardmap"}),
    ("rwkv6", "rwkv6-7b", {}),
    ("griffin", "recurrentgemma-2b", {}),
    ("encdec", "seamless-m4t-medium", {}),
)


def _params(model, seed: int = 0):
    """f32 weights from ``seed``, every zero-initialized leaf filled with
    small values (at init the recurrent mixing leaves are zeros and ones
    and the recurrences would do nothing)."""
    g = torch.Generator().manual_seed(seed)
    p = tree_map(lambda t: t.float(), model.init(g, "cpu"))
    defs = tree_leaves(model.defs, is_leaf=is_def)
    leaves = tree_leaves(p)
    for d, t in zip(defs, leaves):
        if d.init == "zeros":
            t.add_(0.1 * torch.randn(t.shape, generator=g))
    return p


def _clone(tree):
    return tree_map(lambda t: t.detach().clone(), tree)


def _batch(cfg):
    rng = np.random.default_rng(1)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.from_numpy(
            rng.normal(size=(B, 8, cfg.d_model)).astype(np.float32))
    return out


def _whole(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b| (the absolute error where b is
    all zeros)."""
    a, b = _whole(a).float(), _whole(b).float()
    scale = float(b.abs().max()) if b.numel() else 0.0
    err = float((a - b).abs().max()) if b.numel() else 0.0
    return err / scale if scale > 0 else err


def _grads(model, params, batch, rules, impl="torch"):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, _ = model.loss_fn(params, batch, impl=impl, rules=rules)
    with sharded(rules):
        grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return float(_whole(loss.detach())), [_whole(g) for g in grads]


def _per_shard(model, n: int):
    """``model`` whose loss is the mean of ``loss_fn`` over ``n`` equal
    batch shards: the unsharded counterpart of the expert-parallel MoE,
    whose capacity and balance loss are each data shard's (``repro``'s
    ``moe_apply_ep`` too); the lm loss, a mean over tokens, is unchanged."""
    def loss_fn(params, batch, *, impl="auto", rules=None):
        parts = [model.loss_fn(params, {k: v.chunk(n)[i]
                                        for k, v in batch.items()},
                               impl=impl, rules=rules) for i in range(n)]
        metrics = {k: sum(m[k] for _, m in parts) / n for k in parts[0][1]}
        return metrics["loss"], metrics
    return dataclasses.replace(model, loss_fn=loss_fn)


def train_check(arch, overrides, rules, mesh, *, corrupt=False) -> dict:
    cfg = dataclasses.replace(configs.smoke(arch), **overrides)
    model = build_model(cfg)
    params = _params(model)
    batch = _batch(cfg)
    opt = make_optimizer(cfg)

    ref_model = model
    n_data = mesh.size(0)
    if cfg.moe_impl == "ep_shardmap" and n_data > 1:
        ref_model = _per_shard(model, n_data)
    ref_p = _clone(params)
    l_ref, g_ref = _grads(ref_model, ref_p, batch, None)
    ref_state = {"params": ref_p, "opt": opt.init(ref_p)}
    ref_step = make_train_step(ref_model, opt, None, impl="torch")
    for _ in range(STEPS):
        ref_state, ref_m = ref_step(ref_state, batch)

    sh = _clone(params)
    if corrupt:                         # swap two KV heads of one layer
        wk = sh["dense"]["attn"]["wk"]
        wk[0, :, [0, 1]] = wk[0, :, [1, 0]].clone()
    before = dict(_local.LOCAL_CALLS)
    sp = distribute_params(sh, model.defs, rules, mesh)
    split = [p.to_local() for p in tree_leaves(sp)
             if any(not pl.is_replicate() for pl in p.placements)]
    own = all(t.untyped_storage().nbytes() == t.nbytes for t in split)
    l_sh, g_sh = _grads(model, sp, batch, rules)
    if corrupt:                         # the loss and gradients suffice
        return {"loss_rel": abs(l_sh - l_ref) / abs(l_ref),
                "grad": max(_rel(a, b) for a, b in zip(g_sh, g_ref))}
    state = {"params": sp,
             "opt": distribute_params(opt.init(sh), opt.state_defs(
                 model.defs), rules, mesh)}
    step = make_train_step(model, opt, rules, impl="torch")
    for _ in range(STEPS):
        state, m = step(state, batch)
    local = {k: v - before.get(k, 0) for k, v in _local.LOCAL_CALLS.items()
             if v != before.get(k, 0)}
    return {
        "loss_rel": abs(l_sh - l_ref) / abs(l_ref),
        "step_loss_rel": abs(float(m["loss"]) - float(ref_m["loss"]))
        / abs(float(ref_m["loss"])),
        "grad_norm_rel": abs(float(m["grad_norm"])
                             - float(ref_m["grad_norm"]))
        / abs(float(ref_m["grad_norm"])),
        "grad": max(_rel(a, b) for a, b in zip(g_sh, g_ref)),
        "param": max(_rel(a, b) for a, b in zip(
            tree_leaves(state["params"]), tree_leaves(ref_state["params"]))),
        "opt": max(_rel(a, b) for a, b in zip(
            tree_leaves(state["opt"]), tree_leaves(ref_state["opt"]))),
        "placed": sum(isinstance(p, DTensor)
                      for p in tree_leaves(state["params"])),
        "sharded_leaves": len(split),
        "own_storage": own,
        "leaves": len(tree_leaves(state["params"])),
        "local_calls": local,
    }


def _f32_cache(cfg, *a, **k):
    return tree_map(lambda d: dataclasses.replace(d, dtype=torch.float32),
                    _KV_CACHE_DEFS(cfg, *a, **k), is_leaf=is_def)


def serve_check(rules, mesh) -> dict:
    cfg = configs.smoke("llama3.2-1b")
    zoo._kv_cache_defs = _f32_cache
    model = build_model(cfg)
    params = _params(model)
    prompt, gen = 8, 4
    kw = dict(smax=prompt + gen, budget_bytes=1 << 30, device="cpu")
    out = {}
    for mode in ("serial", "vmap"):
        ref_reqs = synth_requests(3, prompt, gen, cfg.vocab_size, 5)
        ref = run_server(model, _clone(params), ref_reqs, step_mode=mode,
                         **kw)
        sp = distribute_params(_clone(params), model.defs, rules, mesh)
        before = dict(_local.LOCAL_CALLS)
        reqs = synth_requests(3, prompt, gen, cfg.vocab_size, 5)
        got = run_server(model, sp, reqs, rules=rules, step_mode=mode, **kw)
        out[mode] = {
            "ref_tokens": [list(map(int, r.tokens)) for r in ref_reqs],
            "tokens": [list(map(int, r.tokens)) for r in reqs],
            "n_served": [ref["n_served"], got["n_served"]],
            "local_calls": {k: v - before.get(k, 0)
                            for k, v in _local.LOCAL_CALLS.items()
                            if v != before.get(k, 0)},
        }
    specs = param_pspecs(model.make_cache_defs(1, prompt + gen), rules, mesh)
    return {
        **out,
        "cache_specs": [list(map(str, s)) for s in tree_leaves(
            specs, is_leaf=is_spec)],
    }


def moe_check(rules, mesh, inp: str, out: str, rank: int) -> None:
    from repro_torch.models.layers import moe_defs
    from repro_torch.models.moe_ep import moe_apply_ep
    from repro_torch.optim.grad_compress import compressed_psum

    a = np.load(inp)
    cfg = configs.smoke("granite-moe-3b-a800m")
    assert not cfg.n_shared_experts
    keys = ("router", "wi_gate", "wi_up", "wo")
    defs = moe_defs(cfg)
    p = distribute_params({k: torch.from_numpy(a[k]) for k in keys},
                          {k: defs[k] for k in keys}, rules, mesh)
    with sharded(rules):
        y, aux = moe_apply_ep(p, torch.from_numpy(a["x"]), cfg, rules)
        y, aux = y.full_tensor(), aux.full_tensor()
    g = torch.from_numpy(a[f"g{mesh.get_local_rank('data')}"])
    total = compressed_psum(g, (mesh, "data"))
    if rank == 0:
        np.savez(out, y=y.numpy(), aux=aux.numpy(), psum=total.numpy())


def launch(data: int, model_n: int, tmp: Path, *extra,
           timeout: float = 180.0) -> Path:
    """Run the ranks of a ``(data, model_n)`` mesh in ``tmp``; returns the
    path rank 0 wrote.  Every rank is killed at ``timeout`` seconds."""
    out = tmp / ("out.npz" if extra else "out.json")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(data * model_n)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(data), str(model_n),
         str(tmp / "store"), str(out), str(r), *map(str, extra)],
        stdout=log, stderr=subprocess.STDOUT, env=env)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (tmp / f"rank{bad[0]}.log").read_text()[-3000:]
        raise RuntimeError(f"ranks {bad} of the ({data}, {model_n}) mesh "
                           f"failed or timed out:\n{tail}")
    return out


def optim_check(rules, mesh) -> dict:
    from repro_torch.kernels.optim import ops as OO
    from repro_torch.kernels.optim import ref as OR
    from repro_torch.launch import steps as ST

    cfg = configs.smoke("llama3.2-1b")
    model = build_model(cfg)
    params = _params(model)
    batch = _batch(cfg)
    opt = make_optimizer(cfg)
    ref_p = _clone(params)
    ref_state = {"params": ref_p, "opt": opt.init(ref_p)}
    ref_step = make_train_step(model, opt, None, impl="torch")
    for _ in range(STEPS):
        ref_state, ref_m = ref_step(ref_state, batch)

    sp = distribute_params(_clone(params), model.defs, rules, mesh)
    leaves = tree_leaves(sp)
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.loss_fn(sp, batch, impl="torch", rules=rules)
    with sharded(rules):
        grads = torch.autograd.grad(loss, leaves)
    n_partial = sum(any(pl.is_partial() for pl in g.placements)
                    for g in grads)

    def sumsq_cuda(grads):
        return OR.sumsq_chunked_torch(grads)

    def adamw_update_cuda(grads, params, ms, vs, **kw):
        OR.adamw_update_torch([g.clone() for g in grads], params, ms, vs,
                              **kw)

    def run(reduce: bool) -> dict:
        saved = (OO.use_kernels, OO._kernel.sumsq_cuda,
                 OO._kernel.adamw_update_cuda, OO._whole_terms,
                 ST.placed_like)
        OO.use_kernels = lambda impl, leaf: True
        OO._kernel.sumsq_cuda = sumsq_cuda
        OO._kernel.adamw_update_cuda = adamw_update_cuda
        if not reduce:
            OO._whole_terms = lambda g: g
            ST.placed_like = lambda grads, params: grads
        try:
            sums = OO.sumsq(list(grads), impl="torch")
            plain = OR.sumsq_torch(grads)
            leaf_rel = max(abs(float(_whole(a)) - float(_whole(b)))
                           / abs(float(_whole(b)))
                           for a, b in zip(sums, plain))
            state = {"params": distribute_params(
                         _clone(params), model.defs, rules, mesh),
                     "opt": distribute_params(opt.init(_clone(params)),
                                              opt.state_defs(model.defs),
                                              rules, mesh)}
            step = make_train_step(model, opt, rules, impl="torch")
            for _ in range(STEPS):
                state, m = step(state, batch)
        finally:
            (OO.use_kernels, OO._kernel.sumsq_cuda,
             OO._kernel.adamw_update_cuda, OO._whole_terms,
             ST.placed_like) = saved
        return {
            "leaf_sumsq_rel": leaf_rel,
            "grad_norm_rel": abs(float(m["grad_norm"])
                                 - float(ref_m["grad_norm"]))
            / abs(float(ref_m["grad_norm"])),
            "param": max(_rel(a, b) for a, b in zip(
                tree_leaves(state["params"]),
                tree_leaves(ref_state["params"]))),
            "opt": max(_rel(a, b) for a, b in zip(
                tree_leaves(state["opt"]), tree_leaves(ref_state["opt"]))),
        }

    return {"partial_grads": n_partial, "leaves": len(grads),
            "reduced": run(True), "control": run(False)}


def adafactor_check(rules, mesh) -> dict:
    from repro_torch.kernels.optim import ops as OO
    from repro_torch.kernels.optim import ref as OR
    from repro_torch.optim import adafactor

    cfg = configs.smoke("llama3.2-1b")
    model = build_model(cfg)
    params = _params(model)
    batch = _batch(cfg)
    opt = adafactor(lr=1e-2)
    ref_p = _clone(params)
    ref_state = {"params": ref_p, "opt": opt.init(ref_p)}
    ref_step = make_train_step(model, opt, None, impl="torch")
    for _ in range(STEPS):
        ref_state, ref_m = ref_step(ref_state, batch)
    K = OO._kernel
    names = ("sumsq_cuda", "adafactor_sums_cuda", "adafactor_finish_cuda",
             "adafactor_rms_cuda", "adafactor_update_cuda")
    emulated = (lambda grads: OR.sumsq_chunked_torch(grads),
                OR.adafactor_sums_emulated, OR.adafactor_finish_emulated,
                OR.adafactor_rms_emulated, OR.adafactor_update_emulated)

    def run(reduce: bool) -> dict:
        saved = ([getattr(K, n) for n in names], OO.use_kernels,
                 OO._reduce_over)
        for n, f in zip(names, emulated):
            setattr(K, n, f)
        OO.use_kernels = lambda impl, leaf: True
        if not reduce:
            OO._reduce_over = lambda local, like, dims: local
        try:
            state = {"params": distribute_params(
                         _clone(params), model.defs, rules, mesh),
                     "opt": distribute_params(opt.init(_clone(params)),
                                              opt.state_defs(model.defs),
                                              rules, mesh)}
            step = make_train_step(model, opt, rules, impl="torch")
            for _ in range(STEPS):
                state, m = step(state, batch)
        finally:
            for n, f in zip(names, saved[0]):
                setattr(K, n, f)
            OO.use_kernels, OO._reduce_over = saved[1:]
        return {
            "grad_norm_rel": abs(float(m["grad_norm"])
                                 - float(ref_m["grad_norm"]))
            / abs(float(ref_m["grad_norm"])),
            "param": max(_rel(a, b) for a, b in zip(
                tree_leaves(state["params"]),
                tree_leaves(ref_state["params"]))),
            "opt": max(_rel(a, b) for a, b in zip(
                tree_leaves(state["opt"]), tree_leaves(ref_state["opt"]))),
            "sharded_leaves": sum(
                any(pl.is_shard() for pl in t.placements)
                for t in tree_leaves(state["params"])),
        }

    return {"reduced": run(True), "control": run(False)}


def ckpt_check(rules, mesh, tmp: Path, rank: int) -> dict:
    from repro_torch.checkpoint import restore, save
    from repro_torch.launch.steps import out_shardings_for, state_specs

    cfg = configs.smoke("llama3.2-1b")
    model = build_model(cfg)
    opt = make_optimizer(cfg)
    p = _params(model)
    state = {"params": distribute_params(p, model.defs, rules, mesh),
             "opt": distribute_params(opt.init(p), opt.state_defs(
                 model.defs), rules, mesh)}
    d = str(tmp / f"ckpt{rank}")
    save(d, 3, state)
    like = tree_map(lambda t: torch.zeros_like(t.full_tensor()), state)
    back = restore(d, 3, like, shardings=out_shardings_for(
        state_specs(model, opt, mesh, rules)))
    pairs = list(zip(tree_leaves(back), tree_leaves(state)))
    other = build_model(dataclasses.replace(cfg, d_model=2 * cfg.d_model))
    po = _params(other)
    try:
        restore(d, 3, {"params": po, "opt": opt.init(po)})
        raised = False
    except ValueError:
        raised = True
    return {
        "bit_equal": all(torch.equal(a.full_tensor(), b.full_tensor())
                         for a, b in pairs),
        "placements": all(a.placements == b.placements for a, b in pairs),
        "sharded_leaves": sum(any(not pl.is_replicate() for pl in
                                  b.placements) for _, b in pairs),
        "own_storage": all(a.to_local().untyped_storage().nbytes()
                           == a.to_local().nbytes for a, _ in pairs),
        "raises_on_shape": raised,
    }


def main() -> None:
    data, model_n, store, out, rank = sys.argv[1:6]
    data, model_n, rank = int(data), int(model_n), int(rank)
    world = data * model_n
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    mesh = make_host_mesh(data, model_n, device="cpu")
    rules = rules_for_mesh(mesh)
    if sys.argv[6:7] == ["moe"]:
        moe_check(rules, mesh, sys.argv[7], out, rank)
        dist.barrier()
        dist.destroy_process_group()
        return
    res = {"train": {}}
    for name, arch, overrides in FAMILIES:
        res["train"][name] = train_check(arch, overrides, rules, mesh)
    res["wrong_shard"] = train_check("llama3.2-1b", {}, rules, mesh,
                                     corrupt=True)
    res["serve"] = serve_check(rules, mesh)
    res["ckpt"] = ckpt_check(rules, mesh, Path(out).parent, rank)
    res["optim"] = optim_check(rules, mesh)
    res["adafactor"] = adafactor_check(rules, mesh)
    if rank == 0:
        Path(out).write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
