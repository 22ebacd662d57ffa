"""The training CLI of the port: the counterpart of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 8                           # on the card, at full width
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma-2b --layers 3 # published width, 3 layers deep
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch rwkv6-7b --layers 17         # published width, 17 of 32
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
        --steps 4                           # the smoke config on the CPU

Wires together: config -> model -> optimizer -> data pipeline ->
fault-tolerant loop with async checkpointing, resuming from the newest
checkpoint in ``--ckpt-dir`` (default ``build/train_ckpt`` at the root of
the checkout).  It logs the loss and tokens/s every ``--log-every`` steps,
as ``repro`` does.  The train step (``launch/steps.py:make_train_step``)
runs the attention's forward and backward through the hand-written flash
kernels on the card (Griffin's local attention with its window), and
Griffin's RG-LRU through its forward and backward kernels
(``kernels/rglru``): ``--arch recurrentgemma-2b`` trains at full width on
one card.  RWKV-6's WKV-6 runs through its forward and backward kernels
(``kernels/rwkv6``): ``--arch rwkv6-7b`` trains at published width with
its depth cut to fit one card (``--layers 17``: AdamW's state of all 32
layers, ~90 GB, does not).  Rematerialization follows the config's ``remat``, as in
``repro`` (``"block"`` in every config: each block's forward runs again in
the backward, so the attention's forward kernel launches twice a layer a
step; ``models/zoo.py:_maybe_remat``).  Weights are random, drawn from ``--seed``.
``--mesh single|multi`` trains on the production mesh (16 x 16, or 2 x 16 x
16 across pods; ``launch/mesh.py``) with ``rules_for_mesh``'s rules, the
state placed by ``distribute_params``: it needs a process group of those
256 (512) ranks and raises a ``ValueError`` naming that world size
otherwise, as ``repro``'s ``jax.make_mesh`` fails without the devices.
``--device`` is ``cuda`` unless ``cpu`` is asked for; without a card it
raises.  On the card without ``--mesh`` every step is one replay of the
step captured in a CUDA graph (``launch/steps.py:CapturedTrainStep``, the
counterpart of ``repro``'s ``jax.jit(step_fn, donate_argnums=(0,))``; its
first step is the capture's warm-up); on the CPU and under ``--mesh`` the
step runs eagerly.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path

import torch

import repro_torch.configs as configs
from repro_torch.checkpoint import CheckpointManager, latest_step, restore
from repro_torch.core.executor import resolve_device
from repro_torch.data import DataPipeline
from repro_torch.launch.mesh import make_production_mesh, rules_for_mesh
from repro_torch.launch.steps import (
    CapturedTrainStep,
    make_optimizer,
    make_train_step,
)
from repro_torch.models.params import distribute_params, tree_leaves
from repro_torch.models.zoo import build_model
from repro_torch.runtime import FaultTolerantLoop

log = logging.getLogger("repro_torch.train")

DEFAULT_CKPT_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "train_ckpt"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--layers", type=int, default=None,
                    help="keep the config's first N layers, every width "
                         "as it is (a smaller model and checkpoint)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=str(DEFAULT_CKPT_DIR))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh", choices=("none", "single", "multi"),
                    default="none")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train as the flags say; returns ``{"state", "start", "end_step",
    "losses", "stragglers"}`` (the final train state, the step it resumed
    from, the step it stopped at, each step's loss and the straggler
    count)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    device = resolve_device(args.device)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    cfg = configs.cut_depth(cfg, args.layers)
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=args.lr)

    mesh = rules = None
    if args.mesh != "none":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=device)
        rules = rules_for_mesh(mesh)

    sched = dict(peak_lr=args.lr, warmup=max(args.steps // 20, 10),
                 total_steps=args.steps)
    # on the card one CUDA graph a step, as repro jits its step; eagerly
    # on the CPU and under rules (ROADMAP A8)
    captured = device.type == "cuda" and rules is None
    step_fn = (CapturedTrainStep(model, opt, device=device, **sched)
               if captured else make_train_step(model, opt, rules, **sched))
    pipe = DataPipeline(cfg=cfg, seq_len=args.seq, global_batch=args.batch,
                        seed=args.seed)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = model.init(gen, device)
    n_params = sum(p.numel() for p in tree_leaves(params))
    log.info("arch=%s params=%.2fM device=%s", cfg.name, n_params / 1e6,
             device)
    state = {"params": params, "opt": opt.init(params)}
    if rules is not None:
        state = {"params": distribute_params(state["params"], model.defs,
                                             rules, mesh),
                 "opt": distribute_params(state["opt"],
                                          opt.state_defs(model.defs),
                                          rules, mesh)}

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start = latest_step(args.ckpt_dir) or 0
    if start:
        log.info("resuming from checkpoint step %d", start)
        state = restore(args.ckpt_dir, start, state)

    losses = []
    t_last = time.perf_counter()

    def on_metrics(step, metrics):
        nonlocal t_last
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0:
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            tok_s = args.batch * args.seq * args.log_every / dt
            log.info("step %5d loss=%.4f  %.1f tok/s", step,
                     float(metrics["loss"]), tok_s)

    def run_step(state, batch):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        if not captured:         # the captured step copies into its own
            batch = {k: v.to(device) for k, v in batch.items()}
        return step_fn(state, batch)

    loop = FaultTolerantLoop(
        step_fn=run_step,
        ckpt_manager=ckpt,
        batch_iter_factory=pipe.iter_from,
        ckpt_every=args.ckpt_every,
    )
    state, end_step = loop.run(state, start, args.steps,
                               on_metrics=on_metrics)
    first = sum(losses[:10]) / max(len(losses[:10]), 1)
    last = sum(losses[-10:]) / max(len(losses[-10:]), 1)
    log.info("done at step %d: loss %.4f -> %.4f (stragglers=%d)",
             end_step, first, last, loop.timer.stragglers)
    return {"state": state, "start": start, "end_step": end_step,
            "losses": losses, "stragglers": loop.timer.stragglers}


if __name__ == "__main__":
    main()
