"""Multi-tenant serving on the card: request queue + budgeted arena pool +
continuous-batching decode.

    python -m repro_torch.launch.serve --arch llama3.2-1b --requests 4 \
        --prompt-len 1024 --gen 32                        # on the card
    python -m repro_torch.launch.serve --arch llama3.2-1b --smoke \
        --requests 6 --prompt-len 8 --gen 4 --device cpu  # on the CPU
    python -m repro_torch.launch.serve ... --step-mode vmap   # batched

The PyTorch counterpart of ``repro.launch.serve``.  Every request's decode
state is arena-planned by SERENITY: the KV caches pinned resident at the
bottom of the plan (:func:`repro_torch.core.allocator.plan_arena_regions`),
the per-step transients (embed/attn/MLP activations, logits) stacked
above; the request then *leases* that plan from a budgeted
:class:`repro_torch.runtime.pool.ArenaPool`, which admits, queues FIFO or
rejects it against one device byte budget.

The decode loop is continuously batched: each server step advances every
admitted request by one token, and between steps each request's KV state
lives *packed in its leased uint8 arena at the planned byte offsets*
(``pack_buffers``/``unpack_buffer``, i.e. the u8 arena kernels on the
card).  A step unpacks the state, runs prefill or decode (attention
through the CUDA flash-attention kernel on the card) and packs the state
back.  Two step modes, as in ``repro``:

  ``serial``  (default) one bsz=1 decode reused for every active request,
              executed back-to-back -- transients of distinct requests are
              never live together, matching the pool's ``overlap='serial'``
              admission accounting.
  ``vmap``    all active requests advance in ONE batched decode step of a
              power-of-two batch bucket, each row at its own position (the
              counterpart of ``repro``'s ``jax.vmap`` of the step).
              Padding rows beyond the live batch repeat row 0 and are
              charged to the pool budget (``ArenaPool.reserve_scratch``)
              for the step, or the step runs at the exact batch when they
              do not fit.  All members' transients materialize at once, so
              admission uses ``overlap='none'`` accounting.

On the card each step is a CUDA graph (the counterpart of ``repro``'s
``jax.jit``): serial mode captures one for every position
(:class:`~repro_torch.launch.steps.CapturedDecodeStep`), vmap mode one per
bucket (:class:`~repro_torch.launch.steps.CapturedBatchedDecodeStep`), of
which only the bucket in use stays resident: a new bucket frees the
previous one's static cache and graph pool, and a return captures again.  A
request's state is unpacked into the graph's static cache, the graph is
replayed, and the static cache is packed back; the unpack and pack stay
outside the graph, since each request's arena lies elsewhere.  In vmap
mode the state of a leaf's batch row is not contiguous (leaves are stacked
by layer, ``(n_layers, bucket, ...)``), so each row is unpacked by the u8
kernels into a contiguous batch-1 staging tree and copied into its row
(one strided copy a leaf), and the reverse after the step.  On the CPU,
which has no CUDA graph, the steps run eagerly
(:class:`~repro_torch.launch.steps.BatchedDecodeStep` in vmap mode).
Prefill runs eagerly on both (``repro`` traces it per prompt shape).
An encoder-decoder's prefill batch also carries the request's frames
(:func:`encoder_frames`, seeded by its id; the audio frontend is a stub).

The sharded fleet (``fleet_planner_for_model``, ``run_fleet``,
``--fleet N``; ``runtime/fleet.py``) serves an open-loop workload on N
simulated decode shards, and ``--prefill-shards`` prefill shards, over
this model's real decode plans, one per sequence bucket: it builds no
parameters and touches no card, as in ``repro``::

    python -m repro_torch.launch.serve --arch llama3.2-1b --fleet 4 \
        --prefill-shards 1 --rate 2.0

Under sharding ``rules`` (``--mesh single|multi``: the production mesh
and ``rules_for_mesh``, as in ``repro``; the weights placed by
``distribute_params``) the server prefills and decodes eagerly on
DTensors: a request's state is unpacked whole from its arena, placed on
the mesh at the cache specs for the step (``launch.steps.place_state``),
and packed back whole (``full_tensor()``), so the arena plans, bytes and
offsets are those of the unsharded server; the captured steps raise
under rules (ROADMAP A8), so the server does not build them.  The other
entry points run on the card unless the caller passes ``device='cpu'``,
and raise without CUDA.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

import repro_torch.configs as configs
from repro_torch.core import Graph, PlanConfig, pin_transients, plan
from repro_torch.core.allocator import resident_bytes
from repro_torch.core.executor import (
    pack_buffers,
    resolve_device,
    unpack_buffer,
)
from repro_torch.core.plancache import default_cache
from repro_torch.launch.mesh import make_production_mesh, rules_for_mesh
from repro_torch.launch.steps import (
    BatchedDecodeStep,
    CapturedBatchedDecodeStep,
    batch_axes,
    make_captured_decode_step,
    make_decode_step,
    make_prefill_step,
    place_state,
)
from repro_torch.models.params import (
    distribute_params,
    is_def,
    tree_flatten,
    tree_leaves,
    tree_unflatten,
)
from repro_torch.models.zoo import build_model
from repro_torch.parallel.sharding import full
from repro_torch.runtime.chaos import ChaosController, TransientExecutorError
from repro_torch.runtime.fleet import Fleet, PlannerService, bucket_key_for
from repro_torch.runtime.loadgen import OpenLoopLoadGen, workload_summary
from repro_torch.runtime.pool import ArenaPool, PoolError

#: Pareto request classes decode admission serves (DESIGN.md §12): a
#: ``memory`` request leases the tight regions plan (transients time-share
#: their bytes -- maximum co-residency under the budget), a ``latency``
#: request the same layout with every transient pinned always-live
#: (:func:`~repro_torch.core.allocator.pin_transients`) -- it pays more
#: bytes so its step never waits on buffer reuse inside a shared arena.
REQUEST_CLASSES = ("memory", "latency")


def encoder_frames(rid: int, n: int, d_model: int, device) -> torch.Tensor:
    """The encoder's input for request ``rid`` of an encoder-decoder: ``n``
    frame embeddings ``(1, n, d_model)`` in f32 on ``device``, drawn from a
    ``torch.Generator`` seeded by ``rid`` (the audio frontend is a stub;
    ``repro``'s server draws ``jax.random.normal(PRNGKey(rid), ...)``).
    May return a numpy array instead, which the server moves to the
    device."""
    g = torch.Generator(device=device).manual_seed(int(rid))
    return torch.randn((1, n, d_model), generator=g, dtype=torch.float32,
                       device=device)


def _align4(n: int) -> int:
    return -(-int(n) // 4) * 4


def decode_state_graph(model, bsz: int, smax: int) -> tuple[Graph, int]:
    """The serve-schedule dataflow graph for one request's decode step.

    Nodes 0..C-1 are the persistent KV-cache buffers (graph outputs: state
    that survives between steps); above them the per-step transient chain
    -- embedding activation, per-layer attention + MLP activations, logits,
    sampled token -- each consumed by the next, so the arena planner can
    time-share their bytes.  Returns ``(graph, n_cache_leaves)``; cache
    node ids equal the (``jax.tree``-ordered) leaf order of
    ``make_cache_defs``, which is what ``pack_decode_state`` relies on.
    """
    leaves = tree_leaves(model.make_cache_defs(bsz, smax), is_leaf=is_def)
    specs = []
    for i, d in enumerate(leaves):
        nbytes = _align4(int(np.prod(d.shape)) * d.dtype.itemsize)
        specs.append(dict(name=f"cache{i}", op="cache", size_bytes=nbytes,
                          preds=[]))
    cfg = model.cfg
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    prev = None

    def chain(name, op, nbytes):
        nonlocal prev
        specs.append(dict(name=name, op=op, size_bytes=_align4(nbytes),
                          preds=[] if prev is None else [prev]))
        prev = len(specs) - 1

    chain("embed_out", "act", bsz * D * 4)
    for li in range(cfg.n_layers):
        chain(f"l{li}.attn", "act", bsz * D * 4)
        chain(f"l{li}.mlp", "act", bsz * F * 4)
        chain(f"l{li}.out", "act", bsz * D * 4)
    chain("logits", "act", bsz * V * 4)
    chain("token", "act", bsz * 4)
    return Graph.build(specs, name="decode_state"), len(leaves)


def plan_decode_arena(model, bsz: int, smax: int) -> dict:
    """Arena-plan one request's decode state with the SERENITY allocator.

    The KV caches are pinned resident at the bottom of the arena (they
    persist between steps, so their bytes can never be time-shared) and the
    per-step transients are planned above them
    (:func:`~repro_torch.core.allocator.plan_arena_regions`).  The plan is
    memoized in the port's content-addressed plan cache.
    """
    g, n_cache = decode_state_graph(model, bsz, smax)
    pc = default_cache()
    cache_opts = ("serve.plan_decode_arena", 3)   # 3: PlanConfig-planned
    out = pc.get(g, cache_opts)
    if out is None:
        # resident: the KV caches and the sampled token -- everything the
        # request carries between steps (the token node also keeps the
        # logits buffer transient: it is the logits' consumer).  The Kahn
        # scheduler is deliberate: decode state is dozens of *isolated*
        # persistent buffers, which the exact DP models as an exponential
        # bitmask space with nothing to gain over the greedy order.
        cfg = PlanConfig(
            rewrite=False, inplace=False, scheduler="kahn",
            resident=(*range(n_cache), len(g) - 1),
            compute_baselines=False)
        res = plan(g, cfg, cache=pc)
        apl = res.arena
        naive = sum(g.sizes)
        pers, extent = resident_bytes(apl)
        out = {"arena_bytes": apl.arena_bytes, "naive_bytes": naive,
               "peak_bytes": apl.peak_bytes, "policy": apl.policy,
               "frag_ratio": apl.frag_ratio,
               "persistent_bytes": pers, "resident_extent": extent,
               "transient_bytes": apl.arena_bytes - extent,
               "n_buffers": len(g), "n_cache": n_cache, "plan": apl,
               "graph": g, "order": res.order}
        pc.put(g, cache_opts, out)
    return out


def pack_decode_state(plan: dict, cache, arena=None):
    """Pack a decode-state tree into (the resident region of) an arena.

    The cache leaves land at their planned byte offsets through the u8
    arena-write kernel; the uint8 buffer covers the plan's resident extent
    (the transient region above it exists only during a step and is never
    materialized per request).  Pass ``arena`` to reuse a leased buffer,
    which is written in place; otherwise one is allocated on the leaves'
    device.
    """
    leaves = tree_leaves(cache)
    if arena is None:
        arena = torch.zeros(plan["resident_extent"], dtype=torch.uint8,
                            device=leaves[0].device)
    return pack_buffers(plan["plan"], dict(enumerate(leaves)), arena=arena,
                        device=arena.device)


def unpack_decode_state(plan: dict, arena, defs_like, *, out=None):
    """Rebuild the decode-state tree from its planned arena offsets (read
    by the u8 arena-read kernel): fresh tensors on the arena's device, or,
    with ``out`` (a tree of contiguous tensors of the same leaves, such as
    a captured step's static cache), into those, in place.  ``defs_like``
    is any tree of leaves with ``shape`` and ``dtype`` (``ParamDef``s or
    tensors)."""
    leaves, treedef = tree_flatten(defs_like, is_leaf=is_def)
    outs = [None] * len(leaves) if out is None else tree_leaves(out)
    apl = plan["plan"]
    rebuilt = [unpack_buffer(arena, apl, i, leaf.shape, leaf.dtype, out=o)
               for i, (leaf, o) in enumerate(zip(leaves, outs))]
    return tree_unflatten(treedef, rebuilt)


def realize_decode_state(plan: dict, cache):
    """Initialize the decode state through the planned arena.

    Packs the initial cache leaves into one uint8 arena buffer at their
    planned byte offsets and rebuilds the cache tree from slices of it, so
    the state the decode loop starts from is materialized at the plan's
    offsets.  Returns (arena, rebuilt_cache).
    """
    arena = pack_decode_state(plan, cache)
    return arena, unpack_decode_state(plan, arena, cache)


# ---------------------------------------------------------------------------
# Request-queue server with continuous batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Request:
    """One generation request moving through submit -> admit -> decode."""

    rid: int
    prompt: np.ndarray               # (P,) int32 token ids
    max_new: int
    klass: str | None = None         # Pareto request class (REQUEST_CLASSES;
                                     # None = classless base-plan admission)
    priority: int = 0                # higher = preempted later
    tenant: str | None = None        # quota bucket (ArenaPool.tenant_quotas)
    submit_s: float = 0.0
    admit_s: float = 0.0
    done_s: float = 0.0
    tokens: list = dataclasses.field(default_factory=list)
    rejected: bool = False
    reject_code: str = ""            # machine-readable cause (Ticket.reason_code)
    reject_reason: str = ""
    preemptions: int = 0             # times this request was spilled
    # runtime state while admitted
    lease: object = None
    arena: object = None             # leased uint8 buffer holding the KV state
    spill: object = None             # SpilledLease while preempted
    t: int = 0                       # decode position (cache_len)
    last_tok: int = 0

    @property
    def latency_s(self) -> float:
        return self.done_s - self.submit_s


@dataclasses.dataclass
class TickWatchdog:
    """Per-tick deadline + stall escalation for the serving loop.

    Two concerns (DESIGN.md §13): a *deadline* -- ticks slower than
    ``step_deadline_s`` are counted (``deadline_misses``) -- and a *stall* --
    ``stall_ticks`` consecutive ticks with no observable progress (no
    token, no admission, no release, no queue movement) escalate instead
    of silently spinning: :meth:`observe` returns ``True`` and the server
    raises :class:`ServingStallError` carrying the structured queue
    diagnostics.
    """

    step_deadline_s: float | None = None
    stall_ticks: int = 64            # > the max readmit backoff (2^5 ticks)
    ticks: int = 0
    deadline_misses: int = 0
    slowest_tick_s: float = 0.0
    stagnant_ticks: int = 0          # consecutive no-progress ticks
    escalations: int = 0

    def observe(self, dt: float, progressed: bool) -> bool:
        """Record one tick; True when stall escalation is due."""
        self.ticks += 1
        self.slowest_tick_s = max(self.slowest_tick_s, dt)
        if self.step_deadline_s is not None and dt > self.step_deadline_s:
            self.deadline_misses += 1
        self.stagnant_ticks = 0 if progressed else self.stagnant_ticks + 1
        if self.stagnant_ticks >= self.stall_ticks:
            self.escalations += 1
            self.stagnant_ticks = 0
            return True
        return False

    def as_dict(self) -> dict:
        return {"ticks": self.ticks,
                "deadline_misses": self.deadline_misses,
                "slowest_tick_s": self.slowest_tick_s,
                "escalations": self.escalations}


class ServingStallError(RuntimeError):
    """The decode loop provably cannot make progress.

    ``report`` is the structured diagnostics dict: every queued request's
    rid/class/priority/tenant and its per-request ``_fits`` failure
    reason, plus the pool's reserved/budget bytes at escalation time.
    """

    def __init__(self, message: str, report: dict):
        super().__init__(message)
        self.report = report


class DecodeServer:
    """Continuous-batching decode server over a budgeted arena pool.

    Each :meth:`step` (one scheduler tick):

      1. admits queued requests the pool now has bytes for (prefill fills
         their KV cache, which is packed into the leased arena),
      2. advances every admitted request by one decode token -- the *batch*
         is the admitted set, re-formed every tick as requests finish,
      3. releases finished requests' leases (their warm buffers go to the
         pool LRU; the freed bytes admit the queue head).

    Between ticks every request's KV state lives packed in its leased
    arena buffer at the planned byte offsets.

    Robustness layer (DESIGN.md §13), as in ``repro``: a mid-run
    :meth:`set_budget` shrink (or an injected admission fault) triggers the
    graceful-degradation ladder -- (1) re-plan a ``latency``-class request
    at its memory-optimal Pareto point, (2) pin vmap batch buckets to the
    exact batch and drop the padding scratch (taken and counted in serial
    mode too, as in ``repro``), (3) preempt the lowest-priority lease
    (spill its packed KV state to host, re-admit later with bounded retry
    + exponential backoff).  A :class:`TickWatchdog` escalates stalls with structured
    queue diagnostics, and a ``chaos=``
    :class:`~repro_torch.runtime.chaos.ChaosController` drives
    deterministic fault injection through the hooks.

    ``params`` must live on ``device`` (``None``: the card).
    """

    def __init__(self, model, params, pool: ArenaPool, *, smax: int,
                 rules=None, step_mode: str = "serial",
                 chaos: ChaosController | None = None,
                 step_deadline_s: float | None = None,
                 stall_ticks: int = 64,
                 max_readmit_attempts: int = 5,
                 max_transient_retries: int = 3,
                 device=None):
        if step_mode not in ("serial", "vmap"):
            raise ValueError(f"unknown step_mode {step_mode!r}")
        if step_mode == "vmap" and pool.overlap == "serial":
            raise ValueError(
                "step_mode='vmap' materializes every active request's "
                "transients at once; the pool must use overlap='none' "
                "admission accounting")
        self.device = resolve_device(device)
        leaf = tree_leaves(params)[0]
        if leaf.device != self.device:
            raise ValueError(f"params live on {leaf.device}, the server "
                             f"runs on {self.device}")
        self.model = model
        self.params = params
        self.pool = pool
        self.smax = smax
        self.step_mode = step_mode
        self.rules = rules
        self._prefill = make_prefill_step(model, rules)
        self._decode = make_decode_step(model, rules)
        # serial mode on the card decodes through one captured step (its
        # static state at (1, smax)); the CPU has no CUDA graph and decodes
        # eagerly, as does every step under sharding rules
        self._captured = None \
            if self.device.type != "cuda" or step_mode != "serial" \
            or rules is not None else \
            make_captured_decode_step(model, params, smax=smax, rules=rules,
                                      device=self.device)
        # vmap mode: the batched step of the bucket in use (captured on
        # the card, eager on the CPU), built at the bucket's first step and
        # dropped when another bucket is built, so that one bucket's static
        # cache and graph pool stay resident, not every bucket's
        self._batched: BatchedDecodeStep | None = None
        # a contiguous batch-1 state for the rows' copies in and out of the
        # batched cache, and each leaf's batch axis there
        self._stage = None
        self._batch_axes = batch_axes(model, smax)
        self._plan = plan_decode_arena(model, 1, smax)
        # register our regions plan with the pool once; submits reuse the
        # key (no per-request graph re-fingerprinting)
        self._key, _ = pool.plan(self._plan["graph"], self._plan["order"],
                                 plan=self._plan["plan"])
        # the decode state's Pareto request classes (DESIGN.md §12): both
        # keep the regions layout (identical offsets, so pack/unpack and
        # the steps are class-agnostic) but charge admission differently
        # -- 'latency' pins its transients always-live
        pool.register_pareto(self._key, {
            "memory": self._plan["plan"],
            "latency": pin_transients(self._plan["plan"]),
        })
        self._tickets: dict[int, Request] = {}
        self.active: list[Request] = []
        self.done: list[Request] = []
        # robustness state (DESIGN.md §13)
        self.chaos = chaos
        if chaos is not None:
            if pool.admission_hook is not None:
                raise ValueError(
                    "chaos= takes ownership of pool.admission_hook, but "
                    "the pool already has one installed; construct the "
                    "pool without admission_hook= or inject admission "
                    "faults through the chaos FaultPlan instead")
            pool.admission_hook = chaos.admission_should_fail
        self.max_readmit_attempts = max_readmit_attempts
        self.max_transient_retries = max_transient_retries
        self.watchdog = TickWatchdog(step_deadline_s=step_deadline_s,
                                     stall_ticks=stall_ticks)
        self._tick = 0
        self._spilled: list[Request] = []       # preempted, awaiting readmit
        self._exact_buckets = False             # ladder rung 2 latch
        self._scratch_token = None              # vmap padding reservation
        self.ladder = {"replan": 0, "shrink_buckets": 0, "preempt": 0}
        self.transient_errors = 0
        self._transient_streak = 0
        self._last_tick_s = 0.0
        self.min_budget_bytes = pool.budget_bytes
        self.max_over_budget_bytes = 0
        self.last_stall: dict | None = None

    # -- admission ---------------------------------------------------------

    def warm(self, n_buffers: int = 1) -> None:
        """Startup warming: pre-plan + pre-allocate arenas for this shape."""
        for _ in range(n_buffers):
            self.pool.warm(self._plan["graph"], key=self._key)

    def submit(self, req: Request) -> None:
        req.submit_s = time.perf_counter()
        # the pool holds *our* regions plan under self._key, so lease
        # buffers, admission accounting and the state pack/unpack all
        # address one set of offsets; a classed request leases its
        # registered Pareto-point plan instead (same offsets, different
        # admission charge)
        ticket = self.pool.submit(self._plan["graph"], key=self._key,
                                  klass=req.klass, priority=req.priority,
                                  tenant=req.tenant)
        if ticket.rejected:
            self._finish_rejected(req, ticket)
            return
        self._tickets[ticket.rid] = req

    def _finish_rejected(self, req: Request, ticket) -> None:
        req.rejected = True
        req.reject_code = ticket.reason_code
        req.reject_reason = ticket.reason
        req.done_s = time.perf_counter()
        req.spill = None
        self.done.append(req)

    def _collect_rejected(self) -> None:
        """Retire queued requests a budget-shrink sweep rejected."""
        for ticket in self.pool.poll_rejected():
            req = self._tickets.pop(ticket.rid, None)
            if req is not None:
                self._finish_rejected(req, ticket)

    def _start(self, ticket) -> None:
        req = self._tickets.pop(ticket.rid)
        req.admit_s = time.perf_counter()
        req.lease = ticket.lease
        if req.spill is not None:
            # re-admission of a preempted request: its packed KV state is
            # self-contained (plan offsets are buffer-relative), so the
            # restore is one host->device byte copy -- no re-prefill, and
            # req.t / tokens continue exactly where the spill left off
            sp, req.spill = req.spill, None
            ticket.lease.buffer = None
            req.arena = torch.from_numpy(np.asarray(sp.host_state)).to(
                self.device)
            req.klass = sp.klass or req.klass   # a downgrade sticks
            self.active.append(req)
            return
        P = len(req.prompt)
        cache = self._placed(self.model.init_cache(1, self.smax,
                                                   self.device))
        batch = {"tokens": torch.as_tensor(
            np.asarray(req.prompt), dtype=torch.long,
            device=self.device)[None]}
        if self.model.cfg.is_encoder_decoder:
            batch["frames"] = torch.as_tensor(
                encoder_frames(req.rid, P, self.model.cfg.d_model,
                               self.device),
                dtype=torch.float32, device=self.device)
        logits, cache = self._prefill(self.params, cache, batch)
        req.last_tok = int(torch.argmax(full(logits), -1)[0])
        req.tokens.append(req.last_tok)
        req.t = P
        req.arena = pack_decode_state(self._plan, cache,
                                      arena=ticket.lease.buffer)
        ticket.lease.buffer = None    # ownership moved to the request
        self.active.append(req)

    # -- degradation ladder (DESIGN.md §13) ---------------------------------

    def set_budget(self, nbytes: int) -> None:
        """Shrink/grow the pool budget mid-run and enforce it.

        A shrink that leaves the admitted set over budget walks the
        degradation ladder (:meth:`_degrade_once`) until the members fit
        again -- the pool itself never evicts, so this is where preemption
        happens.
        """
        over = self.pool.set_budget(nbytes)
        self.min_budget_bytes = min(self.min_budget_bytes,
                                    self.pool.budget_bytes)
        while over > 0:
            if not self._degrade_once():
                break                 # nothing left to shed (no members)
            over = self.pool.reserved_bytes - self.pool.budget_bytes

    def _preempt_request(self, req: Request,
                         downgrade_to: str | None = None) -> None:
        """Spill an active request's lease; it rejoins via readmit."""
        sp = self.pool.preempt(req.lease, state=req.arena)
        req.lease = None
        req.arena = None
        req.preemptions += 1
        if downgrade_to is not None and sp.klass != downgrade_to:
            self.pool.downgrade(sp, downgrade_to)
            req.klass = downgrade_to
        sp.next_tick = self._tick + 1   # first readmit try next tick
        req.spill = sp
        self.active.remove(req)
        self._spilled.append(req)

    def _degrade_once(self) -> bool:
        """One ladder rung; True when it took one.

        Rung 1: re-plan a ``latency``-class request at its memory-optimal
        Pareto point (preempt + downgrade + readmit -- the classes share
        offsets, so only the admission charge changes).  Rung 2: pin vmap
        decode to exact-size batch buckets and drop the server's padding
        scratch.  Rung 3: preempt the lowest-priority lease outright.
        """
        # admitted-but-unpolled tickets (an external set_budget between
        # poll and _start) hold leases none of the rungs below can see:
        # absorb them into the active set first so their bytes are
        # sheddable rather than silently left over budget
        for ticket in self.pool.poll():
            self._start(ticket)
        lat = [r for r in self.active if r.klass == "latency"
               and r.lease is not None]
        if lat and "memory" in self.pool.pareto_classes(self._key):
            victim = min(lat, key=lambda r: (r.priority, -r.rid))
            self._preempt_request(victim, downgrade_to="memory")
            self.ladder["replan"] += 1
            return True
        if not self._exact_buckets:
            self._exact_buckets = True
            self.ladder["shrink_buckets"] += 1
            # drop the server's own padding-scratch reservation (token-
            # scoped: other reservers' scratch is theirs to release)
            token, self._scratch_token = self._scratch_token, None
            if token is not None:
                token.release()
            return True
        owned = [r for r in self.active if r.lease is not None]
        if not owned:
            return False
        # same ordering as ArenaPool.preempt_candidate: lowest priority
        # first, youngest lease among ties
        victim = min(owned, key=lambda r: (r.priority, -r.lease.rid))
        self._preempt_request(victim)
        self.ladder["preempt"] += 1
        return True

    def _retry_spilled(self) -> None:
        """Drive due re-admissions: bounded retry, exponential backoff."""
        still = []
        for req in self._spilled:
            sp = req.spill
            if not sp.due(self._tick):
                still.append(req)
                continue
            ticket = self.pool.readmit(sp)
            if ticket.rejected:
                self._finish_rejected(req, ticket)
            elif ticket.admitted:
                self._tickets[ticket.rid] = req   # restored by _start
            else:
                sp.backoff(self._tick)
                if sp.attempts >= self.max_readmit_attempts:
                    ticket.reason_code = "readmit_exhausted"
                    ticket.reason = (
                        f"re-admission failed after {sp.attempts} attempts "
                        f"(pool reserved {self.pool.reserved_bytes} of "
                        f"{self.pool.budget_bytes} budget bytes)")
                    ticket.rejected = True
                    self._finish_rejected(req, ticket)
                else:
                    still.append(req)
        self._spilled = still

    # -- decode ------------------------------------------------------------

    def _cache_defs(self):
        return self.model.make_cache_defs(1, self.smax)

    def _placed(self, cache):
        """A batch-1 state for a step: on the mesh under rules."""
        return place_state(cache, self._cache_defs(), self.rules)

    def _step_serial(self) -> None:
        step = self._captured
        for req in self.active:
            if step is None:
                cache = self._placed(unpack_decode_state(
                    self._plan, req.arena, self._cache_defs()))
                tok = torch.full((1, 1), req.last_tok, dtype=torch.long,
                                 device=self.device)
                logits, cache = self._decode(self.params, cache, tok, req.t)
            else:
                cache = unpack_decode_state(self._plan, req.arena,
                                            step.cache, out=step.cache)
                logits = step(req.last_tok, req.t)
            req.last_tok = int(torch.argmax(full(logits), -1)[0])
            req.tokens.append(req.last_tok)
            req.t += 1
            req.arena = pack_decode_state(self._plan, cache, arena=req.arena)

    @staticmethod
    def _bucket(n: int) -> int:
        """Next power-of-two batch bucket (bounds the captured steps to
        log2 of the largest batch)."""
        return 1 << max(0, n - 1).bit_length()

    def _batched_step(self, bucket: int) -> BatchedDecodeStep:
        """This bucket's batched step: captured on the card, eager on the
        CPU.  A new bucket frees the previous bucket's step (its static
        ``(bucket, smax)`` cache and, on the card, its graph pool) before
        it is built; a return to that bucket captures again."""
        step = self._batched
        if step is None or step.bucket != bucket:
            self._batched = step = None
            make = CapturedBatchedDecodeStep \
                if self.device.type == "cuda" and self.rules is None \
                else BatchedDecodeStep
            step = self._batched = make(
                self.model, self.params, bucket=bucket, smax=self.smax,
                rules=self.rules, device=self.device)
        return step

    def _rows_in(self, cache, pad: int) -> None:
        """Unpack every active request's state (u8 arena reads) into the
        staging state and copy it into its row of the batched ``cache``;
        row 0's also into the ``pad`` padding rows after the live ones."""
        if self._stage is None:
            self._stage = self.model.init_cache(1, self.smax, self.device)
        B = len(self.active)
        stage = tree_leaves(self._stage)
        for i, req in enumerate(self.active):
            unpack_decode_state(self._plan, req.arena, self._stage,
                                out=self._stage)
            for ax, rows, one in zip(self._batch_axes, tree_leaves(cache),
                                     stage):
                rows.narrow(ax, i, 1).copy_(one)
                if i == 0 and pad:
                    dst = rows.narrow(ax, B, pad)
                    dst.copy_(one.expand(dst.shape))

    def _rows_out(self, cache) -> None:
        """Copy every live row of the batched ``cache`` into the staging
        state and pack it into its request's arena (u8 arena writes)."""
        stage = tree_leaves(self._stage)
        for i, req in enumerate(self.active):
            for ax, rows, one in zip(self._batch_axes, tree_leaves(cache),
                                     stage):
                one.copy_(rows.narrow(ax, i, 1).view(one.shape))
            req.arena = pack_decode_state(self._plan, self._stage,
                                          arena=req.arena)

    def _step_vmap(self) -> None:
        B = len(self.active)
        # ladder rung 2: exact-size buckets trade extra captures for zero
        # padding rows (no scratch charged against the shrunk budget)
        bucket = B if self._exact_buckets else self._bucket(B)
        pad = bucket - B
        if pad:
            # padding rows materialize real state + transients beyond the
            # admitted set: charge them to the pool budget for the duration
            # of the step (a handle-based reservation released in the
            # finally below), or shrink the bucket to the exact batch
            try:
                self._scratch_token = self.pool.reserve_scratch(
                    pad * self._plan["arena_bytes"])
            except PoolError:
                bucket, pad = B, 0
        try:
            step = self._batched_step(bucket)
            self._rows_in(step.cache, pad)
            r0 = self.active[0]
            toks = [r.last_tok for r in self.active] + [r0.last_tok] * pad
            ts = [r.t for r in self.active] + [r0.t] * pad
            next_toks = step(toks, ts)[1]
            self._rows_out(step.cache)
            # one device-to-host read for the whole batch
            next_toks = next_toks.tolist()[:B]
            for req, tok in zip(self.active, next_toks):
                req.last_tok = int(tok)
                req.tokens.append(req.last_tok)
                req.t += 1
        finally:
            token, self._scratch_token = self._scratch_token, None
            if token is not None:
                token.release()

    def step(self) -> int:
        """One scheduler tick; returns the number of active requests.

        Tick order: arm this tick's chaos faults, admit (poll + start),
        apply injected budget shrinks (which may walk the ladder), retry
        spilled re-admissions, then decode -- guarded by the transient-
        error bounded retry -- and finally retire finished requests and
        record the budget-invariant trace.
        """
        self._tick += 1
        t_tick = time.perf_counter()
        shrinks = ()
        if self.chaos is not None:
            shrinks = self.chaos.begin_tick(self._tick)
        self.pool.kick()              # retry after transient faults
        self._collect_rejected()
        for ticket in self.pool.poll():
            self._start(ticket)
        for spec in shrinks:
            if spec.kind == "budget_shrink":
                self.set_budget(max(1, int(self.pool.budget_bytes
                                           * spec.factor)))
        self._collect_rejected()
        self._retry_spilled()
        for ticket in self.pool.poll():
            self._start(ticket)
        if self.active:
            try:
                if self.chaos is not None:
                    self.chaos.maybe_executor_error()
                if self.step_mode == "serial":
                    self._step_serial()
                else:
                    self._step_vmap()
                self._transient_streak = 0
            except TransientExecutorError:
                # request state untouched: skip the decode phase this tick
                # and retry next tick, up to the bounded retry limit
                self.transient_errors += 1
                self._transient_streak += 1
                if self._transient_streak > self.max_transient_retries:
                    raise
        still = []
        for req in self.active:
            if len(req.tokens) >= req.max_new:
                req.done_s = time.perf_counter()
                req.lease.buffer = req.arena   # warm buffer back to the pool
                req.arena = None
                self.pool.release(req.lease)
                self.done.append(req)
            else:
                still.append(req)
        self.active = still
        # budget-invariant trace: realized arena bytes vs the instantaneous
        # (possibly shrunk) budget -- the chaos suite asserts this never
        # goes positive once the ladder has run
        self.max_over_budget_bytes = max(
            self.max_over_budget_bytes,
            self.pool.reserved_bytes - self.pool.budget_bytes)
        self._last_tick_s = time.perf_counter() - t_tick
        return len(self.active)

    # -- stall diagnostics (DESIGN.md §13) ----------------------------------

    def _progress_sig(self) -> tuple:
        """Observable state; two equal signatures = a tick did nothing.

        Spill backoff state is part of the signature: a failed readmit
        attempt re-arms the backoff (``attempts``/``next_tick`` move), and
        that is observable work even when nothing else changed.
        """
        return (len(self.done),
                sum(len(r.tokens) for r in self.active),
                len(self.active), len(self._spilled), len(self._tickets),
                self.pool.queue_len, self.pool.stats.admitted,
                self.pool.budget_bytes,
                tuple(sorted((r.rid, r.spill.attempts, r.spill.next_tick)
                             for r in self._spilled)))

    def _backoff_pending(self) -> bool:
        """True while a spilled re-admission is waiting out its exponential
        backoff window -- that wait is scheduled future work, not
        stagnation, so it must not count toward watchdog escalation."""
        return any(r.spill is not None and r.spill.next_tick > self._tick
                   for r in self._spilled)

    def _stall_report(self) -> dict:
        """Structured queue diagnostics: every waiting request's identity
        and its current ``_fits`` failure reason."""
        return {
            "tick": self._tick,
            "queued": self.pool.queue_report(),
            "waiting_rids": sorted(self._tickets),
            "spilled": [{"rid": r.rid, "attempts": r.spill.attempts,
                         "next_tick": r.spill.next_tick,
                         "klass": r.spill.klass}
                        for r in self._spilled],
            "reserved_bytes": self.pool.reserved_bytes,
            "budget_bytes": self.pool.budget_bytes,
            "scratch_bytes": self.pool.scratch_bytes,
            "watchdog": self.watchdog.as_dict(),
        }

    def _raise_stall(self) -> None:
        report = self._stall_report()
        self.last_stall = report
        queued = ", ".join(
            f"rid={q['rid']} klass={q['klass']} prio={q['priority']} "
            f"({q['why']})" for q in report["queued"]) or "none"
        raise ServingStallError(
            f"serving stalled at tick {report['tick']}: "
            f"{len(report['waiting_rids'])} request(s) waiting, "
            f"{len(report['spilled'])} spilled, none active; pool reserved "
            f"{report['reserved_bytes']} of {report['budget_bytes']} budget "
            f"bytes; queued: [{queued}]", report)

    def run(self, requests: Sequence[Request], *,
            max_steps: int = 100_000) -> dict:
        """Drive all ``requests`` to completion; returns serving metrics."""
        t0 = time.perf_counter()
        for r in requests:
            self.submit(r)
        steps = 0
        while (self.active or self._tickets or self._spilled) \
                and steps < max_steps:
            sig = self._progress_sig()
            self.step()
            steps += 1
            progressed = self._progress_sig() != sig \
                or self._backoff_pending()
            if self.watchdog.observe(self._last_tick_s, progressed):
                self._raise_stall()
            if not progressed and not self.active and self._tickets \
                    and not self._spilled and not self.pool.leases \
                    and not self.pool.pending_admissions \
                    and self.chaos is None:
                # nothing active, nothing held, pending or spilled, no
                # fault injection that could explain it, and the queue did
                # not move: it can never drain (an admission bug) -- fail
                # loudly now instead of waiting out the watchdog
                self._raise_stall()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        served = [r for r in self.done if not r.rejected]
        lat = sorted(r.latency_s for r in served)
        if lat:
            p50_ms = 1e3 * float(np.percentile(lat, 50))
            p99_ms = 1e3 * float(np.percentile(lat, 99))
        else:
            # an all-rejected run has no latencies: report NaN, never a
            # vacuous 0.0 that would pass any latency SLO silently
            p50_ms = p99_ms = float("nan")
        n_tok = sum(len(r.tokens) for r in served)
        st = self.pool.stats
        ps = self.pool.preemption_stats
        reject_codes: dict[str, int] = {}
        for r in self.done:
            if r.rejected:
                code = r.reject_code or "submit"
                reject_codes[code] = reject_codes.get(code, 0) + 1
        return {
            "n_requests": len(requests),
            "n_served": len(served),
            "n_rejected": sum(r.rejected for r in self.done),
            "n_tokens": n_tok,
            "wall_s": wall,
            "tok_per_s": n_tok / max(wall, 1e-9),
            "p50_ms": p50_ms,
            "p99_ms": p99_ms,
            "steps": steps,
            "max_concurrent": st.max_concurrent,
            "peak_reserved_bytes": st.peak_reserved_bytes,
            "budget_bytes": self.pool.budget_bytes,
            "warm_hits": st.warm_hits,
            "plan_hits": st.plan_hits,
            "arena_bytes": self._plan["arena_bytes"],
            "persistent_bytes": self._plan["persistent_bytes"],
            "transient_bytes": self._plan["transient_bytes"],
            "admitted_by_class": dict(st.admitted_by_class),
            # robustness block (DESIGN.md §13)
            "reject_codes": reject_codes,
            "n_preempted": ps.preemptions,
            "spill_bytes": ps.spilled_bytes,
            "n_readmitted": ps.readmitted,
            "readmit_attempts": ps.readmit_attempts,
            "admission_faults": ps.admission_faults,
            "budget_shrinks": ps.budget_shrinks,
            "min_budget_bytes": self.min_budget_bytes,
            "max_over_budget_bytes": self.max_over_budget_bytes,
            "transient_errors": self.transient_errors,
            "ladder": dict(self.ladder),
            "watchdog": self.watchdog.as_dict(),
            "stall": self.last_stall,
        }


def make_pool(budget_bytes: int, *, step_mode: str = "serial",
              pooled: bool = True, max_warm: int = 4,
              tenant_quotas: dict[str, int] | None = None,
              device=None) -> ArenaPool:
    """Pool whose admission accounting matches the server's step mode and
    whose lease buffers are uint8 tensors on ``device`` (``None``: the
    card).  ``pooled=False`` is the naive one-arena-per-request admission
    baseline; it and ``step_mode='vmap'`` give ``overlap='none'``."""
    dev = resolve_device(device)
    return ArenaPool(
        budget_bytes,
        overlap="serial" if (pooled and step_mode == "serial") else "none",
        max_warm=max_warm,
        alloc_fn=lambda n: torch.zeros(n, dtype=torch.uint8, device=dev),
        tenant_quotas=tenant_quotas,
    )


def run_server(model, params, requests, *, smax: int, budget_bytes: int,
               step_mode: str = "serial", pooled: bool = True,
               rules=None, warm: int = 0,
               chaos: ChaosController | None = None,
               tenant_quotas: dict[str, int] | None = None,
               device=None, **server_kwargs) -> dict:
    """Build a pool + server on ``device`` (``None``: the card), serve
    ``requests``, return metrics."""
    pool = make_pool(budget_bytes, step_mode=step_mode, pooled=pooled,
                     tenant_quotas=tenant_quotas, device=device)
    server = DecodeServer(model, params, pool, smax=smax, rules=rules,
                          step_mode=step_mode, chaos=chaos, device=device,
                          **server_kwargs)
    if warm:
        server.warm(warm)
    return server.run(requests)


def synth_requests(n: int, prompt_len: int, gen: int, vocab: int,
                   seed: int = 0,
                   latency_frac: float = 0.0,
                   priorities: Sequence[int] | None = None,
                   tenants: Sequence[str] | None = None) -> list[Request]:
    """Synthesize ``n`` requests; ``latency_frac`` > 0 tags that fraction
    as the ``latency`` Pareto class and the rest ``memory`` (0.0 keeps
    every request classless -- base-plan admission).  ``priorities`` /
    ``tenants`` are cycled over the requests when given.  The same seed
    gives ``repro``'s requests.
    """
    if not 0.0 <= latency_frac <= 1.0:
        raise ValueError(f"latency_frac must be in [0, 1], got {latency_frac}")
    rng = np.random.default_rng(seed)
    n_lat = round(n * latency_frac)
    reqs = []
    for i in range(n):
        klass = None if latency_frac == 0.0 else \
            ("latency" if i < n_lat else "memory")
        reqs.append(Request(
            rid=i,
            prompt=rng.integers(0, vocab, prompt_len).astype(np.int32),
            max_new=gen, klass=klass,
            priority=priorities[i % len(priorities)] if priorities else 0,
            tenant=tenants[i % len(tenants)] if tenants else None))
    return reqs


# ---------------------------------------------------------------------------
# Sharded fleet top layer (DESIGN.md §14)
# ---------------------------------------------------------------------------


def fleet_planner_for_model(model, buckets: Sequence[int]) \
        -> tuple[PlannerService, dict]:
    """A :class:`PlannerService` loaded with this model's real decode
    plans, one per sequence bucket.

    Each bucket's regions-layout decode plan (KV caches pinned resident,
    transients above -- :func:`plan_decode_arena`) is registered together
    with its two Pareto class plans, all backed by the shared
    content-addressed plan cache -- so fleet workers lease exactly the
    plans the single-device server serves, fetched by fingerprint, never
    planned locally.  Returns ``(planner, {bucket: PlanRecord})``.
    """
    planner = PlannerService(cache=default_cache())
    records = {}
    for b in sorted(set(int(b) for b in buckets)):
        d = plan_decode_arena(model, 1, b)
        records[b] = planner.register(
            d["graph"], plan=d["plan"],
            classes={"memory": d["plan"],
                     "latency": pin_transients(d["plan"])})
    return planner, records


def run_fleet(model, arrivals, *, buckets: Sequence[int],
              n_decode: int = 4, n_prefill: int = 1,
              shard_budget_bytes: int | None = None,
              prefill_budget_bytes: int | None = None,
              max_batch: int = 8, prefill_chunk: int = 32,
              tenant_quotas: dict[str, int] | None = None,
              fault_plans: dict | None = None,
              max_ticks: int | None = None) -> dict:
    """Serve an open-loop workload on a sharded fleet of this model's
    decode plans (simulated device workers -- scheduling fidelity, not
    kernels; see ``runtime/fleet.py``).

    ``shard_budget_bytes`` defaults to ``max_batch`` times the largest
    non-oversize bucket's arena -- each decode shard can hold a full
    batch of the biggest routable request.
    """
    planner, records = fleet_planner_for_model(model, buckets)
    if shard_budget_bytes is None:
        fitted = sorted(records)[:-1] or sorted(records)
        shard_budget_bytes = max_batch * records[fitted[-1]].alone_bytes
    fleet = Fleet(planner, key_for=bucket_key_for(records),
                  n_decode=n_decode, n_prefill=n_prefill,
                  shard_budget_bytes=shard_budget_bytes,
                  prefill_budget_bytes=prefill_budget_bytes,
                  max_batch=max_batch, prefill_chunk=prefill_chunk,
                  tenant_quotas=tenant_quotas, fault_plans=fault_plans)
    metrics = fleet.run_arrivals(arrivals, max_ticks=max_ticks)
    metrics["shard_budget_bytes"] = shard_budget_bytes
    metrics["buckets"] = sorted(records)
    return metrics


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=configs.ARCH_NAMES)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--budget-mb", type=float, default=0.0,
                    help="global arena budget; 0 = 4x one request's arena")
    ap.add_argument("--step-mode", choices=("serial", "vmap"),
                    default="serial")
    ap.add_argument("--no-pool", action="store_true",
                    help="naive one-arena-per-request admission baseline")
    ap.add_argument("--warm", type=int, default=2,
                    help="arenas to pre-plan/pre-allocate at startup")
    ap.add_argument("--latency-frac", type=float, default=0.0,
                    help="fraction of requests admitted as the "
                         "latency-sensitive Pareto class (pinned "
                         "transients); the rest memory-starved")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="serve on a sharded fleet of N decode shards "
                         "(simulated workers over the real decode plans) "
                         "instead of the single in-process server")
    ap.add_argument("--prefill-shards", type=int, default=1,
                    help="dedicated prefill-lane shards (fleet mode; 0 "
                         "prefills inline on decode shards)")
    ap.add_argument("--rate", type=float, default=2.0,
                    help="open-loop Poisson arrival rate, requests/tick "
                         "(fleet mode)")
    ap.add_argument("--mesh", choices=("none", "single", "multi"),
                    default="none",
                    help="serve under sharding rules on the production "
                         "mesh (16x16, or 2x16x16 across pods); needs a "
                         "process group of its 256 (512) ranks")
    args = ap.parse_args(argv)

    cfg = configs.smoke(args.arch) if args.smoke else configs.get(args.arch)
    model = build_model(cfg)
    smax = args.prompt_len + args.gen

    plan = plan_decode_arena(model, 1, smax)
    pc_stats = default_cache().stats
    print(f"[serve] decode-state arena/request: "
          f"{plan['arena_bytes']/1e6:.2f} MB "
          f"({plan['persistent_bytes']/1e6:.2f} MB KV state + "
          f"{plan['transient_bytes']/1e6:.2f} MB step transients, "
          f"policy={plan['policy']}, naive sum "
          f"{plan['naive_bytes']/1e6:.2f} MB; plan cache "
          f"hits={pc_stats.hits} misses={pc_stats.misses})")

    budget = int(args.budget_mb * 1e6) if args.budget_mb else \
        4 * plan["arena_bytes"]

    if args.fleet > 0:
        # sharded fleet: open-loop load over per-bucket decode plans;
        # simulated workers exercise routing/admission, not kernels
        gen = OpenLoopLoadGen(
            seed=args.seed, rate=args.rate,
            prompt_mean=args.prompt_len, prompt_max=4 * smax,
            gen_mean=args.gen, gen_max=2 * args.gen, latency_frac=0.25)
        arrivals = gen.arrivals(args.requests)
        print(f"[fleet] workload: {workload_summary(arrivals)}")
        m = run_fleet(model, arrivals,
                      buckets=(smax, 2 * smax, 8 * smax),
                      n_decode=args.fleet, n_prefill=args.prefill_shards)
        print(f"[fleet] {m['n_served']}/{m['n_requests']} served "
              f"({m['n_rejected']} rejected, rate {m['rejection_rate']}), "
              f"{m['tokens']} tokens over {m['ticks']} ticks on "
              f"{args.fleet}+{args.prefill_shards} shards "
              f"({m['tok_per_tick']} tok/tick)")
        print(f"[fleet] latency p50 {m['p50_ticks']} / p99 {m['p99_ticks']} "
              f"ticks; {m['handoffs']} prefill handoffs, "
              f"{m['migrations']} migrations, {m['preemptions']} "
              f"preemptions; shard budget "
              f"{m['shard_budget_bytes']/1e6:.2f} MB")
        return

    dev = resolve_device(args.device)
    mesh = rules = None
    if args.mesh != "none":
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=dev)
        rules = rules_for_mesh(mesh)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, dev)
    if rules is not None:
        params = distribute_params(params, model.defs, rules, mesh)
    reqs = synth_requests(args.requests, args.prompt_len, args.gen,
                          cfg.vocab_size, args.seed + 1,
                          latency_frac=args.latency_frac)
    metrics = run_server(model, params, reqs, smax=smax,
                         budget_bytes=budget, step_mode=args.step_mode,
                         pooled=not args.no_pool, rules=rules,
                         warm=args.warm, device=dev)
    print(f"[serve] {metrics['n_served']}/{metrics['n_requests']} requests "
          f"({metrics['n_rejected']} rejected), {metrics['n_tokens']} tokens "
          f"in {metrics['wall_s']:.2f} s "
          f"({metrics['tok_per_s']:.1f} tok/s) on {dev}")
    print(f"[serve] latency p50 {metrics['p50_ms']:.0f} ms / "
          f"p99 {metrics['p99_ms']:.0f} ms; concurrency "
          f"{metrics['max_concurrent']} under "
          f"{metrics['budget_bytes']/1e6:.2f} MB budget "
          f"(peak reserved {metrics['peak_reserved_bytes']/1e6:.2f} MB; "
          f"warm hits {metrics['warm_hits']})")
    if metrics["admitted_by_class"]:
        by = metrics["admitted_by_class"]
        print("[serve] admitted by Pareto class: "
              + ", ".join(f"{k}={by[k]}" for k in sorted(by)))


if __name__ == "__main__":
    main()
