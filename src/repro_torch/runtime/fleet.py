"""Sharded async serving fleet: planner service, router, worker shards.

DESIGN.md §14.  `DecodeServer` (launch/serve.py) is one device, one
`ArenaPool`, one tick loop.  This module scales the same byte-exact
admission story out to N simulated device workers:

  * :class:`PlannerService` — the fleet's only planner.  It wraps the
    content-addressed :class:`~repro_torch.core.plancache.PlanCache` as the
    shared tier: a graph is planned (or registered pre-built) once,
    keyed by its labeled fingerprint, together with its Pareto class
    plans; every worker fetches :class:`PlanRecord`\\ s by fingerprint and
    **never plans locally** — worker pools are constructed with a planner
    callback that raises, so any local-planning path is a hard error,
    not a silent slow path.
  * :class:`WorkerShard` — one simulated device: its own
    :class:`~repro_torch.runtime.pool.ArenaPool` shard (``overlap='none'``:
    every member's transients are live at once under the vmap-style
    batched step, so naive-sum accounting is the honest charge), a
    per-shard tick loop with a decode lane (up to ``max_batch`` requests
    advance one token per tick) and a chunked prefill lane, plus a
    per-shard :class:`~repro_torch.runtime.chaos.ChaosController` seam.
  * :class:`FleetRouter` — places each request by *planned bytes*:
    among the lane's shards whose budget (and tenant quota) can ever fit
    the request's class plan, pick the least-loaded by projected
    occupancy ``(reserved + queued + charge) / budget``.  A request no
    shard can ever fit is rejected at the router, with the same
    machine-readable reason codes the pool uses.
  * **prefill/decode disaggregation** — prompts at least
    ``prefill_threshold`` tokens long are placed on dedicated prefill
    shards; when prefill completes, the request's resident state is
    spilled to host (:meth:`ArenaPool.preempt`) and re-admitted on a
    decode shard (:meth:`ArenaPool.readmit`) — the *same* host-spill
    round trip preemption uses, so the handoff is bit-exact.  Without a
    prefill lane, prefill runs inline on decode shards and visibly
    stalls decode ticks (``prefill_stall_ticks``) — the cost the lane
    removes.
  * **cross-shard migration** — a lease preempted on one shard (budget
    shrink enforcement) re-enters through the fleet's spill list and may
    be re-admitted on *any* decode shard with bytes free; exponential
    backoff rides on the existing
    :class:`~repro_torch.runtime.pool.SpilledLease` bookkeeping.  A spill that
    keeps losing the fits-now race against the shards' FIFO queues is
    *requeued* instead: re-submitted into the least-loaded shard's queue
    with its host-spilled state riding along, restored verbatim at
    admission.

The device work itself is simulated (the deterministic byte-arithmetic
decode of ``tests/test_chaos.py``'s SimServer, promoted to a fleet-wide
convention): state evolution is a pure function of ``(rid, prompt_len,
resident extent, step)``, so token streams are bit-comparable across
placements, migrations and fault scripts — which is what lets the chaos
invariants (no request lost, every shard within its instantaneous
budget, surviving tokens bit-equal the fault-free twin) be asserted at
fleet scale.  The module exercises scheduling policy, not kernels.

A copy of ``repro.runtime.fleet`` over the port's plan cache, allocator and
pool (numpy only in both): the same records, seeds and arguments give
``repro``'s decisions, token streams and metrics exactly.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time

import numpy as np

from repro_torch.core.allocator import (
    ArenaPlan,
    pin_transients,
    resident_bytes,
)
from repro_torch.core.graph import Graph
from repro_torch.core.plancache import PlanCache, labeled_fingerprint
from repro_torch.core.serenity import PlanConfig, plan as serenity_plan
from repro_torch.runtime.chaos import ChaosController, TransientExecutorError
from repro_torch.runtime.loadgen import Arrival
from repro_torch.runtime.pool import ArenaPool, PoolError, SpilledLease, Ticket

# Fleet plans pack the graph's deterministic topo order as-is (arena
# offsets only) — same convention as the pool's default lease planner.
_PLANNER_CONFIG = PlanConfig(rewrite=False, inplace=False,
                             compute_baselines=False)
# Options tuple keying planner payloads in the shared PlanCache tier.
_CACHE_OPTS = ("fleet.planner", 1)


class FleetStallError(RuntimeError):
    """The fleet stopped making progress (tick guard exceeded); carries a
    structured per-shard report like ServingStallError does."""

    def __init__(self, message: str, report: dict | None = None):
        super().__init__(message)
        self.report = report or {}


def _no_local_planning(graph, order):
    raise PoolError(
        "fleet workers never plan locally — plans come from the "
        "PlannerService by fingerprint", code="no_local_planning")


# ---------------------------------------------------------------------------
# Planner service
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PlanRecord:
    """One planned graph, as the fleet shares it: fingerprint key, base
    plan, Pareto class plans, and the byte numbers routing needs."""

    key: str
    graph: Graph
    plan: ArenaPlan
    classes: dict[str, ArenaPlan]
    alone_bytes: int             # standalone extent: the routing charge
    persistent_bytes: int
    resident_extent: int

    def plan_for(self, klass: str | None) -> ArenaPlan:
        if klass is None:
            return self.plan
        try:
            return self.classes[klass]
        except KeyError:
            raise PoolError(
                f"record {self.key!r} has no class {klass!r}; registered: "
                f"{sorted(self.classes)}", code="unknown_class") from None

    def charge_bytes(self, klass: str | None) -> int:
        """Bytes the router charges a shard for this record's class plan
        (standalone extent — the ``overlap='none'`` admission charge)."""
        return self.plan_for(klass).arena_bytes


@dataclasses.dataclass
class PlannerStats:
    requests: int = 0            # record lookups served to workers
    record_hits: int = 0         # served from the in-process record map
    shared_hits: int = 0         # rebuilt from the shared PlanCache tier
    planned: int = 0             # actually planned by this service
    registered: int = 0          # pre-built plans handed in

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlannerService:
    """The fleet's single planning authority over a shared `PlanCache`.

    Workers hold fingerprints, not graphs: they call :meth:`record` and
    get back a :class:`PlanRecord` (or a hard KeyError — there is no
    plan-it-yourself fallback).  :meth:`plan_graph` is the ingest side:
    it consults the content-addressed cache first (two services sharing
    one `PlanCache` — or one service across restarts with a disk tier —
    plan each graph exactly once fleet-wide), and plans only on a full
    miss.  :meth:`register` ingests a pre-built plan (``launch/serve.py``
    hands in its regions-layout decode plans, so fleet accounting and
    state packing address the same offsets).
    """

    def __init__(self, cache: PlanCache | None = None):
        self.cache = cache if cache is not None else PlanCache()
        self._records: dict[str, PlanRecord] = {}
        self.stats = PlannerStats()

    def _make_record(self, key: str, graph: Graph, plan: ArenaPlan,
                     classes: dict[str, ArenaPlan]) -> PlanRecord:
        pbytes, extent = resident_bytes(plan)
        rec = PlanRecord(key=key, graph=graph, plan=plan,
                         classes=dict(classes),
                         alone_bytes=plan.arena_bytes,
                         persistent_bytes=pbytes, resident_extent=extent)
        self._records[key] = rec
        return rec

    def register(self, graph: Graph, *, plan: ArenaPlan,
                 classes: dict[str, ArenaPlan] | None = None,
                 key: str | None = None) -> PlanRecord:
        """Ingest a pre-built plan (+ optional class plans) under the
        graph's fingerprint; the shared cache tier gets a copy."""
        if key is None:
            key = labeled_fingerprint(graph)
        self.stats.registered += 1
        classes = dict(classes or {})
        self.cache.put(graph, _CACHE_OPTS,
                       {"plan": plan, "classes": classes})
        return self._make_record(key, graph, plan, classes)

    def plan_graph(self, graph: Graph, *, key: str | None = None,
                   with_classes: bool = True) -> PlanRecord:
        """Plan ``graph`` (shared-cache-first) and return its record.

        ``with_classes`` also derives the two canonical Pareto class
        plans: ``'memory'`` = the base min-footprint plan, ``'latency'``
        = the same layout with transients pinned
        (:func:`~repro_torch.core.allocator.pin_transients`).
        """
        if key is None:
            key = labeled_fingerprint(graph)
        self.stats.requests += 1
        rec = self._records.get(key)
        if rec is not None:
            self.stats.record_hits += 1
            return rec
        payload = self.cache.get(graph, _CACHE_OPTS)
        if payload is not None:
            self.stats.shared_hits += 1
            return self._make_record(key, graph, payload["plan"],
                                     payload["classes"])
        plan = serenity_plan(graph, _PLANNER_CONFIG,
                             order=graph.topo_order(), cache=False).arena
        classes = {"memory": plan, "latency": pin_transients(plan)} \
            if with_classes else {}
        self.stats.planned += 1
        self.cache.put(graph, _CACHE_OPTS, {"plan": plan, "classes": classes})
        return self._make_record(key, graph, plan, classes)

    def record(self, key: str) -> PlanRecord:
        """The record for ``key`` — the only call workers make.  Raises
        ``KeyError`` for an unknown fingerprint: a worker holding a key
        the planner never saw is a routing bug, not a planning request."""
        self.stats.requests += 1
        try:
            rec = self._records[key]
        except KeyError:
            raise KeyError(
                f"planner has no record for fingerprint {key!r}; workers "
                f"never plan locally — register/plan_graph it first"
            ) from None
        self.stats.record_hits += 1
        return rec

    def keys(self) -> tuple[str, ...]:
        return tuple(self._records)


# ---------------------------------------------------------------------------
# Requests and the simulated device step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetRequest:
    """One request's life across the fleet (identity + audit trail)."""

    rid: int
    key: str                     # PlanRecord fingerprint
    prompt_len: int
    gen_len: int
    klass: str | None = None
    priority: int = 0
    tenant: str | None = None
    arrival_tick: int = 0
    # -- outcome ------------------------------------------------------------
    tokens: list = dataclasses.field(default_factory=list)
    rejected: bool = False
    reject_code: str = ""
    reject_reason: str = ""
    submit_tick: int = -1
    admit_tick: int = -1
    done_tick: int = -1
    shards: list = dataclasses.field(default_factory=list)  # placement trail
    preemptions: int = 0
    migrations: int = 0          # re-admissions on a *different* shard
    # -- live state (device-side, simulated) --------------------------------
    lease: object = dataclasses.field(default=None, repr=False)
    spill: SpilledLease | None = dataclasses.field(default=None, repr=False)
    state: np.ndarray | None = dataclasses.field(default=None, repr=False)
    prefilled: int = 0           # prompt tokens prefilled so far

    @classmethod
    def from_arrival(cls, a: Arrival, key: str) -> "FleetRequest":
        return cls(rid=a.rid, key=key, prompt_len=a.prompt_len,
                   gen_len=a.gen_len, klass=a.klass, priority=a.priority,
                   tenant=a.tenant, arrival_tick=a.tick)

    @property
    def done(self) -> bool:
        return self.done_tick >= 0

    @property
    def latency_ticks(self) -> int:
        return self.done_tick - self.arrival_tick


def _prefill_state(rid: int, prompt_len: int, extent: int) -> np.ndarray:
    """Deterministic post-prefill resident state: a pure function of the
    request identity, prompt length and plan extent — independent of
    *where* (which shard, which lane) the prefill ran, which is what
    makes prefill-handoff and migration bit-exactness testable.

    ``repro``'s bytes, ``(idx * (rid % 251 + 3) + prompt_len) % 251``,
    which repeat every 251 bytes: one period is computed and copied out in
    doubling spans (a real decode plan's extent is tens of MB, which the
    int64 form would copy and reduce element by element)."""
    idx = np.arange(min(extent, 251), dtype=np.int64)
    out = np.empty(extent, dtype=np.uint8)
    n = idx.size
    out[:n] = (idx * (rid % 251 + 3) + prompt_len) % 251
    while n < extent:
        k = min(n, extent - n)
        out[n:n + k] = out[:k]
        n += k
    return out


#: bytes of a state the simulated step updates at a time: both passes of a
#: span run while it is in the core's cache, so a step reads and writes the
#: state once from memory, not twice
_STEP_SPAN = 1 << 18


def _advance_state(state: np.ndarray, rid: int, step: int) -> np.ndarray:
    """One simulated decode step (same arithmetic as the chaos SimServer):
    ``repro``'s ``(state * 33 + rid + step) % 256``, computed in uint8,
    whose products and sums wrap modulo 256: the same bits, with no int64
    copy.  ``state`` (1-d) is updated in place, ``_STEP_SPAN`` bytes at a
    time (the request owns it: spills and restores copy) and returned."""
    c = np.uint8((rid + step) % 256)
    for i in range(0, state.size, _STEP_SPAN):
        span = state[i:i + _STEP_SPAN]
        np.multiply(span, np.uint8(33), out=span)
        span += c
    return state


def _emit_token(state: np.ndarray, step: int) -> int:
    return int(state[: min(64, state.size)].sum()) + step


# ---------------------------------------------------------------------------
# Worker shard
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardStats:
    submitted: int = 0
    admitted: int = 0
    served: int = 0
    decode_ticks: int = 0
    prefill_ticks: int = 0
    idle_ticks: int = 0
    prefill_stall_ticks: int = 0   # decode work displaced by inline prefill
    tokens: int = 0                # decode tokens emitted
    prefill_tokens: int = 0        # prompt tokens prefilled
    handoffs_out: int = 0          # prefill-complete spills handed to fleet
    migrations_in: int = 0         # spills re-admitted from another shard
    transient_errors: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class WorkerShard:
    """One simulated device worker: an `ArenaPool` shard + tick loop.

    ``role='decode'`` shards run the decode lane (≤ ``max_batch``
    requests advance one token per tick; latency-class requests are
    served first when the batch is oversubscribed) and prefill inline on
    alternating ticks when no prefill lane exists.  ``role='prefill'``
    shards only prefill (``prefill_chunk`` prompt tokens per request per
    tick) and hand completed state to the fleet as a host spill for
    decode-shard re-admission.
    """

    def __init__(self, sid: int, budget_bytes: int, *, role: str = "decode",
                 max_batch: int = 8, prefill_chunk: int = 32,
                 tenant_quotas: dict[str, int] | None = None,
                 chaos: ChaosController | None = None):
        if role not in ("decode", "prefill"):
            raise ValueError(f"unknown shard role {role!r}")
        self.sid = sid
        self.role = role
        self.max_batch = int(max_batch)
        self.prefill_chunk = int(prefill_chunk)
        self.chaos = chaos
        self.pool = ArenaPool(
            budget_bytes, overlap="none", planner=_no_local_planning,
            tenant_quotas=tenant_quotas,
            admission_hook=chaos.admission_should_fail if chaos else None)
        self._known: set[str] = set()
        self.tickets: dict[int, FleetRequest] = {}   # pool rid -> request
        self.active: list[FleetRequest] = []
        self.stats = ShardStats()
        self.max_over_budget = 0   # worst observed reserved - budget (<=0 ok)
        self.peak_reserved = 0     # most bytes reserved at a tick's end

    # -- placement-side API -------------------------------------------------

    def ensure(self, record: PlanRecord) -> None:
        """Install ``record``'s plans in this shard's pool (idempotent)."""
        if record.key in self._known:
            return
        self.pool.plan(record.graph, key=record.key, plan=record.plan)
        if record.classes:
            self.pool.register_pareto(record.key, record.classes)
        self._known.add(record.key)

    def load_fraction(self, extra_bytes: int = 0) -> float:
        """Projected occupancy: admitted + queued (+ a candidate charge)
        over this shard's budget — the router's ranking key."""
        budget = max(1, self.pool.budget_bytes)
        return (self.pool.reserved_bytes + self.pool.queued_bytes
                + extra_bytes) / budget

    def can_ever_fit(self, charge: int, tenant: str | None) -> bool:
        if charge > self.pool.budget_bytes:
            return False
        quota = self.pool.tenant_quotas.get(tenant)
        return quota is None or charge <= quota

    def fits_now(self, plan: ArenaPlan, tenant: str | None) -> bool:
        return self.pool.why_not_admitted(plan, tenant) == ""

    def submit(self, req: FleetRequest, record: PlanRecord) -> Ticket:
        self.ensure(record)
        self.stats.submitted += 1
        ticket = self.pool.submit(record.graph, key=record.key,
                                  klass=req.klass, priority=req.priority,
                                  tenant=req.tenant)
        if not ticket.rejected:
            self.tickets[ticket.rid] = req
        return ticket

    def readmit(self, req: FleetRequest) -> Ticket:
        """One re-admission attempt for a spilled request (queue-bypass)."""
        ticket = self.pool.readmit(req.spill)
        if ticket.admitted:
            self.tickets[ticket.rid] = req
        return ticket

    @property
    def busy(self) -> bool:
        return bool(self.active or self.tickets or self.pool.queue_len
                    or self.pool.pending_admissions)

    # -- the tick loop ------------------------------------------------------

    def tick(self, now: int, fleet: "Fleet") -> None:
        if self.chaos is not None:
            for spec in self.chaos.begin_tick(now):
                if spec.kind == "budget_shrink":
                    self.set_budget(
                        int(self.pool.budget_bytes * spec.factor),
                        fleet, now)
        self.pool.kick()
        self._collect(now, fleet)
        prefill = [r for r in self.active if r.prefilled < r.prompt_len]
        decode = [r for r in self.active if r.prefilled >= r.prompt_len]
        try:
            # the injected transient fires *before* any state is touched,
            # so a skipped tick is safely retryable (bit-equality holds)
            if self.chaos is not None:
                self.chaos.maybe_executor_error()
            if self.role == "prefill":
                if prefill:
                    self._prefill_tick(now, fleet, prefill)
                else:
                    self.stats.idle_ticks += 1
            elif prefill and (not decode or now % 2 == 0):
                # inline prefill: no dedicated lane, so prefilling consumes
                # the device tick and the decode batch waits — the stall
                # disaggregation exists to remove
                if decode:
                    self.stats.prefill_stall_ticks += 1
                self._prefill_tick(now, fleet, prefill)
            elif decode:
                self._decode_tick(now, fleet, decode)
            else:
                self.stats.idle_ticks += 1
        except TransientExecutorError:
            self.stats.transient_errors += 1
        over = self.pool.reserved_bytes - self.pool.budget_bytes
        self.max_over_budget = max(self.max_over_budget, over)
        self.peak_reserved = max(self.peak_reserved, self.pool.reserved_bytes)

    def _collect(self, now: int, fleet: "Fleet") -> None:
        for ticket in self.pool.poll():
            req = self.tickets.pop(ticket.rid, None)
            if req is None:
                continue     # preempted by a budget shrink before collection
            req.lease = ticket.lease
            if req.admit_tick < 0:
                req.admit_tick = now
            if req.spill is not None:
                # spill round trip completes: restore device state verbatim
                if req.spill.host_state is not None:
                    req.state = np.array(req.spill.host_state,
                                         dtype=np.uint8, copy=True)
                if req.shards and req.shards[-1] != self.sid:
                    req.migrations += 1
                    self.stats.migrations_in += 1
                    # classify the crossing once, at restore time, so both
                    # re-admitted and queue-migrated spills are counted
                    if fleet.shard_by_sid(req.shards[-1]).role == "prefill":
                        fleet.stats.handoffs += 1
                    else:
                        fleet.stats.migrations += 1
                req.spill = None
            if not req.shards or req.shards[-1] != self.sid:
                req.shards.append(self.sid)
            self.active.append(req)
            self.stats.admitted += 1
        for ticket in self.pool.poll_rejected():
            # a budget-shrink sweep evicted a queued ticket: the fleet may
            # still place it on another shard
            req = self.tickets.pop(ticket.rid, None)
            if req is not None:
                fleet.reroute_or_reject(req, ticket, now)

    def _prefill_tick(self, now: int, fleet: "Fleet",
                      jobs: list[FleetRequest]) -> None:
        self.stats.prefill_ticks += 1
        for req in jobs[: self.max_batch]:
            step = min(self.prefill_chunk, req.prompt_len - req.prefilled)
            req.prefilled += step
            self.stats.prefill_tokens += step
            if req.prefilled >= req.prompt_len:
                req.state = _prefill_state(req.rid, req.prompt_len,
                                           req.lease.resident_extent)
                if self.role == "prefill":
                    # disaggregation handoff: spill the fresh state to host
                    # and let the fleet re-admit it on a decode shard —
                    # the same round trip preemption uses
                    self._spill_out(req, now, fleet, handoff=True)

    def _decode_tick(self, now: int, fleet: "Fleet",
                     jobs: list[FleetRequest]) -> None:
        self.stats.decode_ticks += 1
        # latency-class requests get batch slots first; then higher
        # priority, then oldest
        jobs = sorted(jobs, key=lambda r: (r.klass != "latency",
                                           -r.priority, r.rid))
        for req in jobs[: self.max_batch]:
            step = req.prompt_len + len(req.tokens)
            req.state = _advance_state(req.state, req.rid, step)
            req.tokens.append(_emit_token(req.state, len(req.tokens)))
            self.stats.tokens += 1
            if len(req.tokens) >= req.gen_len:
                self.pool.release(req.lease)
                req.lease = None
                req.state = None
                req.done_tick = now
                self.active.remove(req)
                self.stats.served += 1
                fleet.retire(req)

    def _spill_out(self, req: FleetRequest, now: int, fleet: "Fleet",
                   handoff: bool = False) -> None:
        spill = self.pool.preempt(req.lease, state=req.state)
        req.lease = None
        req.state = None
        req.spill = spill
        self.active.remove(req)
        if handoff:
            self.stats.handoffs_out += 1
            spill.next_tick = now + 1      # due immediately, no backoff
        else:
            req.preemptions += 1
        fleet.add_spilled(req)

    def set_budget(self, nbytes: int, fleet: "Fleet", now: int) -> None:
        """Shrink/grow this shard's budget and enforce it: over-budget
        bytes are recovered by preempting lowest-priority members, whose
        spills the fleet re-places (possibly on other shards)."""
        over = self.pool.set_budget(nbytes)
        while over > 0:
            victim = self.pool.preempt_candidate()
            if victim is None:
                break
            req = next((r for r in self.active if r.lease is victim), None)
            if req is not None:
                self._spill_out(req, now, fleet)
            else:
                # admitted this very tick, not yet collected: the uncounted
                # ticket still maps the lease rid to its request
                req = self.tickets.pop(victim.rid, None)
                if req is None:      # orphan member (should not happen)
                    self.pool.preempt(victim)
                else:
                    # a requeued spill may be admitted but uncollected: its
                    # device state still lives on the *old* spill record —
                    # carry it over, never clobber it with None
                    state = req.state
                    if state is None and req.spill is not None:
                        state = req.spill.host_state
                    spill = self.pool.preempt(victim, state=state)
                    req.lease = None
                    req.state = None
                    req.spill = spill
                    req.preemptions += 1
                    fleet.add_spilled(req)
            over = self.pool.reserved_bytes - self.pool.budget_bytes

    def report(self) -> dict:
        return {
            "sid": self.sid, "role": self.role,
            "budget_bytes": self.pool.budget_bytes,
            "reserved_bytes": self.pool.reserved_bytes,
            "queue_len": self.pool.queue_len,
            "active": len(self.active),
            "max_over_budget": self.max_over_budget,
            **self.stats.as_dict(),
        }


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


class FleetRouter:
    """Byte-aware placement over the fleet's shards.

    Placement rule (DESIGN.md §14): a request is charged its class
    plan's standalone extent.  Among the lane's shards whose budget and
    tenant quota could *ever* fit that charge, pick the lowest projected
    occupancy ``(reserved + queued + charge) / budget`` (ties to the
    lowest shard id — deterministic).  No candidate → reject with
    ``'budget'`` / ``'tenant_quota'``.  The router never places a charge
    above a shard's budget, so a shard can only exceed its budget if its
    *own* pool accounting does — which the per-shard
    ``max_over_budget`` watermark (and the chaos invariant) would catch.
    """

    def __init__(self, shards: list[WorkerShard]):
        self.shards = list(shards)
        self.decode_shards = [s for s in shards if s.role == "decode"]
        self.prefill_shards = [s for s in shards if s.role == "prefill"]
        self.placements = 0
        self.rejections = 0

    def place(self, req: FleetRequest, record: PlanRecord,
              lane: list[WorkerShard]) -> tuple[WorkerShard | None, str, str]:
        """Pick a shard for a fresh request; ``(None, code, reason)`` when
        no shard in the lane can ever fit it."""
        charge = record.charge_bytes(req.klass)
        fit = [s for s in lane if s.can_ever_fit(charge, req.tenant)]
        if not fit:
            self.rejections += 1
            if any(charge <= s.pool.budget_bytes for s in lane):
                return None, "tenant_quota", (
                    f"plan needs {charge} bytes alone; no shard quota for "
                    f"tenant {req.tenant!r} admits it")
            budgets = [s.pool.budget_bytes for s in lane] or [0]
            return None, "budget", (
                f"plan needs {charge} bytes alone; largest shard budget "
                f"is {max(budgets)}")
        best = min(fit, key=lambda s: (s.load_fraction(charge), s.sid))
        self.placements += 1
        return best, "", ""

    def place_spilled(self, req: FleetRequest,
                      lane: list[WorkerShard] | None = None) \
            -> WorkerShard | None:
        """A lane shard that can admit the spilled plan *right now*
        (spills bypass queues, so fits-now is the bar), least-loaded
        first; ``None`` when no shard currently has the bytes."""
        plan = req.spill.plan
        fit = [s for s in (self.decode_shards if lane is None else lane)
               if s.fits_now(plan, req.tenant)]
        if not fit:
            return None
        return min(fit, key=lambda s: (s.load_fraction(plan.arena_bytes),
                                       s.sid))

    def can_ever_fit_anywhere(self, charge: int, tenant: str | None,
                              lane: list[WorkerShard] | None = None) -> bool:
        lane = self.decode_shards if lane is None else lane
        return any(s.can_ever_fit(charge, tenant) for s in lane)


# ---------------------------------------------------------------------------
# The fleet
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FleetStats:
    submitted: int = 0
    served: int = 0
    rejected: int = 0
    migrations: int = 0          # cross-shard re-admissions (non-handoff)
    handoffs: int = 0            # prefill-lane -> decode-shard handoffs
    spill_retries: int = 0
    requeues: int = 0            # spills migrated via a shard queue

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Fleet:
    """N worker shards + router + planner, driven by one global tick.

    One tick = one simulated device step on every shard in parallel (the
    shards are independent devices; python just iterates them).  The
    run loop is open-loop: requests are submitted at their arrival tick
    regardless of fleet state, spilled leases are retried with
    exponential backoff (bounded by ``max_readmit_attempts``), and the
    loop ends when every request is served or rejected.

    Args:
      planner: the :class:`PlannerService` all shards share.
      key_for: maps an :class:`~repro_torch.runtime.loadgen.Arrival` to the
        planner fingerprint of the record it should lease (e.g. a
        sequence-bucket mapping); only needed when driving with raw
        arrivals via :meth:`run_arrivals`.
      n_decode / n_prefill: lane sizes; ``n_prefill=0`` disables
        disaggregation (prefill runs inline on decode shards).
      shard_budget_bytes / prefill_budget_bytes: per-shard byte budgets.
      prefill_threshold: prompts at least this long go to the prefill
        lane (default ``2 * prefill_chunk``; ignored without one).
      fault_plans: optional ``{sid: FaultPlan}`` — each listed shard gets
        its own :class:`ChaosController` seam.
    """

    def __init__(self, planner: PlannerService, *,
                 key_for=None,
                 n_decode: int = 4, n_prefill: int = 0,
                 shard_budget_bytes: int, prefill_budget_bytes: int | None = None,
                 max_batch: int = 8, prefill_chunk: int = 32,
                 prefill_threshold: int | None = None,
                 tenant_quotas: dict[str, int] | None = None,
                 max_readmit_attempts: int = 6,
                 fault_plans: dict | None = None):
        if n_decode < 1:
            raise ValueError("a fleet needs at least one decode shard")
        self.planner = planner
        self.key_for = key_for
        self.prefill_chunk = int(prefill_chunk)
        self.prefill_threshold = (2 * self.prefill_chunk
                                  if prefill_threshold is None
                                  else int(prefill_threshold))
        self.max_readmit_attempts = int(max_readmit_attempts)
        fault_plans = fault_plans or {}
        self.shards: list[WorkerShard] = []
        for i in range(n_decode):
            self.shards.append(WorkerShard(
                i, shard_budget_bytes, role="decode", max_batch=max_batch,
                prefill_chunk=prefill_chunk, tenant_quotas=tenant_quotas,
                chaos=(ChaosController(fault_plans[i])
                       if i in fault_plans else None)))
        for j in range(n_prefill):
            sid = n_decode + j
            self.shards.append(WorkerShard(
                sid,
                prefill_budget_bytes if prefill_budget_bytes is not None
                else shard_budget_bytes,
                role="prefill", max_batch=max_batch,
                prefill_chunk=prefill_chunk, tenant_quotas=tenant_quotas,
                chaos=(ChaosController(fault_plans[sid])
                       if sid in fault_plans else None)))
        self.router = FleetRouter(self.shards)
        self._spilled: list[FleetRequest] = []
        self.done: list[FleetRequest] = []
        self.rejected: list[FleetRequest] = []
        self.stats = FleetStats()
        self.ticks = 0

    # -- request lifecycle --------------------------------------------------

    def _lane_for(self, req: FleetRequest) -> list[WorkerShard]:
        """Prefill lane iff one exists, the prompt clears the threshold,
        and the request still has prompt tokens left to prefill."""
        if (self.router.prefill_shards
                and req.prefilled < req.prompt_len
                and req.prompt_len >= self.prefill_threshold):
            return self.router.prefill_shards
        return self.router.decode_shards

    def submit(self, req: FleetRequest, now: int) -> None:
        self.stats.submitted += 1
        req.submit_tick = now
        record = self.planner.record(req.key)
        shard, code, reason = self.router.place(req, record,
                                                self._lane_for(req))
        if shard is None:
            self._reject(req, code, reason)
            return
        ticket = shard.submit(req, record)
        if ticket.rejected:
            # the pool's own never-fits check disagrees only when budgets
            # moved between ranking and submit (chaos) — honor it
            self._reject(req, ticket.reason_code, ticket.reason)

    def reroute_or_reject(self, req: FleetRequest, ticket: Ticket,
                          now: int) -> None:
        """A queued ticket was swept by a shard budget shrink; try the
        other shards before giving up."""
        record = self.planner.record(req.key)
        shard, code, reason = self.router.place(req, record,
                                                self._lane_for(req))
        if shard is None:
            self._reject(req, ticket.reason_code or code,
                         ticket.reason or reason)
            return
        t = shard.submit(req, record)
        if t.rejected:
            self._reject(req, t.reason_code, t.reason)

    def add_spilled(self, req: FleetRequest) -> None:
        self._spilled.append(req)

    def retire(self, req: FleetRequest) -> None:
        self.done.append(req)
        self.stats.served += 1

    def _reject(self, req: FleetRequest, code: str, reason: str) -> None:
        req.rejected = True
        req.reject_code = code or "rejected"
        req.reject_reason = reason
        req.lease = None
        req.spill = None
        req.state = None
        self.rejected.append(req)
        self.stats.rejected += 1

    def _retry_spilled(self, now: int) -> None:
        still: list[FleetRequest] = []
        for req in self._spilled:
            spill = req.spill
            if not spill.due(now):
                still.append(req)
                continue
            self.stats.spill_retries += 1
            lane = self._lane_for(req)
            shard = self.router.place_spilled(req, lane)
            if shard is None:
                charge = spill.plan.arena_bytes
                if not self.router.can_ever_fit_anywhere(charge, req.tenant,
                                                         lane):
                    self._reject(req, "budget", (
                        f"spilled plan needs {charge} bytes alone; no "
                        f"decode shard budget admits it"))
                elif spill.attempts >= 1:
                    # fits-now keeps losing the race against the shards'
                    # FIFO queues (every freed byte is claimed by a queued
                    # arrival before the backed-off retry fires).  Migrate
                    # instead: re-submit into the least-loaded shard's
                    # queue — the host-spilled state rides along on the
                    # request and is restored verbatim at admission, so
                    # this is the same round trip, minus the livelock.
                    self._requeue_spilled(req, lane)
                else:
                    spill.backoff(now)
                    still.append(req)
                continue
            ticket = shard.readmit(req)
            if ticket.admitted:
                pass     # the crossing is classified at collection time
            elif ticket.rejected:
                self._reject(req, ticket.reason_code, ticket.reason)
            elif spill.attempts >= self.max_readmit_attempts:
                self._reject(req, "readmit_exhausted", (
                    f"re-admission failed {spill.attempts} times "
                    f"(max {self.max_readmit_attempts})"))
            else:
                spill.backoff(now)
                still.append(req)
        self._spilled = still

    def _requeue_spilled(self, req: FleetRequest,
                         lane: list[WorkerShard]) -> None:
        """Migrate a spill that can't fit *now* anywhere by queueing it on
        the least-loaded shard that can *ever* fit it."""
        record = self.planner.record(req.key)
        shard, code, reason = self.router.place(req, record, lane)
        if shard is None:        # budgets moved since the can-ever check
            self._reject(req, code, reason)
            return
        ticket = shard.submit(req, record)
        if ticket.rejected:
            self._reject(req, ticket.reason_code, ticket.reason)
        else:
            self.stats.requeues += 1

    def shard_by_sid(self, sid: int) -> WorkerShard:
        return self.shards[sid]

    # -- the drive loop -----------------------------------------------------

    def run(self, requests: list[FleetRequest], *,
            max_ticks: int | None = None) -> dict:
        """Drive the open-loop tick clock until every request resolves."""
        pending = collections.deque(sorted(
            requests, key=lambda r: (r.arrival_tick, r.rid)))
        if max_ticks is None:
            horizon = max((r.arrival_tick for r in requests), default=0)
            work = sum(r.gen_len + r.prompt_len // self.prefill_chunk + 2
                       for r in requests)
            max_ticks = horizon + 1000 + 4 * work // max(
                1, len(self.router.decode_shards))
        wall0 = time.perf_counter()
        now = 0
        while pending or self._spilled or any(s.busy for s in self.shards):
            now += 1
            if now > max_ticks:
                raise FleetStallError(
                    f"fleet made no full drain within {max_ticks} ticks "
                    f"({len(pending)} pending, {len(self._spilled)} "
                    f"spilled)", report=self.describe())
            while pending and pending[0].arrival_tick <= now:
                self.submit(pending.popleft(), now)
            self._retry_spilled(now)
            for shard in self.shards:
                shard.tick(now, self)
        self.ticks = now
        return self.metrics(wall_s=time.perf_counter() - wall0)

    def run_arrivals(self, arrivals: list[Arrival], **kwargs) -> dict:
        if self.key_for is None:
            raise ValueError("run_arrivals needs key_for= at construction")
        reqs = [FleetRequest.from_arrival(a, key=self.key_for(a))
                for a in arrivals]
        return self.run(reqs, **kwargs)

    # -- reporting ----------------------------------------------------------

    def metrics(self, wall_s: float | None = None) -> dict:
        served = self.done
        n = self.stats.submitted
        lat = sorted(r.latency_ticks for r in served)
        if lat:
            p50 = float(np.percentile(lat, 50))
            p99 = float(np.percentile(lat, 99))
        else:
            # an all-rejected fleet has no latency to report — NaN, never
            # a vacuous 0.0 (the DecodeServer fix, same convention)
            p50 = p99 = float("nan")
        tokens = sum(s.stats.tokens for s in self.shards)
        ticks = max(1, self.ticks)
        out = {
            "n_requests": n,
            "n_served": len(served),
            "n_rejected": len(self.rejected),
            "n_lost": n - len(served) - len(self.rejected),
            "rejection_rate": round(len(self.rejected) / n, 4) if n else 0.0,
            "ticks": self.ticks,
            "p50_ticks": round(p50, 1) if math.isfinite(p50) else p50,
            "p99_ticks": round(p99, 1) if math.isfinite(p99) else p99,
            "tokens": tokens,
            "tok_per_tick": round(tokens / ticks, 3),
            "migrations": self.stats.migrations,
            "handoffs": self.stats.handoffs,
            "requeues": self.stats.requeues,
            "preemptions": sum(
                s.pool.preemption_stats.preemptions for s in self.shards),
            "max_over_budget": max(s.max_over_budget for s in self.shards),
            "prefill_stall_ticks": sum(
                s.stats.prefill_stall_ticks for s in self.shards),
            "planner": self.planner.stats.as_dict(),
        }
        if wall_s is not None:
            out["wall_s"] = round(wall_s, 3)
        return out

    def describe(self) -> dict:
        """Structured stall/debug report: fleet counters + per-shard state
        (incl. each pool's queue diagnostics)."""
        return {
            "fleet": self.stats.as_dict(),
            "spilled": [
                {"rid": r.rid, "attempts": r.spill.attempts,
                 "next_tick": r.spill.next_tick}
                for r in self._spilled
            ],
            "shards": [
                {**s.report(), "queue": s.pool.queue_report()}
                for s in self.shards
            ],
        }


# ---------------------------------------------------------------------------
# Synthetic fleet workloads (benchmarks + tests)
# ---------------------------------------------------------------------------


def sim_state_graph(smax: int, *, n_cache: int = 3, bytes_per_pos: int = 8,
                    transient_bytes: int | None = None) -> Graph:
    """A decode-state stand-in sized for ``smax`` sequence positions:
    ``n_cache`` persistent cache buffers of ``smax * bytes_per_pos`` bytes
    plus a short transient activation chain — the same shape the chaos
    suite's SimServer uses, parameterized so sequence buckets map to
    genuinely different plans (and byte charges)."""
    cache_bytes = smax * bytes_per_pos
    if transient_bytes is None:
        transient_bytes = max(64, cache_bytes // 2)
    specs = [dict(name=f"s{i}", op="cache", size_bytes=cache_bytes, preds=[])
             for i in range(n_cache)]
    specs.append(dict(name="h", op="act", size_bytes=transient_bytes // 2,
                      preds=[]))
    specs.append(dict(name="l", op="act", size_bytes=transient_bytes,
                      preds=[len(specs) - 1]))
    specs.append(dict(name="tok", op="act", size_bytes=4,
                      preds=[len(specs) - 1]))
    return Graph.build(specs, name=f"simstate{smax}")


def bucketed_records(planner: PlannerService, buckets: tuple[int, ...],
                     graph_for=sim_state_graph) -> dict[int, PlanRecord]:
    """Plan one record per sequence bucket through ``planner``; returns
    ``{bucket: record}``.  Buckets must be sorted ascending."""
    if tuple(sorted(buckets)) != tuple(buckets):
        raise ValueError(f"buckets must be ascending, got {buckets}")
    return {b: planner.plan_graph(graph_for(b)) for b in buckets}


def bucket_key_for(records: dict[int, PlanRecord]):
    """``key_for`` closure for :class:`Fleet`: an arrival leases the
    smallest bucket record covering ``prompt + gen``; oversize arrivals
    get the largest bucket's record (whose plan then typically exceeds
    every shard budget — a *real* router rejection, not a special case)."""
    buckets = sorted(records)

    def key_for(a: Arrival) -> str:
        for b in buckets:
            if a.smax <= b:
                return records[b].key
        return records[buckets[-1]].key

    return key_for
