"""Multi-tenant arena pool: budgeted leases of pre-planned serving arenas.

A copy of ``repro.runtime.pool`` (no JAX in either); the one change is the
spill of a leased buffer, an explicit device-to-host copy of a tensor (the
fleet's simulated state, a numpy array, is copied as ``repro`` copies it).

One edge device, one byte budget, many concurrent requests — the regime
where per-inference footprint is the binding constraint.  The pool turns
the single-request plan machinery (scheduler → arena offsets) into
admission control (DESIGN.md §9):

  * every request *leases* a pre-planned arena for its (graph-hash, shape);
    repeat shapes skip planning (plan LRU) *and* allocation (warm-buffer
    LRU);
  * admission charges the request's plan against the global budget via
    :func:`~repro_torch.core.allocator.plan_shared_arena`: with the default
    ``overlap='serial'`` the joint extent overlaps the members'
    non-concurrent transient slack, so K requests reserve far less than K
    standalone arenas;
  * a request that fits is **admitted**, one that would overflow is
    **queued** (FIFO, head-of-line order preserved), and one whose own
    arena can never fit the budget is **rejected** outright;
  * a key may carry several *request-class* plans — distinct points of the
    latency x memory Pareto frontier (DESIGN.md §12) registered via
    ``register_pareto`` — and ``submit(..., klass=...)`` leases the class's
    plan: a memory-starved request takes the min-peak point, a
    latency-sensitive one the min-makespan point with its transients
    pinned (no buffer-reuse hazards between co-issued ops).

The pool is a synchronous scheduler-side object: one serving loop drives
``submit`` / ``poll`` / ``release``; it is not thread-safe by design.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import warnings
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.allocator import (
    ArenaPlan,
    SharedArenaPlan,
    pin_transients,
    plan_arena_best,
    plan_shared_arena,
    resident_bytes,
)
from repro_torch.core.graph import Graph
from repro_torch.core.plancache import labeled_fingerprint
from repro_torch.core.serenity import PlanConfig, plan as serenity_plan

# Default lease planning: pack the caller's order (or the deterministic topo
# order) as-is — pool members arrive pre-scheduled, so the pool only needs
# arena offsets, not a DP search.
_LEASE_CONFIG = PlanConfig(rewrite=False, inplace=False,
                           compute_baselines=False)


class PoolError(RuntimeError):
    """Pool misuse or admission impossibility, with structured context.

    Besides the formatted message, every raise site attaches the numbers it
    was formatted from as attributes — ``code`` (a stable machine-readable
    cause tag), ``requested_bytes``, ``budget_bytes``, ``reserved_bytes``,
    ``queue_depth`` — so the degradation ladder and tests branch on cause
    instead of regex-matching messages (DESIGN.md §13).  ``context`` is the
    dict of every non-``None`` attribute.
    """

    def __init__(self, message: str, *, code: str | None = None,
                 requested_bytes: int | None = None,
                 budget_bytes: int | None = None,
                 reserved_bytes: int | None = None,
                 queue_depth: int | None = None):
        super().__init__(message)
        self.code = code
        self.requested_bytes = requested_bytes
        self.budget_bytes = budget_bytes
        self.reserved_bytes = reserved_bytes
        self.queue_depth = queue_depth

    @property
    def context(self) -> dict:
        return {k: v for k, v in (
            ("code", self.code),
            ("requested_bytes", self.requested_bytes),
            ("budget_bytes", self.budget_bytes),
            ("reserved_bytes", self.reserved_bytes),
            ("queue_depth", self.queue_depth),
        ) if v is not None}


def pareto_class_plans(graph, frontier) -> dict[str, ArenaPlan]:
    """Arena plans for the two canonical request classes of a frontier.

    Maps a :class:`~repro_torch.core.scheduler.ParetoFrontier` (DESIGN.md §12)
    onto the admission classes the pool serves:

      ``'memory'``   the min-peak point's arena — the smallest footprint
                     the schedule space offers, for memory-starved
                     admission (maximum co-residency).
      ``'latency'``  the min-makespan point's arena with every transient
                     pinned (:func:`~repro_torch.core.allocator.pin_transients`)
                     — a latency-sensitive request trades bytes for a
                     layout with no buffer-reuse hazards to wait on.

    Both plans are packed with the point's co-issue steps, so the planned
    peak is exactly the frontier point's ``peak_bytes``.  Register the
    result with :meth:`ArenaPool.register_pareto`.
    """
    if not frontier.points:
        raise PoolError("cannot build class plans from an empty frontier")
    mem_pt = frontier.min_peak
    lat_pt = frontier.min_makespan
    mem_plan = plan_arena_best(graph, mem_pt.order, steps=mem_pt.steps)
    lat_plan = plan_arena_best(graph, lat_pt.order, steps=lat_pt.steps)
    return {"memory": mem_plan, "latency": pin_transients(lat_plan)}


class LeaseError(PoolError):
    """Lease lifecycle misuse (double release, foreign lease)."""


@dataclasses.dataclass
class PoolStats:
    """Counters over the pool's lifetime (bytes fields in bytes)."""

    submitted: int = 0
    admitted: int = 0
    rejected: int = 0
    released: int = 0
    plan_hits: int = 0           # planning skipped (plan LRU)
    warm_hits: int = 0           # buffer allocation skipped (warm LRU)
    evictions: int = 0           # warm buffers dropped by the LRU cap
    peak_reserved_bytes: int = 0
    max_concurrent: int = 0
    peak_queued: int = 0
    # admissions per request class (DESIGN.md §12); classless admissions
    # are not counted here
    admitted_by_class: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PreemptionStats:
    """Preemption / spill / re-admission counters (DESIGN.md §13)."""

    preemptions: int = 0
    spilled_bytes: int = 0       # total host bytes written by preempt()
    readmit_attempts: int = 0
    readmitted: int = 0
    readmit_rejections: int = 0  # re-admissions the shrunk budget can never fit
    admission_faults: int = 0    # admissions suppressed by the fault hook
    budget_shrinks: int = 0
    budget_evictions: int = 0    # queued tickets rejected by a shrink sweep

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Lease:
    """An admitted request's hold on planned arena bytes.

    ``plan`` is the standalone member plan (offsets local to this lease's
    own address space); ``buffer``, when the pool allocates physical
    buffers, covers ``resident_extent`` bytes — the persistent (state)
    region of the plan, which is what must survive between steps.  The
    transient region above it is accounted (and shared across members by
    admission) but never materialized per lease.
    """

    rid: int
    key: str
    plan: ArenaPlan
    arena_bytes: int             # standalone extent (naive reserve)
    persistent_bytes: int
    resident_extent: int
    buffer: object | None = None
    priority: int = 0            # higher = more important; preempt picks min
    tenant: str | None = None
    _released: bool = dataclasses.field(default=False, repr=False)


@dataclasses.dataclass
class Ticket:
    """Tracks one submitted request through admit / queue / reject.

    ``reason_code`` is the machine-readable rejection cause (stable tags:
    ``'budget'``, ``'tenant_quota'``, ``'budget_shrunk'``,
    ``'readmit_exhausted'``); ``reason`` the human-formatted counterpart.
    """

    rid: int
    key: str
    lease: Lease | None = None
    rejected: bool = False
    reason: str = ""
    reason_code: str = ""
    klass: str | None = None     # Pareto request class, when submitted with one
    priority: int = 0
    tenant: str | None = None

    @property
    def admitted(self) -> bool:
        return self.lease is not None


@dataclasses.dataclass
class SpilledLease:
    """A preempted lease's movable state, waiting to be re-admitted.

    ``host_state`` holds the lease's resident bytes copied off the device
    (the ``pack_decode_state`` round-trip makes them self-contained: the
    plan's offsets are buffer-relative, so any future buffer can host them
    verbatim).  ``attempts`` / ``next_tick`` are the re-admission backoff
    bookkeeping the serving loop drives (bounded retry, exponential
    backoff — DESIGN.md §13).
    """

    rid: int
    key: str
    plan: ArenaPlan
    spill_bytes: int
    host_state: object | None = None   # np.uint8 copy of the resident bytes
    klass: str | None = None
    priority: int = 0
    tenant: str | None = None
    attempts: int = 0
    next_tick: int = 0

    def backoff(self, tick: int) -> None:
        """Record a failed re-admission attempt; next try after 2^attempts
        ticks counting the attempt just recorded (2, 4, 8, ... —
        exponential)."""
        self.attempts += 1
        self.next_tick = tick + (1 << self.attempts)

    def due(self, tick: int) -> bool:
        return tick >= self.next_tick


@dataclasses.dataclass
class ScratchReservation:
    """A handle on transient scratch bytes charged against a pool's budget.

    Returned by :meth:`ArenaPool.reserve_scratch`; each reservation is
    independent — two reservers (a vmap padding step and a prefill lane,
    say) each hold their own token and release only their own bytes, so
    neither can clobber the other.  Release via :meth:`release` (or
    :meth:`ArenaPool.release_scratch`); releasing twice raises
    :class:`PoolError` with ``code='scratch_double_release'``.
    """

    sid: int
    nbytes: int
    _pool: "ArenaPool" = dataclasses.field(repr=False)
    released: bool = dataclasses.field(default=False, repr=False)

    def release(self) -> None:
        self._pool.release_scratch(self)


class ArenaPool:
    """Budgeted pool of pre-planned arena leases (DESIGN.md §9).

    Args:
      budget_bytes: the global device-memory budget all admitted leases
        must fit under (joint extent, not naive sum — see ``overlap``).
      overlap: admission accounting mode.  ``'serial'`` (default) charges
        the :func:`plan_shared_arena` joint extent — members' transient
        slack is shared, matching a runtime that executes admitted steps
        back-to-back on one stream.  ``'none'`` charges the naive sum of
        standalone extents (one arena per request) — the baseline an
        execution mode that materializes every member's transients at once
        must use.
      max_warm: released lease buffers kept warm per pool (LRU); a repeat
        shape leases without planning or allocating.
      planner: ``planner(graph, order) -> ArenaPlan``; defaults to
        :func:`repro_torch.core.serenity.plan` packing the graph's deterministic
        topo order (arena offsets only — no DP search).
      alloc_fn: ``alloc_fn(nbytes) -> buffer`` for physical lease buffers
        (the decode server passes a torch uint8 allocator).  ``None`` keeps
        the pool accounting-only (``Lease.buffer is None``).
      tenant_quotas: optional per-tenant byte caps: a tenant's admitted
        leases may never jointly charge more than its quota (each lease is
        charged its standalone joint extent).  Tenants absent from the map
        are unconstrained.
      admission_hook: fault-injection point (DESIGN.md §13): called with no
        arguments immediately before each admission attempt; returning
        truthy makes that attempt fail transiently (the request stays
        queued, ``preemption_stats.admission_faults`` counts it, and a
        later :meth:`kick` / release retries).  ``None`` disables.
    """

    def __init__(
        self,
        budget_bytes: int,
        *,
        overlap: str = "serial",
        max_warm: int = 4,
        max_plans: int = 64,
        planner: Callable[[Graph, Sequence[int] | None], ArenaPlan] | None = None,
        alloc_fn: Callable[[int], object] | None = None,
        tenant_quotas: dict[str, int] | None = None,
        admission_hook: Callable[[], bool] | None = None,
    ):
        if overlap not in ("serial", "none"):
            raise PoolError(f"unknown overlap mode {overlap!r}",
                            code="bad_overlap")
        self.budget_bytes = int(budget_bytes)
        self.overlap = overlap
        self.max_warm = max_warm
        self.tenant_quotas = dict(tenant_quotas or {})
        self.admission_hook = admission_hook
        self._planner = planner
        self._alloc_fn = alloc_fn
        self._plans: collections.OrderedDict[str, ArenaPlan] = \
            collections.OrderedDict()
        self._max_plans = max_plans
        self._warm: collections.OrderedDict[int, tuple[str, object]] = \
            collections.OrderedDict()          # wid -> (key, buffer)
        self._wid = itertools.count()
        self._rid = itertools.count()
        self._members: list[Lease] = []
        self._queue: collections.deque[tuple[Ticket, ArenaPlan]] = \
            collections.deque()
        self._admitted_since_poll: list[Ticket] = []
        self._rejected_since_poll: list[Ticket] = []
        self._scratch: dict[int, ScratchReservation] = {}
        self._scratch_sid = itertools.count()
        self._scratch_bytes = 0              # running sum over _scratch
        self._legacy_scratch: ScratchReservation | None = None
        self._pareto: dict[str, dict[str, ArenaPlan]] = {}
        self.stats = PoolStats()
        self.preemption_stats = PreemptionStats()

    # -- planning ----------------------------------------------------------

    def plan(self, graph: Graph, order: Sequence[int] | None = None,
             *, key: str | None = None,
             plan: ArenaPlan | None = None) -> tuple[str, ArenaPlan]:
        """Plan (or fetch) the arena for ``graph``; returns ``(key, plan)``.

        ``key`` defaults to the graph's labeled content fingerprint, so two
        byte-identical decode-state graphs share one plan.  Pass ``plan``
        to register a pre-built plan under the key (the decode server
        hands in its regions-layout decode plan, so the pool's accounting,
        the lease buffers and the state pack/unpack all address the *same*
        offsets).
        """
        if key is None:
            key = labeled_fingerprint(graph)
        cached = self._plans.get(key)
        if cached is not None:
            self._plans.move_to_end(key)
            self.stats.plan_hits += 1
            return key, cached
        if plan is None:
            if self._planner is not None:
                plan = self._planner(graph, order)
            else:
                plan = serenity_plan(
                    graph, _LEASE_CONFIG,
                    order=graph.topo_order() if order is None else order,
                    cache=False).arena
        self._plans[key] = plan
        while len(self._plans) > self._max_plans:
            self._plans.popitem(last=False)
        return key, plan

    def register_pareto(self, key: str,
                        plans_by_class: dict[str, ArenaPlan]) -> None:
        """Register per-request-class Pareto plans under ``key``.

        ``plans_by_class`` maps class names (e.g. ``'latency'``,
        ``'memory'`` — see :func:`pareto_class_plans`) to the arena plans
        of the frontier points those classes should lease.  A later
        ``submit(..., klass=k)`` for ``key`` leases ``plans_by_class[k]``,
        cached (and warm-buffered) under the derived key ``f"{key}@{k}"``
        so differently sized class arenas never share warm buffers.
        """
        if not plans_by_class:
            raise PoolError(f"register_pareto({key!r}): no class plans")
        for klass, plan in plans_by_class.items():
            if not klass or not isinstance(klass, str):
                raise PoolError(
                    f"register_pareto({key!r}): bad class name {klass!r}")
            if not isinstance(plan, ArenaPlan):
                raise PoolError(
                    f"register_pareto({key!r}): class {klass!r} plan is "
                    f"{type(plan).__name__}, not ArenaPlan")
        self._pareto[key] = dict(plans_by_class)

    def pareto_classes(self, key: str) -> tuple[str, ...]:
        """Class names registered for ``key`` ('' when none)."""
        return tuple(self._pareto.get(key, ()))

    def warm(self, graph: Graph, order: Sequence[int] | None = None,
             *, key: str | None = None, plan: ArenaPlan | None = None) -> str:
        """Pre-plan ``graph`` and pre-allocate a warm buffer for its shape.

        Startup warming: a later ``submit`` for the same key skips both the
        planning and the allocation.  Returns the plan key.
        """
        key, plan = self.plan(graph, order, key=key, plan=plan)
        if self._alloc_fn is not None:
            _, extent = resident_bytes(plan)
            self._put_warm(key, self._alloc_fn(extent))
        return key

    # -- admission ---------------------------------------------------------

    def submit(self, graph: Graph, order: Sequence[int] | None = None,
               *, key: str | None = None,
               plan: ArenaPlan | None = None,
               klass: str | None = None,
               priority: int = 0,
               tenant: str | None = None) -> Ticket:
        """Request a lease: admit now, queue, or reject outright.

        Returns a :class:`Ticket`; ``ticket.lease`` is set immediately when
        the request fits the remaining budget and nothing is queued ahead
        of it, ``ticket.rejected`` when the plan alone can never fit (the
        global budget or the tenant's quota — ``reason_code`` says which).

        ``klass`` selects a request class previously registered for the
        key via :meth:`register_pareto` — the lease then covers that
        class's Pareto-point plan instead of the base plan.  Submitting an
        unregistered class (or a class for an unregistered key) raises
        :class:`PoolError` rather than silently downgrading the request.

        ``priority`` orders preemption, not admission: the queue stays
        FIFO, but when the degradation ladder must evict a lease it picks
        the lowest-priority one (:meth:`preempt_candidate`).  ``tenant``
        charges the lease against that tenant's byte quota when one is
        configured.
        """
        self.stats.submitted += 1
        if klass is not None:
            if plan is not None:
                raise PoolError("submit: pass either plan= or klass=, "
                                "not both", code="bad_args")
            if key is None:
                key = labeled_fingerprint(graph)
            by_class = self._pareto.get(key)
            if by_class is None:
                raise PoolError(
                    f"submit: no Pareto classes registered for key "
                    f"{key!r} (call register_pareto first)",
                    code="no_pareto_classes")
            if klass not in by_class:
                raise PoolError(
                    f"submit: unknown request class {klass!r} for key "
                    f"{key!r}; registered: {sorted(by_class)}",
                    code="unknown_class")
            plan = by_class[klass]
            key = f"{key}@{klass}"
        key, plan = self.plan(graph, order, key=key, plan=plan)
        ticket = Ticket(rid=next(self._rid), key=key, klass=klass,
                        priority=priority, tenant=tenant)
        # reject iff the request could not be admitted even into an EMPTY
        # pool — evaluated with the same accounting `_fits` uses, so a
        # queued request is always eventually admissible (no queue deadlock)
        if self._reject_never_fits(ticket, plan):
            return ticket
        self._queue.append((ticket, plan))
        self.stats.peak_queued = max(self.stats.peak_queued, len(self._queue))
        self._drain()
        return ticket

    def _reject_never_fits(self, ticket: Ticket, plan: ArenaPlan) -> bool:
        """Mark ``ticket`` rejected when ``plan`` can never be admitted —
        even into an empty pool — under the current budget/quotas."""
        alone = self._joint_extent([plan])
        if alone > self.budget_bytes:
            ticket.rejected = True
            ticket.reason_code = "budget"
            ticket.reason = (
                f"plan needs {alone} bytes alone; budget is "
                f"{self.budget_bytes}")
            self.stats.rejected += 1
            return True
        quota = self.tenant_quotas.get(ticket.tenant)
        if quota is not None and alone > quota:
            ticket.rejected = True
            ticket.reason_code = "tenant_quota"
            ticket.reason = (
                f"plan needs {alone} bytes alone; tenant "
                f"{ticket.tenant!r} quota is {quota}")
            self.stats.rejected += 1
            return True
        return False

    def release(self, lease: Lease) -> None:
        """Return a lease's bytes to the pool and drain the queue."""
        if lease._released:
            raise LeaseError(f"lease {lease.rid} ({lease.key}) already "
                             f"released (double free)", code="double_free")
        try:
            self._members.remove(lease)
        except ValueError:
            raise LeaseError(
                f"lease {lease.rid} ({lease.key}) is not held by this pool",
                code="foreign_lease") from None
        lease._released = True
        self.stats.released += 1
        if lease.buffer is not None:
            self._put_warm(lease.key, lease.buffer)
            lease.buffer = None
        self._drain()

    def poll(self) -> list[Ticket]:
        """Tickets newly admitted since the last poll, in FIFO order."""
        out = self._admitted_since_poll
        self._admitted_since_poll = []
        return out

    def poll_rejected(self) -> list[Ticket]:
        """Queued tickets rejected *after* submit (a budget-shrink sweep);
        submit-time rejections are returned on the ticket itself."""
        out = self._rejected_since_poll
        self._rejected_since_poll = []
        return out

    @property
    def pending_admissions(self) -> int:
        """Admitted tickets not yet collected by :meth:`poll`."""
        return len(self._admitted_since_poll)

    @property
    def queued_tickets(self) -> tuple[Ticket, ...]:
        """The waiting queue, head first (tickets only, FIFO order)."""
        return tuple(t for t, _ in self._queue)

    def queue_report(self) -> list[dict]:
        """Structured per-queued-request diagnostics (DESIGN.md §13):
        rid, class, priority, tenant and the current ``_fits`` failure
        reason — what the serving watchdog logs on stall escalation."""
        return [
            {"rid": t.rid, "klass": t.klass, "priority": t.priority,
             "tenant": t.tenant,
             "why": self.why_not_admitted(p, t.tenant) or "admissible"}
            for t, p in self._queue
        ]

    # -- budget + preemption (DESIGN.md §13) --------------------------------

    def set_budget(self, nbytes: int) -> int:
        """Change the global budget mid-flight; returns the overflow bytes.

        On a *grow* (or no-op) the queue simply re-drains.  On a *shrink*
        the queue is swept first: waiting tickets the new budget (or the
        tenant quota) can never fit are rejected with
        ``reason_code='budget_shrunk'`` and surface through
        :meth:`poll_rejected` — otherwise they would deadlock the FIFO
        head.  The returned overflow (``reserved - budget``, floored at 0)
        is what the caller's degradation ladder must recover by
        preemption; the pool never evicts admitted leases on its own.
        """
        nbytes = int(nbytes)
        if nbytes < 0:
            raise PoolError(f"negative budget {nbytes}", code="bad_budget",
                            requested_bytes=nbytes)
        shrink = nbytes < self.budget_bytes
        self.budget_bytes = nbytes
        if shrink:
            self.preemption_stats.budget_shrinks += 1
            keep: collections.deque = collections.deque()
            for ticket, plan in self._queue:
                alone = self._joint_extent([plan])
                quota = self.tenant_quotas.get(ticket.tenant)
                if alone > nbytes or (quota is not None and alone > quota):
                    ticket.rejected = True
                    ticket.reason_code = "budget_shrunk"
                    ticket.reason = (
                        f"budget shrank to {nbytes} bytes; queued plan "
                        f"needs {alone} alone")
                    self.stats.rejected += 1
                    self.preemption_stats.budget_evictions += 1
                    self._rejected_since_poll.append(ticket)
                else:
                    keep.append((ticket, plan))
            self._queue = keep
        over = self.reserved_bytes - nbytes
        if over <= 0:
            self._drain()
        return max(0, over)

    def preempt_candidate(self) -> Lease | None:
        """The lease preemption should evict next: lowest priority first,
        youngest (highest rid) among ties — the least-progressed work of
        the least-important class.  ``None`` when the pool holds nothing."""
        if not self._members:
            return None
        return min(self._members, key=lambda m: (m.priority, -m.rid))

    def preempt(self, lease: Lease, state: object | None = None) -> SpilledLease:
        """Evict ``lease``: spill its resident bytes to host, free its
        arena bytes, and return a :class:`SpilledLease` for later
        :meth:`readmit`.

        ``state`` is the buffer currently holding the lease's packed
        resident state (the serving loop moves buffer ownership onto the
        request after admission, so it must hand the live arena back);
        when ``None`` the lease's own ``buffer`` is spilled, and when that
        is also ``None`` (accounting-only pools) the spill carries no
        bytes, just the admission slot.  The freed bytes drain the queue
        immediately.
        """
        if lease._released:
            raise LeaseError(
                f"lease {lease.rid} ({lease.key}) already released "
                f"(double free)", code="double_free")
        try:
            self._members.remove(lease)
        except ValueError:
            raise LeaseError(
                f"lease {lease.rid} ({lease.key}) is not held by this pool",
                code="foreign_lease") from None
        lease._released = True
        src = state if state is not None else lease.buffer
        host = None
        if src is not None:
            # a tensor by an explicit device-to-host copy (np.asarray of a
            # CUDA tensor raises); the fleet's simulated state is numpy
            if hasattr(src, "detach"):
                src = src.detach().cpu().numpy()
            host = np.array(src, dtype=np.uint8, copy=True)
        lease.buffer = None
        spill_bytes = int(host.nbytes) if host is not None \
            else lease.resident_extent
        ps = self.preemption_stats
        ps.preemptions += 1
        ps.spilled_bytes += spill_bytes
        self._drain()
        return SpilledLease(
            rid=lease.rid, key=lease.key, plan=lease.plan,
            spill_bytes=spill_bytes, host_state=host,
            klass=lease.key.rsplit("@", 1)[1] if "@" in lease.key else None,
            priority=lease.priority, tenant=lease.tenant)

    def downgrade(self, spilled: SpilledLease, klass: str) -> None:
        """Re-point a spilled lease at another registered Pareto class —
        the ladder's rung-1 move: a preempted ``latency`` request re-admits
        at its ``memory``-optimal point (same offsets layout, smaller
        admission charge)."""
        base = spilled.key.rsplit("@", 1)[0]
        by_class = self._pareto.get(base)
        if by_class is None or klass not in by_class:
            raise PoolError(
                f"downgrade: no class {klass!r} registered for {base!r}",
                code="unknown_class")
        spilled.plan = by_class[klass]
        spilled.key = f"{base}@{klass}"
        spilled.klass = klass

    def readmit(self, spilled: SpilledLease) -> Ticket:
        """One re-admission attempt for a spilled lease.

        Unlike :meth:`submit` this does **not** join the FIFO queue: a
        preempted request was admitted before anything now waiting, so it
        re-enters ahead of the queue iff its bytes fit *right now* —
        otherwise the returned ticket is neither admitted nor queued and
        the caller backs off (:meth:`SpilledLease.backoff`) and retries.
        A spill the shrunk budget/quota can never fit again is rejected
        outright (``reason_code='budget'``/``'tenant_quota'``).  The
        caller rebuilds the request's device state from
        ``spilled.host_state`` once the returned ticket admits.
        """
        ps = self.preemption_stats
        ps.readmit_attempts += 1
        ticket = Ticket(rid=next(self._rid), key=spilled.key,
                        klass=spilled.klass, priority=spilled.priority,
                        tenant=spilled.tenant)
        if self._reject_never_fits(ticket, spilled.plan):
            ps.readmit_rejections += 1
            return ticket
        if self.admission_hook is not None and self.admission_hook():
            ps.admission_faults += 1
            return ticket                       # transient: retry later
        if not self._fits(spilled.plan, spilled.tenant):
            return ticket                       # no bytes yet: retry later
        self._admit(ticket, spilled.plan)
        ps.readmitted += 1
        return ticket

    # -- accounting --------------------------------------------------------

    @property
    def leases(self) -> tuple[Lease, ...]:
        return tuple(self._members)

    @property
    def queue_len(self) -> int:
        return len(self._queue)

    @property
    def queued_bytes(self) -> int:
        """Standalone bytes the waiting queue will eventually charge — the
        load a router should count against this pool beyond
        ``reserved_bytes`` when ranking shards by projected occupancy."""
        return sum(self._joint_extent([p]) for _, p in self._queue)

    @property
    def reserved_bytes(self) -> int:
        """Joint bytes the current admitted set (plus any transient scratch
        reservation) charges to the budget."""
        return self._joint_extent([m.plan for m in self._members]) \
            + self._scratch_bytes

    @property
    def scratch_bytes(self) -> int:
        return self._scratch_bytes

    def reserve_scratch(self, nbytes: int) -> ScratchReservation:
        """Reserve transient scratch bytes; returns a release token.

        For execution-side allocations that are not leases but still occupy
        device memory alongside the admitted set — e.g. the padding rows a
        bucketed vmap decode materializes beyond the active batch, or a
        prefill chunk's workspace.  Each call is an *independent*
        reservation: the returned :class:`ScratchReservation` releases only
        its own bytes (``token.release()`` or :meth:`release_scratch`), so
        two concurrent reservers never clobber each other.  All live
        reservations are charged by ``_fits``, so queued requests cannot be
        admitted into bytes scratch is using.  Raises :class:`PoolError`
        when the new reservation does not fit over the current members plus
        existing scratch; releasing always succeeds — the degradation
        ladder depends on shedding scratch even after a budget shrink has
        left the members alone over budget.
        """
        nbytes = int(nbytes)
        if nbytes < 0:
            raise PoolError(f"negative scratch reservation {nbytes}",
                            code="bad_scratch", requested_bytes=nbytes)
        if nbytes > 0:
            joint = self._joint_extent([m.plan for m in self._members])
            held = self._scratch_bytes
            if joint + held + nbytes > self.budget_bytes:
                raise PoolError(
                    f"scratch reservation of {nbytes} bytes does not fit: "
                    f"members reserve {joint} (+{held} scratch) of "
                    f"{self.budget_bytes} budget bytes",
                    code="scratch_overflow", requested_bytes=nbytes,
                    budget_bytes=self.budget_bytes, reserved_bytes=joint + held,
                    queue_depth=len(self._queue))
        token = ScratchReservation(sid=next(self._scratch_sid),
                                   nbytes=nbytes, _pool=self)
        self._scratch[token.sid] = token
        self._scratch_bytes += nbytes
        self.stats.peak_reserved_bytes = max(self.stats.peak_reserved_bytes,
                                             self.reserved_bytes)
        return token

    def release_scratch(self, token: ScratchReservation) -> None:
        """Release one scratch reservation and drain the queue.

        Always succeeds for a live token of this pool (shedding scratch
        must work even when a budget shrink left the pool over budget).
        Raises :class:`PoolError` on a double release
        (``code='scratch_double_release'``) or a token from another pool
        (``code='foreign_scratch'``).
        """
        if token.released:
            raise PoolError(
                f"scratch reservation {token.sid} ({token.nbytes} bytes) "
                f"already released (double free)",
                code="scratch_double_release", requested_bytes=token.nbytes)
        if token._pool is not self or self._scratch.pop(token.sid, None) is None:
            raise PoolError(
                f"scratch reservation {token.sid} is not held by this pool",
                code="foreign_scratch", requested_bytes=token.nbytes)
        token.released = True
        if self._legacy_scratch is token:
            self._legacy_scratch = None
        self._scratch_bytes -= token.nbytes
        self._drain()

    def reserve_scratch_absolute(self, nbytes: int) -> None:
        """Deprecated absolute-valued scratch API (pre-token shim).

        Replaces any previous *absolute* reservation with ``nbytes`` (pass
        0 to release), exactly like the old ``reserve_scratch`` — but
        implemented as a single pool-owned token, so it composes with (and
        cannot clobber) token-based reservations held by other callers.
        Migrate to ``token = reserve_scratch(n)`` / ``token.release()``.
        """
        warnings.warn(
            "reserve_scratch_absolute is deprecated; use "
            "reserve_scratch(n) -> token and token.release()",
            DeprecationWarning, stacklevel=2)
        nbytes = int(nbytes)
        if nbytes < 0:
            raise PoolError(f"negative scratch reservation {nbytes}",
                            code="bad_scratch", requested_bytes=nbytes)
        prev = self._legacy_scratch
        prev_bytes = prev.nbytes if prev is not None else 0
        if nbytes > prev_bytes:
            joint = self._joint_extent([m.plan for m in self._members])
            others = self._scratch_bytes - prev_bytes
            if joint + others + nbytes > self.budget_bytes:
                raise PoolError(
                    f"scratch reservation of {nbytes} bytes does not fit: "
                    f"members reserve {joint} (+{others} scratch) of "
                    f"{self.budget_bytes} budget bytes",
                    code="scratch_overflow", requested_bytes=nbytes,
                    budget_bytes=self.budget_bytes,
                    reserved_bytes=joint + others,
                    queue_depth=len(self._queue))
        if prev is not None:
            del self._scratch[prev.sid]
            prev.released = True
            self._scratch_bytes -= prev_bytes
            self._legacy_scratch = None
        if nbytes > 0:
            token = ScratchReservation(sid=next(self._scratch_sid),
                                       nbytes=nbytes, _pool=self)
            self._scratch[token.sid] = token
            self._scratch_bytes += nbytes
            self._legacy_scratch = token
        self.stats.peak_reserved_bytes = max(self.stats.peak_reserved_bytes,
                                             self.reserved_bytes)
        if nbytes < prev_bytes:
            self._drain()

    def shared_plan(self) -> SharedArenaPlan:
        """Co-residency plan of the currently admitted members."""
        return plan_shared_arena([m.plan for m in self._members],
                                 serialize=self.overlap == "serial")

    def _joint_extent(self, plans: list[ArenaPlan]) -> int:
        if not plans:
            return 0
        if self.overlap == "none":
            return sum(p.arena_bytes for p in plans)
        return plan_shared_arena(plans).arena_bytes

    def tenant_usage(self, tenant: str | None) -> int:
        """Joint-alone bytes ``tenant``'s admitted leases charge its quota."""
        return sum(self._joint_extent([m.plan]) for m in self._members
                   if m.tenant == tenant)

    def _fits(self, plan: ArenaPlan, tenant: str | None = None) -> bool:
        joint = self._joint_extent([m.plan for m in self._members] + [plan])
        if joint + self._scratch_bytes > self.budget_bytes:
            return False
        quota = self.tenant_quotas.get(tenant)
        if quota is not None and \
                self.tenant_usage(tenant) + self._joint_extent([plan]) > quota:
            return False
        return True

    def why_not_admitted(self, plan: ArenaPlan,
                         tenant: str | None = None) -> str:
        """Human-readable reason :meth:`_fits` currently fails for ``plan``
        ('' when it would fit) — the per-request diagnostic the serving
        watchdog puts in its stall report (DESIGN.md §13)."""
        joint = self._joint_extent([m.plan for m in self._members] + [plan])
        if joint + self._scratch_bytes > self.budget_bytes:
            return (f"needs {joint} joint bytes"
                    + (f" (+{self._scratch_bytes} scratch)"
                       if self._scratch_bytes else "")
                    + f" over {self.budget_bytes} budget")
        quota = self.tenant_quotas.get(tenant)
        if quota is not None:
            used = self.tenant_usage(tenant)
            charge = self._joint_extent([plan])
            if used + charge > quota:
                return (f"tenant {tenant!r} at {used} of {quota} quota "
                        f"bytes; lease charges {charge}")
        return ""

    def _fits_globally(self, plan: ArenaPlan) -> bool:
        joint = self._joint_extent([m.plan for m in self._members] + [plan])
        return joint + self._scratch_bytes <= self.budget_bytes

    def _drain(self) -> None:
        # FIFO with head-of-line blocking on *bytes*: later (smaller)
        # requests never jump an earlier one still waiting for budget
        # bytes.  An entry waiting only on its own tenant's quota does NOT
        # block other tenants behind it — quota exhaustion is private to
        # the tenant, so the drain skips it and keeps scanning.
        progressed = True
        while progressed:
            progressed = False
            for i, (ticket, plan) in enumerate(self._queue):
                if not self._fits_globally(plan):
                    return                     # head-of-line on bytes
                if not self._fits(plan, ticket.tenant):
                    continue                   # tenant-quota blocked: skip
                if self.admission_hook is not None and self.admission_hook():
                    # injected transient admission failure: leave the
                    # entry queued; a later kick()/release retries
                    self.preemption_stats.admission_faults += 1
                    return
                del self._queue[i]
                self._admit(ticket, plan)
                progressed = True
                break

    def kick(self) -> None:
        """Retry queued admissions (e.g. after a transient admission fault
        suppressed a drain, or a budget grow)."""
        self._drain()

    def _admit(self, ticket: Ticket, plan: ArenaPlan) -> None:
        pbytes, extent = resident_bytes(plan)
        buffer = self._take_warm(ticket.key)
        if buffer is None and self._alloc_fn is not None:
            buffer = self._alloc_fn(extent)
        lease = Lease(
            rid=ticket.rid,
            key=ticket.key,
            plan=plan,
            arena_bytes=plan.arena_bytes,
            persistent_bytes=pbytes,
            resident_extent=extent,
            buffer=buffer,
            priority=ticket.priority,
            tenant=ticket.tenant,
        )
        self._members.append(lease)
        ticket.lease = lease
        self._admitted_since_poll.append(ticket)
        self.stats.admitted += 1
        if ticket.klass is not None:
            self.stats.admitted_by_class[ticket.klass] = \
                self.stats.admitted_by_class.get(ticket.klass, 0) + 1
        self.stats.max_concurrent = max(self.stats.max_concurrent,
                                        len(self._members))
        self.stats.peak_reserved_bytes = max(self.stats.peak_reserved_bytes,
                                             self.reserved_bytes)

    # -- warm-buffer LRU ---------------------------------------------------

    def _put_warm(self, key: str, buffer: object) -> None:
        if buffer is None:
            return
        self._warm[next(self._wid)] = (key, buffer)
        while len(self._warm) > self.max_warm:
            self._warm.popitem(last=False)
            self.stats.evictions += 1

    def _take_warm(self, key: str):
        for wid, (k, buf) in self._warm.items():
            if k == key:
                del self._warm[wid]
                self.stats.warm_hits += 1
                return buf
        return None
