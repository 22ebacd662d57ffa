"""Offset allocation: packing tensor lifetimes into one linear arena.

The paper's evaluation (Fig. 12a) measures footprint *through the allocator*:
tensors get byte offsets in one linear arena; the arena's high watermark is
the reported peak.  The DP scheduler optimizes the liveness-sum peak
(``peak_bytes``), but the bytes an edge device actually reserves are the
allocator watermark (``arena_bytes``) — fragmentation can push the latter
above the former, so the planner here runs several placement policies per
graph and keeps the tightest plan (DESIGN.md §5):

``first_fit``
    TFLite's ``SimpleMemoryArena``: allocate in schedule order at the lowest
    offset that fits between currently live allocations.
``best_fit`` / ``best_fit_coalesce``
    Allocate in schedule order into the tightest free gap (free gaps
    coalesce as neighbours die); falls back to the arena top when no gap
    fits.
``greedy_by_size``
    TFLite's ``GreedyBySizeMemoryPlanner``: place buffers in decreasing size
    order, each at the lowest offset that overlaps no temporally-conflicting
    already-placed buffer.  Usually the tightest heuristic; O(n^2), so
    ``plan_arena_best`` skips it above ``_GREEDY_BY_SIZE_MAX`` buffers.
``best``
    All of the above (plus exhaustive search on tiny plans) — keep the
    smallest arena.

The schedule-order policies run as an event-driven sweep over lifetime
intervals: a heap of expiry times retires dead allocations into a sorted,
coalescing free-gap list, so each placement costs O(log n + live gaps)
instead of the former rebuild-and-sort over the whole live set.  That is
what makes planning a 10k-buffer serving arena a milliseconds affair (see
``bench_scheduling_time``'s arena rows).

Alias chains (in-place rewiring from the graph rewriter and the elementwise
in-place pass) share one buffer: the union of the members' live intervals,
sized by the largest member.
"""

from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
from typing import Literal, Sequence

from repro_torch.core.graph import Graph

_GREEDY_BY_SIZE_MAX = 4096     # above this, greedy_by_size's O(n^2) is skipped
_EXHAUSTIVE_MAX = 6            # permutation search bound for tiny plans

Policy = Literal[
    "first_fit", "best_fit", "best_fit_coalesce", "greedy_by_size", "best"
]


@dataclasses.dataclass
class Allocation:
    """One packed buffer: an alias chain's shared storage inside the arena.

    All fields are in *bytes* (offsets/sizes) or *schedule indices* (times).

    ``intra`` maps a member node id to its byte delta inside this buffer:
    members of an accumulating/in-place chain overwrite the buffer verbatim
    (delta 0), while ``concat_view`` parts live back-to-back at cumulative
    deltas in the view's predecessor order.  ``Allocation.offset + intra[n]``
    is therefore the exact first byte of node ``n``'s output — the address
    the executor reads and writes (DESIGN.md §6).
    """

    node_ids: list[int]       # members of the alias chain sharing this buffer
    offset: int
    size: int
    t_alloc: int              # schedule index of first allocation
    t_free: int               # schedule index after last use (exclusive)
    intra: dict[int, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ArenaPlan:
    allocations: list[Allocation]
    arena_bytes: int          # high watermark == required arena size
    policy: str = "first_fit"
    peak_bytes: int = 0       # max overlapped live bytes: packing lower bound

    def offset_of(self, node_id: int) -> int:
        """Exact byte offset of ``node_id``'s output storage in the arena.

        Alias-aware: for a node that shares its chain's buffer this is the
        chain offset plus the node's intra-buffer delta (0 for in-place
        members, the cumulative slice start for ``concat_view`` parts), so
        the executor can address every tensor — including the parts of a
        never-materialized concat — directly.  Raises ``KeyError`` for a
        node id absent from the plan.
        """
        self._ensure_index()
        a = self._index[node_id]
        return a.offset + a.intra.get(node_id, 0)

    def allocation_of(self, node_id: int) -> Allocation:
        """The (possibly shared) :class:`Allocation` backing ``node_id``."""
        self._ensure_index()
        return self._index[node_id]

    def _ensure_index(self) -> None:
        if self.__dict__.get("_index") is None:
            index = {}
            for a in self.allocations:
                for nid in a.node_ids:
                    index[nid] = a
            self._index = index

    def __getstate__(self):
        # derived caches: the offset index is cheap to rebuild, and compiled
        # executor programs (repro_torch.core.executor.compile_plan memoizes
        # them on the plan) are bound to a device and must never hit the
        # plan cache's pickled disk tier
        state = dict(self.__dict__)
        state.pop("_index", None)
        state.pop("_programs", None)
        return state

    @property
    def frag_ratio(self) -> float:
        """arena_bytes / peak_bytes — 1.0 means a fragmentation-free packing."""
        return self.arena_bytes / max(self.peak_bytes, 1)


# ---------------------------------------------------------------------------
# Lifetime intervals
# ---------------------------------------------------------------------------


def _build_items(
    g: Graph,
    order: Sequence[int],
    preplaced: Sequence[int],
    steps: Sequence[Sequence[int]] | None = None,
) -> list[Allocation]:
    """Alias-chain-merged lifetime intervals, in schedule-allocation order.

    With ``steps`` (a width-W step schedule whose flattening is ``order``),
    lifetimes are in *step* indices: co-issued nodes share ``t_alloc``, so
    every packing policy necessarily places their outputs disjointly — the
    arena-level meaning of concurrency (DESIGN.md §12).
    """
    n = len(g)
    if steps is not None:
        pos = {u: si for si, step in enumerate(steps) for u in step}
        if [u for step in steps for u in step] != list(order):
            raise ValueError("steps do not flatten to order")
    else:
        pos = {u: i for i, u in enumerate(order)}
    for p in preplaced:
        pos[p] = -1

    # union alias chains into storage roots
    root = list(range(n))

    def find(x: int) -> int:
        while root[x] != x:
            root[x] = root[root[x]]
            x = root[x]
        return x

    for u in order:
        for p in g.nodes[u].alias_preds:
            root[find(p)] = find(u)

    members: dict[int, list[int]] = {}
    for u in list(preplaced) + list(order):
        members.setdefault(find(u), []).append(u)

    horizon = len(order) if steps is None else len(steps)
    items: list[Allocation] = []
    for mem in members.values():
        t_alloc = min(pos[m] for m in mem)
        last_use = t_alloc
        is_output = False
        for m in mem:
            consumers = [s for s in g.succs[m] if s in pos]
            if not consumers:
                is_output = True
            for s in consumers:
                last_use = max(last_use, pos[s])
        t_free = horizon + 1 if is_output else last_use + 1
        size = max(g.sizes[m] for m in mem)
        items.append(Allocation([*sorted(mem)], -1, size, t_alloc, t_free,
                                intra=_chain_intra_offsets(g, mem, pos)))
    items.sort(key=lambda a: (a.t_alloc, -a.size, a.node_ids))
    return items


def _chain_intra_offsets(
    g: Graph, members: list[int], pos: dict[int, int]
) -> dict[int, int]:
    """Byte deltas of each chain member inside the shared buffer.

    Walking members in reverse schedule order, the chain's final node sits at
    delta 0; an in-place/accumulating alias inherits its consumer's delta
    (same bytes, overwritten), and ``concat_view`` parts are laid out
    back-to-back in the view's predecessor order starting at the view's own
    delta — which is what lets rewritten graphs execute the concat as pure
    slice-writes, never materializing it.
    """
    if len(members) <= 1:
        return {}
    intra: dict[int, int] = {}
    for m in sorted(members, key=lambda u: pos[u], reverse=True):
        base = intra.setdefault(m, 0)
        nd = g.nodes[m]
        if nd.op == "concat_view":
            cum = 0
            for p in nd.preds:
                if p in nd.alias_preds:
                    intra[p] = base + cum
                    cum += g.sizes[p]
        else:
            for p in nd.alias_preds:
                intra[p] = base
    return intra


def _interval_peak(items: Sequence[Allocation]) -> int:
    """Max overlapped live bytes — the lower bound any packing must respect.

    Frees at time t happen before allocations at t (matching the placement
    policies, which retire ``t_free <= t_alloc`` before placing).
    """
    events: list[tuple[int, int, int]] = []
    for it in items:
        events.append((it.t_alloc, 1, it.size))    # frees (kind 0) sort first
        events.append((it.t_free, 0, -it.size))
    events.sort()
    live = peak = 0
    for _, _, delta in events:
        live += delta
        peak = max(peak, live)
    return peak


# ---------------------------------------------------------------------------
# Schedule-order policies: event-driven sweep over a coalescing free list
# ---------------------------------------------------------------------------


class _GapList:
    """Sorted, coalescing free-gap list below a movable arena top.

    Bytes in ``[0, top)`` are either inside a gap or occupied; everything at
    and above ``top`` is free.  Freeing the block just below ``top`` lowers
    ``top`` (after coalescing with an adjacent gap).
    """

    def __init__(self) -> None:
        self.off: list[int] = []      # gap start offsets, sorted
        self.len: list[int] = []      # parallel gap lengths
        self.top = 0

    def free(self, offset: int, size: int) -> None:
        i = bisect.bisect_left(self.off, offset)
        # coalesce with left neighbour
        if i > 0 and self.off[i - 1] + self.len[i - 1] == offset:
            i -= 1
            self.len[i] += size
        else:
            self.off.insert(i, offset)
            self.len.insert(i, size)
        # coalesce with right neighbour
        if i + 1 < len(self.off) and \
                self.off[i] + self.len[i] == self.off[i + 1]:
            self.len[i] += self.len[i + 1]
            del self.off[i + 1], self.len[i + 1]
        # retire into the open top region
        if self.off[i] + self.len[i] == self.top:
            self.top = self.off[i]
            del self.off[i], self.len[i]

    def place(self, size: int, tight: bool) -> int:
        """Claim ``size`` bytes: first fitting gap (or tightest, if asked)."""
        pick = -1
        if tight:
            best_len = -1
            for i, ln in enumerate(self.len):
                if ln >= size and (best_len < 0 or ln < best_len):
                    pick, best_len = i, ln
        else:
            for i, ln in enumerate(self.len):
                if ln >= size:
                    pick = i
                    break
        if pick < 0:
            offset = self.top
            self.top += size
            return offset
        offset = self.off[pick]
        if self.len[pick] == size:
            del self.off[pick], self.len[pick]
        else:
            self.off[pick] += size
            self.len[pick] -= size
        return offset


def _sweep_pack(items: Sequence[Allocation], tight: bool) -> int:
    """Place ``items`` (schedule order) via the event-driven gap sweep."""
    gaps = _GapList()
    expiry: list[tuple[int, int, int]] = []      # (t_free, offset, size)
    watermark = 0
    for it in items:
        while expiry and expiry[0][0] <= it.t_alloc:
            _, off, sz = heapq.heappop(expiry)
            gaps.free(off, sz)
        it.offset = gaps.place(it.size, tight)
        heapq.heappush(expiry, (it.t_free, it.offset, it.size))
        watermark = max(watermark, it.offset + it.size)
    return watermark


def _greedy_by_size_pack(items: Sequence[Allocation]) -> int:
    """TFLite greedy-by-size: biggest buffers first, first fit by offset
    against temporally-conflicting placed buffers."""
    by_size = sorted(
        range(len(items)),
        key=lambda i: (-items[i].size, items[i].t_alloc, items[i].node_ids),
    )
    placed_off: list[int] = []          # offsets of placed items, sorted
    placed: list[Allocation] = []       # parallel to placed_off
    watermark = 0
    for i in by_size:
        it = items[i]
        cursor = 0
        offset = None
        for a in placed:
            if a.t_free <= it.t_alloc or it.t_free <= a.t_alloc:
                continue                 # no lifetime overlap
            if a.offset - cursor >= it.size:
                offset = cursor
                break
            cursor = max(cursor, a.offset + a.size)
        it.offset = cursor if offset is None else offset
        j = bisect.bisect_left(placed_off, it.offset)
        placed_off.insert(j, it.offset)
        placed.insert(j, it)
        watermark = max(watermark, it.offset + it.size)
    return watermark


def _exhaustive_pack(items: Sequence[Allocation], stop_at: int) -> int:
    """Best watermark over all placement orders (tiny plans only).

    Each permutation is packed conflict-first-fit (the greedy_by_size
    placement rule under an arbitrary order).  Early-exits when ``stop_at``
    (the interval peak — unbeatable) is reached.  Offsets of ``items`` hold
    the best packing found on return.
    """
    k = len(items)
    best = None
    best_offsets = [0] * k
    for perm in itertools.permutations(range(k)):
        placed: list[Allocation] = []
        watermark = 0
        for i in perm:
            it = items[i]
            cursor = 0
            offset = None
            for a in sorted(placed, key=lambda a: a.offset):
                if a.t_free <= it.t_alloc or it.t_free <= a.t_alloc:
                    continue
                if a.offset - cursor >= it.size:
                    offset = cursor
                    break
                cursor = max(cursor, a.offset + a.size)
            it.offset = cursor if offset is None else offset
            placed.append(it)
            watermark = max(watermark, it.offset + it.size)
            if best is not None and watermark >= best:
                break
        else:
            if best is None or watermark < best:
                best = watermark
                best_offsets = [it.offset for it in items]
                if best <= stop_at:
                    break
    for it, off in zip(items, best_offsets):
        it.offset = off
    return best if best is not None else 0


_PACKERS = {
    "first_fit": lambda items: _sweep_pack(items, tight=False),
    "best_fit": lambda items: _sweep_pack(items, tight=True),
    "greedy_by_size": _greedy_by_size_pack,
}
# documented synonym: the sweep's free gaps always coalesce, so best_fit
# *is* best_fit_coalesce
_ALIASES = {"best_fit_coalesce": "best_fit"}


def _packer_for(policy: str):
    try:
        return _PACKERS[_ALIASES.get(policy, policy)]
    except KeyError:
        raise ValueError(f"unknown arena policy {policy!r}") from None


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------


def plan_arena(
    g: Graph,
    order: Sequence[int],
    preplaced: Sequence[int] = (),
    policy: Policy = "first_fit",
    steps: Sequence[Sequence[int]] | None = None,
) -> ArenaPlan:
    """Pack the tensors of schedule ``order`` into one linear arena.

    ``policy='best'`` delegates to :func:`plan_arena_best` (all policies,
    keep the tightest arena).  ``steps`` switches lifetimes to width-W step
    indices (see :func:`_build_items`): co-issued outputs pack disjointly.
    """
    if policy == "best":
        return plan_arena_best(g, order, preplaced=preplaced, steps=steps)
    packer = _packer_for(policy)
    items = _build_items(g, order, preplaced, steps=steps)
    watermark = packer(items)
    return ArenaPlan(
        allocations=items,
        arena_bytes=watermark,
        policy=policy,
        peak_bytes=_interval_peak(items),
    )


def plan_arena_best(
    g: Graph,
    order: Sequence[int],
    preplaced: Sequence[int] = (),
    policies: Sequence[str] = ("first_fit", "best_fit", "greedy_by_size"),
    steps: Sequence[Sequence[int]] | None = None,
) -> ArenaPlan:
    """Run every candidate policy and keep the smallest arena.

    Ties go to the earlier policy in ``policies``; the cheap O(n log n)
    sweep policies run first, and the loop stops as soon as a plan matches
    the interval-peak lower bound (nothing can beat it), so the O(n^2)
    ``greedy_by_size`` pass only runs when fragmentation is actually on the
    table.  Plans with at most ``_EXHAUSTIVE_MAX`` buffers additionally
    search all placement orders, so tiny graphs always get a
    fragmentation-free packing when one exists.  ``greedy_by_size`` is
    skipped above ``_GREEDY_BY_SIZE_MAX`` buffers (its O(n^2) placement
    would dominate planning time on serving arenas).

    Args:
      g: the (possibly rewritten) graph whose tensors are being packed.
      order: a topological schedule of ``g``'s node ids; tensor lifetimes
        are derived from positions in this order.
      preplaced: node ids already resident when the schedule starts
        (divide-and-conquer boundary tensors); they occupy arena bytes from
        time 0.
      policies: placement policies to race (see module docstring).
      steps: optional width-W step schedule flattening to ``order``;
        lifetimes switch to step indices so co-issued ops' outputs are
        live simultaneously and therefore packed disjointly.

    Returns:
      An :class:`ArenaPlan` whose ``arena_bytes`` (bytes — the buffer an
      edge device must reserve) is the minimum over the policies tried, with
      ``peak_bytes`` (bytes — the interval-overlap lower bound), the winning
      ``policy`` name, and per-node byte offsets via
      :meth:`ArenaPlan.offset_of`.
    """
    items = _build_items(g, order, preplaced, steps=steps)
    peak = _interval_peak(items)
    best_policy, best_water = _race_pack(items, policies, peak)
    return ArenaPlan(
        allocations=items,
        arena_bytes=best_water,
        policy=best_policy,
        peak_bytes=peak,
    )


def _race_pack(
    items: list[Allocation], policies: Sequence[str], peak: int
) -> tuple[str, int]:
    """Race the placement policies over ``items``; keep the tightest packing.

    On return every item's ``offset`` holds the winning placement.  Stops as
    soon as a policy matches ``peak`` (the interval lower bound — nothing
    can beat it); falls back to the exhaustive permutation search on tiny
    plans.  Returns ``(policy_name, watermark)``.
    """
    best_policy: str | None = None
    best_water = 0
    best_offsets: list[int] = []
    for pol in policies:
        if pol == "greedy_by_size" and len(items) > _GREEDY_BY_SIZE_MAX:
            continue
        water = _packer_for(pol)(items)
        if best_policy is None or water < best_water:
            best_policy, best_water = pol, water
            best_offsets = [it.offset for it in items]
        if best_water <= peak:
            break                      # unbeatable: matches the lower bound
    if best_water > peak and len(items) <= _EXHAUSTIVE_MAX:
        water = _exhaustive_pack(items, stop_at=peak)
        if water < best_water:
            best_policy, best_water = "exhaustive", water
            best_offsets = [it.offset for it in items]
    for it, off in zip(items, best_offsets):
        it.offset = off
    return best_policy or "first_fit", best_water


def plan_arena_regions(
    g: Graph,
    order: Sequence[int],
    resident: Sequence[int],
    preplaced: Sequence[int] = (),
    policies: Sequence[str] = ("first_fit", "best_fit", "greedy_by_size"),
    steps: Sequence[Sequence[int]] | None = None,
) -> ArenaPlan:
    """Two-region arena: ``resident`` tensors at the bottom, the rest on top.

    Serving state (KV caches) must survive *between* schedule executions, so
    its bytes can never be time-shared with the per-step transients — and a
    leased state buffer should cover exactly the resident bytes, with the
    transient scratch stacked above it (DESIGN.md §9).  ``resident`` node
    ids are packed back-to-back in ``[0, P)`` (they all coexist, so the
    cumulative layout is optimal); every other tensor is planned by the
    usual policy race and shifted to ``[P, arena_bytes)``.

    Every ``resident`` node must be a graph output (no consumers): a tensor
    somebody reads *and frees* mid-schedule has no business being pinned.

    Returns an :class:`ArenaPlan` whose ``meta``-free contract matches
    :func:`plan_arena_best`; the resident extent is recoverable as
    ``max(offset + size)`` over the resident allocations (==
    ``sum(sizes)``).
    """
    res_set = set(resident)
    for r in res_set:
        if g.succs[r]:
            raise ValueError(
                f"resident node {r} has consumers {g.succs[r]}; only graph "
                f"outputs (state tensors) can be pinned resident")
    items = _build_items(g, order, preplaced, steps=steps)
    res_items = [it for it in items if set(it.node_ids) & res_set]
    for it in res_items:
        if not set(it.node_ids) <= res_set:
            raise ValueError(
                f"alias chain {it.node_ids} mixes resident and transient "
                f"members")
    trans = [it for it in items if not (set(it.node_ids) & res_set)]
    off = 0
    for it in sorted(res_items, key=lambda a: a.node_ids):
        it.offset = off
        off += it.size
    resident_extent = off
    tpeak = _interval_peak(trans)
    policy, twater = _race_pack(trans, policies, tpeak)
    for it in trans:
        it.offset += resident_extent
    return ArenaPlan(
        allocations=items,
        arena_bytes=resident_extent + twater,
        policy=f"regions+{policy}",
        peak_bytes=_interval_peak(items),
    )


def pin_transients(plan: ArenaPlan) -> ArenaPlan:
    """A copy of ``plan`` with every buffer held until the schedule ends.

    Placement (offsets, ``arena_bytes``) is untouched — the plan stays valid
    for the executor — but no storage is ever reused: the latency-class
    layout serving hands to requests that would rather not pay allocator
    churn, at the cost of ``peak_bytes`` rising to the whole-plan footprint.
    From :func:`resident_bytes`' point of view every allocation becomes
    persistent, so the lease extent equals ``arena_bytes``.
    """
    if not plan.allocations:
        return ArenaPlan([], plan.arena_bytes,
                         policy=f"{plan.policy}+pinned", peak_bytes=0)
    mt = max(a.t_free for a in plan.allocations)
    allocs = [dataclasses.replace(a, t_free=mt, intra=dict(a.intra))
              for a in plan.allocations]
    return ArenaPlan(
        allocations=allocs,
        arena_bytes=plan.arena_bytes,
        policy=f"{plan.policy}+pinned",
        peak_bytes=_interval_peak(allocs),
    )


def resident_bytes(plan: ArenaPlan) -> tuple[int, int]:
    """(resident bytes, resident extent) of ``plan``'s persistent tensors.

    A *persistent* allocation is one holding a graph output: its
    ``t_free`` is the plan-wide maximum (``horizon + 1`` — see
    ``_build_items``), so it survives the whole schedule.  The extent is
    the byte span a lease buffer must cover to hold every persistent tensor
    at its planned offset (== the bytes for a :func:`plan_arena_regions`
    plan, where persistents pack at the bottom).
    """
    if not plan.allocations:
        return 0, 0
    mt = max(a.t_free for a in plan.allocations)
    pers = [a for a in plan.allocations if a.t_free == mt]
    return (sum(a.size for a in pers),
            max(a.offset + a.size for a in pers))


# ---------------------------------------------------------------------------
# Co-residency: K admitted plans sharing one device buffer (DESIGN.md §9)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SharedArenaPlan:
    """K member plans packed into one joint buffer.

    ``members[i]`` is a re-packed copy of the i-th input plan: same
    allocations, same lifetimes, but offsets are *absolute in the joint
    buffer* (so ``members[i].offset_of(node)`` addresses the shared buffer
    directly, and ``members[i].arena_bytes`` is that member's own byte
    extent within it).  ``arena_bytes`` is the joint extent — what the
    device reserves for all K requests together; ``sum_member_bytes`` is
    what K standalone arenas would have reserved.
    """

    members: list[ArenaPlan]
    arena_bytes: int             # joint extent (bytes the device reserves)
    peak_bytes: int              # interval peak on the joint timeline
    sum_member_bytes: int        # sum of the standalone members' extents
    policy: str = "first_fit"
    serialize: bool = True

    @property
    def saved_bytes(self) -> int:
        return self.sum_member_bytes - self.arena_bytes

    def fits(self, budget_bytes: int) -> bool:
        return self.arena_bytes <= budget_bytes


def plan_shared_arena(
    plans: Sequence[ArenaPlan],
    budget: int | None = None,
    *,
    serialize: bool = True,
    policies: Sequence[str] = ("first_fit", "best_fit", "greedy_by_size"),
) -> SharedArenaPlan:
    """Overlap the non-concurrent slack of ``plans`` inside one buffer.

    Each member plan packs one request's tensors over its own schedule
    timeline; its *persistent* allocations (graph outputs — serving state
    that must survive between steps) are live at every moment, while its
    *transient* allocations live only inside the member's own schedule
    window.  When the runtime executes admitted requests' steps serially
    (one device, one stream — the pool's default), member i's transients
    and member j's transients are never live at the same time, so they may
    share addresses: the joint items are placed on one serial timeline
    (member windows back-to-back, persistents spanning everything) and the
    standard lifetime-aware packers do the rest.  The joint extent is
    typically ``sum(persistent_i) + max-ish(transient_i)`` — strictly less
    than ``sum(arena_bytes_i)`` whenever members have any transient slack,
    which is the pool's headline memory win (DESIGN.md §9).

    ``serialize=False`` models *batched* execution instead (every member's
    step runs concurrently): member windows all start at time 0, so
    cross-member sharing is disabled and the joint extent degrades to a
    stacked layout — the accounting an execution mode that materializes all
    members' transients at once must use.

    Args:
      plans: standalone member plans (e.g. from :func:`plan_arena_best` or
        :func:`plan_arena_regions`).  Not mutated.
      budget: optional byte budget; recorded via :meth:`SharedArenaPlan.fits`
        by callers — this function never raises on overflow (admission is
        the pool's decision, not the planner's).
      serialize: see above.
      policies: placement policies to race on the joint items.

    Returns:
      A :class:`SharedArenaPlan`; ``members[i]``'s offsets address the
      joint buffer, so a member schedule can execute against the shared
      buffer via ``execute_plan(..., arena=shared_buffer)`` unchanged.
    """
    del budget  # admission is the caller's decision; kept for signature docs
    if not plans:
        return SharedArenaPlan([], 0, 0, 0, serialize=serialize)
    joint: list[Allocation] = []
    owner: list[tuple[int, Allocation]] = []   # (member idx, original alloc)
    persistent: list[Allocation] = []
    base = 0
    total = 0
    for mi, plan in enumerate(plans):
        if not plan.allocations:
            continue
        mt = max(a.t_free for a in plan.allocations)
        horizon = mt - 1
        for a in plan.allocations:
            if a.t_free == mt:
                ji = dataclasses.replace(a, offset=-1)   # times fixed below
                persistent.append(ji)
            else:
                ji = dataclasses.replace(
                    a,
                    offset=-1,
                    t_alloc=base + max(a.t_alloc, 0),
                    t_free=base + a.t_free,
                )
            joint.append(ji)
            owner.append((mi, a))
        if serialize:
            base += horizon + 1
            total = base
        else:
            total = max(total, horizon + 1)
    for ji in persistent:
        ji.t_alloc = 0
        ji.t_free = total + 1
    pack_order = sorted(
        range(len(joint)),
        key=lambda i: (joint[i].t_alloc, -joint[i].size, owner[i][0],
                       joint[i].node_ids),
    )
    ordered = [joint[i] for i in pack_order]
    peak = _interval_peak(ordered)
    policy, water = _race_pack(ordered, policies, peak)
    sum_members = sum(p.arena_bytes for p in plans)
    if water > sum_members:
        # The joint race fragmented badly — fall back to a stacked layout:
        # each member re-packed *alone* on the joint timeline (its
        # persistents still span everything: a steady-state pool re-executes
        # member schedules every step, so a member's transients may never
        # reuse its own persistent bytes either), members placed
        # back-to-back.  Kept only if actually tighter than the race.
        race_offsets = [it.offset for it in joint]
        by_member: dict[int, list[Allocation]] = {}
        for (mi, _), ji in zip(owner, joint):
            by_member.setdefault(mi, []).append(ji)
        stacked_water = 0
        offsets: list[tuple[Allocation, int]] = []
        for mi in sorted(by_member):
            items = sorted(by_member[mi],
                           key=lambda a: (a.t_alloc, -a.size, a.node_ids))
            _, extent = _race_pack(items, policies, _interval_peak(items))
            offsets += [(it, stacked_water + it.offset) for it in items]
            stacked_water += extent
        if stacked_water < water:
            for it, off in offsets:
                it.offset = off
            policy, water = "stacked", stacked_water
        else:
            for it, off in zip(joint, race_offsets):
                it.offset = off
    member_allocs: dict[int, list[Allocation]] = {i: [] for i in range(len(plans))}
    for (mi, orig), ji in zip(owner, joint):
        member_allocs[mi].append(
            dataclasses.replace(orig, offset=ji.offset))
    members = []
    for mi, plan in enumerate(plans):
        allocs = member_allocs[mi]
        members.append(ArenaPlan(
            allocations=allocs,
            arena_bytes=max((a.offset + a.size for a in allocs), default=0),
            policy="shared",
            peak_bytes=plan.peak_bytes,
        ))
    return SharedArenaPlan(
        members=members,
        arena_bytes=water,
        peak_bytes=peak,
        sum_member_bytes=sum_members,
        policy=policy,
        serialize=serialize,
    )


# ---------------------------------------------------------------------------
# Pre-rewrite reference (differential-testing + benchmarking oracle)
# ---------------------------------------------------------------------------


def _plan_arena_reference(
    g: Graph,
    order: Sequence[int],
    preplaced: Sequence[int] = (),
    policy: str = "first_fit",
) -> ArenaPlan:
    """The seed allocator, kept verbatim: rebuilds and sorts the live set per
    allocation (O(n^2 log n)).  Tests assert the sweep packers reproduce its
    watermarks; ``bench_scheduling_time`` uses it as the pre-rewrite timing
    baseline."""
    items = _build_items(g, order, preplaced)
    live: list[Allocation] = []
    watermark = 0
    for it in items:
        live = [a for a in live if a.t_free > it.t_alloc]
        gaps = sorted(live, key=lambda a: a.offset)
        candidates: list[int] = []
        cursor = 0
        for a in gaps:
            if a.offset - cursor >= it.size:
                candidates.append(cursor)
            cursor = max(cursor, a.offset + a.size)
        candidates.append(cursor)
        if policy == "first_fit":
            it.offset = candidates[0]
        else:  # best_fit: tightest gap
            def gap_len(off: int) -> int:
                following = [a.offset for a in gaps if a.offset >= off + it.size]
                return (min(following) - off) if following else 1 << 60
            it.offset = min(candidates, key=gap_len)
        live.append(it)
        watermark = max(watermark, it.offset + it.size)
    return ArenaPlan(allocations=items, arena_bytes=watermark, policy=policy,
                     peak_bytes=_interval_peak(items))
