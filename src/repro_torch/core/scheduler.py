"""Dynamic-programming memory-aware scheduler (paper Algorithm 1).

The paper keys the memoization table on the *zero-indegree set* ``z`` of each
partial schedule.  ``z`` determines the scheduled set exactly (and vice
versa): the unscheduled nodes are precisely ``z`` plus the strict descendants
of ``z``, so the canonical frontier signature and the scheduled-set bitmask
are two representations of the same signature (bijection proven in
DESIGN.md §8).  We key on the bitmask — the classic Held–Karp signature —
because it is O(1) to update; the frontier rides along in the state for
transition generation.  For each signature we keep only the partial schedule
with the smallest ``(mu_peak, mu, water)`` — the footprint ``mu`` is a pure
function of the signature, so this is the Pareto/dominance filter over the
signature class, which Theorem 1 of the paper proves sufficient for
optimality.

Three pruning layers implement the search-speed machinery (DESIGN.md §8):

  * **eager-move dominance** — if a ready node's scheduling fits under the
    running peak and does not grow the footprint (its deallocations cover
    its allocation), the state that schedules it immediately dominates every
    sibling at the same level: all other transitions of that state are
    dropped.  Chains and in-place ops collapse to a single path.
  * **branch and bound** — with ``bnb=True`` (default) the search seeds an
    incumbent from the best memory-aware heuristic order and prunes every
    transition whose peak exceeds it, plus every signature whose *admissible
    lower bound* (max over remaining nodes of unavoidable resident bytes)
    exceeds it.  ``budget`` (the paper's tau) remains available as an
    explicit cap; the effective bound is ``min(budget, incumbent)``.
    Both engines implement identical rules, so results stay in parity.
  * ``state_quota`` / ``wall_clock_limit_s`` — the per-search-step "timeout"
    T of Algorithm 2, deterministic (signature quota) or literal.

Beyond the paper (DESIGN.md §5): among signatures with equal ``mu_peak``
(and equal ``mu``), the DP prefers the partial schedule with the smaller
*estimated arena watermark* ``water`` — a first-fit-no-coalesce model that
orders equal-peak winners toward fragmentation-free orders.  The
peak-optimality proof is untouched by any of the above: eager moves are an
exchange-argument dominance, and the bound only removes states that provably
cannot beat an order already in hand.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Sequence

import numpy as np

from repro_torch.core.graph import Graph, simulate_schedule

# In engine='auto' the scalar loop runs until some level generates more
# transitions than this, then the search restarts on the vectorized engine
# (the scalar prefix was cheap by definition — it only ran while levels were
# narrow).  This replaces the old static node-count crossover, which made
# 'auto' pick the slower engine on small-but-wide graphs.
_AUTO_SPILL_TRANSITIONS = 512

# The admissible lower bound only pays for itself on wide levels (it exists
# to stop state-space blowups, and costs a per-signature scan / matmul).
# Levels at or below this many deduped signatures skip it — in *both*
# engines, so the explored state sets stay in parity.
_LB_MIN_STATES = 256


class NoSolutionError(RuntimeError):
    """Budget tau is below the optimal peak: every path was pruned."""


class SearchTimeout(RuntimeError):
    """A search step exceeded its state quota / wall-clock limit."""


class _EngineSpill(Exception):
    """Internal: a level outgrew the scalar loop; restart vectorized."""


@dataclasses.dataclass
class ScheduleResult:
    order: list[int]
    peak_bytes: int
    final_bytes: int
    n_states_expanded: int
    n_signatures: int
    wall_time_s: float
    arena_est_bytes: int = 0   # DP's incremental arena-watermark estimate
                               # (0 when the producing path doesn't track it)
    exact: bool = True         # False for beam-trimmed / heuristic orders
    makespan: int = 0          # surrogate-cost makespan (serial = total cost;
                               # 0 when the producing path doesn't track it)
    width: int = 1             # max ops co-issued in any step (serial = 1)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Admissible lower-bound tables (branch and bound, DESIGN.md §8)
# ---------------------------------------------------------------------------


class _BoundTables:
    """Per-graph tables for the admissible completion lower bound.

    For a state with scheduled-set mask ``S`` and any remaining node ``u``,
    the footprint at the moment ``u`` is scheduled is at least

        static_lb[u]                 (u's allocation + all its preds resident)
      + sum sizes over S & need[u]   (already-produced tensors that *cannot*
                                      die before u: a consumer among u's
                                      strict descendants, or no consumer at
                                      all — graph outputs stay resident)

    so ``LB(S) = max(peak, max_u not in S: static_lb[u] + extra(S, u))`` is a
    valid lower bound on every completion's peak: any state with
    ``LB > bound`` cannot beat an order already in hand and is dropped.
    """

    def __init__(self, g: Graph):
        n = len(g)
        sizes = g.sizes
        desc = g.descendants_masks()
        need: list[int] = [0] * n
        static_lb: list[int] = [0] * n
        for u in range(n):
            nd = g.nodes[u]
            pm = g.pred_mask[u]
            m = 0
            for t in range(n):
                if t == u or pm >> t & 1:
                    continue
                if g.succ_mask[t] == 0 or g.succ_mask[t] & desc[u]:
                    m |= 1 << t
            need[u] = m
            alias = sum(sizes[p] for p in nd.alias_preds)
            static_lb[u] = (
                sizes[u] - alias + sum(sizes[p] for p in nd.preds)
            )
        self.need = need
        self.static_lb = static_lb
        # float64 keeps the per-level evaluation a single BLAS matmul; byte
        # sums stay far below 2**53, so the arithmetic is exact
        W = np.zeros((n, n), dtype=np.float64)
        for u in range(n):
            m = need[u]
            while m:
                b = m & -m
                m ^= b
                t = b.bit_length() - 1
                W[t, u] = float(sizes[t])
        self.need_w = W
        self.static_lb_np = np.array(static_lb, dtype=np.float64)


def _bound_tables(g: Graph) -> _BoundTables:
    bt = g.__dict__.get("_bound_tables")
    if bt is None:
        bt = _BoundTables(g)
        g._bound_tables = bt
    return bt


def dp_schedule(
    g: Graph,
    *,
    budget: int | None = None,
    state_quota: int | None = None,
    wall_clock_limit_s: float | None = None,
    preplaced: Sequence[int] = (),
    on_quota: str = "raise",
    engine: str = "auto",
    bnb: bool = True,
) -> ScheduleResult:
    """Optimal-peak topological schedule of ``g`` via signature DP.

    ``on_quota='raise'`` is the paper's behaviour (Algorithm 2 reacts to the
    timeout).  ``on_quota='beam'`` instead keeps only the ``state_quota`` best
    signatures per step (lowest peak, then footprint) — no longer provably
    optimal, but bounded; the production fallback for very wide graphs
    (DESIGN.md §3).  Beam runs without the automatic bound (an incumbent
    prune can dead-end a beam whose feasible path was evicted).

    ``bnb`` (default) turns the paper's user-supplied budget tau into an
    automatic bound: the search seeds an incumbent from the best heuristic
    order (`repro_torch.core.heuristics.best_heuristic_schedule`), prunes peaks
    above ``min(budget, incumbent)``, applies the admissible lower bound,
    and collapses zero-cost moves via the eager-move dominance.  The
    returned peak is identical to the unpruned DP's; pass ``bnb=False`` for
    the pre-bound reference search (kept for A/B state-count benchmarks).

    ``engine`` selects the DP implementation:

      * ``'python'`` — the scalar reference loop (one Python iteration per
        state transition).  Semantically the source of truth.
      * ``'numpy'``  — the vectorized bitmask engine: each DP level is a
        batch of packed-uint64 signature rows and every transition rule
        (alloc, dominance, bound prune, dealloc, frontier update, dedup) is
        evaluated for the whole level at once.  Identical results (same
        ``peak_bytes`` and ``final_bytes``; ties may pick a different but
        equally-optimal order only when the two engines enumerate states
        differently — both are deterministic).
      * ``'auto'``   — starts on the scalar loop and restarts on the
        vectorized engine the first time a level generates more than
        ``_AUTO_SPILL_TRANSITIONS`` transitions, so tiny/narrow searches
        never pay the per-level numpy dispatch overhead and wide ones never
        pay the per-transition interpreter overhead.

    Raises
    ------
    NoSolutionError   if ``budget`` prunes every path (tau < mu*).
    SearchTimeout     if a search step exceeds ``state_quota`` signatures or
                      the wall clock limit (with ``on_quota='raise'``).
    """
    use_bound = bnb and on_quota != "beam"
    tau = budget
    if use_bound:
        # the incumbent is a pure function of (graph, preplaced) — memoized
        # on the instance so budget meta-search rounds don't re-run the
        # heuristics (dropped on pickle, like the other derived caches)
        incumbents = g.__dict__.setdefault("_incumbents", {})
        inc_key = tuple(sorted(preplaced))
        inc_peak = incumbents.get(inc_key)
        if inc_peak is None:
            from repro_torch.core.heuristics import best_heuristic_schedule

            inc_peak = best_heuristic_schedule(
                g, preplaced=preplaced).peak_bytes
            incumbents[inc_key] = inc_peak
        tau = inc_peak if budget is None else min(budget, inc_peak)

    kw = dict(
        tau=tau,
        state_quota=state_quota,
        wall_clock_limit_s=wall_clock_limit_s,
        preplaced=preplaced,
        on_quota=on_quota,
        use_bound=use_bound,
    )
    little = sys.byteorder == "little"
    if engine == "auto":
        try:
            res = _dp_schedule_python(
                g, spill_cap=_AUTO_SPILL_TRANSITIONS if little else None, **kw
            )
        except _EngineSpill:
            res = _dp_schedule_numpy(g, **kw)
    elif engine == "numpy":
        res = _dp_schedule_numpy(g, **kw)
    elif engine == "python":
        res = _dp_schedule_python(g, **kw)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    costs = node_costs(g)
    res.makespan = sum(costs[u] for u in res.order)
    return res


def _dp_schedule_python(
    g: Graph,
    *,
    tau: int | None = None,
    state_quota: int | None = None,
    wall_clock_limit_s: float | None = None,
    preplaced: Sequence[int] = (),
    on_quota: str = "raise",
    use_bound: bool = False,
    spill_cap: int | None = None,
) -> ScheduleResult:
    """Scalar reference DP: one Python iteration per state transition."""
    t0 = time.perf_counter()
    n = len(g)
    pre = frozenset(preplaced)
    to_schedule = [i for i in range(n) if i not in pre]
    if not to_schedule:
        return ScheduleResult([], 0, 0, 0, 0, 0.0)

    sizes = g.sizes
    pred_mask = g.pred_mask
    succ_mask = g.succ_mask
    succs = g.succs
    # flat per-node transition tables (hot loop works on ints/tuples only)
    net_alloc = [0] * n          # size - aliased bytes
    alloc_pos = [0] * n          # max(net_alloc, 0): bytes the arena must find
    dealloc_preds: list[tuple[tuple[int, int], ...]] = [()] * n
    for u in range(n):
        nd = g.nodes[u]
        net_alloc[u] = sizes[u] - sum(sizes[p] for p in nd.alias_preds)
        alloc_pos[u] = max(net_alloc[u], 0)
        dealloc_preds[u] = tuple(
            (p, sizes[p]) for p in nd.preds if p not in nd.alias_preds
        )

    lbt = _bound_tables(g) if use_bound and tau is not None else None
    lb_cache: dict[int, int] = {}

    def _lb(mask: int) -> int:
        """max over remaining nodes of unavoidable resident bytes."""
        v = lb_cache.get(mask)
        if v is not None:
            return v
        best = 0
        need = lbt.need
        slb = lbt.static_lb
        for u in to_schedule:
            if mask >> u & 1:
                continue
            s = slb[u]
            m = mask & need[u]
            while m:
                b = m & -m
                m ^= b
                s += sizes[b.bit_length() - 1]
            if s > best:
                best = s
                if best > tau:
                    break          # prune decision already determined
        lb_cache[mask] = best
        return best

    pre_mask = 0
    mu0 = 0
    for p in pre:
        pre_mask |= 1 << p
        mu0 += sizes[p]

    full_mask = pre_mask
    for u in to_schedule:
        full_mask |= 1 << u

    frontier0 = 0
    for u in to_schedule:
        if pred_mask[u] & pre_mask == pred_mask[u]:
            frontier0 |= 1 << u

    # level: mask -> (mu, peak, water, frontier)
    # parents: mask -> (prev_mask, node)
    level: dict[int, tuple[int, int, int, int]] = {
        pre_mask: (mu0, mu0, mu0, frontier0)
    }
    parents: dict[int, tuple[int, int]] = {}
    expanded = 0
    n_signatures = 1

    for _step in range(len(to_schedule)):
        nxt: dict[int, tuple[int, int, int, int]] = {}
        level_tr = 0
        for mask, (mu, peak, water, frontier) in level.items():
            # generate the state's transitions; the eager-move dominance
            # (DESIGN.md §8) keeps only the first (lowest-id) ready node
            # whose transient fits under the running peak and whose
            # deallocations cover its allocation — its child state dominates
            # every sibling, so the rest of the frontier is dropped.
            trans: list[tuple[int, int, int, int, int]] = []
            f = frontier
            while f:
                ubit = f & -f
                f ^= ubit
                u = ubit.bit_length() - 1
                new_mu = mu + net_alloc[u]
                tpeak = new_mu           # transient before deallocations
                new_mask = mask | ubit
                for p, psz in dealloc_preds[u]:
                    if succ_mask[p] & new_mask == succ_mask[p]:
                        new_mu -= psz
                if use_bound and tpeak <= peak and new_mu <= mu:
                    trans = [(u, ubit, new_mask, new_mu, tpeak)]
                    break
                trans.append((u, ubit, new_mask, new_mu, tpeak))
            expanded += len(trans)
            level_tr += len(trans)
            for u, ubit, new_mask, new_mu, tpeak in trans:
                new_peak = peak if peak >= tpeak else tpeak
                if tau is not None and new_peak > tau:
                    continue  # pruned (budget / incumbent bound)
                # arena-watermark estimate: reuse hole bytes (water - mu) if
                # they cover the allocation, else grow the arena top
                s = alloc_pos[u]
                new_water = water if water - mu >= s else water + s
                cur = nxt.get(new_mask)
                if cur is None:
                    new_frontier = frontier ^ ubit
                    for s2 in succs[u]:
                        pm = pred_mask[s2]
                        if pm & new_mask == pm:
                            new_frontier |= 1 << s2
                    nxt[new_mask] = (new_mu, new_peak, new_water, new_frontier)
                    parents[new_mask] = (mask, u)
                    if (
                        lbt is None
                        and state_quota is not None
                        and on_quota == "raise"
                        and len(nxt) > state_quota
                    ):
                        # without a lower-bound filter nothing can shrink
                        # this level anymore: abort before materializing it
                        raise SearchTimeout(
                            f"step {_step}: memo > quota {state_quota}"
                        )
                elif (new_peak, new_mu, new_water) < (cur[1], cur[0], cur[2]):
                    nxt[new_mask] = (new_mu, new_peak, new_water, cur[3])
                    parents[new_mask] = (mask, u)
            if spill_cap is not None and level_tr > spill_cap:
                raise _EngineSpill
        # the admissible lower bound runs on wide levels only (it exists to
        # stop blowups; narrow levels aren't one) — stale `parents` entries
        # of pruned masks are unreachable and harmless
        if lbt is not None and len(nxt) > _LB_MIN_STATES:
            nxt = {m: v for m, v in nxt.items() if _lb(m) <= tau}
        if (
            state_quota is not None
            and on_quota == "raise"
            and len(nxt) > state_quota
        ):
            raise SearchTimeout(
                f"step {_step}: memo > quota {state_quota}"
            )
        if (
            state_quota is not None
            and on_quota == "beam"
            and len(nxt) > state_quota
        ):
            keep = sorted(
                nxt.items(), key=lambda kv: (kv[1][1], kv[1][0], kv[1][2])
            )
            nxt = dict(keep[:state_quota])
        if not nxt:
            raise NoSolutionError(
                f"budget {tau} prunes all paths at step {_step} "
                f"(graph {g.name!r})"
            )
        if (
            wall_clock_limit_s is not None
            and time.perf_counter() - t0 > wall_clock_limit_s
        ):
            raise SearchTimeout(f"wall clock limit {wall_clock_limit_s}s hit")
        n_signatures += len(nxt)
        level = nxt

    (final_mask, (final_mu, final_peak, final_water, _)), = level.items()
    assert final_mask == full_mask
    order: list[int] = []
    mask = final_mask
    while mask != pre_mask:
        mask, u = parents[mask]
        order.append(u)
    order.reverse()
    return ScheduleResult(
        order=order,
        peak_bytes=final_peak,
        final_bytes=final_mu,
        n_states_expanded=expanded,
        n_signatures=n_signatures,
        wall_time_s=time.perf_counter() - t0,
        arena_est_bytes=final_water,
        exact=on_quota != "beam",
    )


def _dp_schedule_numpy(
    g: Graph,
    *,
    tau: int | None = None,
    state_quota: int | None = None,
    wall_clock_limit_s: float | None = None,
    preplaced: Sequence[int] = (),
    on_quota: str = "raise",
    use_bound: bool = False,
) -> ScheduleResult:
    """Vectorized bitmask DP over whole levels at once.

    A level is the set of DP states with the same number of scheduled nodes.
    State signatures are rows of packed uint64 words (``Graph.masks()``), so
    one level is an ``(S, words)`` array and the per-transition work of the
    reference loop becomes ~a dozen batched numpy ops:

      1. unpack every state's ready-set into (state, node) transition pairs,
      2. batched alloc (``mu + net_alloc``) and dealloc: a predecessor is
         freed iff its successor mask is a subset of the new signature
         (CSR repeat/gather/reduceat over the pred-edge table),
      3. eager-move dominance: per source state, if any transition fits
         under the running peak without growing the footprint, keep only the
         first such transition (``minimum.reduceat`` over the state groups),
      4. bound prune (``new_peak > tau``), then signature dedup via one
         stable lexsort over (mask words, peak, water) — exactly the
         reference loop's per-signature winner,
      5. admissible lower bound on the surviving signatures: one float64
         matmul of the unpacked masks against the need-weight table,
      6. batched frontier refill over the succ-edge table.
    """
    if sys.byteorder != "little":
        # unpackbits(view(uint8), bitorder='little') relies on little-endian
        # uint64 layout; on big-endian hosts bits would map to wrong nodes
        raise RuntimeError(
            "engine='numpy' requires a little-endian host; use engine='python'"
        )
    t0 = time.perf_counter()
    n = len(g)
    pre = frozenset(preplaced)
    n_free = n - len(pre)
    if n_free == 0:
        return ScheduleResult([], 0, 0, 0, 0, 0.0)

    bt = g.masks()
    W = bt.words
    u64 = np.uint64
    lbt = _bound_tables(g) if use_bound and tau is not None else None

    pre_mask = np.zeros(W, dtype=u64)
    mu0 = 0
    for p in pre:
        pre_mask[p // 64] |= u64(1) << u64(p % 64)
        mu0 += g.sizes[p]
    full_mask = pre_mask.copy()
    for u in range(n):
        if u not in pre:
            full_mask[u // 64] |= u64(1) << u64(u % 64)
    frontier0 = np.zeros(W, dtype=u64)
    for u in range(n):
        if u not in pre and (bt.pred_mask[u] & ~pre_mask).max(initial=0) == 0:
            frontier0[u // 64] |= u64(1) << u64(u % 64)

    # current level (all states at the same depth); single-word graphs keep
    # signatures/frontiers as 1-D uint64 arrays, wider ones as (S, W) rows
    word1 = W == 1
    if word1:
        masks = pre_mask.copy()                          # (S,)
        frontier = frontier0.copy()
    else:
        masks = np.ascontiguousarray(pre_mask[None, :])  # (S, W)
        frontier = np.ascontiguousarray(frontier0[None, :])
    mu = np.array([mu0], dtype=np.int64)
    peak = np.array([mu0], dtype=np.int64)
    water = np.array([mu0], dtype=np.int64)   # arena-watermark estimate

    # per-level winner arrays for schedule reconstruction: at level L,
    # state i was reached by scheduling node_hist[L][i] in state
    # from_hist[L][i] of level L-1
    node_hist: list[np.ndarray] = []
    from_hist: list[np.ndarray] = []
    expanded = 0
    n_signatures = 1

    row_bits = 64 * W            # unpacked row width (a power of two iff
    row_shift = row_bits.bit_length() - 1     # W is one: the hot path)
    row_pow2 = row_bits & (row_bits - 1) == 0

    def _csr_expand(u_sel, table_len, table_off):
        """(rows, flat, row_rep, offs) expanding u_sel against a CSR table."""
        cnt = table_len[u_sel]
        rows = np.flatnonzero(cnt)
        if not len(rows):
            return rows, rows, rows, rows
        cnt_nz = cnt[rows]
        ends = np.cumsum(cnt_nz)
        offs = ends - cnt_nz
        pos = np.arange(int(ends[-1])) - np.repeat(offs, cnt_nz)
        flat = np.repeat(table_off[u_sel[rows]], cnt_nz) + pos
        row_rep = np.repeat(rows, cnt_nz)
        return rows, flat, row_rep, offs

    for _step in range(n_free):
        # 1. all (state, node) transitions of this level: unpack the packed
        # frontiers to one flat bit array; flat position p encodes
        # (state, node) = divmod(p, 64W).  Bits past n are always zero, so
        # no trimming is needed.
        bits = np.unpackbits(
            np.ascontiguousarray(frontier).view(np.uint8),
            bitorder="little",
        )
        tpos = np.flatnonzero(bits)
        if row_pow2:
            state_idx = tpos >> row_shift
            u_arr = tpos & (row_bits - 1)
        else:
            state_idx = tpos // row_bits
            u_arr = tpos - state_idx * row_bits

        # 2. batched alloc + dealloc for *every* transition (the dominance
        # test needs the post-dealloc footprint before any pruning)
        tpeak_tr = mu[state_idx] + bt.net_alloc[u_arr]   # transient
        if word1:
            new_mask = masks[state_idx] | bt.node_bit1[u_arr]
        else:
            new_mask = masks[state_idx] | bt.node_bit[u_arr]
        new_mu = tpeak_tr.copy()
        rows, flat, row_rep, offs = _csr_expand(u_arr, bt.pe_len, bt.pe_off)
        if len(rows):
            if word1:
                tgt = bt.pe_tgt1[flat]
                hit = (new_mask[row_rep] & tgt) == tgt
            else:
                tgt = bt.pe_tgt[flat]
                hit = ((new_mask[row_rep] & tgt) == tgt).all(axis=1)
            new_mu[rows] -= np.add.reduceat(
                np.where(hit, bt.pe_size[flat], 0), offs)

        # 3. eager-move dominance: per state, keep only the first transition
        # that fits under the running peak without growing the footprint
        if use_bound and len(u_arr):
            qual = (tpeak_tr <= peak[state_idx]) & (new_mu <= mu[state_idx])
            if qual.any():
                T = len(u_arr)
                starts = np.flatnonzero(
                    np.r_[True, state_idx[1:] != state_idx[:-1]])
                gid = np.cumsum(
                    np.r_[False, state_idx[1:] != state_idx[:-1]])
                qpos = np.where(qual, np.arange(T), T)
                firstq = np.minimum.reduceat(qpos, starts)
                keep = (firstq[gid] == T) | (np.arange(T) == firstq[gid])
                state_idx, u_arr = state_idx[keep], u_arr[keep]
                tpeak_tr, new_mu = tpeak_tr[keep], new_mu[keep]
                new_mask = new_mask[keep]
        expanded += len(u_arr)

        # 4. bound prune (budget / incumbent)
        new_peak = np.maximum(peak[state_idx], tpeak_tr)
        if tau is not None:
            keep = new_peak <= tau
            u_arr, state_idx = u_arr[keep], state_idx[keep]
            new_mu, new_peak = new_mu[keep], new_peak[keep]
            new_mask = new_mask[keep]
        if len(u_arr) == 0:
            raise NoSolutionError(
                f"budget {tau} prunes all paths at step {_step} "
                f"(graph {g.name!r})"
            )
        # arena-watermark estimate: reuse hole bytes (water - mu) when they
        # cover the allocation, else grow the arena top (see module docstring)
        s_arr = bt.alloc_pos[u_arr]
        water_tr = water[state_idx]
        new_water = water_tr + np.where(
            water_tr - mu[state_idx] >= s_arr, 0, s_arr
        )

        # 5. dedup signatures: the footprint mu is a pure function of the
        # signature mask, so transitions reaching the same mask differ only
        # in (peak, water).  One stable lexsort with the mask words as
        # primary keys and (peak, water) as tie-breaks groups equal masks
        # with the lexicographically-best transition first — exactly the
        # reference loop's strictly-better-replaces rule (earliest
        # transition wins among full ties, as lexsort is stable).
        firsts = np.empty(len(u_arr), dtype=bool)
        firsts[0] = True
        if word1:
            order = np.lexsort((new_water, new_peak, new_mask))
            sorted_mask = new_mask[order]
            np.not_equal(sorted_mask[1:], sorted_mask[:-1], out=firsts[1:])
        else:
            order = np.lexsort((new_water, new_peak) + tuple(new_mask.T))
            sorted_mask = new_mask[order]
            np.any(sorted_mask[1:] != sorted_mask[:-1], axis=1, out=firsts[1:])
        winners = order[np.flatnonzero(firsts)]

        state_w = state_idx[winners]
        u_w = u_arr[winners]
        mask_w = new_mask[winners]
        peak_w = new_peak[winners]
        mu_w = new_mu[winners]
        water_w = new_water[winners]

        # 6. admissible lower bound on the deduped signatures (one matmul;
        # wide levels only — the same rule as the reference loop)
        if lbt is not None and len(u_w) > _LB_MIN_STATES:
            mbits = np.unpackbits(
                np.ascontiguousarray(mask_w).view(np.uint8),
                bitorder="little",
            ).reshape(len(u_w), row_bits)[:, :n].astype(np.float64)
            lb = mbits @ lbt.need_w + lbt.static_lb_np
            np.copyto(lb, -1.0, where=mbits > 0.5)   # only remaining nodes
            keep = lb.max(axis=1) <= tau
            if not keep.all():
                state_w, u_w = state_w[keep], u_w[keep]
                mask_w, peak_w = mask_w[keep], peak_w[keep]
                mu_w, water_w = mu_w[keep], water_w[keep]
            if len(u_w) == 0:
                raise NoSolutionError(
                    f"budget {tau} prunes all paths at step {_step} "
                    f"(graph {g.name!r})"
                )
        n_uniq = len(u_w)
        if (
            state_quota is not None
            and on_quota == "raise"
            and n_uniq > state_quota
        ):
            raise SearchTimeout(f"step {_step}: memo > quota {state_quota}")

        # 7. batched frontier refill over the succ-edge table: a successor
        # enters the frontier iff all its preds are in the new signature
        if word1:
            frontier_w = frontier[state_w] ^ bt.node_bit1[u_w]
        else:
            frontier_w = frontier[state_w] ^ bt.node_bit[u_w]
        rows, flat, row_rep, offs = _csr_expand(u_w, bt.se_len, bt.se_off)
        if len(rows):
            if word1:
                tgt = bt.se_tgt1[flat]
                hit = (mask_w[row_rep] & tgt) == tgt
                frontier_w[rows] |= np.bitwise_or.reduceat(
                    np.where(hit, bt.se_bit1[flat], u64(0)), offs)
            else:
                tgt = bt.se_tgt[flat]
                hit = ((mask_w[row_rep] & tgt) == tgt).all(axis=1)
                frontier_w[rows] |= np.bitwise_or.reduceat(
                    np.where(hit[:, None], bt.se_bit[flat], u64(0)),
                    offs, axis=0)

        # 8. beam trim (needs the post-dealloc footprint for its tie-break)
        if (
            state_quota is not None
            and on_quota == "beam"
            and len(u_w) > state_quota
        ):
            best = np.lexsort((water_w, mu_w, peak_w))[: state_quota]
            state_w, u_w = state_w[best], u_w[best]
            mask_w = mask_w[best]
            peak_w, mu_w = peak_w[best], mu_w[best]
            water_w = water_w[best]
            frontier_w = frontier_w[best]
        if (
            wall_clock_limit_s is not None
            and time.perf_counter() - t0 > wall_clock_limit_s
        ):
            raise SearchTimeout(f"wall clock limit {wall_clock_limit_s}s hit")
        n_signatures += len(u_w)

        node_hist.append(u_w)
        from_hist.append(state_w)
        masks, mu, peak, frontier = mask_w, mu_w, peak_w, frontier_w
        water = water_w

    assert len(mu) == 1 and (masks if word1 else masks[0]).reshape(-1).tolist() \
        == full_mask.tolist()
    order_out: list[int] = []
    idx = 0
    for lvl in range(n_free - 1, -1, -1):
        order_out.append(int(node_hist[lvl][idx]))
        idx = int(from_hist[lvl][idx])
    order_out.reverse()
    return ScheduleResult(
        order=order_out,
        peak_bytes=int(peak[0]),
        final_bytes=int(mu[0]),
        n_states_expanded=expanded,
        n_signatures=n_signatures,
        wall_time_s=time.perf_counter() - t0,
        arena_est_bytes=int(water[0]),
        exact=on_quota != "beam",
    )


def brute_force_schedule(
    g: Graph, preplaced: Sequence[int] = ()
) -> ScheduleResult:
    """Exhaustive search over all topological orderings (tests only)."""
    t0 = time.perf_counter()
    n = len(g)
    pre = set(preplaced)
    best_order: list[int] | None = None
    best = (1 << 62, 1 << 62)
    order: list[int] = []
    count = 0

    indeg = [0] * n
    for nd in g.nodes:
        for p in nd.preds:
            if p not in pre:
                indeg[nd.id] += 1
    avail = sorted(
        i for i in range(n) if i not in pre and indeg[i] == 0
    )

    def rec(avail: list[int]) -> None:
        nonlocal best, best_order, count
        if len(order) == n - len(pre):
            count += 1
            sim = simulate_schedule(g, order, preplaced=tuple(pre))
            key = (sim.peak_bytes, sim.final_bytes)
            if key < best:
                best = key
                best_order = list(order)
            return
        for i, u in enumerate(list(avail)):
            order.append(u)
            newly = []
            for v in g.succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    newly.append(v)
            rec(avail[:i] + avail[i + 1 :] + newly)
            for v in g.succs[u]:
                indeg[v] += 1
            order.pop()

    rec(avail)
    assert best_order is not None
    sim = simulate_schedule(g, best_order, preplaced=tuple(pre))
    costs = node_costs(g)
    return ScheduleResult(
        order=best_order,
        peak_bytes=sim.peak_bytes,
        final_bytes=sim.final_bytes,
        n_states_expanded=count,
        n_signatures=count,
        wall_time_s=time.perf_counter() - t0,
        makespan=sum(costs[u] for u in best_order),
    )


# ---------------------------------------------------------------------------
# Latency x memory Pareto frontier (width-W time-slot model, DESIGN.md §12)
# ---------------------------------------------------------------------------


def node_costs(g: Graph) -> list[int]:
    """Per-node surrogate latency cost (the rewriter's FLOPs model).

    Inputs cost 0, so co-issuing graph inputs is free; every compute op
    costs at least 1.  The import is deferred because the rewriter imports
    this module.
    """
    from repro_torch.core.rewriter import node_flops

    return [node_flops(g, u) for u in range(len(g))]


@dataclasses.dataclass(frozen=True)
class ParetoPoint:
    """One non-dominated (makespan, peak) schedule on the frontier."""

    steps: tuple[tuple[int, ...], ...]  # time slots; each an antichain
    makespan: int                       # sum over steps of max member cost
    peak_bytes: int                     # step-model peak (simulate_steps)
    final_bytes: int
    width: int                          # max |step| actually used

    @property
    def order(self) -> list[int]:
        """The steps flattened to a serial execution order."""
        return [u for step in self.steps for u in step]


@dataclasses.dataclass
class ParetoFrontier:
    """Full latency-vs-peak frontier of a graph under width-W concurrency.

    ``points`` is sorted by strictly increasing makespan and strictly
    decreasing peak: ``points[0]`` is the fastest schedule, ``points[-1]``
    the serial-DP-peak endpoint (the latency-unconstrained minimum peak —
    co-issuing ops can never *reduce* peak below the serial optimum because
    any step schedule serializes without raising its peak, DESIGN.md §12).
    """

    points: list[ParetoPoint]
    max_width: int
    latency_budget: int | None
    n_states_expanded: int
    n_signatures: int
    wall_time_s: float
    exact: bool = True

    def pairs(self) -> tuple[tuple[int, int], ...]:
        return tuple((p.makespan, p.peak_bytes) for p in self.points)

    def best_under(self, latency_budget: int | None = None) -> ParetoPoint:
        """Min-peak point with makespan <= budget (None = unconstrained)."""
        pts = self.points if latency_budget is None else [
            p for p in self.points if p.makespan <= latency_budget]
        if not pts:
            raise NoSolutionError(
                f"no frontier point within latency budget {latency_budget} "
                f"(fastest point has makespan {self.points[0].makespan})")
        return pts[-1]

    @property
    def min_makespan(self) -> ParetoPoint:
        return self.points[0]

    @property
    def min_peak(self) -> ParetoPoint:
        return self.points[-1]


def _greedy_packed_steps(
    g: Graph, max_width: int, preplaced: Sequence[int], costs: Sequence[int]
) -> list[tuple[int, ...]]:
    """Deterministic maximal-width longest-cost-first step schedule.

    Not optimal in either objective — it exists to seed the Pareto search
    with a low-makespan incumbent (maximal packing is a decent makespan
    upper bound) whose (makespan, peak) prunes high-peak state families.
    """
    n = len(g)
    pre = set(preplaced)
    indeg = [0] * n
    for nd in g.nodes:
        indeg[nd.id] += sum(1 for p in nd.preds if p not in pre)
    ready = {u for u in range(n) if u not in pre and indeg[u] == 0}
    steps: list[tuple[int, ...]] = []
    while ready:
        pick = sorted(ready, key=lambda u: (-costs[u], u))[:max_width]
        steps.append(tuple(sorted(pick)))
        for u in pick:
            ready.discard(u)
            for v in g.succs[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.add(v)
    return steps


def steps_makespan(
    g: Graph,
    steps: Sequence[Sequence[int]],
    costs: Sequence[int] | None = None,
) -> int:
    """Surrogate makespan of a step schedule: sum of per-step max costs."""
    if costs is None:
        costs = node_costs(g)
    return sum(max(costs[u] for u in step) for step in steps if step)


def pareto_schedule(
    g: Graph,
    *,
    max_width: int = 2,
    latency_budget: int | None = None,
    budget: int | None = None,
    preplaced: Sequence[int] = (),
    state_quota: int | None = None,
    on_quota: str = "raise",
    costs: Sequence[int] | None = None,
) -> ParetoFrontier:
    """Exact latency-vs-peak Pareto frontier under width-W concurrency.

    Extends the signature DP with a time dimension: a transition schedules a
    non-empty *antichain* of up to ``max_width`` ready nodes as one step
    whose duration is the max member cost and whose transient claims every
    member's output before any deallocation lands (the step model of
    :func:`repro_torch.core.graph.simulate_steps`).  Footprint ``mu`` stays a pure
    function of the scheduled-set mask, so keeping the per-mask Pareto set
    of ``(makespan, peak)`` labels is exact — the two-objective analogue of
    the serial DP's single ``(peak, mu, water)`` winner.

    Exactness-preserving prunes: per-mask label dominance; a latency-budget
    cut using the admissible remaining-makespan bound ``max(critical-path
    tail, ceil(remaining cost / W))``; and an incumbent cut against two
    complete seed points (the exact serial DP order and a greedy max-packed
    schedule) — a label whose every completion is weakly dominated by a seed
    point is dropped, and both seeds re-enter the final candidate set so
    boundary ties survive.

    ``max_width=1`` delegates to :func:`dp_schedule`, reproducing today's
    serial schedule bit-for-bit as a single-point frontier.  ``budget`` caps
    peak bytes (the paper's tau); ``latency_budget`` caps makespan.
    ``on_quota='beam'`` trims each DP level to the ``state_quota`` best
    labels by ``(peak, makespan)`` and marks the frontier inexact — the
    serial endpoint stays exact regardless, because the seed point is the
    exact serial DP's.
    """
    if max_width < 1:
        raise ValueError(f"max_width must be >= 1, got {max_width}")
    if on_quota not in ("raise", "beam"):
        raise ValueError(f"unknown on_quota {on_quota!r}")
    t0 = time.perf_counter()
    costs = list(costs) if costs is not None else node_costs(g)
    from repro_torch.core.graph import simulate_steps

    def _serial_seed() -> ScheduleResult:
        # try the exact search first even in beam mode: dp_schedule flags
        # every beam-mode result inexact whether or not a trim happened
        try:
            return dp_schedule(
                g, budget=budget, state_quota=state_quota,
                preplaced=preplaced, on_quota="raise")
        except SearchTimeout:
            if on_quota != "beam":
                raise
            return dp_schedule(
                g, budget=budget, state_quota=state_quota,
                preplaced=preplaced, on_quota="beam")

    if max_width == 1:
        res = _serial_seed()
        if latency_budget is not None and res.makespan > latency_budget:
            raise NoSolutionError(
                f"latency budget {latency_budget} below the serial makespan "
                f"{res.makespan} and max_width=1 allows no packing")
        point = ParetoPoint(
            steps=tuple((u,) for u in res.order),
            makespan=res.makespan,
            peak_bytes=res.peak_bytes,
            final_bytes=res.final_bytes,
            width=1,
        )
        return ParetoFrontier(
            points=[point], max_width=1, latency_budget=latency_budget,
            n_states_expanded=res.n_states_expanded,
            n_signatures=res.n_signatures,
            wall_time_s=time.perf_counter() - t0, exact=res.exact)

    import itertools

    n = len(g)
    W = max_width
    pre = frozenset(preplaced)
    to_schedule = [u for u in range(n) if u not in pre]
    if not to_schedule:
        # nothing to place: a single empty schedule (dp_schedule semantics —
        # preplaced residents are the caller's bytes, not this schedule's)
        point = ParetoPoint(steps=(), makespan=0, peak_bytes=0,
                            final_bytes=0, width=1)
        return ParetoFrontier(
            points=[point], max_width=W, latency_budget=latency_budget,
            n_states_expanded=0, n_signatures=0,
            wall_time_s=time.perf_counter() - t0, exact=True)
    sizes = g.sizes
    pred_mask = g.pred_mask
    succ_mask = g.succ_mask
    succs = g.succs

    net_alloc = [0] * n
    alloc_pos = [0] * n
    dealloc_preds: list[tuple[tuple[int, int], ...]] = [()] * n
    for u in range(n):
        nd = g.nodes[u]
        net_alloc[u] = sizes[u] - sum(sizes[p] for p in nd.alias_preds)
        alloc_pos[u] = max(net_alloc[u], 0)
        dealloc_preds[u] = tuple(
            (p, sizes[p]) for p in nd.preds if p not in nd.alias_preds
        )

    # critical-path tails over the surrogate cost (admissible makespan LB)
    tail = [0] * n
    for u in range(n - 1, -1, -1):
        if u in pre:
            continue
        tail[u] = costs[u] + max(
            (tail[v] for v in succs[u] if v not in pre), default=0)

    pre_mask = 0
    mu0 = 0
    for p in pre:
        pre_mask |= 1 << p
        mu0 += sizes[p]
    full_mask = pre_mask
    for u in to_schedule:
        full_mask |= 1 << u
    frontier0 = 0
    for u in to_schedule:
        if pred_mask[u] & pre_mask == pred_mask[u]:
            frontier0 |= 1 << u
    total_cost = sum(costs[u] for u in to_schedule)

    # complete seed points pruning partial states from above; both re-enter
    # the final candidate set, so a pruned boundary tie is never lost
    serial = _serial_seed()
    exact = serial.exact
    seed_cands: list[tuple[int, int, tuple[tuple[int, ...], ...]]] = [
        (serial.makespan, serial.peak_bytes,
         tuple((u,) for u in serial.order)),
    ]
    if to_schedule:
        packed = _greedy_packed_steps(g, W, preplaced, costs)
        psim = simulate_steps(g, packed, preplaced=preplaced)
        seed_cands.append(
            (steps_makespan(g, packed, costs), psim.peak_bytes,
             tuple(packed)))
    seed_pairs = [(ms, pk) for ms, pk, _ in seed_cands]

    def _ms_lb(mask: int, rem_cost: int) -> int:
        """Admissible lower bound on the remaining makespan."""
        best = 0
        for u in to_schedule:
            if not mask >> u & 1 and tail[u] > best:
                best = tail[u]
        return max(best, -(-rem_cost // W))

    # label = (makespan, peak, parent_label | None, step_tuple); the parent
    # reference survives per-mask Pareto evictions, so reconstruction never
    # chases a reindexed list
    MU, FRONT, LB, LABELS = 0, 1, 2, 3
    root = (0, mu0, None, ())
    buckets: dict[int, dict[int, list]] = {
        len(pre): {pre_mask: [mu0, frontier0,
                              _ms_lb(pre_mask, total_cost), [root]]}
    }
    rem_costs: dict[int, int] = {pre_mask: total_cost}
    expanded = 0
    n_signatures = 1

    k0 = len(pre)
    for k in range(k0, n):
        bucket = buckets.pop(k, None)
        if not bucket:
            continue
        total_labels = sum(len(e[LABELS]) for e in bucket.values())
        if state_quota is not None and total_labels > state_quota:
            if on_quota == "raise":
                raise SearchTimeout(
                    f"pareto level {k - k0}: {total_labels} labels > "
                    f"quota {state_quota}")
            flat = sorted(
                ((lab[1], lab[0], mask, lab)
                 for mask, e in bucket.items() for lab in e[LABELS]),
                key=lambda t: t[:3])
            for e in bucket.values():
                e[LABELS] = []
            for _, _, mask, lab in flat[:state_quota]:
                bucket[mask][LABELS].append(lab)
            exact = False
        n_signatures += total_labels
        for mask, ent in bucket.items():
            mu, frontier, labels = ent[MU], ent[FRONT], ent[LABELS]
            if not labels:
                continue
            ready = []
            f = frontier
            while f:
                b = f & -f
                f ^= b
                ready.append(b.bit_length() - 1)
            rem = rem_costs[mask]
            for size in range(1, min(W, len(ready)) + 1):
                for S in itertools.combinations(ready, size):
                    sbits = 0
                    dur = 0
                    sum_pos = 0
                    sum_net = 0
                    for u in S:
                        sbits |= 1 << u
                        if costs[u] > dur:
                            dur = costs[u]
                        sum_pos += alloc_pos[u]
                        sum_net += net_alloc[u]
                    new_mask = mask | sbits
                    freed = 0
                    seen_preds = set()
                    for u in S:
                        for p, psz in dealloc_preds[u]:
                            if p in seen_preds:
                                continue
                            seen_preds.add(p)
                            if succ_mask[p] & new_mask == succ_mask[p]:
                                freed += psz
                    new_mu = mu + sum_net - freed
                    tpeak = mu + sum_pos
                    nk = k + size
                    nb = buckets.setdefault(nk, {})
                    nent = nb.get(new_mask)
                    if nent is None:
                        nf = frontier ^ sbits
                        for u in S:
                            for v in succs[u]:
                                pm = pred_mask[v]
                                if pm & new_mask == pm:
                                    nf |= 1 << v
                        nrem = rem - sum(costs[u] for u in S)
                        rem_costs[new_mask] = nrem
                        nent = nb[new_mask] = [
                            new_mu, nf, _ms_lb(new_mask, nrem), []]
                    lb_ms = nent[LB]
                    nlabels = nent[LABELS]
                    for lab in labels:
                        expanded += 1
                        new_ms = lab[0] + dur
                        new_peak = lab[1] if lab[1] >= tpeak else tpeak
                        if budget is not None and new_peak > budget:
                            continue
                        floor_ms = new_ms + lb_ms
                        if (latency_budget is not None
                                and floor_ms > latency_budget):
                            continue
                        if any(new_peak >= ipk and floor_ms >= ims
                               for ims, ipk in seed_pairs):
                            continue  # every completion covered by a seed
                        dominated = False
                        for cur in nlabels:
                            if cur[0] <= new_ms and cur[1] <= new_peak:
                                dominated = True
                                break
                        if dominated:
                            continue
                        nlabels[:] = [
                            cur for cur in nlabels
                            if not (new_ms <= cur[0] and new_peak <= cur[1])]
                        nlabels.append((new_ms, new_peak, lab, S))

    cands = list(seed_cands)
    final_bucket = buckets.get(n, {})
    for lab in final_bucket.get(full_mask, [None, None, None, []])[LABELS]:
        steps_rev: list[tuple[int, ...]] = []
        cur = lab
        while cur[2] is not None:
            steps_rev.append(cur[3])
            cur = cur[2]
        cands.append((lab[0], lab[1], tuple(reversed(steps_rev))))

    if latency_budget is not None:
        cands = [c for c in cands if c[0] <= latency_budget]
    if budget is not None:
        cands = [c for c in cands if c[1] <= budget]
    if not cands:
        raise NoSolutionError(
            f"no width-{W} schedule satisfies latency budget "
            f"{latency_budget} / peak budget {budget} (graph {g.name!r})")
    cands.sort(key=lambda c: (c[0], c[1]))
    points: list[ParetoPoint] = []
    last_peak = None
    for ms, pk, steps in cands:
        if last_peak is not None and pk >= last_peak:
            continue  # dominated, or an equal-makespan tie already kept
        last_peak = pk
        sim = simulate_steps(g, steps, preplaced=preplaced)
        assert sim.peak_bytes == pk and steps_makespan(g, steps, costs) == ms
        points.append(ParetoPoint(
            steps=steps, makespan=ms, peak_bytes=pk,
            final_bytes=sim.final_bytes,
            width=max((len(s) for s in steps), default=1)))
    return ParetoFrontier(
        points=points, max_width=W, latency_budget=latency_budget,
        n_states_expanded=expanded, n_signatures=n_signatures,
        wall_time_s=time.perf_counter() - t0, exact=exact)
