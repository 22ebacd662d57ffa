"""Belady (clairvoyant) off-chip traffic simulator (paper Fig. 11).

Given a schedule and an on-chip capacity, simulate tensor residency with the
optimal eviction policy (evict the resident tensor whose next use is furthest
in the future — Belady 1966).  The paper uses exactly this, justified because
the whole schedule is known at compile time.

Model (activations; weights are a mandatory one-way read stream):
  * executing node u requires all of u's live input tensors on-chip — absent
    ones are fetched (read traffic += size);
  * u's output is produced on-chip (no traffic);
  * evicting a tensor that is still needed later writes it off-chip once
    (write traffic += size) — re-fetches count again on use;
  * dead tensors vanish for free;
  * weight bytes of u are streamed on use: read traffic += weight_bytes
    (identical for every schedule, so it shifts all bars equally, as in the
    paper's sweep).

Returns bytes of off-chip traffic; 0 means the whole execution fit on-chip
(the paper's "eradicated" case).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.graph import Graph


@dataclasses.dataclass
class TrafficResult:
    read_bytes: int
    write_bytes: int
    weight_read_bytes: int
    fits_entirely: bool

    @property
    def total_bytes(self) -> int:
        return self.read_bytes + self.write_bytes + self.weight_read_bytes


def simulate_traffic(
    g: Graph,
    order: Sequence[int],
    capacity_bytes: int,
    include_weights: bool = True,
) -> TrafficResult:
    pos = {u: i for i, u in enumerate(order)}
    n = len(g)
    # next-use lists per tensor (ascending schedule positions of consumers)
    uses: dict[int, list[int]] = {u: [] for u in range(n)}
    for u in order:
        for p in g.nodes[u].preds:
            uses[p].append(pos[u])
    for k in uses:
        uses[k].sort(reverse=True)  # pop() yields the earliest next use

    resident: dict[int, int] = {}   # tensor -> size
    used_cap = 0
    reads = writes = weight_reads = 0
    spilled: set[int] = set()       # tensors currently off-chip but still live

    INF = 1 << 60

    def next_use(t: int, now: int) -> int:
        lst = uses[t]
        while lst and lst[-1] <= now:
            lst.pop()
        return lst[-1] if lst else INF

    def evict_until(free_needed: int, now: int, pinned: set[int]) -> None:
        nonlocal used_cap, writes
        while used_cap + free_needed > capacity_bytes and resident:
            candidates = [t for t in resident if t not in pinned]
            if not candidates:
                break  # cannot satisfy; arena overflows (caller accounts)
            victim = max(candidates, key=lambda t: (next_use(t, now), t))
            sz = resident.pop(victim)
            used_cap -= sz
            if next_use(victim, now) != INF:
                writes += sz
                spilled.add(victim)

    overflow = False
    for i, u in enumerate(order):
        nd = g.nodes[u]
        if include_weights:
            weight_reads += nd.weight_bytes
        pinned = set(nd.preds) | {u}
        # fetch inputs
        for p in nd.preds:
            if p in resident:
                continue
            sz = g.sizes[p]
            evict_until(sz, i, pinned)
            if used_cap + sz > capacity_bytes:
                overflow = True
            reads += sz
            resident[p] = sz
            used_cap += sz
            spilled.discard(p)
        # produce output
        sz = g.sizes[u]
        evict_until(sz, i, pinned)
        if used_cap + sz > capacity_bytes:
            overflow = True
        resident[u] = sz
        used_cap += sz
        # drop dead tensors
        for p in list(resident):
            if next_use(p, i) == INF and g.succs[p]:
                used_cap -= resident.pop(p)
    fits = reads == 0 and writes == 0 and not overflow
    return TrafficResult(
        read_bytes=reads,
        write_bytes=writes,
        weight_read_bytes=weight_reads if include_weights else 0,
        fits_entirely=fits,
    )
