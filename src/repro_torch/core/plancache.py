"""Content-addressed plan cache for SERENITY scheduling results.

Scheduling is a pure function of the graph *structure* — node shapes/sizes,
ops and wiring — never of the node labels an importer happened to assign.
This module therefore addresses cached plans by a canonical graph hash:

``canonical_hash(g)``
    Weisfeiler–Lehman-style color refinement over the scheduling-relevant
    node payload (op, output bytes, weight bytes, meta/shape entries, alias
    structure) and the edge wiring.  Two graphs that differ only by a node
    relabeling hash identically; changing any shape, size or edge changes
    the hash.

``labeled_fingerprint(g)``
    Exact hash of the concrete labeled graph.  Used as the second key tier
    so a cache hit hands back a plan whose node ids are valid verbatim for
    the requesting graph.  Note the consequence: a *relabeled* isomorphic
    graph shares the canonical address but does not hit — translating a
    cached plan across labelings is future work; today the canonical tier
    buys address stability (same bucket, dedup-friendly disk names), not
    cross-labeling reuse.

``PlanCache``
    Two-tier memo: an in-process LRU (a hit on a live graph is O(1) — the
    content hashes are memoized on the instance and the stored plan is
    returned zero-copy) and an optional on-disk pickle store shared across
    processes.  Cached plans are shared objects: treat them as immutable.

The default process-wide cache is wired through
:func:`repro_torch.core.serenity.plan`; set the ``REPRO_TORCH_PLANCACHE_DIR``
environment variable to also persist plans across processes.  The port keeps
its own disk namespace: another variable, another blob magic, a schema tag
folded into every key and another file suffix, so a directory shared with the
JAX package never hands one package's pickled ``ArenaPlan`` to the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pickle
import struct
import threading
import zlib
from collections import OrderedDict
from typing import Any, Callable

from repro_torch.core.graph import Graph

_ENV_DIR = "REPRO_TORCH_PLANCACHE_DIR"


# ---------------------------------------------------------------------------
# Canonical graph hashing
# ---------------------------------------------------------------------------


def _node_payload(g: Graph, u: int) -> tuple:
    nd = g.nodes[u]
    return (nd.op, nd.size_bytes, nd.weight_bytes, nd.meta)


_M64 = (1 << 64) - 1
_FNV = 1099511628211


def _fold(salt: int, values) -> int:
    """Order-sensitive 64-bit fold (callers sort first for multisets)."""
    h = salt
    for x in values:
        h = ((h * _FNV) ^ x) & _M64
        h = (h ^ (h >> 29)) * 0xBF58476D1CE4E5B9 & _M64   # splitmix64 finalize
    return h


def wl_colors(g: Graph) -> list[int]:
    """Per-node Weisfeiler–Lehman colors over the scheduling payload.

    Initial colors come from sha256 of the node payload (op, sizes, meta —
    *not* names), refinement mixes the sorted neighbor color multisets with
    64-bit integer arithmetic (no per-node hashing in the loop — the
    refinement is the hot path for cache lookups).  Isomorphic relabelings
    produce the same color multiset; nodes distinguished by structure get
    distinct colors, which is what :func:`translate_order` keys on.
    """
    n = len(g)
    payload_color: dict[bytes, int] = {}
    colors = []
    for u in range(n):
        key = repr(_node_payload(g, u)).encode()
        c = payload_color.get(key)
        if c is None:
            c = int.from_bytes(hashlib.sha256(key).digest()[:8], "big")
            payload_color[key] = c
        colors.append(c)
    succs = g.succs
    for _ in range(max(1, n.bit_length())):
        nxt = [
            _fold(0xA5, (
                colors[u],
                _fold(0xB7, sorted(colors[p] for p in g.nodes[u].preds)),
                _fold(0xC9, sorted(colors[s] for s in succs[u])),
                _fold(0xD1, sorted(colors[p] for p in g.nodes[u].alias_preds)),
            ))
            for u in range(n)
        ]
        if nxt == colors:
            break
        colors = nxt
    return colors


def canonical_hash(g: Graph) -> str:
    """Label-invariant content hash of the scheduling-relevant structure.

    sha256 over the sorted WL color multiset (:func:`wl_colors`) plus edge
    color pairs.  Isomorphic relabelings hash equal; any shape/size/op/edge
    change does not.
    """
    n = len(g)
    colors = wl_colors(g)
    acc = hashlib.sha256()
    acc.update(f"n={n}".encode())
    for c in sorted(colors):
        acc.update(c.to_bytes(8, "big"))
    for cu, cv in sorted(
        (colors[p], colors[nd.id]) for nd in g.nodes for p in nd.preds
    ):
        acc.update(cu.to_bytes(8, "big") + cv.to_bytes(8, "big"))
    return acc.hexdigest()


def labeled_fingerprint(g: Graph) -> str:
    """Exact content hash of the labeled graph (ids, names, wiring, sizes)."""
    acc = hashlib.sha256()
    acc.update(repr(len(g)).encode())
    for nd in g.nodes:
        acc.update(repr((
            nd.id, nd.name, nd.op, nd.size_bytes, nd.weight_bytes,
            nd.preds, tuple(sorted(nd.alias_preds)), nd.meta,
        )).encode())
    return acc.hexdigest()


def translate_order(src: Graph, dst: Graph, order: list[int]) -> list[int] | None:
    """Map a schedule of ``src`` onto the isomorphic-but-relabeled ``dst``.

    The WL colors (:func:`wl_colors`) of both graphs are compared; when the
    refinement individualizes every node (all color classes are singletons)
    the node bijection is forced, and after verifying it really is an
    isomorphism (pred and alias sets map exactly — WL equality alone is
    necessary, not sufficient) the order is rewritten through it.  Returns
    ``None`` when the graphs aren't color-equivalent or the cell is too
    symmetric to individualize — callers fall back to rescheduling.

    This is what turns the plan cache's canonical (WL) tier into real
    cross-labeling reuse for repeated network cells (DESIGN.md §8).
    """
    n = len(src)
    if n != len(dst):
        return None
    cs, cd = wl_colors(src), wl_colors(dst)
    if sorted(cs) != sorted(cd):
        return None
    by_color: dict[int, int] = {}
    for u, c in enumerate(cd):
        if c in by_color:
            return None          # symmetric cell: bijection not forced
        by_color[c] = u
    mapping = [by_color[c] for c in cs]          # src id -> dst id
    for u in range(n):                           # verify the isomorphism
        su, du = src.nodes[u], dst.nodes[mapping[u]]
        if sorted(mapping[p] for p in su.preds) != sorted(du.preds):
            return None
        if {mapping[p] for p in su.alias_preds} != set(du.alias_preds):
            return None
        if su.size_bytes != du.size_bytes or su.op != du.op:
            return None
    return [mapping[u] for u in order]


# Bump whenever the *shape* of cached payloads changes (new plan fields,
# different tuple layouts...): folded into every options key, so stale disk
# entries from older code become clean misses instead of poison.
SCHEMA_VERSION = 1   # 1: the port's first schema (mirrors the JAX
                     #    package's schema 7: CRC32-framed pareto plans)
_NAMESPACE = "repro_torch"


def _options_key(options: Any) -> str:
    return hashlib.sha256(
        repr((_NAMESPACE, SCHEMA_VERSION, options)).encode()
    ).hexdigest()[:16]


# Disk-blob frame (DESIGN.md §13): magic + writer schema + CRC32 of the
# pickle payload, prepended to every on-disk entry.  Disk corruption —
# truncated writes, garbage bytes, bit rot — is thereby *detected*
# (``CacheStats.corrupt``) and the entry evicted, instead of being
# silently swallowed by a bare ``pickle.loads`` except clause.  The schema
# field catches the one corruption CRC cannot: an intact blob written by a
# different code version landing at a current key path.
_BLOB_MAGIC = b"RTPL"
_BLOB_HEADER = struct.Struct("<4sII")     # magic, schema, crc32(payload)


def frame_blob(payload: bytes) -> bytes:
    """Wrap a pickle payload in the CRC32 disk frame."""
    return _BLOB_HEADER.pack(_BLOB_MAGIC, SCHEMA_VERSION,
                             zlib.crc32(payload)) + payload


def unframe_blob(blob: bytes) -> bytes | None:
    """Validate + strip the disk frame; ``None`` on any corruption
    (short/truncated blob, bad magic, stale schema, CRC mismatch)."""
    if len(blob) < _BLOB_HEADER.size:
        return None
    magic, schema, crc = _BLOB_HEADER.unpack_from(blob)
    payload = blob[_BLOB_HEADER.size:]
    if magic != _BLOB_MAGIC or schema != SCHEMA_VERSION \
            or zlib.crc32(payload) != crc:
        return None
    return payload


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    disk_hits: int = 0
    puts: int = 0
    corrupt: int = 0     # disk entries the CRC frame rejected (and evicted)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PlanCache:
    """Two-tier (memory LRU + optional disk) content-addressed plan store.

    Keys are ``(canonical_hash(g), options, labeled_fingerprint(g))`` — the
    canonical tier makes isomorphic graphs share an address, the labeled
    tier guarantees a returned plan's node ids are valid for the caller's
    graph verbatim.  Payloads may be any picklable object (a
    ``SerenityResult``, a bare order, an arena plan...).
    """

    def __init__(self, capacity: int = 256, disk_dir: str | None = None,
                 blob_hook: Callable[[bytes], bytes] | None = None):
        self.capacity = capacity
        self.disk_dir = disk_dir
        # fault-injection seam (DESIGN.md §13): every disk blob passes
        # through the hook before unframing, so the chaos suite can inject
        # bit flips (ChaosController.corrupt_blob) without monkeypatching
        self.blob_hook = blob_hook
        self.stats = CacheStats()
        self._mem: OrderedDict[tuple[str, str, str], Any] = OrderedDict()
        # canonical tier: (canonical, options) -> most recent full key, so
        # isomorphic-but-relabeled graphs can find *a* stored plan to
        # translate (memory tier only; validated against _mem on lookup)
        self._canon: dict[tuple[str, str], tuple[str, str, str]] = {}
        self._lock = threading.Lock()

    # -- keys ---------------------------------------------------------------

    def key_for(self, g: Graph, options: Any = ()) -> tuple[str, str, str]:
        # graphs are immutable, so the content hashes are memoized on the
        # instance — repeat lookups for a live graph are O(1)
        gk = g.__dict__.get("_plancache_key")
        if gk is None:
            gk = (canonical_hash(g), labeled_fingerprint(g))
            g._plancache_key = gk
        return (gk[0], _options_key(options), gk[1])

    # -- lookup / insert ----------------------------------------------------

    def get(self, g: Graph, options: Any = ()) -> Any | None:
        key = self.key_for(g, options)
        with self._lock:
            if key in self._mem:
                self._mem.move_to_end(key)
                self.stats.hits += 1
                return self._mem[key]
        blob = self._disk_read(key)
        if blob is not None:
            if self.blob_hook is not None:
                blob = self.blob_hook(blob)
            payload_bytes = unframe_blob(blob)
            ok = False
            payload = None
            if payload_bytes is not None:
                try:
                    payload = pickle.loads(payload_bytes)
                    ok = True
                except Exception:
                    ok = False       # CRC-valid frame, unpicklable payload
            if ok:
                with self._lock:
                    self._mem_put(key, payload)
                    self.stats.hits += 1
                    self.stats.disk_hits += 1
                return payload
            # corrupt/stale entry (truncated write, garbage bytes, older
            # schema): count it, evict it, and fall through to a clean miss
            with self._lock:
                self.stats.corrupt += 1
            self._disk_evict(key)
        with self._lock:
            self.stats.misses += 1
        return None

    def get_canonical(self, g: Graph, options: Any = ()) -> Any | None:
        """A stored payload for *any* graph isomorphic to ``g`` (same
        canonical hash, same options) — node ids inside it refer to the
        graph it was stored for; callers translate (see
        :func:`translate_order`).  Returns ``None`` on miss; never counts
        toward hit/miss stats (it's a secondary, best-effort tier)."""
        key = self.key_for(g, options)
        with self._lock:
            full = self._canon.get((key[0], key[1]))
            if full is None or full == key:
                return None
            payload = self._mem.get(full)
            if payload is None:
                self._canon.pop((key[0], key[1]), None)   # evicted: drop
                return None
            self._mem.move_to_end(full)
            return payload

    def put(self, g: Graph, options: Any, payload: Any) -> None:
        key = self.key_for(g, options)
        with self._lock:
            self._mem_put(key, payload)
            self._canon[(key[0], key[1])] = key
            self.stats.puts += 1
        if self.disk_dir:
            self._disk_write(key, frame_blob(pickle.dumps(payload)))

    def clear(self) -> None:
        with self._lock:
            self._mem.clear()
            self._canon.clear()
            self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._mem)

    # -- internals ----------------------------------------------------------

    def _mem_put(self, key: tuple[str, str, str], payload: Any) -> None:
        self._mem[key] = payload
        self._mem.move_to_end(key)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)

    def _disk_path(self, key: tuple[str, str, str]) -> str | None:
        if not self.disk_dir:
            return None
        return os.path.join(
            self.disk_dir, f"{key[0][:24]}-{key[1]}-{key[2][:24]}.tplan.pkl"
        )

    def _disk_read(self, key: tuple[str, str, str]) -> bytes | None:
        path = self._disk_path(key)
        if path is None or not os.path.exists(path):
            return None
        try:
            with open(path, "rb") as f:
                return f.read()
        except OSError:
            return None

    def _disk_evict(self, key: tuple[str, str, str]) -> None:
        path = self._disk_path(key)
        if path is not None:
            try:
                os.remove(path)
            except OSError:
                pass

    def _disk_write(self, key: tuple[str, str, str], blob: bytes) -> None:
        path = self._disk_path(key)
        if path is None:
            return
        try:
            os.makedirs(self.disk_dir, exist_ok=True)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)   # atomic publish, safe across processes
        except OSError:
            pass                    # disk tier is best-effort


# ---------------------------------------------------------------------------
# Process-wide default cache
# ---------------------------------------------------------------------------

_default_cache: PlanCache | None = None
_default_lock = threading.Lock()


def default_cache() -> PlanCache:
    """The process-wide plan cache (disk tier from ``$REPRO_TORCH_PLANCACHE_DIR``)."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = PlanCache(
                disk_dir=os.environ.get(_ENV_DIR) or None
            )
        return _default_cache


def configure_default(cache: PlanCache | None) -> None:
    """Replace the process-wide cache (``None`` resets to a fresh one)."""
    global _default_cache
    with _default_lock:
        _default_cache = cache


def resolve(cache: "PlanCache | bool | None") -> PlanCache | None:
    """Map a user-facing cache argument to a PlanCache (or None = disabled)."""
    if cache is True:
        return default_cache()
    if cache is False or cache is None:
        return None
    return cache
