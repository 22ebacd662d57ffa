"""Deterministic fault injection for the serving runtime (DESIGN.md §13).

A copy of ``repro.runtime.chaos`` (no JAX in either).

SERENITY's contract is that plans fit a hard byte budget; this module
exercises the runtime that must keep honoring it when the world
misbehaves.  A :class:`FaultPlan` is a seeded, fully deterministic script
of faults — *which* fault, *at which* server tick — and a
:class:`ChaosController` turns it into the hook callables the runtime
already exposes (``ArenaPool.admission_hook``, the ``DecodeServer``
``chaos=`` parameter, ``PlanCache(blob_hook=...)``).  Nothing is
monkeypatched: every injection point is a first-class seam of the object
it perturbs.

Fault kinds:

  ``budget_shrink``      the server calls ``set_budget(budget * factor)``
                         at the tick — the degradation-ladder trigger.
  ``admission_failure``  every pool admission attempt during the tick
                         fails transiently (the queue holds; a later
                         drain retries).
  ``executor_error``     one :class:`TransientExecutorError` raised at
                         the top of the tick's decode phase, before any
                         request state is touched — the server's bounded
                         retry path.
  ``cache_corrupt``      the next plan-cache disk read returns a
                         bit-flipped blob; the CRC frame must catch it
                         (``CacheStats.corrupt``) and evict the entry.

The chaos differential suite (``tests/test_chaos.py``) replays a seeded
corpus of these plans against both a simulated and the real decode server
and asserts the three invariants: no request lost (every submit completes
or is rejected with a machine-readable ``reason_code``), the realized
arena bytes never exceed the *instantaneous* budget, and the token
streams of surviving requests are bit-equal to the fault-free run.
"""

from __future__ import annotations

import dataclasses
import random

FAULT_KINDS = (
    "budget_shrink",
    "admission_failure",
    "executor_error",
    "cache_corrupt",
)


class TransientExecutorError(RuntimeError):
    """An injected (or real) transient failure of one decode step; request
    state is untouched, so the step is safely retryable."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: ``kind`` fires at server tick ``tick`` (1-based).

    ``factor`` is the budget multiplier for ``budget_shrink`` (0.5 = the
    classic mid-run 2x shrink) and ignored by the other kinds.
    """

    kind: str
    tick: int
    factor: float = 0.5

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"known: {FAULT_KINDS}")
        if self.tick < 1:
            raise ValueError(f"fault tick must be >= 1, got {self.tick}")
        if self.kind == "budget_shrink" and not 0.0 < self.factor <= 1.0:
            raise ValueError(f"budget_shrink factor must be in (0, 1], "
                             f"got {self.factor}")


class FaultPlan:
    """An ordered, deterministic script of :class:`FaultSpec` events."""

    def __init__(self, specs=()):
        self.specs: tuple[FaultSpec, ...] = tuple(sorted(
            specs, key=lambda s: (s.tick, FAULT_KINDS.index(s.kind))))

    @classmethod
    def generate(cls, seed: int, *, n_ticks: int = 24,
                 kinds=FAULT_KINDS, rate: float = 0.2,
                 max_shrinks: int = 2,
                 min_shrink_factor: float = 0.45) -> "FaultPlan":
        """A seeded random fault script — the chaos corpus generator.

        Same ``(seed, kwargs)`` -> same plan, always (``random.Random``,
        no global state).  At most ``max_shrinks`` budget shrinks are
        emitted and each keeps at least ``min_shrink_factor`` of the
        budget, so a corpus plan degrades the pool without zeroing it —
        requests the *initial* budget admitted stay representable, which
        is what makes the no-request-lost invariant interesting rather
        than vacuous (a rejected-everything run asserts nothing).
        """
        rng = random.Random(seed)
        specs = []
        shrinks = 0
        for tick in range(1, n_ticks + 1):
            if rng.random() >= rate:
                continue
            kind = kinds[rng.randrange(len(kinds))]
            if kind == "budget_shrink":
                if shrinks >= max_shrinks:
                    continue
                shrinks += 1
                factor = round(rng.uniform(min_shrink_factor, 0.8), 3)
                specs.append(FaultSpec(kind, tick, factor))
            else:
                specs.append(FaultSpec(kind, tick))
        return cls(specs)

    def at(self, tick: int) -> tuple[FaultSpec, ...]:
        return tuple(s for s in self.specs if s.tick == tick)

    def __len__(self) -> int:
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def describe(self) -> str:
        if not self.specs:
            return "fault-free"
        return ", ".join(
            f"{s.kind}@{s.tick}" + (f"x{s.factor}"
                                    if s.kind == "budget_shrink" else "")
            for s in self.specs)


class ChaosController:
    """Drives a :class:`FaultPlan` through the runtime's injection hooks.

    The tick-driven protocol: the serving loop calls :meth:`begin_tick`
    at the top of every tick and acts on the returned specs itself
    (``budget_shrink`` -> ``server.set_budget``); the hook-shaped kinds
    latch inside the controller and fire when the instrumented object
    consults its hook (``admission_should_fail`` from ``ArenaPool``,
    ``maybe_executor_error`` from the server's decode phase,
    ``corrupt_blob`` from ``PlanCache``).  ``fired`` is the audit log of
    every fault that actually landed.
    """

    #: kinds begin_tick returns for the serving loop to act on directly
    _LOOP_KINDS = ("budget_shrink",)

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.tick = 0
        self.fired: list[FaultSpec] = []
        self._adm_fail: FaultSpec | None = None
        self._exec_err: FaultSpec | None = None
        self._pending_corrupt: list[FaultSpec] = []

    def begin_tick(self, tick: int) -> tuple[FaultSpec, ...]:
        """Arm this tick's faults; returns the loop-handled specs."""
        self.tick = tick
        specs = self.plan.at(tick)
        self._adm_fail = next(
            (s for s in specs if s.kind == "admission_failure"), None)
        self._exec_err = next(
            (s for s in specs if s.kind == "executor_error"), None)
        self._pending_corrupt.extend(
            s for s in specs if s.kind == "cache_corrupt")
        handled = tuple(s for s in specs if s.kind in self._LOOP_KINDS)
        self.fired.extend(handled)
        return handled

    # -- ArenaPool.admission_hook ------------------------------------------

    def admission_should_fail(self) -> bool:
        """True for every admission attempt during an armed tick."""
        if self._adm_fail is None:
            return False
        self.fired.append(self._adm_fail)
        return True

    # -- DecodeServer decode-phase hook ------------------------------------

    def maybe_executor_error(self) -> None:
        """Raise the tick's armed transient error exactly once."""
        if self._exec_err is None:
            return
        spec, self._exec_err = self._exec_err, None
        self.fired.append(spec)
        raise TransientExecutorError(
            f"injected transient executor error at tick {spec.tick}")

    # -- PlanCache blob_hook ------------------------------------------------

    def corrupt_blob(self, blob: bytes) -> bytes:
        """Bit-flip a pending corruption into the next disk read."""
        if not self._pending_corrupt or not blob:
            return blob
        spec = self._pending_corrupt.pop(0)
        self.fired.append(spec)
        pos = (spec.tick * 2654435761) % len(blob)
        return blob[:pos] + bytes([blob[pos] ^ 0xFF]) + blob[pos + 1:]

    @property
    def n_fired(self) -> int:
        return len(self.fired)


def seeded_corpus(n: int, *, base_seed: int = 0, **kwargs) -> list[FaultPlan]:
    """``n`` deterministic fault plans — the chaos corpus the CI job and
    the nightly ``--runslow`` sweep replay (see ``tests/test_chaos.py``)."""
    return [FaultPlan.generate(base_seed + i, **kwargs) for i in range(n)]
