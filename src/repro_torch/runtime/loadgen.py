"""Open-loop load generation for the serving fleet (DESIGN.md §14).

``synth_requests`` hands the server one fixed batch — fine for exercising
a tick loop, useless for sizing a fleet: admission control, shard routing
and preemption only show their behavior under *arrival pressure*, where
requests keep landing whether or not the system has drained the last
ones.  This module generates that pressure as data, ahead of time:

  * **open loop** — arrival times are drawn from a seeded Poisson process
    (exponential inter-arrival gaps at ``rate`` requests/tick) and never
    react to the system under test, so an overloaded fleet sees its queue
    grow instead of the workload politely slowing down;
  * **sampled lengths** — prompt lengths are lognormal (a heavy right
    tail: most prompts are short, a few are huge and stress the prefill
    lane or overflow every shard), generation lengths geometric, both
    clipped to configured bounds;
  * **mixes** — each arrival carries a Pareto request class
    (latency-sensitive fraction), a priority level and a tenant drawn
    from weighted choices, so quota and preemption policies face a
    realistic blend.

Everything is a pure function of ``(seed, parameters)``: the same
generator yields byte-identical workloads across runs and machines, which
is what lets the fleet's tick-domain metrics be compared exactly and the
chaos runs be held against a fault-free twin.  A copy of
``repro.runtime.loadgen`` (numpy only in both): the same seed and
parameters give ``repro``'s arrivals, field for field.  Arrivals are plain
numpy/dataclass values usable by both the simulated fleet and the real
decode server.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class Arrival:
    """One generated request: identity, arrival time, and sampled shape.

    ``tick`` is the open-loop arrival time in scheduler ticks (the fleet
    submits the request at that tick, ready or not).  ``prompt_len`` /
    ``gen_len`` are the sampled prompt and generation lengths;
    ``klass`` is the Pareto request class (``'latency'`` / ``'memory'`` /
    ``None``), ``priority`` orders preemption, ``tenant`` selects a quota.
    """

    rid: int
    tick: int
    prompt_len: int
    gen_len: int
    klass: str | None = None
    priority: int = 0
    tenant: str | None = None

    @property
    def smax(self) -> int:
        """Total sequence budget this request needs (prompt + generated)."""
        return self.prompt_len + self.gen_len


class OpenLoopLoadGen:
    """Seeded open-loop workload generator.

    Args:
      seed: RNG seed; identical seeds + parameters yield identical
        workloads (the whole point — see module docstring).
      rate: mean arrivals per tick of the Poisson process.
      prompt_mean / prompt_sigma: lognormal prompt-length distribution —
        ``prompt_mean`` is the distribution *mean* (the underlying
        normal's mu is derived), ``prompt_sigma`` the log-space sigma
        controlling tail heaviness.
      prompt_min / prompt_max: clip bounds for prompt lengths.
      gen_mean: mean of the geometric generation-length distribution.
      gen_min / gen_max: clip bounds for generation lengths.
      latency_frac: fraction of arrivals tagged ``klass='latency'``
        (the rest are ``'memory'``); 0 leaves ``klass=None``.
      priority_weights: ``{priority: weight}`` for the priority mix
        (default: everything priority 0).
      tenant_weights: ``{tenant: weight}`` for the tenant mix (default:
        ``tenant=None``).
    """

    def __init__(self, seed: int = 0, *, rate: float = 4.0,
                 prompt_mean: float = 48.0, prompt_sigma: float = 0.6,
                 prompt_min: int = 1, prompt_max: int = 2048,
                 gen_mean: float = 8.0, gen_min: int = 1, gen_max: int = 64,
                 latency_frac: float = 0.0,
                 priority_weights: dict[int, float] | None = None,
                 tenant_weights: dict[str, float] | None = None):
        if rate <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate}")
        if not 0.0 <= latency_frac <= 1.0:
            raise ValueError(f"latency_frac must be in [0, 1], got "
                             f"{latency_frac}")
        if prompt_min < 1 or prompt_max < prompt_min:
            raise ValueError(f"bad prompt bounds [{prompt_min}, {prompt_max}]")
        if gen_min < 1 or gen_max < gen_min:
            raise ValueError(f"bad gen bounds [{gen_min}, {gen_max}]")
        if gen_mean < 1:
            raise ValueError(f"gen_mean must be >= 1, got {gen_mean}")
        for name, weights in (("priority_weights", priority_weights),
                              ("tenant_weights", tenant_weights)):
            if weights is not None and (
                    not weights or any(w < 0 for w in weights.values())
                    or sum(weights.values()) <= 0):
                raise ValueError(f"{name} needs positive total weight")
        self.seed = int(seed)
        self.rate = float(rate)
        self.prompt_mean = float(prompt_mean)
        self.prompt_sigma = float(prompt_sigma)
        self.prompt_min = int(prompt_min)
        self.prompt_max = int(prompt_max)
        self.gen_mean = float(gen_mean)
        self.gen_min = int(gen_min)
        self.gen_max = int(gen_max)
        self.latency_frac = float(latency_frac)
        self.priority_weights = dict(priority_weights or {})
        self.tenant_weights = dict(tenant_weights or {})

    def arrivals(self, n: int) -> list[Arrival]:
        """Generate the first ``n`` arrivals, sorted by arrival tick."""
        if n <= 0:
            return []
        rng = np.random.default_rng(self.seed)
        # Poisson process: exponential gaps at `rate` per tick; the cumsum
        # is the arrival clock, floored onto the integer tick grid.
        gaps = rng.exponential(1.0 / self.rate, size=n)
        ticks = np.floor(np.cumsum(gaps)).astype(np.int64) + 1
        # Lognormal prompts with mean `prompt_mean`: mu is derived so the
        # distribution mean (not median) matches before clipping.
        mu = math.log(self.prompt_mean) - 0.5 * self.prompt_sigma ** 2
        prompts = np.clip(
            np.rint(rng.lognormal(mu, self.prompt_sigma, size=n)),
            self.prompt_min, self.prompt_max).astype(np.int64)
        gens = np.clip(rng.geometric(min(1.0, 1.0 / self.gen_mean), size=n),
                       self.gen_min, self.gen_max).astype(np.int64)
        lat = rng.random(n) < self.latency_frac if self.latency_frac else None
        priorities = self._mix(rng, self.priority_weights, n, default=0)
        tenants = self._mix(rng, self.tenant_weights, n, default=None)
        return [
            Arrival(
                rid=i,
                tick=int(ticks[i]),
                prompt_len=int(prompts[i]),
                gen_len=int(gens[i]),
                klass=(None if lat is None
                       else ("latency" if lat[i] else "memory")),
                priority=priorities[i],
                tenant=tenants[i],
            )
            for i in range(n)
        ]

    @staticmethod
    def _mix(rng: np.random.Generator, weights: dict, n: int, default):
        """Draw ``n`` weighted choices from ``weights`` (all ``default``
        when no weights are configured)."""
        if not weights:
            return [default] * n
        keys = sorted(weights)                  # deterministic choice order
        p = np.array([weights[k] for k in keys], dtype=np.float64)
        idx = rng.choice(len(keys), size=n, p=p / p.sum())
        return [keys[i] for i in idx]

    def describe(self) -> dict:
        """Config echo for benchmark rows / logs."""
        return {
            "seed": self.seed, "rate": self.rate,
            "prompt_mean": self.prompt_mean,
            "prompt_sigma": self.prompt_sigma,
            "prompt_max": self.prompt_max,
            "gen_mean": self.gen_mean, "gen_max": self.gen_max,
            "latency_frac": self.latency_frac,
            "priorities": sorted(self.priority_weights),
            "tenants": sorted(self.tenant_weights),
        }


def workload_summary(arrivals: list[Arrival]) -> dict:
    """Deterministic shape summary of a generated workload: the numbers
    that pin the workload a fleet measurement was taken under."""
    if not arrivals:
        return {"n": 0}
    prompts = np.array([a.prompt_len for a in arrivals])
    gens = np.array([a.gen_len for a in arrivals])
    span = max(a.tick for a in arrivals)
    return {
        "n": len(arrivals),
        "span_ticks": int(span),
        "prompt_mean": round(float(prompts.mean()), 2),
        "prompt_p99": int(np.percentile(prompts, 99)),
        "gen_mean": round(float(gens.mean()), 2),
        "tokens_total": int(gens.sum()),
        "latency_frac": round(
            sum(a.klass == "latency" for a in arrivals) / len(arrivals), 3),
    }
