"""Fault-tolerant training-loop runtime: a copy of ``repro.runtime.fault``
over the port's checkpoints (``repro_torch.checkpoint``).

``FaultTolerantLoop`` wraps a train step with:

  * periodic (async) checkpointing + restore-on-start,
  * bounded retry on transient failures (a preemption-style runtime
    error: re-init from the last checkpoint and continue).  The port's
    optimizer updates the state in place, so a step that fails midway
    leaves it partly updated and only a restore makes the retry exact:
    with no checkpoint to restore, the failure is raised (``repro``'s
    loop, whose state is immutable, retries from the state it holds),
  * straggler detection: an EMA of step time flags steps slower than
    ``straggler_factor``x the moving median — on multi-host deployments this
    feeds the controller that triggers slice-swap; here it logs and counts
    (the hook is the deliverable; there is one process in this container),
  * clean shutdown on SIGTERM (checkpoint before exit — preemption notice).
"""

from __future__ import annotations

import dataclasses
import logging
import signal
import time
from typing import Any, Callable

log = logging.getLogger("repro_torch.runtime")


@dataclasses.dataclass
class StepTimer:
    """EMA/median step timing + straggler flagging."""
    straggler_factor: float = 2.5
    window: int = 32

    def __post_init__(self):
        self.history: list[float] = []
        self.stragglers = 0

    def observe(self, dt: float) -> bool:
        self.history.append(dt)
        if len(self.history) > self.window:
            self.history.pop(0)
        med = sorted(self.history)[len(self.history) // 2]
        is_straggler = len(self.history) >= 8 and dt > self.straggler_factor * med
        if is_straggler:
            self.stragglers += 1
            log.warning("straggler step: %.3fs vs median %.3fs", dt, med)
        return is_straggler


class FaultTolerantLoop:
    def __init__(
        self,
        step_fn: Callable,                  # (state, batch) -> (state, metrics)
        ckpt_manager,
        batch_iter_factory: Callable[[int], Any],   # start_step -> iterator
        ckpt_every: int = 100,
        max_retries: int = 3,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt_manager
        self.batch_iter_factory = batch_iter_factory
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self.timer = StepTimer()
        self._stop = False

    def _on_sigterm(self, *_):
        log.warning("SIGTERM: checkpointing before exit")
        self._stop = True

    def run(self, state, start_step: int, n_steps: int,
            on_metrics: Callable | None = None):
        """Steps ``start_step`` to ``n_steps`` (SIGTERM handled while it
        runs, the previous handler put back after it: a handler left
        installed would keep this loop, its step and what the step holds
        -- a captured step's graph and its memory pool -- alive)."""
        try:
            prev = signal.signal(signal.SIGTERM, self._on_sigterm)
        except ValueError:
            prev = None  # not on main thread (tests)
        try:
            return self._run(state, start_step, n_steps, on_metrics)
        finally:
            if prev is not None:
                signal.signal(signal.SIGTERM, prev)

    def _run(self, state, start_step, n_steps, on_metrics):
        step = start_step
        retries = 0
        it = self.batch_iter_factory(step)
        while step < n_steps and not self._stop:
            batch = next(it)
            t0 = time.perf_counter()
            try:
                state, metrics = self.step_fn(state, batch)
            except Exception as e:   # transient runtime failure path
                retries += 1
                log.error("step %d failed (%s); retry %d/%d", step, e,
                          retries, self.max_retries)
                if retries > self.max_retries:
                    raise
                # restore from last checkpoint and rebuild the input stream;
                # without one the state may be partly updated in place
                last = self._latest()
                if last is None:
                    raise
                state = self._restore(state, last)
                step = last
                it = self.batch_iter_factory(step)
                continue
            retries = 0
            self.timer.observe(time.perf_counter() - t0)
            step += 1
            if on_metrics is not None:
                on_metrics(step, metrics)
            if step % self.ckpt_every == 0:
                self.ckpt.save_async(step, state)
        self.ckpt.wait()
        self.ckpt.save(step, state)
        return state, step

    def _latest(self):
        from repro_torch.checkpoint import latest_step

        # a pending async save may hold the newest step: without the join,
        # a failure racing the writer thread restores a stale checkpoint
        # (or none at all) and silently replays from the wrong step
        self.ckpt.wait()
        return latest_step(self.ckpt.dir)

    def _restore(self, like, step):
        from repro_torch.checkpoint import restore

        log.info("restoring from step %d", step)
        return restore(self.ckpt.dir, step, like)
