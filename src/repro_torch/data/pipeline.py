"""Deterministic, shardable, resumable synthetic LM data pipeline: a copy
of ``repro.data.pipeline`` (numpy only), so that ``batch_at(step)`` is
bit-equal to ``repro``'s for the same seed, step and process.

Properties a 1000-node training job needs:

  * stateless addressing — batch(step) is a pure function of (seed, step,
    process_index), so restart/elastic-rescale resumes exactly without
    data-state checkpoints;
  * per-process sharding — each host materializes only its slice of the
    global batch;
  * background prefetch — a double-buffered thread hides generation latency;
  * structured stream — Zipf-distributed tokens over the vocab with Markov
    bigram structure, so LM losses actually *decrease* during the example
    runs (pure-uniform tokens would have irreducible loss = log V).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclasses.dataclass
class DataPipeline:
    cfg: ArchConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    n_processes: int = 1
    process_index: int = 0
    prefetch: int = 2

    def __post_init__(self):
        assert self.global_batch % self.n_processes == 0
        self.local_batch = self.global_batch // self.n_processes
        V = self.cfg.vocab_size
        rng = np.random.default_rng(self.seed)
        # fixed zipfian unigram + low-rank bigram mixing table
        ranks = np.arange(1, V + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._shift = rng.integers(1, V, size=64)

    # -- stateless batch addressing -------------------------------------------
    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 4096 + self.process_index
        )
        B, S, V = self.local_batch, self.seq_len, self.cfg.vocab_size
        base = rng.choice(V, size=(B, S), p=self._unigram)
        # Markov structure: token_t depends on token_{t-1} half the time
        mix = rng.random((B, S)) < 0.5
        shifted = (np.roll(base, 1, axis=1)
                   + self._shift[np.arange(S) % 64][None, :]) % V
        tokens = np.where(mix, shifted, base).astype(np.int32)
        batch = {"tokens": tokens}
        if self.cfg.is_encoder_decoder or self.cfg.frontend == "audio_frames":
            batch["frames"] = rng.standard_normal(
                (B, S, self.cfg.d_model), dtype=np.float32
            )
        return batch

    # -- prefetching iterator ---------------------------------------------------
    def __iter__(self) -> Iterator[dict]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            step = 0
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    def iter_from(self, start_step: int) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def make_pipeline(cfg: ArchConfig, shape: ShapeConfig, **kw) -> DataPipeline:
    return DataPipeline(cfg=cfg, seq_len=shape.seq_len,
                        global_batch=shape.global_batch, **kw)
