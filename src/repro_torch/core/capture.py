"""CUDA-graph capture of one call: the port's counterpart of ``jax.jit``.

``repro`` compiles its two main paths into one program each: a whole arena
program (``PlanProgram.run(jit=True)``: ``jax.jit(self._program,
donate_argnums=(0,))``) and the server's decode step
(``jax.jit(make_decode_step(...))``).  The port runs eagerly, and there
the host's issue of every op from Python sets the pace.  Its counterpart
of a compiled program is a CUDA graph (``torch.cuda.CUDAGraph``): the
call's kernels are recorded once and then replayed as one launch, with no
Python between them.  Static tensors take the place of jit's traced and
donated arguments: the caller writes each call's inputs into the tensors
the graph was captured against, replays, and reads the tensors the
capture's call returned, which every replay overwrites.

:class:`CapturedCall` owns one captured call of ``fn()``:

  1. warm-up: ``fn()`` runs once, eagerly, on a side stream.  It is a
     real call (its kernels launch, the launch counts count them, its
     in-place writes land) and its result is :attr:`CapturedCall.first`.
     It also does what must not happen inside a capture: building and
     loading the kernels' libraries, allocating the split-K decode's
     counters, cuBLAS's first use.  With ``release=True`` the blocks
     the warm-up freed are then given back to the card
     (``torch.cuda.empty_cache``), so that a call whose temporaries are
     large (a train step) does not hold them twice, once cached for the
     general pool and once in the graph's;
  2. capture: ``fn()`` runs once more under ``torch.cuda.graph``, which
     launches nothing; its result, in the graph's private memory pool, is
     :attr:`CapturedCall.outputs`.  Every kernel wrapper counts its launch
     while being captured: those counts are taken back and kept as
     :attr:`CapturedCall.launches` (launches per replay);
  3. :meth:`CapturedCall.replay`: one launch of the graph, which adds
     :attr:`launches` to the kernel modules' counts (``LAUNCHES``, and
     the route splits ``rglru.kernel.ROUTES`` and
     ``flash_attention.kernel.BACKWARD_ROUTES``) and one to
     :attr:`replays`.  So the counts
     stay the number of kernel launches that ran, captured or not.

Since the warm-up has already made the first call, a caller uses
:attr:`first` for it and replays for the calls after.  The capture
records the addresses of every tensor the call reads and writes: the
caller keeps them alive and in place for as long as it replays.  All
launches, eager and captured, run on one stream in order, which the
split-K decode's counters rely on
(``repro_torch.kernels.flash_attention.kernel._counter``).

A CPU has no CUDA graph: :class:`CapturedCall` raises for any device but
a CUDA one, and never runs ``fn`` eagerly in its place.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.kernels.arena import kernel as _arena
from repro_torch.kernels.flash_attention import kernel as _flash
from repro_torch.kernels.optim import kernel as _optim
from repro_torch.kernels.rglru import kernel as _rglru
from repro_torch.kernels.rwkv6 import kernel as _rwkv6

#: the kernel modules' launch counts; keys are unique across them
COUNTS = (_arena.LAUNCHES, _flash.LAUNCHES, _rwkv6.LAUNCHES,
          _optim.LAUNCHES, _rglru.LAUNCHES)
#: counts that split a kernel's launches by route (the RG-LRU forward's,
#: the flash backward's): kept true over replays, not launches of their own
SPLITS = (_rglru.ROUTES, _flash.BACKWARD_ROUTES)


class CapturedCall:
    """One call of ``fn()`` captured in a CUDA graph on ``device``; see
    the module docstring.

    Attributes:
      first:    ``fn()``'s result from the warm-up call (eager).
      outputs:  ``fn()``'s result from the capture: the tensors every
                :meth:`replay` writes.
      launches: the port's kernel launches one replay makes, by kernel
                (the keys of the kernel modules' ``LAUNCHES``).
      replays:  replays so far.
    """

    def __init__(self, fn: Callable[[], Any], device, *,
                 release: bool = False):
        dev = torch.device(device)
        if dev.type != "cuda":
            raise ValueError(
                f"a CUDA graph needs a CUDA device, got {dev}: the CPU has "
                f"no graph to capture; run the call eagerly there")
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            self.first = fn()
        main.wait_stream(side)
        if release:
            # the warm-up's freed blocks, cached for the general pool,
            # would sit beside the graph's own pool: give them back
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()

        before = [dict(c) for c in COUNTS + SPLITS]
        self.graph = torch.cuda.CUDAGraph()
        self._deltas = []
        try:
            with torch.cuda.graph(self.graph):
                self.outputs = fn()
        finally:
            # the capture launched nothing: take its counts back, per replay
            for c, b in zip(COUNTS + SPLITS, before):
                self._deltas.append({k: c[k] - b[k] for k in c})
                c.update(b)
        self.launches = {k: n for d in self._deltas[:len(COUNTS)]
                         for k, n in d.items()}
        self.replays = 0

    def replay(self):
        """Launch the graph once on the current stream; returns
        :attr:`outputs`, which it has overwritten."""
        self.graph.replay()
        self.replays += 1
        for c, d in zip(COUNTS + SPLITS, self._deltas):
            for k, n in d.items():
                c[k] += n
        return self.outputs
