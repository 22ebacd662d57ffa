"""Public arena ops: dispatch between the CUDA kernels and their plain
PyTorch versions.

``impl`` is one of:

  ``'auto'``   the CUDA kernel for a tensor on the card, the plain version
               for a tensor on the CPU;
  ``'cuda'``   the CUDA kernel; raises for a tensor on the CPU;
  ``'torch'``  the plain version on any device, only when asked for
               explicitly (the tests and ``chip_smoke.py`` do).

No environment variable changes the choice: a switch that forced the plain
version on the card would hide the kernel.  A CUDA tensor under ``'auto'``
launches the kernel or raises; it never falls back.  All ops update the
arena in place and return it.  Offsets and lengths are in elements of the
arena's dtype (see ``repro_torch.core.executor`` for the byte conversion).
"""

from __future__ import annotations

from repro_torch.kernels.arena import kernel as _kernel
from repro_torch.kernels.arena.ref import (
    arena_accum_torch,
    arena_chain_write_torch,
    arena_read_torch,
    arena_write_torch,
)

IMPLS = ("auto", "cuda", "torch")


def _use_kernel(impl: str, arena) -> bool:
    if impl == "auto":
        return arena.is_cuda
    if impl == "cuda":
        if not arena.is_cuda:
            raise ValueError("impl='cuda' needs a CUDA arena; got one on "
                             f"{arena.device}")
        return True
    if impl == "torch":
        return False
    raise ValueError(f"unknown arena impl {impl!r}; expected one of {IMPLS}")


def arena_write(arena, x, offset: int, *, impl: str = "auto"):
    """Write ``x`` (1-D, arena dtype) at element ``offset``; returns arena."""
    if _use_kernel(impl, arena):
        return _kernel.arena_write_cuda(arena, x, offset)
    return arena_write_torch(arena, x, offset)


def arena_accum(arena, x, offset: int, *, impl: str = "auto"):
    """Add ``x`` into ``arena[offset : offset+n]``; returns arena."""
    if _use_kernel(impl, arena):
        return _kernel.arena_accum_cuda(arena, x, offset)
    return arena_accum_torch(arena, x, offset)


def arena_read(arena, offset: int, n: int, *, impl: str = "auto"):
    """A fresh ``(n,)`` copy of ``arena[offset : offset+n]``."""
    if _use_kernel(impl, arena):
        return _kernel.arena_read_cuda(arena, offset, n)
    return arena_read_torch(arena, offset, n)


def arena_chain_write(arena, x, offset: int, ops=(), *, impl: str = "auto"):
    """Apply the unary elementwise chain ``ops`` to ``x``, then write the
    result at element ``offset``: the fused execution of an in-place alias
    chain (DESIGN.md §11), one kernel launch instead of a read, compute and
    write per chain member.

    ``ops`` name entries of
    :data:`~repro_torch.kernels.arena.elemwise.ELEMWISE_FNS`.  The plain
    version applies those torch callables, so on the CPU fused and
    slice-per-node execution are bit-equal; the kernel is bit-equal for the
    ops of :data:`~repro_torch.kernels.arena.elemwise.EXACT_OPS` and
    allclose for the transcendentals.
    """
    if _use_kernel(impl, arena):
        return _kernel.arena_chain_write_cuda(arena, x, offset, ops)
    return arena_chain_write_torch(arena, x, offset, ops)
