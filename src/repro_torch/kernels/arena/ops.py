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
launches the kernel or raises; it never falls back.  The kernels have no
backward: on the card, under autograd with an arena or input that requires
a gradient, a call raises ``NotImplementedError`` rather than return an
arena autograd cannot see through (the executor runs without gradients).  All ops update the
arena in place and return it.  Offsets and lengths are in elements of the
arena's dtype (see ``repro_torch.core.executor`` for the byte conversion).
"""

from __future__ import annotations

from repro_torch.kernels import _grad, _local
from repro_torch.kernels.arena import kernel as _kernel
from repro_torch.kernels.arena.ref import (
    arena_accum_torch,
    arena_chain_write_torch,
    arena_read_torch,
    arena_write_torch,
)

IMPLS = ("auto", "cuda", "torch")


def _no_dtensor(op: str, *xs) -> None:
    """Raise for a DTensor: its ``data_ptr()`` is 0, so the kernel would
    write through a null pointer.  An arena is one replicated buffer, and
    a sharded state is gathered whole before it is packed
    (``core.executor.pack_buffers``)."""
    if _local.has_dtensor(*xs):
        raise TypeError(f"{op} takes plain tensors, not DTensors: take "
                        f"full_tensor() first")


def _use_kernel(impl: str, arena, *inputs, op: str) -> bool:
    """Whether the call launches the kernel; on the card, under autograd
    with ``arena`` or an input that requires a gradient, raises."""
    if impl == "auto":
        use = _grad.on_card(arena)
    elif impl == "cuda":
        if not _grad.on_card(arena):
            raise ValueError("impl='cuda' needs a CUDA arena; got one on "
                             f"{arena.device}")
        use = True
    elif impl == "torch":
        use = False
    else:
        raise ValueError(f"unknown arena impl {impl!r}; expected one of "
                         f"{IMPLS}")
    if use and _grad.needs_grad(arena, *inputs):
        raise _grad.no_backward(op, f"a backward of {op}")
    return use


def arena_write(arena, x, offset: int, *, impl: str = "auto"):
    """Write ``x`` (1-D, arena dtype) at element ``offset``; returns arena."""
    _no_dtensor("arena_write", arena, x)
    if _use_kernel(impl, arena, x, op="arena_write"):
        return _kernel.arena_write_cuda(arena, x, offset)
    return arena_write_torch(arena, x, offset)


def arena_accum(arena, x, offset: int, *, impl: str = "auto"):
    """Add ``x`` into ``arena[offset : offset+n]``; returns arena."""
    _no_dtensor("arena_accum", arena, x)
    if _use_kernel(impl, arena, x, op="arena_accum"):
        return _kernel.arena_accum_cuda(arena, x, offset)
    return arena_accum_torch(arena, x, offset)


def arena_read(arena, offset: int, n: int, *, impl: str = "auto",
               out=None):
    """A copy of ``arena[offset : offset+n]``: a fresh ``(n,)`` tensor, or
    ``out`` (a contiguous 1-D tensor of ``n`` elements in the arena's dtype
    on its device), written in place and returned."""
    _no_dtensor("arena_read", arena, out)
    if _use_kernel(impl, arena, out, op="arena_read"):
        return _kernel.arena_read_cuda(arena, offset, n, out)
    return arena_read_torch(arena, offset, n, out)


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
    _no_dtensor("arena_chain_write", arena, x)
    if _use_kernel(impl, arena, x, op="arena_chain_write"):
        return _kernel.arena_chain_write_cuda(arena, x, offset, ops)
    return arena_chain_write_torch(arena, x, offset, ops)
