"""Arena slice ops: move tensors in/out of the planned linear arena.

kernel.py   -- the CUDA kernels (csrc/arena.cu): build, ctypes binding,
               checked launches, launch counts
ops.py      -- dispatch (impl in {auto, cuda, torch}; no environment
               override)
elemwise.py -- canonical unary elementwise table (torch callables) and the
               chain kernel's op codes
ref.py      -- the plain PyTorch version of each op

Used by ``repro_torch.core.executor`` to realize ``ArenaPlan`` offsets at
run time (DESIGN.md §6) and to execute fused alias chains in one launch
(§11).
"""

from repro_torch.kernels.arena.kernel import LAUNCHES, reset_launches
from repro_torch.kernels.arena.ops import (
    arena_accum,
    arena_chain_write,
    arena_read,
    arena_write,
)

__all__ = ["LAUNCHES", "arena_accum", "arena_chain_write", "arena_read",
           "arena_write", "reset_launches"]
