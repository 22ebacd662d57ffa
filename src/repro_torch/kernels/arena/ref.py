"""Plain PyTorch versions of the four arena ops.

Each computes the same function as its CUDA kernel in ``kernel.py`` and
works in place on ``arena`` as the kernel does.  The dispatch in ``ops.py``
takes them for tensors on the CPU (or when ``impl='torch'`` is passed
explicitly); ``chip_smoke.py`` holds the kernels against them on the card.
Offsets and lengths are in elements of the arena's dtype.
"""

from __future__ import annotations

from repro_torch.kernels.arena.elemwise import apply_chain


def arena_write_torch(arena, x, offset: int):
    arena[offset:offset + x.shape[0]] = x
    return arena


def arena_accum_torch(arena, x, offset: int):
    arena[offset:offset + x.shape[0]] += x
    return arena


def arena_read_torch(arena, offset: int, n: int, out=None):
    # a copy, never a view: a view would change under a later in-place
    # write (an alias chain overwriting its predecessor's slice)
    if out is None:
        return arena[offset:offset + n].clone()
    return out.copy_(arena[offset:offset + n])


def arena_chain_write_torch(arena, x, offset: int, ops=()):
    arena[offset:offset + x.shape[0]] = apply_chain(x, ops)
    return arena
