"""CUDA arena kernels for Hopper: build, bind, launch.

The kernels live in ``repro_torch/csrc/arena.cu`` (one file, plain C
interface).  The first call that needs them compiles that file into
``build/repro_torch/<source hash>/libarena.so`` at the root of the checkout
(:mod:`repro_torch.kernels._build`) and loads it with ``ctypes``; later
calls (and later processes) reuse the library while the source is
unchanged.  Nothing is built when this module is imported.

Each wrapper takes CUDA tensors only, checks device, dtype, contiguity and
bounds, launches on PyTorch's current stream and raises if the launch was
refused.  A missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`: there is no fallback.  ``n == 0`` returns before
any launch.  Offsets and lengths are elements of the arena's dtype.

Write and read are one byte copy in the kernel; :func:`copy_plan` splits
it (head bytes, 16-byte body stores, tail bytes, and the source's phase)
from the two byte addresses, and the launch passes the split along.
Accum and chain_write take the same split of their f32 slice and ``x``.

``LAUNCHES`` counts the launches of each kernel (one per call that reached
the device); :func:`reset_launches` sets the counts to 0.

These replace the Pallas kernels of ``repro/kernels/arena/kernel.py``
(``arena_write_pallas``, ``arena_read_pallas``, ``arena_accum_pallas``,
``arena_chain_write_pallas``); see ``csrc/arena.cu`` for what bounds them.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import (  # noqa: F401  (re-exported)
    KernelBuildError,
    KernelLaunchError,
)
from repro_torch.kernels.arena.elemwise import MAX_CHAIN, chain_codes

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "arena.cu"

LAUNCHES = {"write": 0, "read": 0, "accum": 0, "chain_write": 0}

_SUFFIX = {torch.float32: "f32", torch.uint8: "u8"}
_lib = None
_lib_lock = threading.Lock()


class _ChainOps(ctypes.Structure):
    # struct ChainOps in csrc/arena.cu
    _fields_ = [("n", ctypes.c_int), ("op", ctypes.c_int * MAX_CHAIN)]


class CopyPlan(NamedTuple):
    """The split of one copy ``dst[0:nbytes] = src[0:nbytes]`` (struct
    CopyPlan in ``csrc/arena.cu``): ``head`` bytes up to the first
    16-byte-aligned destination address, ``nvec`` 16-byte stores, ``tail``
    bytes; ``phase`` is ``(src - dst) mod 16``."""

    head: int
    nvec: int
    tail: int
    phase: int

    @property
    def mode(self) -> str:
        """How the body's 16-byte stores are built: ``'aligned'`` (phase
        0: one aligned 16-byte load each), ``'word_shift'`` (a multiple of
        4: two aligned loads, a word select) or ``'byte_shift'`` (two
        aligned loads, a funnel shift; only u8 copies meet it).  All three
        store 16 bytes an instruction."""
        if self.phase == 0:
            return "aligned"
        return "word_shift" if self.phase % 4 == 0 else "byte_shift"


def copy_plan(dst_addr: int, src_addr: int, nbytes: int) -> CopyPlan:
    """Split the copy of ``nbytes`` from byte address ``src_addr`` to
    ``dst_addr`` so that every store of the body is 16-byte aligned."""
    head = min(-dst_addr % 16, nbytes)
    nvec = (nbytes - head) // 16
    return CopyPlan(head, nvec, nbytes - head - 16 * nvec,
                    (src_addr - dst_addr) % 16)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile ``csrc/arena.cu`` unless a library of this source exists;
    returns the library's path (see :mod:`repro_torch.kernels._build`)."""
    return _build.build(SOURCE, "arena")


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument and result types on ``lib``."""
    vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for name in ("repro_arena_write_f32", "repro_arena_write_u8",
                 "repro_arena_read_f32", "repro_arena_read_u8",
                 "repro_arena_accum_f32"):
        fn = getattr(lib, name)
        fn.argtypes = [vp, vp, ll, ll, ll, ll, ll, i, vp]
        fn.restype = i
    fn = lib.repro_arena_chain_write_f32
    fn.argtypes = [vp, vp, ll, ll, ll, ll, ll, i, _ChainOps, vp]
    fn.restype = i
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            _lib = bind(ctypes.CDLL(str(build())))
        return _lib


def _check(arena, offset: int, n: int, dtypes, x=None) -> None:
    if not (isinstance(arena, torch.Tensor) and arena.is_cuda):
        raise ValueError("arena kernels take CUDA tensors only")
    if arena.dtype not in dtypes:
        raise ValueError(f"arena dtype {arena.dtype} not in {dtypes}")
    if arena.dim() != 1 or not arena.is_contiguous():
        raise ValueError("arena must be a contiguous 1-D tensor")
    if arena.device.index != torch.cuda.current_device():
        raise ValueError(f"arena on {arena.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if offset < 0 or n < 0 or offset + n > arena.shape[0]:
        raise ValueError(f"slice [{offset}, {offset + n}) outside the arena "
                         f"of {arena.shape[0]} elements")
    if x is not None:
        if x.device != arena.device or x.dtype != arena.dtype:
            raise ValueError(f"x ({x.dtype} on {x.device}) must match the "
                             f"arena ({arena.dtype} on {arena.device})")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError("x must be a contiguous 1-D tensor")
        if n and x.untyped_storage().data_ptr() == \
                arena.untyped_storage().data_ptr():
            raise ValueError("x must not share storage with the arena")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def arena_write_cuda(arena, x, offset: int):
    """``arena[offset : offset+n] = x`` in place (f32 or u8); returns arena."""
    n = x.shape[0]
    _check(arena, offset, n, _SUFFIX, x)
    if n == 0:
        return arena
    fn = getattr(_library(), f"repro_arena_write_{_SUFFIX[arena.dtype]}")
    esz = arena.element_size()
    plan = copy_plan(arena.data_ptr() + esz * offset, x.data_ptr(), esz * n)
    _build.raise_on(fn(arena.data_ptr(), x.data_ptr(), offset, n, *plan,
                       _stream(arena)), "arena_write")
    LAUNCHES["write"] += 1
    return arena


def arena_read_cuda(arena, offset: int, n: int, out=None):
    """A copy of ``arena[offset : offset+n]`` (f32 or u8): a fresh ``(n,)``
    tensor, or ``out`` (contiguous, 1-D, ``n`` elements of the arena's
    dtype on its device, sharing no storage with it), written in place."""
    _check(arena, offset, n, _SUFFIX)
    if out is None:
        out = torch.empty(n, dtype=arena.dtype, device=arena.device)
    else:
        _check(arena, offset, n, _SUFFIX, out)
        if out.shape[0] != n:
            raise ValueError(f"out holds {out.shape[0]} elements, the "
                             f"slice {n}")
    if n == 0:
        return out
    fn = getattr(_library(), f"repro_arena_read_{_SUFFIX[arena.dtype]}")
    esz = arena.element_size()
    plan = copy_plan(out.data_ptr(), arena.data_ptr() + esz * offset, esz * n)
    _build.raise_on(fn(arena.data_ptr(), out.data_ptr(), offset, n, *plan,
                       _stream(arena)), "arena_read")
    LAUNCHES["read"] += 1
    return out


def arena_accum_cuda(arena, x, offset: int):
    """``arena[offset : offset+n] += x`` in place (f32); returns arena."""
    n = x.shape[0]
    _check(arena, offset, n, (torch.float32,), x)
    if n == 0:
        return arena
    plan = copy_plan(arena.data_ptr() + 4 * offset, x.data_ptr(), 4 * n)
    _build.raise_on(_library().repro_arena_accum_f32(
        arena.data_ptr(), x.data_ptr(), offset, n, *plan, _stream(arena)),
        "arena_accum")
    LAUNCHES["accum"] += 1
    return arena


def arena_chain_write_cuda(arena, x, offset: int, ops=()):
    """Apply the elementwise chain ``ops`` to ``x`` in registers and write
    the result at ``offset`` (f32), one launch split by :func:`copy_plan`
    as accum's is; returns arena."""
    codes = chain_codes(ops)
    n = x.shape[0]
    _check(arena, offset, n, (torch.float32,), x)
    if n == 0:
        return arena
    chain = _ChainOps(len(codes), (ctypes.c_int * MAX_CHAIN)(*codes))
    plan = copy_plan(arena.data_ptr() + 4 * offset, x.data_ptr(), 4 * n)
    _build.raise_on(_library().repro_arena_chain_write_f32(
        arena.data_ptr(), x.data_ptr(), offset, n, *plan, chain,
        _stream(arena)), "arena_chain_write")
    LAUNCHES["chain_write"] += 1
    return arena
