"""CUDA arena kernels for Hopper: build, bind, launch.

The kernels live in ``repro_torch/csrc/arena.cu`` (one file, plain C
interface).  The first call that needs them compiles that file with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into ``build/repro_torch/
<source hash>/libarena.so`` at the root of the checkout and loads it with
``ctypes``; later calls (and later processes) reuse the library while the
source is unchanged.  Nothing is built when this module is imported.

Each wrapper takes CUDA tensors only, checks device, dtype, contiguity and
bounds, launches on PyTorch's current stream and raises if the launch was
refused.  A missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`: there is no fallback.  ``n == 0`` returns before
any launch.  Offsets and lengths are elements of the arena's dtype.

``LAUNCHES`` counts the launches of each kernel (one per call that reached
the device); :func:`reset_launches` sets the counts to 0.

These replace the Pallas kernels of ``repro/kernels/arena/kernel.py``
(``arena_write_pallas``, ``arena_read_pallas``, ``arena_accum_pallas``,
``arena_chain_write_pallas``); see ``csrc/arena.cu`` for what bounds them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.kernels.arena.elemwise import MAX_CHAIN, chain_codes

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "arena.cu"
BUILD_ROOT = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

LAUNCHES = {"write": 0, "read": 0, "accum": 0, "chain_write": 0}

_SUFFIX = {torch.float32: "f32", torch.uint8: "u8"}
_lib = None
_lib_lock = threading.Lock()


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


class _ChainOps(ctypes.Structure):
    # struct ChainOps in csrc/arena.cu
    _fields_ = [("n", ctypes.c_int), ("op", ctypes.c_int * MAX_CHAIN)]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError("nvcc not found (on PATH or under $CUDA_HOME); "
                           "the arena kernels cannot be built")


def build() -> Path:
    """Compile ``csrc/arena.cu`` unless a library of this source exists;
    returns the library's path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_ROOT / tag[:16] / "libarena.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libarena.so.tmp.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)     # atomic publish, safe across processes
    return out


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            for name in ("repro_arena_write_f32", "repro_arena_write_u8",
                         "repro_arena_read_f32", "repro_arena_read_u8",
                         "repro_arena_accum_f32"):
                fn = getattr(lib, name)
                fn.argtypes = [vp, vp, ll, ll, vp]
                fn.restype = ctypes.c_int
            fn = lib.repro_arena_chain_write_f32
            fn.argtypes = [vp, vp, ll, ll, _ChainOps, vp]
            fn.restype = ctypes.c_int
            _lib = lib
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


def _raise_on(err: int, what: str) -> None:
    if err:
        raise KernelLaunchError(f"{what}: launch failed with CUDA error "
                                f"{err}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def arena_write_cuda(arena, x, offset: int):
    """``arena[offset : offset+n] = x`` in place (f32 or u8); returns arena."""
    n = x.shape[0]
    _check(arena, offset, n, _SUFFIX, x)
    if n == 0:
        return arena
    fn = getattr(_library(), f"repro_arena_write_{_SUFFIX[arena.dtype]}")
    _raise_on(fn(arena.data_ptr(), x.data_ptr(), offset, n, _stream(arena)),
              "arena_write")
    LAUNCHES["write"] += 1
    return arena


def arena_read_cuda(arena, offset: int, n: int):
    """A fresh ``(n,)`` copy of ``arena[offset : offset+n]`` (f32 or u8)."""
    _check(arena, offset, n, _SUFFIX)
    out = torch.empty(n, dtype=arena.dtype, device=arena.device)
    if n == 0:
        return out
    fn = getattr(_library(), f"repro_arena_read_{_SUFFIX[arena.dtype]}")
    _raise_on(fn(arena.data_ptr(), out.data_ptr(), offset, n, _stream(arena)),
              "arena_read")
    LAUNCHES["read"] += 1
    return out


def arena_accum_cuda(arena, x, offset: int):
    """``arena[offset : offset+n] += x`` in place (f32); returns arena."""
    n = x.shape[0]
    _check(arena, offset, n, (torch.float32,), x)
    if n == 0:
        return arena
    _raise_on(_library().repro_arena_accum_f32(
        arena.data_ptr(), x.data_ptr(), offset, n, _stream(arena)),
        "arena_accum")
    LAUNCHES["accum"] += 1
    return arena


def arena_chain_write_cuda(arena, x, offset: int, ops=()):
    """Apply the elementwise chain ``ops`` to ``x`` in registers and write
    the result at ``offset`` (f32), one launch; returns arena."""
    codes = chain_codes(ops)
    n = x.shape[0]
    _check(arena, offset, n, (torch.float32,), x)
    if n == 0:
        return arena
    chain = _ChainOps(len(codes), (ctypes.c_int * MAX_CHAIN)(*codes))
    _raise_on(_library().repro_arena_chain_write_f32(
        arena.data_ptr(), x.data_ptr(), offset, n, chain, _stream(arena)),
        "arena_chain_write")
    LAUNCHES["chain_write"] += 1
    return arena
