"""CUDA RG-LRU kernel for Hopper: build, bind, launch.

The kernel lives in ``repro_torch/csrc/rglru.cu`` (plain C interface).  The
first call compiles it into ``build/repro_torch/<source hash>/librglru.so``
(:mod:`repro_torch.kernels._build`) and loads it with ``ctypes``; nothing
is built when this module is imported.

:func:`rglru_cuda` takes CUDA tensors only and checks device, dtypes
(``log_a`` and the carries f32, ``gx`` bf16 or f32), contiguity, shapes
and T >= 1; it allocates the outputs with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch was refused.
``LAUNCHES["rglru"]`` counts launches; :func:`reset_launches` sets it
to 0.

It replaces ``rglru_pallas`` / ``_rglru_kernel`` of
``repro/kernels/rglru/kernel.py``; the source note says what bounds it and
what the simple design leaves on the table.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "rglru.cu"

LAUNCHES = {"rglru": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile ``csrc/rglru.cu`` unless a library of this source exists;
    returns the library's path."""
    return _build.build(SOURCE, "rglru")


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"repro_rglru_{sfx}")
                fn.argtypes = [vp, vp, vp, vp, vp,     # la gx h0 h hT
                               ll, ll, ll,             # B T D
                               vp]                     # stream
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(log_a, gx, h0, state_out) -> None:
    for name, t in (("log_a", log_a), ("gx", gx)):
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            raise ValueError(f"rglru_cuda takes CUDA tensors only; {name} "
                             f"is not one")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (B, T, D) tensor")
    if log_a.dtype != torch.float32:
        raise ValueError(f"log_a must be f32; got {log_a.dtype}")
    if gx.dtype not in _SUFFIX:
        raise ValueError(f"gx dtype {gx.dtype} not in {tuple(_SUFFIX)}")
    if log_a.device != gx.device or log_a.shape != gx.shape:
        raise ValueError(f"log_a {tuple(log_a.shape)} on {log_a.device} and "
                         f"gx {tuple(gx.shape)} on {gx.device} differ")
    if gx.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {gx.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    B, T, D = gx.shape
    if T < 1:
        raise ValueError("rglru_cuda needs T >= 1")
    for name, s in (("h0", h0), ("state_out", state_out)):
        if s is None:
            continue
        if not (isinstance(s, torch.Tensor) and s.device == gx.device
                and s.dtype == torch.float32 and s.is_contiguous()
                and tuple(s.shape) == (B, D)):
            raise ValueError(f"{name} must be a contiguous f32 tensor of "
                             f"shape {(B, D)} on {gx.device}")


def rglru_cuda(log_a, gx, h0=None, *, state_out=None):
    """The RG-LRU recurrence on the card: log_a (f32) and gx ``(B,T,D)`` ->
    (h ``(B,T,D)`` in gx's dtype, hT ``(B,D)`` f32).  ``state_out``
    receives hT (a fresh tensor when None) and may be ``h0`` itself."""
    _check(log_a, gx, h0, state_out)
    B, T, D = gx.shape
    h = torch.empty_like(gx)
    hT = state_out if state_out is not None else torch.empty(
        (B, D), dtype=torch.float32, device=gx.device)
    fn = getattr(_library(), f"repro_rglru_{_SUFFIX[gx.dtype]}")
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    _build.raise_on(fn(log_a.data_ptr(), gx.data_ptr(),
                       None if h0 is None else h0.data_ptr(), h.data_ptr(),
                       hT.data_ptr(), B, T, D, stream), "rglru")
    LAUNCHES["rglru"] += 1
    return h, hT
