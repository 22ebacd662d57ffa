"""CUDA flash-attention kernel for Hopper: build, bind, launch.

The kernel lives in ``repro_torch/csrc/flash_attention.cu`` (plain C
interface).  The first call compiles it into ``build/repro_torch/<source
hash>/libflash_attention.so`` (:mod:`repro_torch.kernels._build`) and loads
it with ``ctypes``; nothing is built when this module is imported.

:func:`flash_attention_cuda` takes CUDA tensors only and checks device,
dtype (bf16 or f32, the same for q, k and v), contiguity and 16-byte
alignment (the kernel moves tiles in 16-byte vectors), shapes and head
dims (the (D, Dv) pairs of :data:`HEAD_DIMS`); it allocates the output
with ``torch.empty``, launches on PyTorch's current stream and raises if
the launch was refused.
``LAUNCHES["flash_attention"]`` counts launches; :func:`reset_launches`
sets it to 0.

It replaces ``flash_attention_pallas`` / ``_fa_kernel`` of
``repro/kernels/flash_attention/kernel.py``; the source note says what
bounds it and what the simple design leaves on the table.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "flash_attention.cu"

#: (D of q/k, Dv of v) pairs the kernel is built and checked for
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 128), (256, 256))

LAUNCHES = {"flash_attention": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` unless a library of this source
    exists; returns the library's path."""
    return _build.build(SOURCE, "flash_attention")


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"repro_flash_attention_{sfx}")
                fn.argtypes = [
                    vp, vp, vp, vp,                 # q k v o
                    ll, ll, ll, ll, ll, ll, ll,     # B Sq Skv H KV D Dv
                    ll, ll, ll,                     # q_start kv_len window
                    ctypes.c_int, ctypes.c_float,   # causal scale
                    vp]                             # stream
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            raise ValueError("flash_attention_cuda takes CUDA tensors only; "
                             f"{name} is not one")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous 4-D tensor "
                             f"starting on a 16-byte boundary")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} ({t.dtype} on {t.device}) must match "
                             f"q ({q.dtype} on {q.device})")
    if q.dtype not in _SUFFIX:
        raise ValueError(f"dtype {q.dtype} not in {tuple(_SUFFIX)}")
    if q.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {q.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    B, Sq, H, D = q.shape
    Bk, Skv, KV, Dk = k.shape
    if (Bk, Skv, KV) != tuple(v.shape[:3]) or Bk != B:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} disagree on batch, keys or heads")
    if Dk != D:
        raise ValueError(f"q and k head dims differ: {D} vs {Dk}")
    if KV == 0 or H % KV:
        raise ValueError(f"{H} query heads do not group over {KV} KV heads")
    if B * KV > 65535:
        raise ValueError(f"batch x KV heads = {B * KV} exceeds the grid's "
                         f"y limit of 65535")
    if (D, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = {(D, v.shape[3])} not in "
                         f"{HEAD_DIMS}")


def flash_attention_cuda(q, k, v, *, causal: bool, window: int | None,
                         q_start: int, kv_len: int,
                         softmax_scale: float | None = None):
    """Forward GQA attention on the card: q ``(B,Sq,H,D)``, k ``(B,Skv,KV,D)``,
    v ``(B,Skv,KV,Dv)`` -> ``(B,Sq,H,Dv)`` in q's dtype (f32 accumulation)."""
    _check(q, k, v)
    if q_start < 0 or kv_len < 0:
        raise ValueError(f"q_start {q_start} and kv_len {kv_len} must be >= 0")
    if window is not None and window < 0:
        raise ValueError(f"window {window} must be >= 0")
    B, Sq, H, D = q.shape
    _, Skv, KV, Dv = v.shape
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    scale = float(softmax_scale if softmax_scale is not None else D ** -0.5)
    fn = getattr(_library(), f"repro_flash_attention_{_SUFFIX[q.dtype]}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _build.raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, Sq, Skv, H, KV, D, Dv, q_start,
                       min(kv_len, Skv), -1 if window is None else window,
                       int(bool(causal)), scale, stream), "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return out
