"""CUDA RG-LRU kernels for Hopper: build, bind, launch.

The kernels live in ``repro_torch/csrc/rglru.cu`` (plain C interface).  The
first call compiles it into ``build/repro_torch/<source hash>/librglru.so``
(:mod:`repro_torch.kernels._build`) and loads it with ``ctypes``; nothing
is built when this module is imported.

Two kernels compute the same bits by a fixed route of T
(:func:`pick_route`): the step kernel (one thread a channel for all T)
takes ``T <= STEP_MAX_T`` (decode), the staged kernel the rest (prefill:
blocks of :data:`CHANNELS` channels, chunks of :data:`CHUNK` steps loaded
:data:`STAGES` deep, compute warps for the gates and one walker warp for
the carry; :func:`grid` and :func:`smem_bytes` are its launch shape).
:func:`rglru_cuda` follows the route; :func:`rglru_step_cuda` and
:func:`rglru_staged_cuda` launch one kernel each, at any T >= 1, so the two
can be held against each other.  A route that cannot launch raises; no
call falls to the other route.

Each wrapper takes CUDA tensors only and checks device, dtypes (``log_a``
and the carries f32, ``gx`` bf16 or f32), contiguity, shapes and T >= 1;
it allocates the outputs with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch was refused.
``LAUNCHES["rglru"]`` counts launches of either kernel, ``ROUTES`` each
kernel's; :func:`reset_launches` sets both to 0.  Each kernel's launch
is a ``torch.library`` op (``repro_torch::rglru_step``,
``repro_torch::rglru_staged``; a fake tensor gets its shapes and never
reaches ctypes), with its cost from ``kernels/costs.py``.  The library
reports the constants it was built with, and one that differs from these
is refused.

The gradient is a third kernel (:func:`rglru_backward_cuda`, one launch
of ``rglru_backward_kernel``, op ``repro_torch::rglru_backward``), the
staged design run twice: blocks of :data:`CHANNELS` channels of one batch
row (:func:`grid`, :func:`block_channels`), chunks of
:data:`BACKWARD_CHUNK` steps in a cp.async ring, compute warps for the
gates and the outputs and one walker warp for the carry and the adjoint
(:func:`backward_smem_bytes`); the carry entering each chunk is kept in
dlog_a's first row of the chunk, and each chunk's carries are walked
again before its adjoint.  ``LAUNCHES["rglru_backward"]`` counts it.
``ops.RGLRUFn`` takes it under autograd;
``ref.rglru_backward_chunked_torch`` repeats its order in plain torch.

It replaces ``rglru_pallas`` / ``_rglru_kernel`` of
``repro/kernels/rglru/kernel.py``; the source note says what bounds it and
how the staged design meets that.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build, costs

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "rglru.cu"

#: kChannels, kChunk, kStages and kStepMaxT of csrc/rglru.cu: channels a
#: staged block owns, steps staged at a time, chunks in its load ring, and
#: the longest T the step kernel takes
CHANNELS, CHUNK, STAGES, STEP_MAX_T = 32, 128, 3, 8
#: kBwdChunk, kBwdStages and kBwdThreads of csrc/rglru.cu: the backward's
#: steps a chunk, chunks in its load ring's flight (its raw ring holds
#: BACKWARD_STAGES + 2 chunks: staged, gated, walked, written), and threads
#: a block (a walker warp and a compute thread a (quad of steps, channel)
#: cell of a chunk)
BACKWARD_CHUNK, BACKWARD_STAGES = 16, 3
BACKWARD_THREADS = 32 + BACKWARD_CHUNK // 4 * CHANNELS
CONSTANTS = (CHANNELS, CHUNK, STAGES, STEP_MAX_T, BACKWARD_CHUNK,
             BACKWARD_STAGES, BACKWARD_THREADS)

#: ``rglru``: forward launches of either route; ``rglru_backward``: the
#: backward kernel's
LAUNCHES = {"rglru": 0, "rglru_backward": 0}
ROUTES = {"step": 0, "staged": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for d in (LAUNCHES, ROUTES):
        for k in d:
            d[k] = 0


def pick_route(T: int) -> str:
    """The kernel that takes a call of T steps: ``"step"`` up to
    :data:`STEP_MAX_T`, else ``"staged"``."""
    return "step" if T <= STEP_MAX_T else "staged"


def grid(B: int, D: int) -> int:
    """Blocks of a staged launch, and of a backward launch: one per batch
    row and group of :data:`CHANNELS` channels (the last group ragged)."""
    return B * -(-D // CHANNELS)


def block_channels(block: int, D: int) -> tuple[int, int, int]:
    """``(b, d0, d1)``: the batch row and channels ``[d0, d1)`` that staged
    or backward block ``block`` owns (``blockIdx.x`` in the kernel)."""
    b, g = divmod(block, -(-D // CHANNELS))
    return b, g * CHANNELS, min(D, (g + 1) * CHANNELS)


def smem_bytes(esz: int) -> int:
    """Dynamic shared memory of a staged block at gx's element size: the
    load ring (la f32 and gx, STAGES chunks) and a and b (f32) of two
    chunks."""
    return CHUNK * CHANNELS * (STAGES * (4 + esz) + 2 * 8)


def backward_smem_bytes(esz: int) -> int:
    """Dynamic shared memory of a backward block at gx's element size: the
    raw ring of la (f32), gx and dh (BACKWARD_STAGES + 2 chunks) and three
    slots of four f32 arrays a chunk (a, b or h_{t-1}, e2, g)."""
    tile = BACKWARD_CHUNK * CHANNELS
    return tile * ((BACKWARD_STAGES + 2) * (4 + 2 * esz) + 3 * 4 * 4)


def copy_channels(D: int, esz: int, la_addr: int = 0, gx_addr: int = 0
                  ) -> int:
    """Channels one copy of the staged kernel moves: the largest of 8, 4, 2
    and 1 that divides D and keeps every copy aligned to its size, ``min(16,
    4 v)`` bytes of la and ``min(16, esz v)`` of gx (at ``la_addr`` and
    ``gx_addr``).  8 at Griffin's width: 16-byte copies of both."""
    for v in (8, 4, 2, 1):
        if (D % v == 0 and la_addr % min(16, 4 * v) == 0
                and gx_addr % min(16, esz * v) == 0):
            return v
    return 1


def build() -> Path:
    """Compile ``csrc/rglru.cu`` unless a library of this source exists;
    returns the library's path."""
    return _build.build(SOURCE, "rglru")


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"repro_rglru_step_{sfx}")
                fn.argtypes = [vp, vp, vp, vp, vp,     # la gx h0 h hT
                               ll, ll, ll,             # B T D
                               vp]                     # stream
                fn.restype = i
                fn = getattr(lib, f"repro_rglru_staged_{sfx}")
                fn.argtypes = [vp, vp, vp, vp, vp, ll, ll, ll,
                               i,                      # channels a copy
                               vp]
                fn.restype = i
                fn = getattr(lib, f"repro_rglru_backward_{sfx}")
                fn.argtypes = [vp, vp, vp, vp, vp,     # la gx h0 dh dhT
                               vp, vp, vp,             # dla dgx dh0
                               ll, ll, ll, vp]         # B T D stream
                fn.restype = i
            got = (ctypes.c_int * len(CONSTANTS))()
            lib.repro_rglru_constants.argtypes = [ctypes.c_void_p]
            lib.repro_rglru_constants.restype = None
            lib.repro_rglru_constants(got)
            if tuple(got) != CONSTANTS:
                raise _build.KernelBuildError(
                    f"librglru was built with (CHANNELS, CHUNK, STAGES, "
                    f"STEP_MAX_T, BACKWARD_CHUNK, BACKWARD_STAGES, "
                    f"BACKWARD_THREADS) = {tuple(got)}, "
                    f"kernel.py says {CONSTANTS}")
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


def _launch(route: str, log_a, gx, h0, state_out):
    """Check a call and launch the ``route`` kernel through its op
    (``repro_torch::rglru_step`` / ``repro_torch::rglru_staged``), which
    writes hT into its last argument."""
    _check(log_a, gx, h0, state_out)
    B, T, D = gx.shape
    hT = state_out if state_out is not None else torch.empty(
        (B, D), dtype=torch.float32, device=gx.device)
    return _OPS[route](log_a, gx, h0, hT), hT


def _launch_op(route: str, log_a, gx, h0, hT):
    B, T, D = gx.shape
    h = torch.empty_like(gx)
    fn = getattr(_library(), f"repro_rglru_{route}_{_SUFFIX[gx.dtype]}")
    extra = () if route == "step" else (copy_channels(
        D, gx.element_size(), log_a.data_ptr(), gx.data_ptr()),)
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    _build.raise_on(fn(log_a.data_ptr(), gx.data_ptr(),
                       None if h0 is None else h0.data_ptr(), h.data_ptr(),
                       hT.data_ptr(), B, T, D, *extra, stream),
                    f"rglru {route}")
    LAUNCHES["rglru"] += 1
    ROUTES[route] += 1
    return h


def rglru_step_cuda(log_a, gx, h0=None, *, state_out=None):
    """The step kernel (one thread a channel) at any T >= 1."""
    return _launch("step", log_a, gx, h0, state_out)


def rglru_staged_cuda(log_a, gx, h0=None, *, state_out=None):
    """The staged kernel (compute warps and a walker warp) at any T >= 1."""
    return _launch("staged", log_a, gx, h0, state_out)


def rglru_cuda(log_a, gx, h0=None, *, state_out=None):
    """The RG-LRU recurrence on the card through the kernel
    :func:`pick_route` names: log_a (f32) and gx ``(B,T,D)`` -> (h
    ``(B,T,D)`` in gx's dtype, hT ``(B,D)`` f32).  ``state_out`` receives
    hT (a fresh tensor when None) and may be ``h0`` itself."""
    route = pick_route(gx.shape[1]) if gx.dim() == 3 else "step"
    return _launch(route, log_a, gx, h0, state_out)


def _check_backward(log_a, gx, h0, dh, dhT) -> None:
    _check(log_a, gx, h0, None)
    B, T, D = gx.shape
    if not (isinstance(dh, torch.Tensor) and dh.device == gx.device
            and dh.dtype == gx.dtype and dh.is_contiguous()
            and dh.shape == gx.shape):
        raise ValueError(f"dh must be a contiguous {gx.dtype} tensor of "
                         f"shape {tuple(gx.shape)} on {gx.device}")
    if dhT is not None and not (
            isinstance(dhT, torch.Tensor) and dhT.device == gx.device
            and dhT.dtype == torch.float32 and dhT.is_contiguous()
            and tuple(dhT.shape) == (B, D)):
        raise ValueError(f"dhT must be a contiguous f32 tensor of shape "
                         f"{(B, D)} on {gx.device}")


def rglru_backward_cuda(log_a, gx, h0, dh, dhT=None):
    """The RG-LRU's gradient on the card (``rglru_backward_kernel``): given
    the forward's inputs and the gradients of its outputs, ``dh`` ``(B, T,
    D)`` in gx's dtype and ``dhT`` ``(B, D)`` f32 (None: zero), returns
    ``(dlog_a f32, dgx in gx's dtype, dh0 f32 or None when h0 is None)``,
    bit-equal to :func:`~repro_torch.kernels.rglru.ref.rglru_backward_torch`
    where torch's exp on the card is CUDA's expf.  One launch, through the
    ``repro_torch::rglru_backward`` op."""
    _check_backward(log_a, gx, h0, dh, dhT)
    dla, dgx, dh0 = _BACKWARD_OP(log_a, gx, h0, dh, dhT)
    return dla, dgx, (None if h0 is None else dh0)


def _backward_op(log_a, gx, h0, dh, dhT):
    B, T, D = gx.shape
    dla = torch.empty_like(log_a)
    dgx = torch.empty_like(gx)
    dh0 = torch.empty((B, D), dtype=torch.float32, device=gx.device)
    fn = getattr(_library(), f"repro_rglru_backward_{_SUFFIX[gx.dtype]}")
    stream = torch.cuda.current_stream(gx.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.raise_on(fn(log_a.data_ptr(), gx.data_ptr(), ptr(h0),
                       dh.data_ptr(), ptr(dhT), dla.data_ptr(),
                       dgx.data_ptr(), dh0.data_ptr(), B, T, D, stream),
                    "rglru backward")
    LAUNCHES["rglru_backward"] += 1
    return dla, dgx, dh0


# ``torch.library`` ops, one a kernel, so that a fake tensor (the
# dry-run's) reaches a shape function and never ctypes.  hT may be h0
# itself, and an op's output may not alias an input: hT is its last
# argument, written in place, and the wrapper returns it.

def _cost(log_a, gx, h0, hT):
    return (*costs.rglru_cost(*gx.shape, gx.element_size(),
                              h0=h0 is not None), "cuda_core")


_OPS = {route: costs.kernel_op(
    f"rglru_{route}(Tensor log_a, Tensor gx, Tensor? h0, Tensor(a!) hT) "
    f"-> Tensor", lambda *a, route=route: _launch_op(route, *a),
    lambda log_a, gx, *_: torch.empty_like(gx), "rglru", _cost)
    for route in ("step", "staged")}


def _backward_cost(log_a, gx, h0, dh, dhT):
    return (*costs.rglru_backward_cost(*gx.shape, gx.element_size(),
                                       h0=h0 is not None,
                                       dhT=dhT is not None), "cuda_core")


_BACKWARD_OP = costs.kernel_op(
    "rglru_backward(Tensor log_a, Tensor gx, Tensor? h0, Tensor dh, "
    "Tensor? dhT) -> (Tensor, Tensor, Tensor)", _backward_op,
    lambda log_a, gx, h0, dh, dhT: (
        torch.empty_like(log_a), torch.empty_like(gx),
        log_a.new_empty((gx.shape[0], gx.shape[2]))),
    "rglru_backward", _backward_cost)
