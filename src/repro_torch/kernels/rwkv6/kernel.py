"""CUDA WKV-6 kernel for Hopper: build, bind, launch.

The kernel lives in ``repro_torch/csrc/wkv6.cu`` (plain C interface).  The
first call compiles it into ``build/repro_torch/<source hash>/libwkv6.so``
(:mod:`repro_torch.kernels._build`) and loads it with ``ctypes``; nothing
is built when this module is imported.

:func:`wkv6_cuda` takes CUDA tensors only and checks device, dtype (bf16
or f32, one for r, k, v, w and u; the states f32), contiguity, shapes,
T >= 1 and the head size N (one of :data:`HEAD_SIZES`); it allocates the
output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch was refused.  ``LAUNCHES["wkv6"]`` counts launches;
:func:`reset_launches` sets it to 0.  The launch is the ``repro_torch::
wkv6`` op (``torch.library``; a fake tensor gets its shapes and never
reaches ctypes), with its cost from ``kernels/costs.py``.

It replaces ``wkv6_pallas`` / ``_wkv6_kernel`` of
``repro/kernels/rwkv6/kernel.py``; the source note says what bounds it and
how its design meets that.  The kernel splits the work by
:data:`TILE_COLS` columns of the state a block, :data:`ROW_SPLIT` lanes a
column, :data:`CHUNK` steps staged at a time and :data:`BONUS_SPLIT` lanes
a step's bonus; :func:`block_tile` is its
grid rule, and ``ref.wkv6_tiled_torch`` repeats its decomposition in plain
PyTorch.  The library reports the constants it was built with, and one
that differs from these is refused.

The gradient is a kernel of its own, in ``csrc/wkv6_backward.cu``
(``libwkv6_backward.so``): :func:`wkv6_backward_cuda`, one call of
``wkv6_backward_kernel`` (a cluster of :data:`BACKWARD_CLUSTER` blocks a
(batch row, head), each owning N / BACKWARD_CLUSTER rows of the state,
:data:`BACKWARD_ROW_LANES` threads a row, dv's column sums merged across
the cluster in rank order; :func:`backward_shape`,
:func:`backward_block`) and of ``wkv6_du_kernel`` (u's gradient summed
over the batch rows in order), through the op
``repro_torch::wkv6_backward``; ``LAUNCHES["wkv6_backward"]`` counts it.
``ops.WKV6Fn`` takes it under autograd; ``ref.wkv6_backward_torch`` is its
plain version.
It replaces no TPU kernel: ``repro`` differentiates ``wkv6_ref``'s scan
(``jax.value_and_grad`` in ``repro/launch/steps.py``).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build, costs

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "wkv6.cu"
BACKWARD_SOURCE = SOURCE.with_name("wkv6_backward.cu")

#: head sizes N the kernel is instantiated for (smoke 16, rwkv6-7b 64)
HEAD_SIZES = (16, 32, 64)
#: kTileCols, kRowSplit, kChunk and kBonusSplit of csrc/wkv6.cu: columns
#: of the state a block owns (at most N), lanes a column's rows are split
#: over, steps staged in shared memory at a time, and lanes a step's bonus
#: is split over
TILE_COLS, ROW_SPLIT, CHUNK, BONUS_SPLIT = 16, 8, 16, 8
CONSTANTS = (TILE_COLS, ROW_SPLIT, CHUNK, BONUS_SPLIT)
#: kRowLanes, kChunk, kInterval and kCluster of csrc/wkv6_backward.cu:
#: threads a row of the state is split over (N / BACKWARD_ROW_LANES
#: columns each), the steps whose states a thread walks again into
#: registers, the steps between the forward walk's f32 checkpoints (an
#: interval's chunk starts are kept in shared memory), and the blocks of a
#: (batch row, head)'s cluster, the state's rows split between them
BACKWARD_ROW_LANES, BACKWARD_CHUNK, BACKWARD_INTERVAL, BACKWARD_CLUSTER = (
    8, 8, 32, 2)
BACKWARD_CONSTANTS = (BACKWARD_ROW_LANES, BACKWARD_CHUNK, BACKWARD_INTERVAL,
                      BACKWARD_CLUSTER)

#: ``wkv6``: forward launches; ``wkv6_backward``: the backward's
LAUNCHES = {"wkv6": 0, "wkv6_backward": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_lib = None
_backward_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tile_cols(N: int) -> int:
    """Columns of the state one block owns at head size ``N``."""
    return min(N, TILE_COLS)


def grid(B: int, H: int, N: int) -> int:
    """Blocks of one launch: one per (b, h, tile of columns)."""
    return B * H * (N // tile_cols(N))


def block_tile(block: int, H: int, N: int) -> tuple[int, int, int, int]:
    """``(b, h, j0, j1)``: the batch row, head and columns ``[j0, j1)`` of
    the state that block ``block`` owns (``blockIdx.x`` in the kernel)."""
    jt = tile_cols(N)
    bh, tile = divmod(block, N // jt)
    b, h = divmod(bh, H)
    return b, h, tile * jt, (tile + 1) * jt


def backward_shape(N: int) -> tuple[int, int, int, int]:
    """``(NR, cols, RW, W)`` of a backward block at head size N: the rows
    of the state it owns, the columns a thread owns (one row,
    BACKWARD_ROW_LANES threads a row on neighbouring lanes), the rows a
    warp holds and the warps a block has (``NR * BACKWARD_ROW_LANES``
    threads)."""
    nr = N // BACKWARD_CLUSTER
    threads = nr * BACKWARD_ROW_LANES
    return nr, N // BACKWARD_ROW_LANES, 32 // BACKWARD_ROW_LANES, threads // 32


def backward_block(block: int, H: int, N: int) -> tuple[int, int, int, int]:
    """``(b, h, i0, i1)``: the batch row, head and rows ``[i0, i1)`` of the
    state that backward block ``block`` owns (``blockIdx.x``; its rank in
    the cluster is ``block % BACKWARD_CLUSTER``)."""
    bh, rank = divmod(block, BACKWARD_CLUSTER)
    b, h = divmod(bh, H)
    nr = N // BACKWARD_CLUSTER
    return b, h, rank * nr, (rank + 1) * nr


def backward_grid(B: int, H: int) -> int:
    """Blocks of a backward launch: a cluster of BACKWARD_CLUSTER a (batch
    row, head)."""
    return B * H * BACKWARD_CLUSTER


def backward_smem_bytes(N: int, esz: int) -> int:
    """Dynamic shared memory of a backward block at the inputs' element
    size ``esz``: the staged chunk of k, w, v, r and do in f32 (5 C N
    floats), the raw ring of two chunks in the inputs' dtype (2 x 5 C N x
    esz bytes), the interval's chunk starts of its rows (K / C x NR x N),
    the warps' dv partials (2 x C W N), the rows' partial dr, dk, dw (3 C
    NR x row lanes), the chunk's bonuses and v . do (2 C) and u (N)."""
    C, K, L = BACKWARD_CHUNK, BACKWARD_INTERVAL, BACKWARD_ROW_LANES
    NR, _, _, W = backward_shape(N)
    return 4 * (5 * C * N + K // C * NR * N + 2 * C * W * N
                + 3 * C * NR * L + 2 * C + N) + 2 * 5 * C * N * esz


def build() -> Path:
    """Compile ``csrc/wkv6.cu`` unless a library of this source exists;
    returns the library's path."""
    return _build.build(SOURCE, "wkv6")


def build_backward() -> Path:
    """Compile ``csrc/wkv6_backward.cu`` unless a library of this source
    exists; returns the library's path."""
    return _build.build(BACKWARD_SOURCE, "wkv6_backward")


def bind_backward(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a backward library's entries (this
    source's or an edited copy's) and check its constants."""
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    for sfx in _SUFFIX.values():
        fn = getattr(lib, f"repro_wkv6_backward_{sfx}")
        fn.argtypes = [vp, vp, vp, vp, vp,         # r k v w u
                       vp, vp, vp,                 # s0 do dsT
                       vp, vp, vp, vp, vp, vp,     # dr dk dv dw du ds0
                       vp, vp,                     # checkpoints, du partials
                       ll, ll, ll, ll,             # B T H N
                       vp]                         # stream
        fn.restype = ctypes.c_int
    got = (ctypes.c_int * len(BACKWARD_CONSTANTS))()
    lib.repro_wkv6_backward_constants.argtypes = [ctypes.c_void_p]
    lib.repro_wkv6_backward_constants.restype = None
    lib.repro_wkv6_backward_constants(got)
    if tuple(got) != BACKWARD_CONSTANTS:
        raise _build.KernelBuildError(
            f"libwkv6_backward was built with (row lanes, chunk, "
            f"interval, cluster) = "
            f"{tuple(got)}, kernel.py says {BACKWARD_CONSTANTS}")
    return lib


def _backward_library() -> ctypes.CDLL:
    global _backward_lib
    with _lib_lock:
        if _backward_lib is None:
            _backward_lib = bind_backward(ctypes.CDLL(str(build_backward())))
        return _backward_lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll = ctypes.c_void_p, ctypes.c_longlong
            for sfx in _SUFFIX.values():
                fn = getattr(lib, f"repro_wkv6_{sfx}")
                fn.argtypes = [vp, vp, vp, vp, vp,     # r k v w u
                               vp, vp, vp,             # s0 o sT
                               ll, ll, ll, ll,         # B T H N
                               vp]                     # stream
                fn.restype = ctypes.c_int
            got = (ctypes.c_int * len(CONSTANTS))()
            lib.repro_wkv6_constants.argtypes = [ctypes.c_void_p]
            lib.repro_wkv6_constants.restype = None
            lib.repro_wkv6_constants(got)
            if tuple(got) != CONSTANTS:
                raise _build.KernelBuildError(
                    f"libwkv6 was built with (JT, R, C, bonus split) = "
                    f"{tuple(got)}, kernel.py says {CONSTANTS}")
            _lib = lib
        return _lib


def _check(r, k, v, w, u, initial_state, state_out) -> None:
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            raise ValueError(f"wkv6_cuda takes CUDA tensors only; {name} "
                             f"is not one")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != r.dtype or t.device != r.device:
            raise ValueError(f"{name} ({t.dtype} on {t.device}) must match "
                             f"r ({r.dtype} on {r.device})")
    if r.dtype not in _SUFFIX:
        raise ValueError(f"dtype {r.dtype} not in {tuple(_SUFFIX)}")
    if r.device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {r.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, N); got {tuple(r.shape)}")
    B, T, H, N = r.shape
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != r "
                             f"{tuple(r.shape)}")
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u {tuple(u.shape)} != (H, N) = {(H, N)}")
    if T < 1:
        raise ValueError("wkv6_cuda needs T >= 1")
    if N not in HEAD_SIZES:
        raise ValueError(f"head size N = {N} not in {HEAD_SIZES}")
    for name, s in (("initial_state", initial_state),
                    ("state_out", state_out)):
        if s is None:
            continue
        if not (isinstance(s, torch.Tensor) and s.device == r.device
                and s.dtype == torch.float32 and s.is_contiguous()
                and tuple(s.shape) == (B, H, N, N)):
            raise ValueError(f"{name} must be a contiguous f32 tensor of "
                             f"shape {(B, H, N, N)} on {r.device}")


def wkv6_cuda(r, k, v, w, u, *, initial_state=None, state_out=None):
    """The WKV-6 recurrence on the card: r, k, v, w ``(B,T,H,N)``, u
    ``(H,N)`` -> (out ``(B,T,H,N)`` in r's dtype, final state
    ``(B,H,N,N)`` f32).  ``state_out`` receives the final state (a fresh
    tensor when None) and may be ``initial_state`` itself.  The launch is
    the ``repro_torch::wkv6`` op, which writes the final state into its
    last argument."""
    _check(r, k, v, w, u, initial_state, state_out)
    B, T, H, N = r.shape
    sT = state_out if state_out is not None else torch.empty(
        (B, H, N, N), dtype=torch.float32, device=r.device)
    return _OP(r, k, v, w, u, initial_state, sT), sT


def _launch(r, k, v, w, u, s0, sT):
    B, T, H, N = r.shape
    out = torch.empty_like(r)
    fn = getattr(_library(), f"repro_wkv6_{_SUFFIX[r.dtype]}")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _build.raise_on(fn(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       w.data_ptr(), u.data_ptr(),
                       None if s0 is None else s0.data_ptr(), out.data_ptr(),
                       sT.data_ptr(), B, T, H, N, stream), "wkv6")
    LAUNCHES["wkv6"] += 1
    return out


def _cost(r, k, v, w, u, s0, sT):
    return (*costs.wkv6_cost(*r.shape, r.element_size(),
                             initial_state=s0 is not None), "cuda_core")


# A ``torch.library`` op, so that a fake tensor (the dry-run's) reaches a
# shape function and never ctypes.  The final state may be the initial
# state itself, and an op's output may not alias an input: the state is
# its last argument, written in place, and the wrapper returns it.
_OP = costs.kernel_op(
    "wkv6(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? s0, "
    "Tensor(a!) sT) -> Tensor", _launch,
    lambda r, *_: torch.empty_like(r), "wkv6", _cost)


def _check_backward(r, k, v, w, u, s0, do, dsT) -> None:
    _check(r, k, v, w, u, s0, None)
    B, T, H, N = r.shape
    if not (isinstance(do, torch.Tensor) and do.device == r.device
            and do.dtype == r.dtype and do.is_contiguous()
            and do.shape == r.shape):
        raise ValueError(f"do must be a contiguous {r.dtype} tensor of "
                         f"shape {tuple(r.shape)} on {r.device}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("do", do)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"backward copies rows 16 bytes at a time)")
    if dsT is not None and not (
            isinstance(dsT, torch.Tensor) and dsT.device == r.device
            and dsT.dtype == torch.float32 and dsT.is_contiguous()
            and tuple(dsT.shape) == (B, H, N, N)):
        raise ValueError(f"dsT must be a contiguous f32 tensor of shape "
                         f"{(B, H, N, N)} on {r.device}")


def wkv6_backward_cuda(r, k, v, w, u, s0, do, dsT=None):
    """The WKV-6 gradient on the card: given the forward's inputs (s0 may
    be None) and the gradients of its outputs, ``do`` ``(B, T, H, N)`` in
    r's dtype and ``dsT`` ``(B, H, N, N)`` f32 (None: zero), returns
    ``(dr, dk, dv, dw in r's dtype, du (H, N) in u's dtype, ds0 f32 or None
    when s0 is None)``, as
    :func:`~repro_torch.kernels.rwkv6.ref.wkv6_backward_torch` does.
    One call, through the ``repro_torch::wkv6_backward`` op."""
    _check_backward(r, k, v, w, u, s0, do, dsT)
    out = _BACKWARD_OP(r, k, v, w, u, s0, do, dsT)
    return (*out[:5], None if s0 is None else out[5])


def backward_launch(lib, r, k, v, w, u, s0, do, dsT):
    """One launch of the backward entries of ``lib`` (a
    :func:`bind_backward`-ed library: this source's, or an edited copy's)
    on checked inputs; returns the six outputs, ds0 whether s0 is given or
    not.  Counts nothing: the op counts its own launches."""
    B, T, H, N = r.shape
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    ds0 = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    intervals = -(-T // BACKWARD_INTERVAL)
    ckpt = torch.empty((B, H, intervals, N, N), dtype=torch.float32,
                       device=r.device)
    du_part = torch.empty((B, H, N), dtype=torch.float32, device=r.device)
    fn = getattr(lib, f"repro_wkv6_backward_{_SUFFIX[r.dtype]}")
    stream = torch.cuda.current_stream(r.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.raise_on(fn(*(ptr(t) for t in (r, k, v, w, u, s0, do, dsT, dr,
                                          dk, dv, dw, du, ds0, ckpt,
                                          du_part)), B, T, H, N, stream),
                    "wkv6 backward")
    return dr, dk, dv, dw, du, ds0


def _backward_op(r, k, v, w, u, s0, do, dsT):
    out = backward_launch(_backward_library(), r, k, v, w, u, s0, do, dsT)
    LAUNCHES["wkv6_backward"] += 1
    return out


def _backward_cost(r, k, v, w, u, s0, do, dsT):
    return (*costs.wkv6_backward_cost(*r.shape, r.element_size(),
                                      s0=s0 is not None,
                                      dsT=dsT is not None), "cuda_core")


_BACKWARD_OP = costs.kernel_op(
    "wkv6_backward(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, "
    "Tensor? s0, Tensor dout, Tensor? dsT) -> (Tensor, Tensor, Tensor, "
    "Tensor, Tensor, Tensor)", _backward_op,
    lambda r, k, v, w, u, s0, do, dsT: (
        *(torch.empty_like(r) for _ in range(4)), torch.empty_like(u),
        r.new_empty(r.shape[:1] + r.shape[2:] + r.shape[3:],
                    dtype=torch.float32)),
    "wkv6_backward", _backward_cost)
