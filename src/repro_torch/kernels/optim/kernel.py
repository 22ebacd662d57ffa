"""CUDA optimizer kernels for Hopper: build, bind, launch.

The kernels live in ``repro_torch/csrc/adamw.cu`` (plain C interface).  The
first call compiles it into ``build/repro_torch/<source hash>/libadamw.so``
(:mod:`repro_torch.kernels._build`) and loads it with ``ctypes``; nothing
is built when this module is imported.

Two multi-tensor kernels, each one launch over every leaf of a train step:

  * ``sumsq_kernel`` (:func:`sumsq_cuda`, op ``repro_torch::sumsq``): the
    squared sum of every gradient leaf in f32, one f32 a leaf, summed in a
    fixed order (chunks of :data:`CHUNK` elements, a block each, partials
    summed in chunk order by the last block): two runs give the same bits;
  * ``adamw_update_kernel`` (:func:`adamw_update_cuda`, op
    ``repro_torch::adamw_update``): the clip's scaling and the AdamW update
    of every leaf, in place, bit-equal to the plain torch ops of
    ``ref.adamw_update_torch``.

Both take a leaf table (:func:`leaf_rows`: a row a leaf, its addresses,
element count, dtypes and first chunk), built on the host for each launch
and passed by value as a kernel parameter, at most :data:`MAX_LEAVES`
rows: a graph captured around a launch keeps the rows in its node, so
nothing on the device outlives the call.  The sumsq kernel's partials and
its zeroed counter are allocated for each launch (from the graph's pool
when a graph is captured, where the counter's zeroing is captured too).

Each wrapper takes CUDA tensors only (bf16 or f32 gradients and parameters,
f32 moments, contiguous) and raises on anything else; it launches on
PyTorch's current stream and raises if the launch was refused.
``LAUNCHES["sumsq"]`` and ``LAUNCHES["adamw_update"]`` count the launches;
:func:`reset_launches` sets them to 0.  The library reports the constants
it was built with, and one that differs from these is refused.

They replace no Pallas kernel: ``repro``'s clip and update are XLA's fusion
inside ``jax.jit`` (``src/repro/launch/train.py:65``); the source note says
what bounds them.
"""

from __future__ import annotations

import bisect
import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, costs

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "adamw.cu"

#: kThreads, kChunk and kMaxLeaves of csrc/adamw.cu: threads a block,
#: elements a chunk (a block's work), the leaf table's rows a launch;
#: GROUP (kGroup) elements a thread's 16-byte step
THREADS, CHUNK, MAX_LEAVES, GROUP = 256, 32768, 448, 8
CONSTANTS = (THREADS, CHUNK, MAX_LEAVES)

LAUNCHES = {"sumsq": 0, "adamw_update": 0}

#: the leaf table's dtype codes (m and v are always f32)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_lib_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def n_chunks(n: int) -> int:
    """Chunks of a leaf of ``n`` elements."""
    return -(-n // CHUNK)


def first_chunks(numels) -> list[int]:
    """Each leaf's first chunk: the chunks of the leaves before it."""
    out, c = [], 0
    for n in numels:
        out.append(c)
        c += n_chunks(n)
    return out


def leaf_rows(numels, gtypes, g_addrs, p_addrs=None, m_addrs=None,
              v_addrs=None, ptypes=None) -> np.ndarray:
    """The leaf table, ``(L, 8)`` int64: per leaf the addresses of g, p, m
    and v (0 where not given: sumsq reads g only), its element count, g's
    and p's dtype codes and its first chunk (``csrc/adamw.cu``'s
    ``Leaf``)."""
    L = len(numels)
    zeros = [0] * L
    cols = [g_addrs, p_addrs or zeros, m_addrs or zeros, v_addrs or zeros,
            list(numels), list(gtypes), list(ptypes or zeros),
            first_chunks(numels)]
    return np.array(cols, dtype=np.int64).T.reshape(L, 8).copy()


def chunk_span(first: list, numels, c: int) -> tuple[int, int, int]:
    """``(leaf, start, count)`` of chunk ``c``: the kernels' ``find_leaf``
    (the last leaf whose first chunk is <= c) and the chunk's elements."""
    leaf = bisect.bisect_right(first, c) - 1
    start = (c - first[leaf]) * CHUNK
    return leaf, start, min(CHUNK, numels[leaf] - start)


def build() -> Path:
    """Compile ``csrc/adamw.cu`` unless a library of this source exists;
    returns the library's path."""
    return _build.build(SOURCE, "adamw")


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong,
                            ctypes.c_int, ctypes.c_float)
            lib.repro_sumsq.argtypes = [vp, i, ll,      # leaves n chunks
                                        vp, vp, vp,     # partials out ctr
                                        vp]             # stream
            lib.repro_sumsq.restype = i
            lib.repro_adamw_update.argtypes = [
                vp, i, ll,                  # leaves n_leaves n_chunks
                vp, vp, vp, vp,             # scale lr bc1 bc2
                f, f, f, f, f, f,           # b1 1-b1 b2 1-b2 eps wd
                vp]                         # stream
            lib.repro_adamw_update.restype = i
            got = (ctypes.c_int * len(CONSTANTS))()
            lib.repro_adamw_constants.argtypes = [ctypes.c_void_p]
            lib.repro_adamw_constants.restype = None
            lib.repro_adamw_constants(got)
            if tuple(got) != CONSTANTS:
                raise _build.KernelBuildError(
                    f"libadamw was built with (THREADS, CHUNK, "
                    f"MAX_LEAVES) = "
                    f"{tuple(got)}, kernel.py says {CONSTANTS}")
            _lib = lib
        return _lib


def _table(grads, params=None, ms=None, vs=None):
    """The leaf table of these leaves (``grads`` alone for sumsq) and its
    chunks."""
    numels = [g.numel() for g in grads]
    addr = lambda ts: None if ts is None else [t.data_ptr() for t in ts]  # noqa: E731
    rows = leaf_rows(numels, [DTYPE_CODES[g.dtype] for g in grads],
                     addr(grads), addr(params), addr(ms), addr(vs),
                     None if params is None
                     else [DTYPE_CODES[p.dtype] for p in params])
    return rows, sum(n_chunks(n) for n in numels)


def _check(what: str, ts, dtypes) -> None:
    if not ts:
        raise ValueError(f"{what}: no leaves")
    if len(ts) > MAX_LEAVES:
        raise ValueError(f"{what}: {len(ts)} leaves, a launch takes at most "
                         f"{MAX_LEAVES}")
    dev = ts[0].device
    for t in ts:
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            raise ValueError(f"{what} takes CUDA tensors only; got one on "
                             f"{getattr(t, 'device', type(t))}")
        if t.device != dev:
            raise ValueError(f"{what}: leaves on {dev} and {t.device}")
        if t.dtype not in dtypes:
            raise ValueError(f"{what}: dtype {t.dtype} not in "
                             f"{tuple(dtypes)}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: leaves must be contiguous")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def sumsq_cuda(grads) -> torch.Tensor:
    """The squared sum of each of ``grads`` (bf16 or f32 CUDA tensors) in
    f32: an ``(L,)`` f32 tensor, one launch of ``sumsq_kernel`` through
    the ``repro_torch::sumsq`` op."""
    grads = list(grads)
    _check("sumsq_cuda", grads, DTYPE_CODES)
    return _SUMSQ_OP(grads)


def _sumsq_op(grads):
    dev = grads[0].device
    out = torch.zeros(len(grads), dtype=torch.float32, device=dev)
    rows, chunks = _table(grads)
    if chunks == 0:
        return out                      # nothing to read: every sum is 0
    lib = _library()
    partials = torch.empty(chunks, dtype=torch.float32, device=dev)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.raise_on(lib.repro_sumsq(
        rows.ctypes.data, len(rows), chunks, partials.data_ptr(),
        out.data_ptr(), counter.data_ptr(), stream), "sumsq")
    LAUNCHES["sumsq"] += 1
    return out


def _scalar(name: str, t, dev) -> None:
    if not (isinstance(t, torch.Tensor) and t.device == dev
            and t.dtype == torch.float32 and t.numel() == 1):
        raise ValueError(f"adamw_update_cuda: {name} must be a one-element "
                         f"f32 tensor on {dev}")


def adamw_update_cuda(grads, params, ms, vs, *, scale, lr, bc1, bc2,
                      b1: float, b2: float, eps: float,
                      weight_decay: float) -> None:
    """The clip's scaling (``scale``: a 0-d f32 tensor, or None for no
    clip) and the AdamW update of every leaf, in place (``params``, ``ms``,
    ``vs``), in one launch of ``adamw_update_kernel`` through the
    ``repro_torch::adamw_update`` op.  ``lr``, ``bc1`` and ``bc2`` are 0-d
    f32 tensors on the leaves' device; the grads are read, not written."""
    grads, params, ms, vs = (list(x) for x in (grads, params, ms, vs))
    _check("adamw_update_cuda", grads, DTYPE_CODES)
    _check("adamw_update_cuda", params, DTYPE_CODES)
    _check("adamw_update_cuda", ms + vs, (torch.float32,))
    if not (len(grads) == len(params) == len(ms) == len(vs)):
        raise ValueError("adamw_update_cuda: grads, params and moments "
                         "differ in number")
    for g, p, m, v in zip(grads, params, ms, vs):
        if not (g.shape == p.shape == m.shape == v.shape):
            raise ValueError(f"adamw_update_cuda: shapes {tuple(g.shape)}, "
                             f"{tuple(p.shape)}, {tuple(m.shape)}, "
                             f"{tuple(v.shape)} differ")
    dev = grads[0].device
    if params[0].device != dev or ms[0].device != dev:
        raise ValueError("adamw_update_cuda: leaves on different devices")
    for name, t in (("lr", lr), ("bc1", bc1), ("bc2", bc2)):
        _scalar(name, t, dev)
    if scale is not None:
        _scalar("scale", scale, dev)
    _ADAMW_OP(grads, params, ms, vs, scale, lr, bc1, bc2, float(b1),
              float(b2), float(eps), float(weight_decay))


def _adamw_op(grads, params, ms, vs, scale, lr, bc1, bc2, b1, b2, eps, wd):
    rows, chunks = _table(grads, params, ms, vs)
    if chunks == 0:
        return
    lib = _library()
    stream = torch.cuda.current_stream(grads[0].device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.raise_on(lib.repro_adamw_update(
        rows.ctypes.data, len(rows), chunks, ptr(scale),
        lr.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2,
        1 - b2, eps, wd, stream), "adamw update")
    LAUNCHES["adamw_update"] += 1


# ``torch.library`` ops, one a kernel, so that a fake tensor (the
# dry-run's) reaches a shape function and never ctypes.

def _sumsq_cost(grads):
    return (*costs.sumsq_cost([g.numel() for g in grads],
                              [g.element_size() for g in grads]),
            "cuda_core")


_SUMSQ_OP = costs.kernel_op(
    "sumsq(Tensor[] grads) -> Tensor", _sumsq_op,
    lambda grads: grads[0].new_empty((len(grads),), dtype=torch.float32),
    "sumsq", _sumsq_cost)


def _adamw_cost(grads, params, ms, vs, *_):
    return (*costs.adamw_update_cost(
        [g.numel() for g in grads], [g.element_size() for g in grads],
        [p.element_size() for p in params]), "cuda_core")


_ADAMW_OP = costs.kernel_op(
    "adamw_update(Tensor[] grads, Tensor(a!)[] params, Tensor(b!)[] m, "
    "Tensor(c!)[] v, Tensor? scale, Tensor lr, Tensor bc1, Tensor bc2, "
    "float b1, float b2, float eps, float weight_decay) -> ()",
    _adamw_op, lambda *args: None, "adamw_update", _adamw_cost)
