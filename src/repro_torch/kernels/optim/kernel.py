"""CUDA optimizer kernels for Hopper: build, bind, launch.

The kernels live in ``repro_torch/csrc/adamw.cu`` and
``repro_torch/csrc/adafactor.cu`` (plain C interfaces).  The first call of
each compiles it into ``build/repro_torch/<source hash>/lib<name>.so``
(:mod:`repro_torch.kernels._build`) and loads it with ``ctypes``; nothing
is built when this module is imported.

Two multi-tensor kernels of ``adamw.cu``, each one launch over every leaf
of a train step:

  * ``sumsq_kernel`` (:func:`sumsq_cuda`, op ``repro_torch::sumsq``): the
    squared sum of every gradient leaf in f32, one f32 a leaf, summed in a
    fixed order (chunks of :data:`CHUNK` elements, a block each, partials
    summed in chunk order by the last block): two runs give the same bits;
  * ``adamw_update_kernel`` (:func:`adamw_update_cuda`, op
    ``repro_torch::adamw_update``): the clip's scaling and the AdamW update
    of every leaf, in place, bit-equal to the plain torch ops of
    ``ref.adamw_update_torch``.

Three of ``adafactor.cu``, the clip's scaling and the Adafactor update of
every leaf (the plain version ``ref.adafactor_update_torch``), each one
launch over every leaf, tiles of :data:`TILE_ROWS` x :data:`TILE_COLS`
elements a block (:func:`adafactor_geometry`):

  * ``adafactor_sums_kernel`` (:func:`adafactor_sums_cuda`, op
    ``repro_torch::adafactor_sums``): the second moments -- each row's and
    column's sum of g2 in a fixed order, vr and vc (v for a 1-D leaf), each
    matrix's sum of vr; under sharding split in two launches, the raw sums
    (mode ``"raw"``) and, once the wrapper reduced them across ranks, the
    moments from them (:func:`adafactor_finish_cuda`, op
    ``repro_torch::adafactor_finish``, the same kernel);
  * ``adafactor_rms_kernel`` (:func:`adafactor_rms_cuda`, op
    ``repro_torch::adafactor_rms``): each leaf's sum of u u;
  * ``adafactor_update_kernel`` (:func:`adafactor_update_cuda`, op
    ``repro_torch::adafactor_update``): the parameters.

Their sums are not the plain ops' order, so the moments and parameters are
held to the plain version within a limit, and bit-equal to
``ref.adafactor_update_chunked_torch``, which repeats the kernels' order.

Every kernel takes a leaf table (:func:`leaf_rows`, :func:`adafactor_rows`:
a row a leaf, its addresses, element count, dtypes and where its chunks or
tiles start), built on the host for each launch and passed by value as a
kernel parameter, at most :data:`MAX_LEAVES` rows (Adafactor's
:data:`ADAFACTOR_MAX_LEAVES`): a graph captured around a launch keeps the
rows in its node, so nothing on the device outlives the call.  The
kernels' partials and zeroed counters are allocated for each launch (from
the graph's pool when a graph is captured, where the counters' zeroing is
captured too).

Each wrapper takes CUDA tensors only (bf16 or f32 gradients and parameters,
f32 moments, contiguous) and raises on anything else; it launches on
PyTorch's current stream and raises if the launch was refused.
``LAUNCHES`` counts the launches by kernel (``"sumsq"``,
``"adamw_update"``, ``"adafactor_sums"``, ``"adafactor_rms"``,
``"adafactor_update"``); :func:`reset_launches` sets them to 0.  Each
library reports the constants it was built with, and one that differs from
these is refused.

They replace no Pallas kernel: ``repro``'s clip and updates are XLA's
fusion inside ``jax.jit`` (``src/repro/launch/train.py:65``); the source
notes say what bounds them.
"""

from __future__ import annotations

import bisect
import ctypes
import dataclasses
import math
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build, costs

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "adamw.cu"
ADAFACTOR_SOURCE = SOURCE.with_name("adafactor.cu")

#: kThreads, kChunk and kMaxLeaves of csrc/adamw.cu: threads a block,
#: elements a chunk (a block's work), the leaf table's rows a launch;
#: GROUP (kGroup) elements a thread's 16-byte step
THREADS, CHUNK, MAX_LEAVES, GROUP = 256, 32768, 448, 8
CONSTANTS = (THREADS, CHUNK, MAX_LEAVES)

#: kTileRows, kTileCols, kMaxLeaves and kFields of csrc/adafactor.cu: a
#: tile's rows and columns (a block's work), the leaf table's rows a launch
#: and its int64 fields a row
TILE_ROWS, TILE_COLS, ADAFACTOR_MAX_LEAVES, ADAFACTOR_FIELDS = \
    128, 256, 192, 18
ADAFACTOR_CONSTANTS = (THREADS, TILE_ROWS, TILE_COLS, ADAFACTOR_MAX_LEAVES,
                       ADAFACTOR_FIELDS)
#: adafactor_sums_kernel's modes
MODES = {"fused": 0, "raw": 1, "finish": 2}

LAUNCHES = {"sumsq": 0, "adamw_update": 0, "adafactor_sums": 0,
            "adafactor_rms": 0, "adafactor_update": 0}

#: the leaf table's dtype codes (m and v are always f32)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None
_adafactor_lib = None
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


def _check(what: str, ts, dtypes, limit: int = MAX_LEAVES) -> None:
    if not ts:
        raise ValueError(f"{what}: no leaves")
    if len(ts) > limit:
        raise ValueError(f"{what}: {len(ts)} leaves, a launch takes at most "
                         f"{limit}")
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


def _scalar(name: str, t, dev, what: str = "adamw_update_cuda") -> None:
    if not (isinstance(t, torch.Tensor) and t.device == dev
            and t.dtype == torch.float32 and t.numel() == 1):
        raise ValueError(f"{what}: {name} must be a one-element f32 tensor "
                         f"on {dev}")


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


# ------------------------------------------------------------ Adafactor

@dataclasses.dataclass(frozen=True)
class LeafGeometry:
    """One leaf of ``csrc/adafactor.cu``'s table: a factored leaf (>= 2-D)
    as ``m`` matrices of ``r`` x ``c``, a 1-D (or 0-D) one as ``r`` rows of
    :data:`TILE_COLS` elements (its last row short); its tiles, ``n_rt`` x
    ``n_ct`` a matrix, and where its tiles, strips, matrices and sums start
    in the launch's."""

    factored: bool
    n: int
    m: int
    r: int
    c: int
    n_rt: int
    n_ct: int
    first_tile: int
    first_rstrip: int
    first_cstrip: int
    first_mat: int
    sums: int

    @property
    def tiles(self) -> int:
        return self.m * self.n_rt * self.n_ct

    @property
    def rstrips(self) -> int:
        return self.m * self.n_rt if self.factored else 0

    @property
    def cstrips(self) -> int:
        return self.m * self.n_ct if self.factored else 0

    @property
    def mats(self) -> int:
        return self.m if self.factored else 0

    @property
    def n_sums(self) -> int:
        return self.m * (self.r + self.c) if self.factored else 0


@dataclasses.dataclass(frozen=True)
class Totals:
    tiles: int
    rstrips: int
    cstrips: int
    mats: int
    sums: int


def adafactor_geometry(shapes) -> tuple[list[LeafGeometry], Totals]:
    """Each leaf's :class:`LeafGeometry` (the prefix sums over the leaves
    before it) and the launch's totals.  A leaf of no element (a shard
    that sharding left empty) owns no tile; a factored one still owns its
    rows' and columns' strips, which the finishing mode updates from the
    other ranks' sums."""
    out = []
    tiles = rstrips = cstrips = mats = sums = 0
    for shape in shapes:
        shape = tuple(shape)
        n = math.prod(shape)
        if len(shape) >= 2:
            m, r, c = math.prod(shape[:-2]), shape[-2], shape[-1]
        else:
            m, r, c = 1, -(-n // TILE_COLS), TILE_COLS
        geo = LeafGeometry(len(shape) >= 2, n, m, r, c, -(-r // TILE_ROWS),
                           -(-c // TILE_COLS), tiles, rstrips, cstrips, mats,
                           sums)
        out.append(geo)
        tiles += geo.tiles
        rstrips += geo.rstrips
        cstrips += geo.cstrips
        mats += geo.mats
        sums += geo.n_sums
    return out, Totals(tiles, rstrips, cstrips, mats, sums)


def whole_counts(shapes) -> list[int]:
    """The means' counts of unsharded leaves, three a leaf: rows R and
    columns C of a factored leaf (0 and 0 for a 1-D one) and elements n."""
    out = []
    for shape in shapes:
        shape = tuple(shape)
        rc = shape[-2:] if len(shape) >= 2 else (0, 0)
        out += [rc[0], rc[1], math.prod(shape)]
    return out


def leaf_states(shapes, states) -> list[tuple]:
    """``states`` (flat: a factored leaf's vr and vc, a 1-D leaf's v, in
    leaf order) as ``(vr, vc)`` or ``(v, None)`` a leaf."""
    out, i = [], 0
    for shape in shapes:
        if len(shape) >= 2:
            out.append((states[i], states[i + 1]))
            i += 2
        else:
            out.append((states[i], None))
            i += 1
    if i != len(states):
        raise ValueError(f"adafactor: {len(states)} state tensors, the "
                         f"leaves take {i}")
    return out


def adafactor_rows(geos, gtypes, g_addrs, s0_addrs, s1_addrs, counts,
                   p_addrs=None, ptypes=None) -> np.ndarray:
    """The leaf table, ``(L, ADAFACTOR_FIELDS)`` int64
    (``csrc/adafactor.cu``'s ``Leaf``): per leaf the addresses of g, p, vr
    (or v) and vc (0 where not given), its geometry, its dtypes' flags, and
    its means' counts (``counts``: three a leaf, :func:`whole_counts`)."""
    L = len(geos)
    rows = np.zeros((L, ADAFACTOR_FIELDS), dtype=np.int64)
    for i, g in enumerate(geos):
        R, C, N = counts[3 * i:3 * i + 3]
        flags = (int(gtypes[i]) | (int(ptypes[i]) << 1 if ptypes else 0)
                 | (4 if g.factored else 0))
        rows[i] = (g_addrs[i], p_addrs[i] if p_addrs else 0, s0_addrs[i],
                   s1_addrs[i], g.n, g.m, g.r, g.c, flags, g.first_tile,
                   g.n_rt, g.n_ct, g.first_rstrip, g.first_cstrip,
                   g.first_mat, g.sums, int(C) | (int(R) << 32), N)
    return rows


def build_adafactor() -> Path:
    """Compile ``csrc/adafactor.cu`` unless a library of this source
    exists; returns the library's path."""
    return _build.build(ADAFACTOR_SOURCE, "adafactor")


def bind_adafactor(path) -> ctypes.CDLL:
    """Load a library built from ``csrc/adafactor.cu`` (or an edited copy
    of it) and set its entries' argument types; refuses one whose
    constants differ from :data:`ADAFACTOR_CONSTANTS`."""
    lib = ctypes.CDLL(str(path))
    vp, ll, i, f = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_float)
    lib.repro_adafactor_sums.argtypes = [
        vp, i, i, ll, ll, ll,               # leaves n mode tiles strips
        vp, vp, f,                          # scale beta2 eps
        vp, vp, vp, vp,                     # rowpart colpart sums vrsum
        vp, vp, vp, vp]                     # counters, stream
    lib.repro_adafactor_sums.restype = i
    lib.repro_adafactor_rms.argtypes = [
        vp, i, ll, vp, vp, f,               # leaves n tiles scale vrsum eps
        vp, vp, vp, vp]                     # part u2sum ctr stream
    lib.repro_adafactor_rms.restype = i
    lib.repro_adafactor_update.argtypes = [
        vp, i, ll, vp, vp, vp, vp,          # leaves n tiles scale vrsum
        f, f, f, vp]                        # u2sum lr; eps 1/clip wd stream
    lib.repro_adafactor_update.restype = i
    got = (ctypes.c_int * len(ADAFACTOR_CONSTANTS))()
    lib.repro_adafactor_constants.argtypes = [ctypes.c_void_p]
    lib.repro_adafactor_constants.restype = None
    lib.repro_adafactor_constants(got)
    if tuple(got) != ADAFACTOR_CONSTANTS:
        raise _build.KernelBuildError(
            f"{Path(path).name} was built with (THREADS, TILE_ROWS, "
            f"TILE_COLS, MAX_LEAVES, FIELDS) = {tuple(got)}, kernel.py says "
            f"{ADAFACTOR_CONSTANTS}")
    return lib


def _adafactor_library() -> ctypes.CDLL:
    global _adafactor_lib
    with _lib_lock:
        if _adafactor_lib is None:
            _adafactor_lib = bind_adafactor(build_adafactor())
        return _adafactor_lib


def _adafactor_table(grads, states, geos, counts, params=None):
    pairs = leaf_states([g.shape for g in grads], states)
    addr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    return adafactor_rows(
        geos, [DTYPE_CODES[g.dtype] for g in grads],
        [g.data_ptr() for g in grads], [addr(a) for a, _ in pairs],
        [addr(b) for _, b in pairs], counts,
        None if params is None else [p.data_ptr() for p in params],
        None if params is None else [DTYPE_CODES[p.dtype] for p in params])


def _check_adafactor(what, grads, states, params=None, scalars=()) -> None:
    _check(what, grads, DTYPE_CODES, ADAFACTOR_MAX_LEAVES)
    _check(what, states, (torch.float32,), 2 * ADAFACTOR_MAX_LEAVES)
    dev = grads[0].device
    if states[0].device != dev:
        raise ValueError(f"{what}: leaves on different devices")
    shapes = [g.shape for g in grads]
    for g, (a, b) in zip(grads, leaf_states(shapes, states)):
        want = ((g.shape[:-1], g.shape[:-2] + g.shape[-1:])
                if g.dim() >= 2 else (g.shape, None))
        if a.shape != want[0] or (b is not None and b.shape != want[1]):
            raise ValueError(f"{what}: a leaf {tuple(g.shape)} with states "
                             f"{tuple(a.shape)}, "
                             f"{None if b is None else tuple(b.shape)}")
    if params is not None:
        _check(what, params, DTYPE_CODES, ADAFACTOR_MAX_LEAVES)
        if params[0].device != dev or [p.shape for p in params] != shapes:
            raise ValueError(f"{what}: parameters unlike the gradients")
    for name, t in scalars:
        _scalar(name, t, dev, what)


def adafactor_sums_cuda(grads, states, *, scale, beta2, eps: float,
                        counts=None, fused: bool = True):
    """The second moments, one launch of ``adafactor_sums_kernel`` through
    the ``repro_torch::adafactor_sums`` op: each gradient (bf16 or f32 CUDA
    tensors, read, not written) scaled by ``scale`` (a 0-d f32 tensor, or
    None) and squared; ``states`` (flat, :func:`leaf_states`) updated in
    place by ``beta2`` (a 0-d f32 tensor).  ``fused``: vr and vc updated,
    returns ``(empty, vrsum)``, each matrix's sum of vr; else a 1-D leaf's
    v updated and each row's and column's sum of g2 returned, ``(sums,
    empty)``, for :func:`adafactor_finish_cuda` once reduced.  ``counts``:
    the means' counts (:func:`whole_counts`, the default)."""
    grads, states = list(grads), list(states)
    _check_adafactor("adafactor_sums_cuda", grads, states,
                     scalars=[("beta2", beta2)]
                     + ([("scale", scale)] if scale is not None else []))
    if counts is None:
        counts = whole_counts([g.shape for g in grads])
    return _SUMS_OP(grads, states, scale, beta2, float(eps), list(counts),
                    MODES["fused" if fused else "raw"])


def adafactor_finish_cuda(sums, grads, states, *, beta2, counts=None):
    """vr and vc from each row's and column's sum of g2 (``sums``, of
    :func:`adafactor_sums_cuda` with ``fused=False``, reduced across ranks)
    and each matrix's sum of vr, returned: ``adafactor_sums_kernel`` in its
    finishing mode (a block a strip; the gradients give the geometry and
    are not read), op ``repro_torch::adafactor_finish``."""
    grads, states = list(grads), list(states)
    _check_adafactor("adafactor_finish_cuda", grads, states,
                     scalars=[("beta2", beta2)])
    if counts is None:
        counts = whole_counts([g.shape for g in grads])
    return _FINISH_OP(sums, grads, states, beta2, list(counts))


def adafactor_rms_cuda(grads, states, vrsum, *, scale, eps: float,
                       counts=None):
    """Each leaf's sum of u u, an ``(L,)`` f32 tensor: one launch of
    ``adafactor_rms_kernel`` (op ``repro_torch::adafactor_rms``), given the
    updated moments and each matrix's sum of vr."""
    grads, states = list(grads), list(states)
    _check_adafactor("adafactor_rms_cuda", grads, states,
                     scalars=[("scale", scale)] if scale is not None else [])
    if counts is None:
        counts = whole_counts([g.shape for g in grads])
    return _RMS_OP(grads, states, vrsum, scale, float(eps), list(counts))


def adafactor_update_cuda(grads, params, states, vrsum, u2sum, *, scale, lr,
                          eps: float, clip_threshold: float,
                          weight_decay: float, counts=None) -> None:
    """The parameters' update, in place: one launch of
    ``adafactor_update_kernel`` (op ``repro_torch::adafactor_update``),
    given the moments, each matrix's sum of vr and each leaf's sum of u u;
    ``lr`` a 0-d f32 tensor on the leaves' device."""
    grads, params, states = list(grads), list(params), list(states)
    _check_adafactor("adafactor_update_cuda", grads, states, params,
                     [("lr", lr)]
                     + ([("scale", scale)] if scale is not None else []))
    if counts is None:
        counts = whole_counts([g.shape for g in grads])
    _UPDATE_OP(grads, params, states, vrsum, u2sum, scale, lr, float(eps),
               float(clip_threshold), float(weight_decay), list(counts))


def _ptr(t) -> int | None:
    return None if t is None or t.numel() == 0 else t.data_ptr()


def _adafactor_sums_op(grads, states, scale, beta2, eps, counts, mode):
    geos, tot = adafactor_geometry([g.shape for g in grads])
    dev = grads[0].device
    f32 = torch.float32
    fused = mode == MODES["fused"]
    # zeros: a leaf of no element (an empty shard) writes none of its sums
    sums = torch.zeros(0 if fused else tot.sums, dtype=f32, device=dev)
    vrsum = torch.zeros(tot.mats if fused else 0, dtype=f32, device=dev)
    if tot.tiles == 0:
        return sums, vrsum              # no element on this rank
    lib = _adafactor_library()
    rows = _adafactor_table(grads, states, geos, counts)
    rowpart = torch.empty(tot.tiles * TILE_ROWS, dtype=f32, device=dev)
    colpart = torch.empty(tot.tiles * TILE_COLS, dtype=f32, device=dev)
    ctr = torch.zeros(tot.rstrips + tot.cstrips + tot.mats,
                      dtype=torch.int32, device=dev)
    at = ctr.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.raise_on(lib.repro_adafactor_sums(
        rows.ctypes.data, len(rows), mode, tot.tiles, tot.rstrips,
        tot.cstrips, _ptr(scale), beta2.data_ptr(), eps,
        rowpart.data_ptr(), colpart.data_ptr(), _ptr(sums), _ptr(vrsum),
        at, at + 4 * tot.rstrips, at + 4 * (tot.rstrips + tot.cstrips),
        stream), "adafactor sums")
    LAUNCHES["adafactor_sums"] += 1
    return sums, vrsum


def _adafactor_finish_op(sums, grads, states, beta2, counts):
    geos, tot = adafactor_geometry([g.shape for g in grads])
    dev = grads[0].device
    vrsum = torch.zeros(tot.mats, dtype=torch.float32, device=dev)
    if tot.rstrips + tot.cstrips == 0:
        return vrsum                    # no factored leaf: nothing to do
    lib = _adafactor_library()
    rows = _adafactor_table(grads, states, geos, counts)
    ctr = torch.zeros(tot.mats, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.raise_on(lib.repro_adafactor_sums(
        rows.ctypes.data, len(rows), MODES["finish"], tot.tiles,
        tot.rstrips, tot.cstrips, None, beta2.data_ptr(), 0.0, None, None,
        sums.data_ptr(), vrsum.data_ptr(), None, None, ctr.data_ptr(),
        stream), "adafactor finish")
    LAUNCHES["adafactor_sums"] += 1
    return vrsum


def _adafactor_rms_op(grads, states, vrsum, scale, eps, counts):
    geos, tot = adafactor_geometry([g.shape for g in grads])
    dev = grads[0].device
    u2sum = torch.zeros(len(grads), dtype=torch.float32, device=dev)
    if tot.tiles == 0:
        return u2sum
    lib = _adafactor_library()
    rows = _adafactor_table(grads, states, geos, counts)
    part = torch.empty(tot.tiles, dtype=torch.float32, device=dev)
    ctr = torch.zeros(len(grads), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.raise_on(lib.repro_adafactor_rms(
        rows.ctypes.data, len(rows), tot.tiles, _ptr(scale), _ptr(vrsum),
        eps, part.data_ptr(), u2sum.data_ptr(), ctr.data_ptr(), stream),
        "adafactor rms")
    LAUNCHES["adafactor_rms"] += 1
    return u2sum


def _adafactor_update_op(grads, params, states, vrsum, u2sum, scale, lr,
                         eps, clip_threshold, wd, counts):
    geos, tot = adafactor_geometry([g.shape for g in grads])
    if tot.tiles == 0:
        return
    lib = _adafactor_library()
    rows = _adafactor_table(grads, states, geos, counts, params)
    inv_clip = float(np.float32(1.0) / np.float32(clip_threshold))
    stream = torch.cuda.current_stream(grads[0].device).cuda_stream
    _build.raise_on(lib.repro_adafactor_update(
        rows.ctypes.data, len(rows), tot.tiles, _ptr(scale), _ptr(vrsum),
        u2sum.data_ptr(), lr.data_ptr(), eps, inv_clip, wd, stream),
        "adafactor update")
    LAUNCHES["adafactor_update"] += 1


def _shapes(ts) -> list:
    return [tuple(t.shape) for t in ts]


def _sums_fake(grads, states, scale, beta2, eps, counts, mode):
    _, tot = adafactor_geometry(_shapes(grads))
    fused = mode == MODES["fused"]
    new = lambda n: grads[0].new_empty((n,), dtype=torch.float32)  # noqa: E731
    return new(0 if fused else tot.sums), new(tot.mats if fused else 0)


def _sums_cost(grads, states, scale, beta2, eps, counts, mode):
    return (*costs.adafactor_sums_cost(
        _shapes(grads), [g.element_size() for g in grads],
        fused=mode == MODES["fused"]), "cuda_core")


_SUMS_OP = costs.kernel_op(
    "adafactor_sums(Tensor[] grads, Tensor(a!)[] states, Tensor? scale, "
    "Tensor beta2, float eps, int[] counts, int mode) -> (Tensor, Tensor)",
    _adafactor_sums_op, _sums_fake, "adafactor_sums", _sums_cost)


def _finish_fake(sums, grads, states, beta2, counts):
    _, tot = adafactor_geometry(_shapes(grads))
    return grads[0].new_empty((tot.mats,), dtype=torch.float32)


def _finish_cost(sums, grads, states, beta2, counts):
    return (*costs.adafactor_finish_cost(_shapes(grads)), "cuda_core")


_FINISH_OP = costs.kernel_op(
    "adafactor_finish(Tensor sums, Tensor[] grads, Tensor(a!)[] states, "
    "Tensor beta2, int[] counts) -> Tensor",
    _adafactor_finish_op, _finish_fake, "adafactor_sums", _finish_cost)


def _rms_fake(grads, states, vrsum, scale, eps, counts):
    return grads[0].new_empty((len(grads),), dtype=torch.float32)


def _rms_cost(grads, states, vrsum, scale, eps, counts):
    return (*costs.adafactor_rms_cost(
        _shapes(grads), [g.element_size() for g in grads]), "cuda_core")


_RMS_OP = costs.kernel_op(
    "adafactor_rms(Tensor[] grads, Tensor[] states, Tensor vrsum, "
    "Tensor? scale, float eps, int[] counts) -> Tensor",
    _adafactor_rms_op, _rms_fake, "adafactor_rms", _rms_cost)


def _update_cost(grads, params, *_):
    return (*costs.adafactor_update_cost(
        _shapes(grads), [g.element_size() for g in grads],
        [p.element_size() for p in params]), "cuda_core")


_UPDATE_OP = costs.kernel_op(
    "adafactor_update(Tensor[] grads, Tensor(a!)[] params, Tensor[] states, "
    "Tensor vrsum, Tensor u2sum, Tensor? scale, Tensor lr, float eps, "
    "float clip_threshold, float weight_decay, int[] counts) -> ()",
    _adafactor_update_op, lambda *args: None, "adafactor_update",
    _update_cost)
