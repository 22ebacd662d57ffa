"""CUDA flash-attention kernels for Hopper: build, bind, route, launch.

Three forward kernels and two backward ones, each its own source under
``repro_torch/csrc/`` (plain C interface), compiled at first use into
``build/repro_torch/<source hash>/lib<name>.so``
(:mod:`repro_torch.kernels._build`) and loaded with ``ctypes``; nothing is
built when this module is imported:

  * ``flash_decode.cu``       -- split-K decode, one launch, for every call
                                 whose block of rows is small
                                 (``Sq * G <= 16``) and every call at a
                                 device position (in row blocks of 16
                                 rows), bf16 or f32, every (D, Dv) of
                                 :data:`HEAD_DIMS`;
  * ``flash_prefill_sm90.cu`` -- the tensor-core (``wgmma``) prefill, for
                                 bf16 calls with ``Sq * G > 16`` at a host
                                 position and (D, Dv) in
                                 :data:`PREFILL_HEAD_DIMS`;
  * ``flash_attention.cu``    -- the simple kernel, for the rest: f32 with
                                 ``Sq * G > 16``, and the (16, 16) pair
                                 with ``Sq * G > 16``, at a host
                                 position;
  * ``flash_backward_sm90.cu`` -- the gradient (dq, dk, dv) of attention
                                 in its training forms (q_start 0; causal
                                 with Sq = Skv, with or without a window,
                                 at (D, Dv) in :data:`BACKWARD_HEAD_DIMS`,
                                 or non-causal with any Sq and Skv at
                                 :data:`NONCAUSAL_HEAD_DIMS`) on the
                                 tensor cores (``wgmma``), bf16: one entry
                                 that launches its two kernels (dQ with
                                 each row's log-sum-exp, then dK/dV),
                                 each block one tile of 64 rows and 64
                                 columns (:func:`backward_grid`);
  * ``flash_backward.cu``     -- the same gradient on CUDA cores, for f32
                                 (it also takes bf16, so that the two can
                                 be timed side by side): one entry that
                                 launches its three kernels.

:func:`pick_route` is that fixed rule for the forward, by dtype and shape,
and :func:`pick_backward_route` for the backward; neither is a fallback.
:func:`flash_backward_cuda` routes a backward call; each backward kernel
has its own wrapper too (:func:`flash_backward_sm90_cuda`,
:func:`flash_backward_simple_cuda`).  ``LAUNCHES["flash_backward"]``
counts every backward call (one launch of an entry), ``BACKWARD_ROUTES``
the calls of each kernel.  :func:`flash_attention_cuda` routes a call;
each kernel also has its own wrapper (:func:`flash_decode_cuda`,
:func:`flash_prefill_cuda`, :func:`flash_simple_cuda`), which the checks
call to hold every kernel against the plain version.  The wrappers take
CUDA tensors only, check device, dtype (bf16 or f32, the same for q, k and
v), contiguity, 16-byte alignment (the kernels move tiles in 16-byte
vectors), shapes and head dims, allocate the output (and the decode
kernel's f32 scratch) with ``torch.empty``, launch on PyTorch's current
stream and raise if the launch was refused.  ``LAUNCHES`` counts each
kernel's launches (``flash_attention`` the simple kernel's);
:func:`reset_launches` sets them, and ``BACKWARD_ROUTES``, to 0.

The decode kernel also takes its position from the device: with
``q_start`` a 0-d int64 tensor on the card, the kernel reads it there (and
``kv_len = q_start + Sq``, clipped to the cache), finds its first live
tile itself, and splits the keys by :func:`capacity_splits`, a rule of the
cache's capacity and the window and not of the position.  One launch then
serves every position, which is what a captured decode step replays
(:mod:`repro_torch.core.capture`).  ``q_start`` may also be a ``(B,)``
int64 tensor, a position per batch row (the batched decode step, whose
rows decode at their own positions): each (b, KV head) block reads its
row's, and the split rule, being the capacity's, is the same for every
row.  The other two kernels take host integers only, so a call at a
device position goes to the decode kernel whatever its rows: one with
``Sq * G > 16`` (granite-20b's multi-query decode, G = 48) runs in row
blocks of :data:`DECODE_MAX_ROWS` rows, each (batch row, KV head, row
block) with its own merge and arrival counter.

The decode kernel also takes ``kv_len`` from the device: an int32 tensor,
0-d or ``(B,)`` (the encoder-decoder's ``enc_len`` decode-state leaf, the
number of valid rows of the padded encoder buffer its cross-attention
reads), with ``q_start`` a host int (0 for cross-attention) or a device
position.  Each (b, KV head) block reads its row's length, finds its
first live tile, and the split rule is :func:`capacity_splits`, as at a
device position: one launch serves every length, which is what a captured
cross-attention step replays.  Such a call too goes to the decode kernel
whatever its rows.

Each launch is a ``torch.library`` op of the ``repro_torch`` namespace
(``flash_decode``, ``flash_prefill``, ``flash_attention``,
``flash_backward_sm90``, ``flash_backward_simple``): the wrappers check a
call and split it on the host, the op's real implementation allocates,
launches and counts, and its fake implementation gives the outputs'
shapes, so that a fake tensor (the dry-run's, ``launch/dryrun.py``) never
reaches ctypes; each op carries its cost (``kernels/costs.py``).

The forward kernels replace ``flash_attention_pallas`` / ``_fa_kernel`` of
``repro/kernels/flash_attention/kernel.py``; the backward has no Pallas
counterpart (``repro`` differentiates ``_flash_xla`` with XLA).  Each
source note says what bounds its kernel and what its design does about
it.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from repro_torch.kernels import _build, costs
from repro_torch.kernels._grad import NoBackward

CSRC = Path(__file__).resolve().parents[2] / "csrc"
#: library name -> source; one ``nvcc`` each
SOURCES = {name: CSRC / f"{name}.cu" for name in
           ("flash_attention", "flash_decode", "flash_prefill_sm90",
            "flash_backward", "flash_backward_sm90")}

#: (D of q/k, Dv of v) pairs the kernel is built and checked for
HEAD_DIMS = ((16, 16), (64, 64), (128, 128), (192, 128), (256, 256))

#: (D, Dv) pairs the tensor-core prefill takes (bf16 only): the dense
#: models' and MLA's expanded prefill (192, 128)
PREFILL_HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (256, 256))
#: kRows / kTile of csrc/flash_prefill_sm90.cu (query rows a block, keys a
#: tile) and ``Config<D, Dv>::kStages``, the stages of its K/V ring
PREFILL_TILE = 64
PREFILL_STAGES = {(64, 64): 4, (128, 128): 3, (192, 128): 2, (256, 256): 2}

#: (D, Dv) pairs the backward kernels take causal (bf16 or f32):
#: llama3.2-1b's and granite-moe's; starcoder2-7b's, granite-20b's and
#: chameleon-34b's; deepseek-v3-671b's MLA (nope + rope, v); gemma-7b's and
#: recurrentgemma-2b's
BACKWARD_HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (256, 256))
#: the pairs they also take non-causal, any Sq and Skv: seamless-m4t-
#: medium's encoder self-attention and its decoder's cross-attention
NONCAUSAL_HEAD_DIMS = ((64, 64),)
#: kTile and kCol of csrc/flash_backward_sm90.cu: rows of every tile (64
#: query rows a dQ block, 64 keys a dK/dV block) and the columns of a
#: block's accumulators (a tile of D columns is D / 64 blocks)
BACKWARD_TILE = BACKWARD_COLS = 64
#: ``Config<D, Dv>::kDqStages`` and ``kDkdvStages``: the stages of each
#: kernel's copy ring, by head dims
BACKWARD_STAGES = {(64, 64): (2, 3), (128, 128): (2, 2), (192, 128): (2, 2),
                   (256, 256): (2, 2)}

#: rows (Sq * G) of a row block of the split-K decode: the route for every
#: call of at most this many rows, and the block a call of more rows (at a
#: device position) is cut into
DECODE_MAX_ROWS = 16
#: keys per tile of the decode kernel, and the blocks its split rule aims at
#: (one per SM of an H100 SXM)
DECODE_TILE, DECODE_TARGET_BLOCKS = 32, 132
#: the most splits a decode call may ask for (the merge keeps a weight per
#: split and row in shared memory)
DECODE_MAX_SPLITS = 1024
#: the most partial bytes the split rule lets one merging block read
DECODE_MERGE_BYTES = 384 * 1024

LAUNCHES = {"flash_attention": 0, "flash_decode": 0, "flash_prefill": 0,
            "flash_backward": 0}
#: backward calls by kernel (each is also one ``LAUNCHES["flash_backward"]``)
BACKWARD_ROUTES = {"sm90": 0, "simple": 0}

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}
_libs: dict = {}
_lib_lock = threading.Lock()
_counters: dict = {}            # device index -> int32 zeros, one per
                                # (b, KV head, row block)
#: the decode kernel's grid takes at most this many (batch, KV head, row
#: block) triples: its grid's y limit and its arrival counters
MAX_PAIRS = 65535


def reset_launches() -> None:
    for d in (LAUNCHES, BACKWARD_ROUTES):
        for k in d:
            d[k] = 0


def build(name: str = "flash_attention") -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of this source exists;
    returns the library's path."""
    return _build.build(SOURCES[name], name)


_ARGS = {
    "flash_attention": ["q", "k", "v", "o", "B", "Sq", "Skv", "H", "KV", "D",
                        "Dv", "q_start", "kv_len", "window", "causal",
                        "scale", "stream"],
    "flash_prefill_sm90": ["q", "k", "v", "o", "B", "Sq", "Skv", "H", "KV",
                           "D", "Dv", "q_start", "kv_len", "window",
                           "causal", "scale", "stream"],
    "flash_decode": ["is_bf16", "q", "k", "v", "o", "part", "counter", "B",
                     "Sq", "Skv", "H", "KV", "D", "Dv", "q_start", "kv_len",
                     "window", "causal", "scale", "splits", "t0", "tpc",
                     "q_pos", "q_pos_stride", "kv_pos", "kv_pos_stride",
                     "stream"],
    "flash_backward": ["is_bf16", "q", "k", "v", "o", "do", "dq", "dk", "dv",
                       "lse", "delta", "B", "Sq", "Skv", "H", "KV", "D", "Dv",
                       "window", "causal", "scale", "stream"],
    "flash_backward_sm90": ["q", "k", "v", "o", "do", "dq", "dk", "dv", "lse",
                            "delta", "B", "Sq", "Skv", "H", "KV", "D", "Dv",
                            "window", "causal", "scale", "stream"],
}
_CTYPE = {"q": ctypes.c_void_p, "k": ctypes.c_void_p, "v": ctypes.c_void_p,
          "o": ctypes.c_void_p, "part": ctypes.c_void_p,
          "do": ctypes.c_void_p, "dq": ctypes.c_void_p,
          "dk": ctypes.c_void_p, "dv": ctypes.c_void_p,
          "lse": ctypes.c_void_p, "delta": ctypes.c_void_p,
          "counter": ctypes.c_void_p, "q_pos": ctypes.c_void_p,
          "kv_pos": ctypes.c_void_p,
          "stream": ctypes.c_void_p,
          "is_bf16": ctypes.c_int, "causal": ctypes.c_int,
          "scale": ctypes.c_float}


def _library(name: str = "flash_attention") -> ctypes.CDLL:
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)))
            entries = [f"repro_flash_attention_{sfx}"
                       for sfx in _SUFFIX.values()] \
                if name == "flash_attention" else [f"repro_{name}"]
            for entry in entries:
                fn = getattr(lib, entry)
                fn.argtypes = [_CTYPE.get(a, ctypes.c_longlong)
                               for a in _ARGS[name]]
                fn.restype = ctypes.c_int
            if name == "flash_backward_sm90":
                got = (ctypes.c_int * len(SM90_CONSTANTS))()
                lib.repro_flash_backward_sm90_constants(got)
                if tuple(got) != SM90_CONSTANTS:
                    raise _build.KernelBuildError(
                        f"libflash_backward_sm90 was built with "
                        f"{tuple(got)}, kernel.py says {SM90_CONSTANTS}")
            _libs[name] = lib
        return _libs[name]


def pick_route(Sq: int, G: int, dtype: torch.dtype, D: int, Dv: int, *,
               device_pos: bool = False) -> str:
    """Which kernel takes a call: ``"decode"`` when its block of rows is
    small (``Sq * G <= 16``) or its position or length lies on the device
    (``device_pos``: only the decode kernel reads one there; beyond 16
    rows it runs in row blocks), ``"prefill"`` for bf16 at the
    :data:`PREFILL_HEAD_DIMS`, else ``"simple"``."""
    if Sq * G <= DECODE_MAX_ROWS or device_pos:
        return "decode"
    if dtype == torch.bfloat16 and (D, Dv) in PREFILL_HEAD_DIMS:
        return "prefill"
    return "simple"


def live_tiles(Sq: int, *, causal: bool, window: int | None, q_start: int,
               kv_len: int, tile: int = DECODE_TILE) -> tuple[int, int]:
    """(first tile, number of tiles) of the keys some query of the block
    attends to: ``_fa_kernel``'s block test (keys beyond ``kv_len``, after
    the causal diagonal of the last query, before the window of the first
    are dead)."""
    k_end = min(kv_len, q_start + Sq) if causal else kv_len
    k_begin = max(0, q_start - window + 1) if window is not None else 0
    if k_end <= k_begin:
        return 0, 0
    t0 = k_begin // tile
    return t0, -(-k_end // tile) - t0


def row_blocks(Sq: int, G: int) -> int:
    """Row blocks of the split-K decode: ``ceil(Sq * G / 16)``, 1 for every
    call of at most :data:`DECODE_MAX_ROWS` rows."""
    return -(-(Sq * G) // DECODE_MAX_ROWS)


def _split(n: int, B: int, KV: int, Sq: int, H: int, Dv: int,
           splits: int | None) -> tuple[int, int]:
    """(S, tpc) for n tiles: see :func:`decode_splits`."""
    if splits is None:
        rows = Sq * (H // KV)
        want = -(-DECODE_TARGET_BLOCKS // (B * KV * row_blocks(Sq, H // KV)))
        # one block merges the splits of its row block: bound the partials
        # it reads
        per_split = 4 * min(rows, DECODE_MAX_ROWS) * (Dv + 2)
        want = min(want, max(1, DECODE_MERGE_BYTES // per_split))
        S = max(1, min(n, want))
        tpc = -(-n // S) if n else 1
        return (-(-n // tpc) if n else 1), tpc
    if splits < 1:
        raise ValueError(f"splits {splits} must be >= 1")
    return splits, (-(-n // splits) if n else 1)


def decode_splits(B: int, KV: int, Sq: int, H: int, Dv: int, *,
                  causal: bool, window: int | None, q_start: int,
                  kv_len: int,
                  splits: int | None = None) -> tuple[int, int, int]:
    """(splits S, first live tile t0, tiles per split tpc) of the split-K
    decode at a host position.  ``splits=None`` is the rule: about
    :data:`DECODE_TARGET_BLOCKS` blocks over the ``B * KV`` (batch, KV
    head) pairs and their :func:`row_blocks` whenever the live tiles
    allow, but no more than keep the partials one merging block reads
    (``S * rows * (Dv + 2)`` f32, the rows of its row block: ``Sq * G`` up
    to :data:`DECODE_MAX_ROWS`) within :data:`DECODE_MERGE_BYTES`; tpc =
    ceil(n / S) and S = ceil(n / tpc).  At most 16 rows (one row block)
    this is the rule of the kernel before row blocks, unchanged.
    An explicit S is kept, and its splits past the live range are
    empty."""
    t0, n = live_tiles(Sq, causal=causal, window=window, q_start=q_start,
                       kv_len=kv_len)
    S, tpc = _split(n, B, KV, Sq, H, Dv, splits)
    return S, t0, tpc


def capacity_tiles(Sq: int, Skv: int, *, causal: bool, window: int | None,
                   tile: int = DECODE_TILE) -> int:
    """The most tiles the live keys of a call over a cache of ``Skv`` keys
    can touch, at any position: ``ceil(Skv / tile)``, and with a causal
    window no more than ``ceil((window + Sq) / tile) + 1`` (the live keys
    of the block, ``window + Sq - 1`` of them at most, start anywhere in a
    tile)."""
    n = -(-Skv // tile)
    if causal and window is not None:
        n = min(n, -(-(window + Sq) // tile) + 1)
    return n


def capacity_splits(B: int, KV: int, Sq: int, H: int, Dv: int, *,
                    Skv: int, causal: bool, window: int | None,
                    splits: int | None = None) -> tuple[int, int]:
    """(splits S, tiles per split tpc) of the split-K decode at a device
    position: :func:`decode_splits`'s rule over the
    :func:`capacity_tiles` of the cache instead of the live tiles of one
    position.  The kernel finds the first live tile t0 from the position;
    split s takes tiles ``[t0 + s * tpc, t0 + (s + 1) * tpc)`` cut to the
    live range, and a split past it is empty.  S * tpc covers the live
    tiles at every position."""
    return _split(capacity_tiles(Sq, Skv, causal=causal, window=window),
                  B, KV, Sq, H, Dv, splits)


def _check(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (isinstance(t, torch.Tensor) and t.is_cuda):
            raise ValueError("flash_attention_cuda takes CUDA tensors only; "
                             f"{name} is not one")
        if t.dim() != 4 or not t.is_contiguous():
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
    check_pairs(B, KV)
    if (D, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"head dims (D, Dv) = {(D, v.shape[3])} not in "
                         f"{HEAD_DIMS}")


def _check_aligned(**tensors) -> None:
    """Raise unless every tensor starts on a 16-byte boundary (the kernels
    move tiles in 16-byte vectors): the one check that reads an address,
    so it runs in the ops' real implementations, never on a fake tensor."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous 4-D tensor "
                             f"starting on a 16-byte boundary")


def check_pairs(B: int, KV: int, rows: int = 1) -> None:
    """Raise unless the decode kernel's grid and its arrival counters
    (:data:`MAX_PAIRS`, one per (batch row, KV head, row block)) cover
    ``B * KV`` pairs of ``rows`` rows (``Sq * G``) each: a batched decode
    step checks its bucket with it before it builds."""
    n = B * KV * row_blocks(rows, 1)
    if n > MAX_PAIRS:
        raise ValueError(f"batch x KV heads x row blocks = {B} x {KV} x "
                         f"{row_blocks(rows, 1)} = {n} exceeds the decode "
                         f"kernel's {MAX_PAIRS} (its grid's y limit and its "
                         f"arrival counters)")


def _counter(device: torch.device) -> torch.Tensor:
    """The decode kernel's arrival counters on ``device``, one per (b, KV
    head, row block) of a launch, at ``(b * KV + kv head) * row blocks +
    row block``:
    :data:`MAX_PAIRS` int32 zeros, allocated once and never replaced (a
    captured decode graph holds their address), left at 0 by every launch.
    Every call on a device shares them, so the calls must run in order on
    one stream, as serial decode and its captured replays do: eager calls,
    a capture's warm-up and its replays are issued one after another on
    the current stream."""
    c = _counters.get(device.index)
    if c is None:
        c = torch.zeros(MAX_PAIRS, dtype=torch.int32, device=device)
        _counters[device.index] = c
    return c


def _device_len(kv_len, q) -> None:
    """Raise unless ``kv_len`` is a length on the device the decode kernel
    reads: a contiguous int32 tensor of shape () or (B,) on q's device."""
    B = q.shape[0]
    if tuple(kv_len.shape) not in ((), (B,)) or kv_len.dtype != torch.int32 \
            or kv_len.device != q.device or not kv_len.is_contiguous():
        raise ValueError(
            f"a device kv_len must be a contiguous int32 tensor of shape () "
            f"or ({B},) on {q.device}, got {kv_len.dtype} of shape "
            f"{tuple(kv_len.shape)} on {kv_len.device}")


def _args(q, k, v, *, window, q_start, kv_len, softmax_scale):
    _check(q, k, v)
    if window is not None and window < 0:
        raise ValueError(f"window {window} must be >= 0")
    B, Sq, H, D = q.shape
    _, Skv, KV, Dv = v.shape
    if torch.is_tensor(kv_len):
        # a length on the device: the decode kernel reads it there
        _device_len(kv_len, q)
        kv_len = Skv
    if torch.is_tensor(q_start):
        # a device position, one for every row or one per batch row: the
        # decode kernel derives kv_len from it
        if tuple(q_start.shape) not in ((), (B,)) \
                or q_start.dtype != torch.int64 \
                or q_start.device != q.device \
                or not q_start.is_contiguous():
            raise ValueError(
                f"a device q_start must be a contiguous int64 tensor of "
                f"shape () or ({B},) on {q.device}, got {q_start.dtype} of "
                f"shape {tuple(q_start.shape)} on {q_start.device}")
        kv_len = Skv
    elif kv_len is None:
        kv_len = Skv
    elif q_start < 0 or kv_len < 0:
        raise ValueError(f"q_start {q_start} and kv_len {kv_len} must be >= 0")
    scale = float(softmax_scale if softmax_scale is not None else D ** -0.5)
    return B, Sq, Skv, H, KV, D, Dv, min(kv_len, Skv), scale


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _decode(q, k, v, *, causal, window, q_start, kv_len, softmax_scale,
            splits):
    """Check a split-K decode call, split it, and launch it through the
    ``repro_torch::flash_decode`` op; returns (out, partials (B*KV, S,
    Sq*G, Dv + 2) f32).  ``q_start`` is a host int, or an int64 tensor on
    the card, 0-d or a position per batch row (then each row's ``kv_len``
    is its ``q_start + Sq`` and the split rule is :func:`capacity_splits`).
    ``kv_len`` is a host int, None, or an int32 tensor on the card, 0-d or
    a length per batch row (then it is each row's ``kv_len``, whatever
    ``q_start`` is, and the split rule :func:`capacity_splits`).  Any
    number of rows ``Sq * G``: beyond :data:`DECODE_MAX_ROWS`, in row
    blocks."""
    kv_dev = kv_len if torch.is_tensor(kv_len) else None
    B, Sq, Skv, H, KV, D, Dv, kv_len, scale = _args(
        q, k, v, window=window, q_start=q_start, kv_len=kv_len,
        softmax_scale=softmax_scale)
    G = H // KV
    check_pairs(B, KV, Sq * G)
    q_pos = q_start if torch.is_tensor(q_start) else None
    if q_pos is not None or kv_dev is not None:
        q_start, t0 = (0 if q_pos is not None else q_start), 0
        S, tpc = capacity_splits(B, KV, Sq, H, Dv, Skv=Skv, causal=causal,
                                 window=window, splits=splits)
    else:
        S, t0, tpc = decode_splits(B, KV, Sq, H, Dv, causal=causal,
                                   window=window, q_start=q_start,
                                   kv_len=kv_len, splits=splits)
    if S > DECODE_MAX_SPLITS:
        raise ValueError(f"{S} splits exceed the decode kernel's "
                         f"{DECODE_MAX_SPLITS}")
    return _OPS["flash_decode"](q, k, v, causal, window, q_start, q_pos,
                                 kv_len, kv_dev, scale, S, t0, tpc)


def flash_decode_cuda(q, k, v, *, causal: bool, window: int | None,
                      q_start, kv_len=None,
                      softmax_scale: float | None = None,
                      splits: int | None = None):
    """The split-K decode kernel (any ``Sq * G``, in row blocks of 16
    beyond 16; ``splits`` fixes the number of splits, default its rule)
    with its partials: returns ``(out,
    m, l, acc)``, ``m``/``l`` ``(B, KV, S, Sq, G)`` and ``acc`` ``(B, KV, S, Sq,
    G, Dv)`` in f32, each split's as :func:`~repro_torch.kernels.
    flash_attention.ops.flash_decode_partials_torch` computes them.
    ``q_start`` is a host int (with ``kv_len``), or an int64 tensor on the
    card, 0-d or ``(B,)`` (a position per batch row; each row's ``kv_len``
    then its ``q_start + Sq``, and the splits :func:`capacity_splits`);
    ``kv_len`` may be an int32 tensor on the card, 0-d or ``(B,)`` (each
    row's length; the splits :func:`capacity_splits`)."""
    out, part = _decode(q, k, v, causal=causal, window=window,
                        q_start=q_start, kv_len=kv_len,
                        softmax_scale=softmax_scale, splits=splits)
    B, Sq, H, _ = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    part = part.view(B, KV, part.shape[1], Sq, H // KV, Dv + 2)
    return out, part[..., Dv], part[..., Dv + 1], part[..., :Dv]


def _forward(op, q, k, v, *, causal, window, q_start, kv_len,
             softmax_scale):
    """Check a host-position forward call and launch it through ``op``
    (``repro_torch::flash_prefill`` or ``repro_torch::flash_attention``,
    whose implementation is :func:`_launch`)."""
    B, Sq, Skv, H, KV, D, Dv, kv_len, scale = _args(
        q, k, v, window=window, q_start=q_start, kv_len=kv_len,
        softmax_scale=softmax_scale)
    return op(q, k, v, causal, window, q_start, kv_len, scale)


def _launch(name, lib, entry, q, k, v, causal, window, q_start, kv_len,
            scale):
    """Allocate the output and launch ``entry`` of library ``lib``
    (``{sfx}`` in ``entry`` becomes the dtype's suffix), count."""
    _check_aligned(q=q, k=k, v=v)
    B, Sq, H, _ = q.shape
    Skv, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    fn = getattr(_library(lib), entry.format(sfx=_SUFFIX[q.dtype]))
    _build.raise_on(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), B, Sq, Skv, H, KV, q.shape[3], Dv,
                       q_start, kv_len, -1 if window is None else window,
                       int(bool(causal)), scale, _stream(q)), name)
    LAUNCHES[name] += 1
    return out


def flash_prefill_cuda(q, k, v, *, causal: bool, window: int | None,
                       q_start: int, kv_len: int,
                       softmax_scale: float | None = None):
    """The ``wgmma`` prefill kernel: bf16 at (D, Dv) in
    :data:`PREFILL_HEAD_DIMS`, any number of rows; raises otherwise."""
    D, Dv = q.shape[-1], v.shape[-1]
    if q.dtype != torch.bfloat16 or (D, Dv) not in PREFILL_HEAD_DIMS:
        raise ValueError(f"the prefill kernel takes bf16 at (D, Dv) in "
                         f"{PREFILL_HEAD_DIMS}, got {q.dtype} at {(D, Dv)}")
    return _forward(_OPS["flash_prefill"], q, k, v,
                    causal=causal, window=window, q_start=q_start,
                    kv_len=kv_len, softmax_scale=softmax_scale)


def flash_simple_cuda(q, k, v, *, causal: bool, window: int | None,
                      q_start: int, kv_len: int,
                      softmax_scale: float | None = None):
    """The simple kernel (``csrc/flash_attention.cu``): every dtype and
    head-dim pair the wrapper takes."""
    return _forward(_OPS["flash_attention"], q, k, v,
                    causal=causal, window=window, q_start=q_start,
                    kv_len=kv_len, softmax_scale=softmax_scale)


def flash_attention_cuda(q, k, v, *, causal: bool, window: int | None,
                         q_start, kv_len,
                         softmax_scale: float | None = None):
    """Forward GQA attention on the card: q ``(B,Sq,H,D)``, k ``(B,Skv,KV,D)``,
    v ``(B,Skv,KV,Dv)`` -> ``(B,Sq,H,Dv)`` in q's dtype (f32 accumulation),
    through the kernel :func:`pick_route` names for the call.  A device
    ``q_start`` (an int64 tensor, 0-d or ``(B,)``; ``kv_len = q_start +
    Sq``) or a device ``kv_len`` (an int32 tensor, 0-d or ``(B,)``) goes
    to the decode route, whatever the rows."""
    _, Sq, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[3]
    if KV == 0 or H % KV:
        _check(q, k, v)                      # raises with the reason
    kw = dict(causal=causal, window=window, q_start=q_start, kv_len=kv_len,
              softmax_scale=softmax_scale)
    route = pick_route(Sq, H // KV, q.dtype, D, Dv,
                       device_pos=torch.is_tensor(q_start)
                       or torch.is_tensor(kv_len))
    if route == "decode":
        return _decode(q, k, v, splits=None, **kw)[0]
    if route == "prefill":
        return flash_prefill_cuda(q, k, v, **kw)
    return flash_simple_cuda(q, k, v, **kw)


def check_backward(q, k, v, *, causal=True, window=None, q_start=0,
                   kv_len=None) -> None:
    """Raise unless a call is a training form the backward takes:
    ``q_start`` the host int 0 and ``kv_len`` None or ``Skv``, and either
    causal with ``Sq == Skv``, no window or an int window >= 1 (keys at or
    before ``q - window`` masked, as in the forward), or non-causal with
    any ``Sq`` and ``Skv`` and no window; on the card also a dtype and (D,
    Dv) that :func:`pick_backward_route` gives a kernel for the form."""
    Sq, Skv = q.shape[1], k.shape[1]
    if torch.is_tensor(q_start) or torch.is_tensor(kv_len):
        raise NotImplementedError(
            "the flash backward takes host positions only (a device "
            "position is a decode step's, which has no gradient)")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"window {window!r} must be an int >= 1 or None")
    if q_start != 0 or (kv_len is not None and kv_len != Skv) \
            or (causal and Sq != Skv) or (not causal and window is not None):
        raise NoBackward(
            f"the flash backward takes q_start 0 and kv_len = Skv, causal "
            f"with Sq = Skv (a window or none) or non-causal without a "
            f"window, got causal={causal}, window={window}, "
            f"q_start={q_start}, kv_len={kv_len}, Sq={Sq}, Skv={Skv}")
    if q.is_cuda:
        pick_backward_route(q.dtype, q.shape[3], v.shape[3], causal=causal)


def pick_backward_route(dtype: torch.dtype, D: int, Dv: int, *,
                        causal: bool = True) -> str:
    """Which kernel takes a backward call: ``"sm90"`` (the tensor-core
    kernel) for bf16, ``"simple"`` (the CUDA-core kernel) for f32, both
    causal at (D, Dv) in :data:`BACKWARD_HEAD_DIMS`, with or without a
    window, and non-causal at :data:`NONCAUSAL_HEAD_DIMS`; raises for any
    other form.  (A tensor-core f32 path, TF32, would miss f32's 1e-4
    check.)"""
    dims = BACKWARD_HEAD_DIMS if causal else NONCAUSAL_HEAD_DIMS
    if (D, Dv) not in dims or dtype not in _SUFFIX:
        raise NoBackward(
            f"the flash backward kernels take bf16 or f32 at (D, Dv) in "
            f"{dims} {'causal' if causal else 'non-causal'}, got {dtype} "
            f"at {(D, Dv)}")
    return "sm90" if dtype == torch.bfloat16 else "simple"


def backward_tiles(S: int) -> int:
    """Tiles of :data:`BACKWARD_TILE` rows over a sequence of ``S``."""
    return -(-S // BACKWARD_TILE)


def backward_cols(D: int) -> int:
    """Column blocks of a tile of ``D`` columns: the blocks of each (batch
    row, head, tile), each holding :data:`BACKWARD_COLS` columns of its
    dQ, or of its dK and (where Dv has them) dV."""
    return -(-D // BACKWARD_COLS)


def backward_key_tiles(qt: int, S: int, window: int | None, *,
                       causal: bool = True) -> tuple[int, int]:
    """``(first, n)``: the key tiles a dQ block of query tile ``qt``
    visits over ``S`` keys: causal, from the one holding its first row's
    first live key (``q0 - window + 1``) to its diagonal; non-causal,
    every key tile."""
    if not causal:
        return 0, backward_tiles(S)
    q0 = qt * BACKWARD_TILE
    w = S if window is None else min(window, S)
    t0 = max(0, q0 - w + 1) // BACKWARD_TILE
    return t0, qt - t0 + 1


def backward_query_tiles(kt: int, S: int, window: int | None, *,
                         causal: bool = True) -> tuple[int, int]:
    """``(first, n)``: the query tiles a dK/dV block of key tile ``kt``
    visits over ``S`` queries: causal, from its diagonal to the one
    holding the last query whose window reaches its last key (``k0 + 63 +
    window - 1``); non-causal, every query tile."""
    if not causal:
        return 0, backward_tiles(S)
    w = S if window is None else min(window, S)
    last = min(backward_tiles(S) - 1,
               (kt * BACKWARD_TILE + BACKWARD_TILE - 1 + w - 1)
               // BACKWARD_TILE)
    return kt, last - kt + 1


def backward_grid(B: int, S: int, H: int, KV: int, D: int = 64, *,
                  Skv: int | None = None) -> tuple[int, int]:
    """Blocks of the tensor-core backward's two launches: ``(dQ, dK/dV)``,
    one per (batch row, head, query tile of ``S``, column block of D) and
    per (batch row, KV head, key tile of ``Skv`` (default ``S``), column
    block of D: at D > Dv the last ones hold dK's columns alone)."""
    c = backward_cols(D)
    nk = backward_tiles(S if Skv is None else Skv)
    return backward_tiles(S) * B * H * c, nk * B * KV * c


def dq_block(i: int, B: int, S: int, H: int, D: int = 64
             ) -> tuple[int, int, int, int]:
    """``(b, h, query tile, column block)`` of block ``i`` of the dQ
    launch over ``S`` queries, as the kernel computes it: the last query
    tile (causal: the most key tiles) over every (batch row, head, column
    block) first, the column block fastest."""
    c = backward_cols(D)
    r, pair = divmod(i, B * H * c)
    bh, col = divmod(pair, c)
    return bh // H, bh % H, backward_tiles(S) - 1 - r, col


def dkdv_block(i: int, B: int, S: int, KV: int, D: int = 64
               ) -> tuple[int, int, int, int]:
    """``(b, KV head, key tile, column block)`` of block ``i`` of the dK/dV
    launch: key tile 0 (causal: the most query tiles) over every (batch
    row, KV head, column block) first."""
    c = backward_cols(D)
    r, pair = divmod(i, B * KV * c)
    bk, col = divmod(pair, c)
    return bk // KV, bk % KV, r, col


def prefill_smem_bytes(D: int, Dv: int) -> int:
    """Dynamic shared memory of the tensor-core prefill at (D, Dv): the
    resident Q tile (64 x D), :data:`PREFILL_STAGES` K (64 x D) and V (64 x
    Dv) tiles in bf16, and 1024 bytes to align the swizzled tiles."""
    return 2 * PREFILL_TILE * (D + PREFILL_STAGES[(D, Dv)] * (D + Dv)) + 1024


def backward_smem_bytes(D: int = 64, Dv: int | None = None
                        ) -> tuple[int, int]:
    """Dynamic shared memory of the dQ and the dK/dV kernel at head dims
    (D, Dv) (``Dv`` default ``D``): the dQ kernel's resident Q (D columns)
    and dO (Dv) tiles and a K and a V tile a stage of its ring; the dK/dV
    kernel's resident K and V tiles and a Q and a dO tile a stage, with
    the query tile's f32 log-sum-exp and D; all bf16, 64 rows, and 1024
    bytes to align the swizzled tiles."""
    Dv = D if Dv is None else Dv
    pair = BACKWARD_TILE * (D + Dv) * 2
    dq_stages, dkdv_stages = BACKWARD_STAGES[(D, Dv)]
    dq = (1 + dq_stages) * pair + 1024
    dkdv = (1 + dkdv_stages) * pair \
        + dkdv_stages * 2 * BACKWARD_TILE * 4 + 1024
    return dq, dkdv


#: what ``repro_flash_backward_sm90_constants`` reports: threads a block,
#: the tile, and at each pair of BACKWARD_HEAD_DIMS the stages and shared
#: memory of each kernel
SM90_CONSTANTS = (128, BACKWARD_TILE,
                  *(x for dims in BACKWARD_HEAD_DIMS
                    for x in (*BACKWARD_STAGES[dims],
                              *backward_smem_bytes(*dims))))


def _backward_args(q, k, v, o, do, softmax_scale, window, causal):
    """Check a backward call's five tensors (a training form, CUDA,
    contiguous, one dtype; 16-byte alignment is checked at the launch);
    returns the softmax scale."""
    _check(q, k, v)
    check_backward(q, k, v, causal=causal, window=window)
    B, Sq, H, D = q.shape
    want = (B, Sq, H, v.shape[3])
    for name, t in (("o", o), ("do", do)):
        if not (isinstance(t, torch.Tensor) and t.is_cuda) \
                or tuple(t.shape) != want \
                or t.dtype != q.dtype or t.device != q.device \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous CUDA tensor of "
                             f"shape {want} in {q.dtype} on {q.device}, "
                             f"16-byte aligned")
    if B * H * backward_cols(D) > MAX_PAIRS:
        raise ValueError(f"batch x heads x column blocks = "
                         f"{B * H * backward_cols(D)} exceeds the grid's "
                         f"{MAX_PAIRS}")
    return float(softmax_scale if softmax_scale is not None else D ** -0.5)


def _backward_launch(lib, entry, route, lead, q, k, v, o, do, scale, window,
                     causal, spad):
    """Allocate dq, dk, dv and the f32 scratch (each row's log-sum-exp and
    rowsum(dO * o), ``(B, H, spad)``), launch ``entry`` of library ``lib``
    (``lead``: its arguments before the tensors), count."""
    _check_aligned(q=q, k=k, v=v, o=o, do=do)
    B, Sq, H, D = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lse = torch.empty((B, H, spad), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    fn = getattr(_library(lib), entry)
    _build.raise_on(fn(*lead, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       o.data_ptr(), do.data_ptr(), dq.data_ptr(),
                       dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
                       delta.data_ptr(), B, Sq, k.shape[1], H, k.shape[2],
                       D, v.shape[3], -1 if window is None else window,
                       int(bool(causal)), scale, _stream(q)), lib)
    LAUNCHES["flash_backward"] += 1
    BACKWARD_ROUTES[route] += 1
    return dq, dk, dv


def _backward_simple(q, k, v, o, do, scale, window, causal=True):
    """The CUDA-core backward's launch (``repro_torch::
    flash_backward_simple``); its scratch is ``(B, H, Sq)``."""
    return _backward_launch("flash_backward", "repro_flash_backward",
                            "simple", (int(q.dtype == torch.bfloat16),),
                            q, k, v, o, do, scale, window, causal,
                            q.shape[1])


def _backward_sm90(q, k, v, o, do, scale, window, causal=True):
    """The tensor-core backward's launch (``repro_torch::
    flash_backward_sm90``); its scratch is ``(B, H, Sq rounded up to a
    tile)``."""
    return _backward_launch("flash_backward_sm90",
                            "repro_flash_backward_sm90", "sm90", (), q, k,
                            v, o, do, scale, window, causal,
                            backward_tiles(q.shape[1]) * BACKWARD_TILE)


def flash_backward_simple_cuda(q, k, v, o, do, *,
                               softmax_scale: float | None = None,
                               window: int | None = None,
                               causal: bool = True):
    """The CUDA-core backward (``csrc/flash_backward.cu``: a setup pass for
    each row's log-sum-exp and rowsum(do * o), then the dK/dV and dQ
    kernels), bf16 or f32: the route of f32 calls."""
    scale = _backward_args(q, k, v, o, do, softmax_scale, window, causal)
    return _OPS["flash_backward_simple"](q, k, v, o, do, scale, window,
                                         causal)


def flash_backward_sm90_cuda(q, k, v, o, do, *,
                             softmax_scale: float | None = None,
                             window: int | None = None,
                             causal: bool = True):
    """The tensor-core backward (``csrc/flash_backward_sm90.cu``: the dQ
    kernel, which also writes each row's log-sum-exp and rowsum(do * o) to
    f32 scratch, then the dK/dV kernel), bf16 only: the route of bf16
    calls."""
    scale = _backward_args(q, k, v, o, do, softmax_scale, window, causal)
    if q.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core backward takes bf16, got "
                         f"{q.dtype}")
    return _OPS["flash_backward_sm90"](q, k, v, o, do, scale, window, causal)


def flash_backward_cuda(q, k, v, o, do, *,
                        softmax_scale: float | None = None,
                        window: int | None = None, causal: bool = True):
    """The gradient of attention ``o = attn(q, k, v)`` in a training form
    (q_start 0; causal with Sq = Skv, keys at or before ``q - window``
    masked when ``window`` is given, or non-causal over every key) given
    ``do``, the output's gradient: returns ``(dq, dk, dv)`` in the inputs'
    dtype, by the kernel :func:`pick_backward_route` names (bf16:
    :func:`flash_backward_sm90_cuda`; f32:
    :func:`flash_backward_simple_cuda`).  All five inputs contiguous CUDA
    tensors of one dtype; q ``(B, Sq, H, D)``, k ``(B, Skv, KV, D)``, v
    ``(B, Skv, KV, Dv)``, o and do ``(B, Sq, H, Dv)``."""
    route = pick_backward_route(q.dtype, q.shape[3], v.shape[3],
                                causal=causal)
    fn = flash_backward_sm90_cuda if route == "sm90" \
        else flash_backward_simple_cuda
    return fn(q, k, v, o, do, softmax_scale=softmax_scale, window=window,
              causal=causal)


# ------------------------------------------------------- torch.library ops
#
# Each launch entry is an op of the ``repro_torch`` namespace
# (``costs.kernel_op``), so that a fake tensor (``FakeTensorMode``, the
# dry-run's) reaches a shape function and never ctypes.  The wrappers
# above check a call, split it on the host and call the op with the
# launch's own parameters; the op's real implementation allocates the
# outputs, launches and counts.  Every op is registered with its cost.

def _flash_decode_launch(q, k, v, causal, window, q_start, q_pos, kv_len,
                         kv_pos, scale, S, t0, tpc):
    _check_aligned(q=q, k=k, v=v)
    B, Sq, H, D = q.shape
    Skv, KV, Dv = v.shape[1], v.shape[2], v.shape[3]
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device)
    part = torch.empty((B * KV, S, Sq * (H // KV), Dv + 2),
                       dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, part
    counter = _counter(q.device)
    fn = _library("flash_decode").repro_flash_decode
    _build.raise_on(fn(int(q.dtype == torch.bfloat16), q.data_ptr(),
                       k.data_ptr(), v.data_ptr(), out.data_ptr(),
                       part.data_ptr(), counter.data_ptr(), B, Sq, Skv, H,
                       KV, D, Dv, q_start, kv_len,
                       -1 if window is None else window, int(bool(causal)),
                       scale, S, t0, tpc,
                       None if q_pos is None else q_pos.data_ptr(),
                       0 if q_pos is None else q_pos.dim(),
                       None if kv_pos is None else kv_pos.data_ptr(),
                       0 if kv_pos is None else kv_pos.dim(), _stream(q)),
                    "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out, part


def _flash_decode_fake(q, k, v, causal, window, q_start, q_pos, kv_len,
                       kv_pos, scale, S, t0, tpc):
    B, Sq, H, _ = q.shape
    KV, Dv = v.shape[2], v.shape[3]
    return (q.new_empty((B, Sq, H, Dv)),
            q.new_empty((B * KV, S, Sq * (H // KV), Dv + 2),
                        dtype=torch.float32))


def _forward_fake(q, k, v, causal, window, q_start, kv_len, scale):
    return q.new_empty((*q.shape[:3], v.shape[3]))


def _backward_fake(q, k, v, o, do, scale, window, causal=True):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flop_class(q) -> str:
    return "tensor" if q.dtype in (torch.bfloat16, torch.float16) \
        else "cuda_core"


def _decode_cost(q, k, v, causal, window, q_start, q_pos, kv_len, kv_pos,
                 *_):
    """A decode launch's cost.  At a device position or length the count
    cannot read it: it takes the position that reads the whole cache
    (``kv_len = Skv``), the most the launch can need."""
    Skv = k.shape[1]
    if q_pos is not None:
        q_start, kv_len = max(Skv - q.shape[1], 0), Skv
    elif kv_pos is not None:
        kv_len = Skv
    return (*costs.flash_cost(*q.shape, Skv, k.shape[2], v.shape[3],
                              q.element_size(), q_start=q_start,
                              kv_len=kv_len, causal=causal, window=window),
            _flop_class(q))


def _forward_cost(q, k, v, causal, window, q_start, kv_len, scale):
    return (*costs.flash_cost(*q.shape, *k.shape[1:3], v.shape[3],
                              q.element_size(), q_start=q_start,
                              kv_len=kv_len, causal=causal, window=window),
            _flop_class(q))


def _backward_cost(q, k, v, o, do, scale, window, causal=True):
    B, Sq, H, D = q.shape
    return (*costs.flash_backward_cost(B, Sq, H, k.shape[2], D,
                                       q.element_size(), Skv=k.shape[1],
                                       Dv=v.shape[3], causal=causal,
                                       window=window),
            _flop_class(q))


_FWD = ("(Tensor q, Tensor k, Tensor v, bool causal, int? window, "
        "int q_start, int kv_len, float scale) -> Tensor")
_BWD = ("(Tensor q, Tensor k, Tensor v, Tensor o, Tensor do, float scale, "
        "int? window, bool causal=True) -> (Tensor, Tensor, Tensor)")
_OPS = {
    "flash_decode": costs.kernel_op(
        "flash_decode(Tensor q, Tensor k, Tensor v, bool causal, "
        "int? window, int q_start, Tensor? q_pos, int kv_len, "
        "Tensor? kv_pos, float scale, int S, int t0, int tpc) "
        "-> (Tensor, Tensor)", _flash_decode_launch, _flash_decode_fake,
        "flash_decode", _decode_cost),
    "flash_prefill": costs.kernel_op(
        "flash_prefill" + _FWD,
        lambda *a: _launch("flash_prefill", "flash_prefill_sm90",
                           "repro_flash_prefill_sm90", *a),
        _forward_fake, "flash_prefill", _forward_cost),
    "flash_attention": costs.kernel_op(
        "flash_attention" + _FWD,
        lambda *a: _launch("flash_attention", "flash_attention",
                           "repro_flash_attention_{sfx}", *a),
        _forward_fake, "flash_attention", _forward_cost),
    "flash_backward_sm90": costs.kernel_op(
        "flash_backward_sm90" + _BWD, _backward_sm90, _backward_fake,
        "flash_backward", _backward_cost),
    "flash_backward_simple": costs.kernel_op(
        "flash_backward_simple" + _BWD, _backward_simple, _backward_fake,
        "flash_backward", _backward_cost),
}
