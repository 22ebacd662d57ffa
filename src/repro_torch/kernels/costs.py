"""What the port's kernels cost: operations and bytes of one launch, and the
card's rates.

Counts, not times: each function returns ``(flops, bytes)`` of one call
from its shapes, by the rule a roofline needs -- every input read once,
every output written once, the operations the algorithm does on these
inputs.  ``chip_smoke.py`` turns them into its bounds over the rates
below, and the dry-run (``launch/dryrun.py``) counts each kernel's
``torch.library`` op by them (each op's FLOP formula is registered from
here).

The rates are NVIDIA's data sheet for the H100 SXM at its 700 W limit.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak, same sheet
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores, same sheet


def _sum_clamped(a: int, b: int, lo: int, hi: int) -> int:
    """``sum(min(max(x, lo), hi) for x in range(a, b))`` in closed form
    (``lo <= hi``)."""
    if b <= a:
        return 0
    below = max(0, min(b, lo) - a)               # x < lo: each gives lo
    above = max(0, b - max(a, hi + 1))           # x > hi: each gives hi
    m0, m1 = max(a, lo), min(b, hi + 1)          # lo <= x <= hi: x itself
    mid = (m0 + m1 - 1) * (m1 - m0) // 2 if m1 > m0 else 0
    return below * lo + above * hi + mid


def attention_pairs(Sq: int, *, q_start: int, kv_len: int, causal: bool,
                    window: int | None = None) -> tuple[int, int]:
    """``(live, keys)``: the (query, key) pairs some query of a call
    attends to, and the keys some query of it reads.  Query ``p`` of
    ``q_start .. q_start + Sq - 1`` reads the keys ``[lo(p), min(kv_len, p
    + 1))`` under a causal mask (``lo(p) = p - window + 1`` with a window,
    else 0), every key below ``kv_len`` without one; ``keys`` runs from
    the first query's first key to the last query's last."""
    n, qs = kv_len, q_start
    if not causal:
        return Sq * n, n
    if window is None:
        first = 0
        live = _sum_clamped(qs + 1, qs + Sq + 1, 0, n)
    else:
        first = max(0, qs - window + 1)
        # sum of min(n, p + 1) - min(max(0, p - w + 1), n): a query whose
        # window starts past kv_len reads nothing
        live = (_sum_clamped(qs + 1, qs + Sq + 1, 0, n)
                - _sum_clamped(qs - window + 1, qs + Sq - window + 1, 0, n))
    return live, min(n, qs + Sq) - first


def flash_cost(B: int, Sq: int, H: int, D: int, Skv: int, KV: int, Dv: int,
               esz: int, *, q_start: int, kv_len: int, causal: bool = True,
               window: int | None = None) -> tuple[int, int]:
    """One attention call, q ``(B, Sq, H, D)`` over k ``(B, Skv, KV, D)``
    and v ``(B, Skv, KV, Dv)`` in elements of ``esz`` bytes: q read once,
    k and v read once for the keys some query attends to (the window's and
    kv_len's cuts applied), the output written once; ``2 H (D + Dv)``
    flops per live (query, key) pair and batch row (the scores and the
    weighted sum).  ``Skv`` is the cache's length, which the count does
    not read."""
    live, keys = attention_pairs(Sq, q_start=q_start, kv_len=kv_len,
                                 causal=causal, window=window)
    nbytes = esz * (B * Sq * H * D + B * Sq * H * Dv
                    + B * keys * KV * (D + Dv))
    return 2 * B * H * (D + Dv) * live, nbytes


def flash_backward_cost(B: int, S: int, H: int, KV: int, D: int,
                        esz: int, *, Skv: int | None = None,
                        Dv: int | None = None, causal: bool = True,
                        window: int | None = None) -> tuple[int, int]:
    """One backward in a training form: q and dq ``(B, S, H, D)``, o and
    dO ``(B, S, H, Dv)``, k and dk ``(B, Skv, KV, D)``, v and dv ``(B,
    Skv, KV, Dv)`` (``Skv`` default ``S``, ``Dv`` default ``D``), causal
    (``Skv = S``, with or without a window) or not: q, k, v, o and dO read
    once, dq, dk and dv written once (a window still reads every key);
    five products per live (query, key) pair and head
    (:func:`attention_pairs`, as :func:`flash_cost` counts the forward's
    pairs): the scores recomputed, dK and dQ over ``D`` (``2 D`` flops
    each), dP and dV over ``Dv`` (``2 Dv`` each)."""
    Skv = S if Skv is None else Skv
    Dv = D if Dv is None else Dv
    nbytes = esz * 2 * (D + Dv) * (B * S * H + B * Skv * KV)
    live, _ = attention_pairs(S, q_start=0, kv_len=Skv, causal=causal,
                              window=window)
    return 2 * (3 * D + 2 * Dv) * B * H * live, nbytes


def wkv6_cost(B: int, T: int, H: int, N: int, esz: int, *,
              initial_state: bool = True) -> tuple[int, int]:
    """One WKV-6 call: r, k, v, w read and o written once, u read once,
    the f32 state written once and, with an initial state, read once; per
    head and step ``5 N^2`` f32 flops (o: a product and a sum per state
    element; the state: two products and a sum) and ``5 N`` (the bonus and
    its product with v)."""
    nbytes = (esz * (5 * B * T * H * N + H * N)
              + (1 + int(initial_state)) * 4 * B * H * N * N)
    return B * H * T * (5 * N * N + 5 * N), nbytes


def rglru_cost(B: int, T: int, D: int, esz: int, *,
               h0: bool = True) -> tuple[int, int]:
    """One RG-LRU call: log_a (f32) and gx read once, h written once in
    gx's dtype, hT written once and, with ``h0``, h0 read once (f32); 10
    f32 operations per element (two exps, a sqrt, the clip's two, 2 la, 1
    - e, and the step's two products and sum)."""
    nbytes = (4 + 2 * esz) * B * T * D + (1 + int(h0)) * 4 * B * D
    return 10 * B * T * D, nbytes


def rglru_backward_cost(B: int, T: int, D: int, esz: int, *,
                        h0: bool = False, dhT: bool = False
                        ) -> tuple[int, int]:
    """One RG-LRU backward: log_a (f32), gx and dh (gx's dtype) read
    once, dlog_a (f32) and dgx (gx's dtype) written once, dh0 (f32)
    written once, h0 and dhT read once where given; 31 f32 operations per
    element, as the kernel does them: the carry recomputed (the forward's
    10), the gates again (7: two exps, 2 la, 1 - e2, the clip's two, the
    square root) and the reverse step's 14 (g's sum, dgx's product, g
    h_{t-1} and its product by a, g x, 2 c, the division, the clip's two
    tests, the product by e2, the doubling, dlog_a's sum, the carry's
    product)."""
    nbytes = ((8 + 3 * esz) * B * T * D
              + (1 + int(h0) + int(dhT)) * 4 * B * D)
    return 31 * B * T * D, nbytes


def wkv6_backward_cost(B: int, T: int, H: int, N: int, esz: int, *,
                       s0: bool = False, dsT: bool = False
                       ) -> tuple[int, int]:
    """One WKV-6 backward, the work the gradient needs: r, k, v, w and do
    read once and dr, dk, dv, dw written once (``esz`` bytes an element), u
    read and du written once, s0 read and ds0 (f32) written where s0 is
    given, dsT read where given; per head and step the state walked forward
    once, ``3 N^2`` (S_{t-1} for dr and dw), and the reverse's ``11 N^2``
    (dr, dk, dw: an FMA each per element; dv: a product and a sum; G: two
    products and a sum) and ``16 N`` (the bonus and v . do, 5; dr's and
    dk's bonus terms, 6; du's term, 3; dv's b do, 2).  The kernel does
    more: it walks each chunk's states a second time from its checkpoint
    (another ``3 N^2`` a step, but a chunk's last), writes and reads the
    f32 checkpoints and writes ds0 without s0; none of that is counted."""
    flops = B * H * T * (14 * N * N + 16 * N)
    nbytes = (esz * (9 * B * T * H * N + 2 * H * N)
              + (2 * int(s0) + int(dsT)) * 4 * B * H * N * N)
    return flops, nbytes


def sumsq_cost(numels, esizes) -> tuple[int, int]:
    """One squared-sum launch over gradient leaves of ``numels`` elements
    of ``esizes`` bytes: each element read once and one f32 written a
    leaf; 2 f32 operations an element (the square and the sum)."""
    return 2 * sum(numels), sum(n * e for n, e in zip(numels, esizes)) \
        + 4 * len(numels)


#: f32 operations of one parameter's AdamW update with the clip's scaling,
#: as ``csrc/adamw.cu`` does them: the scaling 1; m 3 (two products and a
#: sum); v 4 (three products and a sum); the denominator 3 (a division,
#: the square root, + eps); the update 2 (two divisions); the weight
#: decay 2 (a product and a sum); the new parameter 2 (a product and a
#: difference)
ADAMW_FLOPS_PER_PARAM = 17


def adamw_update_cost(numels, g_esizes, p_esizes) -> tuple[int, int]:
    """One clip-and-AdamW launch over leaves of ``numels`` elements: the
    gradient read once (``g_esizes`` bytes an element), the parameter read
    and written once (``p_esizes``), both f32 moments read and written
    once: 22 B a bf16 parameter (g 2, p 2 + 2, m 4 + 4, v 4 + 4); the four
    f32 scalars read once; :data:`ADAMW_FLOPS_PER_PARAM` operations a
    parameter."""
    nbytes = sum(n * (g + 2 * p + 16)
                 for n, g, p in zip(numels, g_esizes, p_esizes))
    return ADAMW_FLOPS_PER_PARAM * sum(numels), nbytes + 16


def _moments(shape) -> int:
    """Adafactor's f32 state elements of a leaf: a factored leaf's vr and
    vc (a row and a column a matrix of its last two dims), a 1-D one's v."""
    n = _numel(shape)
    if len(shape) < 2:
        return n
    return n // shape[-1] + n // shape[-2]


def _numel(shape) -> int:
    return math.prod(shape)


def adafactor_cost(shapes, g_esizes, p_esizes) -> tuple[int, int]:
    """The whole clip-and-Adafactor update (its three launches together),
    the bound's count: the gradient read once, the parameter read and
    written once, the f32 moments read and written once, the three f32
    scalars (scale, beta2, lr) read once: 6 B a bf16 parameter and 8 B a
    moment; the operations of the three kernels' passes
    (:func:`adafactor_sums_cost`, :func:`adafactor_rms_cost`,
    :func:`adafactor_update_cost`)."""
    flops = (adafactor_sums_cost(shapes, g_esizes)[0]
             + adafactor_rms_cost(shapes, g_esizes)[0]
             + adafactor_update_cost(shapes, g_esizes, p_esizes)[0])
    nbytes = sum(_numel(s) * (g + 2 * p) + 8 * _moments(s)
                 for s, g, p in zip(shapes, g_esizes, p_esizes))
    return flops, nbytes + 12


def adafactor_sums_cost(shapes, g_esizes, *, fused: bool = True
                        ) -> tuple[int, int]:
    """One ``adafactor_sums`` launch: the gradient read once, the f32
    moments read and written once (``fused``; else a 1-D leaf's v, and
    each row's and column's sum of g2 written), each matrix's sum of vr
    written; per element of a factored leaf 5 operations (the scaling, the
    square, + eps, the row's and the column's sums), per moment 4 (the
    mean's division, two products, a sum) and a vr its matrix's sum; per
    element of a 1-D leaf 6 (the scaling, the square, + eps, the
    moment's three)."""
    flops = nbytes = 0
    for s, g in zip(shapes, g_esizes):
        n, mo = _numel(s), _moments(s)
        nbytes += n * g
        if len(s) < 2:
            flops += 6 * n
            nbytes += 8 * n
            continue
        flops += 5 * n + (5 * mo if fused else 0)
        rows = n // s[-1]
        nbytes += 8 * mo if fused else 4 * mo
        nbytes += 4 * (rows // s[-2]) if fused else 0
    return flops, nbytes + 4


def adafactor_finish_cost(shapes) -> tuple[int, int]:
    """One ``adafactor_finish`` launch (``adafactor_sums_kernel`` from
    each row's and column's reduced sum): the sums read once, vr and vc
    read and written once, each matrix's sum of vr written; 5 operations a
    moment (the mean, two products, a sum; a vr its matrix's sum)."""
    mo = sum(_moments(s) for s in shapes if len(s) >= 2)
    mats = sum(_numel(s) // (s[-1] * s[-2]) for s in shapes if len(s) >= 2)
    return 5 * mo, 12 * mo + 4 * mats + 4


def adafactor_rms_cost(shapes, g_esizes) -> tuple[int, int]:
    """One ``adafactor_rms`` launch: the gradient read once, the moments
    read once, one f32 written a leaf; 5 operations an element (the
    scaling, u's two products -- a 1-D leaf's reciprocal square root and
    its product --, the square, the sum)."""
    nbytes = sum(_numel(s) * g + 4 * _moments(s)
                 for s, g in zip(shapes, g_esizes))
    return 5 * sum(_numel(s) for s in shapes), nbytes + 4 * len(shapes)


def adafactor_update_cost(shapes, g_esizes, p_esizes) -> tuple[int, int]:
    """One ``adafactor_update`` launch: the gradient read once, the
    parameter read and written once, the moments read once, the leaves'
    sums of u u and the scalars read once; 8 operations an element (the
    scaling, u's two, the clip's division, the weight decay's two, the
    rate's product, the difference)."""
    nbytes = sum(_numel(s) * (g + 2 * p) + 4 * _moments(s)
                 for s, g, p in zip(shapes, g_esizes, p_esizes))
    return 8 * sum(_numel(s) for s in shapes), nbytes + 4 * len(shapes) + 8


#: the kernels' ``torch.library`` ops (``OpOverloadPacket``s of the
#: ``repro_torch`` namespace) -> (the kernel's ``LAUNCHES`` key, its cost:
#: ``cost(*op args) -> (flops, bytes, flop class)``, the class
#: ``"tensor"`` for bf16/f16 products and ``"cuda_core"`` for f32 work)
KERNEL_OPS: dict = {}
_LIB = None


def kernel_op(schema: str, impl, fake, launches: str, cost):
    """Define ``repro_torch::<schema>``, a kernel's launch as a
    ``torch.library`` op: ``impl`` its implementation for real tensors
    (every device: the launch checks its own), ``fake`` its outputs'
    shapes for fake ones, registered with its cost (:data:`KERNEL_OPS`)
    and its flops as its formula for ``torch.utils.flop_counter``.
    Returns the op's default overload.  (``torch.library.custom_op``
    would do the same at several times the host cost a call.)"""
    import torch
    from torch.utils.flop_counter import register_flop_formula

    global _LIB
    if _LIB is None:
        _LIB = torch.library.Library("repro_torch", "DEF")
    name = schema[:schema.index("(")]
    _LIB.define(schema)
    _LIB.impl(name, impl, "CompositeExplicitAutograd")
    torch.library.register_fake(f"repro_torch::{name}", fake, lib=_LIB)
    packet = getattr(torch.ops.repro_torch, name)
    KERNEL_OPS[packet] = (launches, cost)
    register_flop_formula(packet, get_raw=True)(
        lambda *args, out_val=None, **kwargs: cost(*args, **kwargs)[0])
    return packet.default
