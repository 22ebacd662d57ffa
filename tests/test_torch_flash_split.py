"""The split-K decode's plain versions against ``repro``'s attention.

``flash_decode_partials_torch`` (each split's m, l and acc, cut as the CUDA
kernel ``csrc/flash_decode.cu`` cuts the live keys) and
``flash_decode_combine_torch`` (their merge) are what ``chip_smoke.py``
holds the kernel's partials and output against on the card.  Here, on the
CPU, their merged output is held against ``repro``'s ``attention_ref``, its
chunked ``_flash_xla`` (``impl="xla"``) and the port's ``_flash_torch``
(``impl="torch"``), for several numbers of splits, GQA groups, windows and
cache tails, and with splits that are fully masked for some rows or for
every row: such a split must weigh exactly 0, never NaN.  Inputs are made
with numpy from a seed.  Tolerance: f32 atol 1e-5 (sums in another order).
Also the fixed route rule and the split rule of the CUDA wrapper, and,
past 16 rows (granite-20b's 48 query heads over one KV head), the row
blocks: a device position routed to the decode kernel, the split rule,
``check_pairs`` and the arrival counters' layout, the plain partials at
G 48 (fully masked splits and rows included, host and device
positions), and the kernel source's constants.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_ref,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention,
    flash_decode_combine_torch,
    flash_decode_partials_torch,
)
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

ATOL32 = 1e-5


def _qkv(seed, B, Sq, Skv, H, KV, D, Dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, Dv or D)).astype(np.float32)
    return q, k, v


def _split(q, k, v, splits, **kw):
    parts = flash_decode_partials_torch(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        splits=splits, **kw)
    out = flash_decode_combine_torch(*parts)
    return out.numpy(), parts


def _check_all(q, k, v, splits, *, flash=True, **kw):
    """The merged splits against ``attention_ref`` and, with ``flash``,
    against ``_flash_xla`` and ``_flash_torch``.  Those two mask with a
    finite -1e30, so a query row with no live key in the chunks they visit
    gets the mean of V over them (exp(-1e30 - (-1e30)) = 1) where
    ``attention_ref``, the CUDA kernels and the split-K merge give 0; rows
    like that are held against ``attention_ref`` alone."""
    got, parts = _split(q, k, v, splits, **kw)
    assert not np.isnan(got).any()
    for t in parts:
        assert not torch.isnan(t).any()
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw))
    xla = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), impl="xla", kv_chunk=32,
                               **kw), np.float32)
    plain = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), impl="torch", kv_chunk=32,
                            **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL32)
    if flash:
        np.testing.assert_allclose(got, xla, rtol=0, atol=ATOL32)
        np.testing.assert_allclose(got, plain, rtol=0, atol=ATOL32)
    return got, parts


CASES = {
    "decode": dict(Skv=200, q_start=199, kv_len=200),
    "window": dict(Skv=200, q_start=199, kv_len=200, window=45),
    "tail": dict(Skv=200, q_start=120, kv_len=121),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("G", [1, 4, 10])
@pytest.mark.parametrize("splits", [1, 2, 7, 64])
def test_split_decode_matches_reference(splits, G, case):
    c = dict(CASES[case])
    Skv = c.pop("Skv")
    KV = 1 if G == 10 else 2
    q, k, v = _qkv(splits * 100 + G, 2, 1, Skv, KV * G, KV, 32)
    _, (m, _, _) = _check_all(q, k, v, splits, **c)
    assert m.shape[2] == splits


@pytest.mark.parametrize("G", [1, 4, 10])
def test_split_rule_matches_reference(G):
    KV = 1 if G == 10 else 2
    q, k, v = _qkv(G, 1, 1, 700, KV * G, KV, 16)
    _check_all(q, k, v, None, q_start=650, kv_len=651, window=300)


def test_garbage_beyond_kv_len_does_not_leak():
    q, k, v = _qkv(5, 1, 1, 96, 4, 1, 16)
    a, _ = _split(q, k, v, 3, q_start=39, kv_len=40)
    k[:, 40:] = 1e4
    v[:, 40:] = -1e4
    b, _ = _split(q, k, v, 3, q_start=39, kv_len=40)
    np.testing.assert_array_equal(a, b)


def test_chunk_masked_for_some_rows_weighs_zero():
    # 16 queries at 100..115, window 20: keys 81..115 live over the block,
    # tiles 2 and 3; the query at 115 sees keys 96..115 only, so split 0
    # (tile 2) is fully masked for it
    q, k, v = _qkv(7, 1, 16, 116, 1, 1, 16)
    kw = dict(q_start=100, kv_len=116, window=20)
    _, (m, l, acc) = _check_all(q, k, v, 2, **kw)
    assert np.isneginf(m[0, 0, 0, 15, 0].item())
    assert l[0, 0, 0, 15, 0].item() == 0.0
    assert not acc[0, 0, 0, 15, 0].any()
    assert np.isfinite(m[0, 0, 1, 15, 0].item())
    # more splits than live tiles: the splits past the range are empty
    _, (m, l, acc) = _check_all(q, k, v, 64, **kw)
    assert torch.isneginf(m[:, :, 2:]).all()
    assert not l[:, :, 2:].any() and not acc[:, :, 2:].any()


def test_row_with_every_chunk_masked_gives_zero():
    # 4 queries at 8..11 over 9 keys, window 2: queries 10 and 11 see
    # keys 9..11 and 10..11, all at or beyond kv_len
    q, k, v = _qkv(11, 1, 4, 64, 8, 2, 16)
    kw = dict(q_start=8, kv_len=9, window=2)
    for splits in (1, 2, 7):
        got, (m, _, _) = _check_all(q, k, v, splits, flash=False, **kw)
        assert torch.isneginf(m[:, :, :, 2:]).all()
        assert not got[:, 2:].any()
        assert np.abs(got[:, :2]).max() > 0


@pytest.mark.parametrize("kw", [dict(q_start=0, kv_len=0, causal=False),
                                dict(q_start=30, kv_len=31, window=0)])
def test_every_row_masked_gives_zero(kw):
    q, k, v = _qkv(13, 1, 1, 40, 4, 1, 16)
    for splits in (None, 1, 7):
        got, (m, _, _) = _check_all(q, k, v, splits, flash=False, **kw)
        assert torch.isneginf(m).all()
        assert not got.any()


def test_combine_keeps_dtype_and_layout():
    q, k, v = _qkv(17, 1, 3, 50, 8, 2, 16, 32)
    parts = flash_decode_partials_torch(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)), splits=2,
        q_start=47, kv_len=50)
    out = flash_decode_combine_torch(*parts, dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (1, 3, 8, 32)


@pytest.mark.parametrize("Sq,G,dtype,dims,want", [
    (1, 4, torch.bfloat16, (64, 64), "decode"),
    (1, 10, torch.float32, (256, 256), "decode"),
    (4, 4, torch.bfloat16, (192, 128), "decode"),
    (1024, 4, torch.bfloat16, (64, 64), "prefill"),
    (2560, 10, torch.bfloat16, (256, 256), "prefill"),
    (17, 1, torch.bfloat16, (128, 128), "prefill"),
    (1024, 4, torch.float32, (64, 64), "simple"),
    (100, 1, torch.bfloat16, (192, 128), "prefill"),
    (100, 1, torch.float32, (192, 128), "simple"),
    (33, 1, torch.bfloat16, (16, 16), "simple"),
])
def test_route_rule(Sq, G, dtype, dims, want):
    assert fk.pick_route(Sq, G, dtype, *dims) == want


def test_split_rule():
    # llama3.2-1b's last decode step: 1056 keys over B * KV = 8
    assert fk.decode_splits(1, 8, 1, 32, 64, causal=True, window=None,
                            q_start=1055, kv_len=1056) == (17, 0, 2)
    # recurrentgemma-2b's: the 2048-key window over B * KV = 1, 10 rows of
    # Dv 256; the merge's 384 KB cap keeps it at 32 splits, not 64
    assert fk.decode_splits(1, 1, 1, 10, 256, causal=True, window=2048,
                            q_start=2591, kv_len=2592) == (32, 17, 2)
    assert fk.decode_splits(1, 1, 1, 10, 256, causal=True, window=None,
                            q_start=0, kv_len=0) == (1, 0, 1)
    assert fk.decode_splits(1, 8, 1, 8, 64, causal=True, window=None,
                            q_start=9, kv_len=10, splits=7) == (7, 0, 1)
    with pytest.raises(ValueError, match="splits"):
        fk.decode_splits(1, 1, 1, 1, 64, causal=True, window=None,
                         q_start=0, kv_len=1, splits=0)


def test_cuda_wrappers_raise_on_cpu():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 1, 8, 4, 1, 16))
    args = dict(causal=True, window=None, q_start=7, kv_len=8)
    for fn in (fk.flash_attention_cuda, fk.flash_decode_cuda,
               fk.flash_simple_cuda):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(q, k, v, **args)
    with pytest.raises(ValueError, match="prefill kernel takes bf16"):
        fk.flash_prefill_cuda(q, k, v, **args)
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(3, 1, 20, 20, 4, 1, 64))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fk.flash_prefill_cuda(q, k, v, causal=True, window=None, q_start=0,
                              kv_len=20)


# ------------------------------------------------ row blocks (G > 16)

# granite-20b's decode: 48 query heads over one KV head of D 128, a cache
# of 1024 + 32 positions
G20, D20, SMAX20 = 48, 128, 1056


@pytest.mark.parametrize("Sq,G,dtype,dims", [
    (1, 48, torch.bfloat16, (128, 128)),
    (1, 48, torch.float32, (128, 128)),
    (2, 9, torch.bfloat16, (128, 128)),
    (1, 17, torch.bfloat16, (16, 16)),
])
def test_route_takes_device_positions_to_decode(Sq, G, dtype, dims):
    # a device position goes to the decode kernel (in row blocks), the only
    # one that reads it there; at a host position the rule is unchanged
    assert Sq * G > fk.DECODE_MAX_ROWS
    assert fk.pick_route(Sq, G, dtype, *dims, device_pos=True) == "decode"
    want = "prefill" if dtype == torch.bfloat16 and \
        dims in fk.PREFILL_HEAD_DIMS else "simple"
    assert fk.pick_route(Sq, G, dtype, *dims) == want
    # at most 16 rows the route is the decode kernel either way
    assert fk.pick_route(1, 16, dtype, *dims) == "decode"
    assert fk.pick_route(1, 16, dtype, *dims, device_pos=True) == "decode"


def test_row_blocks_and_split_rule_at_granite_20b():
    assert [fk.row_blocks(1, G) for G in (1, 4, 10, 16, 17, 32, 48)] == \
        [1, 1, 1, 1, 2, 2, 3]
    assert fk.row_blocks(2, 9) == 2
    # the last decode step: 33 tiles over 3 row blocks; ceil(132 / 3) = 44
    # splits wanted, the merge reads 16 rows of Dv + 2 a split (47 fit in
    # 384 KB): one tile a split, 33 x 3 = 99 blocks
    assert fk.decode_splits(1, 1, 1, G20, D20, causal=True, window=None,
                            q_start=SMAX20 - 1, kv_len=SMAX20) == (33, 0, 1)
    assert fk.capacity_splits(1, 1, 1, G20, D20, Skv=SMAX20, causal=True,
                              window=None) == (33, 1)
    # the batched step's bucket 4: ceil(132 / 12) = 11 splits of 3 tiles
    assert fk.capacity_splits(4, 1, 1, G20, D20, Skv=SMAX20, causal=True,
                              window=None) == (11, 3)
    # a short prompt: the live tiles bound the splits
    assert fk.decode_splits(1, 1, 1, G20, D20, causal=True, window=None,
                            q_start=40, kv_len=41) == (2, 0, 1)
    # at most 16 rows the rule is the single row block's, unchanged
    for B, KV, H, Dv in ((1, 8, 32, 64), (1, 1, 10, 256), (4, 8, 32, 64)):
        n = fk.capacity_tiles(1, SMAX20, causal=True, window=None)
        want = -(-fk.DECODE_TARGET_BLOCKS // (B * KV))
        want = min(want, fk.DECODE_MERGE_BYTES // (4 * (H // KV) * (Dv + 2)))
        S = min(n, want)
        tpc = -(-n // S)
        assert fk.capacity_splits(B, KV, 1, H, Dv, Skv=SMAX20, causal=True,
                                  window=None) == (-(-n // tpc), tpc)


def test_check_pairs_counts_row_blocks():
    fk.check_pairs(1, 1, G20)
    fk.check_pairs(21845, 1, G20)                 # 3 x 21845 = 65535
    with pytest.raises(ValueError, match="row blocks"):
        fk.check_pairs(21846, 1, G20)
    fk.check_pairs(65535, 1, 16)
    with pytest.raises(ValueError, match="row blocks"):
        fk.check_pairs(65535, 1, 17)


ROW_CASES = {
    "decode": dict(Skv=200, q_start=199, kv_len=200),
    "window": dict(Skv=200, q_start=199, kv_len=200, window=45),
    "tail": dict(Skv=200, q_start=120, kv_len=121),
}


@pytest.mark.parametrize("case", sorted(ROW_CASES))
@pytest.mark.parametrize("splits", [None, 1, 7, 64])
def test_split_decode_at_g48_matches_reference(splits, case):
    c = dict(ROW_CASES[case])
    Skv = c.pop("Skv")
    q, k, v = _qkv(4800 + (splits or 0), 1, 1, Skv, G20, 1, 16)
    _, (m, l, acc) = _check_all(q, k, v, splits, **c)
    assert m.shape[-1] == G20 and acc.shape[-2:] == (G20, 16)
    if splits == 64:                              # splits past the range
        assert torch.isneginf(m[:, :, 7:]).all() and not l[:, :, 7:].any()


def test_g48_rows_masked_in_some_and_every_split():
    # 2 queries at 114, 115 of 48 heads each (96 rows, 6 row blocks) over
    # 116 keys, window 20: split 0 of 2 (tile 2, keys 64..95) holds key 95
    # for the first query and no live key for the 48 rows of the second
    q, k, v = _qkv(48, 1, 2, 116, G20, 1, 16)
    kw = dict(q_start=114, kv_len=116, window=20)
    got, (m, l, acc) = _check_all(q, k, v, 2, **kw)
    assert torch.isneginf(m[0, 0, 0, 1]).all() and not l[0, 0, 0, 1].any()
    assert not acc[0, 0, 0, 1].any()
    assert torch.isfinite(m[0, 0, 0, 0]).all()
    assert torch.isfinite(m[0, 0, 1]).all()
    # every key of the second query beyond kv_len: no live key at all
    kw = dict(q_start=8, kv_len=9, window=1)
    for splits in (None, 1, 3):
        got, (m, _, _) = _check_all(q, k[:, :64], v[:, :64],
                                    splits, flash=False, **kw)
        assert torch.isneginf(m[:, :, :, 1]).all()
        assert not got[:, 1].any() and np.abs(got[:, 0]).max() > 0


def test_g48_device_position_partials_match_oracle():
    q, k, v = (torch.from_numpy(x) for x in _qkv(49, 2, 1, 300, G20, 1, 16))
    for pos in (torch.tensor(150), torch.tensor([37, 299])):
        parts = flash_decode_partials_torch(q, k, v, q_start=pos)
        assert parts[0].shape[2] == fk.capacity_splits(
            2, 1, 1, G20, 16, Skv=300, causal=True, window=None)[0]
        got = flash_decode_combine_torch(*parts)
        for b in range(2):
            p = int(pos.reshape(-1)[min(b, pos.numel() - 1)])
            want = np.asarray(jax_ref(
                jnp.asarray(q[b:b + 1].numpy()),
                jnp.asarray(k[b:b + 1].numpy()),
                jnp.asarray(v[b:b + 1].numpy()), q_start=p, kv_len=p + 1))
            np.testing.assert_allclose(got[b:b + 1].numpy(), want, rtol=0,
                                       atol=ATOL32)


def test_decode_source_constants_and_counter_layout():
    src = (fk.CSRC / "flash_decode.cu").read_text()
    import re
    assert int(re.search(r"constexpr int kMaxRows = (\d+);", src)[1]) \
        == fk.DECODE_MAX_ROWS
    assert int(re.search(r"constexpr int kTile = (\d+);", src)[1]) \
        == fk.DECODE_TILE
    # grid z: the row blocks; the arrival counter of (pair, row block)
    assert "(unsigned)((rows + NW - 1) / NW)" in src
    assert "blockIdx.y * gridDim.z + blockIdx.z" in src
    assert "atomicAdd(p.counter + ci, 1)" in src
    assert "p.counter[ci] = 0" in src
    # no refusal of more than 16 rows is left: every call of more than 4
    # rows takes the 16-warp instance, in row blocks beyond 16
    assert "> kMaxRows" not in src
    assert "if (rows <= 4) return launch<T, DMAX, 4>(p, stream);" in src
    assert "return launch<T, DMAX, kMaxRows>(p, stream);" in src
    # the layout gives every (b, KV head, row block) of a launch its own
    # counter, inside the MAX_PAIRS the wrapper allocates
    for B, KV, rows in ((1, 1, 48), (4, 1, 48), (2, 8, 4), (3, 2, 33)):
        RB = fk.row_blocks(rows, 1)
        idx = {(b * KV + h) * RB + z for b in range(B) for h in range(KV)
               for z in range(RB)}
        assert len(idx) == B * KV * RB and max(idx) < fk.MAX_PAIRS
