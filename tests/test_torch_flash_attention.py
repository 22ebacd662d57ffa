"""The port's attention (``impl="torch"`` and ``"ref"``) against ``repro``'s.

The CUDA kernel cannot run here; its plain PyTorch version (what the
dispatch takes for CPU tensors, and what ``chip_smoke.py`` holds the kernel
against on the card) and the port's oracle are compared with ``repro``'s
``attention_ref``, its chunked ``_flash_xla`` (``impl="xla"``) and, at the
shapes the Pallas kernel accepts (``Skv % bk == 0``), with
``flash_attention_pallas(..., interpret=True)``.  Inputs are made with
numpy from a seed.  Tolerance in f32: atol 1e-5 (sums in another order);
in bf16: atol 2e-2, rtol 2e-2 (one bf16 rounding of values below 4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_pallas,
)
from repro.kernels.flash_attention.ops import (  # noqa: E402
    flash_attention as jax_flash,
)
from repro.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref as jax_ref,
)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    LAUNCHES,
    flash_attention,
    reset_launches,
)
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

ATOL32 = 1e-5


def _qkv(seed, B, Sq, Skv, H, KV, D, Dv=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, Dv or D)).astype(np.float32)
    return q, k, v


def _port(q, k, v, impl, **kw):
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), impl=impl, **kw)
    return out.float().numpy()


def _jax(q, k, v, impl, **kw):
    out = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    impl=impl, **kw)
    return np.asarray(out, np.float32)


def _check_all(q, k, v, *, pallas=True, kv_chunk=1024, **kw):
    want = np.asarray(jax_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), **kw))
    xla = _jax(q, k, v, "xla", kv_chunk=kv_chunk, **kw)
    got_torch = _port(q, k, v, "torch", kv_chunk=kv_chunk, **kw)
    got_ref = _port(q, k, v, "ref", **kw)
    np.testing.assert_allclose(got_ref, want, rtol=0, atol=ATOL32)
    np.testing.assert_allclose(got_torch, want, rtol=0, atol=ATOL32)
    np.testing.assert_allclose(got_torch, xla, rtol=0, atol=ATOL32)
    if pallas:
        pal = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bq=16, bk=16,
            interpret=True, **kw))
        np.testing.assert_allclose(got_torch, pal, rtol=0, atol=ATOL32)
        np.testing.assert_allclose(got_ref, pal, rtol=0, atol=ATOL32)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("D", [16, 64])
def test_causal_prefill_gqa(G, D):
    q, k, v = _qkv(G * 10 + D, 2, 32, 32, 2 * G, 2, D)
    _check_all(q, k, v, causal=True, kv_chunk=16)


@pytest.mark.parametrize("G", [1, 4])
def test_non_causal(G):
    q, k, v = _qkv(7 + G, 1, 16, 48, 2 * G, 2, 16)
    _check_all(q, k, v, causal=False, kv_chunk=16)


@pytest.mark.parametrize("window", [1, 5, 24])
def test_sliding_window(window):
    q, k, v = _qkv(window, 1, 48, 48, 4, 2, 16)
    _check_all(q, k, v, causal=True, window=window, kv_chunk=16)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("t", [0, 15, 70, 95])
def test_decode_against_cache(G, t):
    # one new token at position t over a 96-row buffer with t + 1 valid
    q, k, v = _qkv(t * 3 + G, 2, 1, 96, 2 * G, 2, 16)
    _check_all(q, k, v, causal=True, q_start=t, kv_len=t + 1, kv_chunk=32)


def test_decode_window_against_cache():
    q, k, v = _qkv(11, 1, 1, 64, 8, 2, 16)
    _check_all(q, k, v, causal=True, window=20, q_start=50, kv_len=51,
               kv_chunk=16)


def test_multi_token_decode_against_cache():
    # a 16-token chunk at position 33 over a 96-row buffer
    q, k, v = _qkv(12, 1, 16, 96, 4, 2, 16)
    _check_all(q, k, v, causal=True, q_start=33, kv_len=49, kv_chunk=32)


@pytest.mark.parametrize("Skv,kv_chunk", [(50, 16), (33, 1024), (1, 1024)])
def test_ragged_skv(Skv, kv_chunk):
    # Skv not a multiple of the chunk: the plain version pads, as
    # _flash_xla does; the Pallas kernel refuses the shape
    q, k, v = _qkv(Skv, 1, Skv, Skv, 4, 2, 16)
    _check_all(q, k, v, pallas=False, causal=True, kv_chunk=kv_chunk)
    qd, _, _ = _qkv(Skv + 1, 1, 1, Skv, 4, 2, 16)
    _check_all(qd, k, v, pallas=False, causal=True, q_start=Skv - 1,
               kv_len=Skv, kv_chunk=kv_chunk)


@pytest.mark.parametrize("D,Dv", [(32, 16), (16, 64)])
def test_value_dim_differs(D, Dv):
    # Dv != D (MLA's shape): ref and _flash_xla take it, Pallas does not
    q, k, v = _qkv(D + Dv, 1, 24, 24, 4, 2, D, Dv)
    _check_all(q, k, v, pallas=False, causal=True, kv_chunk=16)


@pytest.mark.parametrize("Sq,Skv,kw", [
    (80, 80, dict()),                               # a prompt
    (40, 150, dict(q_start=70, kv_len=110)),        # a partly filled cache
])
def test_mla_pair(Sq, Skv, kw):
    # MLA's expanded prefill (D 192 = 128 + 64, Dv 128, its own scale), the
    # pair the tensor-core prefill takes in bf16; Pallas does not take it
    q, k, v = _qkv(Sq + Skv, 1, Sq, Skv, 4, 4, 192, 128)
    _check_all(q, k, v, pallas=False, causal=True, kv_chunk=32,
               softmax_scale=192 ** -0.5, **kw)


def test_masked_tail_does_not_leak():
    # finite garbage beyond kv_len must not reach the output
    q, k, v = _qkv(5, 1, 1, 64, 4, 2, 16)
    k2, v2 = k.copy(), v.copy()
    k2[:, 40:] = 1e4
    v2[:, 40:] = -1e4
    for impl in ("torch", "ref"):
        a = _port(q, k, v, impl, q_start=39, kv_len=40)
        b = _port(q, k2, v2, impl, q_start=39, kv_len=40)
        np.testing.assert_array_equal(a, b)


def test_bf16_against_flash_xla():
    q, k, v = _qkv(21, 1, 32, 32, 8, 2, 64)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    got = flash_attention(qb, kb, vb, impl="torch", kv_chunk=16)
    assert got.dtype == torch.bfloat16
    want = jax_flash(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                     impl="xla", kv_chunk=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_auto_is_plain_on_cpu_and_cuda_raises():
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 4, 4, 2, 1, 16))
    reset_launches()
    auto = flash_attention(q, k, v)
    assert torch.equal(auto, flash_attention(q, k, v, impl="torch"))
    assert LAUNCHES["flash_attention"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fk.flash_attention_cuda(q, k, v, causal=True, window=None,
                                q_start=0, kv_len=4)
    with pytest.raises(ValueError, match="unknown attention impl"):
        flash_attention(q, k, v, impl="pallas")
