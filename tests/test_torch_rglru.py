"""The port's RG-LRU recurrence against ``repro``'s, on the CPU.

Inputs are made with numpy from a seed (``log_a = -0.5 exp(z)`` as
``tests/test_kernels.py`` draws it) and handed to both packages.  The
port's plain version (``impl="torch"``, the CPU path of ``rglru``; the
CUDA kernel is held against it on the card by ``chip_smoke.py``) is
compared with ``rglru_ref``, ``rglru_pallas(interpret=True)`` and the
``xla`` associative scan, with and without ``h0``: within 1e-5 of the
sequential versions (one multiply-add a step, rounded alike; the
exponentials of two libraries may differ in the last ulp) and within
1e-4 of the scan (products taken in another order).  ``h`` comes back in
``gx``'s dtype and ``hT`` in f32; state threading and the in-place final
state are held within the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.kernel import rglru_pallas  # noqa: E402
from repro.kernels.rglru.ops import rglru as jax_rglru  # noqa: E402
from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref  # noqa: E402
from repro_torch.kernels.rglru import LAUNCHES, reset_launches, rglru  # noqa: E402
from repro_torch.kernels.rglru import kernel as rk  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
TOL_SCAN = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, T, D):
    rng = np.random.default_rng(seed)
    la = (-0.5 * np.exp(rng.standard_normal((B, T, D)))).astype(np.float32)
    gx = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return la, gx, h0


@pytest.mark.parametrize("B,T,D,chunk", [(1, 32, 16, 8), (2, 64, 32, 32)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_against_ref_pallas_and_scan(B, T, D, chunk, with_h0):
    la, gx, h0 = _inputs(0, B, T, D)
    h0 = h0 if with_h0 else None
    jargs = (jnp.asarray(la), jnp.asarray(gx),
             None if h0 is None else jnp.asarray(h0))
    h, hT = rglru(torch.from_numpy(la), torch.from_numpy(gx),
                  None if h0 is None else torch.from_numpy(h0),
                  impl="torch")
    assert h.dtype == torch.float32 and hT.shape == (B, D)
    for name, (jh, jhT), tol in (
            ("ref", jax_rglru_ref(*jargs), TOL),
            ("pallas", rglru_pallas(*jargs, chunk=chunk, interpret=True),
             TOL),
            ("xla scan", jax_rglru(*jargs, impl="xla"), TOL_SCAN)):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **tol,
                                   err_msg=name)
        np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), **tol,
                                   err_msg=name)


def test_rglru_bf16_gx_and_odd_t():
    la, gx, h0 = _inputs(1, 2, 37, 24)
    jgx = jnp.asarray(gx).astype(jnp.bfloat16)
    jh, jhT = jax_rglru_ref(jnp.asarray(la), jgx, jnp.asarray(h0))
    h, hT = rglru(torch.from_numpy(la),
                  torch.from_numpy(np.asarray(jgx, np.float32)).bfloat16(),
                  torch.from_numpy(h0))
    assert h.dtype == torch.bfloat16 and hT.dtype == torch.float32
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), **TOL)
    g, w = h.float().numpy(), np.asarray(jh, np.float32)
    _, e = np.frexp(np.maximum(np.abs(g), np.abs(w)))
    assert np.all(np.abs(g - w) <= np.ldexp(1.0, e - 8) + 1e-5)


def test_rglru_state_threading_in_place():
    la, gx, h0 = (torch.from_numpy(a) for a in _inputs(2, 1, 40, 16))
    h_full, hT_full = rglru(la, gx, h0)
    carry = h0.clone()
    h1, _ = rglru(la[:, :25], gx[:, :25], carry, state_out=carry)
    h2, hT = rglru(la[:, 25:], gx[:, 25:], carry, state_out=carry,
                   impl="ref")
    assert hT is carry
    assert torch.equal(torch.cat([h1, h2], 1), h_full)
    assert torch.equal(hT, hT_full)


def test_auto_is_plain_on_cpu_and_cuda_raises():
    la, gx, h0 = (torch.from_numpy(a) for a in _inputs(3, 1, 5, 16))
    reset_launches()
    auto = rglru(la, gx, h0)
    assert all(torch.equal(a, b)
               for a, b in zip(auto, rglru(la, gx, h0, impl="torch")))
    assert LAUNCHES["rglru"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        rglru(la, gx, h0, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rk.rglru_cuda(la, gx, h0)
    with pytest.raises(ValueError, match="unknown rglru impl"):
        rglru(la, gx, impl="xla")
