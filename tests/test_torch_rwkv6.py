"""The port's WKV-6 recurrence against ``repro``'s, on the CPU.

Inputs are made with numpy from a seed and handed to both packages
(bf16 inputs are rounded once, by JAX, and carried across as float32,
which holds them exactly).  The port's plain version (``impl="torch"``,
the CPU path of ``wkv6``; the CUDA kernel is held against it on the card
by ``chip_smoke.py``) is compared with:

  * ``wkv6_ref`` and ``wkv6_pallas(interpret=True)`` on
    ``tests/test_kernels.py``'s sweep, f32 and bf16: f32 outputs and every
    final state within 1e-5 (sums in another order); bf16 outputs within
    one bf16 ulp of the output + 1e-5 (the same f32 value, rounded once);
  * ``wkv6_ref`` at a T that is no multiple of the Pallas chunk;
  * state threading: a split run (T/2 + T/2, the state threaded) equals
    the whole run bit for bit within the port, and the final state can be
    written in place into the initial-state tensor.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv6.kernel import wkv6_pallas  # noqa: E402
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro_torch.kernels.rwkv6 import LAUNCHES, reset_launches, wkv6  # noqa: E402
from repro_torch.kernels.rwkv6 import kernel as wk  # noqa: E402

TOL32 = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, B, T, H, N, dtype=jnp.float32, state=False):
    """numpy inputs as test_kernels.py draws them (w = exp(-exp(z)),
    u ~ 0.5 N(0, 1)), rounded to ``dtype`` by JAX; returns the JAX arrays
    and their float32 numpy values."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)) for _ in range(3))
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, N))))
    u = 0.5 * rng.standard_normal((H, N))
    jx = [jnp.asarray(a, jnp.float32).astype(dtype) for a in (r, k, v, w, u)]
    s0 = (rng.standard_normal((B, H, N, N)).astype(np.float32)
          if state else None)
    return jx, [np.array(a, np.float32) for a in jx], s0


def _torch(xs, dtype):
    return [torch.from_numpy(a).to(dtype) for a in xs]


def _bf16_ulp(x):
    _, e = np.frexp(x)
    return np.ldexp(np.ones_like(x), e - 8)


def _assert_out(got, want):
    """f32: within TOL32; bf16: within one bf16 ulp of the output + 1e-5."""
    if got.dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL32)
        return
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert np.all(np.abs(g - w) <= _bf16_ulp(np.maximum(np.abs(g),
                                                        np.abs(w))) + 1e-5)


@pytest.mark.parametrize("B,T,H,N,chunk", [
    (1, 32, 2, 8, 8), (2, 64, 3, 16, 16), (1, 48, 1, 32, 48),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_sweep_against_ref_and_pallas(B, T, H, N, chunk, dtype):
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    jx, nx, _ = _inputs(0, B, T, H, N, jdt)
    o, s = wkv6(*_torch(nx, tdt), impl="torch")
    assert o.dtype == tdt and s.dtype == torch.float32
    for name, (jo, js) in (
            ("ref", jax_wkv6_ref(*jx)),
            ("pallas", wkv6_pallas(*jx, chunk=chunk, interpret=True))):
        _assert_out(o, jo)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL32,
                                   err_msg=name)


@pytest.mark.parametrize("state", [False, True])
def test_wkv6_t_not_a_chunk_multiple(state):
    jx, nx, s0 = _inputs(1, 2, 37, 2, 16, state=state)
    o, s = wkv6(*_torch(nx, torch.float32), impl="torch",
                initial_state=None if s0 is None else torch.from_numpy(s0))
    jo, js = jax_wkv6_ref(*jx, None if s0 is None else jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL32)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), **TOL32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_state_threading(dtype):
    _, nx, s0 = _inputs(7, 1, 32, 2, 8, state=True)
    r, k, v, w, u = _torch(nx, dtype)
    s0 = torch.from_numpy(s0)
    o_full, s_full = wkv6(r, k, v, w, u, initial_state=s0, impl="torch")
    o1, s1 = wkv6(r[:, :16], k[:, :16], v[:, :16], w[:, :16], u,
                  initial_state=s0, impl="torch")
    # the second half writes its final state in place into s1
    o2, s2 = wkv6(r[:, 16:], k[:, 16:], v[:, 16:], w[:, 16:], u,
                  initial_state=s1, state_out=s1, impl="ref")
    assert s2 is s1
    assert torch.equal(torch.cat([o1, o2], 1), o_full)
    assert torch.equal(s2, s_full)


def test_auto_is_plain_on_cpu_and_cuda_raises():
    _, nx, _ = _inputs(3, 1, 5, 2, 16)
    xs = _torch(nx, torch.float32)
    reset_launches()
    auto = wkv6(*xs)
    plain = wkv6(*xs, impl="torch")
    assert all(torch.equal(a, b) for a, b in zip(auto, plain))
    assert LAUNCHES["wkv6"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        wkv6(*xs, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        wk.wkv6_cuda(*xs)
    with pytest.raises(ValueError, match="unknown wkv6 impl"):
        wkv6(*xs, impl="pallas")
