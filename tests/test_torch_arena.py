"""The port's arena ops on the CPU against the JAX package's.

The CUDA kernels cannot run here; their plain PyTorch versions (what the
dispatch takes for CPU tensors, and what ``chip_smoke.py`` holds the kernels
against on the card) are compared with ``repro``'s ``ref`` (numpy) and
``xla`` impls on the same numpy inputs.  Copies and adds are bit-equal.
Each elementwise op is allclose to its jnp callable with rtol 1e-5 and
atol 1e-6: XLA's and torch's transcendentals differ in the last ulps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP pool on 150k-element ops would take the cores from the others
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.kernels.arena as ja  # noqa: E402
from repro.kernels.arena import ref as jref  # noqa: E402
from repro.kernels.arena.elemwise import ELEMWISE_FNS as JAX_FNS  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import arena as ta  # noqa: E402
from repro_torch.kernels.arena import kernel as tk  # noqa: E402
from repro_torch.kernels.arena.elemwise import (  # noqa: E402
    ELEMWISE_FNS,
    ELEMWISE_OP_CODES,
    EXACT_OPS,
    MAX_CHAIN,
    chain_codes,
)

RTOL, ATOL = 1e-5, 1e-6
SPANS = [(0, 0), (0, 1), (5, 3), (17, 4097), (3, 150528)]


def _arena_and_x(rng, offset, n, dtype):
    size = offset + n + 11
    if dtype == np.uint8:
        return (rng.integers(0, 256, size, dtype=np.uint8),
                rng.integers(0, 256, n, dtype=np.uint8))
    return (rng.standard_normal(size).astype(np.float32),
            (3 * rng.standard_normal(n)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("offset,n", SPANS)
def test_write_and_read_match_reference(offset, n, dtype):
    rng = np.random.default_rng(offset * 7 + n)
    a, x = _arena_and_x(rng, offset, n, dtype)
    got = ta.arena_write(_t(a), _t(x), offset).numpy()
    np.testing.assert_array_equal(got, jref.arena_write_ref(a, x, offset))
    np.testing.assert_array_equal(
        got, np.asarray(ja.arena_write(jnp.asarray(a), jnp.asarray(x),
                                       offset, impl="xla")))
    arena = _t(a)
    r = ta.arena_read(arena, offset, n)
    np.testing.assert_array_equal(r.numpy(), jref.arena_read_ref(a, offset, n))
    np.testing.assert_array_equal(
        r.numpy(), np.asarray(ja.arena_read(jnp.asarray(a), offset, n,
                                            impl="xla")))
    if n:   # a fresh copy, not a view that a later write would change
        arena[offset] += 1
        assert r[0] != arena[offset]


@pytest.mark.parametrize("offset,n", SPANS)
def test_accum_matches_reference(offset, n):
    rng = np.random.default_rng(n + 1)
    a, x = _arena_and_x(rng, offset, n, np.float32)
    got = ta.arena_accum(_t(a), _t(x), offset).numpy()
    np.testing.assert_array_equal(got, jref.arena_accum_ref(a, x, offset))
    np.testing.assert_array_equal(
        got, np.asarray(ja.arena_accum(jnp.asarray(a), jnp.asarray(x),
                                       offset, impl="xla")))


CHAINS = [("relu", "bn"), ("bn", "relu"), ("bn",),
          ("relu", "bn", "relu", "bn"), ("bn", "scale", "bias_add", "relu6"),
          ("gelu", "silu", "tanh", "sigmoid"), ()]


@pytest.mark.parametrize("ops", CHAINS)
@pytest.mark.parametrize("offset,n", SPANS[:4])
def test_chain_write_matches_reference(offset, n, ops):
    rng = np.random.default_rng(len(ops) * 100 + n)
    a, x = _arena_and_x(rng, offset, n, np.float32)
    got = ta.arena_chain_write(_t(a), _t(x), offset, ops).numpy()
    xla = np.asarray(ja.arena_chain_write(jnp.asarray(a), jnp.asarray(x),
                                          offset, ops, impl="xla"))
    ref = jref.arena_chain_write_ref(a, x, offset, ops)
    if set(ops) <= EXACT_OPS:
        np.testing.assert_array_equal(got, xla)
    np.testing.assert_allclose(got, xla, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("op", sorted(ELEMWISE_FNS))
def test_elemwise_op_matches_jnp(op):
    x = (4 * np.random.default_rng(3).standard_normal(4099)).astype(np.float32)
    got = ELEMWISE_FNS[op](torch.from_numpy(x)).numpy()
    want = np.asarray(JAX_FNS[op](jnp.asarray(x)))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_op_tables_cover_the_same_ops():
    assert set(ELEMWISE_FNS) == set(JAX_FNS) == set(ELEMWISE_OP_CODES)
    assert EXACT_OPS < set(ELEMWISE_FNS)
    assert chain_codes(("relu", "bn", "identity")) == [1, 3, 0]
    with pytest.raises(ValueError):
        chain_codes(("relu",) * (MAX_CHAIN + 1))
    with pytest.raises(KeyError):
        chain_codes(("softmax",))


def test_dispatch_picks_plain_on_cpu_and_never_falls_back():
    arena, x = torch.zeros(8), torch.ones(3)
    tk.reset_launches()
    ta.arena_write(arena, x, 2)                      # auto on the CPU
    ta.arena_write(arena, x, 4, impl="torch")
    assert arena.tolist() == [0, 0, 1, 1, 1, 1, 1, 0]
    assert all(v == 0 for v in ta.LAUNCHES.values())
    with pytest.raises(ValueError, match="CUDA"):
        ta.arena_read(arena, 0, 2, impl="cuda")
    with pytest.raises(ValueError, match="unknown arena impl"):
        ta.arena_read(arena, 0, 2, impl="xla")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tk.arena_accum_cuda(arena, x, 0)


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(tk.KernelBuildError, match="nvcc not found"):
        tk.build()
