"""The launch rules of the RG-LRU kernels (``kernels/rglru/kernel.py``), on
the CPU.

The kernels (``csrc/rglru.cu``) cannot run here; what surrounds them can:

  * ``pick_route``: the step kernel up to ``STEP_MAX_T`` steps (decode),
    the staged kernel beyond;
  * ``grid`` / ``block_channels``: the staged launch covers every (batch
    row, channel) exactly once, the last group of channels ragged;
  * ``smem_bytes`` stays under the 227 KB a block may use, for bf16 and
    f32 gx;
  * the constants of ``kernel.py`` are those of ``csrc/rglru.cu`` (the
    backward kernel's threads a block among them);
  * ``copy_channels``: 16-byte copies at Griffin's width, narrower where
    D or an address does not allow them;
  * the port's plain ``rglru_ref`` (what the kernels are held against on
    the card) against ``repro``'s ``rglru_ref`` at ragged T and D, with
    numpy inputs from a seed: f32 within rtol 1e-6 + atol 1e-6;
  * ``impl="cuda"`` and both route wrappers raise on CPU tensors and
    launch nothing.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref  # noqa: E402
from repro_torch.kernels.rglru import kernel as rk  # noqa: E402
from repro_torch.kernels.rglru import rglru  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_ref  # noqa: E402


def test_pick_route_threshold():
    assert rk.STEP_MAX_T >= 1
    for T in range(1, rk.STEP_MAX_T + 1):
        assert rk.pick_route(T) == "step"
    for T in (rk.STEP_MAX_T + 1, rk.CHUNK - 1, rk.CHUNK, rk.CHUNK + 1,
              1024, 2560):
        assert rk.pick_route(T) == "staged"


@pytest.mark.parametrize("B,D", [(1, 1), (1, 16), (2, 37), (2, 40),
                                 (3, 64), (1, 2560), (2, 2561)])
def test_grid_covers_every_channel_once(B, D):
    seen = np.zeros((B, D), np.int64)
    blocks = rk.grid(B, D)
    assert blocks == B * -(-D // rk.CHANNELS)
    for blk in range(blocks):
        b, d0, d1 = rk.block_channels(blk, D)
        assert 0 <= b < B and d0 % rk.CHANNELS == 0
        assert 0 < d1 - d0 <= rk.CHANNELS
        seen[b, d0:d1] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("esz", [2, 4])
def test_smem_bytes_fit_a_block(esz):
    ring = rk.STAGES * rk.CHUNK * rk.CHANNELS * (4 + esz)
    ab = 2 * 2 * rk.CHUNK * rk.CHANNELS * 4
    assert rk.smem_bytes(esz) == ring + ab
    assert rk.smem_bytes(esz) <= 227 * 1024     # a block's most on an H100


def test_constants_are_the_sources():
    text = rk.SOURCE.read_text()
    got = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                               text).group(1))
           for name in ("kChannels", "kChunk", "kStages", "kStepMaxT",
                        "kBwdChunk", "kBwdStages")}
    assert got == {"kChannels": rk.CHANNELS, "kChunk": rk.CHUNK,
                   "kStages": rk.STAGES, "kStepMaxT": rk.STEP_MAX_T,
                   "kBwdChunk": rk.BACKWARD_CHUNK,
                   "kBwdStages": rk.BACKWARD_STAGES}
    assert rk.CONSTANTS == (rk.CHANNELS, rk.CHUNK, rk.STAGES, rk.STEP_MAX_T,
                            rk.BACKWARD_CHUNK, rk.BACKWARD_STAGES,
                            rk.BACKWARD_THREADS)
    # a chunk is whole quads of steps, a block whole units of 8 channels
    assert rk.CHUNK % 16 == 0 and rk.CHANNELS % 8 == 0


@pytest.mark.parametrize("D,esz,la,gx,want", [
    (2560, 2, 0, 0, 8),        # Griffin: 16-byte copies of la and gx
    (2560, 4, 0, 0, 8),
    (40, 2, 0, 0, 8),
    (36, 2, 0, 0, 4),          # 16 B of la, 8 B of gx
    (38, 2, 0, 0, 2),
    (37, 2, 0, 0, 1),          # 4 B of la, 2 B of gx
    (37, 4, 0, 0, 1),
    (2560, 2, 4, 0, 1),        # la 4-byte aligned only
    (2560, 2, 0, 8, 4),        # gx 8-byte aligned only
    (2560, 4, 8, 0, 2),
])
def test_copy_channels(D, esz, la, gx, want):
    base = 0x7F12_3456_0000
    v = rk.copy_channels(D, esz, base + la, base + gx)
    assert v == want
    assert D % v == 0
    assert (base + la) % min(16, 4 * v) == 0
    assert (base + gx) % min(16, esz * v) == 0


def _inputs(seed, B, T, D):
    rng = np.random.default_rng(seed)
    la = (-0.5 * np.exp(rng.standard_normal((B, T, D)))).astype(np.float32)
    gx = rng.standard_normal((B, T, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return la, gx, h0


@pytest.mark.parametrize("B,T,D", [(1, 1, 5), (2, 7, 37), (1, 129, 40),
                                   (2, 3, 16)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_version_matches_jax_ref(B, T, D, with_h0):
    la, gx, h0 = _inputs(B * 1000 + T * 10 + D, B, T, D)
    h0 = h0 if with_h0 else None
    h, hT = rglru_ref(torch.from_numpy(la), torch.from_numpy(gx),
                      None if h0 is None else torch.from_numpy(h0))
    jh, jhT = jax_rglru_ref(jnp.asarray(la), jnp.asarray(gx),
                            None if h0 is None else jnp.asarray(h0))
    assert h.shape == (B, T, D) and hT.shape == (B, D)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(hT.numpy(), np.asarray(jhT), rtol=1e-6,
                               atol=1e-6)


def test_cuda_routes_raise_on_cpu_tensors():
    la, gx, h0 = (torch.from_numpy(a) for a in _inputs(3, 1, 20, 16))
    rk.reset_launches()
    for fn in (rk.rglru_cuda, rk.rglru_step_cuda, rk.rglru_staged_cuda):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(la, gx, h0)
    with pytest.raises(ValueError, match="CUDA"):
        rglru(la, gx, h0, impl="cuda")
    assert rk.LAUNCHES == {"rglru": 0, "rglru_backward": 0}
    assert rk.ROUTES == {"step": 0, "staged": 0}
