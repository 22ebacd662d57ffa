"""The tensor-core prefill's route, shared memory and constants, on the CPU
(``kernels/flash_attention/kernel.py``; the kernel,
``csrc/flash_prefill_sm90.cu``, runs on the card only).

  * bf16 calls of more than 16 rows at a host position go to the prefill
    kernel at every pair of ``PREFILL_HEAD_DIMS``, MLA's (192, 128)
    among them; f32 calls and the (16, 16) pair to the simple kernel;
  * ``prefill_smem_bytes`` equals the source's ``smem_bytes<D, Dv>()``
    with its ``Config<D, Dv>::kStages``, stays within a block's 232,448
    bytes, and leaves room for two blocks an SM at (128, 128) and
    (192, 128) (an SM's 228 KB less 1 KB a block);
  * the source's entry dispatches exactly the pairs of
    ``PREFILL_HEAD_DIMS``, and its tile constants are ``PREFILL_TILE``;
  * the prefill wrapper raises on CPU tensors and on a pair or dtype it
    does not take, and launches nothing.
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402

SOURCE = fk.CSRC / "flash_prefill_sm90.cu"
SMEM_LIMIT = 232_448          # dynamic shared memory a block may use (H100)
SM_SMEM = 228 * 1024          # shared memory of an SM, 1 KB of it per block


def _configs():
    pat = (r"template <> struct Config<(\d+), (\d+)> \{ enum \{ "
           r"kStages = (\d+) \}; \};")
    return {(int(d), int(dv)): int(s)
            for d, dv, s in re.findall(pat, SOURCE.read_text())}


def _source_smem(D, Dv):
    text = SOURCE.read_text()
    expr = re.search(r"constexpr int smem_bytes\(\) \{\s*return ([^;]+);",
                     text).group(1)
    ints = {name: int(re.search(rf"constexpr int {name} = (\d+);",
                                text).group(1))
            for name in ("kRows", "kTile")}
    expr = expr.replace("Config<D, Dv>::kStages", str(_configs()[(D, Dv)]))
    for name, val in ints.items():
        expr = expr.replace(name, str(val))
    expr = re.sub(r"\bDv\b", str(Dv), expr)
    expr = re.sub(r"\bD\b", str(D), expr)
    assert re.fullmatch(r"[\d\s()+*]+", expr), expr
    return eval(expr)


@pytest.mark.parametrize("dims", fk.PREFILL_HEAD_DIMS)
def test_route_takes_every_prefill_pair_in_bf16(dims):
    assert fk.pick_route(1024, 1, torch.bfloat16, *dims) == "prefill"
    assert fk.pick_route(17, 1, torch.bfloat16, *dims) == "prefill"
    assert fk.pick_route(1024, 1, torch.float32, *dims) == "simple"
    assert fk.pick_route(16, 1, torch.bfloat16, *dims) == "decode"
    assert fk.pick_route(1024, 1, torch.bfloat16, *dims,
                         device_pos=True) == "decode"


@pytest.mark.parametrize("dims", fk.PREFILL_HEAD_DIMS)
def test_smem_bytes_are_the_sources_and_fit_a_block(dims):
    got = fk.prefill_smem_bytes(*dims)
    assert got == _source_smem(*dims)
    assert got <= SMEM_LIMIT
    if dims in ((128, 128), (192, 128)):
        assert 2 * (got + 1024) <= SM_SMEM


def test_constants_are_the_sources():
    text = SOURCE.read_text()
    for name in ("kRows", "kTile"):
        assert int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1)) == fk.PREFILL_TILE
    assert _configs() == fk.PREFILL_STAGES
    assert set(fk.PREFILL_STAGES) == set(fk.PREFILL_HEAD_DIMS)
    dispatched = {(int(d), int(dv)) for d, dv in re.findall(
        r"if \(D == (\d+) && Dv == (\d+)\) return launch<\1, \2>", text)}
    assert dispatched == set(fk.PREFILL_HEAD_DIMS)
    # 2 blocks an SM at (192, 128): Q + 2 x (K + V) + 1024 bytes
    assert fk.prefill_smem_bytes(192, 128) == 24_576 + 2 * (24_576
                                                            + 16_384) + 1024


@pytest.mark.parametrize("dtype,dims", [(torch.bfloat16, (192, 128)),
                                        (torch.float32, (192, 128)),
                                        (torch.bfloat16, (16, 16))])
def test_prefill_wrapper_raises_and_launches_nothing(dtype, dims):
    D, Dv = dims
    q = torch.zeros(1, 80, 4, D, dtype=dtype)
    k = torch.zeros(1, 80, 4, D, dtype=dtype)
    v = torch.zeros(1, 80, 4, Dv, dtype=dtype)
    fk.reset_launches()
    takes = dtype == torch.bfloat16 and dims in fk.PREFILL_HEAD_DIMS
    with pytest.raises(ValueError, match="CUDA tensors only" if takes
                       else "the prefill kernel takes bf16"):
        fk.flash_prefill_cuda(q, k, v, causal=True, window=None, q_start=0,
                              kv_len=80, softmax_scale=D ** -0.5)
    assert fk.LAUNCHES["flash_prefill"] == 0
