"""The port's dry-run (``repro_torch.launch.dryrun``) and the kernels'
``torch.library`` ops it counts.

* Parity with ``repro``: ``min_bytes_estimate``, ``model_flops`` and
  ``cell_applicable`` for every config, shape and production mesh size,
  and ``VARIANTS``, equal ``repro.launch.dryrun``'s exactly.  ``repro``'s
  module writes ``XLA_FLAGS`` for 512 host devices into ``os.environ`` when
  imported, so it is imported only in a subprocess.
* The counting mode (``CostMode``), in a subprocess over a fake group of 4
  ranks on the CPU: per-device products on a data-parallel mesh are a
  quarter of the unsharded count, a DTensor op is counted once (at its
  local shape), a view moves no byte, a redistribution is one all-gather
  of its result's bytes.
* The ops: on fake CPU tensors each op's shapes and dtypes equal the plain
  version's outputs on small real inputs, its FLOP formula equals the cost
  module, and the cost module's live (query, key) pairs equal a brute-force
  count; ``chip_smoke.py``'s bounds equal the formulas it had before the
  cost module.
* Whole cells at full width on the CPU (``--device cpu``): llama3.2-1b's
  ``decode_32k`` and ``train_4k`` on the single pod, through the CLI in a
  subprocess: ``repro``'s keys, the arguments' bytes equal rank 0's shards
  computed here from the abstract leaves, collectives in the train cell,
  the process's peak RSS under 2 GB; on a mocked card,
  deepseek-v3-671b's ``train_4k`` is written not applicable when the
  backward's head dims lack its MLA's (192, 128) (``NoBackward``'s path,
  which no config takes now), and starcoder2-7b's (heads (128, 128)),
  recurrentgemma-2b's, rwkv6-7b's and seamless-m4t-medium's (its
  encoder's and cross-attention's non-causal backward) applicable at full
  depth, their kernels' launches a device pinned (starcoder2: 64
  ``flash_prefill``, 32 ``flash_backward_sm90``; Griffin: 16
  ``flash_prefill``, 8 ``flash_backward``, 34 ``rglru_staged`` and 18
  ``rglru_backward``; rwkv6: 64 ``wkv6`` and 32 ``wkv6_backward``;
  seamless: 72 ``flash_prefill`` and 36 ``flash_backward_sm90``:
  chip_smoke.py's ``train_launches``).
* ``flash_backward_cost`` against a count over explicit (query, key)
  pairs: causal with and without a window, non-causal with Sq != Skv, and
  D != Dv (MLA's (192, 128)), and the bounds of the three training
  shapes the two new families' backward runs at.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import flop_registry  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.kernels import costs  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as FK  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FO  # noqa: E402
from repro_torch.kernels.rglru import kernel as RK  # noqa: E402
from repro_torch.kernels.rglru.ref import (  # noqa: E402
    rglru_backward_torch,
    rglru_ref,
)
from repro_torch.kernels.rwkv6 import kernel as WK  # noqa: E402
from repro_torch.kernels.rwkv6.ref import (  # noqa: E402
    wkv6_backward_torch,
    wkv6_ref,
)
from repro_torch.launch import dryrun as D  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
ops = torch.ops.repro_torch


def _env(**kw):
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1",
                JAX_PLATFORMS="cpu", **kw)


def _run(code: str, timeout: int = 120) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         env=_env(), capture_output=True, text=True,
                         timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


# ------------------------------------------------------- parity with repro

_REPRO = """
import json
import repro.configs as configs
import repro.launch.dryrun as D
from repro.configs.base import SHAPES
out = {}
for arch in configs.ARCH_NAMES:
    cfg = configs.get(arch)
    for s in SHAPES:
        out[f"{arch} {s}"] = dict(
            ok=list(D.cell_applicable(cfg, s)),
            flops=D.model_flops(cfg, SHAPES[s]),
            bytes={n: D.min_bytes_estimate(cfg, SHAPES[s], n)
                   for n in (256, 512)})
print(json.dumps(dict(cells=out, variants=D.VARIANTS)))
"""


def test_analytics_and_variants_equal_repro():
    got = json.loads(_run(_REPRO))
    assert sorted(configs.ARCH_NAMES) == sorted(
        k.split()[0] for k in got["cells"] if k.endswith(" train_4k"))
    for arch in configs.ARCH_NAMES:
        cfg = configs.get(arch)
        for s in SHAPES:
            want = got["cells"][f"{arch} {s}"]
            assert list(D.cell_applicable(cfg, s)) == want["ok"]
            assert D.model_flops(cfg, SHAPES[s]) == want["flops"]
            for n in (256, 512):
                assert D.min_bytes_estimate(cfg, SHAPES[s], n) \
                    == want["bytes"][str(n)], (arch, s, n)
    assert json.loads(json.dumps(D.VARIANTS)) == got["variants"]


# ------------------------------------------------------- the counting mode

_MODE = """
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.launch.dryrun import CostMode, fake_world
from repro_torch.parallel import sharding

out = {}
with fake_world(4):
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        xl = torch.empty(2, 16)
        w = torch.empty(16, 32)
        y = torch.empty(8, 16)
    x = DTensor.from_local(xl, mesh, [Shard(0)], run_check=False,
                           shape=torch.Size([8, 16]), stride=(16, 1))
    wd = DTensor.from_local(w, mesh, [Replicate()], run_check=False)
    m = CostMode(fake)
    with fake, m:
        z = x @ wd
    out["dp_flops"] = m.flops
    out["dp_bytes"] = m.bytes
    out["dp_local"] = list(z.to_local().shape)
    with fake, FlopCounterMode(display=False) as fc:
        x @ wd
    out["flopcounter"] = fc.get_total_flops()
    with fake, CostMode(fake) as m2:
        y @ w
    out["unsharded_flops"] = m2.flops
    with fake, CostMode(fake) as m3:
        x.view(8, 4, 4)
        x.t()
        x.to_local()[0]
    out["view_bytes"] = m3.bytes
    with fake, CostMode(fake) as m4:
        x.redistribute(mesh, [Replicate()])
    out["redistribute"] = m4.collectives()
    # write_rows at an int start into a sequence-split cache, fake
    mesh2 = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    with fake:
        bl = torch.empty(2, 4, 3, 5)
        new = torch.empty(2, 6, 3, 5)
    buf = DTensor.from_local(bl, mesh2, [Replicate(), Shard(1)],
                             run_check=False, shape=torch.Size([2, 16, 3, 5]),
                             stride=(240, 15, 5, 1))
    with fake, CostMode(fake) as m5:
        sharding.write_rows(buf, new, start=2)
    out["write_rows_fake"] = list(buf.to_local().shape)
    # the host offsets against torch's, rank 0 of meshes of 4
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    got = []
    for dims, pls, shape in (
            ((1, 4), [Replicate(), Shard(1)], (2, 16, 3)),
            ((2, 2), [Shard(0), Shard(1)], (4, 10, 3)),
            ((2, 2), [Shard(1), Shard(1)], (4, 10, 3)),
            ((2, 2), [Shard(0), Shard(0)], (7, 5)),
            ((4,), [Shard(1)], (3, 6, 2))):
        m = init_device_mesh("cpu", dims, mesh_dim_names=tuple(
            "dm"[:len(dims)]))
        want = compute_local_shape_and_global_offset(shape, m, pls)
        have = sharding.local_extent(shape, m, pls)
        got.append([list(want[0]), list(want[1]), have[0], have[1]])
    out["extents"] = got
    # real tensors: rank 0's shard after each write form equals its slice
    # of the plain write
    writes = []
    g = torch.Generator().manual_seed(0)
    for form, S in (("start", 3), ("start", 6), ("positions", 3)):
        for t0 in (0, 2, 3, 5, 13):
            if t0 + S > 16:
                continue
            whole = torch.randn(2, 16, 3, 5, generator=g)
            new = torch.randn(2, S, 3, 5, generator=g)
            buf = DTensor.from_local(whole[:, :4].clone(), mesh2,
                                     [Replicate(), Shard(1)],
                                     run_check=False,
                                     shape=torch.Size([2, 16, 3, 5]),
                                     stride=(240, 15, 5, 1))
            if form == "start":
                sharding.write_rows(buf, new, start=t0)
            else:
                sharding.write_rows(buf, new,
                                    positions=t0 + torch.arange(S))
            want = whole.clone()
            want[:, t0:t0 + S] = new
            writes.append(torch.equal(buf.to_local(), want[:, :4]))
    out["writes"] = writes
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mode_counts():
    return json.loads(_run(_MODE))


def test_data_parallel_products_are_a_quarter_each(mode_counts):
    m = mode_counts
    assert m["dp_local"] == [2, 32]
    assert sum(m["dp_flops"].values()) * 4 == sum(
        m["unsharded_flops"].values()) == 2 * 8 * 16 * 32
    assert m["dp_flops"] == {"tensor": 0, "cuda_core": 2 * 2 * 16 * 32}


def test_a_dtensor_op_counts_once(mode_counts):
    """The counting mode sees the local op once and neither the op at the
    global shape nor DTensor's metadata run of it; ``FlopCounterMode``
    sees the global op (with the local one too, in some torch
    versions)."""
    m = mode_counts
    assert m["flopcounter"] in (2 * 8 * 16 * 32,
                                2 * 8 * 16 * 32 + 2 * 2 * 16 * 32)
    assert sum(m["dp_flops"].values()) == 2 * 2 * 16 * 32
    assert m["dp_bytes"] == 4 * (2 * 16 + 16 * 32 + 2 * 32)


def test_views_move_no_byte(mode_counts):
    assert mode_counts["view_bytes"] == 0


def test_redistribution_counts_its_result(mode_counts):
    c = mode_counts["redistribute"]
    assert c["bytes_by_type"]["all-gather"] == 8 * 16 * 4
    assert c["count_by_type"]["all-gather"] == 1
    assert c["total_bytes"] == 8 * 16 * 4
    assert set(c["bytes_by_type"]) == set(D._COLLECTIVES)


def test_write_rows_at_an_int_start_runs_on_fake_tensors(mode_counts):
    assert mode_counts["write_rows_fake"] == [2, 4, 3, 5]


def test_write_rows_keeps_the_plain_writes_bytes(mode_counts):
    """Rank 0's shard of a sequence-split cache after a write at an int
    start (host arithmetic) or at device positions (no host read) equals
    its slice of the plain write, bit for bit."""
    assert mode_counts["writes"] and all(mode_counts["writes"])


def test_host_offsets_equal_torchs(mode_counts):
    for want_shape, want_off, shape, off in mode_counts["extents"]:
        assert (shape, off) == (want_shape, want_off)


# ------------------------------------------------------- the custom ops

def _live_brute(Sq, q_start, kv_len, causal, window):
    live, keys = 0, set()
    for p in range(q_start, q_start + Sq):
        for j in range(kv_len):
            if causal and j > p:
                continue
            if window is not None and j <= p - window:
                continue
            live += 1
            keys.add(j)
    return live, keys


CASES = [  # (Sq, q_start, kv_len, causal, window)
    (1, 0, 1, True, None), (7, 0, 7, True, None), (64, 0, 64, True, None),
    (1, 1055, 1056, True, None), (5, 20, 25, True, None),
    (5, 20, 22, True, None), (9, 3, 40, False, None), (1, 0, 300, False,
                                                       None),
    (16, 100, 116, True, 8), (1, 2047, 2048, True, 2048),
    (40, 0, 40, True, 7), (3, 30, 12, True, 4), (6, 10, 13, True, 3),
    (0, 5, 5, True, None),
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_live_pairs_equal_a_brute_force_count(case):
    Sq, qs, n, causal, w = case
    live, keys = costs.attention_pairs(Sq, q_start=qs, kv_len=n,
                                       causal=causal, window=w)
    want, seen = _live_brute(Sq, qs, n, causal, w)
    assert live == want
    if seen:
        assert keys == max(seen) - min(seen) + 1


BWD_COST_CASES = [  # (B, Sq, Skv, H, KV, D, Dv, causal, window)
    (2, 24, 24, 4, 2, 64, 64, True, None),
    (2, 24, 24, 4, 2, 64, 64, True, 5),
    (1, 17, 40, 4, 4, 64, 64, False, None),
    (1, 40, 17, 4, 2, 64, 64, False, None),
    (2, 20, 20, 4, 4, 192, 128, True, None),
    (1, 70, 70, 2, 1, 192, 128, True, 9),
]


@pytest.mark.parametrize("case", BWD_COST_CASES, ids=str)
def test_flash_backward_cost_counts_explicit_pairs(case):
    B, Sq, Skv, H, KV, D, Dv, causal, w = case
    live = 0
    for i in range(Sq):
        for j in range(Skv):
            if causal and j > i:
                continue
            if w is not None and j <= i - w:
                continue
            live += 1
    # per live pair and head: the scores and dK and dQ over D, dP and dV
    # over Dv (2 flops a multiply-add)
    flops = B * H * live * (3 * 2 * D + 2 * 2 * Dv)
    # q, dq (D) and o, dO (Dv) of every query; k, dk (D) and v, dv (Dv)
    # of every key
    nbytes = 2 * (B * Sq * H * (2 * D + 2 * Dv)
                  + B * Skv * KV * (2 * D + 2 * Dv))
    assert costs.flash_backward_cost(B, Sq, H, KV, D, 2, Skv=Skv, Dv=Dv,
                                     causal=causal, window=w) == (flops,
                                                                  nbytes)


@pytest.mark.parametrize("shape,want", [
    ((8, 256, 256, 16, 16, 64, 64, False), (33_554_432, 5.37e9)),
    ((8, 256, 384, 16, 16, 64, 64, False), (41_943_040, 8.05e9)),
    ((8, 256, 256, 128, 128, 192, 128, True), (671_088_640, 56.05e9)),
], ids=["seamless encoder", "seamless cross", "deepseek MLA"])
def test_flash_backward_cost_at_the_training_shapes(shape, want):
    # the new forms' bounds at the trained families' shapes (bf16): bytes
    # bound all three on an H100 (3.35 TB/s against 989 TFLOP/s)
    B, Sq, Skv, H, KV, D, Dv, causal = shape
    flops, nbytes = costs.flash_backward_cost(B, Sq, H, KV, D, 2, Skv=Skv,
                                              Dv=Dv, causal=causal)
    assert nbytes == want[0]
    assert abs(flops - want[1]) <= 0.005e9
    assert nbytes / costs.HBM_BYTES_PER_S > flops / costs.BF16_FLOP_PER_S


def _old_fa_bound(q, k, v, kw):
    """``chip_smoke.py``'s ``fa_bound`` before the cost module."""
    B, Sq, H, D = q.shape
    Dv = v.shape[3]
    n, qs, w = kw["kv_len"], kw["q_start"], kw.get("window")
    if not kw.get("causal", True):
        live, keys = Sq * n, n
    else:
        lo = lambda p: 0 if w is None else max(0, p - w + 1)  # noqa: E731
        live = sum(min(n, p + 1) - lo(p) for p in range(qs, qs + Sq))
        keys = min(n, qs + Sq) - lo(qs)
    esz = q.element_size()
    nbytes = esz * (q.numel() + B * Sq * H * Dv + B * keys * k.shape[2]
                    * (k.shape[3] + Dv))
    return (nbytes / 3.35e12 * 1e3, 2 * B * H * (D + Dv) * live / 989e12
            * 1e3)


@pytest.fixture(scope="module")
def smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("shape", [
    (1, 1024, 32, 64, 1024, 8, 64, dict(q_start=0, kv_len=1024)),
    (1, 1, 32, 64, 1056, 8, 64, dict(q_start=1055, kv_len=1056)),
    (1, 2560, 10, 256, 2560, 1, 256, dict(q_start=0, kv_len=2560,
                                          window=2048)),
    (1, 1, 10, 256, 2592, 1, 256, dict(q_start=2591, kv_len=2592,
                                       window=2048)),
    (1, 1024, 128, 192, 1024, 128, 128, dict(q_start=0, kv_len=1024)),
    (4, 1, 16, 64, 1056, 16, 64, dict(q_start=0, kv_len=517,
                                      causal=False)),
], ids=str)
def test_chip_smoke_bounds_are_unchanged(smoke, shape):
    B, Sq, H, D, Skv, KV, Dv, kw = shape
    with FakeTensorMode():
        q = torch.empty(B, Sq, H, D, dtype=torch.bfloat16)
        k = torch.empty(B, Skv, KV, D, dtype=torch.bfloat16)
        v = torch.empty(B, Skv, KV, Dv, dtype=torch.bfloat16)
    assert smoke.fa_bound(q, k, v, kw) == _old_fa_bound(q, k, v, kw)
    for (B, T, H, N, esz) in ((1, 1, 64, 64, 2), (1, 1024, 64, 64, 2),
                              (4, 1, 64, 64, 2)):
        assert smoke.wkv6_bound(B, T, H, N, esz) == (
            (esz * (5 * B * T * H * N + H * N) + 2 * 4 * B * H * N * N)
            / 3.35e12 * 1e3, B * H * T * (5 * N * N + 5 * N) / 67e12 * 1e3)
    for (B, T, Dm, esz) in ((1, 1, 2560, 2), (1, 2560, 2560, 2)):
        assert smoke.rglru_bound(B, T, Dm, esz) == (
            ((4 + 2 * esz) * B * T * Dm + 2 * 4 * B * Dm) / 3.35e12 * 1e3,
            10 * B * T * Dm / 67e12 * 1e3)
    with FakeTensorMode():
        q = torch.empty(8, 256, 32, 64, dtype=torch.bfloat16)
        k = torch.empty(8, 256, 8, 64, dtype=torch.bfloat16)
    S = 256
    assert smoke.bwd_bound(q, k, k) == (
        2 * (4 * q.numel() + 4 * k.numel()) / 3.35e12 * 1e3,
        5 * 2 * 8 * 32 * 64 * (S * (S + 1) // 2) / 989e12 * 1e3)
    # non-causal with Sq != Skv: every (query, key) pair live
    with FakeTensorMode():
        q = torch.empty(8, 256, 16, 64, dtype=torch.bfloat16)
        k = torch.empty(8, 384, 16, 64, dtype=torch.bfloat16)
    assert smoke.bwd_bound(q, k, k, causal=False) == (
        2 * (4 * q.numel() + 4 * k.numel()) / 3.35e12 * 1e3,
        5 * 2 * 8 * 16 * 64 * (256 * 384) / 989e12 * 1e3)


def _rand(*shape, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed + sum(shape))
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _fake(*ts):
    mode = FakeTensorMode()
    return mode, [None if t is None else mode.from_tensor(t) for t in ts]


def _flops(op, *args):
    return flop_registry[op](*args, out_val=None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("name,Sq,Skv,kw", [
    ("flash_prefill", 40, 40, dict(q_start=0, kv_len=40)),
    ("flash_attention", 40, 40, dict(q_start=0, kv_len=40, window=9)),
    ("flash_attention", 6, 30, dict(q_start=0, kv_len=21, causal=False)),
])
def test_forward_ops_shapes_and_flops(name, Sq, Skv, kw, dtype):
    q, k, v = (_rand(2, Sq, 4, 64, dtype=dtype),
               _rand(2, Skv, 2, 64, dtype=dtype, seed=1),
               _rand(2, Skv, 2, 64, dtype=dtype, seed=2))
    causal, window = kw.get("causal", True), kw.get("window")
    want = FO._flash_torch(q, k, v, causal=causal, window=window,
                           q_start=kw["q_start"], kv_len=kw["kv_len"],
                           softmax_scale=None, kv_chunk=16)
    op = getattr(ops, name)
    args = (causal, window, kw["q_start"], kw["kv_len"], 0.125)
    mode, (fq, fk, fv) = _fake(q, k, v)
    with mode:
        got = op(fq, fk, fv, *args)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    flops, nbytes = costs.flash_cost(2, Sq, 4, 64, Skv, 2, 64,
                                     q.element_size(), q_start=kw["q_start"],
                                     kv_len=kw["kv_len"], causal=causal,
                                     window=window)
    assert _flops(op, q, k, v, *args) == flops
    key, cost = costs.KERNEL_OPS[op]
    assert key == name and cost(q, k, v, *args) == (
        flops, nbytes, "tensor" if dtype == torch.bfloat16 else "cuda_core")


@pytest.mark.parametrize("q_start,device_pos", [(37, False), (37, True)])
def test_decode_op_shapes_and_flops(q_start, device_pos):
    B, Sq, H, KV, D, Skv = 2, 1, 8, 2, 64, 80
    q, k, v = (_rand(B, Sq, H, D), _rand(B, Skv, KV, D, seed=1),
               _rand(B, Skv, KV, D, seed=2))
    pos = torch.tensor(q_start) if device_pos else q_start
    m, l, acc = FO.flash_decode_partials_torch(q, k, v, q_start=pos,
                                               kv_len=q_start + Sq)
    if device_pos:
        S, tpc = FK.capacity_splits(B, KV, Sq, H, D, Skv=Skv, causal=True,
                                    window=None)
        args = (True, None, 0, pos, Skv, None, 0.125, S, 0, tpc)
    else:
        S, t0, tpc = FK.decode_splits(B, KV, Sq, H, D, causal=True,
                                      window=None, q_start=q_start,
                                      kv_len=q_start + Sq)
        args = (True, None, q_start, None, q_start + Sq, None, 0.125, S, t0,
                tpc)
    mode, (fq, fk, fv, fpos) = _fake(q, k, v, pos if device_pos else None)
    fargs = (*args[:3], fpos, *args[4:])
    with mode:
        out, part = ops.flash_decode(fq, fk, fv, *fargs)
    assert out.shape == (B, Sq, H, D) and out.dtype == q.dtype
    part = part.view(B, KV, S, Sq, H // KV, D + 2)
    assert part[..., D].shape == m.shape and part[..., :D].shape == acc.shape
    assert part.dtype == m.dtype == l.dtype
    # a device position is counted at the whole cache, the most it reads
    qs, n = (Skv - Sq, Skv) if device_pos else (q_start, q_start + Sq)
    flops, _ = costs.flash_cost(B, Sq, H, D, Skv, KV, D, 4, q_start=qs,
                                kv_len=n)
    assert _flops(ops.flash_decode, q, k, v, *args) == flops


@pytest.mark.parametrize("name", ["flash_backward_sm90",
                                  "flash_backward_simple"])
@pytest.mark.parametrize("window", [None, 5])
def test_backward_ops_shapes_and_flops(name, window):
    B, S, H, KV, D = 2, 24, 4, 2, 64
    q, k, v = (_rand(B, S, H, D), _rand(B, S, KV, D, seed=1),
               _rand(B, S, KV, D, seed=2))
    o, do = _rand(B, S, H, D, seed=3), _rand(B, S, H, D, seed=4)
    want = FO.flash_attention_backward_torch(q, k, v, o, do, window=window)
    op = getattr(ops, name)
    mode, fts = _fake(q, k, v, o, do)
    with mode:
        got = op(*fts, 0.125, window)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]
    flops, nbytes = costs.flash_backward_cost(B, S, H, KV, D, 4,
                                              window=window)
    live, _ = costs.attention_pairs(S, q_start=0, kv_len=S, causal=True,
                                    window=window)
    assert flops == 5 * 2 * B * H * D * live
    assert live == (S * (S + 1) // 2 if window is None
                    else sum(min(p + 1, window) for p in range(S)))
    assert _flops(op, q, k, v, o, do, 0.125, window) == flops
    assert costs.KERNEL_OPS[op][0] == "flash_backward"
    assert costs.KERNEL_OPS[op][1](q, k, v, o, do, 0.125, window) == (
        flops, nbytes, "cuda_core")


@pytest.mark.parametrize("name", ["flash_backward_sm90",
                                  "flash_backward_simple"])
@pytest.mark.parametrize("form", [(17, 40, 64, 64, False),
                                  (40, 17, 64, 64, False),
                                  (24, 24, 192, 128, True)], ids=str)
def test_backward_ops_new_forms_shapes_and_flops(name, form):
    # non-causal with Sq != Skv, and MLA's (192, 128): the op's shapes are
    # the plain version's, its cost flash_backward_cost's with Skv, Dv and
    # the mask
    Sq, Skv, D, Dv, causal = form
    B, H, KV = 2, 4, 2
    q, k, v = (_rand(B, Sq, H, D), _rand(B, Skv, KV, D, seed=1),
               _rand(B, Skv, KV, Dv, seed=2))
    o, do = _rand(B, Sq, H, Dv, seed=3), _rand(B, Sq, H, Dv, seed=4)
    want = FO.flash_attention_backward_torch(q, k, v, o, do, causal=causal)
    op = getattr(ops, name)
    mode, fts = _fake(q, k, v, o, do)
    with mode:
        got = op(*fts, 0.125, None, causal)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]
    cost = costs.flash_backward_cost(B, Sq, H, KV, D, 4, Skv=Skv, Dv=Dv,
                                     causal=causal)
    assert _flops(op, q, k, v, o, do, 0.125, None, causal) == cost[0]
    assert costs.KERNEL_OPS[op][1](q, k, v, o, do, 0.125, None, causal) == (
        *cost, "cuda_core")


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_op_shapes_and_flops(with_state):
    B, T, H, N = 1, 5, 2, 16
    r, k, v, w = (_rand(B, T, H, N, seed=i) for i in range(4))
    w = -torch.exp(w)
    u = _rand(H, N, seed=5)
    s0 = _rand(B, H, N, N, seed=6) if with_state else None
    want, want_s = wkv6_ref(r, k, v, w, u, s0)
    sT = torch.empty(B, H, N, N)
    mode, fts = _fake(r, k, v, w, u, s0, sT)
    with mode:
        got = ops.wkv6(*fts)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert (sT.shape, sT.dtype) == (want_s.shape, want_s.dtype)
    assert _flops(ops.wkv6, r, k, v, w, u, s0, sT) == costs.wkv6_cost(
        B, T, H, N, 4, initial_state=with_state)[0]
    assert costs.KERNEL_OPS[ops.wkv6][1](r, k, v, w, u, s0, sT)[2] \
        == "cuda_core"


@pytest.mark.parametrize("route", ["step", "staged", "backward"])
def test_rglru_ops_shapes_and_flops(route):
    B, T, Dm = 2, 12, 24
    la = -torch.exp(_rand(B, T, Dm))
    gx = _rand(B, T, Dm, dtype=torch.bfloat16, seed=1)
    h0 = _rand(B, Dm, seed=2)
    if route == "backward":
        dh = _rand(B, T, Dm, dtype=torch.bfloat16, seed=3)
        want = rglru_backward_torch(la, gx, h0, dh)
        mode, fts = _fake(la, gx, h0, dh)
        with mode:
            got = ops.rglru_backward(*fts, None)
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                     for t in want]
        flops, nbytes = costs.rglru_backward_cost(B, T, Dm, 2, h0=True)
        assert nbytes == 14 * B * T * Dm + 2 * 4 * B * Dm
        assert _flops(ops.rglru_backward, la, gx, h0, dh, None) == flops
        assert costs.KERNEL_OPS[ops.rglru_backward][0] == "rglru_backward"
        assert costs.KERNEL_OPS[ops.rglru_backward][1](
            la, gx, h0, dh, None) == (flops, nbytes, "cuda_core")
        return
    want, want_h = rglru_ref(la, gx, h0)
    op = getattr(ops, f"rglru_{route}")
    hT = torch.empty(B, Dm)
    mode, fts = _fake(la, gx, h0, hT)
    with mode:
        got = op(*fts)
    assert (got.shape, got.dtype) == (want.shape, want.dtype)
    assert (hT.shape, hT.dtype) == (want_h.shape, want_h.dtype)
    assert _flops(op, la, gx, h0, hT) == costs.rglru_cost(B, T, Dm, 2)[0]
    assert costs.KERNEL_OPS[op][0] == "rglru"


def test_wrappers_still_refuse_cpu_tensors():
    q = torch.zeros(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        FK.flash_attention_cuda(q, q, q, causal=True, window=None,
                                q_start=0, kv_len=4)
    r = torch.zeros(1, 2, 1, 16)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        WK.wkv6_cuda(r, r, r, r, torch.zeros(1, 16))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        RK.rglru_cuda(torch.zeros(1, 2, 8), torch.zeros(1, 2, 8))


# ------------------------------------------------------- whole cells

REPRO_KEYS = {
    "top": {"arch", "shape", "mesh", "label", "kind", "applicable",
            "n_chips", "lower_s", "compile_s", "cost_analysis",
            "memory_analysis", "collectives", "roofline"},
    "cost_analysis": {"flops", "bytes accessed"},
    "memory_analysis": {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes", "peak_memory_in_bytes"},
    "collectives": {"bytes_by_type", "count_by_type", "total_bytes"},
    "roofline": {"t_compute_s", "t_memory_s", "t_collective_s", "dominant",
                 "model_flops_global", "model_flops_per_chip",
                 "useful_flops_ratio", "min_bytes_per_chip",
                 "useful_bytes_ratio", "t_useful_compute_s",
                 "t_min_memory_s", "roofline_fraction"},
}


@pytest.fixture(scope="module")
def cli_cells(tmp_path_factory):
    """llama3.2-1b's decode_32k and train_4k on the single pod at full
    width, on the CPU, through the CLI in one process: (records, stdout,
    peak RSS in bytes)."""
    out = tmp_path_factory.mktemp("dryrun")
    with open(out / "stdout", "w") as so, open(out / "stderr", "w") as se:
        p = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "llama3.2-1b", "--shape", "decode_32k", "--shape", "train_4k",
             "--mesh", "single", "--device", "cpu", "--out", str(out)],
            env=_env(), stdout=so, stderr=se)
        try:
            rc = p.wait(timeout=300)
        finally:
            if p.returncode is None:
                p.kill()
                p.wait()
    assert rc == 0, (out / "stderr").read_text()[-4000:]
    stdout = (out / "stdout").read_text()
    recs = {s: json.loads((out / f"llama3.2-1b__{s}__pod16x16__baseline"
                                  f".json").read_text())
            for s in ("decode_32k", "train_4k")}
    return recs, stdout, recs["train_4k"]["host_peak_rss_bytes"]


def _shard_bytes(tree) -> int:
    """Rank 0's bytes of every abstract leaf: each mesh dimension that
    shards a tensor dimension keeps the first ceil(n / size) of it."""
    from repro_torch.models.params import is_abstract, tree_leaves
    total = 0
    for leaf in tree_leaves(tree, is_leaf=is_abstract):
        if leaf.sharding is None:
            continue
        shape = list(leaf.shape)
        mesh = leaf.sharding.mesh
        for j, p in enumerate(leaf.sharding.placements):
            if hasattr(p, "dim"):
                shape[p.dim] = -(-shape[p.dim] // mesh.shape[j])
        total += math.prod(shape) * torch.empty(
            (), dtype=leaf.dtype).element_size()
    return total


def _specs(shape_name):
    from repro_torch.launch.mesh import production_shape, rules_for_mesh
    from repro_torch.launch.steps import (
        make_optimizer,
        serve_input_specs,
        train_input_specs,
    )
    from repro_torch.models.zoo import build_model
    mesh = production_shape()
    rules = rules_for_mesh(mesh)
    model = build_model(configs.get("llama3.2-1b"))
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(model, make_optimizer(model.cfg), shape,
                                 mesh, rules)
    return serve_input_specs(model, shape, mesh, rules, kind="decode")


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_cell_records_have_repros_keys(cli_cells, shape):
    rec = cli_cells[0][shape]
    assert REPRO_KEYS["top"] <= set(rec)
    for k in ("cost_analysis", "memory_analysis", "collectives",
              "roofline"):
        assert REPRO_KEYS[k] <= set(rec[k]), k
    assert rec["applicable"] and rec["n_chips"] == 256
    assert rec["device"] == "cpu"
    assert set(D._COLLECTIVES) <= set(rec["collectives"]["bytes_by_type"])
    for v in rec["cost_analysis"].values():
        assert v > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] == _shard_bytes(_specs(shape))
    assert mem["peak_memory_in_bytes"] >= mem["argument_size_in_bytes"] \
        + mem["output_size_in_bytes"]
    if shape == "decode_32k":
        assert rec["position"] == SHAPES[shape].seq_len - 1


def test_train_cell_moves_collective_bytes(cli_cells):
    rec = cli_cells[0]["train_4k"]
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["collectives"]["count_by_type"]["reduce-scatter"] > 0


def test_cli_prints_its_lines_and_stays_small(cli_cells):
    _, stdout, rss = cli_cells
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[dryrun]")]
    assert len(lines) == 3 and lines[-1] == "[dryrun] all cells OK"
    assert "decode_32k" in lines[0] and "pod16x16" in lines[0]
    assert 0 < rss < 2 << 30, rss


_MOCKED = """
import tempfile, torch
from repro_torch.kernels import _grad
from repro_torch.kernels.flash_attention import kernel as FK
# the card mocked: the wrappers route fake CPU tensors to the kernels' ops
_grad.on_card = lambda t: True
torch.Tensor.is_cuda = property(lambda t: True)
torch.cuda.current_device = lambda: None
# the backward's head dims without MLA's (192, 128)
FK.BACKWARD_HEAD_DIMS = tuple(d for d in FK.BACKWARD_HEAD_DIMS
                              if d != (192, 128))
from repro_torch.launch.dryrun import run_cell
rec = run_cell("deepseek-v3-671b", "train_4k", False, tempfile.mkdtemp(),
               device="cpu")
print(rec["applicable"], "|", rec["skip_reason"])
"""


def test_train_cell_without_a_backward_kernel_is_skipped():
    # Kept by design now that every config trains on the card: it holds
    # NoBackward's path, deepseek-v3-671b's train_4k with the backward's
    # head dims patched to lack its MLA's (192, 128), written not
    # applicable with the error's text
    out = _run(_MOCKED, timeout=240).strip().splitlines()[-1]
    ok, why = out.split(" | ")
    assert ok == "False"
    assert "flash backward" in why and "(192, 128)" in why


_MOCKED_GRIFFIN = """
import tempfile, torch
from repro_torch.kernels import _grad
# the card mocked: the wrappers route fake CPU tensors to the kernels' ops,
# whose fake implementations give the shapes (nothing launches)
_grad.on_card = lambda t: True
torch.Tensor.is_cuda = property(lambda t: True)
torch.cuda.current_device = lambda: None
from repro_torch.launch.dryrun import run_cell
rec = run_cell("recurrentgemma-2b", "train_4k", False, tempfile.mkdtemp(),
               device="cpu")
print(rec["applicable"], "|", sorted(rec["launches"].items()), "|",
      sorted((k, v["launches"]) for k, v in rec["kernels"].items()))
"""


def test_griffin_train_cell_is_applicable_on_a_mocked_card():
    out = _run(_MOCKED_GRIFFIN, timeout=240).strip().splitlines()[-1]
    ok, launches, kernels = out.split(" | ")
    assert ok == "True"
    # a device's step under remat "block": 8 groups (rec, rec, attn) run
    # their forward twice, the tail's 2 rec blocks once; one backward a
    # layer; AdamW's norm and update one launch each over the local shards
    assert launches == str(sorted({"flash_prefill": 16, "flash_backward": 8,
                                   "rglru": 34, "rglru_backward": 18,
                                   **OPTIM}.items()))
    assert kernels == str(sorted({"flash_prefill": 16,
                                  "flash_backward_sm90": 8,
                                  "rglru_staged": 34,
                                  "rglru_backward": 18, **OPTIM}.items()))


#: an AdamW step's optimizer kernels: the squared sums and the clip with
#: the update, one launch each (``kernels/optim``)
OPTIM = {"sumsq": 1, "adamw_update": 1}
_MOCKED_RWKV6 = _MOCKED_GRIFFIN.replace('"recurrentgemma-2b"', '"rwkv6-7b"')
_MOCKED_STARCODER2 = _MOCKED_GRIFFIN.replace('"recurrentgemma-2b"',
                                             '"starcoder2-7b"')


def test_starcoder2_train_cell_is_applicable_on_a_mocked_card():
    # (128, 128) on the tensor-core backward: a device's step under remat
    # "block" runs each of the 32 layers' forward twice, its backward once
    out = _run(_MOCKED_STARCODER2, timeout=240).strip().splitlines()[-1]
    ok, launches, kernels = out.split(" | ")
    assert ok == "True"
    assert launches == str(sorted({"flash_prefill": 64,
                                   "flash_backward": 32, **OPTIM}.items()))
    assert kernels == str(sorted({"flash_prefill": 64,
                                  "flash_backward_sm90": 32,
                                  **OPTIM}.items()))


_MOCKED_SEAMLESS = _MOCKED_GRIFFIN.replace('"recurrentgemma-2b"',
                                          '"seamless-m4t-medium"')


def test_seamless_train_cell_is_applicable_on_a_mocked_card():
    # the encoder's non-causal self-attention and the decoder's
    # cross-attention take the tensor-core backward: a device's step under
    # remat "block" runs each of the 12 encoder layers' attention forward
    # twice and each of the 12 decoder layers' two (self, cross) twice,
    # each backward once, as chip_smoke.py's train_launches counts
    sys.path.insert(0, str(ROOT))
    from chip_smoke import train_launches
    want = train_launches(configs.get("seamless-m4t-medium"))
    assert want == {"flash_prefill": 72, "flash_backward": 36, **OPTIM}
    out = _run(_MOCKED_SEAMLESS, timeout=240).strip().splitlines()[-1]
    ok, launches, kernels = out.split(" | ")
    assert ok == "True"
    assert launches == str(sorted(want.items()))
    assert kernels == str(sorted({"flash_prefill": 72,
                                  "flash_backward_sm90": 36,
                                  **OPTIM}.items()))


def test_rwkv6_train_cell_is_applicable_on_a_mocked_card():
    out = _run(_MOCKED_RWKV6, timeout=240).strip().splitlines()[-1]
    ok, launches, kernels = out.split(" | ")
    assert ok == "True"
    # a device's step under remat "block": 32 layers run their WKV-6
    # forward twice, its backward once
    want = str(sorted({"wkv6": 64, "wkv6_backward": 32, **OPTIM}.items()))
    assert launches == want and kernels == want


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_backward_op_shapes_and_flops(with_state):
    B, T, H, N = 2, 11, 2, 16
    r, k, v, do = (_rand(B, T, H, N, seed=i) for i in range(4))
    w = torch.exp(-torch.exp(_rand(B, T, H, N, seed=4)))
    u = _rand(H, N, seed=5)
    s0 = _rand(B, H, N, N, seed=6) if with_state else None
    dsT = _rand(B, H, N, N, seed=7) if with_state else None
    want = wkv6_backward_torch(r, k, v, w, u, s0, do, dsT)
    mode, fts = _fake(r, k, v, w, u, s0, do, dsT)
    with mode:
        got = ops.wkv6_backward(*fts)
    # the op returns a ds0 whether s0 is given or not (the kernel writes
    # it; the wrapper drops it without s0)
    want = want[:5] + (torch.empty(B, H, N, N),)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in want]
    flops, nbytes = costs.wkv6_backward_cost(B, T, H, N, 4, s0=with_state,
                                             dsT=with_state)
    # ds0 counted only with s0: without it the function has no ds0
    assert nbytes == 4 * (9 * B * T * H * N + 2 * H * N) + (
        3 if with_state else 0) * 4 * B * H * N * N
    assert _flops(ops.wkv6_backward, r, k, v, w, u, s0, do, dsT) == flops
    assert costs.KERNEL_OPS[ops.wkv6_backward][0] == "wkv6_backward"
    assert costs.KERNEL_OPS[ops.wkv6_backward][1](
        r, k, v, w, u, s0, do, dsT) == (flops, nbytes, "cuda_core")
