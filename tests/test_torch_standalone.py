"""``repro_torch`` stands alone: no JAX, no networkx, nothing of ``repro``.

A subprocess with ``jax`` and ``networkx`` made unimportable imports the
port, plans a cell and executes it on the CPU, then builds the smoke
``llama3.2-1b`` and serves one request through the decode-arena server on
the CPU, and the smoke ``seamless-m4t-medium`` (encoder-decoder) and
``deepseek-v3-671b`` (MLA, MTP) one request each, and serves an open-loop
workload on the sharded fleet (``runtime.fleet``, ``runtime.loadgen``,
``launch.serve.run_fleet``); another, with ``jax`` and ``ml_dtypes`` made
unimportable, imports the training modules (``repro_torch.optim``,
``data``, ``checkpoint``, ``launch.train``), round-trips a bf16 checkpoint
and takes a train step of the smoke ``llama3.2-1b`` on the CPU (under its
default ``remat="block"``); a third, with ``jax`` and ``ml_dtypes``
unimportable, imports the parallel modules (``repro_torch.parallel``,
``launch.mesh``, ``models.moe_ep``) and takes a sharded train step of two
smoke families at a mesh of one rank; a fourth imports the dry-run
(``launch.dryrun``) and counts a DTensor product over a fake group of 4;
a scan of the port's sources and of ``chip_smoke.py`` finds no import of
``jax``, ``ml_dtypes`` or ``repro``.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs in parallel workers, and torch's
# OpenMP pool on 150k-element ops would take the cores from the others
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["networkx"] = None
import repro_torch as rt
from repro_torch.graphs import randwire_graph
p = rt.plan(randwire_graph(seed=100), rt.PlanConfig())
res = rt.execute(p.graph, None, p.arena, order=p.order, fuse=True,
                 device="cpu")
assert res.realized_matches_plan
import torch
from repro_torch.core import fx_bridge, ilp_oracle, traffic
from repro_torch.graphs.programs import nas_like
f = fx_bridge.compile_scheduled(nas_like, device="cpu")
y = f(torch.linspace(-1, 1, 16 * 32).reshape(16, 32))
assert f.report.realized_matches_plan and torch.isfinite(y)
assert traffic.simulate_traffic(p.graph, p.order, p.peak_bytes,
                                include_weights=False).total_bytes == 0
assert ilp_oracle.oracle_frontier(randwire_graph(n=6, seed=1),
                                  max_width=2)
import repro_torch.configs as configs
from repro_torch.launch.serve import run_server, synth_requests
from repro_torch.models import build_model
model = build_model(configs.smoke("llama3.2-1b"))
params = model.init(torch.Generator().manual_seed(0), "cpu")
reqs = synth_requests(1, 6, 3, model.cfg.vocab_size)
m = run_server(model, params, reqs, smax=9, budget_bytes=10**6,
               device="cpu")
assert m["n_served"] == 1 and len(reqs[0].tokens) == 3, m
for arch in ("seamless-m4t-medium", "deepseek-v3-671b"):
    model = build_model(configs.smoke(arch))
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    reqs = synth_requests(1, 6, 3, model.cfg.vocab_size)
    m = run_server(model, params, reqs, smax=9, budget_bytes=10**6,
                   device="cpu")
    assert m["n_served"] == 1 and len(reqs[0].tokens) == 3, (arch, m)
from repro_torch.launch.serve import run_fleet
from repro_torch.runtime.fleet import Fleet
from repro_torch.runtime.loadgen import OpenLoopLoadGen
fm = run_fleet(build_model(configs.smoke("llama3.2-1b")),
               OpenLoopLoadGen(0, rate=2.0).arrivals(16),
               buckets=(64, 128, 512))
assert fm["n_lost"] == 0 and fm["n_served"] + fm["n_rejected"] == 16, fm
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "networkx", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok", p.peak_bytes)
"""


def test_imports_plans_and_executes_without_jax_or_networkx():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", "1277952"]


_TRAIN_CHILD = """
import sys, tempfile
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import torch
import repro_torch.checkpoint as ckpt
import repro_torch.configs as configs
import repro_torch.data
import repro_torch.optim
from repro_torch.launch import train
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import build_model
d = tempfile.mkdtemp()
st = {"w": torch.arange(5, dtype=torch.bfloat16), "s": torch.tensor(3)}
ckpt.save(d, 1, st)
back = ckpt.restore(d, 1, {"w": torch.zeros(5, dtype=torch.bfloat16),
                           "s": torch.tensor(0)})
assert torch.equal(back["w"], st["w"]) and int(back["s"]) == 3
model = build_model(configs.smoke("llama3.2-1b"))
opt = make_optimizer(model.cfg)
params = model.init(torch.Generator().manual_seed(0), "cpu")
state = {"params": params, "opt": opt.init(params)}
pipe = repro_torch.data.DataPipeline(cfg=model.cfg, seq_len=8,
                                     global_batch=2)
batch = {"tokens": torch.from_numpy(pipe.batch_at(0)["tokens"])}
state, m = make_train_step(model, opt, warmup=1)(state, batch)
assert torch.isfinite(m["loss"]) and int(state["opt"]["step"]) == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_trains_and_checkpoints_without_jax_or_ml_dtypes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _TRAIN_CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


_PARALLEL_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import torch
import repro_torch.configs as configs
import repro_torch.parallel
from repro_torch.launch import mesh as M
from repro_torch.launch.steps import make_optimizer, make_train_step
from repro_torch.models import build_model, moe_ep
from repro_torch.models.params import distribute_params, tree_leaves
M.init_single_process("cpu")
mesh = M.make_host_mesh(1, 1, device="cpu")
rules = M.rules_for_mesh(mesh)
for arch in ("llama3.2-1b", "granite-moe-3b-a800m"):
    model = build_model(configs.smoke(arch))
    opt = make_optimizer(model.cfg)
    p = model.init(torch.Generator().manual_seed(0), "cpu")
    state = {"params": distribute_params(p, model.defs, rules, mesh),
             "opt": distribute_params(opt.init(p), opt.state_defs(
                 model.defs), rules, mesh)}
    batch = {"tokens": torch.randint(0, 512, (2, 8),
                                     generator=torch.Generator())}
    state, m = make_train_step(model, opt, rules, warmup=1)(state, batch)
    assert torch.isfinite(m["loss"]) and int(state["opt"]["step"]) == 1
torch.distributed.destroy_process_group()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_parallel_modules_run_without_jax():
    """``repro_torch.parallel``, ``launch.mesh`` and ``models.moe_ep``
    import with JAX absent, and a sharded train step runs at a mesh of one
    rank (gloo, in process)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _PARALLEL_CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


_DRYRUN_CHILD = """
import sys
sys.modules["jax"] = None
sys.modules["ml_dtypes"] = None
import torch
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Shard
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import production_shape
with dryrun.fake_world(4):
    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("data",))
    x = DTensor.from_local(torch.ones(2, 8), mesh, [Shard(0)],
                           run_check=False, shape=torch.Size([8, 8]),
                           stride=(8, 1))
    with dryrun.CostMode() as m:
        x @ x.T
assert m.flops["cuda_core"] == 2 * 2 * 8 * 8 and m.collectives()[
    "bytes_by_type"]["all-gather"] == 8 * 8 * 4, (m.flops, m.collectives())
cfg = dryrun.configs.get("llama3.2-1b")
assert dryrun.min_bytes_estimate(cfg, dryrun.SHAPES["train_4k"],
                                 production_shape().size()) > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok")
"""


def test_dryrun_runs_without_jax():
    """``repro_torch.launch.dryrun`` imports with JAX absent, and its
    counting mode counts a DTensor product over a fake group of 4."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", _DRYRUN_CHILD], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "ml_dtypes", "repro",
                        "networkx"}, roots
