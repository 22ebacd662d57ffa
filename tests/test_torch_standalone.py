"""``repro_torch`` stands alone: no JAX, no networkx, nothing of ``repro``.

A subprocess with ``jax`` and ``networkx`` made unimportable imports the
port, plans a cell and executes it on the CPU, then builds the smoke
``llama3.2-1b`` and serves one request through the decode-arena server on
the CPU; another, with ``jax`` and ``ml_dtypes`` made unimportable, imports
the training modules (``repro_torch.optim``, ``data``, ``checkpoint``,
``launch.train``), round-trips a bf16 checkpoint and takes a train step of
the smoke ``llama3.2-1b`` on the CPU; a scan of the port's sources and of
``chip_smoke.py`` finds no import of ``jax``, ``ml_dtypes`` or ``repro``.
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
