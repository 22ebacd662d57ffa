"""``repro_torch`` stands alone: no JAX, no networkx, nothing of ``repro``.

A subprocess with ``jax`` and ``networkx`` made unimportable imports the
port, plans a cell and executes it on the CPU, then builds the smoke
``llama3.2-1b`` and serves one request through the decode-arena server on
the CPU; a scan of the port's sources and of ``chip_smoke.py`` finds no
import of ``jax`` or of ``repro``.
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
    assert not roots & {"jax", "jaxlib", "repro", "networkx"}, roots
