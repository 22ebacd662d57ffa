"""The port's expert-parallel MoE (``models/moe_ep.py``) and
``compressed_psum`` against ``repro``'s, on the CPU.

  * at a mesh of one rank (a gloo process group of one in this process,
    and ``repro``'s ``(1, 1)`` mesh of the one CPU device) the port's
    ``moe_apply_ep`` is held to ``repro``'s ``moe_apply_ep`` (f32, 1e-5),
    and is bit-equal to the port's scatter form (``layers.moe_apply``),
    whose ops it runs in the same order, as is a train step of smoke
    ``granite-moe-3b-a800m`` with ``moe_impl="ep_shardmap"`` to the
    unsharded step;
  * at a ``(2, 2)`` mesh, four gloo ranks (``tests/
    torch_parallel_worker.py``) run the port's ``moe_apply_ep`` and
    ``compressed_psum`` over the ``data`` dimension, and one JAX process
    with four host devices (``--xla_force_host_platform_device_count=4``)
    runs ``repro``'s ``moe_apply_ep`` at its ``(2, 2)`` mesh and
    ``compressed_psum`` over a 2-device axis, on the same inputs: the
    outputs and the balance loss within 1e-5 (sums in another order), the
    int8 sums bit-equal.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.launch.mesh import rules_for_mesh as jrules_for_mesh  # noqa: E402
from repro.models.moe_ep import moe_apply_ep as jmoe_apply_ep  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    init_single_process,
    make_host_mesh,
    rules_for_mesh,
)
from repro_torch.launch.steps import (  # noqa: E402
    make_optimizer,
    make_train_step,
)
from repro_torch.models.layers import moe_apply, moe_defs  # noqa: E402
from repro_torch.models.moe_ep import moe_apply_ep  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    distribute_params,
    tree_leaves,
)
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.parallel.sharding import sharded  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "granite-moe-3b-a800m"
KEYS = ("router", "wi_gate", "wi_up", "wo")


def _inputs(seed: int = 0, B: int = 4, S: int = 16) -> dict:
    """f32 inputs of one MoE layer of the smoke config, and two gradient
    shards for ``compressed_psum``."""
    cfg = configs.smoke(ARCH)
    rng = np.random.default_rng(seed)
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"x": f(B, S, D), "router": f(D, E), "wi_gate": f(E, D, F) / 8,
            "wi_up": f(E, D, F) / 8, "wo": f(E, F, D) / 8,
            "g0": f(300) * 3, "g1": f(300)}


@pytest.fixture(scope="module")
def world1():
    init_single_process("cpu")
    mesh = make_host_mesh(1, 1, device="cpu")
    yield mesh, rules_for_mesh(mesh)
    torch.distributed.destroy_process_group()


def _port_ep(a, rules, mesh):
    cfg = configs.smoke(ARCH)
    defs = moe_defs(cfg)
    p = distribute_params({k: torch.from_numpy(a[k]) for k in KEYS},
                          {k: defs[k] for k in KEYS}, rules, mesh)
    with sharded(rules):
        y, aux = moe_apply_ep(p, torch.from_numpy(a["x"]), cfg, rules)
    return y.full_tensor(), aux.full_tensor()


def test_ep_matches_repro_at_one_rank(world1):
    mesh, rules = world1
    a = _inputs()
    y, aux = _port_ep(a, rules, mesh)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jy, jaux = jmoe_apply_ep({k: jnp.asarray(a[k]) for k in KEYS},
                             jnp.asarray(a["x"]), jconfigs.smoke(ARCH),
                             jrules_for_mesh(jmesh))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


def test_ep_bit_equal_to_scatter_at_one_rank(world1):
    mesh, rules = world1
    a = _inputs(1)
    y, aux = _port_ep(a, rules, mesh)
    ys, auxs = moe_apply({k: torch.from_numpy(a[k]) for k in KEYS},
                         torch.from_numpy(a["x"]), configs.smoke(ARCH))
    assert torch.equal(y, ys)
    assert torch.equal(aux, auxs)


def test_ep_train_step_bit_equal_at_one_rank(world1):
    mesh, rules = world1
    cfg = dataclasses.replace(configs.smoke(ARCH), moe_impl="ep_shardmap")
    model = build_model(cfg)
    params = W._params(model)
    batch = W._batch(cfg)
    opt = make_optimizer(cfg)
    ref = W._clone(params)
    ref_state, ref_m = make_train_step(model, opt, None, impl="torch")(
        {"params": ref, "opt": opt.init(ref)}, batch)
    sh = W._clone(params)
    state = {"params": distribute_params(sh, model.defs, rules, mesh),
             "opt": distribute_params(opt.init(sh), opt.state_defs(
                 model.defs), rules, mesh)}
    calls = W._local.LOCAL_CALLS["moe_ep"]
    state, m = make_train_step(model, opt, rules, impl="torch")(state, batch)
    assert W._local.LOCAL_CALLS["moe_ep"] > calls
    for k in ("loss", "grad_norm", "aux_loss"):
        assert torch.equal(m[k], ref_m[k]), k
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(ref_state["params"])):
        assert torch.equal(a.full_tensor(), b)


_JAX_CHILD = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import repro.configs as C
from repro.launch.mesh import rules_for_mesh
from repro.models.moe_ep import moe_apply_ep
from repro.optim.grad_compress import compressed_psum
a = np.load(sys.argv[1])
mesh = jax.make_mesh((2, 2), ("data", "model"))
keys = ("router", "wi_gate", "wi_up", "wo")
y, aux = jax.jit(lambda p, x: moe_apply_ep(
    p, x, C.smoke("granite-moe-3b-a800m"), rules_for_mesh(mesh)))(
        {k: jnp.asarray(a[k]) for k in keys}, jnp.asarray(a["x"]))
mesh2 = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
f = jax.shard_map(lambda g: compressed_psum(g.reshape(-1), "data")[None],
                  mesh=mesh2, in_specs=P("data"), out_specs=P("data"))
s = np.asarray(f(jnp.stack([jnp.asarray(a["g0"]), jnp.asarray(a["g1"])])))
np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux), psum=s[0],
         psum1=s[1])
"""


@pytest.fixture(scope="module")
def at_2x2(tmp_path_factory):
    """The port's and ``repro``'s outputs at ``(2, 2)``, run side by side:
    four gloo ranks and one JAX process."""
    tmp = tmp_path_factory.mktemp("moe_ep_2x2")
    inp = tmp / "in.npz"
    np.savez(inp, **_inputs(2))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CHILD, str(inp), str(tmp / "jax.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = W.launch(2, 2, tmp, "moe", inp)
        _, err = jax_proc.communicate(timeout=180)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0, err[-3000:]
    return np.load(port), np.load(tmp / "jax.npz")


def test_ep_matches_repro_at_2x2(at_2x2):
    port, ref = at_2x2
    np.testing.assert_allclose(port["y"], ref["y"], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(port["aux"], ref["aux"], rtol=1e-5)


def test_compressed_psum_bit_equal_to_repro(at_2x2):
    port, ref = at_2x2
    assert np.array_equal(ref["psum"], ref["psum1"])
    assert port["psum"].dtype == ref["psum"].dtype
    assert np.array_equal(port["psum"], ref["psum"])


def test_compressed_psum_one_rank_is_quantize_dequantize(world1):
    from repro_torch.optim.grad_compress import (
        compressed_psum,
        dequantize,
        quantize,
    )
    mesh, _ = world1
    g = torch.from_numpy(_inputs(3)["g0"]).to(torch.bfloat16)
    want = dequantize(*quantize(g)).to(torch.bfloat16)
    for group in ((mesh, "data"), mesh["model"], None):
        assert torch.equal(compressed_psum(g, group), want)
