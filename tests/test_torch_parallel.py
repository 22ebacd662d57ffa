"""The port's parallelism against ``repro``'s, on the CPU.

Specs (nothing allocated):

  * ``param_pspecs`` of every ``ParamDef`` tree of the ten full configs --
    ``model.defs``, ``opt.state_defs(defs)`` and ``make_cache_defs(1,
    1024)`` -- equal to ``repro``'s, leaf by leaf as tuples, on meshes of
    names and sizes ``(16, 16)``, ``(2, 16, 16)`` and ``(2, 2, 2)``; so do
    ``act_spec`` of every kind string ``repro`` uses and
    ``rules_for_mesh``;
  * ``abstract_params`` and the six ``*_specs`` functions of
    ``launch/steps.py`` of the ten full configs give ``repro``'s shapes,
    dtypes and specs at a real ``(1, 1)`` mesh (a gloo process group of one
    rank in this process, and ``repro``'s mesh of the one CPU device).

At that one-rank mesh (the card's check, ``chip_smoke.py``'s ``parallel``
phase, on the CPU): a sharded train step of smoke ``llama3.2-1b`` is
bit-equal to the unsharded one, ``distribute_params`` keeps the leaves'
storage, served tokens equal the unsharded server's, and every kernel
wrapper given DTensors goes through ``local_map`` and hands its ctypes
entry plain tensors with a storage (the card mocked, as in
``test_torch_train.py``: the wrappers' device test answers "on the card"
and each ctypes entry is a recorder that runs the plain version).

On a gloo ``(2, 2)`` host mesh of four processes
(``tests/torch_parallel_worker.py``, which records the readings): sharded
train steps of seven smoke families against the unsharded port (loss and
``grad_norm`` within rtol 1e-5, every gradient, updated parameter and
optimizer leaf within 1e-4 of the leaf's largest magnitude), a swapped
KV-head slice read above those limits, and served tokens equal to the
unsharded server's in serial and vmap mode.  ``test_torch_parallel_seq.py``
holds the same at ``(1, 4)``, where the KV heads stay whole and the cache's
sequence is sharded.
"""

import dataclasses
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.launch.steps as jsteps  # noqa: E402
from repro.launch.mesh import rules_for_mesh as jrules_for_mesh  # noqa: E402
from repro.models.params import param_pspecs as jparam_pspecs  # noqa: E402
from repro.models.zoo import build_model as jbuild_model  # noqa: E402
from repro.parallel.sharding import act_spec as jact_spec  # noqa: E402

import repro_torch.configs as configs  # noqa: E402
import repro_torch.launch.steps as steps  # noqa: E402
from repro_torch.configs.base import SHAPES  # noqa: E402
from repro_torch.kernels import _grad, _local  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshShape,
    init_single_process,
    make_host_mesh,
    make_production_mesh,
    rules_for_mesh,
)
from repro_torch.launch.serve import run_server, synth_requests  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    distribute_params,
    is_abstract,
    is_spec,
    param_pspecs,
    tree_leaves,
)
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.parallel.sharding import P, act_spec, placements  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_worker as W  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = configs.ARCH_NAMES
MESHES = {
    "16x16": (("data", "model"), (16, 16)),
    "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
    "2x2x2": (("pod", "data", "model"), (2, 2, 2)),
}
KINDS = ("bsd", "bn", "bnn", "xbn")

#: limits of a sharded step against the unsharded port (f32, 4 ranks)
LOSS_RTOL = 1e-5
LEAF_TOL = 1e-4


def _jmesh(name):
    """A stand-in for ``repro``'s mesh of names and sizes: what
    ``param_pspecs`` and ``rules_for_mesh`` read of it."""
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _tmesh(name):
    return MeshShape(*MESHES[name])


def _jtrees(arch):
    cfg = jconfigs.get(arch)
    m = jbuild_model(cfg)
    opt = jsteps.make_optimizer(cfg)
    return m.defs, opt.state_defs(m.defs), m.make_cache_defs(1, 1024)


def _ttrees(arch):
    cfg = configs.get(arch)
    m = build_model(cfg)
    opt = steps.make_optimizer(cfg)
    return m.defs, opt.state_defs(m.defs), m.make_cache_defs(1, 1024)


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


# ------------------------------------------------------------------ specs

@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_repro(arch, mesh):
    jrules = jrules_for_mesh(_jmesh(mesh))
    trules = rules_for_mesh(_tmesh(mesh))
    for jdefs, tdefs in zip(_jtrees(arch), _ttrees(arch)):
        want = [tuple(s) for s in _jleaves(
            jparam_pspecs(jdefs, jrules, _jmesh(mesh)))]
        got = tree_leaves(param_pspecs(tdefs, trules, _tmesh(mesh)),
                          is_leaf=is_spec)
        assert all(isinstance(s, P) for s in got)
        assert [tuple(s) for s in got] == want
        # and every spec is a valid placement on the mesh
        for s in got:
            placements(s, _tmesh(mesh))


@pytest.mark.parametrize("mesh", MESHES)
def test_rules_and_act_spec_equal_repro(mesh):
    jr, tr = jrules_for_mesh(_jmesh(mesh)), rules_for_mesh(_tmesh(mesh))
    for f in ("batch", "fsdp", "tensor", "expert", "sequence", "act_embed"):
        assert getattr(tr, f) == getattr(jr, f), f
    for kind in KINDS:
        assert tuple(act_spec(tr, kind)) == tuple(jact_spec(jr, kind)), kind
    over = dict(act_embed="model", sequence=None)
    jr2 = jrules_for_mesh(_jmesh(mesh), **over)
    tr2 = rules_for_mesh(_tmesh(mesh), **over)
    for kind in KINDS:
        assert tuple(act_spec(tr2, kind)) == tuple(jact_spec(jr2, kind))


def test_placements_rule():
    mesh = MeshShape(("pod", "data", "model"), (2, 1, 4))
    from torch.distributed.tensor import Replicate, Shard
    assert placements(P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Replicate(), Shard(2))          # data has one rank
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(P("model", "model"), mesh)


def test_production_mesh_needs_its_world():
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        make_production_mesh(multi_pod=True)


# --------------------------------------------------- a mesh of one rank

@pytest.fixture(scope="module")
def world1():
    init_single_process("cpu")
    mesh = make_host_mesh(1, 1, device="cpu")
    yield mesh, rules_for_mesh(mesh)
    torch.distributed.destroy_process_group()


def _same_abstract(got, want):
    gl = tree_leaves(got, is_leaf=is_abstract)
    wl = jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == tuple(w.shape)
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
        ws = getattr(w, "sharding", None)
        if ws is None:
            assert g.sharding is None
        else:
            assert tuple(g.sharding.spec) == tuple(ws.spec)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_specs_equal_repro(world1, arch):
    mesh, rules = world1
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jrules = jrules_for_mesh(jmesh)
    jm, tm = jbuild_model(jconfigs.get(arch)), build_model(configs.get(arch))
    jopt = jsteps.make_optimizer(jm.cfg)
    topt = steps.make_optimizer(tm.cfg)
    shape = SHAPES["train_4k"]
    _same_abstract(steps.train_input_specs(tm, topt, shape, mesh, rules),
                   jsteps.train_input_specs(jm, jopt, shape, jmesh, jrules))
    for kind in ("prefill", "decode"):
        sh = SHAPES[f"{kind}_32k"]
        _same_abstract(
            steps.serve_input_specs(tm, sh, mesh, rules, kind=kind),
            jsteps.serve_input_specs(jm, sh, jmesh, jrules, kind=kind))
    _same_abstract(steps.cache_specs(tm, mesh, rules, 2, 64),
                   jsteps.cache_specs(jm, jmesh, jrules, 2, 64))
    got = steps.out_shardings_for(steps.state_specs(tm, topt, mesh, rules))
    want = jsteps.out_shardings_for(
        jsteps.state_specs(jm, jopt, jmesh, jrules))
    assert [tuple(s.spec) for s in tree_leaves(
        got, is_leaf=lambda x: hasattr(x, "spec"))] == \
        [tuple(s.spec) for s in jax.tree.leaves(want)]


def test_train_step_bit_equal_at_one_rank(world1):
    mesh, rules = world1
    cfg = configs.smoke("llama3.2-1b")
    model = build_model(cfg)
    params = W._params(model)
    batch = W._batch(cfg)
    opt = steps.make_optimizer(cfg)
    ref = W._clone(params)
    ref_state = {"params": ref, "opt": opt.init(ref)}
    sh = W._clone(params)
    sp = distribute_params(sh, model.defs, rules, mesh)
    # placed in place: each DTensor's shard is its leaf's storage
    assert [p.to_local().data_ptr() for p in tree_leaves(sp)] == \
        [p.data_ptr() for p in tree_leaves(sh)]
    state = {"params": sp, "opt": distribute_params(
        opt.init(sh), opt.state_defs(model.defs), rules, mesh)}
    ref_step = steps.make_train_step(model, opt, None, impl="torch")
    step = steps.make_train_step(model, opt, rules, impl="torch")
    for _ in range(W.STEPS):
        ref_state, ref_m = ref_step(ref_state, batch)
        state, m = step(state, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(m[k], ref_m[k]), k
    for a, b in zip(tree_leaves(state), tree_leaves(ref_state)):
        assert torch.equal(a.full_tensor(), b)


def test_serving_bit_equal_at_one_rank(world1):
    mesh, rules = world1
    cfg = configs.smoke("llama3.2-1b")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    kw = dict(smax=12, budget_bytes=1 << 30, device="cpu")
    ref = synth_requests(2, 8, 4, cfg.vocab_size, 3)
    run_server(model, params, ref, **kw)
    got = synth_requests(2, 8, 4, cfg.vocab_size, 3)
    run_server(model, distribute_params(params, model.defs, rules, mesh),
               got, rules=rules, **kw)
    assert [r.tokens for r in got] == [r.tokens for r in ref]


def test_checkpoint_restores_onto_the_mesh(world1, tmp_path):
    from repro_torch.checkpoint import restore, save

    mesh, rules = world1
    model = build_model(configs.smoke("llama3.2-1b"))
    opt = steps.make_optimizer(model.cfg)
    p = W._params(model)
    state = {"params": distribute_params(p, model.defs, rules, mesh),
             "opt": distribute_params(opt.init(p), opt.state_defs(
                 model.defs), rules, mesh)}
    save(str(tmp_path), 1, state)
    plain = restore(str(tmp_path), 1, W._clone(
        {"params": W._params(model), "opt": opt.init(p)}))
    back = restore(str(tmp_path), 1, plain, shardings=steps.out_shardings_for(
        steps.state_specs(model, opt, mesh, rules)))
    for a, b, c in zip(tree_leaves(back), tree_leaves(state),
                       tree_leaves(plain)):
        assert torch.equal(a.full_tensor(), b.full_tensor())
        assert torch.equal(c, b.full_tensor()) and a.placements == b.placements
    with pytest.raises(ValueError, match="another config"):
        small = build_model(dataclasses.replace(model.cfg, d_ff=32))
        ps = W._params(small)
        restore(str(tmp_path), 1, {"params": ps, "opt": opt.init(ps)})


def test_cli_mesh_flags(capsys):
    from repro_torch.launch import serve, train
    for main in (train.main, serve.main):
        with pytest.raises(ValueError, match="needs a world of 256 ranks"):
            main(["--smoke", "--device", "cpu", "--mesh", "single",
                  "--steps", "1"] if main is train.main else
                 ["--smoke", "--device", "cpu", "--mesh", "single"])
    capsys.readouterr()
    args = ["--arch", "llama3.2-1b", "--smoke", "--requests", "3",
            "--prompt-len", "6", "--gen", "3", "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    outs = []
    for extra in ([], ["--mesh", "none"]):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *args, *extra],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr[-2000:]
        # the wall-clock readings aside, the lines are the same
        outs.append(re.sub(r"\d+\.?\d* (s|ms|tok/s)\b", "T", out.stdout))
    assert outs[0] == outs[1] and "[serve] 3/3 requests" in outs[0]


def test_captured_step_raises_under_rules(world1):
    mesh, rules = world1
    model = build_model(configs.smoke("llama3.2-1b"))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        steps.make_captured_decode_step(model, None, smax=8, rules=rules)
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        steps.CapturedBatchedDecodeStep(model, None, bucket=2, smax=8,
                                        rules=rules)


# ------------------------------------------- the wrappers under DTensor

@pytest.fixture
def card(monkeypatch):
    """The card mocked: the wrappers' device test says "on the card" and
    every ctypes entry is a recorder that checks what it was handed (a
    plain tensor with a storage, never a DTensor) and runs the plain
    version."""
    from torch.distributed.tensor import DTensor

    from repro_torch.kernels.arena import kernel as ak
    from repro_torch.kernels.arena import ref as aref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.rglru import kernel as rk
    from repro_torch.kernels.rglru.ref import rglru_backward_torch, rglru_ref
    from repro_torch.kernels.rwkv6 import kernel as wk
    from repro_torch.kernels.rwkv6.ref import wkv6_backward_torch, wkv6_ref

    seen = []

    def check(*xs):
        for x in xs:
            if torch.is_tensor(x):
                assert not isinstance(x, DTensor)
                assert x.numel() == 0 or x.data_ptr() != 0
                seen.append(tuple(x.shape))

    def flash(q, k, v, **kw):
        check(q, k, v)
        return fops._flash_torch(q, k, v, kv_chunk=1024, **kw)

    def flash_backward(q, k, v, o, do, softmax_scale=None, window=None,
                       causal=True):
        check(q, k, v, o, do)
        return fops.flash_attention_backward_torch(
            q, k, v, o, do, softmax_scale=softmax_scale, window=window,
            causal=causal)

    def wkv(r, k, v, w, u, initial_state=None, state_out=None):
        check(r, k, v, w, u, initial_state, state_out)
        return wkv6_ref(r, k, v, w, u, initial_state, state_out)

    def wkv_backward(r, k, v, w, u, s0, do, dsT=None):
        check(r, k, v, w, u, s0, do, dsT)
        return wkv6_backward_torch(r, k, v, w, u, s0, do, dsT)

    def lru(log_a, gx, h0=None, state_out=None):
        check(log_a, gx, h0, state_out)
        return rglru_ref(log_a, gx, h0, state_out)

    def lru_backward(log_a, gx, h0, dh, dhT=None):
        check(log_a, gx, h0, dh, dhT)
        return rglru_backward_torch(log_a, gx, h0, dh, dhT)

    def awrite(arena, x, offset):
        check(arena, x)
        return aref.arena_write_torch(arena, x, offset)

    def aread(arena, offset, n, out=None):
        check(arena, out)
        return aref.arena_read_torch(arena, offset, n, out)

    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    monkeypatch.setattr(fk, "flash_attention_cuda", flash)
    monkeypatch.setattr(fk, "flash_backward_cuda", flash_backward)
    monkeypatch.setattr(wk, "wkv6_cuda", wkv)
    monkeypatch.setattr(wk, "wkv6_backward_cuda", wkv_backward)
    monkeypatch.setattr(rk, "rglru_cuda", lru)
    monkeypatch.setattr(rk, "rglru_backward_cuda", lru_backward)
    monkeypatch.setattr(ak, "arena_write_cuda", awrite)
    monkeypatch.setattr(ak, "arena_read_cuda", aread)
    return seen


def test_wrappers_run_dtensors_through_local_map(world1, card):
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rwkv6.ops import wkv6

    mesh, _ = world1
    g = torch.Generator().manual_seed(0)
    R = lambda *s: torch.randn(*s, generator=g)
    rep = lambda t: distribute_tensor(t, mesh, placements(P(), mesh))
    before = dict(_local.LOCAL_CALLS)
    with torch.no_grad():
        q, k, v = R(2, 5, 4, 16), R(2, 5, 2, 16), R(2, 5, 2, 16)
        o = flash_attention(rep(q), rep(k), rep(v), impl="cuda")
        assert isinstance(o, DTensor)
        assert torch.equal(o.full_tensor(), flash_attention(
            q, k, v, impl="cuda"))
        r, kk, vv, w = (R(1, 3, 2, 4) for _ in range(4))
        w = torch.sigmoid(w)
        u, s0 = R(2, 4), R(1, 2, 4, 4)
        st = rep(s0.clone())
        out, state = wkv6(rep(r), rep(kk), rep(vv), rep(w), rep(u),
                          initial_state=st, state_out=st, impl="cuda")
        want = wkv6(r, kk, vv, w, u, initial_state=s0.clone(), impl="cuda")
        assert state is st and torch.equal(st.full_tensor(), want[1])
        assert torch.equal(out.full_tensor(), want[0])
        la, gx, h0 = -torch.rand(1, 3, 8), R(1, 3, 8), R(1, 8)
        hd = rep(h0.clone())
        h, hT = rglru(rep(la), rep(gx), hd, impl="cuda", state_out=hd)
        wh, whT = rglru(la, gx, h0.clone(), impl="cuda")
        assert torch.equal(h.full_tensor(), wh)
        assert torch.equal(hd.full_tensor(), whT)
    calls = {k: _local.LOCAL_CALLS[k] - before.get(k, 0)
             for k in ("flash_attention", "wkv6", "rglru")}
    # one call a DTensor op; the plain comparisons made none
    assert calls == {"flash_attention": 1, "wkv6": 1, "rglru": 1}
    assert card                          # the recorders saw the launches


def test_arena_ops_refuse_dtensors_and_packing_gathers(world1, card):
    """The arena ops raise ``TypeError`` on a DTensor, before any ctypes
    entry; ``pack_buffers`` takes a sharded state whole, so the recorders
    see plain tensors and the bytes are the unsharded state's."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.core.allocator import Allocation, ArenaPlan
    from repro_torch.core.executor import pack_buffers
    from repro_torch.kernels.arena.ops import (
        arena_accum,
        arena_chain_write,
        arena_read,
        arena_write,
    )

    mesh, _ = world1
    rep = lambda t: distribute_tensor(t, mesh, placements(P(), mesh))
    arena = torch.zeros(64, dtype=torch.uint8)
    x = torch.arange(16, dtype=torch.uint8)
    for call in (lambda: arena_write(arena, rep(x), 8, impl="cuda"),
                 lambda: arena_accum(rep(arena), x, 8, impl="cuda"),
                 lambda: arena_chain_write(arena, rep(x), 8, impl="cuda"),
                 lambda: arena_read(rep(arena), 8, 16, impl="cuda"),
                 lambda: arena_read(arena, 8, 16, impl="cuda",
                                    out=rep(x.clone()))):
        with pytest.raises(TypeError, match="not DTensors"):
            call()
    assert not card
    plan = ArenaPlan([Allocation([1], 0, 16, 0, 1),
                      Allocation([2], 16, 16, 0, 1)], 32)
    y = torch.arange(4, dtype=torch.float32)
    got = pack_buffers(plan, {1: rep(x), 2: rep(y)}, device="cpu",
                       impl="cuda")
    want = pack_buffers(plan, {1: x, 2: y}, device="cpu", impl="torch")
    assert torch.equal(got, want) and len(card) == 4


def test_plain_tensor_on_another_device_raises(world1):
    """A plain tensor handed to a mesh of another device type raises
    rather than being copied there (DTensor's own ``from_local`` and
    ``distribute_tensor`` would move it without a word).  The CPU build
    has no CUDA tensor, so a meta tensor stands for one, and a stand-in
    carries a CUDA device to the check itself."""
    from repro_torch.parallel.sharding import (
        as_dtensor,
        check_device,
        copy_into,
        shard_act,
    )

    mesh, rules = world1
    meta = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="a tensor on meta given to a "
                       "mesh on cpu"):
        as_dtensor(meta, mesh)
    with pytest.raises(ValueError, match="mesh on cpu"):
        shard_act(meta, rules, "bd")
    with pytest.raises(ValueError, match="mesh on cpu"):
        copy_into(as_dtensor(torch.zeros(2, 4), mesh), meta)
    with pytest.raises(ValueError, match="mesh on cpu"):
        copy_into(meta, as_dtensor(torch.zeros(2, 4), mesh))
    model = build_model(configs.smoke("llama3.2-1b"))
    params = W.tree_map(lambda t: t.to("meta"), model.init(
        torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="mesh on cpu"):
        distribute_params(params, model.defs, rules, mesh)
    card_t = types.SimpleNamespace(device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="a tensor on cuda given to a "
                       "mesh on cpu"):
        check_device(card_t, mesh)
    check_device(torch.zeros(1), mesh)


def test_meshes_default_to_the_card(monkeypatch):
    """Without ``device`` a mesh and the one-rank group are the card's, as
    every entry point of the port is: where there is no card they raise
    instead of building a CPU mesh the card's tensors would be copied
    to."""
    from repro_torch.core.executor import ExecutorError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(ExecutorError, match="CUDA is not available"):
        init_single_process()
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 1)
    with pytest.raises(ExecutorError, match="CUDA is not available"):
        make_host_mesh(1, 1)


def test_sharded_nests(world1):
    """``sharded`` turns implicit replication on at its outermost level
    only: an inner context's exit leaves it on, the outer one's turns it
    off."""
    from repro_torch.parallel.sharding import as_dtensor, sharded

    mesh, rules = world1
    d = as_dtensor(torch.ones(2), mesh)
    with sharded(rules):
        with sharded(rules):
            d + torch.ones(2)
        (d + torch.ones(2)).full_tensor()
    with pytest.raises(RuntimeError, match="mixed torch.Tensor and DTensor"):
        d + torch.ones(2)


def test_shard_act_drops_an_axis_that_does_not_divide():
    """``shard_act`` and ``param_pspecs`` share one divisibility rule
    (``divisible_axes``): an axis is kept only where it divides what the
    axes before it leave, and one already used is skipped."""
    from repro_torch.parallel.sharding import divisible_axes, spec_entry

    sizes = {"pod": 2, "data": 4, "model": 3}
    assert divisible_axes(("pod", "data"), 8, sizes) == ["pod", "data"]
    assert divisible_axes(("pod", "data"), 4, sizes) == ["pod"]
    assert divisible_axes(("data", "model"), 12, sizes, {"data"}) == \
        ["model"]
    assert divisible_axes(("x",), 7, sizes) == ["x"]
    assert [spec_entry(a) for a in ([], ["data"], ["pod", "data"])] == [
        None, "data", ("pod", "data")]


def test_train_step_under_mocked_card_at_one_rank(world1, card):
    """The sharded loss and gradient of smoke ``llama3.2-1b`` with the card
    mocked: the attention goes through ``local_map`` into the recorders,
    forward and backward (``FlashAttentionFn``), and equals the unsharded
    mocked run's."""
    mesh, rules = world1
    cfg = configs.smoke("llama3.2-1b")
    model = build_model(cfg)
    params = W._params(model)
    batch = W._batch(cfg)
    ref = W._clone(params)
    sh = distribute_params(W._clone(params), model.defs, rules, mesh)
    n = len(card)
    l0, g0 = W._grads(model, ref, batch, None, impl="auto")
    calls = _local.LOCAL_CALLS["flash_attention"]
    l1, g1 = W._grads(model, sh, batch, rules, impl="auto")
    assert _local.LOCAL_CALLS["flash_attention"] > calls
    assert len(card) > n
    assert l0 == l1
    for a, b in zip(g1, g0):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------------- gloo (2, 2), four ranks

@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    out = W.launch(2, 2, tmp_path_factory.mktemp("gloo_2x2"))
    import json
    return json.loads(out.read_text())


def check_train(res, name):
    r = res["train"][name]
    assert r["placed"] == r["leaves"]
    assert r["sharded_leaves"] > 0 and r["own_storage"]
    assert r["loss_rel"] <= LOSS_RTOL and r["step_loss_rel"] <= LOSS_RTOL
    assert r["grad_norm_rel"] <= LOSS_RTOL
    for k in ("grad", "param", "opt"):
        assert r[k] <= LEAF_TOL, (k, r[k])
    kernels = {"rwkv6": "wkv6", "moe_ep": "moe_ep",
               "moe_scatter": "moe_dispatch"}.get(name, "flash_attention")
    assert r["local_calls"].get(kernels, 0) > 0, r["local_calls"]
    if name == "griffin":
        assert r["local_calls"].get("rglru", 0) > 0


def check_wrong_shard(res):
    r = res["wrong_shard"]
    assert r["loss_rel"] > 10 * LOSS_RTOL
    assert r["grad"] > 10 * LEAF_TOL


def check_serve(res, mode):
    r = res["serve"][mode]
    assert r["n_served"] == [3, 3]
    assert r["tokens"] == r["ref_tokens"]
    assert r["local_calls"].get("flash_attention", 0) > 0


@pytest.mark.parametrize("name", [f[0] for f in W.FAMILIES])
def test_train_step_matches_unsharded_2x2(mesh22, name):
    check_train(mesh22, name)


def test_wrong_shard_reads_above_limits_2x2(mesh22):
    check_wrong_shard(mesh22)


@pytest.mark.parametrize("mode", ["serial", "vmap"])
def test_serving_tokens_2x2(mesh22, mode):
    check_serve(mesh22, mode)


def check_ckpt(res):
    r = res["ckpt"]
    assert r["bit_equal"] and r["placements"] and r["raises_on_shape"]
    assert r["own_storage"]
    assert r["sharded_leaves"] > 0


def test_checkpoint_round_trip_2x2(mesh22):
    check_ckpt(mesh22)


def test_optim_kernels_reduce_partial_gradients_2x2(mesh22):
    # the optimizer kernels' route under rules, the kernels emulated on the
    # CPU: gradients autograd hands back Partial (llama's replicated
    # leaves, the batch sharded over "data") are reduced before their
    # squares are summed, so grad_norm and the state match the unsharded
    # plain steps; without that reduction the norm reads far off
    r = mesh22["optim"]
    assert r["partial_grads"] > 0, r
    got, bad = r["reduced"], r["control"]
    assert got["leaf_sumsq_rel"] <= LOSS_RTOL, got
    assert got["grad_norm_rel"] <= LOSS_RTOL, got
    assert got["param"] <= LEAF_TOL and got["opt"] <= LEAF_TOL, got
    assert bad["leaf_sumsq_rel"] > 100 * LOSS_RTOL, bad
    assert bad["grad_norm_rel"] > 10 * LOSS_RTOL, bad


def test_adafactor_kernels_reduce_partial_sums_2x2(mesh22):
    # the Adafactor kernels' route under rules, the kernels emulated on the
    # CPU in their own order: a shard's row, column and u u sums are
    # partial, and reduced across the mesh between the launches, so two
    # sharded steps match the unsharded plain steps within the chip's
    # moment limit (chip_smoke.ADAFACTOR_MOMENT_RTOL, 1e-5; readings
    # ~7e-7); without that reduction the moments read far off
    r = mesh22["adafactor"]
    got, bad = r["reduced"], r["control"]
    assert got["sharded_leaves"] > 0, got
    assert got["grad_norm_rel"] <= LOSS_RTOL, got
    assert got["param"] <= 1e-5 and got["opt"] <= 1e-5, got
    assert bad["opt"] > 1e3 * 1e-5, bad


def test_cache_heads_sharded_2x2(mesh22):
    # llama's 2 KV heads divide the model axis: heads, not the sequence
    assert mesh22["serve"]["cache_specs"][0] == [
        "None", "None", "None", "model"]
