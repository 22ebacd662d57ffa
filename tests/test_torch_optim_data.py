"""The port's optimizers, schedule, gradient compression, data pipeline,
checkpoints and fault-tolerant loop against ``repro``'s, on the CPU.

Inputs are made with numpy from a seed and handed to both packages:

  * ``adamw`` and ``adafactor``: 5 updates of a tree with a 1-D, a 2-D and
    a 3-D (stacked) leaf, params, moments and step within 1e-6 (f32; the
    port updates in place, ``repro`` returns new arrays);
  * ``cosine_warmup`` at steps 0, within the warm-up, at its end, midway
    and at the total, within 1e-7 relative;
  * ``quantize`` and ``ef_compress``: the same int8 codes, scales and
    carried errors, bit for bit;
  * ``DataPipeline.batch_at``: bit-equal for 2 seeds x 3 steps x 2
    process shards, and ``iter_from`` resumes at the same batches;
  * checkpoints: a round trip bit-equal (bf16, f32, int32 leaves), a stale
    ``tmp.<step>`` replaced, GC down to ``keep``, ``save_async`` writing
    the state as it was when called although the caller then updates it
    in place, and the manifests' path strings letter for letter;
  * a checkpoint written by ``repro.checkpoint.save`` restored by the port
    bit-equal, and the reverse;
  * a smoke ``llama3.2-1b`` train state restored into one of another
    ``d_ff`` raises ``ValueError`` (a leaf's shape is checked against the
    state's, not only against the manifest);
  * ``FaultTolerantLoop`` and ``StepTimer``: the cases of
    ``tests/test_fault.py`` over the port's checkpoints.
"""

import dataclasses
import json
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.checkpoint as jckpt  # noqa: E402
import repro.configs as jconfigs  # noqa: E402
from repro.data import DataPipeline as JPipeline  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro.optim.schedule import cosine_warmup as jcosine  # noqa: E402
import repro_torch.checkpoint as tckpt  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.data import DataPipeline as TPipeline  # noqa: E402
from repro_torch.launch.steps import make_optimizer  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from repro_torch.optim import adafactor as tadafactor  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import grad_compress as tgc  # noqa: E402
from repro_torch.optim.schedule import cosine_warmup as tcosine  # noqa: E402
from repro_torch.runtime import FaultTolerantLoop, StepTimer  # noqa: E402

SHAPES = {"bias": (7,), "w": (5, 6), "stack": (3, 4, 5)}
N_UPDATES = 5


def _np_tree(rng, scale=1.0):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in SHAPES.items()}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_np(tree):
    return tree_map(lambda t: np.asarray(t), tree)


# ---------------------------------------------------------------- optimizers


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_repro(name):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, weight_decay=0.1)
    jopt = (jadamw if name == "adamw" else jadafactor)(**kw)
    topt = (tadamw if name == "adamw" else tadafactor)(**kw)
    p0 = _np_tree(rng)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = _to_torch(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    # the state's structure and the step's dtype are repro's
    assert [tuple(a.shape) for a in jax.tree.leaves(js)] == \
        [tuple(t.shape) for t in tree_leaves(ts)]
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    for i in range(N_UPDATES):
        g = _np_tree(rng, scale=0.1 * (i + 1))
        lr_scale = 0.5 + 0.1 * i
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp,
                             lr_scale=lr_scale)
        tp_in = tp
        tp, ts = topt.update(_to_torch(g), ts, tp, lr_scale=lr_scale)
        # in place: the returned parameters are the given tensors
        assert all(a is b for a, b in zip(tree_leaves(tp),
                                          tree_leaves(tp_in)))
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    assert int(ts["step"]) == N_UPDATES


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_state_defs_match_repro(name):
    from repro.models.params import ParamDef as JDef
    from repro_torch.models.params import ParamDef as TDef, is_def
    jopt = jadamw() if name == "adamw" else jadafactor()
    topt = tadamw() if name == "adamw" else tadafactor()
    jd = jopt.state_defs({k: JDef(s, (None,) * len(s))
                          for k, s in SHAPES.items()})
    td = topt.state_defs({k: TDef(s, (None,) * len(s))
                          for k, s in SHAPES.items()})
    jl = jax.tree.leaves(jd, is_leaf=lambda x: isinstance(x, JDef))
    tl = tree_leaves(td, is_leaf=is_def)
    assert [d.shape for d in jl] == [d.shape for d in tl]
    assert [np.dtype(d.dtype).name for d in jl] == \
        [str(d.dtype).split(".")[1] for d in tl]


@pytest.mark.parametrize("step", [0, 5, 10, 55, 100, 130])
def test_cosine_warmup_matches_repro(step):
    kw = dict(peak_lr=3e-4, warmup=10, total=100)
    want = float(jcosine(jnp.int32(step), **kw))
    got = tcosine(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, rtol=1e-7)


# ---------------------------------------------------------------- compression


def test_quantize_codes_and_scales_bit_equal():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 33)).astype(np.float32) * 3.0
    x[0, 0] = 0.5 * np.abs(x).max() / 127 * 255   # near a rounding tie
    jq, js = jgc.quantize(jnp.asarray(x))
    tq, ts = tgc.quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts) == float(js)
    np.testing.assert_array_equal(tgc.dequantize(tq, ts).numpy(),
                                  np.asarray(jgc.dequantize(jq, js)))


def test_ef_compress_bit_equal_over_steps():
    rng = np.random.default_rng(2)
    p = _np_tree(rng)
    je = jgc.init_error(jax.tree.map(jnp.asarray, p))
    te = tgc.init_error(_to_torch(p))
    for _ in range(3):
        g = _np_tree(rng, scale=0.01)
        jg2, je = jgc.ef_compress(jax.tree.map(jnp.asarray, g), je)
        tg2, te = tgc.ef_compress(_to_torch(g), te)
        for a, b in zip(jax.tree.leaves(jg2), tree_leaves(tg2)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(jax.tree.leaves(je), tree_leaves(te)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("proc", [0, 1])
def test_batch_at_bit_equal(seed, proc):
    kw = dict(seq_len=16, global_batch=4, seed=seed, n_processes=2,
              process_index=proc)
    jp = JPipeline(cfg=jconfigs.smoke("llama3.2-1b"), **kw)
    tp = TPipeline(cfg=tconfigs.smoke("llama3.2-1b"), **kw)
    for step in (0, 1, 17):
        a, b = jp.batch_at(step), tp.batch_at(step)
        assert a.keys() == b.keys() == {"tokens"}
        assert b["tokens"].dtype == np.int32 and b["tokens"].shape == (2, 16)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
    it_j, it_t = jp.iter_from(5), tp.iter_from(5)
    for step in range(5, 8):
        b = next(it_t)["tokens"]
        np.testing.assert_array_equal(b, next(it_j)["tokens"])
        np.testing.assert_array_equal(b, tp.batch_at(step)["tokens"])


# ---------------------------------------------------------------- checkpoints


def _train_state_np(seed=3):
    """A train state's leaves as numpy f32 values: bf16 params (values
    that bf16 holds exactly), f32 moments, an int32 step."""
    rng = np.random.default_rng(seed)
    bf = lambda s: np.asarray(jnp.asarray(rng.standard_normal(s),
                                          jnp.bfloat16), np.float32)
    return {
        "params": {"embed": {"tok": bf((16, 8))},
                   "blocks": [{"w": bf((8, 8))}, {"w": bf((8, 4))}]},
        "opt": {"step": np.int32(7),
                "m": {"embed": {"tok": rng.standard_normal((16, 8))
                                .astype(np.float32)}},
                "v": {"embed": {"tok": rng.random((16, 8))
                                .astype(np.float32)}}},
    }


def _jax_state(st):
    return jax.tree.map(
        lambda a: jnp.asarray(a, jnp.int32) if np.asarray(a).dtype ==
        np.int32 else jnp.asarray(a, jnp.float32), st) | {
        "params": jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                               st["params"])}


def _torch_state(st):
    out = tree_map(lambda a: torch.tensor(np.asarray(a)), st)
    out["params"] = tree_map(lambda t: t.to(torch.bfloat16), out["params"])
    return out


def _zeros_like_torch(st):
    return tree_map(lambda t: torch.zeros_like(t), st)


def _same(torch_tree, jax_tree):
    tl, jl = tree_leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert str(t.dtype).split(".")[1] == j.dtype.name
        np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


def test_checkpoint_round_trip_bit_equal(tmp_path):
    st = _torch_state(_train_state_np())
    d = str(tmp_path / "ck")
    path = tckpt.save(d, 12, st)
    assert os.path.basename(path) == "step_0000000012"
    assert tckpt.latest_step(d) == 12
    back = tckpt.restore(d, 12, _zeros_like_torch(st))
    for a, b in zip(tree_leaves(st), tree_leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with open(os.path.join(path, "manifest.json")) as f:
        recs = json.load(f)["arrays"]
    assert [r["path"] for r in recs][:3] == [
        "['opt']/['m']/['embed']/['tok']", "['opt']/['step']",
        "['opt']/['v']/['embed']/['tok']"]
    assert recs[3]["path"] == "['params']/['blocks']/[0]/['w']"
    assert recs[3]["dtype"] == "bfloat16"


def test_manifest_paths_equal_repro(tmp_path):
    st = _train_state_np()
    a = jckpt.save(str(tmp_path / "j"), 1, _jax_state(st))
    b = tckpt.save(str(tmp_path / "t"), 1, _torch_state(st))
    with open(os.path.join(a, "manifest.json")) as f:
        ja = json.load(f)
    with open(os.path.join(b, "manifest.json")) as f:
        tb = json.load(f)
    assert ja == tb


def test_stale_tmp_is_replaced_atomically(tmp_path):
    d = tmp_path / "ck"
    (d / "tmp.5").mkdir(parents=True)
    (d / "tmp.5" / "junk.npy").write_bytes(b"partial")
    st = {"w": torch.arange(6, dtype=torch.float32)}
    tckpt.save(str(d), 5, st)
    assert sorted(os.listdir(d)) == ["step_0000000005"]
    assert sorted(os.listdir(d / "step_0000000005")) == [
        "arr_00000.npy", "manifest.json"]
    # a crash mid-write leaves only a tmp dir: the latest step is untouched
    (d / "tmp.9").mkdir()
    assert tckpt.latest_step(str(d)) == 5


def test_gc_keeps_newest(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((3,), float(s))})
    assert sorted(os.listdir(mgr.dir)) == ["step_0000000003",
                                           "step_0000000004"]


def test_save_async_snapshots_before_in_place_update(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path / "ck"), keep=3)
    st = {"w": torch.arange(1000, dtype=torch.float32),
          "b": torch.ones(4, dtype=torch.bfloat16)}
    want = tree_map(lambda t: t.clone(), st)
    mgr.save_async(3, st)
    st["w"].add_(1.0)                 # the next step, in place
    st["b"].mul_(2.0)
    mgr.wait()
    back = tckpt.restore(mgr.dir, 3, _zeros_like_torch(st))
    for a, b in zip(tree_leaves(want), tree_leaves(back)):
        assert torch.equal(a, b)


def test_repro_checkpoint_restores_in_port(tmp_path):
    st = _train_state_np()
    jckpt.save(str(tmp_path), 4, _jax_state(st))
    like = _zeros_like_torch(_torch_state(st))
    back = tckpt.restore(str(tmp_path), 4, like)
    _same(back, _jax_state(st))


def test_port_checkpoint_restores_in_repro(tmp_path):
    st = _train_state_np()
    tckpt.save(str(tmp_path), 4, _torch_state(st))
    like = jax.tree.map(jnp.zeros_like, _jax_state(st))
    back = jckpt.restore(str(tmp_path), 4, like)
    _same(_torch_state(st), back)


def test_restore_refuses_leaf_of_another_shape(tmp_path):
    def state(cfg):
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), "cpu")
        return {"params": params, "opt": make_optimizer(cfg).init(params)}

    cfg = tconfigs.smoke("llama3.2-1b")
    tckpt.save(str(tmp_path), 2, state(cfg))
    other = state(dataclasses.replace(cfg, d_ff=2 * cfg.d_ff))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(str(tmp_path), 2, other)
    # the state of the same config still restores
    tckpt.restore(str(tmp_path), 2, state(cfg))


# ---------------------------------------------------------------- fault loop
# the cases of tests/test_fault.py, over the port's checkpoints


class TestStepTimer:
    def test_no_flag_before_warmup(self):
        t = StepTimer()
        for _ in range(6):
            assert not t.observe(0.01)
        assert not t.observe(100.0)
        assert t.stragglers == 0
        assert t.observe(100.0)
        assert t.stragglers == 1

    def test_flags_outlier_against_moving_median(self):
        t = StepTimer(straggler_factor=2.5)
        for _ in range(10):
            t.observe(0.01)
        assert t.observe(0.1)
        assert not t.observe(0.02)
        assert t.stragglers == 1

    def test_window_is_bounded(self):
        t = StepTimer(window=8)
        for i in range(50):
            t.observe(0.01 + i * 1e-6)
        assert len(t.history) == 8


def _batches(start: int):
    i = start
    while True:
        yield float(i)
        i += 1


def _loop(tmp_path, step_fn, **kw) -> FaultTolerantLoop:
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"), keep=10)
    return FaultTolerantLoop(step_fn, mgr, _batches, **kw)


def _state():
    return {"w": np.zeros((), np.float64)}


class TestFaultTolerantLoop:
    def test_happy_path_checkpoints_and_counts(self, tmp_path):
        def step(state, batch):
            return {"w": state["w"] + batch}, {"loss": batch}

        loop = _loop(tmp_path, step, ckpt_every=2)
        seen = []
        state, step_no = loop.run(_state(), 0, 5,
                                  on_metrics=lambda s, m: seen.append(s))
        assert step_no == 5
        assert float(state["w"]) == sum(range(5))
        assert seen == [1, 2, 3, 4, 5]
        assert tckpt.latest_step(loop.ckpt.dir) == 5
        assert len(loop.timer.history) == 5

    def test_transient_failure_restores_from_checkpoint(self, tmp_path):
        fails = {3: 1}

        def step(state, batch):
            step_no = int(round(float(batch)))
            if fails.get(step_no):
                fails[step_no] -= 1
                raise RuntimeError("injected transient step failure")
            return {"w": state["w"] + batch}, {}

        loop = _loop(tmp_path, step, ckpt_every=2, max_retries=3)
        state, step_no = loop.run(_state(), 0, 6)
        assert step_no == 6
        assert float(state["w"]) == sum(range(6))

    def test_retry_budget_exhaustion_raises(self, tmp_path):
        def step(state, batch):
            raise RuntimeError("permanent failure")

        loop = _loop(tmp_path, step, ckpt_every=100, max_retries=2)
        with pytest.raises(RuntimeError, match="permanent failure"):
            loop.run(_state(), 0, 5)

    def test_retry_counter_resets_on_success(self, tmp_path):
        fails = {1: 1, 3: 1}

        def step(state, batch):
            step_no = int(round(float(batch)))
            if fails.get(step_no):
                fails[step_no] -= 1
                raise RuntimeError("transient")
            return {"w": state["w"] + batch}, {}

        loop = _loop(tmp_path, step, ckpt_every=1, max_retries=1)
        state, step_no = loop.run(_state(), 0, 5)
        assert step_no == 5
        assert float(state["w"]) == sum(range(5))

    @pytest.mark.parametrize("ckpt_every", [100, 1])
    def test_failure_inside_in_place_update(self, tmp_path, ckpt_every):
        # the port's optimizer updates the state in place: a step that
        # fails after writing part of it leaves the state wrong, so the
        # loop restores the last checkpoint, and with none it raises
        # rather than carry on from the partly updated state
        fails, calls = {3: 1}, []

        def step(state, batch):
            step_no = int(round(float(batch)))
            calls.append(step_no)
            state["w"].add_(batch)
            if fails.get(step_no):
                fails[step_no] -= 1
                raise RuntimeError("injected failure after a partial update")
            state["v"].add_(1.0)
            return state, {}

        loop = _loop(tmp_path, step, ckpt_every=ckpt_every, max_retries=3)
        state = {"w": torch.zeros((), dtype=torch.float64),
                 "v": torch.zeros((), dtype=torch.float64)}
        if ckpt_every > 3:
            with pytest.raises(RuntimeError, match="partial update"):
                loop.run(state, 0, 6)
            assert calls == [0, 1, 2, 3]
            return
        state, step_no = loop.run(state, 0, 6)
        assert step_no == 6 and calls == [0, 1, 2, 3, 3, 4, 5]
        assert float(state["w"]) == sum(range(6))
        assert float(state["v"]) == 6

    def test_sigterm_checkpoints_before_exit(self, tmp_path):
        prev = signal.getsignal(signal.SIGTERM)
        try:
            stop_at = 3

            def step(state, batch):
                step_no = int(round(float(batch)))
                if step_no == stop_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                return {"w": state["w"] + batch}, {}

            loop = _loop(tmp_path, step, ckpt_every=100)
            state, step_no = loop.run(_state(), 0, 100)
            assert loop._stop
            assert step_no == stop_at + 1
            assert tckpt.latest_step(loop.ckpt.dir) == step_no
            assert float(state["w"]) == sum(range(stop_at + 1))
        finally:
            signal.signal(signal.SIGTERM, prev)
