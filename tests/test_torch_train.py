"""The port's training path against ``repro``'s, on the CPU, and its
attention gradient.

Inputs (weights, tokens, attention tensors) are made in ``repro`` or with
numpy from a seed and handed to both packages; every comparison is in f32:

  * ``loss_fn`` of the smoke configs of the three families
    (``llama3.2-1b``, ``rwkv6-7b``, ``recurrentgemma-2b``; the recurrent
    mixing leaves filled by ``live_leaves`` as in
    ``test_torch_recurrent_models.py``, the Griffin sequence longer than
    its window), of the dense and MoE decoders (``gemma-7b``,
    ``starcoder2-7b``, ``granite-20b``, ``chameleon-34b``,
    ``granite-moe-3b-a800m``, whose metrics carry the MoE's ``aux_loss``),
    of the encoder-decoder (``seamless-m4t-medium``, 24 frames against 16
    tokens; ``repro``'s encoder carried in f32 as in
    ``test_torch_encdec.py``) and of ``deepseek-v3-671b`` (MLA, MoE, its
    metrics carrying ``mtp_loss``) against ``repro``'s
    ``loss_fn(impl="xla")``: the loss and each metric
    within 1e-5, every gradient leaf against ``jax.grad`` within 1e-4 of
    the leaf's largest gradient (sums in another order);
  * 3 train steps of the smoke ``llama3.2-1b`` against ``repro``'s jitted
    ``make_train_step`` from one state (the optimizer state carried across
    by ``params_from_numpy`` over ``opt.state_defs``) and one batch
    sequence: loss and ``grad_norm`` each step within 1e-4 relative, the
    final parameters within 1e-4;
  * a run of the CLI's loop checkpointed at step 2 and replayed from that
    checkpoint ends in bit-equal parameters and optimizer state;
  * ``python -m repro_torch.launch.train --smoke --device cpu --steps 4``
    runs and logs finite losses;
  * ``--layers`` (``configs.cut_depth``) keeps the first layers at the same
    widths (the smoke ``llama3.2-1b`` at 1, ``recurrentgemma-2b`` at 3), and
    such a run replays bit-equal from its checkpoint;
  * ``flash_attention_backward_torch`` (the backward kernel's plain
    version) against autograd of ``attention_ref`` and of ``_flash_torch``
    and against ``jax.grad`` of ``repro``'s ``_flash_xla`` (S 17 and 64, G
    1 and 4; 1e-5);
  * no kernel wrapper drops a gradient: with the wrappers' device test
    (``kernels._grad.on_card``) made to answer "on the card" and each
    kernel entry replaced by its plain version run without autograd (as a
    ctypes launch is), every ``impl="cuda"`` op given an input that
    requires a gradient either returns an output with a ``grad_fn`` (the
    flash attention's ``FlashAttentionFn``, with or without a window, the
    RG-LRU's ``RGLRUFn`` and WKV-6's ``WKV6Fn``, whose gradients then
    equal autograd's of the plain forward) or raises
    ``NotImplementedError`` (the arena ops), and a training form the
    backward does not take raises too: ``check_backward`` on a mocked CUDA
    tensor takes (128, 128) with and without a window, MLA's (192, 128)
    causal at its own softmax scale and (64, 64) non-causal with ``Sq``
    equal to ``Skv`` or not (seamless-m4t-medium's encoder and
    cross-attention), and raises at (16, 16) and (128, 64), for a causal
    call with ``Sq != Skv``, a cut ``kv_len``, a device position, a
    window on a non-causal call and non-causal calls at other head dims;
  * the MoE's gradient check on the card forces each run's expert ids on
    the other (``chip_smoke.RouteLog(force, own_gates=True)``): a run
    forced with its own ids, gates from its own router, gives a loss and
    gradients bit-equal to the unforced run (the smoke
    ``granite-moe-3b-a800m``, f32);
  * the whole Griffin slice on that mocked card: the smoke
    ``recurrentgemma-2b`` (window 16, S 24: the window bites) with its
    gradients through ``RGLRUFn`` and the windowed ``FlashAttentionFn``
    (each backward entry counted) against ``jax.grad`` of ``repro``'s
    ``loss_fn``, leaf by leaf within 1e-4 of each leaf's largest.

The card's tests of the same path are in ``test_torch_train_card.py``,
which imports no JAX (the card's machine has none).
"""

import functools
import math
import os
import shutil
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
import repro.models.zoo as jzoo  # noqa: E402
from repro.kernels.flash_attention.ops import _flash_xla  # noqa: E402
from repro.launch.steps import make_optimizer as jmake_optimizer  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import _grad  # noqa: E402
from repro_torch.kernels.arena import ops as arena_ops  # noqa: E402
from repro_torch.kernels.arena.ref import (  # noqa: E402
    arena_accum_torch,
    arena_chain_write_torch,
    arena_read_torch,
    arena_write_torch,
)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    FlashAttentionFn,
    _flash_torch,
    flash_attention,
    flash_attention_backward_torch,
)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import (  # noqa: E402
    rglru_backward_torch,
    rglru_ref,
)
from repro_torch.kernels.rwkv6 import ops as rwkv6_ops  # noqa: E402
from repro_torch.kernels.rwkv6.ref import (  # noqa: E402
    wkv6_backward_torch,
    wkv6_ref,
)
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import make_optimizer, make_train_step  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    params_from_numpy,
    tree_leaves,
    tree_map,
)
from repro_torch.models.zoo import build_model  # noqa: E402

from test_torch_recurrent_models import live_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RECURRENT = ("rwkv6-7b", "recurrentgemma-2b")
ARCHS = ("llama3.2-1b", *RECURRENT, "gemma-7b", "starcoder2-7b",
         "granite-20b", "chameleon-34b", "granite-moe-3b-a800m",
         "seamless-m4t-medium", "deepseek-v3-671b")
SEQ = {"llama3.2-1b": 16, "rwkv6-7b": 12, "recurrentgemma-2b": 24,
       "gemma-7b": 16, "starcoder2-7b": 16, "granite-20b": 16,
       "chameleon-34b": 16, "granite-moe-3b-a800m": 16,
       "seamless-m4t-medium": 16, "deepseek-v3-671b": 16}
# the encoder-decoder's frames: more rows than its tokens, so that its
# cross-attention has Sq != Skv
FRAMES = {"seamless-m4t-medium": 24}
f32 = jnp.float32


def _np32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tokens(seed, B, S, V):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(
        np.int32)


# ---------------------------------------------------------------- loss_fn


@pytest.fixture(scope="module", params=ARCHS)
def loss_pair(request):
    arch = request.param
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    init = jm.init(jax.random.PRNGKey(0))
    jp = live_leaves(arch, init) if arch in RECURRENT else init
    jp = jax.tree.map(lambda a: a.astype(f32), jp)
    tp = tree_map(lambda t: t.float(),
                  params_from_numpy(tm.defs, _np32(jp), "cpu"))
    batch = {"tokens": _tokens(5, 2, SEQ[arch], tm.cfg.vocab_size)}
    if arch in FRAMES:
        batch["frames"] = np.random.default_rng(6).standard_normal(
            (2, FRAMES[arch], tm.cfg.d_model)).astype(np.float32)
    jloss = lambda p: jm.loss_fn(
        p, {k: jnp.asarray(a) for k, a in batch.items()}, impl="xla")
    with pytest.MonkeyPatch.context() as mp:
        if tm.cfg.is_encoder_decoder:
            # repro's encoder carried in f32 from the bf16-rounded frames,
            # as the port's runs with f32 parameters (test_torch_encdec.py)
            mp.setattr(jzoo, "shard_act",
                       lambda x, rules, kind: x.astype(jnp.float32))
        (jl, jmet), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, tmet = tm.loss_fn(tp, {k: torch.from_numpy(a)
                               for k, a in batch.items()})
    tg = torch.autograd.grad(tl, leaves)
    return arch, (jl, jmet, jg), (tl, tmet, tg)


def test_loss_matches_repro(loss_pair):
    arch, (jl, jmet, _), (tl, tmet, _) = loss_pair
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert set(tmet) == set(jmet)
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5
    for k in jmet:
        assert abs(float(tmet[k].detach()) - float(jmet[k])) <= 1e-5, k


def test_grads_match_repro(loss_pair):
    arch, (_, _, jg), (_, _, tg) = loss_pair
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        a = np.asarray(a)
        assert b.shape == a.shape
        scale = max(float(np.abs(a).max()), 1e-12)
        err = float(np.abs(b.numpy() - a).max()) / scale
        assert err <= 1e-4, (arch, a.shape, err)
    # the gradient is not all zero: the check has teeth
    assert max(float(np.abs(np.asarray(a)).max()) for a in jl) > 1e-3


def test_loss_needs_no_grad_to_run():
    tm = build_model(tconfigs.smoke("llama3.2-1b"))
    tp = tm.init(torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(_tokens(1, 2, 8, 512))
    with torch.no_grad():
        loss, met = tm.loss_fn(tp, {"tokens": tokens})
    assert loss.grad_fn is None and torch.isfinite(loss)
    assert float(met["aux_loss"]) == 0.0
    # sharding rules are live (tests/test_torch_parallel.py); rules
    # without a mesh to shard over are rejected
    with pytest.raises(ValueError, match="need a mesh"):
        tm.loss_fn(tp, {"tokens": tokens}, rules=object())


# ---------------------------------------------------------------- train step


def test_three_train_steps_match_repro():
    arch = "llama3.2-1b"
    kw = dict(peak_lr=1e-2, warmup=1, total_steps=10, grad_clip=1.0)
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    jopt = jmake_optimizer(jm.cfg, lr=1e-2)
    topt = make_optimizer(tm.cfg, lr=1e-2)
    jp = jax.tree.map(lambda a: a.astype(f32), jm.init(jax.random.PRNGKey(1)))
    jstate = {"params": jp, "opt": jopt.init(jp)}
    tstate = {
        "params": tree_map(lambda t: t.float(),
                           params_from_numpy(tm.defs, _np32(jp), "cpu")),
        "opt": params_from_numpy(topt.state_defs(tm.defs),
                                 jax.tree.map(np.asarray, jstate["opt"]),
                                 "cpu"),
    }
    assert tstate["opt"]["step"].dtype == torch.int32
    jstep = jax.jit(jmake_train_step(jm, jopt, None, impl="xla", **kw))
    tstep = make_train_step(tm, topt, None, **kw)
    for s in range(3):
        tokens = _tokens(10 + s, 2, 16, 512)
        jstate, jmet = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tmet = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        for k in ("loss", "lm_loss", "grad_norm", "lr"):
            assert tmet[k].shape == () and tmet[k].grad_fn is None
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=1e-4, err_msg=f"{k} step {s}")
    assert int(tstate["opt"]["step"]) == 3
    for a, b in zip(jax.tree.leaves(jstate["params"]),
                    tree_leaves(tstate["params"])):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-4)
    # the steps moved the parameters
    moved = max(float(np.abs(np.asarray(a) - b).max()) for a, b in zip(
        jax.tree.leaves(jstate["params"]), jax.tree.leaves(_np32(jp))))
    assert moved > 1e-3


def test_train_step_rejects_rules():
    # rules on a mesh run (tests/test_torch_parallel.py); rules without
    # one are rejected when the step is made
    tm = build_model(tconfigs.smoke("llama3.2-1b"))
    with pytest.raises(ValueError, match="need a mesh"):
        make_train_step(tm, make_optimizer(tm.cfg), rules=object())


def _cli(ckpt_dir, steps, every):
    return ttrain.main(["--smoke", "--device", "cpu", "--steps", str(steps),
                        "--batch", "2", "--seq", "16", "--ckpt-every",
                        str(every), "--ckpt-dir", str(ckpt_dir),
                        "--log-every", "1", "--seed", "3"])


def test_checkpoint_replay_bit_equal(tmp_path):
    straight = _cli(tmp_path / "a", 4, 2)
    assert straight["start"] == 0 and straight["end_step"] == 4
    assert all(math.isfinite(x) for x in straight["losses"])
    # resume from the step-2 checkpoint alone and replay steps 3 and 4
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    tmp_path / "b" / "step_0000000002")
    replay = _cli(tmp_path / "b", 4, 2)
    assert replay["start"] == 2 and replay["end_step"] == 4
    assert replay["losses"] == straight["losses"][2:]
    for a, b in zip(tree_leaves(straight["state"]),
                    tree_leaves(replay["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_cli_runs_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "4", "--log-every", "1",
         "--ckpt-dir", str(tmp_path / "ck")],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    losses = [float(ln.split("loss=")[1].split()[0])
              for ln in out.stderr.splitlines() if "loss=" in ln]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    assert "done at step 4" in out.stderr


@pytest.mark.parametrize("arch,layers", [("llama3.2-1b", 1),
                                         ("recurrentgemma-2b", 3)])
def test_cli_cuts_depth(tmp_path, arch, layers):
    # --layers keeps the first layers at the same widths: the trained
    # state has the cut model's leaves, and its replay resumes bit-equal
    argv = ["--smoke", "--arch", arch, "--layers", str(layers), "--device",
            "cpu", "--steps", "3", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--log-every", "1", "--seed", "3"]
    straight = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    assert straight["end_step"] == 3
    assert all(math.isfinite(x) for x in straight["losses"])
    cfg = tconfigs.cut_depth(tconfigs.smoke(arch), layers)
    assert cfg.n_layers == layers < tconfigs.smoke(arch).n_layers
    assert cfg.d_model == tconfigs.smoke(arch).d_model
    want = build_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    got = tree_leaves(straight["state"]["params"])
    assert [tuple(t.shape) for t in got] == [tuple(t.shape)
                                             for t in tree_leaves(want)]
    (tmp_path / "b").mkdir()
    shutil.copytree(tmp_path / "a" / "step_0000000002",
                    tmp_path / "b" / "step_0000000002")
    replay = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "b")])
    assert replay["start"] == 2 and replay["losses"] == straight["losses"][2:]
    for a, b in zip(tree_leaves(straight["state"]),
                    tree_leaves(replay["state"])):
        assert torch.equal(a, b)


def test_cut_depth_keeps_widths_and_bounds_depth():
    full = tconfigs.get("deepseek-v3-671b")
    assert tconfigs.cut_depth(full, None) is full
    cut = tconfigs.cut_depth(full, 2)
    assert (cut.n_layers, cut.n_dense_layers) == (2, 2)
    assert (cut.d_model, cut.vocab_size) == (full.d_model, full.vocab_size)
    assert tconfigs.cut_depth(full, 5).n_dense_layers == full.n_dense_layers
    for bad in (0, full.n_layers + 1):
        with pytest.raises(ValueError, match="cannot cut it"):
            tconfigs.cut_depth(full, bad)


def test_cut_depth_cuts_both_stacks_of_the_encoder_decoder():
    # seamless-m4t-medium's --layers N keeps the first N layers of its
    # encoder and of its decoder, widths as published
    full = tconfigs.get("seamless-m4t-medium")
    cut = tconfigs.cut_depth(full, 1)
    assert (cut.n_layers, cut.encoder_layers) == (1, 1)
    assert (cut.d_model, cut.vocab_size) == (full.d_model, full.vocab_size)
    assert tconfigs.cut_depth(tconfigs.get("llama3.2-1b"), 2) \
        .encoder_layers == 0
    tm = build_model(tconfigs.cut_depth(tconfigs.smoke(
        "seamless-m4t-medium"), 1))
    shapes = {k: tuple(v.shape) for k, v in tm.defs["enc"]["ln1"].items()}
    assert shapes == {"scale": (1, tm.cfg.d_model)}


def test_cli_rejects_a_mesh(tmp_path):
    # the production mesh needs its 256 ranks, as jax.make_mesh its devices
    with pytest.raises(ValueError, match="needs a world of 256 ranks"):
        ttrain.main(["--smoke", "--device", "cpu", "--mesh", "single",
                     "--ckpt-dir", str(tmp_path)])


# ---------------------------------------------------------------- attention


def _attn_inputs(seed, B, S, H, KV, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(dtype) for s in
            ((B, S, H, D), (B, S, KV, D), (B, S, KV, D), (B, S, H, D))]


@pytest.mark.parametrize("S", [17, 64])
@pytest.mark.parametrize("G", [1, 4])
def test_backward_plain_matches_autograd_and_jax(S, G):
    KV, D = 2, 16
    qn, kn, vn, don = _attn_inputs(S + G, 2, S, KV * G, KV, D)
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in (qn, kn, vn))
    do = torch.from_numpy(don)
    o = attention_ref(q, k, v, causal=True)
    got = flash_attention_backward_torch(q.detach(), k.detach(), v.detach(),
                                         o.detach(), do)
    wants = {
        "attention_ref": torch.autograd.grad(o, (q, k, v), do),
        "_flash_torch": torch.autograd.grad(
            _flash_torch(q, k, v, causal=True, window=None, q_start=0,
                         kv_len=None, softmax_scale=None, kv_chunk=8),
            (q, k, v), do),
    }
    fx = functools.partial(_flash_xla, causal=True, window=None, q_start=0,
                           kv_len=None, softmax_scale=None, kv_chunk=8,
                           skip_masked_blocks=False)
    _, vjp = jax.vjp(fx, jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    wants["_flash_xla"] = [torch.from_numpy(np.array(a))
                           for a in vjp(jnp.asarray(don))]
    for name, want in wants.items():
        for g, w, what in zip(got, want, ("dq", "dk", "dv")):
            assert g.dtype == torch.float32 and g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5,
                                       msg=f"{what} vs {name}")


def test_function_on_cpu_matches_autograd(on_card):
    # the Function is the card's; on CPU tensors, with its kernel entries
    # the plain versions (the on_card fixture), it computes autograd's
    # gradient of the plain forward
    qn, kn, vn, don = _attn_inputs(3, 2, 24, 8, 2, 16)
    q, k, v = (torch.from_numpy(a).requires_grad_(True)
               for a in (qn, kn, vn))
    do = torch.from_numpy(don)
    o = FlashAttentionFn.apply(q, k, v, None)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, torch.autograd.grad(ref, (q, k, v), do)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- no dropped
# gradient: every impl="cuda" op, its device test answering "on the card"
# and its kernel entries the plain versions run without autograd, as a
# ctypes launch is


def _detached(fn):
    def run(*a, **kw):
        with torch.no_grad():
            return fn(*a, **kw)
    return run


@pytest.fixture
def on_card(monkeypatch):
    monkeypatch.setattr(_grad, "on_card", lambda t: True)
    fk = fa_ops._kernel

    def fwd(q, k, v, *, causal, window, q_start, kv_len, softmax_scale):
        return _flash_torch(q, k, v, causal=causal, window=window,
                            q_start=q_start, kv_len=kv_len,
                            softmax_scale=softmax_scale, kv_chunk=8)

    monkeypatch.setattr(fk, "flash_attention_cuda", _detached(fwd))
    monkeypatch.setattr(fk, "flash_backward_cuda",
                        _detached(flash_attention_backward_torch))
    monkeypatch.setattr(rwkv6_ops._kernel, "wkv6_cuda", _detached(
        lambda r, k, v, w, u, *, initial_state, state_out:
        wkv6_ref(r, k, v, w, u, initial_state, state_out)))
    monkeypatch.setattr(rwkv6_ops._kernel, "wkv6_backward_cuda",
                        _detached(wkv6_backward_torch))
    monkeypatch.setattr(rglru_ops._kernel, "rglru_cuda", _detached(
        lambda la, gx, h0=None, *, state_out=None:
        rglru_ref(la, gx, h0, state_out)))
    monkeypatch.setattr(rglru_ops._kernel, "rglru_backward_cuda",
                        _detached(rglru_backward_torch))
    ak = arena_ops._kernel
    for name, fn in (("write", arena_write_torch), ("read", arena_read_torch),
                     ("accum", arena_accum_torch),
                     ("chain_write", arena_chain_write_torch)):
        monkeypatch.setattr(ak, f"arena_{name}_cuda", _detached(fn))


def _leaf(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).requires_grad_(True)


def test_mock_flash_cuda_has_grad_fn(on_card):
    q, k, v = _leaf(1, 20, 4, 16), _leaf(1, 20, 2, 16, seed=1), \
        _leaf(1, 20, 2, 16, seed=2)
    for impl in ("cuda", "auto"):
        o = flash_attention(q, k, v, causal=True, impl=impl)
        assert o.grad_fn is not None, impl
        got = torch.autograd.grad(o.sum(), (q, k, v))
        want = torch.autograd.grad(attention_ref(q, k, v).sum(), (q, k, v))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # without autograd, the kernel's own launch (no grad_fn, no Function)
    with torch.no_grad():
        assert flash_attention(q, k, v, impl="cuda").grad_fn is None


@pytest.mark.parametrize("kw", [
    dict(causal=False, window=5), dict(q_start=3),
    dict(kv_len=10), dict(q_start=torch.tensor(0))])
def test_mock_flash_cuda_raises_off_the_training_form(on_card, kw):
    # A window on a non-causal call (no model makes one), an offset, a cut
    # kv_len and a device position: forms outside the backward's, which
    # raise.  (A non-causal call without a window is a training form now:
    # test_mock_flash_cuda_noncausal_has_grad_fn.)
    q, k, v = _leaf(1, 20, 4, 16), _leaf(1, 20, 2, 16), _leaf(1, 20, 2, 16)
    with pytest.raises(NotImplementedError):
        flash_attention(q, k, v, **{"causal": True, **kw}, impl="cuda")


def test_mock_flash_cuda_raises_for_unported_head_dims(on_card,
                                                       monkeypatch):
    # the card's kernel takes (64, 64) only: a (16, 16) call on the card
    # raises before its forward runs
    q, k, v = _leaf(1, 20, 4, 16), _leaf(1, 20, 2, 16), _leaf(1, 20, 2, 16)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(NotImplementedError, match=r"\(64, 64\)"):
        fa_ops._kernel.check_backward(q, k, v)


@pytest.mark.parametrize("dims", [(16, 16), (128, 64)])
def test_mock_check_backward_raises_for_dims_without_a_kernel(on_card,
                                                             monkeypatch,
                                                             dims):
    # the mocked card's route: the (16, 16) pair and (128, 64), a pair no
    # model has, have no backward kernel, with or without a window.  (MLA's
    # (192, 128) has one now: test_mock_flash_cuda_mla_has_grad_fn.)
    D, Dv = dims
    q, k, v = _leaf(1, 20, 4, D), _leaf(1, 20, 2, D), _leaf(1, 20, 2, Dv)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    for window in (None, 7):
        with pytest.raises(NotImplementedError, match=r"\(128, 128\)"):
            fa_ops._kernel.check_backward(q, k, v, window=window)


@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_mock_flash_cuda_d128_has_grad_fn(on_card, monkeypatch, window,
                                          impl):
    # (128, 128), starcoder2-7b's, granite-20b's and chameleon-34b's heads:
    # the route takes it with and without a window, and under autograd the
    # call is FlashAttentionFn, its gradient autograd's of the plain
    # forward
    q, k, v = _leaf(1, 20, 4, 128), _leaf(1, 20, 2, 128, seed=1), \
        _leaf(1, 20, 2, 128, seed=2)
    o = flash_attention(q, k, v, causal=True, window=window, impl=impl)
    assert o.grad_fn is not None and "FlashAttentionFn" in \
        type(o.grad_fn).__name__
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, torch.autograd.grad(ref, (q, k, v), do)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    fa_ops._kernel.check_backward(q, k, v, window=window)
    for dtype in (torch.bfloat16, torch.float32):
        assert fa_ops._kernel.pick_backward_route(dtype, 128, 128) == (
            "sm90" if dtype == torch.bfloat16 else "simple")


@pytest.mark.parametrize("Sq,Skv", [(20, 20), (20, 33), (33, 20)])
@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_mock_flash_cuda_noncausal_has_grad_fn(on_card, monkeypatch, Sq,
                                               Skv, impl):
    # seamless-m4t-medium's encoder self-attention (Sq = Skv) and its
    # cross-attention (Sq != Skv): non-causal at (64, 64) takes
    # FlashAttentionFn, its gradient autograd's of the plain forward
    q = _leaf(1, Sq, 4, 64)
    k, v = _leaf(1, Skv, 2, 64, seed=1), _leaf(1, Skv, 2, 64, seed=2)
    o = flash_attention(q, k, v, causal=False, impl=impl)
    assert o.grad_fn is not None and "FlashAttentionFn" in \
        type(o.grad_fn).__name__
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = attention_ref(q, k, v, causal=False)
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, torch.autograd.grad(ref, (q, k, v), do)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    fa_ops._kernel.check_backward(q, k, v, causal=False)
    for dtype in (torch.bfloat16, torch.float32):
        assert fa_ops._kernel.pick_backward_route(
            dtype, 64, 64, causal=False) == (
            "sm90" if dtype == torch.bfloat16 else "simple")


@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_mock_flash_cuda_mla_has_grad_fn(on_card, monkeypatch, impl):
    # deepseek-v3-671b's MLA in training: (192, 128), causal, with a
    # softmax scale of its own (passed through to both kernels, not
    # recomputed from D), takes FlashAttentionFn, its gradient autograd's
    # of the plain forward at that scale
    q, k = _leaf(1, 20, 4, 192), _leaf(1, 20, 4, 192, seed=1)
    v = _leaf(1, 20, 4, 128, seed=2)
    scale = 0.11
    o = flash_attention(q, k, v, causal=True, softmax_scale=scale,
                        impl=impl)
    assert o.grad_fn is not None and "FlashAttentionFn" in \
        type(o.grad_fn).__name__
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = attention_ref(q, k, v, causal=True, softmax_scale=scale)
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, torch.autograd.grad(ref, (q, k, v), do)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    fa_ops._kernel.check_backward(q, k, v)
    for dtype in (torch.bfloat16, torch.float32):
        assert fa_ops._kernel.pick_backward_route(dtype, 192, 128) == (
            "sm90" if dtype == torch.bfloat16 else "simple")


@pytest.mark.parametrize("form", [
    "causal Sq != Skv", "cut kv_len", "device position",
    "non-causal window", "non-causal (128, 128)", "non-causal (192, 128)"])
def test_mock_check_backward_raises_off_the_new_forms(on_card, monkeypatch,
                                                      form):
    # the forms around the two this slice adds, each still refused on the
    # mocked card: the backward kernels never see them
    D, Dv = {"non-causal (128, 128)": (128, 128),
             "non-causal (192, 128)": (192, 128)}.get(form, (64, 64))
    Skv = 33 if form == "causal Sq != Skv" else 20
    q = _leaf(1, 20, 4, D)
    k, v = _leaf(1, Skv, 2, D, seed=1), _leaf(1, Skv, 2, Dv, seed=2)
    kw = {"causal Sq != Skv": dict(causal=True),
          "cut kv_len": dict(causal=False, kv_len=10),
          "device position": dict(causal=False, q_start=torch.tensor(0)),
          "non-causal window": dict(causal=False, window=5),
          }.get(form, dict(causal=False))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    with pytest.raises(NotImplementedError):
        fa_ops._kernel.check_backward(q, k, v, **kw)


def test_moe_forced_with_own_routes_is_bit_equal():
    # chip_smoke.py's gradient check of the MoE runs the kernels' run with
    # the plain run's expert ids and gates from its own router; forced with
    # its own ids, a run gives the same bits as unforced, the router's
    # gradient included (remat "block": each block's forward runs twice,
    # and the forcing follows the calls in order)
    sys.path.insert(0, str(ROOT))
    from chip_smoke import RouteLog, leaf_paths
    arch = "granite-moe-3b-a800m"
    tm = build_model(tconfigs.smoke(arch))
    assert tm.cfg.remat == "block"
    tp = tree_map(lambda t: t.float(),
                  tm.init(torch.Generator().manual_seed(4), "cpu"))
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    batch = {"tokens": torch.from_numpy(_tokens(9, 2, SEQ[arch],
                                                tm.cfg.vocab_size))}

    def run(log):
        with log:
            loss, met = tm.loss_fn(tp, batch)
            return loss, met, torch.autograd.grad(loss, leaves)

    own = RouteLog()
    loss, met, grads = run(own)
    assert len(own.routes) == 2 * tm.cfg.n_layers
    forced = RouteLog(own.routes, own_gates=True)
    loss_f, met_f, grads_f = run(forced)
    assert forced.summary()["flips"] == 0
    assert torch.equal(loss, loss_f)
    assert torch.equal(met["aux_loss"], met_f["aux_loss"])
    router = leaf_paths(tp).index("/moe/mlp/router")
    assert float(grads[router].abs().max()) > 0
    for a, b in zip(grads, grads_f):
        assert torch.equal(a, b)


@pytest.mark.parametrize("window", [1, 4, 19])
@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_mock_flash_cuda_window_has_grad_fn(on_card, window, impl):
    # a window takes FlashAttentionFn too (Griffin's local attention), its
    # gradient autograd's of the plain forward with the same window
    q, k, v = _leaf(1, 20, 4, 16), _leaf(1, 20, 2, 16, seed=1), \
        _leaf(1, 20, 2, 16, seed=2)
    o = flash_attention(q, k, v, causal=True, window=window, impl=impl)
    assert o.grad_fn is not None and "FlashAttentionFn" in \
        type(o.grad_fn).__name__
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(o, (q, k, v), do)
    ref = attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(o, ref, rtol=1e-5, atol=1e-5)
    for g, w in zip(got, torch.autograd.grad(ref, (q, k, v), do)):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, causal=True, window=0, impl=impl)


def test_mock_recurrences_cuda_raise(on_card):
    # The name is kept from when this held the raise; it now holds that
    # WKV-6 under autograd on the mocked card is WKV6Fn and has a gradient:
    # with the backward's plain version as the kernel entry, autograd's of
    # the plain recurrence
    B, T, H, N = 1, 5, 2, 8
    r, k, v = (_leaf(B, T, H, N, seed=i) for i in range(3))
    w = torch.rand(B, T, H, N).requires_grad_(True)
    u = _leaf(H, N, seed=4)
    out, sT = rwkv6_ops.wkv6(r, k, v, w, u, impl="cuda")
    assert out.grad_fn is not None and "WKV6Fn" in \
        type(out.grad_fn).__name__
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad((out * do).sum() + sT.sum(), (r, k, v, w, u))
    o_r, sT_r = wkv6_ref(r, k, v, w, u)
    want = torch.autograd.grad((o_r * do).sum() + sT_r.sum(), (r, k, v, w, u))
    for g, w_ in zip(got, want):
        torch.testing.assert_close(g, w_, rtol=1e-5, atol=1e-5)
    # without autograd the (mock) kernel runs as before
    with torch.no_grad():
        assert rwkv6_ops.wkv6(r, k, v, w, u, impl="cuda")[0].grad_fn is None


@pytest.mark.parametrize("impl", ["cuda", "auto"])
def test_mock_rglru_cuda_has_grad_fn(on_card, impl):
    # the RG-LRU under autograd on the card is RGLRUFn: its gradient (the
    # backward's plain version as the kernel entry) is autograd's of the
    # plain recurrence
    B, T = 1, 5
    la = (-torch.rand(B, T, 6)).requires_grad_(True)
    gx, h0 = _leaf(B, T, 6, seed=1), _leaf(B, 6, seed=2)
    h, hT = rglru_ops.rglru(la, gx, h0, impl=impl)
    assert h.grad_fn is not None and "RGLRUFn" in type(h.grad_fn).__name__
    loss = (h * torch.arange(T * 6.0).reshape(1, T, 6)).sum() + hT.sum()
    got = torch.autograd.grad(loss, (la, gx, h0))
    hr, hTr = rglru_ref(la, gx, h0)
    loss_r = (hr * torch.arange(T * 6.0).reshape(1, T, 6)).sum() + hTr.sum()
    for g, w in zip(got, torch.autograd.grad(loss_r, (la, gx, h0))):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert rglru_ops.rglru(la, gx, impl=impl)[0].grad_fn is None


def test_mock_griffin_loss_grads_match_repro(on_card, monkeypatch):
    # the smoke Griffin on the mocked card: every RG-LRU and attention
    # gradient through RGLRUFn and the windowed FlashAttentionFn, whose
    # backward entries are counted
    arch = "recurrentgemma-2b"
    calls = {"rglru": 0, "flash": 0}
    fk = fa_ops._kernel

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(rglru_ops._kernel, "rglru_backward_cuda",
                        counted("rglru", rglru_ops._kernel
                                .rglru_backward_cuda))
    monkeypatch.setattr(fk, "flash_backward_cuda",
                        counted("flash", fk.flash_backward_cuda))
    windows = []
    check = fk.check_backward
    monkeypatch.setattr(fk, "check_backward", lambda *a, **kw: (
        windows.append(kw.get("window")), check(*a, **kw))[1])
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    cfg = tm.cfg
    S = SEQ[arch]
    assert cfg.local_window < S
    jp = jax.tree.map(lambda a: a.astype(f32),
                      live_leaves(arch, jm.init(jax.random.PRNGKey(1))))
    tp = tree_map(lambda t: t.float(),
                  params_from_numpy(tm.defs, _np32(jp), "cpu"))
    tokens = _tokens(7, 2, S, cfg.vocab_size)
    jg = jax.grad(lambda p: jm.loss_fn(
        p, {"tokens": jnp.asarray(tokens)}, impl="xla")[0])(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, _ = tm.loss_fn(tp, {"tokens": torch.from_numpy(tokens)})
    tg = torch.autograd.grad(tl, leaves)
    n_attn = cfg.n_layers // len(cfg.block_pattern) * \
        cfg.block_pattern.count("attn")
    n_rec = cfg.n_layers - n_attn
    assert calls == {"rglru": n_rec, "flash": n_attn}
    assert windows and set(windows) == {cfg.local_window}
    jl = jax.tree.leaves(jg)
    assert len(jl) == len(tg)
    for a, b in zip(jl, tg):
        a = np.asarray(a)
        assert b.shape == a.shape
        scale = max(float(np.abs(a).max()), 1e-12)
        err = float(np.abs(b.numpy() - a).max()) / scale
        assert err <= 1e-4, (a.shape, err)
    assert max(float(np.abs(np.asarray(a)).max()) for a in jl) > 1e-3


def test_mock_arena_cuda_raise(on_card):
    arena = torch.zeros(64)
    x = _leaf(8)
    for fn in (arena_ops.arena_write, arena_ops.arena_accum,
               arena_ops.arena_chain_write):
        with pytest.raises(NotImplementedError, match="backward"):
            fn(arena, x, 4, impl="cuda")
    with pytest.raises(NotImplementedError, match="backward"):
        arena_ops.arena_read(arena.clone().requires_grad_(True), 4, 8,
                             impl="cuda")
    out = arena_ops.arena_write(arena, x.detach(), 4, impl="cuda")
    assert torch.equal(out[4:12], x.detach())


def test_recurrent_loss_trains_on_cpu():
    # on the CPU the recurrent families have gradients (the plain
    # versions under autograd); on the card they go through their
    # backward kernels (RGLRUFn, WKV6Fn)
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        tm = build_model(tconfigs.smoke(arch))
        tp = tm.init(torch.Generator().manual_seed(0), "cpu")
        for p in tree_leaves(tp):
            p.requires_grad_(True)
        loss, _ = tm.loss_fn(tp, {"tokens": torch.from_numpy(
            _tokens(2, 1, 8, tm.cfg.vocab_size))})
        assert loss.grad_fn is not None
