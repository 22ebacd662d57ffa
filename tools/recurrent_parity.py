"""How far the port's recurrent LMs sit from the JAX package, and how noisy
the JAX package is in bf16 itself, on the smoke configs.

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/recurrent_parity.py

For ``rwkv6-7b-smoke`` and ``recurrentgemma-smoke``, with the recurrent
mixing leaves filled by ``tests/test_torch_recurrent_models.live_leaves``
and the same prompt (batch 2) in both packages, prefill + 4 decode steps
fed the JAX package's bf16 greedy tokens.  Prints the max abs logit
difference of:

  * the port vs ``repro`` in f32 and in bf16;
  * ``repro`` in bf16 vs ``repro`` in f32 (the reference's own bf16 gap);
  * one ``repro`` block in bf16 under ``jax.jit`` vs eager (RWKV-6's first
    layer on a seeded (2, 8, 64) input).

CPU only; seconds.  The numbers back the bf16 tolerances of
``tests/test_torch_recurrent_models.py`` and ``tests/test_torch_serve.py``.
"""

from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.zoo import build_model as jax_build  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.models.zoo import build_model  # noqa: E402
from test_torch_recurrent_models import (  # noqa: E402
    PROMPT,
    _run_jax,
    _run_port,
    _to_port,
    live_leaves,
)


def logits_gaps(arch):
    jm = jax_build(jconfigs.smoke(arch))
    tm = build_model(tconfigs.smoke(arch))
    jp = live_leaves(arch, jm.init(jax.random.PRNGKey(0)))
    tp = _to_port(tm, jp)
    P = PROMPT[arch]
    prompt = np.random.default_rng(5).integers(
        0, jm.cfg.vocab_size, (2, P)).astype(np.int32)
    f32 = lambda t: jax.tree.map(lambda a: a.astype(jnp.float32), t)
    want16, _ = _run_jax(jm, jp, jm.init_cache(2, P + 5), prompt, P)
    got16, _ = _run_port(tm, tp, tm.init_cache(2, P + 5, "cpu"), prompt, P,
                         want16)
    want32, _ = _run_jax(jm, f32(jp), f32(jm.init_cache(2, P + 5)), prompt,
                         P, want16)
    got32, _ = _run_port(
        tm, tree_map(lambda t: t.float(), tp),
        tree_map(lambda t: t.float(), tm.init_cache(2, P + 5, "cpu")),
        prompt, P, want16)
    gap = lambda xs, ys: max(float(np.abs(a - b).max())
                             for a, b in zip(xs, ys))
    return gap(got32, want32), gap(got16, want16), gap(want16, want32)


def rwkv_block_jit_vs_eager():
    arch = "rwkv6-7b"
    cfg = jconfigs.smoke(arch)
    jm = jax_build(cfg)
    jp = live_leaves(arch, jm.init(jax.random.PRNGKey(0)))
    p0 = jax.tree.map(lambda a: a[0], jp["blocks"])
    x = jnp.asarray(np.random.default_rng(0).standard_normal((2, 8, 64)),
                    jnp.bfloat16)
    ctx = JL.Ctx(cfg=cfg, impl="xla")
    cache = {"tm_x": jnp.zeros((2, 64), jnp.bfloat16),
             "cm_x": jnp.zeros((2, 64), jnp.bfloat16),
             "wkv": jnp.zeros((2, 4, 16, 16), jnp.float32)}
    eager = JB.rwkv6_block_apply(p0, x, ctx, cache)[0]
    jitted = jax.jit(lambda p, x, c: JB.rwkv6_block_apply(p, x, ctx, c)[0])(
        p0, x, cache)
    return float(jnp.abs(eager.astype(jnp.float32)
                         - jitted.astype(jnp.float32)).max())


def main():
    torch.set_num_threads(1)
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        e32, e16, own = logits_gaps(arch)
        print(f"{arch}-smoke: port vs repro logits f32 {e32:.3e}, bf16 "
              f"{e16:.3e}; repro bf16 vs repro f32 {own:.3e}")
    print(f"rwkv6-7b-smoke layer 0, bf16: repro jit vs eager max abs diff "
          f"{rwkv_block_jit_vs_eager():.3e}")


if __name__ == "__main__":
    main()
