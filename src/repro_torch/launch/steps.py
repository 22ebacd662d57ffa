"""Train and serving steps of the port.

  * ``make_train_step(model, opt, rules)``  (state, batch) -> (state, metrics)
  * ``CapturedTrainStep(model, opt, **kw)``  the same in one CUDA graph
  * ``make_optimizer(cfg, **kw)``        the config's optimizer
  * ``make_prefill_step(model, rules)``  (params, cache, batch) -> (logits, cache)
  * ``make_decode_step(model, rules)``   (params, cache, tokens, t) -> (logits, cache)
  * ``make_captured_decode_step(model, params, smax=...)``
        (token, t) -> logits: the decode step in one CUDA graph
  * ``BatchedDecodeStep(model, params, bucket=..., smax=...)``
        (tokens, ts) -> (logits, next tokens): the decode step of ``bucket``
        rows, each at its own position, eagerly;
        ``CapturedBatchedDecodeStep`` the same in one CUDA graph
  * ``init_batched_cache(model, bucket, smax)`` / ``batch_axes(model, smax)``
        the batched steps' decode-state tree, and each leaf's batch axis

Their default is ``impl="auto"``: the CUDA flash-attention kernels for
tensors on the card (forward and, in the train step, the backward), the
plain PyTorch versions for tensors on the CPU (``repro``'s steps default to
its ``"xla"`` version instead).

Sharding ``rules`` (``ShardingRules`` on a ``DeviceMesh``, e.g.
``launch.mesh.rules_for_mesh``) run the train, prefill and decode steps on
DTensors: parameters and state placed by ``models.params.
distribute_params``, activations pinned by ``parallel.sharding.
shard_act``, kernels on local shards (``kernels/_local.py``).  Under rules
a step runs eagerly: the captured steps raise (ROADMAP A8).

The abstract input specs -- ``batch_specs``, ``state_specs``,
``cache_specs``, ``train_input_specs``, ``serve_input_specs`` and
``out_shardings_for`` -- are ``repro``'s: ``AbstractLeaf`` trees (shape,
dtype, sharding; no storage) on a mesh, a live one or a ``MeshShape``.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.capture import CapturedCall
from repro_torch.core.executor import resolve_device
from repro_torch.kernels.flash_attention.kernel import check_pairs
from repro_torch.kernels.optim.ops import global_norm, placed_like
from repro_torch.models.params import (
    AbstractLeaf,
    abstract_params,
    distribute_params,
    is_def,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_unflatten,
    zeros_from_defs,
)
from repro_torch.models.zoo import Model
from repro_torch.optim import OPTIMIZERS
from repro_torch.optim.schedule import cosine_warmup
from repro_torch.parallel.sharding import (
    NamedSharding,
    act_spec,
    check_rules,
    full,
    sharded,
)


def make_train_step(model: Model, opt, rules=None, *, impl: str = "auto",
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_clip: float = 1.0):
    """``(state, batch) -> (state, metrics)``, the counterpart of
    ``repro``'s ``make_train_step``: the loss and its gradient by autograd
    (``model.loss_fn``; on the card the attention's gradient is the
    backward kernel), a global-norm clip (the norm in f32 over every
    gradient leaf in leaf order, each gradient scaled in its own dtype),
    ``cosine_warmup`` of the optimizer's step, and ``opt.update``.  On the
    card the norm's squared sums are one launch of ``sumsq_kernel`` and
    the scaling and the update one of ``adamw_update_kernel`` (AdamW) or
    three of ``csrc/adafactor.cu`` (Adafactor; ``kernels/optim``);
    ``impl="torch"`` and the CPU take the plain ops.

    ``state`` is ``{"params", "opt"}``.  The update writes the new
    parameters and optimizer state into the given tensors (the
    counterpart of ``repro``'s donated state) and returns that state; the
    parameter leaves are made to require a gradient.  ``metrics`` holds
    ``loss``, ``lm_loss`` (and the model's other metrics), ``grad_norm``
    and ``lr``, each a 0-d tensor on the state's device: the step reads
    nothing back to the host.

    Under ``rules`` the state is DTensors (``distribute_params`` of
    ``model.defs`` and ``opt.state_defs``), the gradients are placed as
    their parameters (``placed_like``: a ``Partial`` gradient is reduced
    before the norm squares it), each leaf's squared sum is a ``Partial``
    sum over its shards and the norm their sum in leaf order, reduced
    across the mesh; the metrics are returned whole (plain tensors).
    Rules without a mesh raise here."""
    check_rules(rules)

    def train_step(state, batch):
        params = state["params"]
        leaves, treedef = tree_flatten(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad(), sharded(rules):
            loss, metrics = model.loss_fn(params, batch, impl=impl,
                                          rules=rules)
            grads = torch.autograd.grad(loss, leaves)
        with sharded(rules):
            if rules is not None:
                # a gradient autograd hands back Partial (a parameter
                # replicated over a mesh axis that shards the batch) is
                # reduced once, here: the norm squares it, and the norm
                # and the update read the same gradients
                grads = placed_like(grads, leaves)
            metrics = {k: full(v.detach()) for k, v in metrics.items()}
            # global-norm clip: the norm over every leaf in leaf order; the
            # optimizer's update scales each gradient in its own dtype
            # first (on the card: the squared sums one launch, the scaling
            # and the update AdamW's one, Adafactor's three)
            gnorm = global_norm(grads,
                                impl=impl if opt.fused_clip else "torch")
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                                max=1.0)
            lr = cosine_warmup(state["opt"]["step"], peak_lr=peak_lr,
                               warmup=warmup, total=total_steps)
            new_params, new_opt = opt.update(
                tree_unflatten(treedef, grads), state["opt"], params,
                lr_scale=lr / opt.lr, clip_scale=scale, impl=impl)
        metrics.update(grad_norm=full(gnorm), lr=full(lr))
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def make_optimizer(cfg: ArchConfig, **kw):
    return OPTIMIZERS[cfg.optimizer](**kw)


def make_prefill_step(model: Model, rules=None, *, impl: str = "auto"):
    def prefill_step(params, cache, batch):
        return model.prefill_fn(params, cache, batch, impl=impl, rules=rules)

    return prefill_step


def make_decode_step(model: Model, rules=None, *, impl: str = "auto"):
    def decode_step(params, cache, tokens, t):
        return model.decode_fn(params, cache, tokens, t, impl=impl,
                               rules=rules)

    return decode_step


def _no_capture_under(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "a captured step under sharding rules is not ported (ROADMAP "
            "A8): DTensor's redistributions are collectives and host "
            "decisions the graph would freeze; decode and train eagerly "
            "under rules")


class CapturedTrainStep:
    """The train step captured in one CUDA graph: the counterpart of
    ``repro``'s ``jax.jit(make_train_step(...), donate_argnums=(0,))``
    (``src/repro/launch/train.py:65``), whose one trace serves every step.

    Static tensors take the place of the traced and donated arguments:
    :attr:`state` (the train state, updated in place by every step: the
    parameters, the optimizer's moments and its ``step``, which the
    schedule reads on the device), :attr:`batch` (``tokens``, and
    ``frames`` for the encoder-decoder: each written by one copy a step)
    and the metrics the capture returned (``loss``, ``lm_loss``, ...,
    ``grad_norm``, ``lr``: 0-d tensors that every step overwrites, read by
    the caller before the next call).

    ``step(state, batch)`` returns ``(step.state, metrics)``.  The first
    call adopts ``state`` as its own, copies the batch in and runs the
    step eagerly (the capture's warm-up, which is that call's step), frees
    the blocks the warm-up left in the allocator's cache, so that the
    graph's pool holds one step's peak and not two, and captures the step
    (:class:`~repro_torch.core.capture.CapturedCall`, which keeps the
    kernels' launch counts true); every later call is one replay.  A call
    handed a state whose leaves are not its own (``checkpoint.restore``
    returns new tensors, and ``runtime/fault.py`` restores after a failed
    step) copies them into its own leaves first.  The card only: raises on
    the CPU, and under sharding ``rules`` (ROADMAP A8).
    """

    def __init__(self, model: Model, opt, rules=None, *, impl: str = "auto",
                 device=None, **kw):
        _no_capture_under(rules)
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a captured train step needs a CUDA device, "
                             f"got {self.device}; train eagerly on the CPU")
        self._step = make_train_step(model, opt, None, impl=impl, **kw)
        self.state = None
        self.batch = None
        self.call: CapturedCall | None = None

    def _write(self, batch) -> None:
        if set(batch) != set(self.batch):
            raise ValueError(f"a batch of {sorted(batch)}, the step was "
                             f"captured with {sorted(self.batch)}")
        for k, v in batch.items():
            self.batch[k].copy_(torch.as_tensor(v))

    def _adopt(self, state) -> None:
        own, got = tree_leaves(self.state), tree_leaves(state)
        if len(own) != len(got):
            raise ValueError(f"a state of {len(got)} leaves, the step "
                             f"holds {len(own)}")
        with torch.no_grad():
            for o, g in zip(own, got):
                if o is not g:
                    o.copy_(g)

    def __call__(self, state, batch):
        if self.call is None:
            self.state = state
            self.batch = {k: torch.empty(tuple(v.shape),
                                         dtype=torch.as_tensor(v).dtype,
                                         device=self.device)
                          for k, v in batch.items()}
            self._write(batch)
            self.call = CapturedCall(
                lambda: self._step(self.state, self.batch)[1], self.device,
                release=True)
            return self.state, self.call.first
        self._adopt(state)
        self._write(batch)
        return self.state, self.call.replay()


class CapturedDecodeStep:
    """One batch-1 decode step captured in a CUDA graph that serves every
    position: the counterpart of ``repro``'s ``jax.jit(make_decode_step(
    ...))``, whose one trace serves every position because ``t`` is traced.

    Static tensors take the place of the traced arguments: :attr:`cache`
    (the decode-state tree at ``(1, smax)``, updated in place by every
    step), the token and the position (one int64 pair on the card, the
    position a 0-d tensor that the step reads on the device:
    ``models.zoo``'s ``decode_fn``), and the logits the capture made.  A
    caller writes a request's state into :attr:`cache` (e.g.
    ``unpack_decode_state(..., out=step.cache)``), calls ``step(token,
    t)``, reads the logits before the next call (which overwrites them),
    and takes the state back from :attr:`cache`.

    The first call runs the step eagerly (the capture's warm-up, which is
    that call's step) and captures it; every later call is one replay
    (:class:`~repro_torch.core.capture.CapturedCall`, which keeps the
    kernels' launch counts true).  The card only: raises on the CPU, and
    under sharding ``rules`` (ROADMAP A8).
    """

    def __init__(self, model: Model, params, *, smax: int, rules=None,
                 impl: str = "auto", device=None):
        _no_capture_under(rules)
        self.device = resolve_device(device)
        if self.device.type != "cuda":
            raise ValueError(f"a captured decode step needs a CUDA device, "
                             f"got {self.device}; decode eagerly on the CPU")
        self.params = params
        self.cache = model.init_cache(1, smax, self.device)
        self._step = make_decode_step(model, rules, impl=impl)
        # token and position, written by one copy a step from a pinned
        # host pair, which is not rewritten before the last copy has run
        self._host = torch.zeros(2, dtype=torch.long, pin_memory=True)
        self._copied = torch.cuda.Event()
        self._io = torch.zeros(2, dtype=torch.long, device=self.device)
        self.tokens = self._io[:1].view(1, 1)
        self.t = self._io[1]
        self.call: CapturedCall | None = None

    def __call__(self, token: int, t: int) -> torch.Tensor:
        """Decode ``token`` at position ``t`` against :attr:`cache`;
        returns the ``(1, vocab)`` f32 logits."""
        self._copied.synchronize()
        self._host[0], self._host[1] = int(token), int(t)
        self._io.copy_(self._host, non_blocking=True)
        self._copied.record()
        if self.call is None:
            self.call = CapturedCall(
                lambda: self._step(self.params, self.cache, self.tokens,
                                   self.t)[0], self.device)
            return self.call.first
        return self.call.replay()


def batch_axes(model: Model, smax: int) -> list[int]:
    """Each decode-state leaf's batch axis in a batched step's tree, in
    leaf order: where its ``ParamDef`` names ``"batch"``, and 0 for a 0-d
    leaf (a request's scalar, the encoder-decoder's ``enc_len``), which the
    batched tree holds as a ``(bucket,)`` leaf (:func:`init_batched_cache`).
    A batch-1 state's leaf is its row of the batched leaf: ``narrow(axis,
    row, 1)``, viewed as the batch-1 leaf's shape."""
    return [d.logical.index("batch") if d.shape else 0
            for d in tree_leaves(model.make_cache_defs(1, smax),
                                 is_leaf=is_def)]


def batched_cache_defs(model: Model, bucket: int, smax: int):
    """The decode-state definitions of ``bucket`` rows: ``model.
    make_cache_defs(bucket, smax)``, with each 0-d leaf a ``(bucket,)``
    one, a value per row (``repro``'s ``jax.vmap`` of the batch-1 step
    over requests maps the 0-d ``enc_len`` to one per row)."""
    return tree_map(
        lambda d: d if d.shape else dataclasses.replace(
            d, shape=(bucket,), logical=("batch",)),
        model.make_cache_defs(bucket, smax), is_leaf=is_def)


def init_batched_cache(model: Model, bucket: int, smax: int, device=None):
    """The zeroed decode state of ``bucket`` rows
    (:func:`batched_cache_defs`)."""
    return zeros_from_defs(batched_cache_defs(model, bucket, smax), device)


def place_state(tree, defs, rules):
    """A decode state ``tree`` (laid out as ``defs``) for a step under
    ``rules``: DTensors at the cache specs (``distribute_params``; each
    rank keeps its shard of the leaf it holds), or ``tree`` itself without
    rules."""
    if rules is None:
        return tree
    return distribute_params(tree, defs, rules, rules.mesh)


class BatchedDecodeStep:
    """The decode step of ``bucket`` rows, each at its own position, run
    eagerly: the CPU's batched step (the card's is
    :class:`CapturedBatchedDecodeStep`, which keeps this interface).

    :attr:`cache` is the decode-state tree at ``(bucket, smax)``
    (:func:`init_batched_cache`; each leaf's batch axis by
    :func:`batch_axes`), updated in place by every step.
    ``step(tokens, ts)`` decodes ``tokens[b]`` at position
    ``ts[b]`` against row ``b`` of :attr:`cache` and returns the ``(bucket,
    vocab)`` f32 logits and their ``(bucket,)`` argmax.  Under ``rules``
    :attr:`cache` stays a tree of whole tensors, placed on the mesh for
    each step (:func:`place_state`) and written back after it.
    """

    def __init__(self, model: Model, params, *, bucket: int, smax: int,
                 rules=None, impl: str = "auto", device=None):
        self.device = resolve_device(device)
        self.bucket = bucket
        self.params = params
        self.cache = init_batched_cache(model, bucket, smax, self.device)
        self.rules = rules
        self._defs = batched_cache_defs(model, bucket, smax)
        self._step = make_decode_step(model, rules, impl=impl)

    def _run(self, tokens, t):
        if self.rules is None:
            logits = self._step(self.params, self.cache, tokens, t)[0]
            return logits, torch.argmax(logits, -1)
        # under rules the state is placed for the step and written back
        # whole: the server copies rows in and out of the plain tree
        cache = place_state(self.cache, self._defs, self.rules)
        logits = full(self._step(self.params, cache, tokens, t)[0])
        for whole, part in zip(tree_leaves(self.cache), tree_leaves(cache)):
            whole.copy_(full(part))
        return logits, torch.argmax(logits, -1)

    def _check(self, tokens, ts) -> None:
        if len(tokens) != self.bucket or len(ts) != self.bucket:
            raise ValueError(f"{len(tokens)} tokens and {len(ts)} positions "
                             f"for a step of {self.bucket} rows")

    def __call__(self, tokens, ts) -> tuple[torch.Tensor, torch.Tensor]:
        self._check(tokens, ts)
        return self._run(
            torch.as_tensor(tokens, dtype=torch.long,
                            device=self.device)[:, None],
            torch.as_tensor(ts, dtype=torch.long, device=self.device))


class CapturedBatchedDecodeStep(BatchedDecodeStep):
    """:class:`BatchedDecodeStep` captured in one CUDA graph: the
    counterpart of ``repro``'s ``jax.jit(step, donate_argnums=(1,))`` per
    batch bucket, whose step is ``jax.vmap`` of the decode over the rows
    (``launch/serve.py``).

    The contract is :class:`CapturedDecodeStep`'s, at ``bucket`` rows: the
    tokens ``(bucket, 1)`` and the positions ``(bucket,)`` are written by
    one copy a step from a pinned host buffer, which is not rewritten
    before the last copy has run; the logits and their argmax are computed
    inside the graph, so that a caller reads the next tokens of every row
    with one device-to-host copy, and are overwritten by the next call.
    The split-K decode reads each row's position on the device.  The first
    call is the capture's warm-up; every later call is one replay.  The
    card only: raises on the CPU.
    """

    def __init__(self, model: Model, params, *, bucket: int, smax: int,
                 rules=None, impl: str = "auto", device=None):
        _no_capture_under(rules)
        device = resolve_device(device)
        if device.type != "cuda":
            raise ValueError(f"a captured decode step needs a CUDA device, "
                             f"got {device}; decode eagerly on the CPU")
        if not model.cfg.attn_free:
            cfg = model.cfg
            check_pairs(bucket, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads)
        super().__init__(model, params, bucket=bucket, smax=smax,
                         rules=rules, impl=impl, device=device)
        self._host = torch.zeros(2 * bucket, dtype=torch.long,
                                 pin_memory=True)
        self._copied = torch.cuda.Event()
        self._io = torch.zeros(2 * bucket, dtype=torch.long,
                               device=self.device)
        self.tokens = self._io[:bucket].view(bucket, 1)
        self.t = self._io[bucket:]
        self.call: CapturedCall | None = None

    def __call__(self, tokens, ts) -> tuple[torch.Tensor, torch.Tensor]:
        self._check(tokens, ts)
        self._copied.synchronize()
        self._host[:self.bucket] = torch.as_tensor(tokens, dtype=torch.long)
        self._host[self.bucket:] = torch.as_tensor(ts, dtype=torch.long)
        self._io.copy_(self._host, non_blocking=True)
        self._copied.record()
        if self.call is None:
            self.call = CapturedCall(lambda: self._run(self.tokens, self.t),
                                     self.device)
            return self.call.first
        return self.call.replay()


def make_captured_decode_step(model: Model, params, *, smax: int,
                              rules=None, impl: str = "auto",
                              device=None) -> CapturedDecodeStep:
    """The decode step of ``model`` with ``params`` for a cache of ``smax``
    positions, captured in one CUDA graph on ``device`` (``None``: the
    card): see :class:`CapturedDecodeStep`."""
    return CapturedDecodeStep(model, params, smax=smax, rules=rules,
                              impl=impl, device=device)


# --------------------------------------------------------------------- specs

def _sds(shape, dtype, mesh, spec) -> AbstractLeaf:
    return AbstractLeaf(tuple(shape), dtype, NamedSharding(mesh, spec))


def batch_specs(cfg: ArchConfig, shape, mesh, rules, *,
                seq_len: int | None = None):
    """Abstract train/prefill batch: tokens (+ frames for enc-dec)."""
    S = seq_len if seq_len is not None else shape.seq_len
    Bz = shape.global_batch
    bspec = act_spec(rules, "bn")
    out = {}
    if cfg.is_encoder_decoder:
        Se = Sd = S // 2
        out["tokens"] = _sds((Bz, Sd), torch.int32, mesh, bspec)
        out["frames"] = _sds((Bz, Se, cfg.d_model), torch.float32, mesh,
                             act_spec(rules, "bnn"))
    else:
        out["tokens"] = _sds((Bz, S), torch.int32, mesh, bspec)
    return out


def state_specs(model: Model, opt, mesh, rules):
    """Abstract ``{params, opt}`` train state."""
    return {
        "params": abstract_params(model.defs, rules, mesh),
        "opt": abstract_params(opt.state_defs(model.defs), rules, mesh),
    }


def cache_specs(model: Model, mesh, rules, bsz: int, smax: int):
    return abstract_params(model.make_cache_defs(bsz, smax), rules, mesh)


def train_input_specs(model: Model, opt, shape, mesh, rules):
    return (
        state_specs(model, opt, mesh, rules),
        batch_specs(model.cfg, shape, mesh, rules),
    )


def serve_input_specs(model: Model, shape, mesh, rules, *, kind: str):
    """kind: 'prefill' (full-seq forward filling the cache) or 'decode'
    (one token against a seq_len-deep cache)."""
    cfg = model.cfg
    Bz, S = shape.global_batch, shape.seq_len
    params = abstract_params(model.defs, rules, mesh)
    cache = cache_specs(model, mesh, rules, Bz, S)
    bspec = act_spec(rules, "bn")
    if kind == "prefill":
        batch = batch_specs(cfg, shape, mesh, rules)
        return params, cache, batch
    tokens = _sds((Bz, 1), torch.int32, mesh, bspec)
    t = AbstractLeaf((), torch.int32, None)
    return params, cache, tokens, t


def out_shardings_for(tree_specs):
    """The :class:`NamedSharding` of every leaf of an abstract tree (None
    where it has none)."""
    return tree_map(lambda s: getattr(s, "sharding", None), tree_specs)
