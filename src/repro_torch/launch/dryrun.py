"""Multi-pod dry-run: count every (arch x shape x mesh) cell on fake
tensors.  The counterpart of ``repro.launch.dryrun``.

For each cell this module:
  1. starts a ``fake`` process group of 256 ranks (512 across pods) in
     this process, at rank 0, and builds ``launch.mesh.
     make_production_mesh`` on it (16 x 16, 2 x 16 x 16): no rank but this
     one exists and no collective moves a byte;
  2. makes the abstract inputs (``launch.steps.train_input_specs`` /
     ``serve_input_specs``) fake DTensors under a ``FakeTensorMode``, each
     leaf rank 0's shard at its spec's placements: nothing is allocated;
     the decode step runs at the host position ``seq_len - 1``, the step
     that reads the whole cache;
  3. runs the train, prefill or decode step of ``launch/steps.py`` once
     under :class:`CostMode`, which counts every op on a local (non-
     DTensor) tensor: products' FLOPs by ``torch.utils.flop_counter``'s
     formulas, in two classes (``tensor``: bf16/f16 products at 989
     TFLOP/s; ``cuda_core``: f32 products and the recurrence kernels' f32
     work at 67 TFLOP/s), each non-view op's input plus output bytes (the
     traffic of unfused eager execution), the collectives by the bytes of
     their result (``repro``'s definition), the kernels' ``repro_torch``
     ops by their own cost (``kernels/costs.py``) as one launch each, and
     the peak of the live local storages made during the step;
  4. derives the three roofline terms at H100 constants and writes one
     JSON per cell into --out, with ``repro``'s keys.

Where a key names an XLA stage it holds the port's own: ``lower_s`` is
the seconds spent placing the inputs, ``compile_s`` the seconds of the
fake step; ``cost_analysis`` holds ``"flops"`` and ``"bytes accessed"``
(and the two FLOP classes), ``memory_analysis`` the argument, output,
temporary and peak bytes of one device (rank 0).  The port has no probes:
its layers run as Python loops, and each recurrence kernel's cost covers
its whole T.

The mesh's device type follows the port's rule for entry points: ``cuda``
unless asked (``--device cpu``).  On ``cuda`` the kernel wrappers route
the fake tensors as they route real ones, so the counts are those of the
card's routes, DTensor issues NCCL's all-to-all, and a train cell whose
kernel has no backward (``kernels._grad.NoBackward``: head dims outside
``BACKWARD_HEAD_DIMS``, attention outside the backward's form) is written
as not applicable, with the error's text; Griffin's cells count
``rglru_backward`` and the windowed ``flash_backward`` (256, 256), rwkv6's
``wkv6_backward``.  It needs a PyTorch built with CUDA and allocates
nothing on the card and launches nothing.  On ``cpu`` the count is of the
CPU path: the plain versions of the kernels, and DTensor's all-gather +
chunk where the card would run an all-to-all.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out artifacts/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves

import repro_torch.configs as configs
from repro_torch.configs.base import SHAPES
from repro_torch.kernels import costs
from repro_torch.kernels._grad import NoBackward
from repro_torch.launch.mesh import (
    make_production_mesh,
    production_shape,
    rules_for_mesh,
)
from repro_torch.launch.steps import (
    make_decode_step,
    make_optimizer,
    make_prefill_step,
    make_train_step,
    serve_input_specs,
    train_input_specs,
)
from repro_torch.models.params import is_abstract, tree_map
from repro_torch.models.zoo import build_model
from repro_torch.parallel.sharding import local_extent

# ----------------------------------------------------------------- constants
PEAK_FLOPS = costs.BF16_FLOP_PER_S         # dense bf16, tensor cores
CUDA_CORE_FLOPS = costs.F32_FLOP_PER_S     # f32 outside the tensor cores
HBM_BW = costs.HBM_BYTES_PER_S
# B/s per GPU across nodes: one 400 Gb/s NIC a GPU.  Every 16-rank axis of
# the production mesh spans at least two 8-GPU NVLink domains, so each of
# its collectives crosses the network at this rate.
LINK_BW = 50e9

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
#: collective ops (by their name without overload) -> ``repro``'s type
_COLLECTIVE_TYPE = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")
#: ops that return a view without declaring it in their schema
_UNDECLARED_VIEWS = ("_unsafe_view", "alias", "lift_fresh")

_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_DTENSOR_DIR = os.path.join(_TORCH_DIR, "distributed", "tensor") + os.sep
# torch's own code, and the pytree library its tree maps may call into
_LIBRARY_DIRS = (_TORCH_DIR, os.path.join(
    os.path.dirname(os.path.dirname(torch.__file__)), "optree") + os.sep)


def _fake_store():
    # private API: torch's in-process store for a "fake" process group,
    # whose collectives return at once without moving data
    from torch.testing._internal.distributed.fake_pg import FakeStore
    return FakeStore()


@contextlib.contextmanager
def fake_world(n_ranks: int):
    """A ``fake`` process group of ``n_ranks`` ranks in this process, at
    rank 0, destroyed on exit."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already started; the dry-run "
                           "starts its own fake one")
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ the counting

def _caller_kind() -> str:
    """Who issued the op being dispatched, from the Python frames above
    it: ``"shadow"`` where DTensor runs an op at the global shape only to
    learn its output's metadata (``_propagate_tensor_meta*``), ``"dtensor"``
    where DTensor's own code issues it (a redistribution's local work, or
    its placement arithmetic), else ``"user"`` (the model, the step, a
    kernel wrapper; an op DTensor dispatches to the local shards is called
    from C++ and so is the user's)."""
    f = sys._getframe(2)
    kind = None
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(_DTENSOR_DIR):
            if f.f_code.co_name.startswith("_propagate_tensor_meta"):
                return "shadow"
            kind = kind or "dtensor"
        elif not name.startswith(_LIBRARY_DIRS):
            return kind or "user"
        f = f.f_back
    return kind or "user"


def _is_view(func) -> bool:
    return func._overloadpacket.__name__ in _UNDECLARED_VIEWS or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


def _tensors(tree) -> list:
    return [t for t in _pytree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class CostMode(TorchDispatchMode):
    """Counts what a step does on this rank's local tensors.

    An op on a DTensor is handed back to DTensor (``NotImplemented``),
    whose local ops then reach this mode: each is counted once, at its
    local shape.  Per local op: FLOPs by ``torch.utils.flop_counter``'s
    registered formula, in the class of its first tensor input's dtype
    (bf16/f16: ``tensor``, else ``cuda_core``); bytes, the input plus
    output bytes of every op that returns a tensor and is not a view; a
    ``repro_torch`` kernel op by its cost (``costs.KERNEL_OPS``), one
    launch of its kernel; a collective by the bytes of its result, under
    ``repro``'s type names (another type under its own name;
    ``wait_tensor`` not at all).  Peak memory: the largest sum of the live
    storages made by counted ops, above the arguments (whose storages
    :meth:`arguments` records).

    With ``fake`` (the dry-run's ``FakeTensorMode``, entered below this
    mode) DTensor's placement arithmetic -- an op its own code issues on
    host tensors that are not fake -- runs outside the fake mode and is
    not counted; DTensor's metadata ops at the global shape are never
    counted."""

    def __init__(self, fake=None):
        super().__init__()
        self.fake = fake
        self.flops = {"tensor": 0, "cuda_core": 0}
        self.bytes = 0
        self.kernels: dict = {}
        self.coll_bytes = dict.fromkeys(_COLLECTIVES, 0)
        self.coll_count = dict.fromkeys(_COLLECTIVES, 0)
        self.live = self.peak = 0
        self._args: set = set()
        self._made: set = set()

    # ---------------------------------------------------------- storages
    @staticmethod
    def _key(t) -> int:
        return t.untyped_storage()._cdata

    def arguments(self, tree) -> int:
        """Record the storages of the step's arguments (a DTensor's local
        shard); returns their bytes."""
        total = 0
        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            k = self._key(t)
            if k not in self._args:
                self._args.add(k)
                total += t.untyped_storage().nbytes()
        return total

    def made_bytes(self, tree) -> int:
        """Bytes of the storages in ``tree`` that the step made."""
        seen, total = set(), 0
        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            k = self._key(t)
            if k in self._made and k not in seen:
                seen.add(k)
                total += t.untyped_storage().nbytes()
        return total

    def _gone(self, key: int, n: int) -> None:
        self._made.discard(key)
        self.live -= n

    def _track(self, out) -> None:
        for t in _tensors(out):
            s = t.untyped_storage()
            k = s._cdata
            if k in self._args or k in self._made:
                continue
            n = s.nbytes()
            self._made.add(k)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(s, self._gone, k, n)

    # ---------------------------------------------------------- dispatch
    def _host_only(self, args, kwargs) -> bool:
        ts = _tensors((args, kwargs))
        if any(isinstance(t, torch._subclasses.fake_tensor.FakeTensor)
               or t.device.type != "cpu" for t in ts):
            return False
        dev = kwargs.get("device")
        return dev is None or torch.device(dev).type == "cpu"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(isinstance(t, DTensor) for t in _tensors((args, kwargs))):
            return NotImplemented
        kind = _caller_kind()
        if kind == "shadow":
            return func(*args, **kwargs)
        if kind == "dtensor" and self.fake is not None \
                and self._host_only(args, kwargs):
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        packet = func._overloadpacket
        name = packet.__name__
        if not outs and packet not in costs.KERNEL_OPS:
            # a metadata query (a kernel op may write into its arguments
            # alone, as the optimizer's update does)
            return
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if name == "wait_tensor":
                return
            kind = _COLLECTIVE_TYPE.get(name, name)
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) \
                + sum(_nbytes(t) for t in outs)
            self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
            self._track(out)
            return
        if packet in costs.KERNEL_OPS:
            key, cost = costs.KERNEL_OPS[packet]
            flops, nbytes, cls = cost(*args, **kwargs)
            k = self.kernels.setdefault(name, dict(
                launches_key=key, launches=0, flops=0, bytes=0,
                flop_class=cls))
            k["launches"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
            self.flops[cls] += flops
            self.bytes += nbytes
            self._track(out)
            return
        if _is_view(func):
            return
        from torch.utils.flop_counter import flop_registry
        formula = flop_registry.get(packet)
        if formula is not None:
            ins = _tensors((args, kwargs))
            cls = "tensor" if ins and ins[0].dtype in (
                torch.bfloat16, torch.float16) else "cuda_core"
            self.flops[cls] += int(formula(*args, **kwargs, out_val=out))
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))) \
            + sum(_nbytes(t) for t in outs)
        self._track(out)

    def launches(self) -> dict:
        """Launches by the kernels' ``LAUNCHES`` keys."""
        out: dict = {}
        for k in self.kernels.values():
            out[k["launches_key"]] = out.get(k["launches_key"], 0) \
                + k["launches"]
        return out

    def collectives(self) -> dict:
        return {"bytes_by_type": dict(self.coll_bytes),
                "count_by_type": dict(self.coll_count),
                "total_bytes": sum(self.coll_bytes.values())}


# --------------------------------------------------------- abstract inputs

def fake_inputs(tree, mesh, fake, device: str):
    """Each :class:`~repro_torch.models.params.AbstractLeaf` of ``tree`` a
    DTensor on ``mesh`` over a fake local tensor (made in ``fake``, a
    ``FakeTensorMode``) of rank 0's shard at its spec's placements;
    nothing is allocated."""
    dev = torch.device(device, 0) if device == "cuda" else torch.device(
        device)

    def one(leaf):
        pl = leaf.sharding.placements
        local, _ = local_extent(leaf.shape, mesh, pl)
        with fake:
            loc = torch.empty(local, dtype=leaf.dtype, device=dev)
        stride = torch.empty(leaf.shape, device="meta").stride()
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=torch.Size(leaf.shape),
                                  stride=stride)

    return tree_map(one, tree, is_leaf=is_abstract)


# --------------------------------------------------------------- analytics

def min_bytes_estimate(cfg, shape, n_chips: int) -> float:
    """Analytic lower bound on per-chip HBM traffic for one step (documented
    approximation; the denominator for the memory-roofline fraction):

      train:   params read (fwd+bwd) + grad write + param write
               + AdamW m/v read+write (f32) + layer-boundary activations x3
      prefill: params read + KV-cache write + boundary activations
      decode:  active params read + cache read/write slice
    """
    P = cfg.param_count() * 2.0                      # bf16 bytes
    Pa = cfg.active_param_count() * 2.0
    opt = cfg.param_count() * (16.0 if cfg.optimizer == "adamw" else 2.0)
    L, D = cfg.n_layers + cfg.encoder_layers, cfg.d_model
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        acts = 3.0 * L * toks * D * 2.0
        total = 4.0 * P + 2.0 * opt + acts
    elif shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        kv = 2.0 * L * toks * cfg.n_kv_heads * cfg.head_dim * 2.0
        total = P + kv + L * toks * D * 2.0
    else:
        kv_per_tok = 2.0 * L * cfg.n_kv_heads * cfg.head_dim * 2.0
        if cfg.mla is not None:
            kv_per_tok = L * (cfg.mla.kv_lora_rank
                              + cfg.mla.qk_rope_head_dim) * 2.0
        cache = shape.global_batch * shape.seq_len * kv_per_tok
        if cfg.attn_free:
            cache = (shape.global_batch * cfg.n_layers * (D / cfg.head_dim)
                     * cfg.head_dim ** 2 * 4.0)
        total = Pa + cache
    return total / n_chips


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N_active·tokens (train) / 2·N_active·tokens (fwd);
    attention score FLOPs excluded by convention (standard MFU accounting)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        toks = shape.global_batch * shape.seq_len
        return 6.0 * n * toks
    if shape.kind == "prefill":
        toks = shape.global_batch * shape.seq_len
        return 2.0 * n * toks
    return 2.0 * n * shape.global_batch          # decode: 1 token / seq


def cell_applicable(cfg, shape_name: str) -> tuple[bool, str]:
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: O(S^2) at 500k infeasible"
    return True, ""


# --------------------------------------------------------------- variants
# §Perf hillclimb knobs: each variant = (rules overrides, cfg overrides).
# ``attn_chunk4k`` changes only the plain attention's chunking
# (``models/layers.py``): on the card's routes its counts are baseline's.
VARIANTS: dict[str, dict] = {
    "baseline": dict(),
    # serving: replicate params over 'data' (no FSDP at inference), cache
    # sharded batch x heads — kills the per-step KV/param all-gathers
    "serve_repl": dict(rules=dict(fsdp=None, sequence=None)),
    # MoE: pin dispatch buffers to (expert x EP, capacity x DP)
    "moe_dispatch": dict(cfg=dict(moe_dispatch_sharding=True)),
    # MoE: explicit expert-parallel shard_map (local dispatch, ZeRO gather,
    # psum combine) — see models/moe_ep.py
    "moe_ep": dict(cfg=dict(moe_impl="ep_shardmap")),
    "moe_ep_dots": dict(cfg=dict(moe_impl="ep_shardmap", remat="dots")),
    # selective rematerialization: save matmul outputs, recompute elementwise
    "remat_dots": dict(cfg=dict(remat="dots")),
    # megatron-style activation sharding over the model axis
    "act_shard": dict(rules=dict(act_embed="model")),
    # larger attention KV chunks: fewer online-softmax accumulator rewrites
    "attn_chunk4k": dict(cfg=dict(attn_kv_chunk=4096)),
    # combined training recipe (per-cell winners composed)
    "train_opt": dict(cfg=dict(attn_kv_chunk=4096, remat="dots")),
}


# ------------------------------------------------------------------- cells

def _roofline(flops: dict, bytes_acc: float, coll_bytes: float, cfg, shape,
              n_chips: int) -> dict:
    """``repro``'s three roofline terms (DESIGN.md §7) at H100 constants:
    ``t_compute`` is the sum of the two FLOP classes at their peaks."""
    total = flops["tensor"] + flops["cuda_core"]
    t_compute = flops["tensor"] / PEAK_FLOPS \
        + flops["cuda_core"] / CUDA_CORE_FLOPS
    t_memory = bytes_acc / HBM_BW
    t_coll = coll_bytes / LINK_BW
    dominant = max(
        (("compute", t_compute), ("memory", t_memory),
         ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    mf = model_flops(cfg, shape)
    min_b = min_bytes_estimate(cfg, shape, n_chips)
    t_max = max(t_compute, t_memory, t_coll)
    t_useful_compute = mf / n_chips / PEAK_FLOPS
    t_min_memory = min_b / HBM_BW
    frac = (max(t_useful_compute, t_min_memory) / t_max) if t_max > 0 else None
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_global": mf,
        "model_flops_per_chip": mf / n_chips,
        "useful_flops_ratio": (mf / n_chips) / total if total else None,
        "min_bytes_per_chip": min_b,
        "useful_bytes_ratio": min_b / bytes_acc if bytes_acc else None,
        "t_useful_compute_s": t_useful_compute,
        "t_min_memory_s": t_min_memory,
        "roofline_fraction": frac,
    }


def _check_device(device: str) -> None:
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}: the dry-run counts the card's "
                         f"routes ('cuda') or the CPU's ('cpu')")
    if device == "cuda" and not torch.backends.cuda.is_built():
        raise ValueError("the dry-run on the card's routes needs a PyTorch "
                         "built with CUDA; pass --device cpu to count the "
                         "CPU path")


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             rules_overrides: dict | None = None,
             label: str = "baseline", variant: str = "baseline",
             device: str = "cuda") -> dict:
    """Count one cell and write its record (:func:`_write`); returns it."""
    _check_device(device)
    cfg = configs.get(arch)
    var = VARIANTS[variant]
    if var.get("cfg"):
        cfg = dataclasses.replace(cfg, **var["cfg"])
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape_name)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    rec: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "label": label,
        "kind": shape.kind, "applicable": ok, "device": device,
    }
    if not ok:
        rec["skip_reason"] = why
        _write(out_dir, rec)
        return rec

    n_chips = production_shape(multi_pod=multi_pod).size()
    with fake_world(n_chips), PeakRss() as rss:
        try:
            rec.update(_count_cell(cfg, shape, multi_pod, rules_overrides,
                                   var, device))
        except NoBackward as e:
            if shape.kind != "train":
                raise
            rec.update(applicable=False, skip_reason=str(e))
    rec["host_peak_rss_bytes"] = rss.bytes
    _write(out_dir, rec)
    return rec


def _status_kb(field: str) -> int | None:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


class PeakRss:
    """This process's peak resident set on the host, in bytes
    (:attr:`bytes`), up to the end of the ``with`` block: ``VmHWM`` where
    ``/proc/self/status`` has it (since ``exec``), else ``VmRSS`` sampled
    every 10 ms from a thread while the block runs, else None.
    ``getrusage``'s ``ru_maxrss`` would not do: a process keeps the peak
    of the one it was started from, up to its ``exec``."""

    def __enter__(self):
        self.bytes = None
        self._thread = None
        if _status_kb("VmHWM") is None and _status_kb("VmRSS") is not None:
            import threading
            self._peak = _status_kb("VmRSS")
            self._stop = threading.Event()
            self._thread = threading.Thread(target=self._sample, daemon=True)
            self._thread.start()
        return self

    def _sample(self) -> None:
        while not self._stop.wait(0.01):
            self._peak = max(self._peak, _status_kb("VmRSS") or 0)

    def __exit__(self, *exc) -> None:
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self.bytes = max(self._peak, _status_kb("VmRSS") or 0) * 1024
        elif _status_kb("VmHWM") is not None:
            self.bytes = _status_kb("VmHWM") * 1024


def _count_cell(cfg, shape, multi_pod, rules_overrides, var,
                device) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    n_chips = mesh.size()
    overrides = dict(rules_overrides or {})
    overrides.update(var.get("rules", {}))
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    if shape.global_batch < sizes.get("data", 1) * sizes.get("pod", 1):
        # batch unshardable (long_500k B=1): replicate batch, shard the
        # sequence axis of caches over both axes instead (SP).
        overrides.setdefault("batch", ())
        overrides.setdefault(
            "sequence",
            ("data", "model") if "model" in sizes else ("data",),
        )
    rules = rules_for_mesh(mesh, **overrides)
    model = build_model(cfg)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    out: dict = {}
    if shape.kind == "train":
        opt = make_optimizer(cfg)
        step = make_train_step(model, opt, rules)
        args = [fake_inputs(s, mesh, fake, device)
                for s in train_input_specs(model, opt, shape, mesh, rules)]
    elif shape.kind == "prefill":
        step = make_prefill_step(model, rules)
        args = [fake_inputs(s, mesh, fake, device)
                for s in serve_input_specs(model, shape, mesh, rules,
                                           kind="prefill")]
    else:
        step = make_decode_step(model, rules)
        params, cache, tokens, _ = serve_input_specs(
            model, shape, mesh, rules, kind="decode")
        out["position"] = shape.seq_len - 1
        args = [fake_inputs(s, mesh, fake, device)
                for s in (params, cache, tokens)] + [out["position"]]
    t_lower = time.perf_counter() - t0

    mode = CostMode(fake)
    arg_bytes = mode.arguments(args)
    with fake, mode:
        result = step(*args)
    t_compile = time.perf_counter() - t0 - t_lower
    out_bytes = mode.made_bytes(result)
    del result
    cost = {"flops": float(sum(mode.flops.values())),
            "bytes accessed": float(mode.bytes),
            "flops_tensor": float(mode.flops["tensor"]),
            "flops_cuda_core": float(mode.flops["cuda_core"])}
    mem = {"argument_size_in_bytes": arg_bytes,
           "output_size_in_bytes": out_bytes,
           "temp_size_in_bytes": mode.peak - out_bytes,
           "peak_memory_in_bytes": arg_bytes + mode.peak}
    coll = mode.collectives()
    out.update(
        n_chips=int(n_chips),
        lower_s=round(t_lower, 2),
        compile_s=round(t_compile, 2),
        cost_analysis=cost,
        memory_analysis=mem,
        collectives=coll,
        kernels={k: {f: v[f] for f in ("launches", "flops", "bytes",
                                       "flop_class")}
                 for k, v in mode.kernels.items()},
        launches=mode.launches(),
        roofline=_roofline(mode.flops, cost["bytes accessed"],
                           float(coll["total_bytes"]), cfg, shape, n_chips),
    )
    return out


def _write(out_dir: str, rec: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{rec['label']}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    r = rec.get("roofline", {})
    if rec.get("applicable", True):
        print(
            f"[dryrun] {rec['arch']:24s} {rec['shape']:12s} {rec['mesh']:12s}"
            f" compile={rec.get('compile_s', 0):7.1f}s"
            f" dominant={r.get('dominant', '-'):10s}"
            f" frac={r.get('roofline_fraction') or 0:.3f}",
            flush=True,
        )
    else:
        print(f"[dryrun] {rec['arch']:24s} {rec['shape']:12s} "
              f"{rec['mesh']:12s} SKIP: {rec['skip_reason']}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", default=None)
    ap.add_argument("--shape", action="append", default=None)
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--label", default=None)
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="count the card's routes (default) or the CPU's")
    args = ap.parse_args(argv)
    if args.label is None:
        args.label = args.variant

    archs = args.arch or (list(configs.ARCH_NAMES) if args.all else [])
    shapes = args.shape or list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[
        args.mesh
    ]
    if not archs:
        ap.error("pass --arch or --all")
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, mp, args.out, label=args.label,
                             variant=args.variant, device=args.device)
                except Exception:
                    failures.append((arch, shape, mp))
                    print(f"[dryrun] FAILED {arch} {shape} multi={mp}",
                          flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("[dryrun] all cells OK")


if __name__ == "__main__":
    main()
