#!/usr/bin/env python3
"""Variants of the arena copy (write and read in ``csrc/arena.cu``), of
the arena accumulate (accum) and of the fused chain write (chain_write)
timed against each other and against torch's copy and ``add_``, on one
CUDA card.  Run from the root of a checkout:

    python3 tools/arena_copy_probe.py [variant ...]

Each variant is ``csrc/arena.cu`` with a few edits, built into
``build/arena_probe/`` (the repository's source is not changed) and bound
in place of the library the wrappers load, so every call goes through
``arena_write_cuda`` / ``arena_read_cuda`` and ``copy_plan`` as on the main
path (and accum through ``arena_accum_cuda``, chain_write through
``arena_chain_write_cuda``):

  main        the source as it is: blocks of 256 threads, 2 16-byte loads
              in flight a thread (__ldg), evict-first stores (__stcs),
              64-bit indices, at least 8 blocks an SM (32 registers);
              accum 1 float4 read-modify-write a thread a pass, arena
              loads by __ldcg, plain stores; chain_write 1 float4 a
              thread a pass (x at its phase), the chain's ops read from
              the kernel's parameters, plain stores
  l1, l4      1 or 4 loads in flight a thread
  rows        a body that fills whole passes of the grid in rows of 512
              stores a block instead of spread over the grid
  i32         32-bit indices
  ld, ldcg    plain loads; loads that skip L1 (__ldcg)
  st          plain stores
  nolb        no floor of blocks an SM on the registers
  tma         the phase-0 body by a 1-D bulk copy (cp.async.bulk global ->
              shared -> global, one mbarrier), 16 KB a block's chunk
  empty       the same launches with no load or store: the floor a launch
              of this grid costs (copy, accum and chain_write)
  acc_v2, acc_v4  accum with 2 or 4 vectors a thread a pass
  acc_stcs    accum with evict-first stores (__stcs)
  acc_ld      accum with plain arena loads (through L1)
  acc_old     the accum kernel of PRs 11-15: one float a thread, 4-byte
              loads and store, 256 elements a block
  chain_old   the first chain_write kernel: one float a thread,
              4-byte loads and stores
  chain_tmpl  the (bn, relu) chain as constants in the kernel instead of
              its parameters (the op loop's price; timed on the (bn, relu)
              launches only, where it is right)
  chain_stcs  chain_write with evict-first stores (__stcs)
  chain_general  every chain through the kernel instance that holds the
              transcendental ops' code
  chain_unroll  the op loop unrolled to MAX_CHAIN ops (each skipped past
              the chain's length)
  chain_if    the op dispatch by a chain of ifs, exact ops first, in
              place of the switch

Shapes: the f32 launches one execute of ``darts_net_x6`` and
``randwire_net_32x8`` makes (slice and fused, as ``chip_smoke.py``
records them), all together and by size (under 64 KB, 64 KB and over),
the u8 decode-state leaves of ``llama3.2-1b``,
``rwkv6-7b`` and ``recurrentgemma-2b`` at their served plans, and one
accum of 16 MB (4,194,304 floats, beyond one wave of the grid).  For each,
write, read and accum: device us per launch warm (replayed as the main
path finds L2) and cold (L2 flushed before each launch), and beside them
the torch call (``copy_`` / ``clone`` / ``add_``; for chain_write
``copy_`` of the same bytes, a floor of the launch: no one torch call
applies the chain), timed first and last, and the names of its device
activities.  A copy variant times write and read, an accum variant
accum, a chain variant chain_write, main and empty all four; the f32
chain_write launches are the 42 of a fused ``darts_net_x6`` execute, and
the (bn, relu) ones among them a set of their own.  The variants run
in turns, main first and last; naming variants runs only those (and
main).  One line per measurement with the card's
name and power limit; all of it as JSON in
``chiprun_out/arena_copy_probe.json``.
"""

from __future__ import annotations

import ctypes
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "arena_probe"

TMA_BODY = r'''
// 1-D bulk copy of the phase-0 body: thread 0 of each block moves chunks
// of kCopyThreads * kLoads * 2 vectors global -> shared -> global.
__device__ __forceinline__ void body_tma(uint4* d, const uint4* s,
                                         long long nvec) {
  __shared__ alignas(128) unsigned char buf[kCopyThreads * kLoads * 32];
  __shared__ alignas(8) unsigned long long bar;
  if (threadIdx.x != 0) return;
  const unsigned int sbuf =
      static_cast<unsigned int>(__cvta_generic_to_shared(buf));
  const unsigned int sbar =
      static_cast<unsigned int>(__cvta_generic_to_shared(&bar));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(sbar));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  const long long chunk = static_cast<long long>(kCopyThreads) * kLoads * 2;
  unsigned int parity = 0;
  for (long long c = blockIdx.x * chunk; c < nvec;
       c += static_cast<long long>(gridDim.x) * chunk) {
    const long long left = nvec - c;
    const unsigned int bytes =
        16u * static_cast<unsigned int>(left < chunk ? left : chunk);
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(sbar),
        "r"(bytes)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(sbuf),
        "l"(s + c), "r"(bytes), "r"(sbar)
        : "memory");
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(sbar),
        "r"(parity)
        : "memory");
    parity ^= 1u;
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
            d + c),
        "r"(sbuf), "r"(bytes)
        : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
  }
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

'''

LOADS = "constexpr int kLoads = 2;"
INDEX = "using Index = long long;"
STEP = "  const Index step = static_cast<Index>(gridDim.x) * kCopyThreads;\n"
FIRST = "static_cast<Index>(blockIdx.x) * kCopyThreads + threadIdx.x;"
LOAD = "return __ldg(p);"
STORE = "{ __stcs(p, v); }"
BOUNDS = "__launch_bounds__(kCopyThreads, 2048 / kCopyThreads)"
EDGE = "  long long edge = -1;\n"
BODY = "  const unsigned char* s = src + p.head;\n"
COPY = "// Replaces arena_write_pallas / _write_kernel and arena_read_pallas"
WANT = "(p.nvec + kCopyThreads - 1) / kCopyThreads"

VARIANTS = {
    "main": [],
    "l1": [(LOADS, "constexpr int kLoads = 1;")],
    "l4": [(LOADS, "constexpr int kLoads = 4;")],
    # a body that fills whole passes in rows of kCopyThreads * kStores
    # stores a block (k apart by kCopyThreads)
    "rows": [(STEP, STEP + "  const bool rows = n >= step * kStores;\n"
                    "  const Index lane = rows ? kCopyThreads : step;\n"),
             (FIRST, "static_cast<Index>(blockIdx.x) * (rows ? kCopyThreads"
                     " * kStores : kCopyThreads) + threadIdx.x;"),
             ("k * step", "k * lane")],
    "i32": [(INDEX, "using Index = int;")],
    "ld": [(LOAD, "return *p;")],
    "ldcg": [(LOAD, "return __ldcg(p);")],
    "st": [(STORE, "{ *p = v; }")],
    "nolb": [(BOUNDS, "__launch_bounds__(kCopyThreads)")],
    "tma": [(COPY, TMA_BODY + COPY),
            (BODY, BODY + "  if constexpr (kMode == 0) {\n"
                          "    body_tma(d, reinterpret_cast<const uint4*>(s), "
                          "p.nvec);\n"
                          "    if (edge >= 0) dst[edge] = e;\n"
                          "    return;\n  }\n"),
            (WANT, "(p.nvec + kCopyThreads * kLoads * 2 - 1) / "
                   "(kCopyThreads * kLoads * 2)")],
    # the launch alone: the same grid, no load or store
    "empty": [(EDGE, "  return;\n" + EDGE)],
}
OLD_ACCUM = r'''
__global__ void old_accum_kernel(float* arena, const float* __restrict__ x,
                                 long long offset, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    arena[offset + i] = __fadd_rn(arena[offset + i], x[i]);
  }
}

'''
ACC_VECS = "constexpr int kAccVecs = 1;"
ACC_LOAD = "  return __ldcg(p);\n}\n\n__device__ __forceinline__ void store_arena"
ACC_STORE = "void store_arena(float4* p, float4 v) { *p = v; }"
ACC_DOC = "// Replaces arena_accum_pallas / _accum_kernel"
ACC_LAUNCH = "  const cudaStream_t st = static_cast<cudaStream_t>(stream);\n" \
    "  switch (p.phase >> 2) {\n    case 0: return launch_accum<0>"
# one float a thread, 256 a block, up to one wave then a grid-stride loop
OLD_GRID = "static_cast<unsigned int>((n + 255) / 256 < kMaxBlocks ? " \
    "(n + 255) / 256 : kMaxBlocks), 256"
VARIANTS.update({
    "acc_v2": [(ACC_VECS, "constexpr int kAccVecs = 2;")],
    "acc_v4": [(ACC_VECS, "constexpr int kAccVecs = 4;")],
    "acc_stcs": [(ACC_STORE,
                  "void store_arena(float4* p, float4 v) { __stcs(p, v); }")],
    "acc_ld": [(ACC_LOAD, ACC_LOAD.replace("__ldcg(p)", "*p"))],
    "acc_old": [(ACC_DOC, OLD_ACCUM + ACC_DOC),
                (ACC_LAUNCH,
                 "  old_accum_kernel<<<" + OLD_GRID + ", 0,\n"
                 "      static_cast<cudaStream_t>(stream)>>>(\n"
                 "      static_cast<float*>(arena), s, offset, n);\n"
                 "  return static_cast<int>(cudaGetLastError());\n"
                 + ACC_LAUNCH)],
})
# chain_write: the first kernel (one float a thread, 4-byte loads and
# stores), the (bn, relu) chain as template constants, evict-first stores
OLD_CHAIN = r'''
__device__ __forceinline__ float old_apply_op(int op, float v) {
  switch (op) {
    case OP_RELU: return op_of<OP_RELU>(v);
    case OP_RELU6: return op_of<OP_RELU6>(v);
    case OP_BN: return op_of<OP_BN>(v);
    case OP_SIGMOID: return op_of<OP_SIGMOID>(v);
    case OP_TANH: return op_of<OP_TANH>(v);
    case OP_GELU: return op_of<OP_GELU>(v);
    case OP_SILU: return op_of<OP_SILU>(v);
    case OP_BIAS_ADD: return op_of<OP_BIAS_ADD>(v);
    case OP_SCALE: return op_of<OP_SCALE>(v);
    default: return v;
  }
}

__global__ void old_chain_write_kernel(float* arena,
                                       const float* __restrict__ x,
                                       long long offset, long long n,
                                       ChainOps ops) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float v = x[i];
    for (int k = 0; k < ops.n; ++k) {
      v = old_apply_op(ops.op[k], v);
    }
    arena[offset + i] = v;
  }
}

'''
CHAIN_DOC = "// Replaces arena_chain_write_pallas / _chain_write_kernel"
CHAIN_LAUNCH = "  const cudaStream_t st = static_cast<cudaStream_t>(stream);\n" \
    "  switch (p.phase >> 2) {\n    case 0: return launch_chain<0>"
CHAIN_STORE = "    apply_chain<kExact>(ops, v);\n    store_arena(d + i, "
VARIANTS.update({
    "chain_old": [(CHAIN_DOC, OLD_CHAIN + CHAIN_DOC),
                  (CHAIN_LAUNCH,
                   "  old_chain_write_kernel<<<" + OLD_GRID + ", 0,\n"
                   "      static_cast<cudaStream_t>(stream)>>>(\n"
                   "      static_cast<float*>(arena), s, offset, n, ops);\n"
                   "  return static_cast<int>(cudaGetLastError());\n"
                   + CHAIN_LAUNCH)],
    "chain_tmpl": [(CHAIN_STORE,
                    "    apply_chain<kExact>(Chain{OP_BN | OP_RELU << 4, 2}, "
                    "v);\n"
                    "    store_arena(d + i, ")],
    "chain_stcs": [(CHAIN_STORE,
                    "    apply_chain<kExact>(ops, v);\n    __stcs(d + i, ")],
    # every chain through the general kernel (transcendental code in it)
    "chain_general": [("    exact = exact && exact_op(ops.op[k]);\n",
                       "    exact = false;\n")],
    "chain_unroll": [("  for (int k = 0; k < c.n; ++k, code >>= 4) {\n",
                      "#pragma unroll\n"
                      "  for (int k = 0; k < kMaxChain; ++k, code >>= 4) {\n"
                      "    if (k >= c.n) break;\n")],
    "chain_if": [(None, ("  switch (op) {\n    case OP_RELU: map_op",
                         "// Any op on each"),
                  "  if (op == OP_BN) map_op<OP_BN>(v);\n"
                  "  else if (op == OP_RELU) map_op<OP_RELU>(v);\n"
                  "  else if (op == OP_RELU6) map_op<OP_RELU6>(v);\n"
                  "  else if (op == OP_BIAS_ADD) map_op<OP_BIAS_ADD>(v);\n"
                  "  else if (op == OP_SCALE) map_op<OP_SCALE>(v);\n"
                  "}\n\n")],
})
UNCHECKED = {"empty"}
ORDER = ("main", "l1", "l4", "rows", "i32", "ld", "ldcg", "st", "nolb",
         "tma", "acc_v2", "acc_v4", "acc_stcs", "acc_ld", "acc_old",
         "chain_old", "chain_tmpl", "chain_stcs", "chain_general",
         "chain_unroll", "chain_if", "empty", "main")
ALL_OPS = ("write", "read", "accum", "chain_write")
# the set a chain_tmpl variant is right on (its chain is fixed)
BN_RELU = "f32 chain (bn, relu)"


def ops_of(name: str) -> tuple[str, ...]:
    """The ops a variant changes, and so is timed at."""
    if name in ("main", "empty"):
        return ALL_OPS
    if name.startswith("chain_"):
        return ("chain_write",)
    return ("accum",) if name.startswith("acc_") else ("write", "read")


def sets_of(name: str, sets: dict) -> dict:
    """The launch sets a variant is checked and timed on."""
    return {BN_RELU: sets[BN_RELU]} if name == "chain_tmpl" else sets


def variant(name: str, edits) -> Path:
    """Build ``csrc/arena.cu`` with every occurrence of each old of
    ``edits`` replaced by its new; returns the library's path."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.arena import kernel as K
    text = K.SOURCE.read_text()
    for e in edits:
        if e[0] is None:     # (None, (start, end), new): start .. end
            (start, end), new = e[1], e[2]
            i, j = text.find(start), text.find(end)
            if i < 0 or j < i:
                raise SystemExit(f"arena.cu: the probe's anchors are gone: "
                                 f"{start!r} .. {end!r}")
            text = text[:i] + new + text[j:]
            continue
        old, new = e
        if old not in text:
            raise SystemExit(f"arena.cu: the probe's anchor is gone: {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"arena_{name}.cu"
    path.write_text(text)
    return _build.build(path, f"arena_{name}")


def f32_launches(dev):
    """{op: args} of the f32 launches one execute of each full network
    makes (write, read, accum, chain_write), on one random arena."""
    import chip_smoke as CS
    import repro_torch as rt
    from repro_torch.graphs import FULL_NETWORKS

    names = ("darts_net_x6", "randwire_net_32x8")
    plans = {n: rt.plan(FULL_NETWORKS[n](), rt.PlanConfig()) for n in names}
    rng = np.random.default_rng(CS.SEED)
    inputs = {n: CS.seeded_inputs(p.graph, rng) for n, p in plans.items()}
    log = CS.record_launches(rt, plans, inputs)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    arena = torch.randn(max(e[1] for e in log), device=dev, generator=gen)
    xs = {}
    for _, _, _, n, _ in log:
        if n not in xs:
            xs[n] = torch.randn(n, device=dev, generator=gen)
    return {"write": [(arena, xs[n], o) for op, _, o, n, _ in log
                      if op == "write"],
            "read": [(arena, o, n) for op, _, o, n, _ in log
                     if op == "read"],
            "accum": [(arena, xs[n], o) for op, _, o, n, _ in log
                      if op == "accum"],
            "chain_write": [(arena, xs[n], o, ops)
                            for op, _, o, n, ops in log
                            if op == "chain_write"]}


def large_accum(dev):
    """One accum of 16 MB at a word-shifted x: a DRAM stream beyond one
    wave of the grid."""
    n = 1 << 22
    gen = torch.Generator(device=dev).manual_seed(11)
    arena = torch.randn(n + 8, device=dev, generator=gen)
    x = torch.randn(n + 4, device=dev, generator=gen)[1:n + 1]
    return {"accum": [(arena, x, 2)]}


def served_launches(dev):
    """{arch: (write args, read args)} at each model's served leaves: the
    decode plan's offsets in an arena of its resident extent, one source
    of each leaf's bytes."""
    import chip_smoke as CS
    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.params import is_def, tree_leaves
    from repro_torch.models.zoo import build_model

    out = {}
    gen = torch.Generator(device=dev).manual_seed(CS.SEED + 3)
    for arch, spec in CS.SERVES.items():
        model = build_model(configs.get(arch))
        smax = spec["prompt"] + CS.GEN
        plan = S.plan_decode_arena(model, 1, smax)
        defs = tree_leaves(model.make_cache_defs(1, smax), is_leaf=is_def)
        spans = [(plan["plan"].offset_of(i),
                  int(np.prod(d.shape)) * d.dtype.itemsize)
                 for i, d in enumerate(defs)]
        arena = torch.randint(0, 256, (plan["resident_extent"],),
                              dtype=torch.uint8, device=dev, generator=gen)
        xs = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                            generator=gen) for _, n in spans]
        out[arch] = {"write": [(arena, x, o) for x, (o, _) in zip(xs, spans)],
                     "read": [(arena, o, n) for o, n in spans]}
    return out


def check_copies(name, sets):
    """The variant must be right before it is timed: its first launches
    of each set against the plain versions, bit for bit."""
    import chip_smoke as CS
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R
    for sname, ops in sets.items():
        for op in ops_of(name):
            for args in ops.get(op, [])[:4]:
                if op == "read":
                    ok = torch.equal(K.arena_read_cuda(*args),
                                     R.arena_read_torch(*args))
                elif op == "chain_write":   # the darts chains are exact
                    a = args[0].clone()
                    K.arena_chain_write_cuda(a, *args[1:])
                    ok = torch.equal(a, R.arena_chain_write_torch(
                        args[0].clone(), *args[1:]))
                else:
                    a = args[0].clone()
                    getattr(K, f"arena_{op}_cuda")(a, *args[1:])
                    ok = torch.equal(a, getattr(R, f"arena_{op}_torch")(
                        args[0].clone(), *args[1:]))
                CS.check(ok, f"{name} {sname} {op}")


def by_size(f32):
    """The f32 launches in two sets by bytes: under 64 KB, and 64 KB and
    over."""
    cuts = (("f32 <64KB", 0, 16384), ("f32 >=64KB", 16384, 1 << 62))
    n_of = {"write": lambda a: a[1].shape[0], "read": lambda a: a[2],
            "accum": lambda a: a[1].shape[0],
            "chain_write": lambda a: a[1].shape[0]}
    return {name: {op: [a for a in args if lo <= n_of[op](a) < hi]
                   for op, args in f32.items()}
            for name, lo, hi in cuts}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; this probe needs a "
              "CUDA card", flush=True)
        return 2
    import chip_smoke as CS
    from repro_torch.kernels.arena import kernel as K

    dev = torch.device("cuda", torch.cuda.current_device())
    card = CS.card_line()
    from repro_torch.kernels import _build

    def built(kv):
        try:
            return variant(*kv)
        except _build.KernelBuildError as e:     # reported, not timed
            print(f"probe: variant {kv[0]} does not build: {e}", flush=True)
            return None

    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = {k: v for k, v in zip(VARIANTS, ex.map(built, VARIANTS.items()))
                if v is not None}
    for name, lib in libs.items():
        for ln in _build.ptxas_report(lib):
            print(f"probe: ptxas {name}: {ln}", flush=True)
    K._library()
    f32 = f32_launches(dev)
    sets = {"f32": f32, **by_size(f32), **served_launches(dev),
            "f32 16MB": large_accum(dev),
            BN_RELU: {"chain_write": [a for a in f32["chain_write"]
                                      if a[3] == ("bn", "relu")]}}
    flush = CS.L2Flush(dev)
    # chain_write's yardstick is copy_ of the same bytes: no one torch call
    # applies bn then relu, so it is a floor of the launch, not a library
    # call computing the same function
    torch_fns = {"write": lambda a, x, o: a[o:o + x.shape[0]].copy_(x),
                 "read": lambda a, o, n: a[o:o + n].clone(),
                 "accum": lambda a, x, o: a[o:o + x.shape[0]].add_(x),
                 "chain_write": lambda a, x, o, ops:
                     a[o:o + x.shape[0]].copy_(x)}

    def measure(tag, fns, ops=ALL_OPS, only=None):
        res = {}
        for sname, by_op in (only or sets).items():
            for op in ops:
                args = by_op.get(op)
                if not args:
                    continue
                fn = fns[op]
                warm = CS.time_replay(args, fn)[0]
                cold = CS.time_cold(args, fn, flush)
                res[f"{sname} {op}"] = dict(warm_ms=warm, cold_ms=cold)
                print(f"probe: {tag} {sname} {op} ({len(args)} launches): "
                      f"device us per launch warm {warm * 1e3:.3f}, cold "
                      f"{CS.fmt_us(cold)} [{card}]", flush=True)
        return res

    results = {"card": card, "torch_first": measure("torch", torch_fns)}
    for op, args in sets["f32"].items():
        names = sorted(CS.device_profile(
            lambda: [torch_fns[op](*a) for a in args[:64]])[2])
        results[f"torch {op} activities"] = names
        print(f"probe: torch {op} call's device activities: {names}",
              flush=True)
    kernels = {"write": K.arena_write_cuda, "read": K.arena_read_cuda,
               "accum": K.arena_accum_cuda,
               "chain_write": K.arena_chain_write_cuda}
    asked = set(sys.argv[1:]) | {"main"}
    for i, name in enumerate(ORDER):
        if name not in libs or (len(asked) > 1 and name not in asked):
            continue
        K._lib = K.bind(ctypes.CDLL(str(libs[name])))
        if name not in UNCHECKED:
            check_copies(name, sets_of(name, sets))
        results[f"{name}#{i}"] = measure(name, kernels, ops_of(name),
                                         sets_of(name, sets))
    results["torch_last"] = measure("torch", torch_fns)
    out = ROOT / "chiprun_out" / "arena_copy_probe.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"probe: wrote {out.relative_to(ROOT)}", flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
