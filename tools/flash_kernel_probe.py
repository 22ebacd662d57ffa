#!/usr/bin/env python3
"""Measurements behind the design notes of the two flash kernels, on one
CUDA card.  Run from the root of a checkout:

    python3 tools/flash_kernel_probe.py phases      # csrc/flash_decode.cu
    python3 tools/flash_kernel_probe.py precision   # flash_prefill_sm90.cu
    python3 tools/flash_kernel_probe.py mla [--parent DIR]

Each builds a variant of a kernel's source into ``build/flash_probe/`` (the
repository's sources are not changed) and prints one line per
measurement, with the card's name and power limit.

``phases``: the split-K decode with ``clock64`` stamps in every block: the
cycles of the tile loop, of writing the partials, of the arrival counter,
and, in the block that merges, of the merge's three steps, at
``llama3.2-1b``'s and ``recurrentgemma-2b``'s decode shapes over several
numbers of splits; beside them the kernel's device time at each.

``precision``: the ``wgmma`` prefill as it is (P split into bf16 hi and lo
parts) and with P rounded once to bf16 (the lo product removed), at the
served prefill shapes and the check's prefill cases: the largest error
against ``impl="torch"`` as a share of what ``chip_smoke.py`` allows (one
bf16 ulp of the output + 1e-5; above 1 fails), the outputs over it, and
the device time of each.

``mla``: the ``wgmma`` prefill at MLA's (D, Dv) = (192, 128) built four
ways, 2 and 3 stages of the K/V ring (``Config<192, 128>``), with and
without the next tile's Q K^T issued under the softmax (``OVERLAP``,
below; the source as it is has no overlap): each variant's
registers and spills (``-Xptxas -v``, and any warning that ptxas
serialized the products), its outputs at ``chip_smoke.py``'s flash cases
at (192, 128) (bf16, GQA 1 and 4) and deepseek-v3-671b's served prefill
(H 128, 1024 tokens, causal, scale 192^-0.5) bit-equal across the four
and to the kernel as built, within the attention tolerance of the plain
version; then the four timed in turns at the served shape (CUDA events
over replays of a graph of launches) beside the simple kernel, the
plain version, SDPA and the bound.  With ``--parent DIR`` (the root of
another checkout, e.g. ``git archive <commit> | tar -x -C
build/parent``) also that checkout's ``flash_prefill_sm90.cu``: every
call at (64, 64), (128, 128) and (256, 256) (the flash cases, GQA 1 and
4, recurrentgemma-2b's, and the llama3.2-1b, starcoder2-7b,
recurrentgemma-2b, seamless-m4t-medium and train-step shapes) bit-equal
to it, and those shapes timed in turns (this, other, other, this).  JSON
in ``chiprun_out/flash_probe_mla.json``; exits 1 on a failed check.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

OUT = ROOT / "build" / "flash_probe"
# (Sq, Skv, H, KV, D, window) of the served decode and prefill shapes
DECODE = {"llama3.2-1b": (1, 1056, 32, 8, 64, None),
          "recurrentgemma-2b": (1, 2592, 10, 1, 256, 2048)}
PREFILL = {"llama3.2-1b": (1024, 1024, 32, 8, 64, None),
           "recurrentgemma-2b": (2560, 2560, 10, 1, 256, 2048)}


def variant_path(name: str, source: Path, edits, rewrite=None) -> Path:
    """Build ``source`` with each (old, new) of ``edits`` applied once,
    then ``rewrite`` (a function of the text) if given; returns the
    library's path."""
    from repro_torch.kernels import _build
    text = source.read_text()
    if rewrite is not None:
        text = rewrite(text)
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{source.name}: the probe's anchor is gone: "
                             f"{old!r}")
        text = text.replace(old, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return _build.build(path, name)


def variant(name: str, source: Path, edits) -> ctypes.CDLL:
    return ctypes.CDLL(str(variant_path(name, source, edits)))


def bind(lib, fk, entry, args):
    fn = getattr(lib, entry)
    fn.argtypes = [fk._CTYPE.get(a, ctypes.c_longlong) for a in args]
    fn.restype = ctypes.c_int
    return fn


def qkv(gen, dev, Sq, Skv, H, KV, D):
    r = lambda *s: torch.randn(*s, device=dev, generator=gen).bfloat16()
    return r(1, Sq, H, D), r(1, Skv, KV, D), r(1, Skv, KV, D)


def phases(dev, card):
    import chip_smoke as CS
    from repro_torch.kernels.flash_attention import kernel as FK

    stamp = ("  if (tid == 0) g_stamp[(bk * 64 + split) * 8 + {i}] = "
             "clock64();\n")
    edits = [
        ("namespace {\n", "__device__ long long g_stamp[64 * 64 * 8];\n"
                          "namespace {\n"),
        ("  const int d0 = lane * kCols;", stamp.format(i=0)
         + "  const int d0 = lane * kCols;"),
        ("  cp_async_wait<0>();\n", "  cp_async_wait<0>();\n"
         + stamp.format(i=1)),
        ("  __shared__ int s_last;", stamp.format(i=2)
         + "  __shared__ int s_last;"),
        ("  if (!s_last) return;", stamp.format(i=3)
         + "  if (!s_last) return;"),
        ("  // 2. per row, M = max", stamp.format(i=4)
         + "  // 2. per row, M = max"),
        ("  // 3. out = sum_s", stamp.format(i=5) + "  // 3. out = sum_s"),
        ("  if (tid == 0) p.counter[bk] = 0;", stamp.format(i=6)
         + "  if (tid == 0) p.counter[bk] = 0;"),
        ("}  // namespace", "}  // namespace\nextern \"C\" int probe_stamps("
         "void* h) { return (int)cudaMemcpyFromSymbol(h, g_stamp, "
         "sizeof(g_stamp)); }\nextern \"C\" int probe_clear() { void* a; "
         "cudaGetSymbolAddress(&a, g_stamp); return (int)cudaMemset(a, 0, "
         "sizeof(g_stamp)); }\n"),
    ]
    lib = variant("flash_decode_phases", FK.SOURCES["flash_decode"], edits)
    bind(lib, FK, "repro_flash_decode", FK._ARGS["flash_decode"])
    lib.probe_stamps.argtypes = [ctypes.c_void_p]
    FK._libs["flash_decode"] = lib
    FK._counters.clear()
    gen = torch.Generator(device=dev).manual_seed(0)
    buf = np.zeros(64 * 64 * 8, dtype=np.int64)
    for model, (Sq, Skv, H, KV, D, w) in DECODE.items():
        q, k, v = qkv(gen, dev, Sq, Skv, H, KV, D)
        kw = dict(causal=True, window=w, q_start=Skv - 1, kv_len=Skv)
        for S in (8, 16, 32, 64):
            run = lambda: FK.flash_decode_cuda(q, k, v, splits=S, **kw)
            us = CS.time_replay([()], run)[0] * 1e3
            lib.probe_clear()               # only this run's stamps
            run()
            torch.cuda.synchronize()
            lib.probe_stamps(buf.ctypes.data)
            st = buf.reshape(64, 64, 8)[:KV, :S]
            last = st[st[..., 4] > 0]             # the merging blocks
            tiles = np.median(st[..., 1] - st[..., 0])
            d = np.median(np.diff(last[:, [2, 3, 4, 5, 6]], axis=1), axis=0)
            print(f"phases {model} splits {S}: device us {us:.2f}; cycles "
                  f"(median over blocks): tiles {tiles:.0f}, partials "
                  f"{np.median(st[..., 2] - st[..., 1]):.0f}; merging "
                  f"block: arrival {d[0]:.0f}, merge step 1 {d[1]:.0f}, "
                  f"step 2 {d[2]:.0f}, step 3 {d[3]:.0f} [{card}]",
                  flush=True)


def precision(dev, card):
    import chip_smoke as CS
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    src = FK.SOURCES["flash_prefill_sm90"]
    libs = {"hi + lo (as built)": variant("flash_prefill_split", src, []),
            "P rounded once": variant("flash_prefill_round", src, [
                ("        wgmma_rs(o[c], lo[kk], dv);\n", "")])}
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = {f"{m} prefill": (*shape, {}) for m, shape in PREFILL.items()}
    cases.update({
        "D 128 G 4 prefill 1024": (1024, 1024, 32, 8, 128, None, {}),
        "D 64 G 4 window 100": (300, 300, 32, 8, 64, 100, {}),
        "D 256 G 1 tail": (70, 1056, 8, 8, 256, None,
                           dict(q_start=400, kv_len=470)),
    })
    for label, (Sq, Skv, H, KV, D, w, extra) in cases.items():
        q, k, v = qkv(gen, dev, Sq, Skv, H, KV, D)
        kw = {"q_start": 0, "kv_len": Skv, "window": w, **extra}
        want = flash_attention(q, k, v, impl="torch", causal=True, **kw)
        for name, lib in libs.items():
            bind(lib, FK, "repro_flash_prefill_sm90",
                 FK._ARGS["flash_prefill_sm90"])
            FK._libs["flash_prefill_sm90"] = lib
            run = lambda: FK.flash_prefill_cuda(q, k, v, causal=True, **kw)
            got = run().float()
            ref = want.float()
            allowed = CS.bf16_ulp(torch.maximum(got.abs(), ref.abs())) \
                + CS.FA_ATOL16
            share = ((got - ref).abs() / allowed)
            us = CS.time_replay([()], run)[0] * 1e3
            print(f"precision {label} (Sq {Sq}, Skv {Skv}, H {H}, KV {KV}, "
                  f"D {D}, window {w}) {name}: max error {share.max():.3f} "
                  f"of the allowed, {int((share > 1).sum())} of "
                  f"{share.numel()} outputs over it; device us {us:.2f} "
                  f"[{card}]", flush=True)


# the (192, 128) kernel's loop with tile t + 1's Q K^T issued before tile
# t's P V (a second score accumulator; the K ring one tile ahead of the V
# ring), so that tile t + 1's softmax runs on the CUDA cores while P V runs
# on the tensor cores (`wgmma.wait_group 1`): the intra-warpgroup overlap
# of FlashAttention-3.  Only when the products are issued changes, not
# what is summed.  `mla` puts it in place of the ring and the tile loop
# of csrc/flash_prefill_sm90.cu for that pair alone.
OVERLAP = r"""
    auto load_k = [&](long long t, int stage) {
      if (t >= t_end) return;
      const long long kb = t * kTile;
      for (int i = tid; i < kTile * kCpr; i += kThreads) {
        const int j = i / kCpr, c = i - j * kCpr;
        const bool in = kb + j < p.kv_len;
        const long long off = ((b * p.Skv + kb + j) * p.KV + kvh) * D + c * 8;
        cp_async16(sK + stage * kTileBytes + swz(j, c, kTile),
                   in ? p.k + off : p.k, in ? 16 : 0);
      }
    };
    auto load_v = [&](long long t, int stage) {
      if (t >= t_end) return;
      const long long kb = t * kTile;
      for (int i = tid; i < kTile * kVCpr; i += kThreads) {
        const int j = i / kVCpr, c = i - j * kVCpr;
        const bool in = kb + j < p.kv_len;
        const long long off = ((b * p.Skv + kb + j) * p.KV + kvh) * Dv + c * 8;
        cp_async16(sV + stage * kVBytes + swz(j, c, kTile),
                   in ? p.v + off : p.v, in ? 16 : 0);
      }
    };
    auto issue_scores = [&](float (&s)[32], uint32_t ks) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * kRows * 128 + (kk & 3) * 32;
        wgmma_ss(s, make_desc(sQ + off, 16),
                 make_desc(ks + (kk >> 2) * kTile * 128 + (kk & 3) * 32, 16));
      }
    };
    // tile t's scores s masked and scaled in place, p = 2^(s - m) into out
    auto softmax = [&](float (&s)[32], float (&out)[32], long long t,
                       float (&corr)[2]) {
      const long long kb = t * kTile;
      float mx[2] = {-INFINITY, -INFINITY};
      const bool full = q0 + kRows <= p.Sq && kb + kTile <= p.kv_len &&
                        (!p.causal || kb + kTile - 1 <= qpos_lo) &&
                        (p.window < 0 || kb > qpos_hi - p.window);
      if (full) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] *= p.scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int x = (i >> 1) & 1;
          const long long kj = kb + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
          bool live = valid[x] && kj < p.kv_len;
          if (p.causal) live = live && kj <= qpos[x];
          if (p.window >= 0) live = live && kj > qpos[x] - p.window;
          s[i] = live ? s[i] * p.scale_log2 : -INFINITY;
          mx[x] = fmaxf(mx[x], s[i]);
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 1));
        mx[x] = fmaxf(mx[x], __shfl_xor_sync(0xffffffffu, mx[x], 2));
        const float m_new = fmaxf(m[x], mx[x]);
        corr[x] = 1.f;
        if (m_new != -INFINITY) {
          corr[x] = exp2f(m[x] - m_new);
          m[x] = m_new;
        }
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int x = (i >> 1) & 1;
        out[i] = m[x] == -INFINITY ? 0.f : exp2f(s[i] - m[x]);
        rs[x] += out[i];
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) l[x] = l[x] * corr[x] + rs[x];
    };
    auto issue_pv = [&](const uint32_t (&hi)[kTile / 16][4],
                        const uint32_t (&lo)[kTile / 16][4], uint32_t vs) {
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
        for (int c = 0; c < kBlk; ++c) {
          const uint64_t dv = make_desc(vs + c * kTile * 128 + kk * 16 * 128,
                                        kTile * 128);
          wgmma_rs(o[c], hi[kk], dv);
          wgmma_rs(o[c], lo[kk], dv);
        }
    };
    // V of tile t_begin + i to stage i, K of tile t_begin + i + 1 to
    // stage i + 1 (mod kStages); K of t_begin also in the first group
    load_k(t_begin, 0);
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      load_k(t_begin + i + 1, (i + 1) % kStages);
      load_v(t_begin + i, i);
      cp_async_commit();
    }
    float pr[32], corr[2];          // tile t's probabilities and factor
    if (t_begin < t_end) {
      cp_async_wait<kStages - 2>();
      fence_proxy_async();
      __syncthreads();
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
      issue_scores(s, sK);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(s);
      __syncthreads();
      softmax(s, pr, t_begin, corr);
    }
    int stage = 0;
    for (long long t = t_begin; t < t_end; ++t) {
      const int ahead = stage == 0 ? kStages - 1 : stage - 1;
      load_k(t + kStages, stage);
      load_v(t + kStages - 1, ahead);
      cp_async_commit();
      cp_async_wait<kStages - 1>();     // V of t and K of t + 1 landed
      fence_proxy_async();
      __syncthreads();
      const uint32_t vs = sV + stage * kVBytes;
      const int next = stage + 1 == kStages ? 0 : stage + 1;
#pragma unroll
      for (int c = 0; c < kBlk; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
      uint32_t hi[kTile / 16][4], lo[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float a = pr[8 * kk + 2 * e], bb = pr[8 * kk + 2 * e + 1];
          hi[kk][e] = pack_bf16(a, bb);
          const __nv_bfloat162 hv =
              *reinterpret_cast<const __nv_bfloat162*>(&hi[kk][e]);
          lo[kk][e] = pack_bf16(a - __low2float(hv), bb - __high2float(hv));
        }
#pragma unroll
      for (int c = 0; c < kBlk; ++c) fence_regs(o[c]);
      if (t + 1 < t_end) {
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
        issue_scores(s, sK + next * kTileBytes);
        wgmma_commit();
        issue_pv(hi, lo, vs);
        wgmma_commit();
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(s);
        softmax(s, pr, t + 1, corr);
        wgmma_wait0();
      } else {
        wgmma_fence();
        issue_pv(hi, lo, vs);
        wgmma_commit();
        wgmma_wait0();
      }
#pragma unroll
      for (int c = 0; c < kBlk; ++c) fence_regs(o[c]);
      stage = next;
      __syncthreads();
    }
    cp_async_wait<0>();
"""
RING = ("  // the ring: tile t_begin + i goes to stage i % kStages;",
        "  // out = O / max(l, 1e-30)")


def with_overlap(text: str) -> str:
    """``text`` (csrc/flash_prefill_sm90.cu) with the ring and tile loop of
    the (192, 128) kernel replaced by :data:`OVERLAP`."""
    i, j = text.index(RING[0]), text.index(RING[1])
    return (text[:i] + "  if constexpr (D == 192 && Dv == 128) {\n"
            + OVERLAP.lstrip("\n") + "  } else {\n" + text[i:j].rstrip()
            + "\n  }\n\n" + text[j:])


# MLA's served prefill (deepseek-v3-671b): Sq = Skv, H = KV, D, Dv
MLA = (1024, 128, 192, 128)
# the pairs the parent's kernel takes at their served prefill shapes:
# B, Sq, Skv, H, KV, D, causal, window
SERVED = {"llama3.2-1b": (1, 1024, 1024, 32, 8, 64, True, None),
          "starcoder2-7b": (1, 1024, 1024, 36, 4, 128, True, None),
          "recurrentgemma-2b": (1, 2560, 2560, 10, 1, 256, True, 2048),
          "seamless-m4t-medium encoder": (1, 1024, 1024, 16, 16, 64, False,
                                          None),
          "seamless-m4t-medium cross 700x1000": (1, 700, 1000, 16, 16, 64,
                                                 False, None),
          "llama3.2-1b train step": (8, 256, 256, 32, 8, 64, True, None)}


def entry_report(path: Path, D: int, Dv: int) -> dict:
    """Registers, spills and ptxas's performance warnings of the prefill
    kernel at (D, Dv) in the build log beside ``path``."""
    from repro_torch.kernels import _build
    tag, out, cur = f"ILi{D}ELi{Dv}E", {"warnings": []}, False
    for ln in _build.ptxas_report(path):
        if "Compiling entry" in ln:
            cur = tag in ln
        elif cur and "Used" in ln:
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
        elif cur and "spill" in ln:
            out["spill_bytes"] = sum(int(x) for x in re.findall(
                r"(\d+) bytes spill", ln))
            out["stack_bytes"] = int(re.search(r"(\d+) bytes stack",
                                               ln).group(1))
        if "Performance Loss" in ln:
            out["warnings"].append(ln)
    return out


def mla(dev, card, parent):
    import chip_smoke as CS
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    src = FK.SOURCES["flash_prefill_sm90"]
    anchor = re.search(r"template <> struct Config<192, 128> \{[^\n]*",
                       src.read_text()).group(0)
    jobs = {f"s{s}{'_overlap' if o else ''}": (
        f"flash_prefill_mla_s{s}_o{o}", src, [(anchor, (
            f"template <> struct Config<192, 128> {{ enum {{ kStages = {s} "
            f"}}; }};"))], with_overlap if o else None)
        for s in (2, 3) for o in (0, 1)}
    if parent is not None:
        jobs["parent"] = ("flash_prefill_parent",
                          parent / "src/repro_torch/csrc/flash_prefill_sm90.cu",
                          [])
    with ThreadPoolExecutor(len(jobs)) as ex:
        paths = dict(zip(jobs, ex.map(lambda a: variant_path(*a),
                                      jobs.values())))
    built = FK._library("flash_prefill_sm90")
    libs = {"as built": built}
    for name, path in paths.items():
        libs[name] = ctypes.CDLL(str(path))
        bind(libs[name], FK, "repro_flash_prefill_sm90",
             FK._ARGS["flash_prefill_sm90"])
    record, bad = {"card": card, "variants": {}}, []
    for name in [n for n in paths if n != "parent"]:
        rep = entry_report(paths[name], 192, 128)
        record["variants"][name] = dict(rep)
        ok = rep.get("registers", 256) <= 255 and not rep.get("spill_bytes")
        if not ok:
            bad.append(f"{name}: registers or spills {rep}")
        print(f"mla: variant {name}: ptxas (192, 128) {rep} [{card}]",
              flush=True)

    def run(lib, q, k, v, **kw):
        FK._libs["flash_prefill_sm90"] = libs[lib]
        try:
            return FK.flash_prefill_cuda(q, k, v, **kw)
        finally:
            FK._libs["flash_prefill_sm90"] = built

    gen = torch.Generator(device=dev).manual_seed(0)

    def inputs(B, Sq, Skv, H, KV, D, Dv):
        r = lambda *s: torch.randn(*s, device=dev, generator=gen).bfloat16()
        return r(B, Sq, H, D), r(B, Skv, KV, D), r(B, Skv, KV, Dv)

    # (192, 128): every variant bit-equal to the kernel as built
    cases, _ = CS.flash_cases()
    calls = [(f"{name} G {G}", 8, G, sq, skv, kw)
             for name, sq, skv, kw in cases for G in (1, 4)]
    Sq, H, D, Dv = MLA
    calls.append(("deepseek-v3-671b prefill", H, 1, Sq, Sq,
                  dict(softmax_scale=D ** -0.5)))
    worst, n_calls = 0.0, 0
    for name, KV, G, sq, skv, kw in calls:
        kw = dict(kw)
        q, k, v = inputs(kw.pop("batch", 1), sq, skv, KV * G, KV, D, Dv)
        args = dict(causal=kw.get("causal", True), window=kw.get("window"),
                    q_start=kw.get("q_start", 0),
                    kv_len=kw.get("kv_len", skv),
                    softmax_scale=kw.get("softmax_scale"))
        want = flash_attention(q, k, v, impl="torch", **kw)
        base = run("as built", q, k, v, **args)
        e, ok = CS.fa_err(base, want)
        worst, n_calls = max(worst, e), n_calls + 1
        if not ok:
            bad.append(f"(192, 128) {name}: vs the plain version {e}")
        for lib in [n for n in libs if n not in ("as built", "parent")]:
            if not torch.equal(run(lib, q, k, v, **args), base):
                bad.append(f"(192, 128) {name}: {lib} differs")
    torch.cuda.synchronize()
    record["mla_calls"] = n_calls
    print(f"mla: {n_calls} calls at (192, 128), each through the kernel as "
          f"built and the {len(paths) - (parent is not None)} variants: "
          f"{'bit-equal' if not bad else bad}; worst error vs the plain "
          f"version {worst:.3e} [{card}]", flush=True)

    # the served shape, the variants in turns
    q, k, v = inputs(1, Sq, Sq, H, H, D, Dv)
    args = dict(causal=True, window=None, q_start=0, kv_len=Sq,
                softmax_scale=D ** -0.5)
    names = [n for n in paths if n != "parent"]
    order = names + names[::-1]
    turns = {n: [] for n in names}
    for n in order:
        turns[n].append(CS.graph_ms(lambda q, k, v, n=n: run(n, q, k, v,
                                                             **args),
                                    (q, k, v), dev, reps=20) * 1e3)
    import torch.nn.functional as F
    other = {
        "simple kernel": lambda q, k, v: FK.flash_simple_cuda(q, k, v,
                                                               **args),
        "plain": lambda q, k, v: flash_attention(
            q, k, v, impl="torch", causal=True, softmax_scale=D ** -0.5),
        "sdpa": lambda q, k, v: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, scale=D ** -0.5).transpose(1, 2),
    }
    times = {n: CS.graph_ms(fn, (q, k, v), dev) * 1e3
             for n, fn in other.items()}
    b_ms, o_ms = CS.fa_bound(q, k, v, dict(q_start=0, kv_len=Sq,
                                           causal=True))
    flops = 2 * H * (D + Dv) * Sq * (Sq + 1) / 2
    record["served"] = dict(turns_us=turns, others_us=times,
                            bound_us=max(b_ms, o_ms) * 1e3,
                            bound_by="bytes" if b_ms >= o_ms
                            else "operations", flops=flops)
    for n, us in turns.items():
        print(f"mla: deepseek-v3-671b prefill (H {H}, {Sq} tokens, causal, "
              f"bf16) {n}: us per launch in turns {us[0]:.2f}, {us[1]:.2f} "
              f"({flops / (min(us) * 1e-6) / 1e12:.1f} TFLOP/s) [{card}]",
              flush=True)
    print(f"mla: the same shape: simple kernel {times['simple kernel']:.2f}"
          f" us, plain {times['plain']:.2f}, SDPA {times['sdpa']:.2f}, "
          f"bound {max(b_ms, o_ms) * 1e3:.3f} "
          f"({record['served']['bound_by']}) [{card}]", flush=True)

    if parent is not None:
        # the other pairs: bit-equal to the parent's kernel, and its times
        _, mqa = CS.flash_cases()
        n_calls, n_bad = 0, len(bad)
        for D2, Dv2 in FK.PREFILL_HEAD_DIMS:
            if D2 != Dv2:
                continue
            todo = [(8, G, sq, skv, kw) for _, sq, skv, kw in cases
                    for G in (1, 4)]
            if D2 == CS.MQA_D:
                todo += [(1, CS.MQA_H, sq, skv, kw) for _, sq, skv, kw in mqa]
            todo += [(KV, H2 // KV, sq, skv, dict(
                causal=c, window=w, batch=B)) for B, sq, skv, H2, KV, d, c, w
                in SERVED.values() if d == D2]
            for KV, G, sq, skv, kw in todo:
                kw = dict(kw)
                q2, k2, v2 = inputs(kw.pop("batch", 1), sq, skv, KV * G, KV,
                                    D2, Dv2)
                a = dict(causal=kw.get("causal", True),
                         window=kw.get("window"),
                         q_start=kw.get("q_start", 0),
                         kv_len=kw.get("kv_len", skv))
                n_calls += 1
                if not torch.equal(run("as built", q2, k2, v2, **a),
                                   run("parent", q2, k2, v2, **a)):
                    bad.append(f"({D2}, {Dv2}) {sq}x{skv} G {G} {kw}: "
                               f"differs from the parent's kernel")
        torch.cuda.synchronize()
        record["parent_calls"] = n_calls
        print(f"mla: {n_calls} calls at (64, 64), (128, 128), (256, 256) "
              f"against {parent}'s kernel: "
              f"{n_calls - (len(bad) - n_bad)} bit-equal [{card}]",
              flush=True)
        record["parent_turns_us"] = {}
        for label, (B, sq, skv, H2, KV, d, c, w) in SERVED.items():
            q2, k2, v2 = inputs(B, sq, skv, H2, KV, d, d)
            a = dict(causal=c, window=w, q_start=0, kv_len=skv)
            us = [CS.graph_ms(lambda q, k, v, n=n: run(n, q, k, v, **a),
                              (q2, k2, v2), dev, reps=20) * 1e3
                  for n in ("as built", "parent", "parent", "as built")]
            record["parent_turns_us"][label] = us
            ratio = (us[0] + us[3]) / (us[1] + us[2])
            print(f"mla: {label} prefill (B {B}, Sq {sq}, Skv {skv}, H {H2}, "
                  f"KV {KV}, D {d}, causal {c}, window {w}) us per launch, "
                  f"this / other / other / this: "
                  f"{', '.join(f'{u:.2f}' for u in us)}; this / other "
                  f"{ratio:.4f} [{card}]", flush=True)
    record["failed"] = bad
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "flash_probe_mla.json").write_text(json.dumps(record, indent=1))
    if bad:
        print(f"FAIL: {bad}", flush=True)
    return 1 if bad else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("phases", "precision", "mla"))
    ap.add_argument("--parent", type=Path, default=None,
                    help="mla: root of another checkout whose prefill "
                         "kernel the (64, 64), (128, 128) and (256, 256) "
                         "calls are held and timed against")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: this probe needs a CUDA card")
        return 2
    import chip_smoke as CS
    dev = torch.device("cuda", torch.cuda.current_device())
    card = CS.card_line()
    if args.mode == "mla":
        return mla(dev, card, args.parent)
    (phases if args.mode == "phases" else precision)(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
