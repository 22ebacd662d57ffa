#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run it from the root of a checkout.  It needs one CUDA card, ``nvcc`` and
nothing of JAX.  Phases, each fatal (an exception or a failed check exits
non-zero):

1. build   -- compile ``src/repro_torch/csrc/arena.cu``,
              ``flash_attention.cu``, ``flash_decode.cu``,
              ``flash_prefill_sm90.cu``, ``flash_backward.cu``,
              ``flash_backward_sm90.cu``, ``wkv6.cu`` and ``rglru.cu``
              (nvcc, sm_90a, all eight started together) and print the
              build seconds of each, the registers, shared memory and
              spills (``-Xptxas -v``) of the arena kernels (accum among
              them), the WKV-6 and RG-LRU kernels and the four newer flash
              kernels, the card's name and power limit;
2. kernels -- hold each arena kernel against its plain PyTorch version on
              the card.  write and read (one vectorised byte copy split by
              ``copy_plan``), f32 and u8: every destination phase x source
              phase mod 16 the dtype allows (u8: all 256 pairs up to 65
              elements, the multiples of 4 beyond), lengths 0, 1, 3, 15,
              16, 17, 63, 64, 65, 4097 and 150,528 elements (the largest
              tensor of the DARTS cell) and one llama3.2-1b KV leaf of
              17,301,504 B, x, arena and out as views at a storage offset,
              read also into an out view through its C entry: bit-equal,
              the bytes around the slice and the sources unchanged, the
              cases counted per (op, dtype, mode); a split that does not
              fit its addresses refused.  accum (the same split over f32)
              at every arena phase x x phase mod 16 bytes, x a view at a
              storage offset, at the f32 lengths above: bit-equal to the
              plain version, the floats around the slice and x unchanged;
              a split that does not fit its addresses, or is not whole
              floats, refused.  chain_write (the same split) of every
              single op and five longer chains at every arena phase x x
              phase mod 16 bytes, at the f32 lengths above: exact chains
              bit-equal to the plain version, the rest allclose, the floats
              around the slice and x unchanged; a split that does not fit
              its addresses, or is not whole floats, refused (its launch
              raises).  accum and the exact chain ops also
              bit-equal at random offsets and lengths 0, 1, 3, 4097 and
              150,528, the transcendental chain ops allclose; n == 0
              launches nothing;
3. flash   -- hold the three flash-attention kernels (the split-K
              decode, the ``wgmma`` prefill and the simple kernel) against
              the plain PyTorch version (``impl="torch"``) and the oracle
              (``impl="ref"``) on the card, each case through every kernel
              that takes it (the simple kernel takes all; the decode kernel
              Sq * G <= 16; the prefill kernel bf16 at 64/64, 128/128 and
              256/256): bf16 and f32, every (D, Dv) the wrapper takes
              (16/16, 64/64, 128/128, 192/128, 256/256), GQA groups 1 and 4,
              decode over caches of 1/127/1056/4097 keys, causal prefill of
              1/33/1024 tokens, a sliding window, a prefill against a
              partly filled cache, non-causal attention (with a window, and
              against a partly filled cache), batch 2 at decode and
              prefill, and a cache whose tail beyond kv_len holds garbage
              that must not leak; then
              recurrentgemma-2b's multi-query shape (D 256, G 10, KV 1,
              window 2048): decode over 2592 keys, causal prefill of 2560,
              a garbage tail; f32 within rtol 1e-5 + atol 1e-5, bf16 within
              one bf16 ulp of the output + 1e-5.  Then the split-K decode's
              partials (m, l, acc of each split, at its own rule and at 7
              and 64 splits) against ``flash_decode_partials_torch`` and its
              output against ``flash_decode_combine_torch``, with splits
              fully masked for some rows and a row masked in every split
              (output 0, no NaN); and the launch a captured decode step
              makes, the position on the device and the capacity split
              rule, at llama3.2-1b's and recurrentgemma-2b's served caches
              and a small f32 one, at positions from 0 to the last: the
              rule's splits, partials and output against the plain
              versions with a tensor position and the oracle, and bit-equal
              to the host-position launch wherever the host rule splits
              alike; and the launch a batched decode step makes, a
              position per batch row (buckets 4 and 8 of llama3.2-1b's
              cache, 4 of recurrentgemma-2b's with rows cut by the
              window, a small f32 one): partials and output against the
              plain versions at the same positions and the oracle, each
              row against the oracle of the row alone, and every row at
              one position bit-equal to the 0-d launch;
4. wkv6    -- hold the WKV-6 kernel against its plain version on the card:
              bf16 and f32, N 16/32/64, batch 1 at T 1/7/256/1000/1024
              with and without an initial state, and batch 2 at T 1000
              and 3 chunks + 5 steps (T 7, 1000 and that one end in a
              ragged chunk): outputs within the flash phase's tolerances
              plus the rounding bound of two f32 sums of N + 1 terms
              (2 (N + 1) 2^-24 times the terms' magnitudes), final states
              bit-equal; a split run (T/2 + T/2, the state threaded), a
              run of T 7 one step a launch (the one-step path) and a run
              whose final state overwrites its initial state in place
              equal the whole run bit for bit;
5. rglru   -- the same for the RG-LRU kernels: gx bf16 and f32, D 16, 37
              (rows not 16-byte aligned), 40 (a ragged group of channels)
              at batch 2 and 2560 at batch 1, T 1, 5, the route threshold
              and one either side, a chunk and one either side, and 2560,
              with and without h0; every case through both kernels (the
              staged and the step kernel), which must agree bit for bit on
              h and hT; h within the same tolerances of the plain version,
              hT within rtol 1e-5 + atol 1e-5 (the bit-equal share is
              printed); in-place runs and runs split in two (at the middle,
              and after the threshold's steps, across the route boundary)
              bit-equal to the whole run;
6. main    -- plan every paper graph and full network with SERENITY and
              execute it in one arena on the card, slice-per-node and fused:
              realized == planned bytes, slice path bit-equal to
              ``run_reference`` on the card, fused path bit-equal where every
              fused chain is exact (else allclose), the planner's known
              integers, a uint8 pack/unpack round trip; then every one
              again with ``jit=True`` (one CUDA graph per program, the
              counterpart of ``repro``'s whole-program jit), slice and
              fused: the first call, a replay and a replay with other
              inputs bit-equal to the eager runs and held to
              ``run_reference`` as they are, a replay's outputs not
              overwritten by the next, realized == planned, and the arena
              launches per replay, as the capture counted them and in the
              most complete of three or more traces of a replay (up to
              ``TRACE_TRIES``), equal to the eager run's; each of the four kernels launched > 0 times over the
              run;
7. serve   -- the serving path, once per model at its published width
              (random weights from a seed; for ``rwkv6-7b`` and
              ``recurrentgemma-2b`` the recurrent mixing leaves, zeros or
              ones at init, filled with seeded values so that the carried
              state matters, which is checked) behind ``run_server``, 4
              requests of 32 generated tokens under the CLI's default
              budget: ``llama3.2-1b`` and ``rwkv6-7b`` with 1024 prompt
              tokens, ``recurrentgemma-2b`` with 2560 (longer than its
              2048-key window), every decode token through the server's
              one captured decode step (a CUDA graph for every position):
              the decode plan's integers, 4 served and
              128 tokens, tokens bit-equal to an eager prefill + decode
              loop that keeps the cache as plain tensors, the first decode
              steps' logits of the kernels allclose to the plain versions' (in
              f32, and in bf16 as served), every
              kernel's launches over the run exactly the path's count (an
              attention layer: one ``wgmma`` prefill per request and one
              split-K decode per decode step, the simple kernel never; an
              RG-LRU layer: one staged launch per prompt and one step
              launch per decode step), and
              one prefilled cache packed and unpacked at the served plan by
              the u8 kernels bit-equal to their plain versions; then the
              batched decode (``step_mode="vmap"``, one captured step per
              bucket): the same 4 requests, and the first 3 (bucket 4 with
              a padding row reserved as scratch), their tokens equal to
              the serial run's up to a first divergence at a step whose
              serial top-1 margin is under the model's bf16 logit
              tolerance, every kernel's launches over each run exactly
              the batched path's count, the peak reserved bytes 4 arenas,
              and the logits of LOGIT_STEPS batched steps of 4 rows at
              their own positions against each row's serial step (f32,
              and bf16 as served at the model's tolerance);
8. timing  -- microseconds per ``execute`` of the two full networks, eager
              and captured (``jit=True``) in turns, each with the device's
              busy time and idle share, and per
              kernel at the launches the main paths made: the kernel, its
              bound, its plain version and the one torch call that computes
              the same (a yardstick, never called by the port), for write
              and read also cold (L2 flushed before each launch) and inside
              a replayed CUDA graph of the launches beside ``copy_`` there;
              for each served model its prefill ms per request, ms per
              decode token captured (the server) and eager (the same
              token's unpack, eager step and pack),
              the device's busy time and idle share over one prefill (with
              its largest kernels) and one decode step and
              its launches (no more device activities per decode token than
              ``ACTIVITIES``, in a trace that holds all of them), the u8
              arena write/read at the served leaves (one launch of each
              per leaf a decode token, by the launch counts; the kernels
              found by name in a trace of their own; replayed warm (each
              time from a trace that holds every launch, else not
              measured) and with L2 flushed before each launch, against
              the bound, the plain version and one torch copy), and its
              recurrence or
              attention kernel at
              decode and prefill shapes (attention: the routed kernel, the
              decode kernel at a device position, the
              simple kernel, the plain version and SDPA; RG-LRU: also both
              kernels at the prefill shape); chain_write beside ``copy_``
              of the same bytes, a floor of its launch; and for each
              served model the batched tick at bucket 4: ms per tick and
              per token, its launches (the captured step's recorded counts
              plus one u8 read and write a leaf and row, checked), device
              busy time, idle share and activities (no limit), each
              kernel's us per launch in the tick's trace (the kernels
              JSON rows' ``batched``), and the row staging copies against
              their bound.

9. train   -- the training path, the serving models' weights freed: at
              llama3.2-1b's heads (H 32, KV 8, D 64) with B 8 x S 256 and
              the ragged S 200 and 17, bf16 and f32, the forward kernel's
              output against ``_flash_torch`` and ``attention_ref`` (the
              flash tolerance) and both flash backward kernels against
              their plain version (``flash_attention_backward_torch``; f32
              within 1e-4 of each gradient's largest magnitude, bf16
              within 4 ulps of it): the tensor-core kernel
              (``flash_backward_sm90.cu``, the bf16 route) in bf16, the
              CUDA-core kernel (``flash_backward.cu``, the f32 route) in
              both; the tensor-core kernel against the CUDA-core one in
              bf16 (the readings printed) and two runs of it bit-equal;
              and ``FlashAttentionFn`` against
              autograd of the plain forward (f32 at (2, 200), bf16 at
              (8, 256), the prefill route); the full-width llama3.2-1b
              gradient through the kernels against the plain versions',
              leaf by leaf and layer by layer (relative L2 within 3e-2),
              and a deliberately broken backward reading above that; one
              full-width train step through the kernels
              (impl="auto": the ``wgmma`` prefill forward, the tensor-core
              backward) against the same step through the plain versions
              (loss and grad_norm within the bf16 logit tolerance), with
              16 launches of each flash kernel, the backward's all on the
              tensor-core route; the step's ms (host clock,
              ending in ``synchronize``), tokens/s, model FLOPs' share of
              989 TFLOP/s, device busy time and idle share, peak memory;
              ``launch/train.py``'s ``main`` in process for 7 steps at the
              CLI's defaults (batch 8, seq 256, AdamW, bf16) with a
              checkpoint at step 4, its launches counted from 0 (16 x 7 of
              each flash kernel, the backward's 112 on the tensor-core
              route), every loss finite, and a second run
              resumed from that checkpoint alone, whose parameters and
              optimizer state end bit-equal to the first's (both under
              ``torch.use_deterministic_algorithms(True)``); rwkv6-7b's
              and Griffin's ``loss_fn`` raising under autograd on the card
              (no backward kernel yet); and the flash forward and backward
              at the step's shape against their bounds, their plain
              versions and SDPA's forward and backward, the two backward
              kernels timed in turns (CUDA-core, tensor-core, tensor-core,
              CUDA-core).

10. bridge -- (run after phase 6) the graph bridge
              (``repro_torch/core/fx_bridge.py``): each function of
              ``repro_torch/graphs/programs.py`` (``wide`` at x 64 x 64,
              the rest at the bench's 64 x 128 f32, ``nas_cell`` also at
              2048 x 1024, a 76 MB arena) traced to aten, scheduled
              (host seconds printed) and run by ``compile_scheduled``
              through one planned uint8 arena on the card, eagerly and
              captured (``jit=True``): the program run once through the
              arena kernels and once through their plain versions, each
              in a zeroed arena, with bit-equal outputs and final arena
              bytes; outputs bit-equal to the unscheduled function's
              (the same aten ops on the same bytes), captured
              bit-equal to eager (a replay, one with other inputs, a
              replay's outputs kept), realized == optimal peak, arena >=
              peak, ``exact`` where ``repro``'s is, the arena launches per
              call (one write per threaded tensor, one read per op and
              distinct threaded input) in each eager call, the capture's
              count and the most complete of up to ``TRACE_TRIES`` traces
              of a replay, both kernels launched; prints nodes, the
              traced / Kahn / optimal / arena bytes, the caching
              allocator's peak over one unscheduled call and over one
              eager arena call (inputs counted in both), and us per call
              (unscheduled, eager arena, captured; CUDA events, median of
              20).  The ``arena_write``/``arena_read`` JSON rows carry the
              bridge's launches per call (``bridge``).

The kernels JSON (one entry per kernel) is printed third from last, the
card's name and power limit second from last, and ``{"ok": true,
"device": {...}}`` last.  Without CUDA, or outside a checkout, it exits
non-zero before printing any of them.
"""

from __future__ import annotations

import ctypes
import gc
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
BF16_FLOP_PER_S = 989e12           # dense bf16 tensor-core peak, same sheet
F32_FLOP_PER_S = 67e12             # f32 outside the tensor cores, same sheet
SIZES = (0, 1, 3, 4097, 150528)    # 150,528 f32 = 28x28x48x4 B: DARTS fmap
# the copy sweep of write and read: lengths in elements; u8 runs every
# phase pair up to COPY_SHORT and the multiples of 4 beyond, and one
# llama3.2-1b KV leaf (16 layers x 1056 x 8 KV heads x 64 x bf16)
COPY_LENGTHS = (0, 1, 3, 15, 16, 17, 63, 64, 65, 4097, 150528)
COPY_SHORT, LLAMA_LEAF = 65, 17_301_504
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-6  # expf/tanhf vs torch's eager kernels
FLUSH_BYTES = 256 << 20            # written between cold launches: 5x L2
SEED = 0

# file:line of the Pallas kernel each CUDA kernel replaces
REPLACES = {
    "write": "src/repro/kernels/arena/kernel.py:65",
    "read": "src/repro/kernels/arena/kernel.py:89",
    "accum": "src/repro/kernels/arena/kernel.py:77",
    "chain_write": "src/repro/kernels/arena/kernel.py:100",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:109",
    "wkv6": "src/repro/kernels/rwkv6/kernel.py:63",
    "rglru": "src/repro/kernels/rglru/kernel.py:49",
}
FA_RTOL32 = FA_ATOL32 = 1e-5       # f32: sums in another order
FA_ATOL16 = 1e-5                   # bf16: + one ulp of the output
# recurrentgemma-2b's attention: multi-query, head dim 256, local window
MQA_H, MQA_D, MQA_WINDOW = 10, 256, 2048
# serving, each model at its published width: 4 requests of GEN tokens,
# the decode plan's known integers (from the JAX package), and the atol of
# the kernels' logits against the plain versions' over prefill and
# LOGIT_STEPS decode steps (|logit| up to ~5).  With params and cache in
# f32 the two differ by sums taken in another order: LOGIT_ATOL32 for
# all.  In bf16, as served, they differ where a rounding flips; the
# recurrent models carry each flip through their state for the whole
# prompt (rwkv6-7b: 0.217 at max |logit| 4.97 on the card, while the f32
# runs agree to 5e-5), so their bf16 atol is wider.
GEN, N_REQ, LOGIT_STEPS, LOGIT_ATOL32 = 32, 4, 8, 2e-3
SERVES = {
    "llama3.2-1b": dict(
        prompt=1024, logit_atol=5e-2,
        plan={"arena_bytes": 35_124_228, "resident_extent": 34_603_012,
              "transient_bytes": 521_216, "n_buffers": 53}),
    "rwkv6-7b": dict(
        prompt=1024, logit_atol=5e-1,
        plan={"arena_bytes": 34_357_252, "resident_extent": 34_078_724,
              "transient_bytes": 278_528, "n_buffers": 102}),
    "recurrentgemma-2b": dict(
        prompt=2560, logit_atol=5e-1,
        plan={"arena_bytes": 22_728_708, "resident_extent": 21_694_468,
              "transient_bytes": 1_034_240, "n_buffers": 89}),
}
RG_RTOL = RG_ATOL = 1e-5           # rglru f32: exp of two libraries
# device activities per decode token with one request in flight, counted in
# traces that hold the step's first kernels (``device_profile``'s lead), as
# the flash, arena and recurrence kernels stood before their Hopper
# redesigns; the redesigns must not add any.  Limits read from traces
# without the lead (999 / 2806 / 1511) were low by the kernels those traces
# missed, so a trace that held them failed with nothing risen.
ACTIVITIES = {"llama3.2-1b": 999, "rwkv6-7b": 2808, "recurrentgemma-2b": 1515}
TOKEN_TRACES = 3
# traces lose events at random on the card's machine (a trace of a replay
# has come back with 3514 of its 4162 activities, and four in a row have
# come back empty): a check that needs one whole trace takes up to this
# many, and the most complete of them must hold every launch
TRACE_TRIES = 8
# the split-K decode's partials against the plain version's: m to rtol/atol
# 1e-5; l and acc to 1e-5 plus 1e-5 times the summands' magnitude (at most
# l for l, l * max|v| for acc)
SPLIT_TOL = 1e-5


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def sweep_copy(dev) -> dict:
    """write and read, f32 and u8, at every destination phase x source
    phase mod 16 that the dtype allows (u8: all 16 x 16 up to COPY_SHORT
    elements, multiples of 4 beyond), at COPY_LENGTHS elements and (u8)
    one llama3.2-1b KV leaf.  x, the arena and out are views at a storage
    offset that sets their phase; write goes through its wrapper, read
    through its wrapper (a fresh out, phase 0) and through its C entry into
    every phase of an out view.  Each result is bit-equal to the plain
    version, and the bytes on both sides of the slice (and of the out
    view) are unchanged.  A split that does not fit its addresses is
    refused.  Returns the cases run per (op, dtype, mode)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = {}

    def rand(n, dtype):
        if dtype == torch.uint8:
            return torch.randint(0, 256, (n,), dtype=dtype, device=dev,
                                 generator=gen)
        return torch.randn(n, device=dev, generator=gen)

    def count(op, dtype, plan):
        key = f"{op} {str(dtype).split('.')[1]} {plan.mode}"
        cases[key] = cases.get(key, 0) + 1

    def read_into(out, arena, o):
        esz, n = arena.element_size(), out.shape[0]
        plan = K.copy_plan(out.data_ptr(), arena.data_ptr() + esz * o, esz * n)
        fn = getattr(K._library(), "repro_arena_read_"
                     + ("u8" if esz == 1 else "f32"))
        _build.raise_on(fn(arena.data_ptr(), out.data_ptr(), o, n, *plan,
                           stream), "arena_read into a view")
        return plan

    for dtype in (torch.float32, torch.uint8):
        esz = torch.tensor([], dtype=dtype).element_size()
        per16 = 16 // esz            # elements in 16 bytes
        lengths = COPY_LENGTHS + ((LLAMA_LEAF,) if esz == 1 else ())
        for n in lengths:
            step = 1 if esz == 4 or n <= COPY_SHORT else 4
            phases = range(0, per16, step)
            guard = 2 * per16        # elements on each side of a slice
            full = rand(guard + n + 2 * guard, dtype)
            src = rand(n + per16, dtype)
            keep, keep_src = full.clone(), src.clone()
            outbuf = rand(n + 2 * per16, dtype)
            for dp in phases:
                o = guard + dp                 # dst phase: dp elements
                for sp in phases:
                    x = src[sp:sp + n]         # src phase: sp elements
                    a = full.clone()
                    K.arena_write_cuda(a, x, o)
                    want = R.arena_write_torch(full.clone(), x, o)
                    count("write", dtype, K.copy_plan(
                        a.data_ptr() + esz * o, x.data_ptr(), esz * n))
                    check(torch.equal(a, want)
                          and torch.equal(a[:o], full[:o])
                          and torch.equal(a[o + n:], full[o + n:]),
                          f"write {dtype} n={n} dst phase {dp} src phase "
                          f"{sp}: differs from the plain version")
                    # read: the arena seen at storage offset sp, so its
                    # slice at o has phase sp + dp; out at phase dp
                    arena = full[sp:]
                    want = R.arena_read_torch(arena, o, n)
                    out = outbuf.clone()
                    view = out[dp:dp + n]
                    count("read", dtype, read_into(view, arena, o))
                    check(torch.equal(view, want)
                          and torch.equal(out[:dp], outbuf[:dp])
                          and torch.equal(out[dp + n:], outbuf[dp + n:]),
                          f"read {dtype} n={n} into an out view at phase "
                          f"{dp}, arena phase {sp + dp}: differs from the "
                          f"plain version or wrote outside the view")
                    if dp == 0:
                        got = K.arena_read_cuda(arena, o, n)
                        count("read", dtype, K.copy_plan(
                            got.data_ptr(), arena.data_ptr() + esz * o,
                            esz * n))
                        check(torch.equal(got, want) and (
                            n == 0 or got.data_ptr() != arena.data_ptr()),
                            f"read {dtype} n={n} arena phase {sp}")
                    check(torch.equal(full, keep)
                          and torch.equal(src, keep_src),
                          f"{dtype} n={n}: a copy changed its source")
            del full, keep, src, keep_src, outbuf
    torch.cuda.synchronize()

    # a split that does not fit its two addresses is refused, not launched
    a, x = rand(64, torch.uint8), rand(48, torch.uint8)
    good = K.copy_plan(a.data_ptr() + 5, x.data_ptr(), 48)
    fn = K._library().repro_arena_write_u8
    for bad in (good._replace(phase=(good.phase + 1) % 16),
                good._replace(head=good.head + 16),
                good._replace(tail=good.tail + 1)):
        check(fn(a.data_ptr(), x.data_ptr(), 5, 48, *bad, stream) != 0,
              f"the write entry launched a wrong split {bad}")
    torch.cuda.synchronize()
    return cases


def sweep_accum(dev) -> dict:
    """accum at every arena phase x x phase mod 16 bytes (whole floats),
    at the f32 COPY_LENGTHS: x a view of a larger tensor at a storage
    offset, the slice of an arena with guard floats on both sides.  Each
    result is bit-equal to the plain version, with the guard floats and x
    unchanged; a split that does not fit its addresses, or is not whole
    floats, is refused.  Returns the cases run per mode."""
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    cases = {}
    for n in COPY_LENGTHS:
        guard = 8                                # floats each side
        full = torch.randn(guard + n + 2 * guard, device=dev, generator=gen)
        src = 3 * torch.randn(n + 4, device=dev, generator=gen)
        keep_src = src.clone()
        for dp in range(4):                      # arena phase: dp floats
            o = guard + dp
            for sp in range(4):                  # x phase: sp floats
                x = src[sp:sp + n]
                a = full.clone()
                plan = K.copy_plan(a.data_ptr() + 4 * o, x.data_ptr(), 4 * n)
                K.arena_accum_cuda(a, x, o)
                want = R.arena_accum_torch(full.clone(), x, o)
                key = f"accum {plan.mode}"
                cases[key] = cases.get(key, 0) + 1
                check(torch.equal(a, want)
                      and torch.equal(a[:o], full[:o])
                      and torch.equal(a[o + n:], full[o + n:])
                      and torch.equal(src, keep_src),
                      f"accum n={n} arena phase {4 * dp} B, x phase "
                      f"{4 * sp} B: differs from the plain version or "
                      f"touched a float outside the slice")
    torch.cuda.synchronize()

    stream = torch.cuda.current_stream(dev).cuda_stream
    a, x = torch.zeros(64, device=dev), torch.zeros(16, device=dev)
    good = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 48)
    fn = K._library().repro_arena_accum_f32
    for bad in (good._replace(phase=(good.phase + 4) % 16),
                good._replace(head=good.head + 16),
                good._replace(tail=good.tail + 4)):
        check(fn(a.data_ptr(), x.data_ptr(), 1, 12, *bad, stream) != 0,
              f"the accum entry launched a wrong split {bad}")
    # 3 floats, all head: a split of 9 + 3 bytes fits the addresses but
    # cuts floats
    small = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 12)
    bad = small._replace(head=small.head - 3, tail=small.tail + 3)
    check(small.nvec == 0 and fn(a.data_ptr(), x.data_ptr(), 1, 3, *bad,
                                 stream) != 0,
          f"the accum entry launched a split that cuts floats {bad}")
    torch.cuda.synchronize()
    return cases


def sweep_chain(dev, chains, err) -> tuple[dict, float]:
    """chain_write of every chain in ``chains`` at every arena phase x x
    phase mod 16 bytes (whole floats), at the f32 COPY_LENGTHS, as
    sweep_accum runs accum: exact chains bit-equal to the plain version,
    the rest allclose, the guard floats and x unchanged in every case; a
    split that does not fit its addresses, or is not whole floats, is
    refused and its launch raises.  Returns the cases run per (exact or
    not, mode) and the worst error of the transcendental chains."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R
    from repro_torch.kernels.arena.elemwise import (
        EXACT_OPS,
        MAX_CHAIN,
        chain_codes,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    cases, worst = {}, 0.0
    for n in COPY_LENGTHS:
        guard = 8                                # floats each side
        full = torch.randn(guard + n + 2 * guard, device=dev, generator=gen)
        src = 3 * torch.randn(n + 4, device=dev, generator=gen)
        keep_src = src.clone()
        for ops in chains:
            exact = set(ops) <= EXACT_OPS
            for dp in range(4):                  # arena phase: dp floats
                o = guard + dp
                for sp in range(4):              # x phase: sp floats
                    x = src[sp:sp + n]
                    a = full.clone()
                    plan = K.copy_plan(a.data_ptr() + 4 * o, x.data_ptr(),
                                       4 * n)
                    K.arena_chain_write_cuda(a, x, o, ops)
                    want = R.arena_chain_write_torch(full.clone(), x, o, ops)
                    key = f"{'exact' if exact else 'transcendental'} " \
                          f"{plan.mode}"
                    cases[key] = cases.get(key, 0) + 1
                    what = (f"chain_write {ops} n={n} arena phase {4 * dp} "
                            f"B, x phase {4 * sp} B")
                    check(torch.equal(a[:o], full[:o])
                          and torch.equal(a[o + n:], full[o + n:])
                          and torch.equal(src, keep_src),
                          f"{what}: touched a float outside the slice or x")
                    e = 0.0 if n == 0 else float(
                        (a.double() - want.double()).abs().max())
                    err["chain_write"] = max(err["chain_write"], e)
                    if exact:
                        check(torch.equal(a, want),
                              f"{what}: differs from the plain version")
                    else:
                        worst = max(worst, e)
                        check(torch.allclose(a, want, rtol=CHAIN_RTOL,
                                             atol=CHAIN_ATOL),
                              f"{what}: max abs err {e}")
    torch.cuda.synchronize()

    stream = torch.cuda.current_stream(dev).cuda_stream
    a, x = torch.zeros(64, device=dev), torch.zeros(16, device=dev)
    codes = chain_codes(("bn", "relu"))
    chain = K._ChainOps(len(codes), (ctypes.c_int * MAX_CHAIN)(*codes))
    good = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 48)
    small = K.copy_plan(a.data_ptr() + 4, x.data_ptr(), 12)
    fn = K._library().repro_arena_chain_write_f32
    for bad, n in ((good._replace(phase=(good.phase + 4) % 16), 12),
                   (good._replace(head=good.head + 16), 12),
                   (good._replace(tail=good.tail + 4), 12),
                   # 9 + 3 bytes: fits the addresses, cuts floats
                   (small._replace(head=small.head - 3,
                                   tail=small.tail + 3), 3)):
        try:
            _build.raise_on(fn(a.data_ptr(), x.data_ptr(), 1, n, *bad, chain,
                               stream), "arena_chain_write")
        except _build.KernelLaunchError:
            continue
        check(False, f"the chain_write entry launched a wrong split {bad}")
    torch.cuda.synchronize()
    return cases, worst


def phase_kernels(dev, rng, err):
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R
    from repro_torch.kernels.arena.elemwise import ELEMWISE_OP_CODES, EXACT_OPS

    def arena_and_x(n, dtype):
        pad = int(rng.integers(0, 97))
        size = n + pad + int(rng.integers(0, 65))
        if dtype == torch.uint8:
            a = rng.integers(0, 256, size, dtype=np.uint8)
            x = rng.integers(0, 256, n, dtype=np.uint8)
        else:
            a = rng.standard_normal(size).astype(np.float32)
            x = (3 * rng.standard_normal(n)).astype(np.float32)
        return (torch.from_numpy(a).to(dev), torch.from_numpy(x).to(dev), pad)

    def record(name, got, want):
        e = 0.0 if got.numel() == 0 else float(
            (got.double() - want.double()).abs().max())
        err[name] = max(err[name], e)
        return e

    cases = sweep_copy(dev)      # bit-equal: write/read errors stay 0
    cases.update(sweep_accum(dev))
    for n in SIZES:
        a, x, o = arena_and_x(n, torch.float32)
        got = K.arena_accum_cuda(a.clone(), x, o)
        want = R.arena_accum_torch(a.clone(), x, o)
        record("accum", got, want)
        check(torch.equal(got, want), f"accum n={n}")

    chains = [(op,) for op in ELEMWISE_OP_CODES] + [
        ("relu", "bn"), ("bn", "relu"), ("relu", "bn", "relu", "bn"),
        ("bn", "scale", "bias_add", "relu6"), ("gelu", "silu", "tanh")]
    chain_cases, chain_worst = sweep_chain(dev, chains, err)
    worst_transcendental = 0.0
    for ops in chains:
        for n in SIZES:
            a, x, o = arena_and_x(n, torch.float32)
            got = K.arena_chain_write_cuda(a.clone(), x, o, ops)
            want = R.arena_chain_write_torch(a.clone(), x, o, ops)
            e = record("chain_write", got, want)
            if set(ops) <= EXACT_OPS:
                check(torch.equal(got, want), f"chain_write {ops} n={n}")
            else:
                worst_transcendental = max(worst_transcendental, e)
                check(torch.allclose(got, want, rtol=CHAIN_RTOL,
                                     atol=CHAIN_ATOL),
                      f"chain_write {ops} n={n}: max abs err {e}")
    torch.cuda.synchronize()

    K.reset_launches()
    a, x, _ = arena_and_x(0, torch.float32)
    K.arena_write_cuda(a, x, 0)
    K.arena_accum_cuda(a, x, 0)
    K.arena_chain_write_cuda(a, x, 0, ("relu",))
    check(K.arena_read_cuda(a, 0, 0).numel() == 0, "read n=0")
    check(all(v == 0 for v in K.LAUNCHES.values()),
          f"n == 0 launched a kernel: {K.LAUNCHES}")
    say(f"kernels: write/read f32+u8 bit-equal with the guard bytes "
        f"untouched over every phase pair, cases per (op, dtype, mode) "
        f"{cases}; accum bit-equal over every phase pair of the f32 "
        f"lengths, a wrong split refused; chain_write of {len(chains)} "
        f"chains over every phase pair of the f32 lengths, cases per "
        f"(chain kind, mode) {chain_cases}: exact chains bit-equal, guard "
        f"floats and x untouched, transcendental chains max abs err "
        f"{chain_worst:.3e}, a wrong split refused; accum, exact chains "
        f"bit-equal at n in {SIZES}; transcendental chains max abs err "
        f"{worst_transcendental:.3e} (rtol {CHAIN_RTOL}, atol {CHAIN_ATOL}); "
        f"n == 0 launches nothing")


# ---------------------------------------------------------------------------
# Phase 3: the flash-attention kernel against its plain versions
# ---------------------------------------------------------------------------


def bf16_ulp(x):
    """One bf16 ulp of each element of ``x`` (f32): 2^(e - 8) for
    x = m * 2^e, 0.5 <= m < 1."""
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def fa_err(got, want):
    """(max abs err, within tolerance) of two outputs of one dtype."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    if got.dtype == torch.float32:
        ok = bool((diff <= FA_ATOL32 + FA_RTOL32 * b.abs()).all())
    else:
        ok = bool((diff <= bf16_ulp(torch.maximum(a.abs(), b.abs()))
                   + FA_ATOL16).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


def flash_routes(dtype, D, Dv, rows) -> dict:
    """The kernels that take a call, by route, each through its wrapper:
    the simple kernel always, the split-K decode at Sq * G <= 16, the
    ``wgmma`` prefill in bf16 at its pairs."""
    from repro_torch.kernels.flash_attention import kernel as FK
    out = {"simple": FK.flash_simple_cuda}
    if rows <= FK.DECODE_MAX_ROWS:
        out["decode"] = lambda *a, **kw: FK.flash_decode_cuda(*a, **kw)[0]
    if dtype == torch.bfloat16 and (D, Dv) in FK.PREFILL_HEAD_DIMS:
        out["prefill"] = FK.flash_prefill_cuda
    return out


def phase_flash(dev, err):
    """Every case through every kernel that takes it; returns the worst
    error of each route."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst, per_route, n_runs = {}, {}, {}

    def run(name, dtype, D, Dv, KV, G, sq, skv, kw):
        kw = dict(kw)
        B = kw.pop("batch", 1)
        q = torch.randn(B, sq, KV * G, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(B, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(B, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        args = dict(causal=kw.get("causal", True), window=kw.get("window"),
                    q_start=kw.get("q_start", 0),
                    kv_len=kw.get("kv_len", skv))
        wants = {impl: flash_attention(q, k, v, impl=impl, **kw)
                 for impl in ("torch", "ref")}
        line = []
        for route, kernel in flash_routes(dtype, D, Dv, sq * G).items():
            got = kernel(q, k, v, **args)
            for impl, want in wants.items():
                e, ok = fa_err(got, want)
                check(ok, f"flash {name} {dtype} D={D} Dv={Dv} G={G} KV={KV} "
                          f"route {route} vs {impl}: max abs err {e}")
                err["flash_attention"] = max(err["flash_attention"], e)
                key = (str(dtype).split(".")[1], impl)
                worst[key] = max(worst.get(key, 0.0), e)
                per_route[route] = max(per_route.get(route, 0.0), e)
                line.append(f"{route} vs {impl} {e:.3e}")
            n_runs[route] = n_runs.get(route, 0) + 1
            if name.endswith("tail"):
                # finite garbage beyond kv_len must not leak
                k2, v2 = k.clone(), v.clone()
                k2[:, kw["kv_len"]:] = 1e4
                v2[:, kw["kv_len"]:] = -1e4
                dirty = kernel(q, k2, v2, **args)
                check(torch.equal(dirty, got),
                      f"flash {name} {dtype} D={D} Dv={Dv} G={G} route "
                      f"{route}: garbage beyond kv_len leaked")
        say(f"flash: {name} Sq {sq} Skv {skv} {kw} "
            f"{str(dtype).split('.')[1]} D {D} Dv {Dv} G {G} KV {KV}: "
            f"max abs err {', '.join(line)}")

    cases = []
    for kv in (1, 127, 1056, 4097):        # decode: one query at kv_len - 1
        cases.append(("decode", 1, kv, dict(q_start=kv - 1, kv_len=kv)))
    for n in (1, 33, 1024):                # causal prefill
        cases.append(("prefill", n, n, dict()))
    cases.append(("window", 100, 100, dict(window=17)))
    cases.append(("tail", 1, 1056, dict(q_start=499, kv_len=500)))
    cases.append(("prefill window", 300, 300, dict(window=100)))
    cases.append(("prefill tail", 70, 1056, dict(q_start=400, kv_len=470)))
    cases.append(("noncausal", 33, 100, dict(causal=False)))
    cases.append(("noncausal window", 64, 64, dict(causal=False, window=9)))
    cases.append(("noncausal tail", 5, 1056, dict(causal=False, q_start=3,
                                                  kv_len=700)))
    cases.append(("batch decode", 1, 300, dict(q_start=299, kv_len=300,
                                               batch=2)))
    cases.append(("batch prefill tail", 70, 300, dict(q_start=200,
                                                      kv_len=270, batch=2)))
    # recurrentgemma-2b's served attention: one KV head for 10 query heads,
    # D 256, window 2048, the cache of smax 2592 and the prompt of 2560
    w = MQA_WINDOW
    mqa = [("mqa decode", 1, 2592, dict(q_start=2591, kv_len=2592,
                                        window=w)),
           ("mqa prefill", 2560, 2560, dict(window=w)),
           ("mqa decode tail", 1, 2592, dict(q_start=2199, kv_len=2200,
                                             window=w))]
    for dtype in (torch.float32, torch.bfloat16):
        for D, Dv in FK.HEAD_DIMS:        # every (D, Dv) the wrapper takes
            for G in (1, 4):
                for name, sq, skv, kw in cases:
                    run(name, dtype, D, Dv, 8, G, sq, skv, kw)
        for name, sq, skv, kw in mqa:
            run(name, dtype, MQA_D, MQA_D, 1, MQA_H, sq, skv, kw)
    torch.cuda.synchronize()
    say(f"flash: every case within tolerance (f32 rtol {FA_RTOL32} + atol "
        f"{FA_ATOL32}; bf16 one ulp of the output + {FA_ATOL16}); worst "
        + ", ".join(f"{d} vs {i} {e:.3e}" for (d, i), e in worst.items())
        + f"; by route {per_route}, cases per route {n_runs}")
    per_route.update(phase_flash_split(dev, gen))
    return per_route


def phase_flash_split(dev, gen):
    """The split-K decode's partials and merged output against its two plain
    versions, with splits fully masked for some rows, empty splits, and
    rows masked in every split (which must give 0 with no NaN; those rows
    are held against the oracle, since ``impl="torch"``, like ``repro``'s
    ``_flash_xla``, gives them the mean of the masked values)."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_decode_combine_torch,
        flash_decode_partials_torch,
    )

    cases = [  # (name, dtype, Sq, Skv, H, KV, D, Dv, kw, rows masked)
        ("llama decode", torch.bfloat16, 1, 1056, 32, 8, 64, 64,
         dict(q_start=1055, kv_len=1056), 0),
        ("griffin decode", torch.bfloat16, 1, 2592, 10, 1, 256, 256,
         dict(q_start=2591, kv_len=2592, window=MQA_WINDOW), 0),
        ("f32 192/128 tail", torch.float32, 1, 1056, 16, 4, 192, 128,
         dict(q_start=499, kv_len=500), 0),
        ("some splits masked", torch.bfloat16, 16, 116, 1, 1, 128, 128,
         dict(q_start=100, kv_len=116, window=20), 0),
        ("rows masked in every split", torch.float32, 4, 64, 8, 2, 16, 16,
         dict(q_start=8, kv_len=9, window=2), 2),
    ]
    worst = 0.0

    def hold(what, q, k, v, got, want, ref_kw, dtype):
        """One launch's partials and output against the plain versions'
        and the oracle; returns (m, l, acc, merge, oracle) errors and the
        mask of live (split, row) partials."""
        out, m, l, acc = got
        mw, lw, aw = want
        vmax = float(v.float().abs().max())
        check(m.shape == mw.shape, f"{what}: {m.shape} vs {mw.shape}")
        check(not any(bool(torch.isnan(t).any())
                      for t in (out.float(), m, l, acc)), f"{what}: NaN")
        live = torch.isfinite(mw)
        check(torch.equal(live, torch.isfinite(m)),
              f"{what}: the -inf splits differ")
        em = float((m - mw).abs()[live].max()) if live.any() else 0.0
        el = float((l - lw).abs().max())
        ea = float((acc - aw).abs().max())
        check(bool(((m - mw).abs()[live] <= SPLIT_TOL
                    * (1 + mw.abs()[live])).all())
              and bool(((l - lw).abs() <= SPLIT_TOL * (1 + lw)).all())
              and bool(((acc - aw).abs() <= SPLIT_TOL
                        * (1 + lw[..., None] * vmax)).all()),
              f"{what}: partials off the plain version's (m {em}, l "
              f"{el}, acc {ea})")
        check(bool((l[~live] == 0).all()) and bool((acc[~live] == 0).all()),
              f"{what}: a fully masked split is not exactly 0")
        merged = flash_decode_combine_torch(mw, lw, aw, dtype=dtype)
        e, ok = fa_err(out, merged)
        check(ok, f"{what}: output vs the plain merge: {e}")
        e2, ok2 = fa_err(out, flash_attention(q, k, v, impl="ref", **ref_kw))
        check(ok2, f"{what}: output vs the oracle: {e2}")
        return em, el, ea, e, e2, live

    for name, dtype, sq, skv, H, KV, D, Dv, kw, n_dead in cases:
        q = torch.randn(1, sq, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(1, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(1, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        args = dict(causal=True, window=kw.get("window"),
                    q_start=kw["q_start"], kv_len=kw["kv_len"])
        for splits in (None, 7, 64):
            got = FK.flash_decode_cuda(q, k, v, splits=splits, **args)
            want = flash_decode_partials_torch(q, k, v, splits=splits, **kw)
            out, m = got[0], got[1]
            what = f"flash_decode {name} splits {splits} ({m.shape[2]})"
            em, el, ea, e, e2, live = hold(what, q, k, v, got, want, kw,
                                           dtype)
            if n_dead:
                check(not bool(out[:, -n_dead:].any()),
                      f"{what}: a row with no live key is not 0")
            worst = max(worst, e, e2)
            say(f"flash: split-K {name} ({str(dtype).split('.')[1]}, D {D}, "
                f"Dv {Dv}, G {H // KV}, {kw}) at {m.shape[2]} splits: "
                f"partials vs plain m {em:.3e}, l {el:.3e}, acc {ea:.3e}; "
                f"output vs plain merge {e:.3e}, vs oracle {e2:.3e}; "
                f"{int((~live).sum())} of {live.numel()} (split, row) "
                f"partials fully masked, exactly 0")

    # the position on the device (a captured decode step's launch): the
    # capacity split rule at the served caches and a small f32 one, over
    # positions from 0 to the last, each against the plain versions with a
    # tensor position and the oracle; where the host rule splits alike,
    # the launch must equal the host-position launch bit for bit
    dpos = [  # (name, dtype, Sq, Skv, H, KV, D, Dv, window, positions)
        ("llama", torch.bfloat16, 1, 1056, 32, 8, 64, 64, None,
         (0, 31, 32, 500, 1023, 1024, 1040, 1055)),
        ("griffin", torch.bfloat16, 1, 2592, 10, 1, 256, 256, MQA_WINDOW,
         (0, 100, 2047, 2048, 2100, 2559, 2560, 2575, 2591)),
        ("f32 Sq 2 window", torch.float32, 2, 300, 8, 2, 128, 128, 40,
         (0, 1, 39, 40, 41, 150, 298)),
    ]
    worst_dev, equal_host, n_dev = 0.0, 0, 0
    for name, dtype, sq, skv, H, KV, D, Dv, w, positions in dpos:
        q = torch.randn(1, sq, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(1, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(1, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        cap = FK.capacity_splits(1, KV, sq, H, Dv, Skv=skv, causal=True,
                                 window=w)
        for t in positions:
            pos = torch.full((), t, dtype=torch.long, device=dev)
            got = FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                       q_start=pos)
            want = flash_decode_partials_torch(q, k, v, causal=True,
                                               window=w, q_start=pos)
            what = f"flash_decode {name} at device position {t}"
            check(got[1].shape[2] == cap[0],
                  f"{what}: {got[1].shape[2]} splits, the rule {cap[0]}")
            ref_kw = dict(causal=True, window=w, q_start=t, kv_len=t + sq)
            e = hold(what, q, k, v, got, want, ref_kw, dtype)[3:5]
            host = FK.decode_splits(1, KV, sq, H, Dv, causal=True, window=w,
                                    q_start=t, kv_len=t + sq)
            if (host[0], host[2]) == cap:
                out_host = FK.flash_decode_cuda(q, k, v, **ref_kw)[0]
                check(torch.equal(got[0], out_host),
                      f"{what}: not bit-equal to the host-position launch "
                      f"of the same splits")
                equal_host += 1
            worst_dev = max(worst_dev, *e)
            n_dev += 1
        say(f"flash: split-K {name} ({str(dtype).split('.')[1]}, Sq {sq}, "
            f"Skv {skv}, G {H // KV}, window {w}) at device positions "
            f"{positions}: {cap[0]} splits of {cap[1]} tiles (the capacity "
            f"rule) at every one, partials within the plain version's "
            f"tolerance, output vs plain merge and oracle within the "
            f"flash tolerance")
    say(f"flash: device positions: {n_dev} launches held, worst output "
        f"error {worst_dev:.3e}; {equal_host} bit-equal to the host-position "
        f"launch of the same splits")

    # a position per batch row (the batched decode step's launch): rows at
    # different positions, some cut by the window, in one grid, against
    # the plain versions at the same (B,) positions and the oracle; with
    # every row at one position, bit-equal to the 0-d launch
    rpos = [  # (name, dtype, Sq, Skv, H, KV, D, Dv, window, positions)
        ("llama bucket 4", torch.bfloat16, 1, 1056, 32, 8, 64, 64, None,
         (0, 500, 1023, 1055)),
        ("llama bucket 8", torch.bfloat16, 1, 1056, 32, 8, 64, 64, None,
         (3, 31, 32, 300, 1024, 1040, 1054, 1055)),
        ("griffin bucket 4", torch.bfloat16, 1, 2592, 10, 1, 256, 256,
         MQA_WINDOW, (100, 2047, 2300, 2591)),
        ("f32 Sq 2 window", torch.float32, 2, 300, 8, 2, 128, 128, 40,
         (0, 41, 298)),
    ]
    worst_rows = 0.0
    for name, dtype, sq, skv, H, KV, D, Dv, w, positions in rpos:
        B = len(positions)
        q = torch.randn(B, sq, H, D, device=dev, generator=gen).to(dtype)
        k = torch.randn(B, skv, KV, D, device=dev, generator=gen).to(dtype)
        v = torch.randn(B, skv, KV, Dv, device=dev, generator=gen).to(dtype)
        pos = torch.tensor(positions, dtype=torch.long, device=dev)
        cut = [t for t in positions if w is not None and t - w + 1 > 0]
        got = FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                   q_start=pos)
        want = flash_decode_partials_torch(q, k, v, causal=True, window=w,
                                           q_start=pos)
        what = f"flash_decode {name} at row positions {positions}"
        ref_kw = dict(causal=True, window=w, q_start=pos)
        e = hold(what, q, k, v, got, want, ref_kw, dtype)[3:5]
        for b, t in enumerate(positions):
            row = (q[b:b + 1], k[b:b + 1], v[b:b + 1])
            e_row, ok = fa_err(got[0][b:b + 1], flash_attention(
                *row, impl="ref", causal=True, window=w, q_start=t,
                kv_len=t + sq))
            check(ok, f"{what}: row {b} vs the oracle of the row alone "
                      f"at {t}: {e_row}")
        same = torch.full((B,), positions[-1], dtype=torch.long, device=dev)
        one = torch.full((), positions[-1], dtype=torch.long, device=dev)
        check(torch.equal(
            FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                 q_start=same)[0],
            FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                 q_start=one)[0]),
            f"{what}: every row at one position is not bit-equal to the 0-d "
            f"launch")
        worst_rows = max(worst_rows, *e)
        say(f"flash: split-K {name} ({str(dtype).split('.')[1]}, B {B}, Sq "
            f"{sq}, Skv {skv}, G {H // KV}, window {w}) at row positions "
            f"{positions} (window cuts the rows at {cut}), {got[1].shape[2]} "
            f"splits: partials within the plain version's tolerance, output "
            f"vs plain merge {e[0]:.3e}, vs oracle {e[1]:.3e}, each row "
            f"within the flash tolerance of the oracle of the row alone; "
            f"all rows at {positions[-1]}: bit-equal to the 0-d launch")
    torch.cuda.synchronize()
    return {"decode partials": worst, "decode at a device position":
            worst_dev, "decode at row positions": worst_rows}


# ---------------------------------------------------------------------------
# Phases 4 and 5: the recurrence kernels against their plain versions
# ---------------------------------------------------------------------------


def wkv6_err(got, want, mag, N):
    """(max abs err, within tolerance) of two WKV-6 outputs: the flash
    phase's tolerance plus the error bound of two f32 sums of N + 1 terms
    taken in different orders, 2 (N + 1) 2^-24 times the sum of the terms'
    magnitudes (``mag``): an output that cancels to near 0 keeps the
    rounding of its large terms."""
    a, b = got.float(), want.float()
    diff = (a - b).abs()
    slack = 2 * (N + 1) * 2.0 ** -24 * mag.float()
    if got.dtype == torch.float32:
        allowed = FA_ATOL32 + FA_RTOL32 * b.abs() + slack
    else:
        allowed = bf16_ulp(torch.maximum(a.abs(), b.abs())) + FA_ATOL16 \
            + slack
    share = float((diff / allowed).max())
    return float(diff.max()), share <= 1.0, share


def phase_wkv6(dev, err):
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen)

    # (B, T, with s0): batch 1 as served, batch 2 at a T that ends in a
    # ragged chunk, and the batched decode's one-step runs at buckets 4
    # and 8
    runs = [(1, T, s) for T in (1, 7, 256, 1000, 1024) for s in (False, True)]
    runs += [(2, 1000, False), (2, 3 * WK.CHUNK + 5, True)]
    runs += [(B, 1, s) for B in (N_REQ, 2 * N_REQ) for s in (False, True)]
    n, worst_share = 0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for N in WK.HEAD_SIZES:
            H = 4096 // N if N == 64 else 4     # rwkv6-7b: 64 heads of 64
            for B, T, with_s0 in runs:
                r, k, v = (rnd(B, T, H, N).to(dtype) for _ in range(3))
                w = torch.exp(-torch.exp(rnd(B, T, H, N))).to(dtype)
                u = (0.5 * rnd(H, N)).to(dtype)
                s0 = rnd(B, H, N, N) if with_s0 else None
                o, sT = WK.wkv6_cuda(r, k, v, w, u, initial_state=s0)
                ow, sw = wkv6_ref(r, k, v, w, u, s0)
                # a bound on the summands of each output: the same
                # recurrence on |r|, |k|, |v|, |u|, |s0| (w > 0)
                mag = wkv6_ref(r.abs(), k.abs(), v.abs(), w, u.abs(),
                               None if s0 is None else s0.abs())[0]
                e, ok, share = wkv6_err(o, ow, mag, N)
                worst_share = max(worst_share, share)
                what = f"wkv6 {dtype} N={N} B={B} H={H} T={T} s0={with_s0}"
                check(ok, f"{what}: output max abs err {e}")
                check(torch.equal(sT, sw), f"{what}: final state not "
                      f"bit-equal (max abs err "
                      f"{float((sT - sw).abs().max())})")
                err["wkv6"] = max(err["wkv6"], e)
                if with_s0:             # the final state over s0, in place
                    s_in = s0.clone()
                    o_in, s_out = WK.wkv6_cuda(r, k, v, w, u,
                                               initial_state=s_in,
                                               state_out=s_in)
                    check(s_out is s_in and torch.equal(s_in, sT)
                          and torch.equal(o_in, o),
                          f"{what}: the in-place run differs")
                if T == 7:              # one step a launch: decode path
                    s_step = None if s0 is None else s0.clone()
                    outs = []
                    for t in range(T):
                        o_t, s_step = WK.wkv6_cuda(
                            r[:, t:t + 1].contiguous(),
                            k[:, t:t + 1].contiguous(),
                            v[:, t:t + 1].contiguous(),
                            w[:, t:t + 1].contiguous(), u,
                            initial_state=s_step, state_out=s_step)
                        outs.append(o_t)
                    check(torch.equal(s_step, sT)
                          and torch.equal(torch.cat(outs, 1), o),
                          f"{what}: the run one step a launch differs")
                if T > 1:               # the state threaded across two runs
                    h = T // 2
                    o1, s1 = WK.wkv6_cuda(r[:, :h].contiguous(),
                                          k[:, :h].contiguous(),
                                          v[:, :h].contiguous(),
                                          w[:, :h].contiguous(), u,
                                          initial_state=s0)
                    o2, s2 = WK.wkv6_cuda(r[:, h:].contiguous(),
                                          k[:, h:].contiguous(),
                                          v[:, h:].contiguous(),
                                          w[:, h:].contiguous(), u,
                                          initial_state=s1,
                                          state_out=s1)
                    check(s2 is s1 and torch.equal(s2, sT)
                          and torch.equal(torch.cat([o1, o2], 1), o),
                          f"{what}: the split run differs")
                n += 1
    torch.cuda.synchronize()
    say(f"wkv6: {n} cases (f32/bf16, N {WK.HEAD_SIZES}, (B, T, s0) in "
        f"{runs}; chunk {WK.CHUNK}, tile {WK.TILE_COLS}, row split "
        f"{WK.ROW_SPLIT}): outputs within tolerance of the plain version, "
        f"worst {err['wkv6']:.3e}, at most {worst_share:.3f} of the allowed "
        f"error; final states bit-equal; in-place runs, split runs with "
        f"the state threaded in place and T 7 one step a launch bit-equal "
        f"to the whole run")


def rglru_cases(RK) -> tuple[list, list, list]:
    """(D values, T values, (D, B, T) cases) of phase 5: a group of 16
    channels, a ragged group (40), rows that are not 16-byte aligned (37)
    and Griffin's width, at B 2 (Griffin's width at B 1, as served one
    request a step); T at 1, around the route threshold and a chunk, and
    2560; and at Griffin's width the batched decode's steps at buckets 4
    and 8, T 1 and STEP_MAX_T."""
    Ds = [16, 37, 40, 2560]
    Ts = sorted({1, 5, RK.STEP_MAX_T - 1, RK.STEP_MAX_T, RK.STEP_MAX_T + 1,
                 RK.CHUNK - 1, RK.CHUNK, RK.CHUNK + 1, 2560})
    cases = [(D, 1 if D == 2560 else 2, T) for D in Ds for T in Ts]
    cases += [(2560, B, T) for B in (N_REQ, 2 * N_REQ)
              for T in (1, RK.STEP_MAX_T)]
    return Ds, Ts, cases


def phase_rglru(dev, err):
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_ref

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    Ds, Ts, cases = rglru_cases(RK)
    n = n_equal = n_split = 0
    worst_hT = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for D, B, T in cases:
            for with_h0 in (False, True):
                la = -0.5 * torch.exp(torch.randn(B, T, D, device=dev,
                                                  generator=gen))
                gx = torch.randn(B, T, D, device=dev,
                                 generator=gen).to(dtype)
                h0 = torch.randn(B, D, device=dev, generator=gen) \
                    if with_h0 else None
                what = f"rglru {dtype} B={B} D={D} T={T} h0={with_h0}"
                # both kernels, whatever the route: the same bits
                h, hT = RK.rglru_staged_cuda(la, gx, h0)
                hs, hTs = RK.rglru_step_cuda(la, gx, h0)
                check(torch.equal(h, hs) and torch.equal(hT, hTs),
                      f"{what}: the staged kernel differs from the step "
                      f"kernel (h max abs err "
                      f"{float((h.float() - hs.float()).abs().max())}, "
                      f"hT {float((hT - hTs).abs().max())})")
                hw, hTw = rglru_ref(la, gx, h0)
                e, ok = fa_err(h, hw)
                eT = float((hT - hTw).abs().max())
                check(ok, f"{what}: h max abs err {e}")
                check(torch.allclose(hT, hTw, rtol=RG_RTOL,
                                     atol=RG_ATOL),
                      f"{what}: hT max abs err {eT}")
                err["rglru"] = max(err["rglru"], e, eT)
                worst_hT = max(worst_hT, eT)
                n_equal += int(torch.equal(h, hw)
                               and torch.equal(hT, hTw))
                if with_h0:         # the final state over h0, in place
                    s_in = h0.clone()
                    h_in, s_out = RK.rglru_cuda(la, gx, s_in,
                                                state_out=s_in)
                    check(s_out is s_in and torch.equal(s_in, hT)
                          and torch.equal(h_in, h),
                          f"{what}: the in-place run differs")
                # the carry threaded across two routed runs: at the
                # middle, and after STEP_MAX_T steps (the first run on
                # the step kernel, the second on the staged one)
                for c in {T // 2, RK.STEP_MAX_T} - {0, T}:
                    if c > T:
                        continue
                    h1, s1 = RK.rglru_cuda(la[:, :c].contiguous(),
                                           gx[:, :c].contiguous(), h0)
                    h2, s2 = RK.rglru_cuda(la[:, c:].contiguous(),
                                           gx[:, c:].contiguous(), s1,
                                           state_out=s1)
                    check(s2 is s1 and torch.equal(s2, hT)
                          and torch.equal(torch.cat([h1, h2], 1), h),
                          f"{what}: the run split after {c} steps "
                          f"({RK.pick_route(c)} + "
                          f"{RK.pick_route(T - c)}) differs")
                    n_split += 1
                n += 1
    torch.cuda.synchronize()
    say(f"rglru: {n} cases (gx f32/bf16, D {Ds} (B 2, Griffin's 2560 B 1), "
        f"T {Ts}, and Griffin's 2560 at (B, T) "
        f"{[(B, T) for D, B, T in cases if B > 2]}, with and without h0; "
        f"staged kernel: {RK.CHANNELS} "
        f"channels a block, chunks of {RK.CHUNK}, {RK.STAGES} stages; the "
        f"step kernel takes T <= {RK.STEP_MAX_T}): the staged and the step "
        f"kernel bit-equal on h and hT in every case; h within tolerance of "
        f"the plain version, hT within rtol {RG_RTOL} + atol {RG_ATOL} "
        f"(worst {worst_hT:.3e}); {n_equal} of {n} bit-equal to the plain "
        f"version; in-place runs and {n_split} split runs (across the route "
        f"boundary too) bit-equal to the whole run")


# ---------------------------------------------------------------------------
# Phase 6: the main path
# ---------------------------------------------------------------------------


def seeded_inputs(g, rng):
    from repro_torch.core.executor import input_nodes
    return {g.nodes[u].name: rng.standard_normal(g.sizes[u] // 4)
            .astype(np.float32) for u in input_nodes(g)}


def phase_main(rng):
    import repro_torch as rt
    from repro_torch.graphs import BENCHMARK_GRAPHS, FULL_NETWORKS, swiftnet_cell
    from repro_torch.kernels.arena import LAUNCHES, reset_launches
    from repro_torch.kernels.arena.elemwise import EXACT_OPS

    # the planner integers known from the JAX package
    g = swiftnet_cell("A")
    plain = rt.plan(g, rt.PlanConfig(rewrite=False))
    rew = rt.plan(g, rt.PlanConfig())
    peaks = (plain.baseline_peaks["kahn"], plain.peak_bytes, rew.peak_bytes)
    check(peaks == (3920 * 1024, 3038 * 1024, 2744 * 1024),
          f"swiftnet_cell_a peaks {peaks}")
    say(f"planner: swiftnet_cell_a TFLite {peaks[0]} B -> SERENITY "
        f"{peaks[1]} B -> rewrite {peaks[2]} B")

    graphs = {**BENCHMARK_GRAPHS, **FULL_NETWORKS}
    plans = {name: rt.plan(mk(), rt.PlanConfig()) for name, mk in graphs.items()}
    inputs = {name: seeded_inputs(p.graph, rng) for name, p in plans.items()}

    reset_launches()
    per_graph = {}
    for name, p in plans.items():
        before = dict(LAUNCHES)
        ref = rt.run_reference(p.graph, inputs[name])
        for fuse in (False, True):
            res = rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                             fuse=fuse)
            check(res.realized_matches_plan
                  and res.realized_peak_bytes == p.peak_bytes
                  and res.realized_arena_bytes == p.arena_bytes,
                  f"{name} fuse={fuse}: realized != planned")
            check(set(res.outputs) == set(ref), f"{name}: output names")
            prog = rt.compile_plan(p.graph, p.order, p.arena, fuse=fuse)
            exact = all(set(ops) <= EXACT_OPS
                        for _, ops, _ in prog._groups.values())
            for k, v in ref.items():
                got = res.outputs[k]
                check(got.shape == v.shape and bool(torch.isfinite(got).all()),
                      f"{name}: output {k} shape or finiteness")
                if not fuse or exact:
                    check(torch.equal(got, v),
                          f"{name} fuse={fuse}: {k} not bit-equal to "
                          f"run_reference")
                else:
                    check(torch.allclose(got, v, rtol=CHAIN_RTOL,
                                         atol=CHAIN_ATOL),
                          f"{name} fuse={fuse}: {k} not allclose")
            if name == "darts_imagenet_cell" and fuse:
                counts = (prog.n_regions, prog.n_fused_nodes,
                          max(len(r) for r in prog.regions))
                check(counts == (31, 23, 4), f"darts fusion counts {counts}")
        torch.cuda.synchronize()
        per_graph[name] = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        say(f"main: {name}: {len(p.graph)} nodes, peak {p.peak_bytes} B, "
            f"arena {p.arena_bytes} B, realized == planned (slice, fused), "
            f"slice bit-equal to run_reference, fused "
            f"{'bit-equal' if exact else 'allclose'}; launches {per_graph[name]}")

    # serving-state packing: mixed dtypes through the uint8 write/read
    p = plans["darts_imagenet_cell"]
    ids, taken = [], []     # nodes whose first 64 bytes overlap no other's
    for u in p.order:
        o = p.arena.offset_of(u)
        if p.graph.sizes[u] >= 64 and len(ids) < 4 and \
                all(o + 64 <= t or t + 64 <= o for t in taken):
            ids.append(u)
            taken.append(o)
    dts = (torch.float32, torch.int32, torch.float16, torch.uint8)
    arrays = {u: torch.from_numpy(rng.integers(0, 100, 16)).to(dt)
              for u, dt in zip(ids, dts)}
    packed = rt.pack_buffers(p.arena, arrays)
    for u, x in arrays.items():
        back = rt.unpack_buffer(packed, p.arena, u, x.shape, x.dtype)
        check(torch.equal(back.cpu(), x), f"pack/unpack node {u} {x.dtype}")
    torch.cuda.synchronize()

    captured = phase_capture(rt, plans, inputs, rng)

    launches = dict(LAUNCHES)
    say(f"main: launches over the run (eager and captured) {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main path was never launched: {launches}")
    return plans, inputs, launches, per_graph, captured


# the arena kernels' names in a trace, by launch count key
ARENA_KERNELS = {"write": "arena_write_kernel", "read": "arena_read_kernel",
                 "accum": "accum_kernel", "chain_write": "chain_write_kernel"}


def phase_capture(rt, plans, inputs, rng):
    """``jit=True`` on every paper graph and full network, slice and fused:
    the first call (the capture's warm-up) and a replay bit-equal to the
    eager run, a replay with other inputs right against ``run_reference``
    of those (bit-equal where the eager run is), the first replay's
    outputs not overwritten by the second, realized == planned, and the
    arena launches per replay, both as the capture counted them and as the
    most complete of three traces of a replay holds them (more, up to
    TRACE_TRIES, while none holds them all), equal to the eager run's.  Returns {(name, fuse): launches per replay}."""
    import functools

    from repro_torch.kernels.arena import LAUNCHES
    from repro_torch.kernels.arena.elemwise import EXACT_OPS

    out = {}
    for name, p in plans.items():
        other = seeded_inputs(p.graph, rng)
        refs = {"first": rt.run_reference(p.graph, inputs[name]),
                "other": rt.run_reference(p.graph, other)}
        for fuse in (False, True):
            run = functools.partial(rt.execute, p.graph, plan=p.arena,
                                    order=p.order, fuse=fuse)
            before = dict(LAUNCHES)
            eager = run(inputs[name]).outputs
            torch.cuda.synchronize()
            per_exec = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            res = {"first": run(inputs[name], jit=True),
                   "again": run(inputs[name], jit=True)}
            prog = rt.compile_plan(p.graph, p.order, p.arena, fuse=fuse)
            call = prog._captures[None][0]
            traces, traced = [], {}
            while len(traces) < 3 or (traced != per_exec
                                      and len(traces) < TRACE_TRIES):
                traces.append(device_profile(
                    lambda: run(inputs[name], jit=True)))
                traced = max(({op: traced_copies(t[2], op)[1]
                               for op in ARENA_KERNELS} for t in traces),
                             key=lambda d: sum(d.values()))
            res["other"] = run(other, jit=True)
            torch.cuda.synchronize()
            exact = not fuse or all(set(ops) <= EXACT_OPS
                                    for _, ops, _ in prog._groups.values())
            what = f"{name} {'fused' if fuse else 'slice'} jit=True"
            for key, r in res.items():
                check(r.realized_matches_plan
                      and r.realized_peak_bytes == p.peak_bytes
                      and r.realized_arena_bytes == p.arena_bytes,
                      f"{what} ({key}): realized != planned")
                ref = refs["other" if key == "other" else "first"]
                check(set(r.outputs) == set(ref), f"{what}: output names")
                for k, v in ref.items():
                    got = r.outputs[k]
                    if key != "other":
                        check(torch.equal(got, eager[k]),
                              f"{what} ({key}): {k} not bit-equal to the "
                              f"eager run")
                    if exact:
                        check(torch.equal(got, v),
                              f"{what} ({key}): {k} not bit-equal to "
                              f"run_reference")
                    else:
                        check(torch.allclose(got, v, rtol=CHAIN_RTOL,
                                             atol=CHAIN_ATOL),
                              f"{what} ({key}): {k} not allclose to "
                              f"run_reference")
            for k in eager:
                check(torch.equal(res["again"].outputs[k], eager[k]),
                      f"{what}: a replay's output {k} was overwritten by "
                      f"the next replay")
            per_replay = {k: call.launches[k] for k in per_exec}
            check(per_replay == per_exec,
                  f"{what}: launches per replay {per_replay}, the eager run "
                  f"{per_exec}")
            check(traced == per_exec,
                  f"{what}: the most complete of {len(traces)} traces of a "
                  f"replay holds {traced} arena kernels, the eager run "
                  f"launches {per_exec}")
            out[(name, fuse)] = per_exec
            say(f"capture: {what}: first call, replay and a replay with "
                f"other inputs bit-equal to the eager run and "
                f"{'bit-equal' if exact else 'allclose'} to run_reference, "
                f"realized == planned; arena launches per replay "
                f"{per_replay} (in a traced replay {traced}; activities in "
                f"the traces {[t[1] for t in traces]}), as the eager "
                f"run's; {call.replays} replays")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the graph bridge (core/fx_bridge.py), run after phase 6
# ---------------------------------------------------------------------------


# (program, x shape): each of ``repro_torch.graphs.programs`` at the bench's
# size (``wide``'s weights take 64 columns), and ``nas_cell`` at a size
# whose 76 MB arena makes the copies real work
BRIDGE_CASES = (("wide", (64, 64)), ("nas_cell", (64, 128)),
                ("nas_like", (64, 128)), ("moe_fanout", (64, 128)),
                ("branchy_residual", (64, 128)), ("mixed", (64, 128)),
                ("nas_cell", (2048, 1024)))
# where repro's bridge is exact (tests/test_jax_bridge.py:59 gates
# nas_cell; tests/test_torch_fx_bridge.py holds the others' integers)
BRIDGE_EXACT = ("wide", "nas_cell", "nas_like", "moe_fanout",
                "branchy_residual")
BRIDGE_REPS = 20


def bridge_close(got, want) -> bool:
    """Bit-equal: the scheduled program runs the unscheduled function's
    aten ops on the same bytes, in another order."""
    return got.dtype == want.dtype and torch.equal(got, want)


def event_us(fn, reps=BRIDGE_REPS) -> float:
    """Median us per call of ``fn()`` by CUDA events around each call
    (the host's issue included), after two warm calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def phase_bridge(dev, card) -> dict:
    """The graph bridge on the card: each BRIDGE_CASES program traced,
    scheduled (``schedule_fx``; host seconds) and run through the planned
    uint8 arena by ``compile_scheduled``, eagerly and captured
    (``jit=True``).  Checks, each fatal: the program through the arena
    kernels against the same program through their plain versions (outputs
    and final arena bytes bit-equal), outputs bit-equal to the unscheduled
    function's on the card, eager and
    captured bit-equal (a replay, and a replay with other inputs against
    an eager run on those; a replay's outputs not overwritten by the next),
    realized == optimal peak, arena >= peak, ``exact`` where repro's is,
    and the arena launches per call (write: one per threaded tensor; read:
    one per op and distinct threaded input) in each eager call, in the
    capture's count and in the most complete of up to TRACE_TRIES traces
    of a replay; both kernels launched.  Prints nodes, planning seconds,
    the peaks, the caching allocator's peak over one call of the
    unscheduled function and of the eager arena program, and us per call (unscheduled, eager arena,
    captured).  Returns {case: record}."""
    from torch.utils._pytree import tree_leaves

    from repro_torch.core import fx_bridge as fb
    from repro_torch.graphs.programs import PROGRAMS
    from repro_torch.kernels.arena import LAUNCHES, reset_launches

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    out = {}
    for name, shape in BRIDGE_CASES:
        case = f"{name} {shape[0]}x{shape[1]}"
        fn, make_args = PROGRAMS[name]
        args = make_args(torch.randn(shape, device=dev, generator=gen))
        other = make_args(torch.randn(shape, device=dev, generator=gen))
        t0 = time.perf_counter()
        gm = fb.trace_fn(fn, *args)
        _, rep = fb.schedule_fx(gm)
        plan_s = time.perf_counter() - t0
        n_nodes = len(fb.fx_to_graph(gm)[0])
        torch.cuda.synchronize()

        eager = fb.compile_scheduled(fn)
        per_call = []
        for a in (args, args, other):
            reset_launches()
            res = eager(*a)
            torch.cuda.synchronize()
            per_call.append(dict(LAUNCHES))
        r = eager.report
        want = {k: 0 for k in LAUNCHES}
        want.update(write=r.n_arena_writes, read=r.n_arena_reads)
        check(all(c == want for c in per_call),
              f"bridge {case}: arena launches per eager call {per_call}, "
              f"the program's {want}")
        check(want["write"] > 0 and want["read"] > 0,
              f"bridge {case}: an arena kernel was not launched: {want}")
        check(r.realized_bytes == r.optimal_peak and r.realized_matches_plan,
              f"bridge {case}: realized {r.realized_bytes} B != optimal "
              f"peak {r.optimal_peak} B")
        check(r.arena_bytes >= r.optimal_peak,
              f"bridge {case}: arena {r.arena_bytes} B below the peak")
        check(r.exact or name not in BRIDGE_EXACT,
              f"bridge {case}: the plan fell back (exact=False)")
        check((r.optimal_peak, r.arena_bytes) == (rep.optimal_peak,
                                                 rep.arena_bytes),
              f"bridge {case}: compile_scheduled's plan differs from "
              f"schedule_fx's")

        # each arena kernel against its plain version at this program's
        # shapes and offsets: the same program on the same inputs, once
        # through the kernels and once through the plain versions, each in
        # its own zeroed arena; the aten ops between are the same calls on
        # the same bytes, so outputs and final arena bytes are bit-equal
        prog = eager.program
        flat = [t for t in tree_leaves(args) if isinstance(t, torch.Tensor)]
        arenas = {impl: torch.zeros(max(r.arena_bytes, 1), dtype=torch.uint8,
                                    device=dev) for impl in ("auto", "torch")}
        with torch.no_grad():
            held = {impl: prog.run(arenas[impl], flat, impl=impl)
                    for impl in arenas}
        torch.cuda.synchronize()
        check(all(torch.equal(k, p) for k, p in zip(held["auto"],
                                                      held["torch"]))
              and torch.equal(arenas["auto"], arenas["torch"]),
              f"bridge {case}: the arena kernels' program differs from the "
              f"plain versions' (outputs or final arena bytes)")

        want_first = tree_leaves(fn(*args))
        want_other = tree_leaves(fn(*other))
        got_first = tree_leaves(eager(*args))
        got_other = tree_leaves(res)
        for got, ref in ((got_first, want_first), (got_other, want_other)):
            check(len(got) == len(ref) and all(
                bridge_close(g, w) for g, w in zip(got, ref)),
                f"bridge {case}: the arena program's outputs are not "
                f"bit-equal to the unscheduled function's: "
                f"{[(g - w).abs().max().item() for g, w in zip(got, ref)]}")

        cap = fb.compile_scheduled(fn, jit=True)
        runs = {"first": cap(*args), "again": cap(*args)}
        kept = [t.clone() for t in tree_leaves(runs["again"])]
        runs["other"] = cap(*other)
        torch.cuda.synchronize()
        for key, y in runs.items():
            ref = got_other if key == "other" else got_first
            check(all(torch.equal(g, w)
                      for g, w in zip(tree_leaves(y), ref)),
                f"bridge {case} jit=True ({key}): not bit-equal to the "
                f"eager arena program")
        check(all(torch.equal(g, w) for g, w in zip(
            tree_leaves(runs["again"]), kept)),
            f"bridge {case}: a replay's output was overwritten by the next")
        call = cap.program.capture
        per_replay = {k: call.launches.get(k, 0) for k in LAUNCHES}
        check(per_replay == want,
              f"bridge {case}: launches per replay {per_replay}, the "
              f"program's {want}")
        traces, traced = [], {}
        while len(traces) < 3 or (traced != per_replay
                                  and len(traces) < TRACE_TRIES):
            traces.append(device_profile(lambda: cap(*args)))
            traced = max(({op: traced_copies(t[2], op)[1]
                           for op in ARENA_KERNELS} for t in traces),
                         key=lambda d: sum(d.values()))
        check(traced == per_replay,
              f"bridge {case}: the most complete of {len(traces)} traces of "
              f"a replay holds {traced} arena kernels, the program launches "
              f"{per_replay}")

        # the caching allocator's peak over one call of the unscheduled
        # function, its inputs counted as the arena holds them: what
        # PyTorch takes for the same program
        # and the same over one eager call of the arena program (its arena,
        # the fresh tensors of its reads, each op's output before its
        # write), from the same base: the bridge's own measured memory
        in_bytes = sum(t.numel() * t.element_size() for t in flat)

        def peak_of(call) -> int:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            call(*args)
            torch.cuda.synchronize()
            return torch.cuda.max_memory_allocated(dev) - base + in_bytes

        del arenas, held
        alloc_peak, bridge_peak = peak_of(fn), peak_of(eager)
        us = {"plain": event_us(lambda: fn(*args)),
              "eager": event_us(lambda: eager(*args)),
              "captured": event_us(lambda: cap(*args))}
        rec = dict(nodes=n_nodes, plan_s=plan_s, original_peak=r.original_peak,
                   kahn_peak=r.kahn_peak, optimal_peak=r.optimal_peak,
                   arena_bytes=r.arena_bytes, exact=r.exact,
                   realized_bytes=r.realized_bytes,
                   n_env_bypassed=r.n_env_bypassed,
                   launches_per_call={"write": want["write"],
                                      "read": want["read"]},
                   traced=traced, allocator_peak=alloc_peak,
                   bridge_peak=bridge_peak, us=us)
        out[case] = rec
        say(f"bridge: {case}: {rec['nodes']} nodes, planned in "
            f"{plan_s:.2f} s (host); traced / Kahn / optimal / arena "
            f"{r.original_peak} / {r.kahn_peak} / {r.optimal_peak} / "
            f"{r.arena_bytes} B, exact {r.exact}, realized == optimal; "
            f"allocator peak (inputs counted) of one call: unscheduled "
            f"{alloc_peak} B, eager arena program {bridge_peak} B; "
            f"arena launches per call {rec['launches_per_call']} (eager, "
            f"per replay and traced {traced}); kernels bit-equal to the "
            f"plain versions in the program, outputs bit-equal to the "
            f"unscheduled function's, captured bit-equal to eager; us per "
            f"call (CUDA events, "
            f"median of {BRIDGE_REPS}): unscheduled {us['plain']:.1f}, "
            f"eager arena {us['eager']:.1f}, captured {us['captured']:.1f}"
            f" [{card}]")
    say(f"bridge: phase done in {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 7: serving each model at full width
# ---------------------------------------------------------------------------


KERNEL_MODULES = ("arena", "flash_attention", "rwkv6", "rglru")


def reset_all():
    import importlib
    for m in KERNEL_MODULES:
        importlib.import_module(f"repro_torch.kernels.{m}").reset_launches()


def all_launches() -> dict:
    import importlib
    out = {}
    for m in KERNEL_MODULES:
        out.update(importlib.import_module(f"repro_torch.kernels.{m}")
                   .LAUNCHES)
    return out


def backward_routes() -> dict:
    """The flash backward's calls by kernel since the counts were last set
    to 0 (``reset_all``): the tensor-core kernel's and the CUDA-core
    one's."""
    from repro_torch.kernels.flash_attention import kernel as FK
    return dict(FK.BACKWARD_ROUTES)


def path_launches(cfg, n_cache: int, n_req: int = N_REQ,
                  batched: bool = False) -> dict:
    """Every kernel's launches over the serving run of ``n_req`` requests:
    each request runs one prefill and GEN - 1 decode steps; every forward
    runs one attention or recurrence kernel per layer of its kind
    (attention in bf16: the ``wgmma`` prefill for a prompt, the split-K
    decode for a decode step, the simple kernel never); each prefill packs
    the ``n_cache`` state leaves once, each decode step unpacks and packs
    them.  ``batched``: the requests decode together (vmap), so a decode
    step's forward runs once a tick for all of them, while the state is
    still unpacked and packed row by row."""
    if cfg.attn_free:
        kinds = ["wkv6"] * cfg.n_layers
    elif cfg.family == "hybrid":
        pat = cfg.block_pattern
        kinds = ["rglru" if pat[i % len(pat)] == "rec" else "flash_attention"
                 for i in range(cfg.n_layers)]
    else:
        kinds = ["flash_attention"] * cfg.n_layers
    want = {k: 0 for k in all_launches()}
    steps = n_req * (GEN - 1)
    forwards = GEN - 1 if batched else steps
    for k in kinds:
        if k == "flash_attention":
            want["flash_prefill"] += n_req
            want["flash_decode"] += forwards
        else:
            want[k] += n_req + forwards
    want["write"] = n_cache * (n_req + steps)
    want["read"] = n_cache * steps
    return want


def live_leaves(cfg, params, dev):
    """Fill the recurrent mixing leaves, which the init leaves at zeros or
    ones (so that the token shift, the bonus, the convolution and every
    RG-LRU carry do nothing), with seeded values, in place:
    RWKV-6 mu_x, mu, mu_k, mu_r ~ U(0, 1); lora_b, wb ~ N(0, 0.02^2); w0
    evenly spaced over [-6, -1] across channels; u ~ N(0, 0.5^2).
    Griffin conv_w ~ N(0, 0.5^2); conv_b ~ N(0, 0.1^2); lam such that
    exp(-8 softplus(lam)) ~ U(0.9, 0.999).  (The CPU tests draw the same
    recipe with numpy.)"""
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)

    def rand(t):
        return torch.rand(t.shape, device=dev, generator=gen)

    def normal(t, std):
        return std * torch.randn(t.shape, device=dev, generator=gen)

    if cfg.attn_free:
        tm, cm = params["blocks"]["tmix"], params["blocks"]["cmix"]
        for t in (tm["mu_x"], tm["mu"], cm["mu_k"], cm["mu_r"]):
            t.copy_(rand(t))
        for t in (tm["lora_b"], tm["wb"]):
            t.copy_(normal(t, 0.02))
        tm["w0"].copy_(torch.linspace(-6.0, -1.0, cfg.d_model, device=dev)
                       .expand(tm["w0"].shape))
        tm["u"].copy_(normal(tm["u"], 0.5))
    elif cfg.family == "hybrid":
        for r in [params["groups"]["rec"]["rec"]] + \
                [t["rec"] for t in params["tail"] if "rec" in t]:
            r["conv_w"].copy_(normal(r["conv_w"], 0.5))
            r["conv_b"].copy_(normal(r["conv_b"], 0.1))
            a = 0.9 + 0.099 * rand(r["lam"])
            r["lam"].copy_(torch.log(torch.expm1(-torch.log(a) / 8.0)))


def direct_decode(model, params, prompt, n_steps, dev, *, impl="auto",
                  forced=None, dtype=None):
    """Prefill + ``n_steps`` greedy decode steps with the cache kept as
    plain tensors (no arena); returns (tokens, per-step logits).  With
    ``forced``, step s feeds token ``forced[s]`` instead of its own; with
    ``dtype``, the cache is kept in that dtype."""
    from repro_torch.models.params import tree_map
    P = len(prompt)
    cache = model.init_cache(1, P + GEN, dev)
    if dtype is not None:
        cache = tree_map(lambda t: t.to(dtype), cache)
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    logits, cache = model.prefill_fn(params, cache, {"tokens": tokens},
                                     impl=impl)
    toks, outs = [int(torch.argmax(logits, -1)[0])], [logits]
    for s in range(n_steps):
        tok = toks[-1] if forced is None else forced[s]
        t = torch.full((1, 1), tok, dtype=torch.long, device=dev)
        logits, cache = model.decode_fn(params, cache, t, P + s, impl=impl)
        toks.append(int(torch.argmax(logits, -1)[0]))
        outs.append(logits)
    return toks, outs


def check_logits(model, params, prompt, dev):
    """Prefill + LOGIT_STEPS decode steps through the kernels and through
    the plain versions, in bf16 as served and with params and cache in
    f32, every run fed the kernels' bf16 greedy tokens; returns the max
    abs logit differences (bf16 kernels vs plain, f32 kernels vs plain,
    bf16 plain vs f32 plain) and the max |logit|."""
    from repro_torch.models.params import tree_map
    toks, auto = direct_decode(model, params, prompt, LOGIT_STEPS, dev)
    check(all(bool(torch.isfinite(a).all())
              and a.shape == (1, model.cfg.vocab_size) for a in auto),
          "logits not finite or of the wrong shape")
    forced = toks[:LOGIT_STEPS]
    _, plain = direct_decode(model, params, prompt, LOGIT_STEPS, dev,
                             impl="torch", forced=forced)
    p32 = tree_map(lambda t: t.float(), params)
    runs32 = [direct_decode(model, p32, prompt, LOGIT_STEPS, dev, impl=impl,
                            forced=forced, dtype=torch.float32)[1]
              for impl in ("auto", "torch")]
    del p32
    torch.cuda.empty_cache()
    diff = lambda xs, ys: max(float((a - b).abs().max())
                              for a, b in zip(xs, ys))
    return (diff(auto, plain), diff(*runs32), diff(plain, runs32[1]),
            max(float(a.abs().max()) for a in auto))


def check_recurrence_matters(model, params, prompt, dev):
    """With the live leaves, zeroing the carried state between prefill and
    the first decode step must move the logits."""
    from repro_torch.models.params import tree_map
    cfg = model.cfg
    groups = (("tm_x", "cm_x"), ("wkv",)) if cfg.attn_free \
        else (("conv",), ("h",))
    P = len(prompt)
    cache = model.init_cache(1, P + GEN, dev)
    tokens = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    logits, cache = model.prefill_fn(params, cache, {"tokens": tokens})
    tok = torch.argmax(logits, -1)[:, None]

    def step(zero):
        c = tree_map(lambda t: t.clone(), cache)
        for d in [c] if cfg.attn_free else \
                [c["rec"]] + [x for x in c["tail"] if "h" in x]:
            for name in zero:
                d[name].zero_()
        return model.decode_fn(params, c, tok, P)[0]

    base = step(())
    moved = {"+".join(z): float((step(z) - base).abs().max())
             for z in groups}
    check(all(m > 1e-3 for m in moved.values()),
          f"{cfg.name}: zeroing the carried state did not move the logits "
          f"{moved}")
    return moved


def check_served_packing(model, params, plan, req, dev):
    """The u8 arena kernels at the served sizes: one request's prefilled
    cache packed into an arena of the plan's resident extent (random bytes
    to start with) by the kernels and by their plain versions must give the
    same arena, with each leaf's bytes at its planned offset; unpacking it
    both ways must give the leaves back, bit for bit."""
    from repro_torch.core.executor import pack_buffers, unpack_buffer
    from repro_torch.kernels.arena.kernel import copy_plan
    from repro_torch.models.params import tree_leaves

    cache = model.init_cache(1, len(req.prompt) + GEN, dev)
    tokens = torch.as_tensor(req.prompt, dtype=torch.long, device=dev)[None]
    _, cache = model.prefill_fn(params, cache, {"tokens": tokens})
    leaves = dict(enumerate(tree_leaves(cache)))
    apl = plan["plan"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    start = torch.randint(0, 256, (plan["resident_extent"],),
                          dtype=torch.uint8, device=dev, generator=gen)
    packed = {impl: pack_buffers(apl, leaves, arena=start.clone(), impl=impl,
                                 device=dev) for impl in ("cuda", "torch")}
    torch.cuda.synchronize()
    check(torch.equal(packed["cuda"], packed["torch"]),
          "served cache: the u8 write kernel's arena differs from the plain "
          "version's")
    spans, modes = [], set()
    for i, leaf in leaves.items():
        raw = leaf.reshape(-1).view(torch.uint8)
        o, n = apl.offset_of(i), raw.numel()
        spans.append((o, n))
        modes.add(copy_plan(packed["cuda"].data_ptr() + o, raw.data_ptr(),
                            n).mode)
        check(torch.equal(packed["cuda"][o:o + n], raw),
              f"served cache leaf {i}: bytes not at planned offset {o}")
        backs = {impl: unpack_buffer(packed["cuda"], apl, i, leaf.shape,
                                     leaf.dtype, impl=impl)
                 for impl in ("cuda", "torch")}
        for impl, back in backs.items():
            check(back.dtype == leaf.dtype and torch.equal(
                back.reshape(-1).view(torch.uint8), raw),
                f"served cache leaf {i}: unpacked by {impl} != the leaf")
    torch.cuda.synchronize()
    say(f"serve: one prefilled {model.cfg.name} cache "
        f"({', '.join(str(t.dtype).split('.')[1] for t in leaves.values())}"
        f") packed into {plan['resident_extent']} B by the u8 write kernel "
        f"and by its plain version: arenas bit-equal, leaves (offset, bytes) "
        f"{spans} at their planned offsets (copy modes {sorted(modes)}); "
        f"unpacked by the u8 read kernel and by its plain version: "
        f"bit-equal to the leaves")
    return spans


def phase_serve(dev, arch):
    import repro_torch.configs as configs
    from repro_torch.launch import serve as S
    from repro_torch.models.params import leaf_count, tree_leaves
    from repro_torch.models.zoo import build_model

    spec = SERVES[arch]
    prompt_len = spec["prompt"]
    cfg = configs.get(arch)
    model = build_model(cfg)
    smax = prompt_len + GEN
    plan = S.plan_decode_arena(model, 1, smax)
    got = {k: plan[k] for k in spec["plan"]}
    check(got == spec["plan"], f"{arch} decode plan {got} != reference "
                               f"{spec['plan']}")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    live_leaves(cfg, params, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    check(n_params == leaf_count(model.defs),
          f"{n_params} parameters made, {leaf_count(model.defs)} defined")
    say(f"serve: {arch} at full width, {n_params} parameters in bf16 "
        f"({cfg.param_count()} without the norm scales) made on the card "
        f"in {time.perf_counter() - t0:.3f} s; decode plan {got}, policy "
        f"{plan['policy']} (the reference's integers)")

    budget = 4 * plan["arena_bytes"]      # the CLI's default budget
    reqs = S.synth_requests(N_REQ, prompt_len, GEN, cfg.vocab_size, SEED + 1)
    reset_all()
    m = S.run_server(model, params, reqs, smax=smax, budget_bytes=budget,
                     warm=2)
    torch.cuda.synchronize()
    launches = all_launches()
    say(f"serve: {arch}: {m['n_served']}/{m['n_requests']} served, "
        f"{m['n_rejected']} rejected, {m['n_tokens']} tokens in "
        f"{m['wall_s']:.2f} s over {m['steps']} ticks, concurrency "
        f"{m['max_concurrent']} under {budget} B; launches over the run "
        f"{launches}")
    check(m["n_served"] == N_REQ and m["n_rejected"] == 0
          and m["n_tokens"] == N_REQ * GEN,
          f"served {m['n_served']}, rejected {m['n_rejected']}, "
          f"{m['n_tokens']} tokens")
    want = path_launches(cfg, plan["n_cache"])
    for k, n in want.items():
        check(launches[k] == n, f"{arch}: {k} launched {launches[k]} times, "
                                f"the serving path needs {n}")
    routes = None
    if want["rglru"]:
        # each prompt through the staged kernel, each decode step through
        # the step kernel, in every recurrent layer
        from repro_torch.kernels.rglru import kernel as RK
        layers = want["rglru"] // (N_REQ * GEN)
        routes = dict(RK.ROUTES)
        need = {"step": layers * N_REQ * (GEN - 1), "staged": layers * N_REQ}
        check(routes == need and RK.pick_route(prompt_len) == "staged"
              and RK.pick_route(1) == "step",
              f"{arch}: rglru launches by kernel {routes}, the serving path "
              f"needs {need}")
        say(f"serve: {arch}: rglru launches by kernel {routes} (staged "
            f"prefills, step decodes)")
    spans = check_served_packing(model, params, plan, reqs[0], dev)

    for r in reqs:
        toks, _ = direct_decode(model, params, r.prompt, GEN - 1, dev)
        check(toks == list(r.tokens),
              f"{arch} request {r.rid}: server tokens differ from the "
              f"arena-free loop")
    e, e32, gap, peak = check_logits(model, params, reqs[0].prompt, dev)
    tol = spec["logit_atol"]
    check(e32 <= LOGIT_ATOL32,
          f"{arch}: f32 logits of the kernels vs the plain versions: max "
          f"abs err {e32} > {LOGIT_ATOL32}")
    check(e <= tol, f"{arch}: bf16 logits of the kernels vs the plain "
                    f"versions: max abs err {e} > {tol}")
    say(f"serve: {arch}: tokens of all {N_REQ} requests bit-equal to the "
        f"arena-free prefill + decode loop; prefill + {LOGIT_STEPS} decode "
        f"steps' logits, kernels vs plain versions: f32 max abs err "
        f"{e32:.3e} (atol {LOGIT_ATOL32}), bf16 {e:.3e} (atol {tol}); the "
        f"plain versions' bf16 logits vs their f32 ones {gap:.3e}; max "
        f"|logit| {peak:.3f}")
    if cfg.attn_free or cfg.family == "hybrid":
        moved = check_recurrence_matters(model, params, reqs[0].prompt, dev)
        say(f"serve: {arch}: zeroing the carried state before the first "
            f"decode step moves the logits by {moved} (max abs)")
    return dict(model=model, params=params, plan=plan, reqs=reqs,
                launches=launches, routes=routes, spans=spans, smax=smax,
                metrics=m)


def hold_tokens(what, model, params, serial, batched, tol, dev):
    """The batched run's tokens against the serial run's, request by
    request: equal, or equal up to a first divergence at a step where the
    serial reference's top-1 margin is under ``tol`` (a tie that rounding
    in the batched products may break the other way).  Returns the
    divergences as (rid, step, margin)."""
    ties = []
    for a, b in zip(serial, batched):
        ta, tb = list(a.tokens), list(b.tokens)
        check(len(ta) == len(tb) == GEN, f"{what} request {a.rid}: "
                                         f"{len(tb)} tokens, {len(ta)} serial")
        if ta == tb:
            continue
        s = next(i for i, (x, y) in enumerate(zip(ta, tb)) if x != y)
        toks, outs = direct_decode(model, params, a.prompt, s, dev)
        check(toks == ta[:s + 1], f"{what} request {a.rid}: the arena-free "
                                  f"loop differs from the serial server")
        top2 = outs[s][0].float().topk(2).values
        margin = float(top2[0] - top2[1])
        check(margin < tol,
              f"{what} request {a.rid}: tokens differ from serial at step "
              f"{s}, where the serial top-1 margin {margin} is not under "
              f"{tol}")
        ties.append((a.rid, s, margin))
    return ties


def check_batched_logits(model, params, prompt, dev, f32, rows=N_REQ):
    """LOGIT_STEPS decode steps of ``rows`` requests in one batched step
    against each row decoded alone (the serial step), through the
    kernels, both fed the batched step's greedy tokens: with params and
    cache in f32 (``f32``), or as served; the rows' prompts are cuts of
    ``prompt`` of different lengths, so that each row decodes at its own
    position.  Returns the max abs logit difference and the lengths."""
    from repro_torch.models.params import is_def, tree_leaves, tree_map
    cast = (lambda c: tree_map(lambda t: t.float(), c)) if f32 else \
        (lambda c: c)
    p32 = cast(params)
    smax = len(prompt) + GEN
    lens = [len(prompt) - 7 * b for b in range(rows)]
    axes = [d.logical.index("batch") for d in tree_leaves(
        model.make_cache_defs(1, smax), is_leaf=is_def)]
    batched = cast(model.init_cache(rows, smax, dev))
    caches, toks = [], []
    for b, n in enumerate(lens):
        c = cast(model.init_cache(1, smax, dev))
        tokens = torch.as_tensor(prompt[:n], dtype=torch.long,
                                 device=dev)[None]
        logits, c = model.prefill_fn(p32, c, {"tokens": tokens})
        for ax, dst, one in zip(axes, tree_leaves(batched), tree_leaves(c)):
            dst.narrow(ax, b, 1).copy_(one)
        caches.append(c)
        toks.append(int(torch.argmax(logits, -1)[0]))
    worst = 0.0
    for s in range(LOGIT_STEPS):
        got, batched = model.decode_fn(
            p32, batched, torch.tensor(toks, device=dev)[:, None],
            torch.tensor([n + s for n in lens], device=dev))
        for b in range(rows):
            want, caches[b] = model.decode_fn(
                p32, caches[b], torch.tensor([[toks[b]]], device=dev),
                lens[b] + s)
            worst = max(worst, float((got[b] - want[0]).abs().max()))
        toks = [int(t) for t in torch.argmax(got, -1).tolist()]
    check(all(bool(torch.isfinite(t.float()).all())
              for t in tree_leaves(batched)),
          f"{model.cfg.name}: the batched state is not finite")
    del p32, batched, caches
    torch.cuda.empty_cache()
    return worst, lens


#: the port's kernels in a trace, by the launch counts' names
TRACE_NAMES = {"write": "arena_write_kernel", "read": "arena_read_kernel",
               "flash_decode": "flash_decode_kernel", "wkv6": "wkv6_kernel",
               "rglru": "rglru_step_kernel"}


def phase_serve_vmap(ctx, card, dev):
    """The batched decode (``step_mode="vmap"``) of one served model at its
    published width: the 4 requests of the serial run through
    ``run_server(step_mode="vmap")`` (one captured step per bucket), their
    tokens against the serial run's (``hold_tokens``) and the kernels'
    launches over the run exactly the batched path's count; the first 3 of
    them, which pad to bucket 4 and reserve the padding row's bytes; the
    logits of LOGIT_STEPS batched steps against the serial step, in f32
    and in bf16 as served; then one
    server's ticks at bucket 4: ms per tick and per token, the launches of
    a tick (the captured step's recorded counts plus one u8 read and write
    a leaf and row), the device's busy time, idle share and activities per
    tick, each kernel's us per launch in the tick's trace, and the row
    staging copies.  Returns the numbers for the JSON."""
    from repro_torch.launch import serve as S

    model, params, plan, reqs = (ctx[k] for k in ("model", "params", "plan",
                                                  "reqs"))
    cfg, smax = model.cfg, ctx["smax"]
    name, tol, n_cache = cfg.name, SERVES[cfg.name]["logit_atol"], \
        plan["n_cache"]
    budget, arena = 4 * plan["arena_bytes"], plan["arena_bytes"]
    out = {"serial_wall_s": ctx["metrics"]["wall_s"]}
    for n in (N_REQ, N_REQ - 1):
        vreqs = S.synth_requests(n, len(reqs[0].prompt), GEN, cfg.vocab_size,
                                 SEED + 1)
        check(all(np.array_equal(a.prompt, b.prompt)
                  for a, b in zip(vreqs, reqs)), "the requests' prompts")
        reset_all()
        m = S.run_server(model, params, vreqs, smax=smax, budget_bytes=budget,
                         step_mode="vmap", warm=2)
        torch.cuda.synchronize()
        launches = all_launches()
        check(m["n_served"] == n and m["n_rejected"] == 0
              and m["n_tokens"] == n * GEN and m["max_concurrent"] == n,
              f"{name} vmap, {n} requests: served {m['n_served']}, "
              f"rejected {m['n_rejected']}, {m['n_tokens']} tokens, "
              f"concurrency {m['max_concurrent']}")
        ties = hold_tokens(f"{name} vmap", model, params, reqs[:n], vreqs,
                           tol, dev)
        want = path_launches(cfg, n_cache, n, batched=True)
        for k, c in want.items():
            check(launches[k] == c, f"{name} vmap, {n} requests: {k} "
                                    f"launched {launches[k]} times, the "
                                    f"batched path needs {c}")
        # n = 4 fills the budget; n = 3 pads to bucket 4, whose padding row
        # is reserved for each step
        check(m["peak_reserved_bytes"] == 4 * arena <= m["budget_bytes"],
              f"{name} vmap, {n} requests: peak reserved "
              f"{m['peak_reserved_bytes']}, 4 arenas {4 * arena}")
        say(f"serve: {name} vmap: {n} requests, {m['n_tokens']} tokens in "
            f"{m['wall_s']:.2f} s ({m['tok_per_s']:.1f} tok/s; serial "
            f"{out['serial_wall_s']:.2f} s for 4) over {m['steps']} ticks, "
            f"bucket 4{' (one padding row)' if n < 4 else ''}, peak reserved "
            f"{m['peak_reserved_bytes']} B = 4 arenas; tokens against the "
            f"serial run: {'all equal' if not ties else ties} (a divergence "
            f"only where the serial top-1 margin < {tol}); launches over "
            f"the run the batched path's count {launches} [{card}]")
        out[f"run_{n}"] = dict(wall_s=m["wall_s"], tok_per_s=m["tok_per_s"],
                               ticks=m["steps"], ties=ties,
                               peak_reserved_bytes=m["peak_reserved_bytes"])

    e32, lens = check_batched_logits(model, params, reqs[0].prompt, dev,
                                     f32=True)
    e16, _ = check_batched_logits(model, params, reqs[0].prompt, dev,
                                  f32=False)
    check(e32 <= LOGIT_ATOL32 and e16 <= tol,
          f"{name}: logits of the batched step vs the serial step: max abs "
          f"err f32 {e32} (atol {LOGIT_ATOL32}), bf16 {e16} (atol {tol})")
    say(f"serve: {name} vmap: {LOGIT_STEPS} batched decode steps of "
        f"{N_REQ} rows (prompts of {lens}) vs each row's serial step: max "
        f"abs logit err f32 {e32:.3e} (atol {LOGIT_ATOL32}), bf16 as served "
        f"{e16:.3e} (atol {tol})")
    out["logit_err_f32"], out["logit_err_bf16"] = e32, e16

    # one server's ticks at bucket 4
    pool = S.make_pool(budget, step_mode="vmap")
    server = S.DecodeServer(model, params, pool, smax=smax,
                            step_mode="vmap")
    for r in S.synth_requests(N_REQ, len(reqs[0].prompt), GEN,
                              cfg.vocab_size, SEED + 1):
        server.submit(r)
    server.step()        # admit + prefill + the first tick (the capture)
    step = server._batched
    check(step.bucket == N_REQ, f"{name}: the live bucket step is of "
                                f"{step.bucket} rows, not {N_REQ}")
    ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tick_ms = statistics.median(ms)
    want = {k: n for k, n in step.call.launches.items() if n}
    for k in ("read", "write"):
        want[k] = want.get(k, 0) + n_cache * N_REQ
    traces = []
    for _ in range(TOKEN_TRACES):
        reset_all()
        traces.append(device_profile(server.step))
        per_tick = {k: v for k, v in all_launches().items() if v}
        check(per_tick == want,
              f"{name} vmap tick: launches {per_tick}, the captured step's "
              f"{step.call.launches} + {n_cache} leaves x {N_REQ} rows of "
              f"u8 reads and writes = {want}")
    check(step.call.replays >= 8 + TOKEN_TRACES,
          f"{name}: the vmap ticks did not replay the bucket's captured step")
    busy_us, n_dev, by_name = max(traces, key=lambda t: t[1])
    kernel_us = {}
    for k, sub in TRACE_NAMES.items():
        hits = [v for nm, v in by_name.items() if sub in nm]
        if hits:
            kernel_us[k] = (sum(v[0] for v in hits) / sum(v[1] for v in hits),
                            sum(v[1] for v in hits))
    stage_ms = time_staging(server, card)
    del step
    resident = bucket_resident(server, card)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    say(f"timing: serve {name} vmap: {tick_ms:.3f} ms per tick of {N_REQ} "
        f"rows (median of 8, min {min(ms):.3f}, host clock), "
        f"{tick_ms / N_REQ:.3f} ms per token; device busy {busy_us:.1f} us "
        f"per tick, idle share {1 - busy_us / (tick_ms * 1e3):.4f}; "
        f"{n_dev} device activities per tick (the most of "
        f"{[t[1] for t in traces]}; no limit); launches per tick {want}; "
        f"the port's kernels in the tick's trace, us per launch (launches): "
        + ", ".join(f"{k} {u:.2f} ({c})" for k, (u, c) in kernel_us.items())
        + f" [{card}]")
    say(f"timing: serve {name} vmap tick, device us by kernel (count): "
        + "; ".join(f"{k[:60]} {t:.1f} ({c})" for k, (t, c) in top))
    out["tick"] = dict(
        ms=tick_ms, min_ms=min(ms), ms_per_token=tick_ms / N_REQ,
        busy_us=busy_us, idle_share=1 - busy_us / (tick_ms * 1e3),
        activities=n_dev, launches=want, kernel_us=kernel_us,
        staging=stage_ms, resident=resident)
    del server
    torch.cuda.empty_cache()
    return out


def bucket_resident(server, card):
    """The device memory the server's live bucket step holds: its static
    ``(bucket, smax)`` cache, and the allocated and reserved bytes freed
    when the step goes (the cache and the graph's private pool).  The
    server keeps one bucket's step at a time; this drops it (the server
    holds its last reference) with the garbage collector off, as a new
    bucket does: what it frees, it frees at once."""
    from repro_torch.models.params import tree_leaves
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(server._batched.cache))
    torch.cuda.synchronize()
    gc.collect()
    gc.disable()
    alloc, held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    server._batched = None
    torch.cuda.empty_cache()
    out = dict(bucket=N_REQ, cache_bytes=cache_bytes,
               allocated_bytes=alloc - torch.cuda.memory_allocated(),
               reserved_bytes=held - torch.cuda.memory_reserved())
    gc.enable()
    check(out["allocated_bytes"] >= cache_bytes,
          f"{server.model.cfg.name}: dropping the bucket-{N_REQ} step freed "
          f"{out['allocated_bytes']} B, less than its static cache "
          f"{cache_bytes} B: something still holds it")
    say(f"serve: {server.model.cfg.name} vmap: the bucket-{N_REQ} step "
        f"holds {out['allocated_bytes']} B allocated "
        f"({out['reserved_bytes']} B reserved): its static cache "
        f"{cache_bytes} B and its graph pool; the server keeps one bucket's "
        f"step at a time [{card}]")
    return out


def time_staging(server, card):
    """The row staging copies of one tick at bucket 4: each row's state
    copied from the staging tree into its row of the batched cache and
    back (one strided copy a leaf and direction), device us per tick in
    each direction, against the bound (each row's state read and written
    once)."""
    from repro_torch.models.params import tree_leaves
    cache = server._batched.cache
    stage = tree_leaves(server._stage)
    rows_in, rows_out = [], []
    for i in range(N_REQ):
        for ax, rows, one in zip(server._batch_axes, tree_leaves(cache),
                                 stage):
            rows_in.append((rows.narrow(ax, i, 1), one))
            rows_out.append((one, rows.narrow(ax, i, 1)))
    row_bytes = sum(t.numel() * t.element_size() for t in stage)
    bound_us = 2 * row_bytes / HBM_BYTES_PER_S * 1e6
    out = {}
    for label, args in (("in", rows_in), ("out", rows_out)):
        dev_ms, call_ms = time_replay(args, lambda d, s: d.copy_(s), reps=5)
        out[label] = dict(us_per_tick=dev_ms * 1e3 * len(args),
                          us_per_row=dev_ms * 1e3 * len(args) / N_REQ,
                          host_us_per_tick=call_ms * 1e3 * len(args))
    out["bound_us_per_row"] = bound_us
    out["row_bytes"] = row_bytes
    say(f"timing: serve {server.model.cfg.name} vmap row staging copies "
        f"({len(stage)} leaves, {row_bytes} B a row): device us per row "
        f"in {out['in']['us_per_row']:.2f}, out {out['out']['us_per_row']:.2f}"
        f" (bound {bound_us:.2f}: the row read and written once); per tick "
        f"of {N_REQ} rows in {out['in']['us_per_tick']:.1f}, out "
        f"{out['out']['us_per_tick']:.1f} [{card}]")
    return out


# ---------------------------------------------------------------------------
# Phase 8: timings
# ---------------------------------------------------------------------------


# the lead of every trace: torch.cuda._sleep's kernel, about a millisecond
LEAD_CYCLES, LEAD_KERNEL = 2_000_000, "spin_kernel"


def device_profile(work, required=True):
    """(microseconds, activities, {name: [us, count]}) of the card during
    ``work()``: the kernels and copies of a ``torch.profiler`` trace,
    summed and counted, in all and by name.  A trace lacks the first
    kernels launched after it starts, so a short spin kernel runs to its end
    in the trace before ``work()`` and is left out of the counts.  A short
    trace sometimes comes back empty on the card's machine; it is taken
    again, up to TRACE_TRIES times, and then None is returned, or the run
    fails if ``required``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(TRACE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(LEAD_CYCLES)
            torch.cuda.synchronize()
            work()
            torch.cuda.synchronize()
        evs = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and LEAD_KERNEL not in e.name]
        by_name = {}
        for e in evs:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
        us = sum(t for t, _ in by_name.values())
        if us > 0:
            return us, len(evs), by_name
        time.sleep(0.5 * (attempt + 1))
    check(not required, f"the profiler saw no device activity in "
                        f"{TRACE_TRIES} traces of "
                        f"{getattr(work, '__name__', work)}")
    return None


def device_us(work) -> float:
    """Microseconds the card spent running kernels (and copies) during
    ``work()``."""
    return device_profile(work)[0]


def time_execute(rt, p, inputs, fuse, reps=20, jit=False):
    """(median, min) host-clock us per execute, and device-busy us per
    execute, with the inputs already on the card; ``jit`` replays the
    program's CUDA graph."""
    dev_inputs = {k: torch.from_numpy(v).cuda() for k, v in inputs.items()}

    def run():
        rt.execute(p.graph, dev_inputs, p.arena, order=p.order, fuse=fuse,
                   jit=jit)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    us = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        us.append((time.perf_counter() - t0) * 1e6)
    busy = device_us(lambda: [run() for _ in range(3)]) / 3
    return statistics.median(us), min(us), busy


def record_launches(rt, plans, inputs):
    """The (kernel, arena elements, offset, n, ops) of every launch one
    execute of each full network makes, slice and fused."""
    from repro_torch.kernels.arena import kernel as K
    log = []
    names = ("write", "read", "accum", "chain_write")
    orig = {nm: getattr(K, f"arena_{nm}_cuda") for nm in names}

    def rec(nm):
        def wrapped(arena, *args):
            if nm == "read":
                offset, n = args[:2]
                log.append((nm, arena.shape[0], offset, n, ()))
            else:
                x, offset, *ops = args
                log.append((nm, arena.shape[0], offset, x.shape[0],
                            tuple(ops[0]) if ops else ()))
            return orig[nm](arena, *args)
        return wrapped

    try:
        for nm in names:
            setattr(K, f"arena_{nm}_cuda", rec(nm))
        for name in ("darts_net_x6", "randwire_net_32x8"):
            p = plans[name]
            for fuse in (False, True):
                rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                           fuse=fuse)
    finally:
        for nm in names:
            setattr(K, f"arena_{nm}_cuda", orig[nm])
    torch.cuda.synchronize()
    return [e for e in log if e[3] > 0]


def time_replay(launches_of, fn, reps=20, one_launch=False,
                complete=False):
    """(device ms, host-clock ms) per launch of ``fn`` over the recorded
    launches: the card's own time from the profiler (or, where no trace
    comes back, the CUDA events' time), and the time per call with the
    host's issue cost, from CUDA events around ``reps`` passes.  With
    ``one_launch`` (``fn`` launches one kernel a call) the device time is
    the mean over the kernels the trace holds, so a trace that lost some
    of them does not read low.  With ``complete`` (``fn`` makes one device
    activity a call) the device time comes only from a trace that holds
    every call's activity, taken up to TRACE_TRIES times, else it is None
    (not measured)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def one_pass():
        for args in launches_of:
            fn(*args)

    for _ in range(2):
        one_pass()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        one_pass()
    end.record()
    torch.cuda.synchronize()
    call_ms = start.elapsed_time(end) / (reps * len(launches_of))
    # traces of a launch or two have come back empty on the card's
    # machine: trace enough passes for some 64 launches, unless a pass
    # already takes a millisecond
    passes = 1 if call_ms * len(launches_of) > 1.0 else \
        max(1, min(reps, 64 // len(launches_of)))
    calls = passes * len(launches_of)
    best = None
    for _ in range(TRACE_TRIES if complete else 1):
        prof = device_profile(lambda: [one_pass() for _ in range(passes)],
                              required=False)
        if prof is not None and (best is None or prof[1] > best[1]):
            best = prof
        if prof is None or not complete or prof[1] == calls:
            break
    if complete and (best is None or best[1] != calls):
        held = "none" if best is None else (
            f"at most {best[1]}, whose mean is "
            f"{best[0] / best[1]:.3f} us (not used)")
        say(f"timing: no trace of {getattr(fn, '__name__', fn)} held all "
            f"{calls} of its activities ({held}); its device time is not "
            f"measured")
        return None, call_ms
    if prof is None:
        say(f"timing: no trace of {getattr(fn, '__name__', fn)}; its "
            f"device time below is the CUDA events' time per call")
        return call_ms, call_ms
    if one_launch:
        if prof[1] != calls:
            say(f"timing: the trace holds {prof[1]} of {calls} launches of "
                f"{getattr(fn, '__name__', fn)}; their mean is its time")
        return prof[0] / 1e3 / prof[1], call_ms
    return prof[0] / 1e3 / calls, call_ms


class L2Flush:
    """Writes FLUSH_BYTES of scratch, which leaves none of a copy's source
    or destination in the 50 MB L2; ``names`` are its kernels' names in a
    trace, which a cold timing leaves out of the device time."""

    def __init__(self, dev):
        self.buf = torch.empty(FLUSH_BYTES // 4, device=dev)
        self.names = set(device_profile(
            lambda: [self() for _ in range(16)])[2])

    def __call__(self):
        self.buf.fill_(1.0)


def time_in_graph(launches_of, fn, dev, reps=20):
    """(device ms per launch, ms per launch of a replay) of ``fn`` over the
    recorded launches captured in one CUDA graph: the mean of the
    activities in a trace of one replay (None where every trace came back
    empty), and a replay's time by CUDA events over ``reps`` replays per
    launch (the gaps between the graph's nodes included)."""
    from repro_torch.core.capture import CapturedCall
    call = CapturedCall(lambda: [fn(*a) for a in launches_of], dev)
    for _ in range(2):
        call.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        call.replay()
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / (reps * len(launches_of))
    prof = device_profile(call.replay, required=False)
    if prof is None:
        say(f"timing: no trace of a replayed graph of "
            f"{getattr(fn, '__name__', fn)}; not measured")
        return None, step_ms
    if prof[1] != len(launches_of):
        say(f"timing: the trace of a replayed graph holds {prof[1]} of "
            f"{len(launches_of)} launches of {getattr(fn, '__name__', fn)}; "
            f"their mean is its time")
    return prof[0] / 1e3 / prof[1], step_ms


def time_cold(launches_of, fn, flush):
    """Device ms per launch of ``fn`` over the recorded launches with the
    L2 flushed before each launch (the flush's own kernels left out by
    name), or None where every trace came back empty.  At least 64
    launches are traced."""
    def one_pass():
        for args in launches_of:
            flush()
            fn(*args)

    one_pass()
    passes = max(1, 64 // len(launches_of))
    prof = device_profile(lambda: [one_pass() for _ in range(passes)],
                          required=False)
    if prof is None:
        say(f"timing: no trace of {getattr(fn, '__name__', fn)} cold; "
            f"not measured")
        return None
    us = sum(t for k, (t, _) in prof[2].items() if k not in flush.names)
    return us / 1e3 / (passes * len(launches_of))


def fmt_us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.3f}"


def phase_timing(plans, inputs, launches, err, card, captured):
    import repro_torch as rt
    from repro_torch.kernels.arena import LAUNCHES, reset_launches
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    executes = {}
    for name in ("darts_net_x6", "randwire_net_32x8"):
        p = plans[name]
        for fuse in (False, True):
            reset_launches()
            rt.execute(p.graph, inputs[name], p.arena, order=p.order,
                       fuse=fuse)
            torch.cuda.synchronize()
            per_exec = dict(LAUNCHES)
            path = "fused" if fuse else "slice"
            # eager, captured (jit=True), eager, captured: in turns
            t = [time_execute(rt, p, inputs[name], fuse, jit=jit)
                 for jit in (False, True, False, True)]
            for i, jit in enumerate((False, True, False, True)):
                med, best, busy = t[i]
                say(f"timing: execute {name} {path} "
                    f"{'captured (jit=True)' if jit else 'eager'}"
                    f"{' again' if i > 1 else ''}: median {med:.1f} us, min "
                    f"{best:.1f} us per execute (host clock); device busy "
                    f"{busy:.1f} us per execute, idle share "
                    f"{1 - busy / med:.4f}; arena kernel launches per "
                    f"execute {per_exec}"
                    f"{', per replay ' + str(captured[(name, fuse)]) if jit else ''}"
                    f" [{card}]")
            executes[f"{name} {path}"] = dict(
                eager_us=[x[0] for x in t[0::2]],
                eager_min_us=[x[1] for x in t[0::2]],
                eager_busy_us=[x[2] for x in t[0::2]],
                captured_us=[x[0] for x in t[1::2]],
                captured_min_us=[x[1] for x in t[1::2]],
                captured_busy_us=[x[2] for x in t[1::2]])

    say("timing: execute, eager and captured: " + json.dumps(executes)
        + f" [{card}]")
    log = record_launches(rt, plans, inputs)
    dev = torch.device("cuda", torch.cuda.current_device())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    arena_elems = max(e[1] for e in log)
    arena = torch.randn(arena_elems, device=dev, generator=gen)
    xs = {}

    def x_of(n):
        if n not in xs:
            xs[n] = torch.randn(n, device=dev, generator=gen)
        return xs[n]

    impls = {
        "write": (K.arena_write_cuda, R.arena_write_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].copy_(x)),
        "read": (K.arena_read_cuda, R.arena_read_torch,
                 lambda a, o, n: a[o:o + n].clone()),
        "accum": (K.arena_accum_cuda, R.arena_accum_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].add_(x)),
        "chain_write": (K.arena_chain_write_cuda, R.arena_chain_write_torch,
                        None),
    }
    # bytes each launch must move: inputs read once, outputs written once
    per_elem = {"write": 8, "read": 8, "accum": 12, "chain_write": 8}
    flush = L2Flush(dev)
    rows = []
    for name, (kern, plain, lib) in impls.items():
        recs = [e for e in log if e[0] == name]
        check(len(recs) > 0, f"no recorded launches of {name}")
        if name == "read":
            args = [(arena, o, n) for _, _, o, n, _ in recs]
        elif name == "chain_write":
            args = [(arena, x_of(n), o, ops) for _, _, o, n, ops in recs]
        else:
            args = [(arena, x_of(n), o) for _, _, o, n, _ in recs]
        ms, call_ms = time_replay(args, kern)
        plain_ms, plain_call_ms = time_replay(args, plain)
        lib_ms, lib_call_ms = (None, None) if lib is None \
            else time_replay(args, lib)
        floor = ""
        if name == "chain_write":
            # no one torch call applies a chain: copy_ of the same bytes is
            # a floor of the launch, not the same function
            floor_ms = time_replay(
                args, lambda a, x, o, ops: a[o:o + x.shape[0]].copy_(x))[0]
            floor = (f"; launch-floor yardstick (copy_ of the same bytes, "
                     f"not the same function) {floor_ms * 1e3:.3f}")
        mean_bytes = per_elem[name] * sum(r[3] for r in recs) / len(recs)
        bound_ms = mean_bytes / HBM_BYTES_PER_S * 1e3
        row = dict(
            name=f"arena_{name}", route="cuda",
            source="src/repro_torch/csrc/arena.cu",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=err[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", library_ms=lib_ms)
        cold = ""
        if name in ("write", "read"):
            # L2 flushed before each launch, in turns: kernel, plain,
            # torch call, kernel
            c = [time_cold(args, f, flush) for f in (kern, plain, lib, kern)]
            row.update(cold_ms=c[0], cold_plain_ms=c[1], cold_library_ms=c[2],
                       cold_ms_again=c[3])
            cold = (f"; cold (L2 flushed before each launch): kernel "
                    f"{fmt_us(c[0])} (again {fmt_us(c[3])}), plain "
                    f"{fmt_us(c[1])}, torch call {fmt_us(c[2])}")
            # inside a CUDA graph, as a captured execute runs them: kernel,
            # torch call, kernel, in turns
            g = [time_in_graph(args, f, dev) for f in (kern, lib, kern)]
            row.update(graph_ms=g[0][0], graph_step_ms=g[0][1],
                       graph_library_ms=g[1][0],
                       graph_library_step_ms=g[1][1],
                       graph_ms_again=g[2][0], graph_step_ms_again=g[2][1])
            cold += (f"; in a replayed graph of the launches, device us per "
                     f"launch (the trace's mean) kernel {fmt_us(g[0][0])} "
                     f"(again {fmt_us(g[2][0])}), torch call "
                     f"{fmt_us(g[1][0])}; us per launch of a replay (CUDA "
                     f"events, gaps between nodes included) kernel "
                     f"{fmt_us(g[0][1])} (again {fmt_us(g[2][1])}), torch "
                     f"call {fmt_us(g[1][1])}")
        say(f"timing: {name}: {len(recs)} launches at the main path's shapes "
            f"(mean n {mean_bytes / per_elem[name]:.0f}); device us per "
            f"launch: kernel {ms * 1e3:.3f}, bound {bound_ms * 1e3:.3f} "
            f"(bytes), plain {plain_ms * 1e3:.3f}, torch call "
            f"{'n/a' if lib_ms is None else f'{lib_ms * 1e3:.3f}'}{cold}"
            f"{floor}; "
            f"host-clock us per call: kernel {call_ms * 1e3:.2f}, plain "
            f"{plain_call_ms * 1e3:.2f}, torch call "
            f"{'n/a' if lib_call_ms is None else f'{lib_call_ms * 1e3:.2f}'} "
            f"[{card}]")
        rows.append(row)
    return rows


def fa_bound(q, k, v, kw) -> tuple[float, float]:
    """(bytes ms, operations ms) the card needs at least for one causal
    attention call: q read once, k and v read once for the keys some query
    attends to (the window's and kv_len's cuts applied), the output
    written once, over 3.35 TB/s; 2*2*H*D flops per live (query, key) pair
    over the bf16 tensor-core peak."""
    B, Sq, H, D = q.shape
    n, qs, w = kw["kv_len"], kw["q_start"], kw.get("window")
    lo = lambda p: 0 if w is None else max(0, p - w + 1)     # first key
    live = sum(min(n, p + 1) - lo(p) for p in range(qs, qs + Sq))
    keys = min(n, qs + Sq) - lo(qs)
    esz = q.element_size()
    nbytes = esz * (2 * q.numel() + B * keys * k.shape[2]
                    * (k.shape[3] + v.shape[3]))
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            4 * B * H * D * live / BF16_FLOP_PER_S * 1e3)


def wkv6_bound(B, T, H, N, esz) -> tuple[float, float]:
    """(bytes ms, operations ms) for one WKV-6 call with an initial state:
    r, k, v, w read and o written once, u read once, the f32 state read
    and written once; per head and step 5 N^2 f32 flops (o: a product and
    a sum per state element; the state: two products and a sum) and 5 N
    (the bonus and its product with v), over the f32 CUDA-core peak."""
    nbytes = esz * (5 * B * T * H * N + H * N) + 2 * 4 * B * H * N * N
    flops = B * H * T * (5 * N * N + 5 * N)
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3


def rglru_bound(B, T, D, esz) -> tuple[float, float]:
    """(bytes ms, operations ms) for one RG-LRU call with h0: log_a (f32)
    and gx read once, h written once in gx's dtype, h0 read and hT written
    once (f32); 10 f32 operations per element (two exps, a sqrt, the
    clip's two, 2 la, 1 - e, and the step's two products and sum) over the
    f32 CUDA-core peak."""
    nbytes = (4 + 2 * esz) * B * T * D + 2 * 4 * B * D
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            10 * B * T * D / F32_FLOP_PER_S * 1e3)


def traced_copies(by_name, op) -> tuple[float, int]:
    """(device us, launches) of the arena ``op`` kernel in a trace."""
    hits = [v for k, v in by_name.items() if ARENA_KERNELS[op] in k]
    return sum(v[0] for v in hits), sum(v[1] for v in hits)


def time_served_packing(plan, spans, by_name, card, dev):
    """The u8 arena write/read at the served cache leaves' offsets and
    sizes: their launches and device us in the decode token's trace, the
    kernels' names held in a trace of their own, and replayed, warm (as
    the decode loop finds L2) and cold (L2 flushed before each launch),
    against their bound, their plain versions and one torch copy.  Returns
    {op: numbers} for the JSON."""
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.arena import ref as R

    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    arena = torch.randint(0, 256, (plan["resident_extent"],),
                          dtype=torch.uint8, device=dev, generator=gen)
    xs = [torch.randint(0, 256, (n,), dtype=torch.uint8, device=dev,
                        generator=gen) for _, n in spans]
    impls = {
        "write": ([(arena, x, o) for x, (o, _) in zip(xs, spans)],
                  K.arena_write_cuda, R.arena_write_torch,
                  lambda a, x, o: a[o:o + x.shape[0]].copy_(x)),
        "read": ([(arena, o, n) for o, n in spans],
                 K.arena_read_cuda, R.arena_read_torch,
                 lambda a, o, n: a[o:o + n].clone()),
    }
    flush = L2Flush(dev)
    out = {}
    for name, (args, kern, plain, lib) in impls.items():
        # the name is held over a trace of some 64 launches over the
        # leaves, of which it may lack no more than one pass (the most
        # complete of up to TRACE_TRIES traces)
        t_us, t_n = traced_copies(by_name, name)
        passes = max(2, -(-64 // len(spans)))
        lo, hi, n_traced = (passes - 1) * len(spans), passes * len(spans), 0
        for _ in range(TRACE_TRIES):
            n_traced = max(n_traced, traced_copies(device_profile(
                lambda: [kern(*a) for _ in range(passes) for a in args])[2],
                name)[1])
            if n_traced >= lo:
                break
        check(lo <= n_traced <= hi,
              f"{name}: {n_traced} launches of arena_{name}_kernel in the "
              f"most complete trace of {passes} x {len(spans)}")
        # one device activity a call: each time from a trace that holds
        # all of them (a trace that lost some read below the DRAM bound)
        ms, plain_ms, lib_ms = (time_replay(args, f, complete=True)[0]
                                for f in (kern, plain, lib))
        cold, cold_plain, cold_lib, cold_again = (
            time_cold(args, f, flush) for f in (kern, plain, lib, kern))
        mean_n = sum(n for _, n in spans) / len(spans)
        bound_ms = 2 * mean_n / HBM_BYTES_PER_S * 1e3
        share = "not measured" if cold is None else f"{bound_ms / cold:.3f}"
        say(f"timing: serve u8 arena {name} at the served leaves "
            f"{spans}: in the decode token's trace {t_n} of its "
            f"{len(spans)} launches, {t_us:.1f} us in all; {n_traced} in a "
            f"trace of {passes} passes; replayed, device us per launch: bound "
            f"{bound_ms * 1e3:.2f} (bytes, {2 * mean_n:.0f} B); warm: kernel "
            f"{fmt_us(ms)}, plain {fmt_us(plain_ms)}, torch call "
            f"{fmt_us(lib_ms)}; cold (L2 flushed before each launch): "
            f"kernel {fmt_us(cold)} (again {fmt_us(cold_again)}), plain "
            f"{fmt_us(cold_plain)}, torch call {fmt_us(cold_lib)}; the cold "
            f"kernel reaches {share} of the bound [{card}]")
        out[name] = dict(traced_launches=t_n, traced_us=t_us,
                         ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms,
                         cold_ms=cold, cold_plain_ms=cold_plain,
                         cold_library_ms=cold_lib, cold_ms_again=cold_again,
                         bound_ms=bound_ms)
    return out


def phase_serve_timing(ctx, card, dev):
    """Prefill ms per request, ms per decode token (host clock), the
    device's busy time and idle share over one prefill and one decode
    token, and the u8 arena write/read at the served leaves, for one
    served model."""
    from repro_torch.launch import serve as S
    from repro_torch.launch.steps import make_prefill_step

    model, params, plan, reqs = (ctx[k] for k in ("model", "params", "plan",
                                                  "reqs"))
    smax, prompt = ctx["smax"], reqs[0].prompt
    prefill = make_prefill_step(model)
    batch = {"tokens": torch.as_tensor(prompt, dtype=torch.long,
                                       device=dev)[None]}
    ms = []
    for _ in range(4):
        cache = model.init_cache(1, smax, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill(params, cache, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    prefill_ms = statistics.median(ms[1:])
    # the card's share of one prefill: busy time, and its largest kernels
    cache = model.init_cache(1, smax, dev)
    pre_us, _, pre_by = device_profile(lambda: prefill(params, cache, batch))
    pre_top = sorted(pre_by.items(), key=lambda kv: -kv[1][0])[:4]
    del cache

    # decode through the server: one request in flight, one token a tick
    pool = S.make_pool(4 * plan["arena_bytes"])
    server = S.DecodeServer(model, params, pool, smax=smax)
    server.submit(S.Request(rid=0, prompt=prompt, max_new=GEN))
    server.step()                  # admit + prefill + the first decode
    ms = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        server.step()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    tok_ms = statistics.median(ms)
    # a trace can lack a few of a token's kernels, never hold more: the
    # most complete of TOKEN_TRACES traces stands for the token
    n_cache, traces = plan["n_cache"], []
    for _ in range(TOKEN_TRACES):
        reset_all()
        traces.append(device_profile(server.step))
        per_tok = {k: v for k, v in all_launches().items() if v}
        check(per_tok.get("write") == per_tok.get("read") == n_cache,
              f"{model.cfg.name}: {per_tok} arena copies in a decode "
              f"token, {n_cache} leaves")
    busy_us, n_dev, by_name = max(traces, key=lambda t: t[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    name = model.cfg.name
    say(f"timing: serve {name}: prefill {prefill_ms:.2f} ms per request of "
        f"{len(prompt)} tokens (median of 3, host clock); decode "
        f"{tok_ms:.3f} ms per token (median of 8 ticks, min {min(ms):.3f}, "
        f"one request in flight, host clock); device busy {busy_us:.1f} us "
        f"per token, idle share {1 - busy_us / (tok_ms * 1e3):.4f}; {n_dev} "
        f"device activities per token (the most of "
        f"{[t[1] for t in traces]}), of them the port's kernels "
        f"{per_tok} [{card}]")
    say(f"timing: serve {name} decode token, device us by kernel (count): "
        + "; ".join(f"{k[:60]} {t:.1f} ({n})" for k, (t, n) in top))
    say(f"timing: serve {name} prefill: device busy {pre_us:.1f} us of "
        f"{prefill_ms * 1e3:.1f} (idle share "
        f"{1 - pre_us / (prefill_ms * 1e3):.4f}); device us by kernel "
        f"(count): " + "; ".join(f"{k[:60]} {t:.1f} ({n})"
                                  for k, (t, n) in pre_top) + f" [{card}]")
    check(n_dev <= ACTIVITIES[name],
          f"{name}: {n_dev} device activities per decode token, more than "
          f"the limit of {ACTIVITIES[name]}")
    check(server._captured.call is not None
          and server._captured.call.replays >= 8 + TOKEN_TRACES,
          f"{name}: the server's decode ticks did not replay its captured "
          f"step")

    # the same token eager, as the server on the CPU makes it (and the card
    # before its capture): unpack into fresh tensors, the eager step, the
    # argmax, the pack, on a copy of the request's arena
    req = server.active[0]
    arena = req.arena.clone()
    defs = server._cache_defs()

    def eager_token():
        cache = S.unpack_decode_state(plan, arena, defs)
        tok = torch.full((1, 1), req.last_tok, dtype=torch.long, device=dev)
        logits, cache = server._decode(params, cache, tok, req.t)
        int(torch.argmax(logits, -1)[0])
        S.pack_decode_state(plan, cache, arena=arena)

    eager_token()
    ems = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager_token()
        torch.cuda.synchronize()
        ems.append((time.perf_counter() - t0) * 1e3)
    e_busy, e_dev, _ = max((device_profile(eager_token)
                            for _ in range(TOKEN_TRACES)),
                           key=lambda t: t[1])
    e_ms = statistics.median(ems)
    say(f"timing: serve {name}: decode eager {e_ms:.3f} ms per token "
        f"(median of 8, min {min(ems):.3f}, host clock) against captured "
        f"{tok_ms:.3f} (min {min(ms):.3f}); device busy eager "
        f"{e_busy:.1f} us (idle share {1 - e_busy / (e_ms * 1e3):.4f}, "
        f"{e_dev} activities), captured {busy_us:.1f} us (idle share "
        f"{1 - busy_us / (tok_ms * 1e3):.4f}, {n_dev} activities) "
        f"[{card}]")
    out = time_served_packing(plan, ctx["spans"], by_name, card, dev)
    out["decode"] = dict(
        captured_ms=tok_ms, captured_min_ms=min(ms), captured_busy_us=busy_us,
        captured_activities=n_dev, eager_ms=e_ms, eager_min_ms=min(ems),
        eager_busy_us=e_busy, eager_activities=e_dev, prefill_ms=prefill_ms,
        prefill_busy_us=pre_us)
    return out


def flash_impls():
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention

    def sdpa(q, k, v, kw):
        n, mask = kw["kv_len"], kw.get("mask")    # the window as a mask
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k[:, :n].transpose(1, 2),
            v[:, :n].transpose(1, 2), attn_mask=mask,
            is_causal=mask is None and q.shape[1] > 1,
            enable_gqa=True).transpose(1, 2)

    def args(kw):
        return {k: kw[k] for k in ("q_start", "kv_len", "window") if k in kw}

    def cuda(fn):
        return lambda q, k, v, kw: fn(q, k, v, causal=True,
                                      **{"window": None, **args(kw)})

    return {
        # the kernel the route rule picks, and PR 12's kernel beside it
        "kernel": cuda(FK.flash_attention_cuda),
        "simple": cuda(FK.flash_simple_cuda),
        "plain": lambda q, k, v, kw: flash_attention(q, k, v, impl="torch",
                                                     **args(kw)),
        "sdpa": sdpa,
    }


def window_mask(Sq, q_start, kv_len, window, dev):
    """SDPA's boolean mask (True attends) for causal attention with a
    window: key j is live for the query at p when p - window < j <= p."""
    p = q_start + torch.arange(Sq, device=dev)[:, None]
    j = torch.arange(kv_len, device=dev)[None]
    return (j <= p) & (j > p - window)


def time_flash(name, shapes, mix, card, dev):
    """The routed flash kernel, the simple kernel, the plain version and
    SDPA at ``shapes`` (label -> (q, k, v, kw)) and over the launch ``mix``;
    returns {label or "mix": times (ms), bound and route}."""
    from repro_torch.kernels.flash_attention import kernel as FK
    impls = flash_impls()
    out = {}
    for label, args in shapes.items():
        t = {i: time_replay([args], fn) for i, fn in impls.items()}
        b_ms, o_ms = fa_bound(*args)
        e = float((impls["kernel"](*args).float()
                   - impls["sdpa"](*args).float()).abs().max())
        q, k, v = args[0], args[1], args[2]
        route = FK.pick_route(q.shape[1], q.shape[2] // k.shape[2], q.dtype,
                              q.shape[3], v.shape[3])
        kw = {x: y for x, y in args[3].items() if x != "mask"}
        out[label] = dict(
            route=route, ms=t["kernel"][0], simple_ms=t["simple"][0],
            plain_ms=t["plain"][0], library_ms=t["sdpa"][0],
            bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations")
        if route == "decode":
            # the launch a captured decode step makes: the position on the
            # device, the capacity split rule; beside it the host-position
            # launch again, in turns
            pos = torch.full((), kw["q_start"], dtype=torch.long, device=dev)
            dp = [time_replay([args], fn)[0] for fn in (
                lambda q, k, v, a: FK.flash_decode_cuda(
                    q, k, v, causal=True, window=a.get("window"),
                    q_start=pos)[0],
                impls["kernel"])]
            S = FK.capacity_splits(1, k.shape[2], q.shape[1], q.shape[2],
                                   v.shape[3], Skv=k.shape[1], causal=True,
                                   window=kw.get("window"))
            out[label].update(device_position_ms=dp[0],
                              device_position_splits=S[0], ms_again=dp[1])
            say(f"timing: flash_attention {name} {label} at a device "
                f"position (the capacity rule, {S[0]} splits of {S[1]} "
                f"tiles): device us per launch {dp[0] * 1e3:.2f}, the "
                f"host-position launch {t['kernel'][0] * 1e3:.2f} (again "
                f"{dp[1] * 1e3:.2f}) [{card}]")
        say(f"timing: flash_attention {name} {label} (B 1, Sq {q.shape[1]}, "
            f"Skv {k.shape[1]}, H {q.shape[2]}, KV {k.shape[2]}, D "
            f"{q.shape[3]}, bf16, {kw}): device us per launch: kernel "
            f"({route}) {t['kernel'][0] * 1e3:.2f}, bound "
            f"{max(b_ms, o_ms) * 1e3:.3f} "
            f"({'bytes' if b_ms >= o_ms else 'operations'}), simple kernel "
            f"{t['simple'][0] * 1e3:.2f}, plain {t['plain'][0] * 1e3:.2f}, "
            f"sdpa {t['sdpa'][0] * 1e3:.2f}; host-clock us per call: kernel "
            f"{t['kernel'][1] * 1e3:.2f}, simple {t['simple'][1] * 1e3:.2f}, "
            f"plain {t['plain'][1] * 1e3:.2f}, sdpa {t['sdpa'][1] * 1e3:.2f}; "
            f"kernel vs sdpa max abs err {e:.3e} [{card}]")
    t = {i: time_replay(mix, fn, reps=3)[0] for i, fn in impls.items()}
    bounds = [fa_bound(*a) for a in mix]
    bound_ms = sum(max(b) for b in bounds) / len(mix)
    by = "bytes" if sum(b for b, _ in bounds) >= sum(o for _, o in bounds) \
        else "operations"
    out["mix"] = dict(route="decode + prefill", ms=t["kernel"],
                      simple_ms=t["simple"], plain_ms=t["plain"],
                      library_ms=t["sdpa"], bound_ms=bound_ms, bound_by=by)
    say(f"timing: flash_attention {name} over the serving run's launch mix "
        f"({len(mix)} shapes): device us per launch: kernel (routed) "
        f"{t['kernel'] * 1e3:.2f}, bound {bound_ms * 1e3:.3f} ({by}), simple "
        f"kernel {t['simple'] * 1e3:.2f}, plain {t['plain'] * 1e3:.2f}, sdpa "
        f"{t['sdpa'] * 1e3:.2f} [{card}]")
    return out


def flash_shapes(cfg, prompt, smax, dev, window=None):
    """The served attention's prefill and last decode shape, and the
    serving run's launch mix (one prefill, one decode at each t)."""
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).bfloat16()

    def kw(Sq, q_start, kv_len):
        out = dict(q_start=q_start, kv_len=kv_len)
        if window is not None:
            out.update(window=window,
                       mask=window_mask(Sq, q_start, kv_len, window, dev))
        return out

    dec = (rnd(1, 1, H, D), rnd(1, smax, KV, D), rnd(1, smax, KV, D))
    pre = (rnd(1, prompt, H, D), rnd(1, prompt, KV, D), rnd(1, prompt, KV, D))
    shapes = {"decode": (*dec, kw(1, smax - 1, smax)),
              "prefill": (*pre, kw(prompt, 0, prompt))}
    mix = [shapes["prefill"]] + [(*dec, kw(1, t, t + 1))
                                 for t in range(prompt, prompt + GEN - 1)]
    return shapes, mix


FLASH_SOURCES = {"decode": "src/repro_torch/csrc/flash_decode.cu",
                 "prefill": "src/repro_torch/csrc/flash_prefill_sm90.cu",
                 "simple": "src/repro_torch/csrc/flash_attention.cu"}
FLASH_LAUNCHES = {"decode": "flash_decode", "prefill": "flash_prefill",
                  "simple": "flash_attention"}


def flash_row(ctx, err, card, dev):
    """llama3.2-1b's attention: the flash row of the kernels JSON.  Its
    times are the serving run's launch mix through the routed kernels;
    ``routes`` gives each kernel's times at its served shape, its source
    and its launches over the serving run; ``models`` gives each served
    attention model's decode, prefill and mix times and launches by
    route (``simple_ms``: the simple kernel at the same shape)."""
    cfg = ctx["model"].cfg
    shapes, mix = flash_shapes(cfg, len(ctx["reqs"][0].prompt), ctx["smax"],
                               dev)
    # each shape of the mix stands for N_REQ * n_layers launches
    res = time_flash(cfg.name, shapes, mix, card, dev)
    launches = {r: ctx["launches"][k] for r, k in FLASH_LAUNCHES.items()}
    routes = {}
    for label in ("decode", "prefill"):
        r = res[label]["route"]
        routes[r] = dict(res[label], source=FLASH_SOURCES[r],
                         launches=launches[r])
    mix_t = res["mix"]
    return dict(
        name="flash_attention", route="cuda",
        source=FLASH_SOURCES["decode"],
        replaces=REPLACES["flash_attention"],
        launches=sum(launches.values()),
        max_abs_err=err["flash_attention"], ms=mix_t["ms"],
        plain_ms=mix_t["plain_ms"], bound_ms=mix_t["bound_ms"],
        bound_by=mix_t["bound_by"], library_ms=mix_t["library_ms"],
        simple_ms=mix_t["simple_ms"], routes=routes,
        models={cfg.name: dict(res, launches=launches)})


def recurrence_row(name, fn, plain, bound, shapes, launches, err, card):
    """A recurrence kernel at the served decode and prefill shapes
    (``shapes``: label -> args of ``fn``), against its plain version and
    its bound (``bound``: args -> (bytes ms, operations ms)); the row's
    times are the serving run's mix, one prefill to GEN - 1 decodes."""
    t, b = {}, {}
    for label, args in shapes.items():
        reps = 20 if label == "decode" else 10
        t[label] = (time_replay([args], fn, reps=reps, one_launch=True)[0],
                    time_replay([args], plain, reps=reps)[0])
        b[label] = bound(*args)
        by = "bytes" if b[label][0] >= b[label][1] else "operations"
        shape = ", ".join(f"{tuple(a.shape)} {str(a.dtype).split('.')[1]}"
                          for a in args if isinstance(a, torch.Tensor))
        say(f"timing: {name} {label} ({shape}): device us per launch: "
            f"kernel {t[label][0] * 1e3:.2f}, bound {max(b[label]) * 1e3:.3f} "
            f"({by}; bytes {b[label][0] * 1e3:.3f}, operations "
            f"{b[label][1] * 1e3:.3f}), plain {t[label][1] * 1e3:.2f}, "
            f"torch call none [{card}]")
    mix = lambda x: (x["prefill"] + (GEN - 1) * x["decode"]) / GEN
    bytes_ms = mix({k: v[0] for k, v in b.items()})
    ops_ms = mix({k: v[1] for k, v in b.items()})
    row = dict(
        name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
        replaces=REPLACES[name], launches=launches[name],
        max_abs_err=err[name], ms=mix({k: v[0] for k, v in t.items()}),
        plain_ms=mix({k: v[1] for k, v in t.items()}),
        bound_ms=mix({k: max(v) for k, v in b.items()}),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=None)
    say(f"timing: {name} over the serving run's mix (1 prefill : {GEN - 1} "
        f"decodes): device us per launch: kernel {row['ms'] * 1e3:.2f}, "
        f"bound {row['bound_ms'] * 1e3:.3f} ({row['bound_by']}), plain "
        f"{row['plain_ms'] * 1e3:.2f} [{card}]")
    return row


def wkv6_row(ctx, err, card, dev):
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6.ref import wkv6_ref

    cfg = ctx["model"].cfg
    H, N = cfg.d_model // cfg.head_dim, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)

    def args(T):
        r, k, v = (torch.randn(1, T, H, N, device=dev, generator=gen)
                   .bfloat16() for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(1, T, H, N, device=dev,
                                             generator=gen))).bfloat16()
        u = (0.5 * torch.randn(H, N, device=dev, generator=gen)).bfloat16()
        s0 = torch.randn(1, H, N, N, device=dev, generator=gen)
        return r, k, v, w, u, s0

    shapes = {"decode": args(1), "prefill": args(len(ctx["reqs"][0].prompt))}
    return recurrence_row(
        "wkv6", lambda r, k, v, w, u, s0: WK.wkv6_cuda(
            r, k, v, w, u, initial_state=s0, state_out=s0),
        lambda r, k, v, w, u, s0: wkv6_ref(r, k, v, w, u, s0, s0),
        lambda r, k, v, w, u, s0: wkv6_bound(*r.shape, r.element_size()),
        shapes, ctx["launches"], err, card)


def rglru_row(ctx, err, card, dev):
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rglru.ref import rglru_ref

    cfg = ctx["model"].cfg
    W = cfg.lru_width or cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)

    def args(T):
        la = -0.5 * torch.exp(torch.randn(1, T, W, device=dev,
                                          generator=gen))
        gx = torch.randn(1, T, W, device=dev, generator=gen).bfloat16()
        return la, gx, torch.randn(1, W, device=dev, generator=gen)

    shapes = {"decode": args(1), "prefill": args(len(ctx["reqs"][0].prompt))}
    row = recurrence_row(
        "rglru", lambda la, gx, h0: RK.rglru_cuda(la, gx, h0, state_out=h0),
        lambda la, gx, h0: rglru_ref(la, gx, h0, h0),
        lambda la, gx, h0: rglru_bound(*gx.shape, gx.element_size()),
        shapes, ctx["launches"], err, card)
    # each kernel at the prefill shape in the same run: the staged kernel
    # (the route), the step kernel (one thread a channel), the
    # staged kernel again
    fns = {"staged": RK.rglru_staged_cuda, "step": RK.rglru_step_cuda}
    t = [(r, time_replay([shapes["prefill"]],
                         lambda la, gx, h0, f=fns[r]: f(la, gx, h0,
                                                        state_out=h0),
                         reps=10, one_launch=True)[0])
         for r in ("staged", "step", "staged")]
    row["routes"] = {
        "step": dict(source="src/repro_torch/csrc/rglru.cu "
                            "(rglru_step_kernel)",
                     launches=ctx["routes"]["step"], prefill_ms=t[1][1]),
        "staged": dict(source="src/repro_torch/csrc/rglru.cu "
                              "(rglru_staged_kernel)",
                       launches=ctx["routes"]["staged"],
                       prefill_ms=t[0][1], prefill_ms_again=t[2][1])}
    say(f"timing: rglru prefill {tuple(shapes['prefill'][1].shape)} bf16, "
        f"each kernel: device us per launch staged {t[0][1] * 1e3:.2f} "
        f"(again {t[2][1] * 1e3:.2f}), step {t[1][1] * 1e3:.2f}; launches "
        f"over the serving run {ctx['routes']} [{card}]")
    return row


def mqa_flash_timing(ctx, card, dev):
    """recurrentgemma-2b's attention (H 10, KV 1, D 256, window 2048): the
    routed kernel, the simple kernel, its plain version and SDPA with the
    window as a mask."""
    cfg = ctx["model"].cfg
    shapes, mix = flash_shapes(cfg, len(ctx["reqs"][0].prompt), ctx["smax"],
                               dev, window=cfg.local_window)
    return time_flash(cfg.name, shapes, mix, card, dev)


# ---------------------------------------------------------------------------
# Phase 9: training
# ---------------------------------------------------------------------------

# the backward kernel against its plain version: llama3.2-1b's heads (H 32,
# KV 8, D 64) at the CLI's batch 8 x seq 256, and two ragged sequences
# (B, S); f32 within BWD_RTOL32 of each gradient's largest magnitude (sums
# in another order), bf16 within BWD_ULPS16 bf16 ulps of it (both round one
# f32 sum to bf16)
BWD_CASES = ((8, 256), (2, 200), (2, 17))
BWD_RTOL32, BWD_ULPS16 = 1e-4, 4
# the train step through the kernels against the same step through the
# plain versions (impl="torch"), full width, bf16: the loss within the bf16
# logit atol of llama3.2-1b's serving check, grad_norm within the same
# relative
TRAIN_ATOL = SERVES["llama3.2-1b"]["logit_atol"]
# and its gradient, leaf by leaf, each stacked leaf layer by layer: the
# worst relative L2 error ||g - g_plain|| / ||g_plain|| within
# TRAIN_GRAD_RTOL, set from readings on an H100 (worst of three seeds
# 2.03e-2, at an attention projection); a deliberately broken backward (one
# KV head's dK zeroed in one layer), which read 0.32-0.38, must read above
# it
TRAIN_GRAD_RTOL = 3e-2
# the CLI's run: TRAIN_STEPS steps at its defaults (batch 8, seq 256, AdamW,
# bf16), a checkpoint at TRAIN_CKPT_EVERY; the replay resumes there
TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_BATCH, TRAIN_SEQ = 7, 4, 8, 256
TIMED_STEPS = 5
# the memory a full-width llama3.2-1b step holds, reckoned from shapes:
# bf16 params and grads, f32 AdamW moments, f32 logits, their log-softmax
# and gradient
TRAIN_MEM_BYTES = 20e9


def bwd_tol(want, dtype) -> float:
    scale = float(want.float().abs().max())
    if dtype == torch.float32:
        return BWD_RTOL32 * scale
    return BWD_ULPS16 * 2.0 ** (math.floor(math.log2(max(scale, 1e-30)))
                                - 7)


def bwd_bound(q, k, v) -> tuple[float, float]:
    """(bytes ms, operations ms) for one causal backward in its training
    form: q, k, v, o and dO read once, dq, dk and dv written once; five
    products (the scores recomputed, dP, dV, dK, dQ) of 2 D flops per live
    (query, key) pair and head, over the bf16 tensor-core peak."""
    B, S, H, D = q.shape
    nbytes = q.element_size() * (4 * q.numel() + 2 * k.numel()
                                 + 2 * v.numel())
    live = S * (S + 1) // 2
    return (nbytes / HBM_BYTES_PER_S * 1e3,
            5 * 2 * B * H * D * live / BF16_FLOP_PER_S * 1e3)


def attn_inputs(dev, B, S, dtype, seed, H=32, KV=8, D=64):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(*s, device=dev, generator=gen).to(dtype)
            for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                      (B, S, H, D))]


def check_flash_backward(dev) -> dict:
    """The forward kernel's output and the backward kernel against their
    plain versions on the same inputs, every case of BWD_CASES in bf16 and
    f32: o (the routed kernel: the ``wgmma`` prefill in bf16, the simple
    kernel in f32) against ``_flash_torch`` and ``attention_ref`` at the
    flash tolerance (``fa_err``), then dq, dk and dv given that o against
    ``flash_attention_backward_torch``; then ``FlashAttentionFn`` (what
    ``flash_attention`` takes under autograd on the card) against autograd
    of the plain forward at (2, 200) in f32 (the simple kernel) and at the
    train step's (8, 256) in bf16 (the prefill route).  bf16 runs both
    backward kernels (the tensor-core one, bf16's route, and the CUDA-core
    one) and holds them against each other and the tensor-core kernel's
    second run bit-equal to its first (no atomics); f32 runs the CUDA-core
    kernel, its route.  Returns the worst errors."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention,
        flash_attention_backward_torch,
    )
    worst = {"max_abs_err": 0.0, "bf16_ulps": 0.0, "f32_rel": 0.0,
             "forward": 0.0, "function_bf16_ulps": 0.0,
             "function_f32_rel": 0.0, "sm90_bf16_ulps": 0.0,
             "simple_bf16_ulps": 0.0, "sm90_vs_simple_bf16_ulps": 0.0}
    for B, S in BWD_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, do = attn_inputs(dev, B, S, dtype, SEED + S)
            o = FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                        q_start=0, kv_len=S)
            for impl in ("torch", "ref"):
                e, ok = fa_err(o, flash_attention(q, k, v, causal=True,
                                                  impl=impl))
                check(ok, f"flash forward (B {B}, S {S}, {dtype}, route "
                          f"{FK.pick_route(S, 4, dtype, 64, 64)}) vs {impl}: "
                          f"max abs err {e}")
                worst["forward"] = max(worst["forward"], e)
            want = flash_attention_backward_torch(q, k, v, o, do)
            route = FK.pick_backward_route(dtype, 64, 64)
            kernels = {route: FK.flash_backward_cuda}
            if dtype == torch.bfloat16:
                kernels["simple"] = FK.flash_backward_simple_cuda
            got = {}
            for kname, fn in kernels.items():
                got[kname] = fn(q, k, v, o, do)
                torch.cuda.synchronize()
                for name, g, w in zip(("dq", "dk", "dv"), got[kname], want):
                    check(g.dtype == w.dtype and g.shape == w.shape,
                          f"flash_backward {name}: {g.dtype} "
                          f"{tuple(g.shape)}")
                    e = float((g.float() - w.float()).abs().max())
                    tol = bwd_tol(w, dtype)
                    check(e <= tol, f"flash_backward ({kname} kernel) "
                                    f"{name} (B {B}, S {S}, {dtype}): max "
                                    f"abs err {e} > {tol}")
                    worst["max_abs_err"] = max(worst["max_abs_err"], e)
                    key = "f32_rel" if dtype == torch.float32 \
                        else "bf16_ulps"
                    r = e / tol * (BWD_RTOL32 if dtype == torch.float32
                                   else BWD_ULPS16)
                    worst[key] = max(worst[key], r)
                    if dtype == torch.bfloat16:
                        worst[f"{kname}_bf16_ulps"] = max(
                            worst[f"{kname}_bf16_ulps"], r)
            if dtype == torch.bfloat16:
                again = FK.flash_backward_sm90_cuda(q, k, v, o, do)
                torch.cuda.synchronize()
                for name, a, b, c in zip(("dq", "dk", "dv"), got["sm90"],
                                         again, got["simple"]):
                    check(torch.equal(a, b), f"flash_backward (sm90 kernel) "
                                             f"{name} (B {B}, S {S}): two "
                                             f"runs differ")
                    e = float((a.float() - c.float()).abs().max())
                    worst["sm90_vs_simple_bf16_ulps"] = max(
                        worst["sm90_vs_simple_bf16_ulps"],
                        e / bwd_tol(c, dtype) * BWD_ULPS16)
    for (B, S), dtype in (((2, 200), torch.float32),
                          ((TRAIN_BATCH, TRAIN_SEQ), torch.bfloat16)):
        q, k, v, do = attn_inputs(dev, B, S, dtype, SEED + 1)
        for t in (q, k, v):
            t.requires_grad_(True)
        o = flash_attention(q, k, v, causal=True)
        check(o.grad_fn is not None and "FlashAttentionFn" in
              type(o.grad_fn).__name__,
              f"flash_attention under autograd on the card: grad_fn "
              f"{o.grad_fn}")
        got = torch.autograd.grad(o, (q, k, v), do)
        ref = flash_attention(q, k, v, causal=True, impl="torch")
        want = torch.autograd.grad(ref, (q, k, v), do)
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            e = float((g.float() - w.float()).abs().max())
            tol = bwd_tol(w, dtype)
            key = "function_" + ("f32_rel" if dtype == torch.float32
                                 else "bf16_ulps")
            worst[key] = max(worst[key], e / tol * (
                BWD_RTOL32 if dtype == torch.float32 else BWD_ULPS16))
            check(e <= tol, f"FlashAttentionFn {name} (B {B}, S {S}, "
                            f"{dtype}) vs autograd of the plain forward: "
                            f"max abs err {e} > {tol}")
    say(f"train: the forward kernel's o vs _flash_torch and attention_ref "
        f"and flash_backward vs flash_attention_backward_torch, (B, S) in "
        f"{BWD_CASES}, H 32, KV 8, D 64, bf16 and f32: o max abs err "
        f"{worst['forward']:.3e} (flash tolerance); gradients max abs err "
        f"{worst['max_abs_err']:.3e}, f32 (CUDA-core kernel) "
        f"{worst['f32_rel']:.3e} of the largest gradient (tol {BWD_RTOL32}), "
        f"bf16 {worst['bf16_ulps']:.2f} ulps of it (tol {BWD_ULPS16}): the "
        f"tensor-core kernel {worst['sm90_bf16_ulps']:.2f}, the CUDA-core "
        f"kernel {worst['simple_bf16_ulps']:.2f}, the two against each other "
        f"{worst['sm90_vs_simple_bf16_ulps']:.2f}; the tensor-core kernel's "
        f"two runs bit-equal; FlashAttentionFn vs autograd of "
        f"the plain forward: f32 (2, 200) {worst['function_f32_rel']:.3e} of "
        f"the largest gradient, bf16 ({TRAIN_BATCH}, {TRAIN_SEQ}) "
        f"{worst['function_bf16_ulps']:.2f} ulps of it")
    return worst


def leaf_paths(tree, prefix="") -> list[str]:
    """The leaves' paths in ``tree_flatten``'s order (sorted dict keys)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def loss_grads(model, params, batch, impl) -> tuple:
    """(loss, the gradient of every leaf) by ``model.loss_fn`` under
    autograd, as ``make_train_step`` takes them, before its clip."""
    from repro_torch.models.params import tree_leaves
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss, _ = model.loss_fn(params, batch, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


def worst_grad_err(got, want, paths, n_layers) -> tuple[float, str]:
    """The worst relative L2 error ||g - w|| / ||w|| over the leaves, a
    stacked leaf (first dim ``n_layers``) layer by layer, and where."""
    worst, where = 0.0, ""
    for path, g, w in zip(paths, got, want):
        stacked = w.dim() >= 2 and w.shape[0] == n_layers
        for i, (gs, ws) in enumerate(zip(g, w) if stacked else [(g, w)]):
            d = float(torch.linalg.vector_norm((gs - ws).float()))
            e = d / max(float(torch.linalg.vector_norm(ws.float())), 1e-30)
            if e > worst:
                worst, where = e, path + (f"[{i}]" if stacked else "")
    return worst, where


def grad_compare(model, params, batch) -> dict:
    """The full-width loss's gradient through the kernels (impl="auto")
    against the plain versions' (impl="torch"), leaf by leaf and layer by
    layer (``worst_grad_err``) within TRAIN_GRAD_RTOL; then the same
    reading of a deliberately broken backward, the backward kernel's dK of
    KV head 0 zeroed in its first launch (the last layer), which must
    read above TRAIN_GRAD_RTOL: the check can see a wrong attention
    gradient in one head of one layer.  Launches here are outside the
    counted runs."""
    from repro_torch.kernels.flash_attention import kernel as FK
    paths = leaf_paths(params)
    L = model.cfg.n_layers
    _, want = loss_grads(model, params, batch, "torch")
    _, got = loss_grads(model, params, batch, "auto")
    sound, sound_at = worst_grad_err(got, want, paths, L)
    del got
    kernel, broke = FK.flash_backward_cuda, []

    def broken(*a, **kw):
        dq, dk, dv = kernel(*a, **kw)
        if not broke:
            dk[:, :, 0] = 0
            broke.append(1)
        return dq, dk, dv

    FK.flash_backward_cuda = broken
    try:
        _, bad = loss_grads(model, params, batch, "auto")
    finally:
        FK.flash_backward_cuda = kernel
    broken_err, broken_at = worst_grad_err(bad, want, paths, L)
    del bad, want
    say(f"train: full-width gradient through the kernels vs the plain "
        f"versions, {len(paths)} leaves (stacked ones by layer): worst "
        f"relative L2 error {sound:.3e} at {sound_at} (limit "
        f"{TRAIN_GRAD_RTOL}); with one KV head's dK zeroed in the last "
        f"layer's backward it reads {broken_err:.3e} at {broken_at}")
    check(sound <= TRAIN_GRAD_RTOL,
          f"the full-width gradient through the kernels is {sound} (at "
          f"{sound_at}) from the plain versions', above {TRAIN_GRAD_RTOL}")
    check(broken_err > TRAIN_GRAD_RTOL,
          f"a broken attention backward reads {broken_err} (at "
          f"{broken_at}), within {TRAIN_GRAD_RTOL}: the gradient check "
          f"cannot see it")
    return dict(grad_rel_err=sound, grad_rel_err_at=sound_at,
                broken_grad_rel_err=broken_err,
                broken_grad_rel_err_at=broken_at)


def train_step_compare(dev, card):
    """One full-width llama3.2-1b train step through the kernels
    (impl="auto") against the same step through the plain versions
    (impl="torch"), from the same params, optimizer state and batch; the
    kernels' step's launches.  Returns (model, opt, state after the
    kernels' step, batch, record)."""
    import repro_torch.configs as configs
    from repro_torch.data import DataPipeline
    from repro_torch.launch.steps import make_optimizer, make_train_step
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.models.zoo import build_model

    cfg = configs.get("llama3.2-1b")
    model = build_model(cfg)
    opt = make_optimizer(cfg, lr=3e-4)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED), dev)
    plain_params = tree_map(lambda t: t.clone(), params)
    pipe = DataPipeline(cfg=cfg, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                        seed=SEED)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    kw = dict(peak_lr=3e-4, warmup=10, total_steps=TRAIN_STEPS)
    grads = grad_compare(model, params, batch)
    torch.cuda.empty_cache()
    state = {"params": params, "opt": opt.init(params)}
    reset_all()
    state, m_k = make_train_step(model, opt, impl="auto", **kw)(state, batch)
    torch.cuda.synchronize()
    launches = {k: v for k, v in all_launches().items() if v}
    want = {"flash_prefill": cfg.n_layers, "flash_backward": cfg.n_layers}
    check(launches == want, f"one train step launched {launches}, the "
                            f"train path needs {want}")
    routes = backward_routes()
    want = {"sm90": cfg.n_layers, "simple": 0}
    check(routes == want, f"one bf16 train step's backward launches by "
                          f"kernel {routes}, the route gives {want}")
    plain = {"params": plain_params, "opt": opt.init(plain_params)}
    _, m_p = make_train_step(model, opt, impl="torch", **kw)(plain, batch)
    torch.cuda.synchronize()
    del plain, plain_params
    got = {k: float(m_k[k]) for k in ("loss", "grad_norm", "lr")}
    ref = {k: float(m_p[k]) for k in ("loss", "grad_norm", "lr")}
    check(all(np.isfinite(list(got.values()))), f"train step metrics {got}")
    check(abs(got["loss"] - ref["loss"]) <= TRAIN_ATOL
          and abs(got["grad_norm"] - ref["grad_norm"])
          <= TRAIN_ATOL * ref["grad_norm"],
          f"train step through the kernels {got} vs the plain versions "
          f"{ref} (loss atol {TRAIN_ATOL}, grad_norm rtol {TRAIN_ATOL})")
    n = sum(t.numel() for t in tree_leaves(state["params"]))
    say(f"train: llama3.2-1b at full width ({n} parameters, bf16), batch "
        f"{TRAIN_BATCH} x seq {TRAIN_SEQ}: one step through the kernels "
        f"{got} vs through the plain versions {ref} (loss atol {TRAIN_ATOL}, "
        f"grad_norm rtol {TRAIN_ATOL}); its launches {launches}, the "
        f"backward's by kernel {routes} [{card}]")
    rec = dict(loss=got["loss"], loss_plain=ref["loss"],
               grad_norm=got["grad_norm"], grad_norm_plain=ref["grad_norm"],
               step_launches=launches, step_backward_routes=routes, **grads)
    return model, opt, state, batch, rec


TRAIN_PARTS = ("forward", "backward", "clip", "optimizer")


def step_parts(model, opt, state, batch) -> dict:
    """One train step in its parts: the loss (forward), its gradient
    (backward), the clip and the optimizer's update, each in a
    ``record_function`` range (for a trace) and timed twice: on the
    device by CUDA events between the parts, and on the host from the
    part's first op to its last op queued (no wait in between).  Returns
    {part: (device ms, host issue ms)}.  The parts are
    ``make_train_step``'s body, called one by one so that events can sit
    between them."""
    from torch.profiler import record_function

    from repro_torch.models.params import tree_flatten, tree_unflatten
    from repro_torch.optim.schedule import cosine_warmup
    params = state["params"]
    leaves, treedef = tree_flatten(params)
    ev, host = [torch.cuda.Event(enable_timing=True)], [time.perf_counter()]

    def mark():
        host.append(time.perf_counter())
        ev.append(torch.cuda.Event(enable_timing=True))
        ev[-1].record()

    ev[0].record()
    with torch.enable_grad():
        with record_function("forward"):
            loss, _ = model.loss_fn(params, batch)
        mark()
        with record_function("backward"):
            grads = torch.autograd.grad(loss, leaves)
        mark()
    with record_function("clip"):
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
        scale = torch.clamp(1.0 / torch.clamp(gnorm, min=1e-9), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))
        lr = cosine_warmup(state["opt"]["step"], peak_lr=3e-4, warmup=10,
                           total=TRAIN_STEPS)
    mark()
    with record_function("optimizer"):
        opt.update(tree_unflatten(treedef, list(grads)), state["opt"],
                   params, lr_scale=lr / opt.lr)
    mark()
    torch.cuda.synchronize()
    return {n: (ev[i].elapsed_time(ev[i + 1]),
                (host[i + 1] - host[i]) * 1e3)
            for i, n in enumerate(TRAIN_PARTS)}


def time_train_step(model, opt, state, batch, card) -> dict:
    """ms per step (host clock, each step ending in ``synchronize``) over
    TIMED_STEPS steps after the first, tokens/s, the model FLOPs' share of
    the bf16 peak (6 N per token), the device's busy time and idle share
    over one traced step with its flash kernels' time, the step's parts
    (``step_parts``), and the peak memory allocated."""
    from repro_torch.launch.steps import make_train_step
    step = make_train_step(model, opt, impl="auto", peak_lr=3e-4, warmup=10,
                           total_steps=TRAIN_STEPS)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    busy, n_act, by_name = device_profile(lambda: step(state, batch))
    parts = step_parts(model, opt, state, batch)
    med = statistics.median(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = model.cfg.param_count()
    share = 6 * n * tokens / (med / 1e3) / BF16_FLOP_PER_S
    kern = lambda key: sum(t for name, (t, _) in by_name.items()
                           if key in name)
    out = dict(ms_median=med, ms_min=min(ms), ms=ms,
               tokens_per_s=tokens / (med / 1e3), model_flops_share=share,
               busy_us=busy, idle_share=max(0.0, 1 - busy / (med * 1e3)),
               activities=n_act, peak_allocated=peak, parts_device_host_ms=parts,
               flash_prefill_us=kern("flash_prefill_kernel"),
               flash_backward_us=kern("bwd_"),
               gemm_us=kern("gemm") + kern("nvjet") + kern("cutlass"))
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    say(f"train: llama3.2-1b step (B {TRAIN_BATCH}, S {TRAIN_SEQ}, bf16, "
        f"AdamW): {med:.2f} ms median, {min(ms):.2f} min of {TIMED_STEPS} "
        f"(host clock, each ending in synchronize); {out['tokens_per_s']:.0f} "
        f"tokens/s; model FLOPs (6 x {n} x {tokens}) {share:.4f} of "
        f"989 TFLOP/s; one traced step: device busy {busy:.1f} us, idle "
        f"share {out['idle_share']:.4f}, {n_act} activities, flash prefill "
        f"{out['flash_prefill_us']:.1f} us, flash backward "
        f"{out['flash_backward_us']:.1f} us, products (gemm / nvjet / "
        f"cutlass kernels) {out['gemm_us']:.1f} us; parts by CUDA events "
        f"(host issue) "
        + ", ".join(f"{k} {d:.2f} ms ({h:.2f})" for k, (d, h)
                    in parts.items())
        + f"; peak allocated {peak} B (reckoned ~{TRAIN_MEM_BYTES:.0f}); "
        f"largest kernels "
        + ", ".join(f"{k[:60]} {t:.1f} us x {c}" for k, (t, c) in top)
        + f" [{card}]")
    return out


def cli_run_and_replay(dev, card) -> dict:
    """``launch/train.py``'s ``main`` in this process: TRAIN_STEPS steps of
    full-width llama3.2-1b at the CLI's defaults with a checkpoint every
    TRAIN_CKPT_EVERY steps, the launch counts set to 0 just before and
    read just after (the train path's own); then a second run in another
    directory that holds only the step-TRAIN_CKPT_EVERY checkpoint, which
    resumes there and replays to TRAIN_STEPS.  Both under
    ``torch.use_deterministic_algorithms(True)``: torch's backward of the
    embedding lookup and of the loss's gather add with atomics otherwise
    (cuBLAS then needs ``CUBLAS_WORKSPACE_CONFIG``; ``:4096:8`` is the 32
    MiB PyTorch gives a Hopper card anyway).  The replay's parameters and
    optimizer state must equal the straight run's bit for bit."""
    import os
    import shutil

    import repro_torch.configs as configs
    from repro_torch.launch import train
    from repro_torch.models.params import tree_leaves

    cfg = configs.get("llama3.2-1b")
    root = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", "llama3.2-1b", "--steps", str(TRAIN_STEPS),
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--log-every", "1",
            "--seed", str(SEED)]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        reset_all()
        t0 = time.perf_counter()
        straight = train.main(argv + ["--ckpt-dir", str(root / "a")])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: v for k, v in all_launches().items() if v}
        routes = backward_routes()
        want = {"flash_prefill": cfg.n_layers * TRAIN_STEPS,
                "flash_backward": cfg.n_layers * TRAIN_STEPS}
        check(launches == want, f"the CLI's {TRAIN_STEPS} steps launched "
                                f"{launches}, the train path needs {want}")
        want = {"sm90": cfg.n_layers * TRAIN_STEPS, "simple": 0}
        check(routes == want, f"the CLI's {TRAIN_STEPS} steps' backward "
                              f"launches by kernel {routes}, the bf16 route "
                              f"gives {want}")
        losses = straight["losses"]
        check(straight["end_step"] == TRAIN_STEPS
              and len(losses) == TRAIN_STEPS
              and all(np.isfinite(losses)),
              f"the CLI ended at {straight['end_step']}, losses {losses}")
        (root / "b").mkdir(parents=True)
        ck = f"step_{TRAIN_CKPT_EVERY:010d}"
        os.rename(root / "a" / ck, root / "b" / ck)
        shutil.rmtree(root / "a")
        t0 = time.perf_counter()
        replay = train.main(argv + ["--ckpt-dir", str(root / "b")])
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    check(replay["start"] == TRAIN_CKPT_EVERY
          and replay["losses"] == losses[TRAIN_CKPT_EVERY:],
          f"the replay resumed at {replay['start']} with losses "
          f"{replay['losses']}, the straight run's {losses}")
    a, b = tree_leaves(straight["state"]), tree_leaves(replay["state"])
    check(len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                   for x, y in zip(a, b)),
          "the replay from the checkpoint is not bit-equal to the straight "
          "run")
    say(f"train: python -m repro_torch.launch.train {' '.join(argv)} (in "
        f"process, deterministic algorithms): losses {losses}, launches "
        f"{launches} ({cfg.n_layers} of each a step; the backward's by "
        f"kernel {routes}), {run_s:.1f} s with "
        f"checkpoints; the replay from step {TRAIN_CKPT_EVERY} "
        f"({replay_s:.1f} s) ends bit-equal in all {len(a)} leaves of "
        f"params and optimizer state [{card}]")
    return dict(losses=losses, launches=launches, backward_routes=routes,
                run_s=run_s, replay_s=replay_s)


def check_recurrent_training_raises(dev):
    """rwkv6-7b's and Griffin's loss under autograd on the card raise
    (their recurrence kernels have no backward yet), rather than drop the
    gradient; smoke widths, which reach the same first kernel."""
    import repro_torch.configs as configs
    from repro_torch.models.params import tree_leaves
    from repro_torch.models.zoo import build_model
    for arch in ("rwkv6-7b", "recurrentgemma-2b"):
        model = build_model(configs.smoke(arch))
        params = model.init(torch.Generator(device=dev).manual_seed(SEED),
                            dev)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        tokens = torch.zeros((1, 16), dtype=torch.long, device=dev)
        try:
            model.loss_fn(params, {"tokens": tokens})
        except NotImplementedError as e:
            check("backward" in str(e), f"{arch}: {e}")
            say(f"train: {arch} loss_fn under autograd on the card raises: "
                f"{e}")
            continue
        check(False, f"{arch}: loss_fn under autograd on the card ran "
                     f"without its backward kernel")


def backward_turn(fn, per_call: int, calls: int = 10) -> float:
    """Device ms per call of a backward wrapper that launches ``per_call``
    kernels (named ``bwd_*``): a trace of ``calls`` calls after two
    warm-up calls.  A trace that lost some of the launches (the profiler
    drops events at random) reads low, so it is taken again, up to
    TRACE_TRIES times; failing that, the most complete trace's mean per
    launch times ``per_call``, and a line says so."""
    fn(), fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for _ in range(TRACE_TRIES):
        prof = device_profile(lambda: [fn() for _ in range(calls)],
                              required=False)
        if prof is None:
            continue
        got = [(t, c) for name, (t, c) in prof[2].items() if "bwd_" in name]
        n, us = sum(c for _, c in got), sum(t for t, _ in got)
        if n == calls * per_call:
            return us / calls / 1e3
        best = max(best, (n, us))
    check(best[0] > 0, "no trace held a backward kernel")
    say(f"timing: no trace held all {calls * per_call} backward launches; "
        f"the best held {best[0]}, whose mean per launch is used")
    return best[1] / best[0] * per_call / 1e3


def time_train_flash(dev, card) -> dict:
    """The flash forward (routed: the ``wgmma`` prefill) and backward
    kernels at the train step's shape (B 8, S 256, H 32, KV 8, D 64, bf16)
    against their bounds, their plain versions and SDPA's forward and
    backward (``is_causal=True, enable_gqa=True``; a yardstick, never
    called by the port).  The backward's two kernels are timed in turns
    (``backward_turn``: traces that hold every launch), the CUDA-core one,
    the tensor-core one (bf16's route), the tensor-core one, the CUDA-core
    one: ``kernel`` is the mean of the tensor-core kernel's two times,
    ``simple`` of the other's."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import (
        _flash_torch,
        flash_attention_backward_torch,
    )
    q, k, v, do = attn_inputs(dev, TRAIN_BATCH, TRAIN_SEQ, torch.bfloat16,
                              SEED + 3)
    S = TRAIN_SEQ
    o = FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                q_start=0, kv_len=S)
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    so = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                        enable_gqa=True)
    dos = do.transpose(1, 2)
    fwd = {
        "kernel": lambda: FK.flash_attention_cuda(
            q, k, v, causal=True, window=None, q_start=0, kv_len=S),
        "plain": lambda: _flash_torch(q, k, v, causal=True, window=None,
                                      q_start=0, kv_len=None,
                                      softmax_scale=None, kv_chunk=1024),
        "sdpa": lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True),
    }
    bwd = {
        "simple": lambda: FK.flash_backward_simple_cuda(q, k, v, o, do),
        "kernel": lambda: FK.flash_backward_cuda(q, k, v, o, do),
        "plain": lambda: flash_attention_backward_torch(q, k, v, o, do),
        "sdpa": lambda: torch.autograd.grad(so, (qs, ks, vs), dos,
                                            retain_graph=True),
    }
    out = {}
    with torch.no_grad():
        t_f = {i: time_replay([()], fn, reps=10)[0] for i, fn in fwd.items()}
    turns = {"simple": [], "kernel": []}
    for i in ("simple", "kernel", "kernel", "simple"):
        turns[i].append(backward_turn(bwd[i], 3 if i == "simple" else 2))
    t_b = {i: statistics.mean(t) for i, t in turns.items()}
    t_b.update({i: time_replay([()], bwd[i], reps=10)[0]
                for i in ("plain", "sdpa")})
    for name, t, bound in (("forward", t_f, fa_bound(q, k, v, dict(
            q_start=0, kv_len=S))), ("backward", t_b, bwd_bound(q, k, v))):
        by = "bytes" if bound[0] >= bound[1] else "operations"
        out[name] = dict(ms=t["kernel"], plain_ms=t["plain"],
                         library_ms=t["sdpa"], bound_ms=max(bound),
                         bound_by=by)
        extra = ""
        if name == "backward":
            out[name].update(simple_ms=t["simple"], turns_ms=turns)
            extra = (f" (the tensor-core kernel; in turns "
                     f"{turns['kernel'][0] * 1e3:.2f}, "
                     f"{turns['kernel'][1] * 1e3:.2f}), the CUDA-core kernel "
                     f"{t['simple'] * 1e3:.2f} (in turns "
                     f"{turns['simple'][0] * 1e3:.2f}, "
                     f"{turns['simple'][1] * 1e3:.2f})")
        say(f"timing: flash {name} at the train step's shape (B "
            f"{TRAIN_BATCH}, S {S}, H 32, KV 8, D 64, bf16, causal): device "
            f"us per launch: kernel {t['kernel'] * 1e3:.2f}{extra}, bound "
            f"{max(bound) * 1e3:.3f} ({by}; bytes {bound[0] * 1e3:.3f}, "
            f"operations {bound[1] * 1e3:.3f}), plain {t['plain'] * 1e3:.2f},"
            f" sdpa {t['sdpa'] * 1e3:.2f} [{card}]")
    return out


def phase_train(dev, card, err) -> tuple[dict, dict]:
    """The train path: the backward kernel against its plain version, one
    full-width step through the kernels against the plain versions, the
    step's time and memory, the CLI's run with a checkpoint and its
    bit-equal replay, the recurrent families raising, and the flash
    kernels' times at the step's shape.  Returns (the flash_backward row
    of the kernels JSON, the phase's record)."""
    t0 = time.perf_counter()
    worst = check_flash_backward(dev)
    err["flash_backward"] = worst["max_abs_err"]
    model, opt, state, batch, rec = train_step_compare(dev, card)
    rec["step"] = time_train_step(model, opt, state, batch, card)
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["cli"] = cli_run_and_replay(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    check_recurrent_training_raises(dev)
    flash = time_train_flash(dev, card)
    rec["flash"] = flash
    b = flash["backward"]
    routes = rec["cli"]["backward_routes"]
    row = dict(
        name="flash_backward", route="cuda",
        source="src/repro_torch/csrc/flash_backward_sm90.cu",
        replaces="src/repro/kernels/flash_attention/ops.py:77",
        replaces_note="no TPU kernel: jax.grad of _flash_xla",
        launches=rec["cli"]["launches"]["flash_backward"],
        max_abs_err=err["flash_backward"], ms=b["ms"],
        plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
        bound_by=b["bound_by"], library_ms=b["library_ms"],
        simple_ms=b["simple_ms"],
        routes={"sm90": dict(
                    source="src/repro_torch/csrc/flash_backward_sm90.cu",
                    launches=routes["sm90"], ms=b["ms"],
                    turns_ms=b["turns_ms"]["kernel"]),
                "simple": dict(
                    source="src/repro_torch/csrc/flash_backward.cu",
                    launches=routes["simple"], ms=b["simple_ms"],
                    turns_ms=b["turns_ms"]["simple"])},
        errors=worst, forward_at_train_shape=flash["forward"])
    rec["seconds"] = time.perf_counter() - t0
    say(f"train: phase done in {rec['seconds']:.1f} s [{card}]")
    return row, rec


def main() -> int:
    t_start = time.perf_counter()
    csrc = SRC / "repro_torch" / "csrc"
    if not all((csrc / f).is_file() for f in (
            "arena.cu", "flash_attention.cu", "flash_decode.cu",
            "flash_prefill_sm90.cu", "flash_backward.cu",
            "flash_backward_sm90.cu", "wkv6.cu", "rglru.cu")):
        say("FAIL: src/repro_torch not found beside chip_smoke.py; run it "
            "from the root of a checkout")
        return 2
    sys.path.insert(0, str(SRC))
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this check needs a "
            "CUDA card")
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.kernels import _build
    from repro_torch.kernels.arena import kernel as K
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rwkv6 import kernel as WK

    def timed_build(fn):
        t0 = time.perf_counter()
        return fn(), time.perf_counter() - t0

    # one nvcc per source, all started together
    jobs = [K.build, WK.build, RK.build] + [
        (lambda n=n: FK.build(n)) for n in FK.SOURCES]
    with ThreadPoolExecutor(len(jobs)) as ex:
        builds = [ex.submit(timed_build, fn) for fn in jobs]
        for fut in builds:
            lib, sec = fut.result()
            say(f"build: {lib.relative_to(ROOT)} in {sec:.1f} s")
            if lib.stem in ("libarena", "libwkv6", "librglru",
                            "libflash_decode", "libflash_prefill_sm90",
                            "libflash_backward", "libflash_backward_sm90"):
                for ln in _build.ptxas_report(lib):
                    say(f"build: ptxas {lib.stem[3:]}: {ln}")
    for mod in (K, WK, RK):
        mod._library()
    for n in FK.SOURCES:
        FK._library(n)
    say(f"card: {card}")

    rng = np.random.default_rng(SEED)
    err = {k: 0.0 for k in REPLACES}
    phase_kernels(dev, rng, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    flash_err = phase_flash(dev, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    phase_wkv6(dev, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    phase_rglru(dev, err)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    plans, inputs, launches, _, captured = phase_main(rng)
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    bridge = phase_bridge(dev, card)
    say("bridge: " + json.dumps(bridge) + f" [{card}]")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    rows, decode, batched = [], {}, {}
    for arch in SERVES:            # one model on the card at a time
        ctx = phase_serve(dev, arch)
        if arch == "llama3.2-1b":
            rows += phase_timing(plans, inputs, launches, err, card,
                                 captured)
        served = phase_serve_timing(ctx, card, dev)
        decode[arch] = served["decode"]
        batched[arch] = phase_serve_vmap(ctx, card, dev)
        for r in rows:
            if r["name"] in ("arena_write", "arena_read"):
                r.setdefault("served", {})[arch] = served[r["name"][6:]]
        if arch == "llama3.2-1b":
            flash = flash_row(ctx, err, card, dev)
            flash["max_abs_err_by_route"] = flash_err
            rows.append(flash)
        elif arch == "rwkv6-7b":
            rows.append(wkv6_row(ctx, err, card, dev))
        else:
            rows.append(rglru_row(ctx, err, card, dev))
            flash["models"][arch] = dict(
                mqa_flash_timing(ctx, card, dev),
                launches={r: ctx["launches"][k]
                          for r, k in FLASH_LAUNCHES.items()})
        del ctx
        torch.cuda.empty_cache()
        say(f"elapsed: {time.perf_counter() - t_start:.1f} s")
    say("timing: decode per token, captured and eager: "
        + json.dumps(decode) + f" [{card}]")
    say("timing: vmap decode, per model: " + json.dumps(batched)
        + f" [{card}]")
    # each kernel of the batched path: launches per tick and us per launch
    # at bucket 4, in the tick's trace
    row_of = {"write": "arena_write", "read": "arena_read",
              "flash_decode": "flash_attention", "wkv6": "wkv6",
              "rglru": "rglru"}
    for r in rows:
        for arch, b in batched.items():
            for k, name in row_of.items():
                if r["name"] == name and k in b["tick"]["launches"]:
                    us, n = b["tick"]["kernel_us"].get(k, (None, 0))
                    r.setdefault("batched", {})[arch] = dict(
                        bucket=N_REQ,
                        launches_per_tick=b["tick"]["launches"][k],
                        us_per_launch=us, traced_launches=n)

    # the bridge's arena launches per call, by case
    for r in rows:
        if r["name"] in ("arena_write", "arena_read"):
            r["bridge"] = {case: rec["launches_per_call"][r["name"][6:]]
                           for case, rec in bridge.items()}

    # the train path, the serving models' weights freed
    train_row, train_rec = phase_train(dev, card, err)
    rows.append(train_row)
    say("timing: train: " + json.dumps(train_rec) + f" [{card}]")
    say(f"elapsed: {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    # a failure goes to both streams: a caller that keeps only one of them
    # still reads why the check failed
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        print(f"FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
    except Exception:
        import traceback
        print(f"FAIL: {traceback.format_exc()}", flush=True)
        raise
