#!/usr/bin/env python3
"""The split-K decode of this checkout against another checkout's, on the
card: bit-equality of every call of at most 16 rows (with ``--row-blocks``
also of granite-20b's 48 and 96 rows), and the launch time of both in
turns.

    python3 tools/decode_rows_probe.py --parent DIR [--row-blocks]

``DIR`` is the root of another checkout (e.g. a ``git archive`` of the
parent commit unpacked under ``build/``).  Both ``csrc/flash_decode.cu``
are built (``build/repro_torch/<hash>/``) and each call is launched through
this checkout's wrapper (``kernels/flash_attention/kernel.py:
flash_decode_cuda``) once with each library: outputs and partials (m, l,
acc of every split) must be equal bit for bit.  The calls: bf16 and f32,
every (D, Dv) of ``HEAD_DIMS``, GQA groups 1, 4 and 16 (16 rows, the
largest single row block), decode at host positions (last key, a tail
with garbage beyond ``kv_len``) at the split rule's, 7 and 64 splits, 4
queries of 4 heads with a window, 0-d device positions from 0 to the last
(the capacity rule) and a position per row at bucket 4; with
``--row-blocks`` (the other kernel must take more than 16 rows) the same
calls at KV 1, G 48 and 2 queries of 48 heads at a host position.  Then
both kernels are timed in turns (this, other, other, this; CUDA events
over replays of a graph of 50 launches) at llama3.2-1b's and
recurrentgemma-2b's served decode, and with ``--row-blocks`` at
granite-20b's (one request, and bucket 4 at positions a row apart).
Needs one CUDA card and ``nvcc``; prints one line per group and exits 1
on a difference.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--row-blocks", action="store_true",
                    help="the other kernel takes row blocks: compare and "
                         "time granite-20b's 48 rows too")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: no CUDA card")
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as FK

    dev = torch.device("cuda", torch.cuda.current_device())
    mine = FK._library("flash_decode")
    other_path = _build.build(
        args.parent / "src/repro_torch/csrc/flash_decode.cu",
        "flash_decode_other")
    other = ctypes.CDLL(str(other_path))
    fn = other.repro_flash_decode
    fn.argtypes = [FK._CTYPE.get(a, ctypes.c_longlong)
                   for a in FK._ARGS["flash_decode"]]
    fn.restype = ctypes.c_int
    libs = {"this": mine, "other": other}

    def run(which, *a, **kw):
        FK._libs["flash_decode"] = libs[which]
        try:
            return FK.flash_decode_cuda(*a, **kw)
        finally:
            FK._libs["flash_decode"] = mine

    gen = torch.Generator(device=dev).manual_seed(0)
    n_calls, bad = 0, []

    def same(what, *a, **kw):
        nonlocal n_calls
        x, y = run("this", *a, **kw), run("other", *a, **kw)
        n_calls += 1
        if not all(torch.equal(p, q) for p, q in zip(x, y)):
            bad.append(what)

    def rnd(*shape, dtype):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    for dtype in (torch.bfloat16, torch.float32):
        for D, Dv in FK.HEAD_DIMS:
            groups = ((8, 1), (8, 4), (1, 16)) + \
                (((1, 48),) if args.row_blocks else ())
            for KV, G in groups:
                H, Skv = KV * G, 1056
                q = rnd(1, 1, H, D, dtype=dtype)
                k, v = rnd(1, Skv, KV, D, dtype=dtype), \
                    rnd(1, Skv, KV, Dv, dtype=dtype)
                for qs, kvl in ((Skv - 1, Skv), (499, 500)):
                    for splits in (None, 7, 64):
                        same(f"{dtype} {D}/{Dv} G {G} host {qs}", q, k, v,
                             causal=True, window=None, q_start=qs,
                             kv_len=kvl, splits=splits)
                for t in (0, 31, 32, 500, 1055):
                    same(f"{dtype} {D}/{Dv} G {G} device {t}", q, k, v,
                         causal=True, window=None,
                         q_start=torch.full((), t, dtype=torch.long,
                                            device=dev))
                qb = rnd(4, 1, H, D, dtype=dtype)
                kb, vb = rnd(4, Skv, KV, D, dtype=dtype), \
                    rnd(4, Skv, KV, Dv, dtype=dtype)
                pos = torch.tensor([3, 500, 1023, 1055], device=dev)
                same(f"{dtype} {D}/{Dv} G {G} rows", qb, kb, vb, causal=True,
                     window=None, q_start=pos)
            q4 = rnd(1, 4, 16, D, dtype=dtype)
            k4, v4 = rnd(1, 300, 4, D, dtype=dtype), \
                rnd(1, 300, 4, Dv, dtype=dtype)
            same(f"{dtype} {D}/{Dv} Sq 4 window", q4, k4, v4, causal=True,
                 window=40, q_start=120, kv_len=124)
            same(f"{dtype} {D}/{Dv} Sq 4 window device", q4, k4, v4,
                 causal=True, window=40,
                 q_start=torch.full((), 120, dtype=torch.long, device=dev))
            if args.row_blocks:
                q2 = rnd(1, 2, 48, D, dtype=dtype)
                k2, v2 = rnd(1, 300, 1, D, dtype=dtype), \
                    rnd(1, 300, 1, Dv, dtype=dtype)
                same(f"{dtype} {D}/{Dv} Sq 2 G 48", q2, k2, v2, causal=True,
                     window=None, q_start=114, kv_len=116)
    torch.cuda.synchronize()
    most = 96 if args.row_blocks else 16
    print(f"decode_rows_probe: {n_calls} calls of at most {most} rows, "
          f"outputs "
          f"and partials of this kernel against {args.parent}'s: "
          f"{n_calls - len(bad)} bit-equal" + (f"; differ: {bad}" if bad
                                               else ""), flush=True)

    card = torch.cuda.get_device_name(0)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    shapes = [("llama3.2-1b", 1, 32, 8, 64, 1056, None),
              ("recurrentgemma-2b", 1, 10, 1, 256, 2592, 2048)]
    if args.row_blocks:
        shapes += [("granite-20b", 1, 48, 1, 128, 1056, None),
                   ("granite-20b bucket 4", 4, 48, 1, 128, 1056, None)]
    for name, B, H, KV, D, Skv, w in shapes:
        q = rnd(B, 1, H, D, dtype=torch.bfloat16)
        k, v = (rnd(B, Skv, KV, D, dtype=torch.bfloat16) for _ in range(2))
        pos = torch.full((), Skv - 1, dtype=torch.long, device=dev) \
            if B == 1 else torch.arange(Skv - 1, Skv - 1 - 7 * B, -7,
                                        device=dev)
        graphs = {}
        for which in ("this", "other"):
            # 50 launches in one CUDA graph, so that a replay times the
            # device and not the host's issue
            FK._libs["flash_decode"] = libs[which]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                     q_start=pos)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                for _ in range(50):
                    FK.flash_decode_cuda(q, k, v, causal=True, window=w,
                                         q_start=pos)
            FK._libs["flash_decode"] = mine
            graphs[which] = g
        us = []
        for which in ("this", "other", "other", "this"):
            graphs[which].replay()
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                graphs[which].replay()
            end.record()
            torch.cuda.synchronize()
            us.append(start.elapsed_time(end) / 1000 * 1e3)
        print(f"decode_rows_probe: {name} decode (B {B}, H {H}, KV {KV}, "
              f"D {D}, "
              f"cache {Skv}) at a device position, device us per launch in "
              f"a replayed graph of 50 (CUDA events, 20 replays; this, "
              f"other, other, this): {', '.join(f'{u:.2f}' for u in us)} "
              f"[{card}]", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
