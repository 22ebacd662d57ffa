#!/usr/bin/env python3
"""Host cost of the kernels' eager calls, for a checkout, on one NVIDIA GPU.

    python3 tools/host_call_probe.py [--root DIR]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
its flash-attention, WKV-6 and RG-LRU kernels, and times on the host's
clock (each run of calls ending in ``synchronize``) the microseconds an
eager call of each wrapper takes at the main path's decode shapes --
llama3.2-1b's split-K decode (1 token over a 1056-key cache), rwkv6-7b's
WKV-6 step, recurrentgemma-2b's RG-LRU step -- and llama's prefill of 1024
tokens, each the median of 7 runs of 200 calls (20 for the prefill); then
llama3.2-1b's eager decode step at full width (ms a token, median of 20).
At these shapes the card finishes a decode call sooner than the host
issues the next, so the time per call is the host's.  Prints one JSON
line.  To compare two checkouts, run them in turns in one call (``git
archive <commit> | tar -x -C build/parent``; ``for r in build/parent . .
build/parent; do python3 tools/host_call_probe.py --root $r; done``).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def _per_call_us(fn, n: int) -> float:
    import torch
    runs = []
    for _ in range(8):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / n * 1e6)
    return statistics.median(runs[1:])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("FAIL: this probe needs a CUDA card", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.rglru import kernel as RK
    from repro_torch.kernels.rwkv6 import kernel as WK
    assert Path(repro_torch.__file__).resolve().is_relative_to(root)

    for build in (WK.build, RK.build, lambda: FK.build("flash_decode"),
                  lambda: FK.build("flash_prefill_sm90")):
        build()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def rnd(*shape, dtype=bf):
        return torch.randn(*shape, device=dev, generator=g).to(dtype)

    out = {"root": str(root)}
    q, k, v = rnd(1, 1, 32, 64), rnd(1, 1056, 8, 64), rnd(1, 1056, 8, 64)
    out["flash_decode_us"] = _per_call_us(lambda: FK.flash_attention_cuda(
        q, k, v, causal=True, window=None, q_start=1055, kv_len=1056), 200)
    pos = torch.tensor(1055, device=dev)
    out["flash_decode_device_pos_us"] = _per_call_us(
        lambda: FK.flash_attention_cuda(q, k, v, causal=True, window=None,
                                        q_start=pos, kv_len=None), 200)
    qp, kp = rnd(1, 1024, 32, 64), rnd(1, 1024, 8, 64)
    out["flash_prefill_us"] = _per_call_us(lambda: FK.flash_attention_cuda(
        qp, kp, kp, causal=True, window=None, q_start=0, kv_len=1024), 20)
    r, u = rnd(1, 1, 64, 64), rnd(64, 64)
    w = -torch.ones_like(r)
    s0 = rnd(1, 64, 64, 64, dtype=torch.float32)
    out["wkv6_us"] = _per_call_us(lambda: WK.wkv6_cuda(
        r, r, r, w, u, initial_state=s0, state_out=s0), 200)
    la = -rnd(1, 1, 2560, dtype=torch.float32).abs()
    gx, h0 = rnd(1, 1, 2560), rnd(1, 2560, dtype=torch.float32)
    out["rglru_us"] = _per_call_us(lambda: RK.rglru_cuda(la, gx, h0,
                                                         state_out=h0), 200)

    import repro_torch.configs as configs
    from repro_torch.launch.steps import make_decode_step
    from repro_torch.models.zoo import build_model
    model = build_model(configs.get("llama3.2-1b"))
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    cache = model.init_cache(1, 1056, dev)
    tok = torch.ones((1, 1), dtype=torch.long, device=dev)
    step = make_decode_step(model, impl="auto")
    ms = []
    with torch.no_grad():
        for i in range(24):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(params, cache, tok, 1000 + i)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
    out["llama_eager_ms_per_token"] = statistics.median(ms[4:])
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
