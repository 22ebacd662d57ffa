#!/usr/bin/env python3
"""Measurements behind the design notes of the two flash kernels, on one
CUDA card.  Run from the root of a checkout:

    python3 tools/flash_kernel_probe.py phases      # csrc/flash_decode.cu
    python3 tools/flash_kernel_probe.py precision   # flash_prefill_sm90.cu

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
"""

from __future__ import annotations

import ctypes
import sys
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


def variant(name: str, source: Path, edits) -> ctypes.CDLL:
    """Build ``source`` with each (old, new) of ``edits`` applied once."""
    from repro_torch.kernels import _build
    text = source.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{source.name}: the probe's anchor is gone: "
                             f"{old!r}")
        text = text.replace(old, new, 1)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / f"{name}.cu"
    path.write_text(text)
    return ctypes.CDLL(str(_build.build(path, name)))


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


def main() -> int:
    if len(sys.argv) != 2 or sys.argv[1] not in ("phases", "precision"):
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: this probe needs a CUDA card")
        return 2
    import chip_smoke as CS
    dev = torch.device("cuda", torch.cuda.current_device())
    card = CS.card_line()
    (phases if sys.argv[1] == "phases" else precision)(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
