"""Build the port's CUDA sources into shared libraries with a plain C
interface, one library per source file.

``build(source, name)`` compiles ``csrc/<file>.cu`` with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into
``build/repro_torch/<hash of source and flags>/lib<name>.so`` at the root
of the checkout and returns its path; a library of the same source and
flags is reused, across processes too.  The compiler's report
(``-Xptxas -v``: registers, shared memory and spills of each kernel) is
kept beside it in ``lib<name>.log``; :func:`ptxas_report` reads it.  The
kernel modules load the library with ``ctypes``.  Nothing is built when a
module is imported, and a missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`: there is no fallback.  Builds of different sources may run at the same
time (``chip_smoke.py`` starts them together); each publishes its library
with an atomic rename.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def raise_on(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch)."""
    if err:
        raise KernelLaunchError(f"{what}: launch failed with CUDA error "
                                f"{err}")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise KernelBuildError("nvcc not found (on PATH or under "
                             "$CUDA_HOME); the CUDA kernels cannot be built")


def build(source: Path, name: str) -> Path:
    """Compile ``source`` into ``lib<name>.so`` unless a library of this
    source and these flags exists; returns the library's path."""
    src = Path(source).read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_ROOT / tag[:16] / f"lib{name}.so"
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.tmp.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelBuildError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
            f"{res.stdout}{res.stderr}")
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, out)     # atomic publish, safe across processes
    return out


def ptxas_report(library: Path) -> list[str]:
    """The lines of ``library``'s build log that give each kernel's
    registers, shared memory and spills, and ptxas's warnings of a
    performance loss (``wgmma`` serialized); empty when no log was kept."""
    log = Path(library).with_suffix(".log")
    if not log.exists():
        return []
    keep = ("Compiling entry", "Used", "spill", "Performance Loss")
    return [ln.strip() for ln in log.read_text().splitlines()
            if any(k in ln for k in keep)]
