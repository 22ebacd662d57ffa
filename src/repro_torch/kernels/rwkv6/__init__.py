"""RWKV-6 WKV recurrence: the CUDA kernel and its plain PyTorch version.

ops.py    -- ``wkv6`` dispatch (impl in {auto, cuda, torch, ref}; no
             environment override)
kernel.py -- the CUDA kernel (csrc/wkv6.cu): build, ctypes binding,
             checked launches, launch count
ref.py    -- the plain version ``wkv6_ref``, an exact sequential f32 loop

Used by ``repro_torch.models.blocks.rwkv6_block_apply`` for every time-mix
of the serving path.
"""

from repro_torch.kernels.rwkv6.kernel import LAUNCHES, reset_launches
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref

__all__ = ["LAUNCHES", "reset_launches", "wkv6", "wkv6_ref"]
