"""RWKV-6 WKV recurrence: the CUDA kernel and its plain PyTorch version.

ops.py    -- ``wkv6`` dispatch (impl in {auto, cuda, torch, ref}; no
             environment override); ``WKV6Fn`` under autograd on the card
kernel.py -- the CUDA kernels (csrc/wkv6.cu, the forward; csrc/
             wkv6_backward.cu, its gradient): build, ctypes binding,
             checked launches, launch counts
ref.py    -- the plain versions: ``wkv6_ref``, an exact sequential f32
             loop, and ``wkv6_backward_torch``, its reverse scan

Used by ``repro_torch.models.blocks.rwkv6_block_apply`` for every time-mix
of the serving and the training path (under autograd on the card,
``ops.WKV6Fn``).
"""

from repro_torch.kernels.rwkv6.kernel import LAUNCHES, reset_launches
from repro_torch.kernels.rwkv6.ops import wkv6
from repro_torch.kernels.rwkv6.ref import wkv6_ref

__all__ = ["LAUNCHES", "reset_launches", "wkv6", "wkv6_ref"]
