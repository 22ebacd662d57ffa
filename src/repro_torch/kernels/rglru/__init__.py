"""RG-LRU recurrence of Griffin: the CUDA kernels and their plain PyTorch
version.

ops.py    -- ``rglru`` dispatch (impl in {auto, cuda, torch, ref}; no
             environment override)
kernel.py -- the CUDA kernels (csrc/rglru.cu: a step kernel for decode,
             a staged kernel for prefill, by ``pick_route``, and the
             backward kernel): build, ctypes binding, checked launches,
             launch counts
ref.py    -- the plain versions: ``rglru_ref``, the sequential
             recurrence with an f32 carry, and ``rglru_backward_torch``,
             its reverse scan (``rglru_backward_chunked_torch``: the
             backward kernel's order)

Used by ``repro_torch.models.blocks.griffin_rec_block_apply`` for every
recurrent layer of the serving and the training path (under autograd on
the card, ``ops.RGLRUFn``).
"""

from repro_torch.kernels.rglru.kernel import LAUNCHES, reset_launches
from repro_torch.kernels.rglru.ops import rglru
from repro_torch.kernels.rglru.ref import rglru_ref

__all__ = ["LAUNCHES", "reset_launches", "rglru", "rglru_ref"]
