"""GQA flash attention: the CUDA kernel and its plain PyTorch versions.

ops.py    -- ``flash_attention`` dispatch (impl in {auto, cuda, torch,
             ref}; no environment override), the chunked online-softmax
             plain version (``impl="torch"``), the split-K decode's
             plain versions (partials per split, and their merge), and
             the training form's gradient: ``FlashAttentionFn``, taken
             under autograd, with the backward kernels on the card, their
             plain version ``flash_attention_backward_torch`` and the
             tensor-core kernel's tiled emulation
             ``flash_backward_tiled_torch``
kernel.py -- the five CUDA kernels (csrc/flash_decode.cu,
             csrc/flash_prefill_sm90.cu, csrc/flash_attention.cu and the
             backward's, csrc/flash_backward_sm90.cu and
             csrc/flash_backward.cu): build, ctypes binding, the route
             rules, checked launches, launch counts
ref.py    -- the O(S²) oracle ``attention_ref``

Used by ``repro_torch.models.layers.attn_apply`` for every prefill and
decode attention of the serving path, and for the attention of the train
step (forward and gradient).
"""

from repro_torch.kernels.flash_attention.kernel import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention.ops import (
    FlashAttentionFn,
    flash_attention,
    flash_attention_backward_torch,
    flash_backward_tiled_torch,
    flash_decode_combine_torch,
    flash_decode_partials_torch,
)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["LAUNCHES", "FlashAttentionFn", "attention_ref",
           "flash_attention", "flash_attention_backward_torch",
           "flash_backward_tiled_torch", "flash_decode_combine_torch",
           "flash_decode_partials_torch", "reset_launches"]
