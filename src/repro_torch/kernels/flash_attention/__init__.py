"""GQA flash attention: the CUDA kernel and its plain PyTorch versions.

ops.py    -- ``flash_attention`` dispatch (impl in {auto, cuda, torch,
             ref}; no environment override) and the chunked online-softmax
             plain version (``impl="torch"``)
kernel.py -- the CUDA kernel (csrc/flash_attention.cu): build, ctypes
             binding, checked launches, launch count
ref.py    -- the O(S²) oracle ``attention_ref``

Used by ``repro_torch.models.layers.attn_apply`` for every prefill and
decode attention of the serving path.
"""

from repro_torch.kernels.flash_attention.kernel import LAUNCHES, reset_launches
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["LAUNCHES", "attention_ref", "flash_attention", "reset_launches"]
