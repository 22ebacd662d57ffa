"""The train step's global-norm clip and its AdamW and Adafactor
updates: the CUDA kernels and their plain PyTorch versions.

ops.py    -- ``sumsq`` / ``global_norm`` / ``adamw_update`` /
             ``adafactor_update`` dispatch (impl in {auto, cuda, torch,
             ref}; no environment override)
kernel.py -- the CUDA kernels (csrc/adamw.cu: ``sumsq_kernel`` and
             ``adamw_update_kernel``; csrc/adafactor.cu:
             ``adafactor_sums_kernel``, ``adafactor_rms_kernel`` and
             ``adafactor_update_kernel``; one launch each over every leaf):
             build, ctypes binding, the leaf tables, checked launches,
             launch counts
ref.py    -- the plain versions (``sumsq_torch``, ``adamw_update_torch``,
             ``adafactor_update_torch``) and the kernels' order in torch
             (``sumsq_chunked_torch``, ``adamw_update_chunked_torch``,
             ``adafactor_update_chunked_torch``)

Used by ``repro_torch.launch.steps.make_train_step`` (the norm) and
``repro_torch.optim.adamw.update`` / ``repro_torch.optim.adafactor.update``
(the clip's scaling and the update).
"""

from repro_torch.kernels.optim.kernel import LAUNCHES, reset_launches
from repro_torch.kernels.optim.ops import (
    adafactor_update,
    adamw_update,
    global_norm,
    sumsq,
)

__all__ = ["LAUNCHES", "adafactor_update", "adamw_update", "global_norm",
           "reset_launches", "sumsq"]
