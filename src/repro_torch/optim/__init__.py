"""Optimizers of the port: the counterparts of ``repro.optim``.

adamw.py          -- AdamW, f32 moments, updated in place
adafactor.py      -- Adafactor, factored second moments, updated in place
schedule.py       -- cosine_warmup on a step tensor, on its device
grad_compress.py  -- int8 quantize / dequantize and error feedback
                     (``compressed_psum`` waits for ROADMAP A8)
"""

from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import cosine_warmup

OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}

__all__ = ["OPTIMIZERS", "adafactor", "adamw", "cosine_warmup"]
