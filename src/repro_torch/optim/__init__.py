"""Optimizers of the port: the counterparts of ``repro.optim``.

adamw.py          -- AdamW, f32 moments, updated in place
adafactor.py      -- Adafactor, factored second moments, updated in place
schedule.py       -- cosine_warmup on a step tensor, on its device
grad_compress.py  -- int8 quantize / dequantize, error feedback and
                     ``compressed_psum``, the int8 sum over a group
"""

from repro_torch.optim.adafactor import adafactor
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import cosine_warmup

OPTIMIZERS = {"adamw": adamw, "adafactor": adafactor}

__all__ = ["OPTIMIZERS", "adafactor", "adamw", "cosine_warmup"]
