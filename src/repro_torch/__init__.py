"""repro_torch: the SERENITY planner and its arena executor on PyTorch.

The PyTorch/CUDA port of the JAX package ``repro``: the same planner
(``repro_torch.core``, integer-for-integer the same plans), the paper's
networks (``repro_torch.graphs``) and an executor that runs a plan in one
arena tensor on the card through hand-written CUDA kernels
(``repro_torch.kernels.arena``).  It imports torch and numpy, never JAX.
"""

from repro_torch.core import *  # noqa: F401,F403
from repro_torch.core import __all__ as _core_all

__all__ = list(_core_all)
