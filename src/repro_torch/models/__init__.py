"""Models of the port: parameter definitions, layers, blocks and the zoo.

params.py  -- ParamDef, init_params, params_from_numpy, stack_defs and the
              jax.tree-ordered tree helpers
layers.py  -- rms_norm, apply_rope, attn_apply (flash attention), mlp_apply,
              embed_apply, logits_apply
blocks.py  -- the dense transformer block
zoo.py     -- build_model / build_decoder_lm (dense decoder LMs)
"""

from repro_torch.models.params import (
    ParamDef,
    init_params,
    leaf_count,
    params_from_numpy,
    stack_defs,
)
from repro_torch.models.zoo import Model, build_decoder_lm, build_model

__all__ = ["Model", "ParamDef", "build_decoder_lm", "build_model",
           "init_params", "leaf_count", "params_from_numpy", "stack_defs"]
