"""Serving steps of the port.

  * ``make_prefill_step(model, rules)``  (params, cache, batch) -> (logits, cache)
  * ``make_decode_step(model, rules)``   (params, cache, tokens, t) -> (logits, cache)

Their default is ``impl="auto"``: the CUDA flash-attention kernel for
tensors on the card, the plain PyTorch version for tensors on the CPU
(``repro``'s steps default to its ``"xla"`` version instead).  The training
step and the input specs of the dry-run wait for ROADMAP A7/A10.
"""

from __future__ import annotations

from repro_torch.models.zoo import Model


def make_prefill_step(model: Model, rules=None, *, impl: str = "auto"):
    def prefill_step(params, cache, batch):
        return model.prefill_fn(params, cache, batch, impl=impl, rules=rules)

    return prefill_step


def make_decode_step(model: Model, rules=None, *, impl: str = "auto"):
    def decode_step(params, cache, tokens, t):
        return model.decode_fn(params, cache, tokens, t, impl=impl,
                               rules=rules)

    return decode_step
