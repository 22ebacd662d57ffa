"""Canonical unary-elementwise op tables shared by the executor and the
fused arena-chain kernel (DESIGN.md §11).

``ELEMWISE_FNS`` is the single source of truth for the surrogate numerics of
the in-place-eligible unary ops (the same name set as
``repro_torch.core.rewriter.INPLACE_UNARY_OPS``): the reference interpreter,
the slice-per-node executor and the plain chain write all apply *these exact
torch callables*, so fused execution through the plain version is bit-equal
to the unfused path by construction.  Each callable is the counterpart of the
JAX package's jnp callable of the same name; ``gelu`` is the tanh form,
because ``jax.nn.gelu`` defaults to it.

``ELEMWISE_OP_CODES`` numbers the same ops for the CUDA chain kernel
(``csrc/arena.cu``, ``enum ElemOp``), which applies a chain in registers.
There relu, relu6, bn/batchnorm, bias_add, scale and the identities are
bit-equal to eager torch (no FMA contraction, ``__fmul_rn``/``__fadd_rn``);
sigmoid, tanh, gelu and silu use ``expf``/``tanhf`` and are allclose, the
same contract as the JAX package's one-launch Pallas chain kernel.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F

# Each fn maps an (n,) vector to an (n,) vector element-by-element, so
# aliasing the input buffer is semantics-preserving.
ELEMWISE_FNS: dict[str, Callable] = {
    "relu": torch.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "bn": lambda x: 1.05 * x - 0.02,
    "batchnorm": lambda x: 1.05 * x - 0.02,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "bias_add": lambda x: x + 0.05,
    "scale": lambda x: 0.9 * x,
    "dropout": lambda x: x,          # deterministic (inference) semantics
    "identity": lambda x: x,
    "cast_inplace": lambda x: x,
}

# Op codes of the CUDA chain kernel; must match ``enum ElemOp`` in
# csrc/arena.cu.  The identity-likes share code 0 (the kernel skips them).
ELEMWISE_OP_CODES: dict[str, int] = {
    "dropout": 0,
    "identity": 0,
    "cast_inplace": 0,
    "relu": 1,
    "relu6": 2,
    "bn": 3,
    "batchnorm": 3,
    "sigmoid": 4,
    "tanh": 5,
    "gelu": 6,
    "silu": 7,
    "bias_add": 8,
    "scale": 9,
}

# Ops whose kernel form is bit-equal to the eager torch callable.
EXACT_OPS = frozenset({"relu", "relu6", "bn", "batchnorm", "bias_add",
                       "scale", "dropout", "identity", "cast_inplace"})

# Longest chain the kernel takes by value (``struct ChainOps`` in arena.cu).
MAX_CHAIN = 16


def apply_chain(x, ops: Sequence[str]):
    """Apply a named elementwise chain with the canonical torch callables."""
    for op in ops:
        x = ELEMWISE_FNS[op](x)
    return x


def chain_codes(ops: Sequence[str]) -> list[int]:
    """Kernel op codes of ``ops``; raises on an unknown name or a chain
    longer than :data:`MAX_CHAIN`."""
    if len(ops) > MAX_CHAIN:
        raise ValueError(f"chain of {len(ops)} ops exceeds the kernel's "
                         f"limit of {MAX_CHAIN}")
    return [ELEMWISE_OP_CODES[op] for op in ops]
