"""gemma-7b — 28L d_model=3072 16H (GQA kv=16, i.e. MHA) d_ff=24576
vocab=256000, GeGLU, head_dim=256, tied embeddings [arXiv:2403.08295]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256_000,
    mlp_kind="geglu",
    tie_embeddings=True,
    optimizer="adamw",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="gemma-7b-smoke", n_layers=2, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=512,
    )
