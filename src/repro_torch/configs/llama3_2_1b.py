"""llama3.2-1b — 16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256
[hf:meta-llama/Llama-3.2-1B], rope theta 500k, tied embeddings."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=128_256,
    mlp_kind="swiglu",
    rope_theta=500_000.0,
    tie_embeddings=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="llama3.2-1b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    )
