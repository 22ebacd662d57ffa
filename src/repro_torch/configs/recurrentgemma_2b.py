"""recurrentgemma-2b — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000, RG-LRU + local attention (window 2048) in a (rec, rec, attn)
pattern, GeGLU, head_dim=256, lru_width=2560 [arXiv:2402.19427]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    mlp_kind="geglu",
    tie_embeddings=True,
    block_pattern=("rec", "rec", "attn"),
    local_window=2048,
    lru_width=2560,
    subquadratic=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-smoke", n_layers=4, d_model=64,
        n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=512,
        local_window=16, lru_width=64, block_pattern=("rec", "rec", "attn"),
    )
