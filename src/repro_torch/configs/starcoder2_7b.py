"""starcoder2-7b — 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
GQA + RoPE [arXiv:2402.19173]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49_152,
    mlp_kind="gelu",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="starcoder2-7b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    )
