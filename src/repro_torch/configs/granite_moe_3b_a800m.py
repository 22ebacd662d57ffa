"""granite-moe-3b-a800m — 32L d_model=1536 24H (GQA kv=8) vocab=49155,
MoE 40 experts top-8, expert d_ff=512
[hf:ibm-granite/granite-3.0-*-base family]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    mlp_kind="swiglu",
    n_experts=40,
    n_experts_per_tok=8,
    moe_d_ff=512,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=64, vocab_size=512, n_experts=4,
        n_experts_per_tok=2, moe_d_ff=64, moe_capacity_factor=8.0,
    )
