"""rwkv6-7b (Finch) — 32L d_model=4096, attention-free, d_ff=14336
vocab=65536, data-dependent decay, head size 64 [arXiv:2404.05892]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,            # wkv heads = d_model / head_dim
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65_536,
    mlp_kind="gelu",       # unused: rwkv channel-mix has its own form
    attn_free=True,
    subquadratic=True,
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="rwkv6-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=512,
    )
