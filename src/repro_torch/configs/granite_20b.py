"""granite-20b — 52L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152
llama-style code model [arXiv:2405.04324]."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-20b",
    family="dense",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    mlp_kind="gelu",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="granite-20b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab_size=512,
    )
