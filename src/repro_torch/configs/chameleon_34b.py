"""chameleon-34b — 48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536
early-fusion VLM; images arrive as VQ tokens in the shared vocab, so the
modality frontend (VQ-VAE encoder) is a stub that precomputes token ids
[arXiv:2405.09818].  Chameleon uses qk-norm for stability."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65_536,
    mlp_kind="swiglu",
    qk_norm=True,
    frontend="vq_image",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="chameleon-34b-smoke", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=512,
    )
