"""seamless-m4t-medium — enc-dec 12L(+12L) d_model=1024 16H d_ff=4096
vocab=256206 [arXiv:2308.11596]: 12 encoder + 12 decoder layers (the
published medium model's speech-encoder/text-decoder split).  The audio
frontend (fbank + conv subsampler) is a stub: the encoder takes frame
embeddings (B, S_enc, d_model)."""

import dataclasses

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder layers
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256_206,
    mlp_kind="gelu",
    is_encoder_decoder=True,
    frontend="audio_frames",
)


def smoke_config() -> ArchConfig:
    return dataclasses.replace(
        CONFIG, name="seamless-smoke", n_layers=2, encoder_layers=2,
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
        vocab_size=512,
    )
