"""Config registry: ``get(name)`` -> ArchConfig, ``smoke(name)`` -> reduced,
``cut_depth(cfg, n)`` -> the first ``n`` layers at the same widths.

The port's registry lists only the architectures it can build:

  llama3.2-1b           dense decoder
  gemma-7b              dense decoder, head dim 256, GeGLU, tied embeddings
  starcoder2-7b         dense decoder, GQA 9 heads a KV head, GeLU MLP
  granite-20b           dense decoder, multi-query (48 heads, one KV head)
  chameleon-34b         dense decoder with qk-norm (VQ image tokens share
                        the vocabulary, so it serves as a decoder)
  granite-moe-3b-a800m  MoE decoder: 40 experts, top-8
  rwkv6-7b              RWKV-6, attention-free
  recurrentgemma-2b     Griffin: RG-LRU + local attention
  deepseek-v3-671b      MoE decoder with MLA and the MTP head: 256
                        experts, top-8 (served at published width with
                        its depth cut)
  seamless-m4t-medium   encoder-decoder: 12 + 12 layers, cross-attention
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import (
    SHAPES,
    ArchConfig,
    MLAConfig,
    ShapeConfig,
    ShardingRules,
)

_MODULES = {
    "llama3.2-1b": "llama3_2_1b",
    "gemma-7b": "gemma_7b",
    "starcoder2-7b": "starcoder2_7b",
    "granite-20b": "granite_20b",
    "chameleon-34b": "chameleon_34b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}

ARCH_NAMES = tuple(_MODULES)


def _mod(name: str):
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get(name: str) -> ArchConfig:
    return _mod(name).CONFIG


def smoke(name: str) -> ArchConfig:
    return _mod(name).smoke_config()


def cut_depth(cfg: ArchConfig, n_layers: int | None) -> ArchConfig:
    """``cfg`` with its first ``n_layers`` layers (leading dense layers
    kept up to that depth; an encoder-decoder's encoder cut alike), every
    width as it was; ``cfg`` itself for None."""
    if n_layers is None:
        return cfg
    if not 1 <= n_layers <= cfg.n_layers:
        raise ValueError(f"{cfg.name} has {cfg.n_layers} layers; cannot "
                         f"cut it to {n_layers}")
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        n_dense_layers=min(cfg.n_dense_layers, n_layers),
        encoder_layers=min(cfg.encoder_layers, n_layers))


__all__ = [
    "ARCH_NAMES",
    "ArchConfig",
    "MLAConfig",
    "SHAPES",
    "ShapeConfig",
    "ShardingRules",
    "cut_depth",
    "get",
    "smoke",
]
