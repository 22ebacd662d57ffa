"""Config registry: ``get(name)`` -> ArchConfig, ``smoke(name)`` -> reduced.

The port's registry lists only the architectures it can build:

  llama3.2-1b        dense decoder
  rwkv6-7b           RWKV-6, attention-free
  recurrentgemma-2b  Griffin: RG-LRU + local attention

The other configs of ``repro.configs`` join with their model families
(ROADMAP A6).
"""

from __future__ import annotations

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
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
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


__all__ = [
    "ARCH_NAMES",
    "ArchConfig",
    "MLAConfig",
    "SHAPES",
    "ShapeConfig",
    "ShardingRules",
    "get",
    "smoke",
]
