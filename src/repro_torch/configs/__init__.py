"""Architecture registry: the assigned architectures' published configs.

``get_config(name)`` returns the full published configuration;
``get_smoke_config(name)`` a reduced same-family variant for CPU smoke tests.
"""
from __future__ import annotations

from .base import ModelConfig
from . import archs


def get_config(name: str) -> ModelConfig:
    return archs.CONFIGS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return archs.smoke_variant(archs.CONFIGS[name])


__all__ = ["ModelConfig", "get_config", "get_smoke_config"]
