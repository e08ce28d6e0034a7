"""Assigned architecture registry: ``--arch <id>`` resolves here."""
from __future__ import annotations

from importlib import import_module
from typing import Dict

from ..models.common import ArchConfig
from .shapes import SHAPES, ShapeSpec, cell_supported

_MODULES = {
    "codeqwen1.5-7b": "codeqwen15_7b",
    "starcoder2-15b": "starcoder2_15b",
    "minicpm-2b": "minicpm_2b",
    "gemma3-1b": "gemma3_1b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "whisper-medium": "whisper_medium",
    "zamba2-2.7b": "zamba2_2_7b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-2b": "internvl2_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch_id: str, smoke: bool = False) -> ArchConfig:
    mod = import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.smoke_config() if smoke else mod.config()


def all_configs(smoke: bool = False) -> Dict[str, ArchConfig]:
    return {a: get_config(a, smoke) for a in ARCH_IDS}

__all__ = ["ARCH_IDS", "get_config", "all_configs", "SHAPES", "ShapeSpec",
           "cell_supported"]
