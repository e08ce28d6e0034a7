"""Uniform model API: ``build_model(cfg)`` -> object with
``param_specs / logits / init_cache / prefill / decode_step`` (see
transformer.py for the contract) — the counterpart of
``repro.models.api``.  Families this package cannot run yet raise
``NotImplementedError`` naming their ROADMAP item."""
from __future__ import annotations

from .common import ArchConfig
from .transformer import DecoderLM, unported

_LEFT = ("moe", "ssm", "hybrid", "encdec", "audio")


def build_model(cfg: ArchConfig) -> DecoderLM:
    if cfg.family in ("dense", "vlm"):
        return DecoderLM(cfg)
    if cfg.family in _LEFT:
        raise unported(f"the {cfg.family!r} family", "12b")
    raise ValueError(f"unknown family {cfg.family!r}")
