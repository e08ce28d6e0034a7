"""Uniform model API: ``build_model(cfg)`` -> object with
``param_specs / logits / init_cache / prefill / decode_step`` (see
transformer.py for the contract) — the counterpart of
``repro.models.api``."""
from __future__ import annotations

from .common import ArchConfig


def build_model(cfg: ArchConfig):
    if cfg.family in ("dense", "moe", "vlm"):
        from .transformer import DecoderLM
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        from .ssm_lm import SSMLM
        return SSMLM(cfg)
    if cfg.family == "hybrid":
        from .hybrid import HybridLM
        return HybridLM(cfg)
    if cfg.family in ("encdec", "audio"):
        from .encdec import EncDecLM
        return EncDecLM(cfg)
    raise ValueError(f"unknown family {cfg.family!r}")
