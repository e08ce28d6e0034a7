"""Assigned input shapes (one set for all LM-family archs) + applicability.

  train_4k     seq 4096   x global_batch 256   (training: train_step)
  prefill_32k  seq 32768  x global_batch 32    (inference prefill)
  decode_32k   seq 32768  x global_batch 128   (one token, 32k KV cache)
  long_500k    seq 524288 x global_batch 1     (long-context decode)

``long_500k`` requires sub-quadratic attention: it runs for SSM / hybrid /
sliding-window archs and is SKIPPED for pure full-attention archs
(DESIGN.md §3.2 — a 500k dense-causal KV step is architecturally
unsupported without a sub-quadratic mechanism).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..models.common import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """(supported, reason-if-not) for an (arch x shape) cell."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.sliding_window is not None)
        if not sub_quadratic:
            return False, ("long_500k skipped: pure full-attention arch "
                           "(no sub-quadratic mechanism)")
    return True, ""
