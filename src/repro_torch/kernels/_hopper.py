"""Shared-memory limits of one NVIDIA H100 (sm_90) SM, which the wrappers
size their launch configurations against (``_pass1`` for B1 and B3,
``flash_decode`` for B5)."""
from __future__ import annotations

__all__ = ["SM_BYTES", "MAX_SMEM", "RESERVED", "blocks_per_sm"]

SM_BYTES = 233_472      # shared memory of one SM (228 KiB)
MAX_SMEM = 232_448      # dynamic shared memory one block may ask for
RESERVED = 1024         # shared memory the runtime keeps per resident block


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of dynamic shared memory that share one SM,
    at most the two the kernels' launch bounds count on."""
    return 2 if 2 * (smem + RESERVED) <= SM_BYTES else 1
