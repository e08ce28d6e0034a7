"""Device resolution shared by every entry point of the port.

Entry points take ``device=``.  The default is the first CUDA card; when
no card is present the caller must ask for the CPU explicitly
(``device="cpu"``) — the port never falls back to the CPU on its own.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda:0"


def resolve_device(device=None, *tensors) -> torch.device:
    """``device`` if given, else the device of the first torch tensor among
    ``tensors``, else the first CUDA card.  Raises when the result is a
    CUDA device and no card is present."""
    if device is None:
        for t in tensors:
            if isinstance(t, torch.Tensor):
                return t.device
        device = DEFAULT_DEVICE
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: device {str(dev)!r} requested but no CUDA card is "
            "present; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(a, device: torch.device, dtype: Optional[torch.dtype] = None
              ) -> torch.Tensor:
    """numpy array / tensor / scalar -> tensor on ``device`` (no copy when
    it already lives there with the right dtype)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype or a.dtype)
    return torch.as_tensor(a, dtype=dtype, device=device)
