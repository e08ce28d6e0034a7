"""Carry the reference's weights into the port.

``params_from_jax`` takes the JAX package's parameter tree as numpy
arrays (``jax.tree.map(np.asarray, params)``: stacked ``[L, ...]`` layers,
projections ``[in, out]``) and returns the port's parameters.  The port
keeps the reference's tree and layouts, so nothing is transposed: each
leaf is checked against the port's spec and copied to ``device`` once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .api import build_model
from .common import ArchConfig, Params, Spec, map_specs

__all__ = ["params_from_jax"]


def _leaf(path: str, a, sp: Spec, dev: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")      # owned and writable
    if tuple(a.shape) != tuple(sp.shape):
        raise ValueError(f"{path}: shape {a.shape}, the port expects "
                         f"{sp.shape}")
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16 from jax
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if t.dtype != sp.dtype:
        raise TypeError(f"{path}: dtype {t.dtype}, the port expects "
                        f"{sp.dtype}")
    return t.to(dev)


def params_from_jax(np_params: Params, cfg: ArchConfig, device=None
                    ) -> Params:
    """The reference's parameter tree (numpy leaves) as the port's
    parameters on ``device`` (default: the first CUDA card)."""
    dev = resolve_device(device)
    specs = build_model(cfg).param_specs()

    def get(path: str):
        node = np_params
        for key in path.split("."):
            node = node[key]
        return node

    return map_specs(specs, lambda path, sp: _leaf(path, get(path), sp, dev))
