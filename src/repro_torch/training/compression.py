"""Gradient compression for the data-parallel all-reduce: int8
quantization with error feedback — the counterpart of
``repro.training.compression``.

Each replica quantizes its local gradient (one fp32 scale per tensor),
all-reduces the int8 payload (summed as int32) and the scales over a
``torch.distributed`` process group (the reference's ``psum`` inside
``shard_map`` over the data axis), dequantizes with the mean scale, and
keeps the quantization residual in an error-feedback buffer that is added
to the *next* step's gradient.

The arithmetic is the reference's to the bit: ``scale = max|g| / 127 +
1e-30`` in fp32, ``round`` half to even, a clip to +-127.  Every division
divides by an fp32 tensor: on a CUDA tensor torch turns a division by a
Python scalar into a multiplication by its reciprocal, which rounds
differently.  ``compressed_psum`` keeps the reference's formula, which
scales the summed payload by the *mean* scale, not each replica's own.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .tree import leaves, tree_map, unflatten_like

Params = Any


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale fp32 0-d)`` of an fp32 tensor ``g``."""
    scale = torch.amax(torch.abs(g)) / _f32(127.0, g) + 1e-30
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_residual(g: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns ``(q, scale, residual = g - dequant(q))``."""
    q, scale = quantize_int8(g)
    return q, scale, g - dequantize_int8(q, scale)


def compressed_psum(grads: Params, errors: Params, group=None
                    ) -> Tuple[Params, Params]:
    """Error-feedback compressed mean over the process group ``group``
    (default: the world).  ``grads`` / ``errors``: local trees (errors in
    fp32).  Returns ``(averaged grads fp32, new errors)``; every rank
    gets the same average."""
    import torch.distributed as dist
    n_ranks = dist.get_world_size(group)

    def one(g, e):
        g = g.to(torch.float32) + e
        q, scale, resid = compress_residual(g)
        # int8 payload summed across replicas as int32; the per-replica
        # scale rides along as one fp32 per tensor
        qsum = q.to(torch.int32)
        dist.all_reduce(qsum, group=group)
        ssum = scale.clone()
        dist.all_reduce(ssum, group=group)
        n = _f32(float(n_ranks), g)
        avg = qsum.to(torch.float32) * (ssum / n) / n
        return avg, resid

    out = [one(g, e) for g, e in zip(leaves(grads), leaves(errors))]
    return (unflatten_like(grads, [o[0] for o in out]),
            unflatten_like(grads, [o[1] for o in out]))


def init_error_state(params: Params) -> Params:
    """fp32 zeros beside every parameter, on its device."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
