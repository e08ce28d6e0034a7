"""Tiled pairwise distance matrix (kernel B2).

``pairwise_dist_call`` launches the hand-written CUDA kernel
(``csrc/distance.cu``) for CUDA tensors and runs the plain PyTorch twin
``pairwise_dist_plain`` for CPU tensors: ``[bq, d] x [n, d] -> [bq, n]``
fp32 squared L2 or negated inner product, from fp32 or bf16 inputs with
fp32 accumulation.
"""
from __future__ import annotations

import threading

import torch

from . import ref

__all__ = ["pairwise_dist_call", "pairwise_dist_plain", "launch_count",
           "reset_launch_count"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_LAUNCHES = [0]
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    """CUDA launches of this kernel in this process (the twin never
    counts)."""
    return _LAUNCHES[0]


def reset_launch_count() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[0] = 0


def pairwise_dist_plain(q, x, metric: str = "l2"):
    """Plain PyTorch twin of the kernel."""
    return ref.pairwise_sq_l2(q, x) if metric == "l2" \
        else ref.pairwise_neg_ip(q, x)


def pairwise_dist_call(q, x, metric: str = "l2"):
    """[bq, d] x [n, d] -> [bq, n] fp32 distances.  CPU tensors run the
    twin; CUDA tensors launch the kernel or raise."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if q.dim() != 2 or x.dim() != 2 or q.shape[1] != x.shape[1]:
        raise ValueError(f"shapes {tuple(q.shape)} x {tuple(x.shape)} do not "
                         "form [bq, d] x [n, d]")
    if q.dtype != x.dtype or q.dtype not in _DTYPES:
        raise TypeError(f"q and x must share a dtype in float32/bfloat16, got "
                        f"{q.dtype} and {x.dtype}")
    if q.device != x.device:
        raise ValueError(f"inputs on different devices: {q.device}, "
                         f"{x.device}")
    if q.device.type == "cpu":
        return pairwise_dist_plain(q, x, metric)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bq, d = q.shape
    n = x.shape[0]
    out = torch.empty((bq, n), dtype=torch.float32, device=q.device)
    if bq == 0 or n == 0:
        return out
    if d == 0:
        return out.zero_()
    q, x = q.contiguous(), x.contiguous()
    from ._build import load
    lib = load("distance")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_pairwise_dist(q.data_ptr(), x.data_ptr(),
                                      out.data_ptr(), bq, n, d,
                                      0 if metric == "l2" else 1,
                                      _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"pairwise_dist CUDA launch failed: "
                           f"cudaError {err}")
    with _LAUNCH_LOCK:
        _LAUNCHES[0] += 1
    return out
