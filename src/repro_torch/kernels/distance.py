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

__all__ = ["pairwise_dist_call", "pairwise_dist_plain", "launch_config",
           "copy_width", "launch_count", "reset_launch_count"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The layout of csrc/simt_gemm.cuh and csrc/distance.cu, mirrored here so
# the launch configuration is chosen (and checked on the CPU) in Python;
# the C launcher refuses a shared-memory size that differs from its own.
THREADS = 256
BK = 16                 # depth chunk of one ring stage
LDF = BK + 4            # fp32 row stride of a staged tile (floats)
STAGES = 3
TN = 128                # candidates per output tile
GROUP = 8               # query tiles per rasterisation group
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


def copy_width(ptr: int, row_bytes: int) -> int:
    """Bytes per asynchronous copy for a row-major operand: 16 or 4 where
    the base pointer and the row stride allow it, else 0 (element loads).
    Every row start is then aligned like the base."""
    for width in (16, 4):
        if ptr % width == 0 and row_bytes % width == 0:
            return width
    return 0


def ring_bytes(tq: int, tn: int, a_size: int, b_size: int,
               stages: int = STAGES) -> int:
    """Bytes of ``simt_gemm.cuh``'s ring (``sg::Ring::BYTES``): ``stages``
    slots of a ``[tq, BK]`` A tile and a ``[tn, BK]`` B tile at their
    element sizes (fp32 rows padded to ``LDF``), plus two k-major fp32
    copies ``[BK, rows + 4]`` of each operand."""
    def raw(rows, size):
        return rows * (LDF if size == 4 else BK) * size
    kmajor = BK * (tq + 4) * 4 + BK * (tn + 4) * 4
    return stages * (raw(tq, a_size) + raw(tn, b_size)) + 2 * kmajor


def launch_config(bq: int, n: int, d: int, dtype: torch.dtype, q_ptr: int,
                  x_ptr: int) -> dict:
    """The launch configuration of ``csrc/distance.cu``: the query tile
    (128 rows, 64 for a batch of <= 64), the copy width of each operand,
    the rasterisation group, the dynamic shared memory, the threads and
    the blocks per SM the kernel is compiled for (its launch bounds)."""
    size = 4 if dtype == torch.float32 else 2
    tq = 128 if bq > 64 else 64
    return dict(tq=tq, vec_q=copy_width(q_ptr, d * size),
                vec_x=copy_width(x_ptr, d * size), group=GROUP,
                smem=ring_bytes(tq, TN, size, size) + (tq + TN) * 4,
                threads=THREADS, min_blocks=2 if size == 4 else 1)


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
    cfg = launch_config(bq, n, d, q.dtype, q.data_ptr(), x.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_pairwise_dist(q.data_ptr(), x.data_ptr(),
                                      out.data_ptr(), bq, n, d,
                                      0 if metric == "l2" else 1,
                                      _DTYPES[q.dtype], cfg["tq"],
                                      cfg["vec_q"], cfg["vec_x"],
                                      cfg["group"], cfg["smem"], stream)
    if err != 0:
        raise RuntimeError(f"pairwise_dist CUDA launch failed: "
                           f"cudaError {err}")
    with _LAUNCH_LOCK:
        _LAUNCHES[0] += 1
    return out
