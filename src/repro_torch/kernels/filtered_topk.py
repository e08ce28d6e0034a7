"""Fused distance + spatio-temporal predicate + exact top-k (kernel B1).

``filtered_topk_call`` launches the hand-written CUDA kernel
(``csrc/filtered_topk.cu``) for CUDA tensors and runs its plain PyTorch
twin ``filtered_topk_plain`` for CPU tensors — the tensor's device alone
decides; a CUDA tensor never silently takes the twin.

Both take a leading batch axis ``g``: ``x [g, n, d]``, ``s [g, n, m]``,
``q [gq, bq, d]`` and ``params [gp, 4, mp]`` with ``gq, gp in {1, g}``
(1 = shared across the batch).  Outputs are ``(dists [g, bq, kpad]
ascending by (distance, id), ids [g, bq, kpad] int32)`` with ``+inf`` /
``-1`` for misses; rows whose metadata carries ``PAD_META`` fail every
filter kind.
"""
from __future__ import annotations

import math
import threading

import torch

from . import _pass1, ref
from ._hopper import blocks_per_sm
from .distance import THREADS, copy_width

__all__ = ["FILTER_KINDS", "filtered_topk_call", "filtered_topk_plain",
           "launch_config", "launch_count", "reset_launch_count",
           "MAX_KPAD"]

FILTER_KINDS = ref.FILTER_KINDS
_KIND_CODE = {k: i for i, k in enumerate(FILTER_KINDS)}
_MAX_M = 16                   # metadata columns the CUDA kernel reads
MAX_KPAD = 1024

_LAUNCHES = [0]
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    """CUDA launches of this kernel in this process (the twin never
    counts)."""
    return _LAUNCHES[0]


def reset_launch_count() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[0] = 0


def filtered_topk_plain(q, x, s, params, kind: str, kpad: int,
                        metric: str = "l2"):
    """Plain PyTorch twin of the kernel, same shapes and semantics."""
    g = x.shape[0]
    outs_d, outs_i = [], []
    for gi in range(g):
        qg = q[gi if q.shape[0] > 1 else 0]
        pg = params[gi if params.shape[0] > 1 else 0]
        dd, ii = ref.filtered_topk_ref(qg, x[gi], s[gi], kind, pg, kpad,
                                       metric=metric)
        outs_d.append(dd)
        outs_i.append(ii)
    return torch.stack(outs_d), torch.stack(outs_i)


def _check(q, x, s, params, kind, kpad, metric):
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown filter kind {kind!r}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if kpad < 1 or kpad & (kpad - 1):
        raise ValueError(f"kpad must be a power of two, got {kpad}")
    if x.dim() != 3 or s.dim() != 3 or q.dim() != 3 or params.dim() != 3:
        raise ValueError("filtered_topk_call takes batched inputs: q [gq, bq,"
                         " d], x [g, n, d], s [g, n, m], params [gp, 4, mp]")
    g, n, d = x.shape
    if s.shape[:2] != (g, n):
        raise ValueError(f"metadata shape {tuple(s.shape)} does not match "
                         f"vectors {tuple(x.shape)}")
    if q.shape[0] not in (1, g) or q.shape[2] != d:
        raise ValueError(f"query shape {tuple(q.shape)} does not match "
                         f"vectors {tuple(x.shape)}")
    if (params.shape[0] not in (1, g) or params.shape[1] != 4
            or params.shape[2] < max(s.shape[2], 2)):
        raise ValueError(f"params shape {tuple(params.shape)} must be "
                         f"[1|g, 4, >=max(m, 2)]")
    devs = {t.device for t in (q, x, s, params)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    for name, t in (("q", q), ("x", x), ("s", s), ("params", params)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def launch_config(g: int, bq: int, n: int, d: int, kpad: int, q_ptr: int,
                  x_ptr: int, sms: int) -> dict:
    """The launch configuration of ``csrc/filtered_topk.cu`` (pass 1 of
    ``csrc/topk_pass1.cuh`` over fp32 candidates) for ``g`` rows of ``n``
    candidates: the query tile (``_pass1.tile_q``), the dynamic shared
    memory and the blocks that share one SM, the candidate-axis splits
    (``_pass1.splits_for``, as B3), the copy widths of the queries and the
    candidates (16, 4 or 0 bytes), and the threads."""
    tq = _pass1.tile_q(kpad, 4)
    smem = _pass1.smem_bytes(tq, kpad, 4)
    per_sm = blocks_per_sm(smem)
    splits = _pass1.splits_for(math.ceil(bq / tq) * g,
                               max(1, math.ceil(n / _pass1.TN)),
                               per_sm * sms)
    return dict(tq=tq, splits=splits, vec_q=copy_width(q_ptr, d * 4),
                vec_x=copy_width(x_ptr, d * 4), smem=smem, threads=THREADS,
                min_blocks=per_sm)


def filtered_topk_call(q, x, s, params, kind: str, kpad: int,
                       metric: str = "l2"):
    """Fused filtered exact top-kpad over a batch of candidate sets.

    CPU tensors run :func:`filtered_topk_plain`; CUDA tensors launch the
    kernel or raise."""
    _check(q, x, s, params, kind, kpad, metric)
    if x.device.type == "cpu":
        return filtered_topk_plain(q, x, s, params, kind, kpad, metric)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    g, n, d = x.shape
    bq, m, mp = q.shape[1], s.shape[2], params.shape[2]
    if m > _MAX_M:
        raise ValueError(f"the CUDA kernel reads at most {_MAX_M} metadata "
                         f"columns, got {m}")
    if kpad > MAX_KPAD:
        raise ValueError(f"the CUDA kernel supports kpad <= {MAX_KPAD}, "
                         f"got {kpad}")
    dev = x.device
    out_d = torch.empty((g, bq, kpad), dtype=torch.float32, device=dev)
    out_i = torch.empty((g, bq, kpad), dtype=torch.int32, device=dev)
    if bq == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(float("inf")), out_i.fill_(-1)
    q, x, s, params = (t.contiguous() for t in (q, x, s, params))
    from ._build import load
    lib = load("filtered_topk")
    cfg = launch_config(g, bq, n, d, kpad, q.data_ptr(), x.data_ptr(),
                        torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
    splits = cfg["splits"]
    if splits > 1:
        part_d = torch.empty((g, splits, bq, kpad), dtype=torch.float32,
                             device=dev)
        part_i = torch.empty((g, splits, bq, kpad), dtype=torch.int32,
                             device=dev)
        pd, pi = part_d.data_ptr(), part_i.data_ptr()
    else:
        pd = pi = None
    gs = lambda t: 0 if t.shape[0] == 1 else t.stride(0)   # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_filtered_topk(
            q.data_ptr(), x.data_ptr(), s.data_ptr(), params.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), pd, pi,
            g, bq, n, d, m, mp, kpad, _KIND_CODE[kind],
            0 if metric == "l2" else 1, cfg["tq"], splits, cfg["vec_q"],
            cfg["vec_x"], cfg["smem"], gs(q), x.stride(0), s.stride(0),
            gs(params), stream)
    if err != 0:
        raise RuntimeError(f"filtered_topk CUDA launch failed: "
                           f"cudaError {err}")
    with _LAUNCH_LOCK:
        _LAUNCHES[0] += 1
    return out_d, out_i
