"""Fused asymmetric-distance filtered top-k over int8 codes (kernel B3).

``quant_topk_call`` launches the hand-written CUDA kernel
(``csrc/quant_topk.cu``) for CUDA tensors and runs its plain PyTorch twin
``quant_topk_plain`` for CPU tensors — the tensor's device alone decides.

Layout (the port's, not the TPU's transposed tiles): scale-folded queries
``qs [gq, bq, d]`` fp32 (``gq in {1, g}``), codes ``[g, n, d]`` int8
row-major, metadata ``s [g, n, m]`` fp32 (``PAD_META`` on padding and dead
rows), dequantized squared norms ``xsq [g, n]`` fp32 and one packed
``params [4, mp]`` block.  Outputs are ``(dists [g, bq, kpad], ids [g, bq,
kpad] int32)`` ascending by (distance, id); L2 distances are *partial*
(``xsq − 2·ip``: the caller adds ``‖q‖²``), IP distances are ``−ip``.
"""
from __future__ import annotations

import math
import threading

import torch

from . import _pass1, ref
from ._hopper import (MAX_SMEM, RESERVED, SM_BYTES,  # noqa: F401
                      blocks_per_sm)
from ._pass1 import MAX_TILES, TN, live_tiles  # noqa: F401
from .distance import THREADS, copy_width
from .filtered_topk import FILTER_KINDS

__all__ = ["quant_topk_call", "quant_topk_plain", "launch_config",
           "live_tiles", "launch_count", "launch_counts_by_device",
           "reset_launch_count", "MAX_KPAD"]

_KIND_CODE = {k: i for i, k in enumerate(FILTER_KINDS)}
_MAX_M = 16
MAX_KPAD = 2048
_LAUNCHES = [0]
# launches per CUDA device index (a shard mesh launches on each card)
_BY_DEVICE: dict = {}
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    """CUDA launches of this kernel in this process (the twin never
    counts)."""
    return _LAUNCHES[0]


def launch_counts_by_device() -> dict:
    """:func:`launch_count`'s launches by CUDA device index."""
    with _LAUNCH_LOCK:
        return dict(_BY_DEVICE)


def reset_launch_count() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[0] = 0
        _BY_DEVICE.clear()


def quant_topk_plain(qs, codes, s, xsq, params, kind: str, kpad: int,
                     metric: str = "l2"):
    """Plain PyTorch twin of the kernel, same shapes and semantics."""
    outs_d, outs_i = [], []
    for gi in range(codes.shape[0]):
        q1 = qs[gi if qs.shape[0] > 1 else 0]
        dd, ii = ref.quant_filtered_topk_ref(q1, codes[gi], s[gi], xsq[gi],
                                             kind, params, kpad,
                                             metric=metric)
        outs_d.append(dd)
        outs_i.append(ii)
    return torch.stack(outs_d), torch.stack(outs_i)


def smem_bytes(tq: int, kpad: int) -> int:
    """Dynamic shared memory of one pass-1 block over int8 codes
    (``csrc/topk_pass1.cuh``, ``_pass1.smem_bytes``)."""
    return _pass1.smem_bytes(tq, kpad, 1)


def tile_q(kpad: int) -> int:
    """Query rows per block at ``kpad`` (``_pass1.tile_q``)."""
    return _pass1.tile_q(kpad, 1)


def launch_config(g: int, bq: int, n: int, d: int, kpad: int, q_ptr: int,
                  c_ptr: int, sms: int) -> dict:
    """The launch configuration of ``csrc/quant_topk.cu`` for ``g`` rows
    of ``n`` candidates: the query tile, the dynamic shared memory and the
    blocks that fit on one SM (``SM_BYTES``, ``RESERVED`` per block),
    the candidate-axis splits (about four waves of resident blocks, at
    most ``MAX_TILES`` tiles and at least two per split; split ``s`` takes
    tiles ``s, s + splits, ...``), the copy widths of the folded queries
    (fp32) and the codes (int8), and the threads."""
    tq = tile_q(kpad)
    smem = smem_bytes(tq, kpad)
    per_sm = blocks_per_sm(smem)
    splits = _pass1.splits_for(math.ceil(bq / tq) * g,
                               max(1, math.ceil(n / TN)), per_sm * sms)
    return dict(tq=tq, splits=splits,
                vec_q=copy_width(q_ptr, d * 4), vec_c=copy_width(c_ptr, d),
                smem=smem, threads=THREADS, min_blocks=per_sm)


def _check(qs, codes, s, xsq, params, kind, kpad, metric):
    if kind not in _KIND_CODE:
        raise ValueError(f"unknown filter kind {kind!r}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    if kpad < 1 or kpad & (kpad - 1):
        raise ValueError(f"kpad must be a power of two, got {kpad}")
    if codes.dim() != 3 or s.dim() != 3 or qs.dim() != 3 or xsq.dim() != 2 \
            or params.dim() != 2:
        raise ValueError("quant_topk_call takes qs [gq, bq, d], codes "
                         "[g, n, d], s [g, n, m], xsq [g, n], params [4, mp]")
    g, n, d = codes.shape
    if s.shape[:2] != (g, n) or tuple(xsq.shape) != (g, n):
        raise ValueError(f"metadata {tuple(s.shape)} / norms "
                         f"{tuple(xsq.shape)} do not match codes "
                         f"{tuple(codes.shape)}")
    if qs.shape[0] not in (1, g) or qs.shape[2] != d:
        raise ValueError(f"query shape {tuple(qs.shape)} does not match "
                         f"codes {tuple(codes.shape)}")
    if params.shape[0] != 4 or params.shape[1] < max(s.shape[2], 2):
        raise ValueError(f"params shape {tuple(params.shape)} must be "
                         f"[4, >=max(m, 2)]")
    devs = {t.device for t in (qs, codes, s, xsq, params)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")
    if codes.dtype != torch.int8:
        raise TypeError(f"codes must be int8, got {codes.dtype}")
    for name, t in (("qs", qs), ("s", s), ("xsq", xsq), ("params", params)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def quant_topk_call(qs, codes, s, xsq, params, kind: str, kpad: int,
                    metric: str = "l2"):
    """Fused asymmetric filtered top-kpad over a batch of int8 code blocks.

    CPU tensors run :func:`quant_topk_plain`; CUDA tensors launch the
    kernel or raise."""
    _check(qs, codes, s, xsq, params, kind, kpad, metric)
    if codes.device.type == "cpu":
        return quant_topk_plain(qs, codes, s, xsq, params, kind, kpad, metric)
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    g, n, d = codes.shape
    bq, m, mp = qs.shape[1], s.shape[2], params.shape[1]
    if m > _MAX_M:
        raise ValueError(f"the CUDA kernel reads at most {_MAX_M} metadata "
                         f"columns, got {m}")
    if kpad > MAX_KPAD:
        raise ValueError(f"the CUDA kernel supports kpad <= {MAX_KPAD}, "
                         f"got {kpad}")
    dev = codes.device
    out_d = torch.empty((g, bq, kpad), dtype=torch.float32, device=dev)
    out_i = torch.empty((g, bq, kpad), dtype=torch.int32, device=dev)
    if bq == 0 or g == 0:
        return out_d, out_i
    if n == 0:
        return out_d.fill_(float("inf")), out_i.fill_(-1)
    qs, codes, s, xsq, params = (t.contiguous()
                                 for t in (qs, codes, s, xsq, params))
    from ._build import load
    lib = load("quant_topk")
    cfg = launch_config(g, bq, n, d, kpad, qs.data_ptr(), codes.data_ptr(),
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
    q_gs = 0 if qs.shape[0] == 1 else qs.stride(0)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_quant_topk(
            qs.data_ptr(), codes.data_ptr(), s.data_ptr(), xsq.data_ptr(),
            params.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), pd, pi,
            g, bq, n, d, m, mp, kpad, _KIND_CODE[kind],
            0 if metric == "l2" else 1, cfg["tq"], splits, cfg["vec_q"],
            cfg["vec_c"], cfg["smem"], q_gs, codes.stride(0),
            s.stride(0), xsq.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"quant_topk CUDA launch failed: cudaError {err}")
    with _LAUNCH_LOCK:
        _LAUNCHES[0] += 1
        _BY_DEVICE[dev.index] = _BY_DEVICE.get(dev.index, 0) + 1
    return out_d, out_i
