"""Fused single-token GQA decode attention (kernel B5).

``flash_decode_call`` launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``) for CUDA tensors and runs its plain PyTorch
twin :func:`repro_torch.kernels.ref.flash_decode_ref` for CPU tensors —
the tensor's device alone decides; a CUDA tensor never takes the twin.

``q [bkv, g, hd]`` (one row per (batch, kv-head) pair, ``g`` the GQA
group), ``k / v [bkv, smax, hd]`` cache slabs, ``lengths [bkv]`` int32
inclusive filled prefix, in ``[0, smax)``  ->  ``o [bkv, g, hd]`` in q's
dtype: ``softmax(q·Kᵀ/√hd over columns <= lengths) · V`` with fp32
accumulation.  On the card: fp32 or bf16, ``g`` in 1..16, ``hd`` in
{64, 128, 256}, contiguous inputs; anything else raises.
"""
from __future__ import annotations

import math
import threading

import torch

from . import ref

__all__ = ["flash_decode_call", "flash_decode_plain", "launch_count",
           "reset_launch_count", "MAX_G", "HEAD_DIMS"]

MAX_G = 16
HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LAUNCHES = [0]
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    """CUDA launches of this kernel in this process (the twin never
    counts)."""
    return _LAUNCHES[0]


def reset_launch_count() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[0] = 0


def flash_decode_plain(q, k, v, lengths):
    """Plain PyTorch twin of the kernel, same shapes and semantics."""
    return ref.flash_decode_ref(q, k, v, lengths)


def _check(q, k, v, lengths):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3 or lengths.dim() != 1:
        raise ValueError("flash_decode_call takes q [bkv, g, hd], k / v "
                         "[bkv, smax, hd] and lengths [bkv]")
    bkv, g, hd = q.shape
    if k.shape != v.shape or k.shape[0] != bkv or k.shape[2] != hd:
        raise ValueError(f"cache shapes k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if lengths.shape[0] != bkv:
        raise ValueError(f"lengths {tuple(lengths.shape)} do not match "
                         f"{bkv} rows")
    if k.shape[1] < 1:
        raise ValueError("the cache holds no positions (smax = 0)")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    devs = {t.device for t in (q, k, v, lengths)}
    if len(devs) != 1:
        raise ValueError(f"inputs on different devices: {devs}")


def _splits(dev, bkv: int, smax: int, tile: int) -> int:
    """Sequence splits: about four blocks per SM over the card, with at
    least one key tile per split."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want = math.ceil(4 * sms / max(bkv, 1))
    return max(1, min(want, math.ceil(smax / tile)))


def flash_decode_call(q, k, v, lengths):
    """Decode attention of one layer.  CPU tensors run
    :func:`flash_decode_plain`; CUDA tensors launch the kernel or raise."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    bkv, g, hd = q.shape
    smax = k.shape[1]
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"the CUDA kernel takes fp32 or bf16, got {q.dtype}")
    if not 1 <= g <= MAX_G:
        raise ValueError(f"the CUDA kernel takes a GQA group of 1..{MAX_G}, "
                         f"got {g}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernel takes hd in {HEAD_DIMS}, got {hd}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for the CUDA "
                             "kernel")
    dev = q.device
    out = torch.empty_like(q)
    if bkv == 0:
        return out
    from ._build import load
    lib = load("flash_decode")
    code = _DTYPE_CODE[q.dtype]
    tile = lib.repro_flash_decode_tile(hd, code)
    nsplit = _splits(dev, bkv, smax, tile)
    chunk = math.ceil(math.ceil(smax / nsplit) / tile) * tile
    nsplit = math.ceil(smax / chunk)
    if nsplit > 1:
        part_acc = torch.empty((bkv, nsplit, g, hd), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((bkv, nsplit, g, 2), dtype=torch.float32,
                              device=dev)
        pa, pm = part_acc.data_ptr(), part_ml.data_ptr()
    else:
        pa = pm = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.repro_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), pa, pm, bkv, g, smax, hd, chunk, nsplit, code,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_decode CUDA launch failed: "
                           f"cudaError {err}")
    with _LAUNCH_LOCK:
        _LAUNCHES[0] += 1
    return out
