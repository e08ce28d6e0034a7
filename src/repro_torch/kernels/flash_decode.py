"""Fused single-token GQA decode attention (kernel B5).

``flash_decode_call`` launches the hand-written CUDA kernel
(``csrc/flash_decode.cu``) for CUDA tensors and runs its plain PyTorch
twin :func:`repro_torch.kernels.ref.flash_decode_ref` for CPU tensors —
the tensor's device alone decides; a CUDA tensor never takes the twin.

``q [bkv, g, hd]`` (one row per (batch, kv-head) pair, ``g`` the GQA
group), ``k / v [bkv, smax, hd]`` cache slabs, ``lengths [bkv]`` int32
inclusive filled prefix, in ``[0, smax)``, and ``window`` (the layer's
scalar: -1 global, else row ``r`` reads columns ``max(0, lengths[r] -
window) .. lengths[r]``)  ->  ``o [bkv, g, hd]`` in q's dtype:
``softmax(q·Kᵀ/√hd over those columns) · V`` with fp32 accumulation.  On
the card: fp32 or bf16, ``g`` in 1..16, ``hd`` in {64, 80, 128, 256},
contiguous inputs; anything else raises.

The kernel combines a row's segments itself: the last block of a row takes
a ticket from a per-row int32 counter that it leaves at 0.  The wrapper
keeps the counters and the partial results' scratch per (device, stream),
so launches on one stream share them in order (and a captured CUDA graph
may replay them).
"""
from __future__ import annotations

import functools
import operator
import threading

import torch

from . import ref
from ._hopper import MAX_SMEM, blocks_per_sm

__all__ = ["flash_decode_call", "flash_decode_plain", "launch_config",
           "launch_count", "windowed_launch_count", "reset_launch_count",
           "MAX_G", "HEAD_DIMS"]

MAX_G = 16
HEAD_DIMS = (64, 80, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/flash_decode.cu's layout, mirrored (the C launcher refuses a
# shared-memory size that differs from its own)
THREADS = 128
GROUPS = (1, 2, 4, 8, 16)   # the group sizes the kernel is compiled for
_SCRATCH: dict = {}     # (device, stream) -> (counters, partials)
_SMS: dict = {}

_LAUNCHES = [0, 0]      # all launches, windowed launches
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    """CUDA launches of this kernel in this process (the twin never
    counts)."""
    return _LAUNCHES[0]


def windowed_launch_count() -> int:
    """The launches among :func:`launch_count` with a window >= 0."""
    return _LAUNCHES[1]


def reset_launch_count() -> None:
    with _LAUNCH_LOCK:
        _LAUNCHES[0] = _LAUNCHES[1] = 0


def flash_decode_plain(q, k, v, lengths, window: int = -1):
    """Plain PyTorch twin of the kernel, same shapes and semantics."""
    return ref.flash_decode_ref(q, k, v, lengths, window)


def _check(q, k, v, lengths, window):
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
    if window < -1:
        raise ValueError(f"window must be >= -1, got {window}")


def tile_keys(hd: int, size: int) -> int:
    """Keys per ring tile (``Geo::TS``): 64, or 32 where a key row of K
    is longer than 256 bytes."""
    return 64 if hd * size <= 256 else 32


def stages(hd: int, size: int) -> int:
    """Tiles in the ring (``Geo::STAGES``): 3, or 2 for fp32 at hd 256."""
    return 2 if size == 4 and hd == 256 else 3


def smem_bytes(bkv: int, hd: int, size: int, gc: int) -> int:
    """Dynamic shared memory of one block (``Geo::smem``): the ring
    (``stages`` tiles of K, rows padded by 16 bytes, of V and the tile's
    query row, ``gc`` heads), the probabilities ``[gc, tile]`` and the
    scaled query rows ``[gc, hd + 4]`` in fp32, each warp's maximum and
    sum per head (``[4, gc]`` twice), the ticket and the rows' tile prefix
    sums (``bkv + 1`` int32, rounded up to 16 bytes)."""
    ts = tile_keys(hd, size)
    stage = ts * (hd * size + 16) + ts * hd * size + gc * hd * size
    return (stages(hd, size) * stage + gc * ts * 4 + gc * (hd + 4) * 4
            + 2 * 4 * gc * 4 + 16 + -(-(bkv + 1) * 4 // 16) * 16)


@functools.lru_cache(maxsize=256)
def launch_config(bkv: int, g: int, smax: int, hd: int, dtype: torch.dtype,
                  sms: int) -> dict:
    """The launch configuration of ``csrc/flash_decode.cu``: keys per tile,
    the group rounded up to a compiled size (``gc``), the ring depth, the
    dynamic shared memory and the blocks that share one SM, the grid
    (``blocks``: as many as the card holds at once; the kernel shares the
    filled tiles of all rows out evenly between them, and each block
    leaves at most two partial results: its first and its last row), the
    copy width (16 bytes: the wrapper refuses other alignments) and the
    threads."""
    size = 4 if dtype == torch.float32 else 2
    ts = tile_keys(hd, size)
    gc = next(c for c in GROUPS if c >= g)
    smem = smem_bytes(bkv, hd, size, gc)
    per_sm = blocks_per_sm(smem)
    blocks = per_sm * sms
    return dict(tile=ts, gc=gc, stages=stages(hd, size), smem=smem,
                min_blocks=per_sm, blocks=blocks, vec=16, threads=THREADS)


def _scratch(dev, stream: int, bkv: int, acc_elems: int):
    """The zeroed per-row ticket counters (which the kernel leaves zeroed)
    and the partial (acc, (max, sum)) buffers of ``stream`` on ``dev``:
    launches on one stream run in order, so they share them, and a
    decode step allocates nothing per layer."""
    key = (dev.index, stream)
    cnt, part = _SCRATCH.get(key, (None, None))
    if cnt is None or cnt.numel() < bkv:
        cnt = torch.zeros(max(bkv, 1024), dtype=torch.int32, device=dev)
    if part is None or part.numel() < acc_elems:
        part = torch.empty(acc_elems, dtype=torch.float32, device=dev)
    _SCRATCH[key] = (cnt, part)
    return cnt, part


def _sms(dev) -> int:
    n = _SMS.get(dev.index)
    if n is None:
        n = _SMS[dev.index] = (torch.cuda.get_device_properties(dev)
                               .multi_processor_count)
    return n


def flash_decode_call(q, k, v, lengths, window: int = -1):
    """Decode attention of one layer.  CPU tensors run
    :func:`flash_decode_plain`; CUDA tensors launch the kernel or raise."""
    window = operator.index(window)      # a Python or numpy integer
    _check(q, k, v, lengths, window)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, window)
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
    cfg = launch_config(bkv, g, smax, hd, q.dtype, _sms(dev))
    if cfg["smem"] > MAX_SMEM:
        raise ValueError(f"the CUDA kernel takes at most "
                         f"{(MAX_SMEM - smem_bytes(0, hd, 2, 16)) // 4} rows,"
                         f" got {bkv}")
    nb = cfg["blocks"]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        # scratch [blocks, 2, g, hd] acc, then [blocks, 2, g, 2] (max, sum)
        n_acc = nb * 2 * g * hd
        cnt, part = _scratch(dev, stream, bkv, n_acc + nb * 2 * g * 2)
        err = lib.repro_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part.data_ptr(), part.data_ptr() + 4 * n_acc,
            cnt.data_ptr(), bkv, g, smax, hd, min(window, smax), nb,
            _DTYPE_CODE[q.dtype], cfg["gc"], cfg["smem"], stream)
    if err != 0:
        raise RuntimeError(f"flash_decode CUDA launch failed: "
                           f"cudaError {err}")
    with _LAUNCH_LOCK:
        _LAUNCHES[0] += 1
        _LAUNCHES[1] += window >= 0
    return out
