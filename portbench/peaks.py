"""The chip's peaks and the scan's least time: the roofline arithmetic.

The peaks are a frozen copy of ``src/repro_torch/launch/mesh.py::HW``
(NVIDIA H100 SXM5 80GB data sheet, dense, at the 700 W limit), so a
later change to the program cannot move the yardstick.
"""
from __future__ import annotations

PEAK_FP32_FLOPS = 67e12        # fp32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12               # bytes/s

# Element bytes of a pack row's vector, by the configuration's quantize.
ELEM_BYTES = {None: 4, "int8": 1}


def scan_ops(pairs: int, d: int) -> float:
    """Operations of a filtered scan: a multiply and an add per dimension
    for each (query, row) pair that passes the filter."""
    return 2.0 * float(pairs) * d


def scan_bytes(rows: int, d: int, elem_bytes: int) -> float:
    """Bytes of a filtered scan: each passing row's vector read once."""
    return float(rows) * d * elem_bytes


def scan_bound_s(pairs: int, rows: int, d: int, elem_bytes: int) -> float:
    """The least time the chip needs for one batch's filtered scan: the
    larger of its operations at the fp32 peak (the peak ``PERF.md``'s
    kernel table holds B1 and B3 to: both multiply in an fp32 mainloop)
    and its bytes at the HBM bandwidth."""
    return max(scan_ops(pairs, d) / PEAK_FP32_FLOPS,
               scan_bytes(rows, d, elem_bytes) / HBM_BW)
