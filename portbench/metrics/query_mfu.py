"""The whole query path's share of the fp32 peak (%): the operations the
untraced window's filtered scans needed (every live row inside each box,
delta buffer included, times the batch, times 2d) over the window's
seconds at ``peaks.PEAK_FP32_FLOPS``.  It bounds the kernels' rooflines:
work moved off the scan kernels still counts here."""
from portbench.peaks import PEAK_FP32_FLOPS


def read(r):
    if r.window.get("seconds", 0) <= 0 or r.window.get("ops", 0) <= 0:
        return None
    return 100.0 * r.window["ops"] / (PEAK_FP32_FLOPS * r.window["seconds"])
