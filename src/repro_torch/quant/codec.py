"""Per-segment symmetric int8 scalar quantization.

One scale per vector dimension, fit over a sealed segment's rows:
``scale[j] = max_i |x[i, j]| / 127``.  Codes are round-to-nearest of
``x / scale`` clipped to ``[-127, 127]``, so every element satisfies the
codec contract

    |x[i, j] - scale[j] * code[i, j]|  <=  scale[j] / 2

(tested against the reference codec, bit for bit, in
``tests/test_torch_quant.py``: this module is host numpy, a copy of the
JAX package's codec, so codes, scales and ``xsq`` are bit-equal to it).
Scales are fit only when a segment's content is (re)written — seal and
compaction-publish — because sealed segments are immutable; restore loads
codes/scales from the segment artifact and never re-quantizes.

The dequantized squared norms (``xsq``) are precomputed here too: the
asymmetric-distance kernel needs ``||deq(x)||^2`` per point and the segment
is immutable, so paying O(n d) once at encode time keeps it off every
query.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["QUANT_KINDS", "SegmentQuant", "dequantize", "encode_segment",
           "fit_scales", "quantize"]

QUANT_KINDS = ("int8",)
_QMAX = 127.0                    # symmetric int8 code range [-127, 127]
_MIN_SCALE = 1e-12               # all-zero dimensions quantize to code 0


def fit_scales(x: np.ndarray) -> np.ndarray:
    """Per-dimension symmetric scales for one segment: ``[d]`` fp32 with
    ``scale[j] = max_i |x[i, j]| / 127`` (floored so an all-zero dimension
    stays finite and round-trips to exactly zero)."""
    x = np.atleast_2d(np.asarray(x, np.float32))
    amax = np.abs(x).max(axis=0) if len(x) else np.zeros(x.shape[1],
                                                         np.float32)
    return np.maximum(amax / _QMAX, _MIN_SCALE).astype(np.float32)


def quantize(x: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """``[n, d]`` fp32 -> int8 codes: round-to-nearest of ``x / scales``,
    clipped to the symmetric range."""
    x = np.atleast_2d(np.asarray(x, np.float32))
    q = np.rint(x / np.asarray(scales, np.float32)[None, :])
    return np.clip(q, -_QMAX, _QMAX).astype(np.int8)


def dequantize(codes: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """int8 codes -> fp32 reconstruction ``codes * scales``."""
    return (np.asarray(codes, np.float32)
            * np.asarray(scales, np.float32)[None, :])


@dataclasses.dataclass(frozen=True)
class SegmentQuant:
    """One sealed segment's quantized payload (rows parallel to the
    segment's ``index.x`` rows, so validity masks apply unchanged).

    ``xsq`` holds the *dequantized* squared norms — the asymmetric L2
    kernel computes ``||q - deq(x)||^2 = ||q||^2 - 2 (q*scale).codes +
    xsq`` and must use the reconstruction's norm, not the original's, for
    its candidate ranking to match the dequantized oracle exactly.
    """

    kind: str                    # codec name ("int8")
    codes: np.ndarray            # [n, d] int8
    scales: np.ndarray           # [d] fp32
    xsq: np.ndarray              # [n] fp32 dequantized squared norms

    @property
    def n(self) -> int:
        """Encoded rows."""
        return int(self.codes.shape[0])

    @property
    def d(self) -> int:
        """Vector dimension."""
        return int(self.codes.shape[1])

    @property
    def nbytes(self) -> int:
        """Host bytes of the payload (codes + scales + norms)."""
        return int(self.codes.nbytes + self.scales.nbytes + self.xsq.nbytes)

    def take(self, rows: np.ndarray) -> "SegmentQuant":
        """Row-subset view (e.g. the live rows) sharing this payload's
        scales — valid because per-dimension maxima only shrink under
        subsetting, so the scale bound still holds for every kept row."""
        rows = np.asarray(rows)
        return SegmentQuant(self.kind, self.codes[rows], self.scales,
                            self.xsq[rows])


def encode_segment(x: np.ndarray, kind: str = "int8") -> SegmentQuant:
    """Fit scales over ``x`` and encode it — the one entry point used at
    seal and compaction-publish time."""
    if kind not in QUANT_KINDS:
        raise ValueError(f"unknown quantization kind {kind!r}; "
                         f"supported: {QUANT_KINDS}")
    x = np.atleast_2d(np.asarray(x, np.float32))
    scales = fit_scales(x)
    codes = quantize(x, scales)
    deq = dequantize(codes, scales)
    xsq = np.einsum("nd,nd->n", deq, deq).astype(np.float32)
    return SegmentQuant(kind, codes, scales, xsq)
