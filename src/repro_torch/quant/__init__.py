"""Quantized read path: int8 segment codecs + exact fp32 rerank.

Sealed segments are immutable, so per-dimension symmetric int8 scales are
fit once — at seal or compaction-publish — and never revisited (``codec``,
host numpy).  The sealed-segment scan runs over int8 codes with the scale
folded into the fp32 query (kernel B3, ``repro_torch.kernels.quant_topk``),
over-fetches a candidate set, and an exact fp32 rerank (``rerank``)
restores full-precision ordering with the same deterministic
``(dist, gid)`` tie-break the unquantized merge uses.
"""
from .codec import (QUANT_KINDS, SegmentQuant, dequantize, encode_segment,
                    fit_scales, quantize)
from .rerank import rerank_exact

__all__ = ["QUANT_KINDS", "SegmentQuant", "dequantize", "encode_segment",
           "fit_scales", "quantize", "rerank_exact"]
