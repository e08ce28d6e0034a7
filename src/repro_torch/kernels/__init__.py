"""Hand-written Hopper kernels for CubeGraph's hot loops, each beside its
plain PyTorch twin.

- ``filtered_topk`` fused distance + spatio-temporal predicate + exact
                    top-k (kernel B1, ``csrc/filtered_topk.cu``)
- ``distance``      tiled pairwise distance matrix (kernel B2,
                    ``csrc/distance.cu``)
- ``quant_topk``    asymmetric int8 filtered top-k over a shard stack
                    (kernel B3, ``csrc/quant_topk.cu``)
- ``graph_topk``    one graph traversal hop with the gather fused in
                    (kernel B4, ``csrc/graph_step.cu``) and the stitched
                    per-bucket traversal around it
- ``flash_decode``  single-token GQA decode attention split over the
                    sequence (kernel B5, ``csrc/flash_decode.cu``); the
                    port's decode step calls it once per layer
- ``ref``           plain PyTorch oracles
- ``ops``           public wrappers: filter encoding, device placement,
                    dispatch, the shard-stack wrappers and block layouts
"""
from .ops import (PAD_META, encode_filter, exact_filtered_search,
                  filtered_topk, next_pow2, pairwise_dist, round_up)

__all__ = ["PAD_META", "encode_filter", "exact_filtered_search",
           "filtered_topk", "next_pow2", "pairwise_dist", "round_up"]
