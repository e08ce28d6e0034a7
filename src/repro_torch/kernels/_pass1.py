"""Launch configuration of the shared top-k pass 1 (``csrc/topk_pass1.cuh``)
that kernels B1 (``filtered_topk``, fp32 candidates) and B3
(``quant_topk``, int8 codes) instantiate.

The layout of the C template is mirrored here so that the configuration is
chosen, and checked on the CPU, in Python; the C launcher refuses a
shared-memory size that differs from its own.
"""
from __future__ import annotations

import math

import torch

from . import ref
from ._hopper import MAX_SMEM, blocks_per_sm
from .distance import ring_bytes

__all__ = ["TN", "MAX_TILES", "QUERY_TILES", "smem_bytes", "tile_q",
           "splits_for", "live_tiles", "packed_tiles"]

TN = 128                # candidates per tile: the unit of the tile skip
MAX_TILES = 64          # candidate tiles per split
QUERY_TILES = (64, 32, 16, 8)   # the query tiles the kernel is built for


def smem_bytes(tq: int, kpad: int, x_size: int) -> int:
    """Dynamic shared memory of one pass-1 block (``p1::Cfg::smem``) for
    candidates of ``x_size`` bytes (4: B1, 1: B3): the ring and k-major
    copies, the ``[tq, 128]`` distance tile, a norm row, the query norms
    (B1 only, which takes its norms from the ring), the ok bits of
    ``MAX_TILES`` tiles with their 16-bit prefix counts, two 16-bit row
    lists of a packed tile, the passing count (16 bytes), and the ``tq``
    per-query lists of ``kpad`` (distance, id) pairs."""
    words = MAX_TILES * TN // 32
    return (ring_bytes(tq, TN, 4, x_size) + tq * TN * 4 + TN * 4
            + (tq * 4 if x_size == 4 else 0) + words * 4 + words * 2
            + 2 * TN * 2 + 16 + tq * kpad * 8)


def tile_q(kpad: int, x_size: int) -> int:
    """Query rows per block: the largest of ``QUERY_TILES`` at which two
    blocks share an SM, else the largest that fits one block."""
    for tq in QUERY_TILES:
        if blocks_per_sm(smem_bytes(tq, kpad, x_size)) == 2:
            return tq
    return next(tq for tq in QUERY_TILES
                if smem_bytes(tq, kpad, x_size) <= MAX_SMEM)


def splits_for(blocks_per_split: int, tiles: int, slots: int) -> int:
    """Candidate-axis splits for a grid of ``blocks_per_split`` blocks per
    split (query tiles x g) over ``tiles`` candidate tiles of 128, on a
    card with ``slots`` resident blocks: about four waves of blocks, at
    least two tiles a split, at most ``MAX_TILES``.  Split ``s`` takes
    tiles ``s, s + splits, ...``."""
    want = math.ceil(4 * slots / max(blocks_per_split, 1))
    return max(1, min(want, tiles // 2), math.ceil(tiles / MAX_TILES))


def live_tiles(s, params, kind: str, tile: int = TN):
    """Plain count of tiles with a passing candidate: ``(passing
    candidates, live tiles, tiles)`` over a ``[g, n, m]`` metadata stack,
    where a tile is ``tile`` consecutive candidates of one row (from 0)
    and is live when at least one of them passes the predicate."""
    ok = ref.filter_mask_ref(s, kind, params)             # [g, n]
    g, n = ok.shape
    pad = (-n) % tile
    okp = torch.nn.functional.pad(ok, (0, pad)).reshape(g, -1, tile)
    return (int(ok.sum()), int(okp.any(-1).sum()), g * okp.shape[1])


def packed_tiles(s, params, kind: str, splits: int) -> int:
    """Plain count of the tiles the kernels multiply over a ``[g, n, m]``
    metadata stack in ``splits`` splits: each split (tiles ``s, s +
    splits, ...`` of 128 candidates of a row) packs its passing
    candidates into tiles of 128, so it computes ``ceil(passing / 128)``
    of them."""
    ok = ref.filter_mask_ref(s, kind, params)             # [g, n]
    g, n = ok.shape
    tiles = -(-n // TN)
    per_tile = torch.nn.functional.pad(ok, (0, tiles * TN - n)).reshape(
        g, tiles, TN).sum(-1)
    per_tile = torch.nn.functional.pad(per_tile, (0, (-tiles) % splits))
    per_split = per_tile.reshape(g, -1, splits).sum(1)    # [g, splits]
    return int(((per_split + TN - 1) // TN).sum())
