"""The one traffic generator: a mix file's parameters -> a pool of batches.

A mix (``traffic/<name>.json``) is a closed loop of one client that
cycles a fixed pool of batches.  Every batch holds ``batch`` queries that
share one filter: a square box over (lon, lat) AND a time window.

* ``box_area``: [lo, hi] share of the map the box covers; the box is
  centred on a hot region of the configuration, chosen by its weight,
  and shifted to lie inside the map.
* ``window_share``: [lo, hi] share of the corpus's time span (0, now]
  the window covers, placed anywhere inside it.
* ``query_noise``: a query is a corpus row plus Gaussian noise of this
  sigma.

Every seed gets the same batches' shapes: areas, window shares and
window offsets evenly spaced over their ranges, regions split by weight,
and one fixed pairing of them.  The seed draws the corpus, the query rows
and the order of the batches, so it changes which rows and queries a run
sees and not how much work it does.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .data import Corpus, stream_seed

PAIRING_SEED = 20261018   # the one fixed pairing of shapes, for every seed


@dataclasses.dataclass
class Batch:
    """One pool entry: host queries and the box ``[lo, hi]`` over every
    metadata column (fp32, as handed to the program)."""

    queries: np.ndarray
    lo: np.ndarray
    hi: np.ndarray


def _strata(lo: float, hi: float, n: int) -> np.ndarray:
    return lo + (hi - lo) * (np.arange(n) + 0.5) / n


def _region_counts(weights, n: int) -> np.ndarray:
    """Largest-remainder split of ``n`` batches by the region weights."""
    w = np.asarray(weights, np.float64)
    raw = w / w.sum() * n
    counts = np.floor(raw).astype(int)
    for i in np.argsort(-(raw - counts), kind="stable")[:n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.arange(len(w)), counts)


def make_pool(traffic: dict, cfg: dict, corpus: Corpus, seed: int
              ) -> List[Batch]:
    """The mix's pool of batches for ``seed`` over ``corpus``."""
    p, b = int(traffic["pool"]), int(traffic["batch"])
    fixed = np.random.default_rng(PAIRING_SEED)
    areas = _strata(*traffic["box_area"], p)
    shares = fixed.permutation(_strata(*traffic["window_share"], p))
    offsets = fixed.permutation(_strata(0.0, 1.0, p))
    regions = fixed.permutation(_region_counts(
        cfg["data"]["region_weights"], p))
    order = np.random.default_rng(stream_seed(seed, 3)).permutation(p)
    hot = np.asarray(cfg["data"]["hot_regions"], np.float64)
    n = corpus.n
    step = 1.0 / n                       # spacing of arrival times
    span = corpus.now
    gen = torch.Generator(device=corpus.x.device)
    gen.manual_seed(stream_seed(seed, 4))
    pool = []
    for i in order:
        side = float(np.sqrt(areas[i]))
        xy_lo = np.clip(hot[regions[i]] - side / 2, 0.0, 1.0 - side)
        length = shares[i] * span
        start = offsets[i] * (span - length)
        # snap both ends half-way between two arrival times, so a row's
        # time never lies on a bound in either precision
        t_lo = (np.floor(start / step) + 0.5) * step
        t_hi = min((np.floor((start + length) / step) + 0.5) * step,
                   corpus.now + 0.5 * step)
        lo = np.array([xy_lo[0], xy_lo[1], t_lo], np.float32)
        hi = np.array([xy_lo[0] + side, xy_lo[1] + side, t_hi], np.float32)
        rows = torch.randint(0, n, (b,), generator=gen,
                             device=corpus.x.device)
        q = corpus.x[rows] + float(traffic["query_noise"]) * torch.randn(
            (b, corpus.x.shape[1]), generator=gen, device=corpus.x.device)
        pool.append(Batch(q.cpu().numpy(), lo, hi))
    return pool
