"""The corpus of a configuration, made on the device from ``--seed``.

Frozen copies, so that a later change to the program cannot move the
yardstick:

* the vectors follow ``src/repro_torch/core/workloads.py::make_dataset``
  (a mixture of 32 Gaussian clusters, noise 0.3), drawn on the device as
  its ``make_dataset_device`` does;
* lon / lat follow ``src/repro_torch/serving/workload.py``'s
  ``_HOT_REGIONS = ((2, 2), (7, 6), (4.5, 8))`` and ``_REGION_WEIGHTS =
  (0.65, 0.25, 0.10)`` with a spread of 1.5, rescaled from its 10 x 10 map
  to the unit square (the configuration file holds the rescaled numbers);
* time is arrival order: row ``i`` of ``n`` has ``t = (i + 1) / n``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

BLOCK = 1 << 16          # rows per noise draw: bounds the temporary


def stream_seed(seed: int, tag: int) -> int:
    """A 63-bit seed of its own for each use of ``--seed``."""
    state = np.random.SeedSequence([int(seed) % (1 << 64), tag])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


@dataclasses.dataclass
class Corpus:
    """``x`` [n, d] fp32 and ``meta`` [n, m] fp32 on the device; the host
    copies handed to the program; the newest arrival time."""

    x: torch.Tensor
    meta: torch.Tensor
    x_host: np.ndarray
    s_host: np.ndarray
    now: float

    @property
    def n(self) -> int:
        return self.x.shape[0]


def make_corpus(cfg: dict, seed: int, device, n: int = None) -> Corpus:
    """The configuration's corpus for ``seed`` (``n`` rows; default
    ``live_rows``).  The live set is worked out here from the rows and the
    deletes alone, so a configuration with a TTL is refused."""
    if "ttl" in cfg["stream"]:
        raise ValueError("the benchmark's live set assumes no TTL")
    n = int(cfg["live_rows"]) if n is None else int(n)
    d, dc = int(cfg["d"]), cfg["data"]
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 1))
    n_clusters = min(int(dc["clusters"]), max(2, n // 64))
    centers = torch.randn((n_clusters, d), generator=gen, device=device)
    assign = torch.randint(0, n_clusters, (n,), generator=gen, device=device)
    x = torch.empty((n, d), device=device)
    for lo in range(0, n, BLOCK):
        hi = min(lo + BLOCK, n)
        x[lo:hi] = centers[assign[lo:hi]] + dc["cluster_noise"] * torch.randn(
            (hi - lo, d), generator=gen, device=device)
    hot = torch.tensor(dc["hot_regions"], dtype=torch.float32, device=device)
    w = torch.tensor(dc["region_weights"], dtype=torch.float32, device=device)
    region = torch.multinomial(w, n, replacement=True, generator=gen)
    lonlat = (hot[region] + dc["region_sigma"] * torch.randn(
        (n, 2), generator=gen, device=device)).clamp_(0.0, 1.0)
    t = (np.arange(n, dtype=np.float64) + 1.0) / n
    s_host = np.concatenate([lonlat.cpu().numpy().astype(np.float64),
                             t[:, None]], axis=1)
    meta = torch.as_tensor(s_host.astype(np.float32), device=device)
    now = float(t[-1])
    return Corpus(x=x, meta=meta, x_host=x.cpu().numpy(), s_host=s_host,
                  now=now)


def pick_deletes(corpus: Corpus, cfg: dict, seed: int) -> np.ndarray:
    """Row ids to delete: ``delete_fraction`` of the rows, drawn from the
    seed."""
    rng = np.random.default_rng(stream_seed(seed, 2))
    n_del = int(corpus.n * float(cfg["delete_fraction"]))
    return np.sort(rng.choice(corpus.n, size=n_del, replace=False))


def live_mask(corpus: Corpus, deleted: np.ndarray) -> torch.Tensor:
    """The benchmark's own live set: every row it ingested, less the
    deletes it handed to the program."""
    alive = np.ones(corpus.n, bool)
    alive[deleted] = False
    return torch.as_tensor(alive, device=corpus.x.device)
