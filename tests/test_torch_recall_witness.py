"""Index recall of both packages on one workload, and the port's chunked
candidate gather.

Both packages build a CubeGraph index from the same numpy data and answer
the recipe of ``chip_smoke.py``'s index phase (m = 3, k = 10, ef = 128; box,
ball and box-minus-ball filters at the given ratios, planner on ``auto``).
The ground truth is an exact float64 scan.  As a test it runs at a small
size; as a script it runs at n = 20,000, d = 768 and prints one line per
leg, with the reference on the CPU and the port on the CPU, or with the
port alone on a CUDA card:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_recall_witness.py
    PYTHONPATH=src python tests/test_torch_recall_witness.py cuda

The script's reference build uses 512 x 512 gather chunks (the default
2048 x 2048 gather is 12.9 GB at d = 768); chunking changes no kept
neighbour beyond exact ties, which ``test_gather_chunking_keeps_neighbours``
checks for the port.
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

import repro_torch.core as tc
from repro_torch.core import graph as tgraph
from repro_torch.core import workloads as tw

torch.set_num_threads(1)

M, K = 3, 10
LEGS = ("box", "ball", "compose")      # make_<leg>_filter in both packages
# ratio 0.5 at n = 20k passes as many points (10k) as ratio 0.1 does at
# the smoke's n = 100k
SCRIPT_N, SCRIPT_D, SCRIPT_Q, SCRIPT_RATIOS = 20_000, 768, 1000, (0.01, 0.1,
                                                                   0.5)


def workload(n, d, nq, seed=0):
    x, s = tw.make_dataset(n, d, M, seed=seed)
    rng = np.random.default_rng(seed + 1)
    q = x[rng.integers(0, n, nq)] + 0.05 * rng.normal(
        size=(nq, d)).astype(np.float32)
    return x, s, q


def exact_truth(x, s, q, filt):
    """Exact filtered top-K ids in float64, one query block at a time."""
    ok = np.nonzero(filt.contains(torch.as_tensor(s)).numpy())[0]
    out = np.full((len(q), K), -1, np.int64)
    if len(ok) == 0:
        return out
    xv = x[ok].astype(np.float64)
    xn = (xv ** 2).sum(1)
    kk = min(K, len(ok))
    for lo in range(0, len(q), 64):
        qb = q[lo:lo + 64].astype(np.float64)
        dd = (qb ** 2).sum(1)[:, None] - 2.0 * qb @ xv.T + xn[None, :]
        order = np.argsort(dd, axis=1, kind="stable")[:, :kk]
        out[lo:lo + 64, :kk] = ok[order]
    return out


def port_recalls(x, s, q, ratios, device="cpu", seed=0, ef=128):
    """``{(ratio, leg): (planner mode, recall@K)}`` of the port."""
    index = tc.CubeGraphIndex.build(x, s, tc.CubeGraphConfig(),
                                    device=device)
    out = {}
    for ratio in ratios:
        for leg in LEGS:
            f = getattr(tw, f"make_{leg}_filter")(M, ratio, seed=seed)
            ids, _, st = index.query(q, f, k=K, ef=ef, return_stats=True)
            out[ratio, leg] = (st.mode, tw.recall(ids, exact_truth(x, s, q,
                                                                   f)))
    return out


def reference_recalls(x, s, q, ratios, seed=0, ef=128, chunk=None):
    """``{(ratio, leg): recall@K}`` of the JAX package."""
    import repro.core as jc
    from repro.core import workloads as jw
    cfg = (jc.CubeGraphConfig() if chunk is None else
           jc.CubeGraphConfig(point_chunk=chunk, col_chunk=chunk))
    index = jc.CubeGraphIndex.build(x, s, cfg)
    out = {}
    for ratio in ratios:
        for leg in LEGS:
            f = getattr(jw, f"make_{leg}_filter")(M, ratio, seed=seed)
            pf = getattr(tw, f"make_{leg}_filter")(M, ratio, seed=seed)
            ids, _ = index.query(q, f, k=K, ef=ef)
            out[ratio, leg] = jw.recall(ids, exact_truth(x, s, q, pf))
    return out


def test_recall_matches_reference_on_smoke_recipe():
    x, s, q = workload(1500, 48, 32)
    ref = reference_recalls(x, s, q, (0.1,))
    for key, (mode, r_t) in port_recalls(x, s, q, (0.1,)).items():
        assert r_t >= ref[key] - 0.01, (key, mode, ref[key], r_t)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_chunking_keeps_neighbours(monkeypatch, metric):
    """A gather cap of a few columns gives the same neighbours, in the
    same order, as one gather of every candidate.  Distances agree to fp32
    rounding: the batched product's summation order depends on its width."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(400, 24)).astype(np.float32))
    x[200:210] = x[:10]                         # exact ties
    cand = rng.integers(-1, 400, size=(64, 300))
    qv = x[:64] + 0.01
    norms = tgraph.squared_norms(x)
    whole = tgraph.topk_over_candidates(qv, cand, x, norms, 20,
                                        exclude=np.arange(64),
                                        col_chunk=300, metric=metric)
    monkeypatch.setattr(tgraph, "GATHER_BYTES", 7 * 64 * 24 * 4)
    chunked = tgraph.topk_over_candidates(qv, cand, x, norms, 20,
                                          exclude=np.arange(64),
                                          col_chunk=300, metric=metric)
    assert torch.equal(whole[0], chunked[0])
    tol = 1e-5 * float((qv ** 2).sum(1).max() + norms.max())
    assert torch.allclose(whole[1], chunked[1], rtol=0, atol=tol)


if __name__ == "__main__":
    device = sys.argv[1] if len(sys.argv) > 1 else "cpu"
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.perf_counter()
    x, s, q = workload(SCRIPT_N, SCRIPT_D, SCRIPT_Q)
    port = port_recalls(x, s, q, SCRIPT_RATIOS, device=device)
    ref = (reference_recalls(x, s, q, SCRIPT_RATIOS, chunk=512)
           if device == "cpu" else {})
    where = (torch.cuda.get_device_name(0) if device.startswith("cuda")
             else "cpu")
    for (ratio, leg), (mode, r_t) in port.items():
        r_j = f"{ref[ratio, leg]:.4f}" if ref else "not run"
        print(f"n={SCRIPT_N} d={SCRIPT_D} ratio={ratio} {leg} ({mode}): "
              f"recall@{K} reference {r_j} port ({where}) {r_t:.4f}",
              flush=True)
    print(f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
