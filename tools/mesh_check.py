#!/usr/bin/env python3
"""Check the shard mesh across every visible CUDA card: the smoke's
retrieval phases up to the mesh phase, and the card tests.

    python3 tools/mesh_check.py                  # the mesh's card test
    python3 tools/mesh_check.py --all-card-tests # every card test
    python3 tools/mesh_check.py --n-sharded 20000 --no-card-tests

Run it on a host with several cards (e.g. four H100s) to exercise the
copies between cards, which ``chip_smoke.py`` on one card cannot: its
phase 5e then runs two mesh entries on one card.  The script builds B1,
B2, B3 and B4 from the checkout, runs ``tests/test_torch_cuda.py``'s
``cuda``-marked mesh test (or all of them) in a subprocess, then
``chip_smoke``'s phases 3 (the 1M x 768 scan, whose data phase 5e
reuses), 5b (the sharded fp32 and int8 managers, ``--n-sharded`` points
each), 5c (their snapshots) and 5e (the managers restored on a mesh of
every visible card and held bit for bit to one card, per-card launches,
and the 1M scan and forced-graph hop timed on the mesh and on one card).
Every check is the smoke's own, so a mismatch exits non-zero.  The last
line is one JSON object: the card count, the card tests' exit code and
summary, the phase times and phase 5e's numbers.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_tests(expr: str) -> tuple:
    """``pytest -m cuda tests/test_torch_cuda.py -k expr`` in a subprocess
    (the suite's conftest imports jax, so it is not loaded).  Returns
    ``(exit code, summary line)``."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-q",
           "-p", "no:cacheprovider", "-m", "cuda", "tests/test_torch_cuda.py"]
    if expr:
        cmd += ["-k", expr]
    r = subprocess.run(cmd, cwd=HERE, capture_output=True, text=True,
                       env=dict(os.environ, PYTHONPATH="src"), timeout=900)
    print(r.stdout[-4000:], r.stderr[-2000:], flush=True)
    lines = [ln for ln in r.stdout.splitlines() if ln.strip()]
    return r.returncode, lines[-1] if lines else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n-sharded", type=int, default=None,
                    help="points of each phase-5b manager (default: the "
                         "smoke's N_SHARDED)")
    ap.add_argument("--all-card-tests", action="store_true",
                    help="run every cuda-marked test, not only the mesh's")
    ap.add_argument("--no-card-tests", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(HERE, "src"))
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("mesh_check: no CUDA card", file=sys.stderr)
        return 2
    cs.load_peaks()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    t_start = time.perf_counter()
    print(cs.smi_line(), f"cards {torch.cuda.device_count()}, torch "
          f"{torch.__version__}", flush=True)
    from repro_torch.kernels import _build
    _build.build(["filtered_topk", "distance", "quant_topk", "graph_step"])
    out = {"cards": torch.cuda.device_count(),
           "build_s": time.perf_counter() - t_start}
    if not args.no_card_tests:
        t0 = time.perf_counter()
        rc, summary = card_tests("" if args.all_card_tests else "mesh")
        out.update(card_tests_rc=rc, card_tests=summary,
                   card_tests_s=time.perf_counter() - t0)
    n5b = cs.N_SHARDED if args.n_sharded is None else args.n_sharded
    errs = {"filtered_topk": 0.0, "pairwise_dist": 0.0}
    keep: dict = {}
    phase_s = {}
    t0 = time.perf_counter()
    with cs.Phase("3 exact filtered scan", torch):
        cs.main_scan(torch, dev, cs.N_SCAN, cs.D, cs.QUERIES, cs.SEED, errs,
                     keep)
    phase_s["3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with cs.Phase("5b sharded streaming", torch):
        cs.main_sharded(torch, dev, n5b, cs.D, cs.QUERIES, cs.SEED, keep)
    phase_s["5b"] = time.perf_counter() - t0
    root = tempfile.mkdtemp(prefix="cubegraph-mesh-")
    try:
        t0 = time.perf_counter()
        with cs.Phase("5c durability and tiering", torch):
            cs.main_durability(torch, dev, keep, cs.QUERIES, root)
        phase_s["5c"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with cs.Phase("5e shard mesh", torch):
            mesh_run = cs.main_shard_mesh(torch, dev, keep, root, cs.SEED)
        phase_s["5e"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out.update(n_sharded=n5b, phase_s=phase_s, mesh=mesh_run,
               total_s=time.perf_counter() - t_start)
    print(json.dumps(out, default=str), flush=True)
    return 1 if out.get("card_tests_rc", 0) else 0


if __name__ == "__main__":
    sys.exit(main())
