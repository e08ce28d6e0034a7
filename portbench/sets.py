"""Run sets of benchmark runs in one call, and summarise their spreads.

    python3 -m portbench.sets --out chiprun_out/sets.jsonl \\
        --runs fp32.wide:11:0,fp32.wide:12:0,fp32.wide:13:1 --seconds 20
    python3 -m portbench.sets --summary chiprun_out/a.jsonl chiprun_out/b.jsonl

Each run is a process of its own (``python3 -m portbench.run``), one at a
time.  Every run appends one JSON line to ``--out``: the workload, seed,
trace flag, exit code, wall seconds, the parsed result line and the end of
standard error.  ``--summary`` reads such files as sets and prints, per
cell and metric, each set's median and quartile spread
(``statistics.quantiles(values, n=4)``, as a share of the median), the
wider of the spreads, and five times it: the bound's first estimate.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

from .stats import spread

ROOT = Path(__file__).resolve().parent.parent


def run_one(workload: str, seed: int, trace: int, seconds: float,
            timeout: float) -> dict:
    cmd = [sys.executable, "-m", "portbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace",
           str(trace)]
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=timeout)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = 124, exc.stdout or "", exc.stderr or ""
        out = out.decode() if isinstance(out, bytes) else out
        err = err.decode() if isinstance(err, bytes) else err
    wall = time.perf_counter() - t0
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace, "rc": rc,
            "wall_s": wall, "result": result, "stderr": err[-3000:]}


def summarise(paths) -> None:
    sets = []
    for path in paths:
        per = defaultdict(lambda: defaultdict(list))
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                res = rec.get("result") or {}
                for name, mv in (res.get("metrics") or {}).items():
                    per[rec["workload"]][name].append(mv["value"])
        sets.append(per)
    cells = sorted({c for per in sets for c in per})
    for cell in cells:
        names = sorted({n for per in sets for n in per.get(cell, {})})
        for name in names:
            parts, widest = [], 0.0
            for per in sets:
                vals = per.get(cell, {}).get(name, [])
                if len(vals) >= 2:
                    sp = spread(vals)
                    widest = max(widest, sp)
                    parts.append(f"median {statistics.median(vals):.6g} "
                                 f"spread {sp:.4f} (n={len(vals)})")
            print(f"{cell} {name}: " + "; ".join(parts)
                  + f"; widest {widest:.4f}, 5x {5 * widest:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sets")
    ap.add_argument("--runs", help="workload:seed:trace,...")
    ap.add_argument("--seconds", type=float, default=20)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("--out")
    ap.add_argument("--summary", nargs="*")
    args = ap.parse_args(argv)
    if args.summary:
        summarise(args.summary)
        return 0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for item in args.runs.split(","):
        workload, seed, trace = item.split(":")
        rec = run_one(workload, int(seed), int(trace), args.seconds,
                      args.timeout)
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        res = rec["result"] or {}
        short = {n: round(v["value"], 6)
                 for n, v in (res.get("metrics") or {}).items()}
        print(f"{workload} seed {seed} trace {trace}: rc {rec['rc']}, "
              f"{rec['wall_s']:.1f} s, correct {res.get('correct')}, "
              f"{short}, checks {res.get('checks')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
