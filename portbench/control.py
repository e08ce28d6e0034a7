"""The control: the reference put in the program's place one precision
step below the configuration, judged exactly as a run judges the program.

    python3 -m portbench.control --workload fp32.wide --seeds 1,2,3 --kinds tf32
    python3 -m portbench.control --workload int8.wide --seeds 1,2,3 --kinds tf32,int4

At the cell's own size (its corpus, deletes and pool of batches, from
each seed), every pool batch is answered once by :func:`reference.
control_topk` and held against the exact reference with ``judge.py``.
``exact`` answers with the reference itself (fp64 distances cast to
fp32), as a check of the judge.  One JSON line per seed and kind: the
numbers, and whether the cell's limits find the answers correct.  The
control has to come out as not correct.  Runs on the card (``--device``,
default ``cuda:0``); no program runs, so it needs no build.
"""
from __future__ import annotations

import argparse
import json
import sys

from . import data, generator, judge, reference, spec


def control_numbers(cell: spec.Cell, seed: int, kinds, device) -> dict:
    import torch
    cfg, k = cell.config, int(cell.config["k"])
    corpus = data.make_corpus(cfg, seed, device)
    deleted = data.pick_deletes(corpus, cfg, seed)
    alive = data.live_mask(corpus, deleted)
    pool = generator.make_pool(cell.traffic, cfg, corpus, seed)
    tallies = {kind: judge.Tally() for kind in kinds}
    for bt in pool:
        truth = judge.truth_for(corpus.x, corpus.meta, alive, bt.queries,
                                bt.lo, bt.hi, k)
        for kind in kinds:
            if kind == "exact":
                ids, dd = truth.ids, truth.dists.float()
            else:
                ids, dd = reference.control_topk(
                    kind, corpus.x, corpus.meta, alive, truth.q, bt.lo,
                    bt.hi, k, int(cfg["stream"].get("rerank_multiple", 4)))
            judge.judge_answer(tallies[kind], corpus.x, truth,
                               ids.cpu().numpy(), dd.cpu().numpy())
        del truth
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    out = {}
    for kind, t in tallies.items():
        ok, checks = judge.verdict(t.numbers(), cell.limits)
        out[kind] = {"correct": ok, "numbers": t.numbers(),
                     "checks": checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="tf32")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    kinds = args.kinds.split(",")
    for seed in (int(s) for s in args.seeds.split(",")):
        res = control_numbers(cell, seed, kinds, args.device)
        for kind, r in res.items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
