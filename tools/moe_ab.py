#!/usr/bin/env python3
"""Time qwen2-moe-a2.7b's serving run of one source tree of the
PyTorch/CUDA port on one CUDA card, for A/B comparisons of two trees in
one machine.

    python3 tools/moe_ab.py --tree .            # this checkout
    python3 tools/moe_ab.py --tree build/parent # e.g. an unpacked
                                                # `git archive` of a parent

It imports ``chip_smoke`` and ``repro_torch`` from ``<tree>`` (so run one
process per tree, alternating: parent, change, change, parent) and runs
that tree's phase-7b serving run of qwen2-moe-a2.7b (``main_family``: the
batcher, 8 requests, published width in bf16, random weights from the
smoke's seed) ``--reps`` times, the first of them a warm-up.  After each
run it prints one line ``AB {json}`` with the tree, the run's index and
the smoke's numbers: prefill ms per request, the decode step's mean and
median ms (host clock), the traced step's device ms and idle share,
tokens/s and the MoE's dropped share.  Both trees time the same work
only when their ``main_family`` instruments it the same way.
"""
import argparse
import json
import os
import sys

KEYS = ("prefill_ms_per_request", "step_ms_mean", "step_ms_p50",
        "device_ms_step", "idle_share", "tokens_per_s", "moe_dropped_share")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=".")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, os.path.join(tree, "src"))
    sys.path.insert(0, tree)
    import torch
    import chip_smoke as cs
    if hasattr(cs, "load_peaks"):
        cs.load_peaks()
    arch = "qwen2-moe-a2.7b"
    spec = dict(cs.FAMILIES)[arch]
    for rep in range(args.reps):
        r = cs.main_family(torch, torch.device("cuda:0"), arch, spec,
                           cs.SEED, {})
        n = r["numbers"]
        print("AB", json.dumps({"tree": args.tree, "rep": rep,
                                **{k: n.get(k) for k in KEYS}}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
