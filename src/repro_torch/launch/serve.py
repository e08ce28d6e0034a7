"""Serving launcher: continuous-batched generation with random weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --smoke --requests 16 --slots 4 --device cpu

The flags are the reference launcher's plus ``--device`` (default: the
first CUDA card).  The encoder-decoder ``whisper-medium`` needs frames
at prefill, which the batcher does not carry: serve it with
``serving.serve_step.generate(..., extra=frames)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import ARCH_IDS, get_config
from ..device import resolve_device
from ..models import build_model, init_params
from ..serving.batching import ContinuousBatcher, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma3-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' runs the "
                         "kernels' plain twins)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = init_params(model.param_specs(), seed=0, device=dev)
    batcher = ContinuousBatcher(model, params, n_slots=args.slots,
                                max_len=args.max_len, eos_id=1)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.integers(4, 24))
        batcher.submit(Request(
            req_id=i, prompt=rng.integers(2, cfg.vocab, size=plen
                                          ).astype(np.int32),
            max_new=args.max_new))
    t0 = time.time()
    done = batcher.run_until_drained()
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens/dt:.1f} tok/s, {batcher.steps} decode ticks) on "
          f"{dev} with {cfg.name}")
    for r in done[:3]:
        print(f"  req {r.req_id}: {len(r.output)} tokens -> {r.output[:8]}…")
    return done


if __name__ == "__main__":
    main()
