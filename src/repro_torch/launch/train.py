"""End-to-end training driver with checkpoints and resume — the
counterpart of ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --steps 100 --ckpt-dir /tmp/ckpt --device cpu

The flags are the reference launcher's plus ``--device`` (default: the
first CUDA card; the launcher raises when there is none).  Weights are
drawn from seed 0 by the port's ``init_params``, batches come from the
synthetic learnable stream (seed 0), and a run with ``--ckpt-dir``
resumes from the latest valid checkpoint there: its state restored onto
the device (bf16 leaves through the manifest's dtype) and the data
cursor from the manifest.
"""
from __future__ import annotations

import argparse
import hashlib
import time

import torch

from ..configs import ARCH_IDS, get_config
from ..data.pipeline import DataConfig, PrefetchingLoader, SyntheticTokenPipeline
from ..device import resolve_device
from ..models import build_model, init_params
from ..training.checkpoint import CheckpointManager
from ..training.fault_tolerance import FaultTolerantRunner, HeartbeatMonitor
from ..training.optimizer import OptConfig
from ..training.train_step import init_train_state, make_train_step


def to_device(batch, dev: torch.device):
    """numpy batch -> tensors on ``dev`` (through pinned memory, copied
    without blocking, when ``dev`` is a card)."""
    out = {}
    for k, a in batch.items():
        t = torch.from_numpy(a)
        out[k] = (t.pin_memory().to(dev, non_blocking=True)
                  if dev.type == "cuda" else t.to(dev))
    return out


def batch_digest(batch) -> str:
    """sha256 over the batch's arrays in key order (the resume audit)."""
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(batch[k].tobytes())
    return h.hexdigest()


def main(argv=None) -> dict:
    """Train; returns ``{"state", "losses": {step: loss}, "batches":
    {step: digest}, "resumed_from": step or None}``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="codeqwen1.5-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--schedule", default="cosine",
                    choices=("cosine", "wsd", "const"))
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0; 'cpu' runs on the "
                         "CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    model = build_model(cfg)
    params = init_params(model.param_specs(), seed=0, device=dev)
    state = init_train_state(params)
    opt_cfg = OptConfig(lr=args.lr, schedule=args.schedule,
                        warmup_steps=max(args.steps // 20, 1),
                        total_steps=args.steps)
    step_fn = make_train_step(model, opt_cfg, args.accum)

    pipe = SyntheticTokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch, seed=0))

    start_step = 0
    resumed_from = None
    runner = None
    if args.ckpt_dir:
        cm = CheckpointManager(args.ckpt_dir)
        runner = FaultTolerantRunner(cm, HeartbeatMonitor(hosts=[0]),
                                     ckpt_every=args.ckpt_every)
        restored, manifest = cm.restore(state)
        if restored is not None:
            state = restored
            start_step = manifest["extra"]["data_step"]
            resumed_from = manifest["step"]
            print(f"[resume] restored step {manifest['step']}, "
                  f"data cursor {start_step}")

    losses, digests = {}, {}
    loader = PrefetchingLoader(pipe, start_step=start_step)
    t_start = time.time()
    try:
        for i in range(start_step, args.steps):
            step_i, batch = next(loader)
            digests[step_i] = batch_digest(batch)
            t0 = time.time()
            state, metrics = step_fn(state, to_device(batch, dev))
            dt = time.time() - t0
            losses[i] = metrics["loss"]
            if runner:
                runner.monitor.beat(0, step_time_s=dt)
                runner.maybe_checkpoint(i, state, data_step=step_i + 1)
            if i % args.log_every == 0 or i == args.steps - 1:
                tok_s = args.batch * args.seq / max(dt, 1e-9)
                print(f"step {i:5d} loss {float(metrics['loss']):.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"{tok_s:,.0f} tok/s", flush=True)
    finally:
        loader.close()
    print(f"done: {args.steps - start_step} steps in "
          f"{time.time() - t_start:.1f}s on {dev} with {cfg.name}")
    return {"state": state, "losses": {i: float(v) for i, v in losses.items()},
            "batches": digests, "resumed_from": resumed_from}


if __name__ == "__main__":
    main()
