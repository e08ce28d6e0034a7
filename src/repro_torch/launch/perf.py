"""Hill-climb runner over dry-run cells: run an (arch x shape x mesh) cell
under a named optimization variant and report its roofline terms — the
counterpart of ``repro.launch.perf``.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch gemma3-1b \\
      --shape train_4k --mesh pod1 --variant sp_dots

Variants compose config-level levers (see models/common.py):
  baseline      paper-faithful defaults
  sp            sequence-parallel residual stream (Megatron-SP)
  dots          remat policy saving matmul outputs
  sp_dots       both
  qchunk512/qchunk2048   attention query-block size
  kv_heads      decode KV cache sharded over kv-heads instead of sequence
  cf10          MoE capacity factor 1.0 (tighter dispatch buffer)
  ssmchunk256   SSM scan chunk of 256
  localdisp     block-local MoE dispatch (``moe_local``)
  accumN        N-way gradient accumulation (train shapes)
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from ..configs import ARCH_IDS, SHAPES, get_config
from .dryrun import compile_cell, fake_world, roofline
from .mesh import make_production_mesh

PERF_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "experiments", "perf_torch")

VARIANTS = {
    "baseline": {},
    "sp": dict(seq_parallel=True),
    "dots": dict(remat_policy="dots"),
    "sp_dots": dict(seq_parallel=True, remat_policy="dots"),
    "qchunk512": dict(attn_q_chunk=512),
    "qchunk2048": dict(attn_q_chunk=2048),
    "kv_heads": dict(decode_shard="heads"),
    "cf10": dict(capacity_factor=1.0),
    "ssmchunk256": dict(ssm_chunk=256),
    "localdisp": dict(moe_local_dispatch=True),
    "localdisp_cf10": dict(moe_local_dispatch=True, capacity_factor=1.0),
}


def run_variant(arch: str, shape_name: str, mesh_kind: str, variant: str,
                accum: int = 1, skip_delta: bool = False, cfg=None,
                shape=None, mesh=None, chips: int = None):
    """One cell under ``variant``, recorded to ``PERF_DIR``.  ``cfg``,
    ``shape``, ``mesh`` and ``chips`` replace the production config, shape
    and mesh (a small cell); without ``mesh`` the default process group
    must hold the production mesh's ranks (``dryrun.fake_world``)."""
    overrides = VARIANTS[variant] if variant in VARIANTS else {}
    if variant.startswith("accum"):
        accum = int(variant[5:])
        overrides = {}
    cfg = dataclasses.replace(cfg or get_config(arch), **overrides)
    shape = shape or SHAPES[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=(mesh_kind == "pod2"),
                                    device_type="cpu")
    chips = chips or (512 if mesh_kind == "pod2" else 256)
    t0 = time.time()
    full = compile_cell(cfg, shape, mesh, accum=accum)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "variant": variant, "accum": accum, "full": full}
    if not skip_delta:
        rec["roofline"] = roofline(cfg, shape, mesh, chips)["roofline"]
    rec["wall_s"] = round(time.time() - t0, 1)
    os.makedirs(PERF_DIR, exist_ok=True)
    safe = arch.replace(".", "_")
    path = os.path.join(PERF_DIR,
                        f"{safe}__{shape_name}__{mesh_kind}__{variant}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--shape", choices=tuple(SHAPES), required=True)
    ap.add_argument("--mesh", choices=("pod1", "pod2"), default="pod1")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--skip-delta", action="store_true")
    args = ap.parse_args(argv)
    with fake_world(512 if args.mesh == "pod2" else 256):
        rec = run_variant(args.arch, args.shape, args.mesh, args.variant,
                          args.accum, args.skip_delta)
    m = rec["full"]["memory"]
    line = {
        "variant": args.variant,
        "peak_gb": round(m["peak_per_device_bytes"] / 1e9, 2),
        "fits": m["fits_hbm"],
        "coll_gb_full": round(rec["full"]["collectives"]["total"] / 1e9, 3),
    }
    if "roofline" in rec:
        ro = rec["roofline"]
        line.update(compute_s=round(ro["compute_s"], 4),
                    memory_s=round(ro["memory_s"], 4),
                    collective_s=round(ro["collective_s"], 4),
                    bottleneck=ro["bottleneck"],
                    useful=round(ro["useful_ratio"], 3))
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
