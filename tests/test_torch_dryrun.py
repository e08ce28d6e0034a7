"""The dry-run machinery of the port on a small fake mesh — the
counterpart of ``tests/test_dryrun_small.py``.

One subprocess (so the test worker keeps no process group) opens a
``fake`` process group of 8 ranks and, on a (2, 4) ("data", "model")
``DeviceMesh``, runs under ``FakeTensorMode``:

- the train (32, 8) and decode (64, 8) cells of the six architectures of
  the reference's test at smoke size: each must run (``status == "ok"``)
  with ``flops > 0`` and ``temp_bytes > 0``;
- a hand-built row-parallel matmul (``x`` sharded on its contraction dim
  over "model", the weight on its rows): ``collective_bytes`` must count
  exactly one all-reduce of the ``[b, s, d]`` fp32 output;
- ``perf.run_variant`` on qwen2-moe's smoke train cell with the
  ``baseline``, ``sp`` and ``localdisp`` variants (records written to a
  temporary directory): each runs, and each variant changes what the
  cell does.

``depth_delta`` and ``roofline_terms`` are held to the reference's on the
same numbers, in process (pure arithmetic).
"""
import json
import math
import os
import subprocess
import sys

import pytest

from repro.distributed import hlo_analysis as jh
from repro_torch.distributed import hlo_analysis as th

ARCHS = ["codeqwen1.5-7b", "qwen2-moe-a2.7b", "falcon-mamba-7b",
         "zamba2-2.7b", "whisper-medium", "internvl2-2b"]

SCRIPT = r"""
import json, sys, traceback
import torch
torch.set_num_threads(1)
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Shard, distribute_tensor
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed.hlo_analysis import CostCounter, collective_bytes
from repro_torch.launch import perf
from repro_torch.launch.dryrun import compile_cell, fake_world

archs, tmp = json.loads(sys.argv[1]), sys.argv[2]
out = {}
with fake_world(8):
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        for kind, shape in (("train", ShapeSpec("t", "train", 32, 8)),
                            ("decode", ShapeSpec("d", "decode", 64, 8))):
            try:
                rec = compile_cell(cfg, shape, mesh)
                out[f"{arch}/{kind}"] = {
                    "status": "ok",
                    "collective_ops": rec["collectives"]["count"],
                    "flops": rec["cost"]["flops"],
                    "temp": rec["memory"]["temp_bytes"],
                    "peak": rec["memory"]["peak_per_device_bytes"]}
            except Exception as e:
                out[f"{arch}/{kind}"] = {
                    "status": "error",
                    "error": traceback.format_exc()[-2000:]}
    # a row-parallel matmul: x [b, s, k] sharded on k, w [k, d] on rows
    b, s, k, d = 2, 8, 16, 12
    m1 = init_device_mesh("cpu", (8,), mesh_dim_names=("model",))
    with FakeTensorMode() as fake:
        x = distribute_tensor(torch.zeros(b, s, k), m1, [Shard(2)])
        w = distribute_tensor(torch.zeros(k, d), m1, [Shard(0)])
        counter = CostCounter(fake)
        with counter:
            y = torch.matmul(x, w).full_tensor()
    out["row_parallel"] = {"coll": collective_bytes(counter.collectives),
                           "records": counter.collectives,
                           "hand": b * s * d * 4, "flops": counter.flops,
                           "hand_flops": 2 * b * s * (k // 8) * d}
    perf.PERF_DIR = tmp
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    shape = ShapeSpec("t", "train", 32, 8)
    for variant in ("baseline", "sp", "localdisp"):
        rec = perf.run_variant("qwen2-moe-a2.7b", "t", "2x4", variant,
                               cfg=cfg, shape=shape, mesh=mesh, chips=8,
                               skip_delta=(variant != "baseline"))
        out[f"variant/{variant}"] = {
            "flops": rec["full"]["cost"]["flops"],
            "bytes": rec["full"]["cost"]["bytes"],
            "coll": rec["full"]["collectives"]["total"],
            "count": rec["full"]["collectives"]["count"],
            "roofline": rec.get("roofline")}
print("RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    tmp = str(tmp_path_factory.mktemp("perf"))
    r = subprocess.run([sys.executable, "-c", SCRIPT, json.dumps(ARCHS),
                        tmp], capture_output=True, text=True, env=env,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_small_mesh(results, arch, kind):
    rec = results[f"{arch}/{kind}"]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["flops"] > 0
    assert rec["temp"] > 0
    assert rec["peak"] >= rec["temp"]


def test_collective_bytes_row_parallel_matmul(results):
    r = results["row_parallel"]
    assert r["coll"]["count"] == 1, r["records"]
    assert r["coll"]["all-reduce"] == r["hand"]
    assert r["coll"]["total"] == r["hand"]
    assert r["records"][0]["shape"] == [2, 8, 12]
    assert r["records"][0]["dtype"] == "float32"
    # per device: one rank's [16, 2] x [2, 12] local product
    assert r["flops"] == r["hand_flops"]


def test_run_variant_baseline_sp_localdisp(results):
    base, sp, loc = (results[f"variant/{v}"]
                     for v in ("baseline", "sp", "localdisp"))
    for rec in (base, sp, loc):
        assert rec["flops"] > 0 and rec["bytes"] > 0
    ro = base["roofline"]
    assert ro["bottleneck"] in ("compute", "memory", "collective")
    assert 0 < ro["useful_ratio"]
    # each lever changes the cell: SP redistributes the residual stream,
    # the block-local dispatch sorts per data-parallel block
    assert (sp["coll"], sp["count"]) != (base["coll"], base["count"])
    assert (loc["flops"], loc["bytes"], loc["coll"]) != \
        (base["flops"], base["bytes"], base["coll"])


COSTS = [({"flops": 10.0, "bytes": 4.0}, {"flops": 17.0, "bytes": 9.5},
          {"total": 100}, {"total": 160}, 1, 26),
         ({"flops": 3.5e12, "bytes": 2.25e11}, {"flops": 4.75e12,
                                                "bytes": 3.0e11},
          {"total": 7.0e9}, {"total": 9.5e9}, 1, 48)]


@pytest.mark.parametrize("case", range(len(COSTS)))
def test_depth_delta_and_roofline_equal_reference(case):
    c1, c2, k1, k2, u, depth = COSTS[case]
    got = th.depth_delta(c1, c2, k1, k2, u, depth)
    assert got == jh.depth_delta(c1, c2, k1, k2, u, depth)
    for per_device in (True, False):
        args = (got["flops"], got["bytes"], got["collective_bytes"], 256,
                989.4e12, 3.35e12, 450e9)
        a = th.roofline_terms(*args, per_device=per_device)
        b = jh.roofline_terms(*args, per_device=per_device)
        assert a == b
        assert math.isfinite(a["compute_s"])
