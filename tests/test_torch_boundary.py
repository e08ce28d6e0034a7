"""Import boundary of the port: ``repro_torch`` and ``chip_smoke.py`` import
neither ``jax`` nor the JAX package ``repro`` (only these parity tests load
both)."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call):
            # importlib.import_module("...") / __import__("...")
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", "")
            if name in ("import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str) and \
                    _forbidden(node.args[0].value):
                bad.append(node.args[0].value)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch, repro_torch.core, repro_torch.kernels, "
            "repro_torch.obs, repro_torch.streaming, repro_torch.quant, "
            "repro_torch.distributed, repro_torch.kernels.graph_topk, "
            "repro_torch.streaming.planner, repro_torch.kernels.flash_decode, "
            "repro_torch.core.baselines, repro_torch.streaming.persistence, "
            "repro_torch.streaming.tiering, repro_torch.streaming.chaos, "
            "repro_torch.serving.tenancy, repro_torch.serving.service, "
            "repro_torch.serving.workload, "
            "repro_torch.configs, repro_torch.models, repro_torch.serving, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun, "
            "repro_torch.launch.perf, repro_torch.training.compression, "
            "repro_torch.distributed.hints, repro_torch.distributed.sharding, "
            "repro_torch.distributed.hlo_analysis\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n"
            "print('clean')")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
