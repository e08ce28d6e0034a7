"""No module of the benchmark imports JAX, the JAX package or the old
benchmarks; top-level names are compared whole."""
import ast
from pathlib import Path

import pytest

from portbench.guard import FORBIDDEN, forbidden_modules

HERE = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("names,found", [
    (["repro_torch", "repro_torch.streaming", "numpy"], []),
    (["repro", "torch"], ["repro"]),
    (["repro.core.filters"], ["repro"]),
    (["jaxlib.xla_client", "jax"], ["jax", "jaxlib"]),
    (["jaxtyping", "flaxen", "reprox", "benchmarks_old"], []),
    (["flax.linen", "benchmarks.common"], ["benchmarks", "flax"]),
])
def test_top_level_names_compared_whole(names, found):
    assert forbidden_modules(names) == found


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_benchmark_sources_import_nothing_forbidden():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "judge.py", "data.py", "generator.py",
                 "peaks.py", "stats.py"):
        tops = {n.split(".")[0] for n in _imports(HERE / name)}
        assert "repro_torch" not in tops, name
