"""``python3 -m portbench.run`` prints no result where it cannot measure
the card."""
import shutil
from pathlib import Path

import pytest

from portbench import run, spec

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "fp32.wide", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


@pytest.fixture
def caches(monkeypatch):
    """``run`` points the build caches into the checkout; restore them."""
    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                 "TORCHINDUCTOR_CACHE_DIR"):
        monkeypatch.setenv(name, "unset")


def test_no_card_no_result(monkeypatch, capsys, caches):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(ARGS) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err


def test_fewer_cards_than_the_cell_asks(monkeypatch, capsys, caches):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_a_directory_of_the_benchmark_alone(tmp_path, monkeypatch, capsys):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    assert run.main(ARGS) != 0
    assert capsys.readouterr().out == ""


def test_caches_live_at_fixed_paths_in_the_checkout(caches):
    import os
    run.use_checkout_caches(ROOT)
    for name in ("TRITON_CACHE_DIR", "TORCH_EXTENSIONS_DIR",
                 "TORCHINDUCTOR_CACHE_DIR"):
        assert os.environ[name].startswith(str(ROOT / "build"))
