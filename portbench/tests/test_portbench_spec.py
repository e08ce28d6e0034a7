"""BENCHMARK.json keeps to the contract's shape, names and characters, and
every name it gives has its file."""
import json
import re
from pathlib import Path

import pytest

from portbench import spec

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert TEXT.match(word) and not word.startswith("/") and ".." not in word
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and (ROOT / p).is_dir()
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_texts(bench):
    groups = [bench["configs"], bench["workloads"], bench["end_to_end"],
              bench["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        for name in names:
            assert NAME.match(name), name
    for e in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for p in bench["per_layer"]:
        assert TEXT.match(p["layer"])


def test_entries_have_exactly_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for e in bench["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in bench["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_name_finds_its_files(bench):
    e2e = {e["name"] for e in bench["end_to_end"]}
    assert "setup_s" in e2e
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        assert all(k in cfg for k in c["reduced"])
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], ROOT)
        names = {e["name"] for e in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer and cell.limits["bad_answers"] == 0
        for p in cell.per_layer:
            assert p["moves"] in names, (w["name"], p["name"])
            assert callable(spec.metric_reader(p["name"]))
    for p in bench["per_layer"]:
        assert p["moves"] in e2e
        if p["unit"] == "%" and "roofline" in p["name"]:
            assert p["name"].split(".")[0].endswith("_roofline")


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such.cell", ROOT)
