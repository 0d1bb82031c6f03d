"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import hashlib
import json
import re

import pytest

from conftest import ROOT
from portbench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200 and NAME.match(w["traffic"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_config_is_used_and_pairs_are_unique():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_to_its_files(cell):
    c = spec.load_cell(cell)
    assert c.driver().run
    assert c.limits and all(v > 0 for v in c.limits.values())
    names = [m.name for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    reported = set(names)
    for m in c.per_layer:
        assert m.entry["moves"] in reported, (cell, m.name)
        assert callable(m.read)


def test_per_layer_metrics_move_a_metric_their_cells_report():
    for m in BENCH["per_layer"]:
        moves = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m.get("workloads", CELLS):
            assert "workloads" not in moves or cell in moves["workloads"], (m["name"], cell)


def test_a_cell_added_as_files_runs_with_no_edit(tiny_root):
    """The tiny cells are new files and entries only; every file the
    benchmark had is byte for byte the same, and the cells resolve."""
    def digests(root):
        return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
                for p in (root / "portbench").rglob("*") if p.is_file()
                and "__pycache__" not in p.parts}

    before, after = digests(ROOT), digests(tiny_root)
    assert all(after[p] == d for p, d in before.items())
    added = set(after) - set(before)
    assert {p.name for p in added} >= {"tiny.json", "tiny_offline.json", "tiny-score.json"}
    for cell in ("tiny-score", "tiny-qknorm-score", "tiny-serve"):
        c = spec.load_cell(cell, tiny_root)
        assert c.per_layer and any(m.name == "setup_s" for m in c.end_to_end)
