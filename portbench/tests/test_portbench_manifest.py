"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration, a traffic mix, a metric and a cell by name."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.smoke import SMOKE, rehearse, smoke_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = BENCH["workloads"]
    assert 1 <= len(cells) <= 24 and 1 <= len(BENCH["configs"]) <= 24
    # 2 + 14 runs a cell at run_seconds + 60 s, 2 x 90 s a cell to compile,
    # 1200 s spare, for the full 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]


def test_names_units_and_text_fields():
    names = list(_names())
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in BENCH["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")


def test_bounds_and_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:  # setup_s and one more end-to-end metric in every cell
        names = {m["name"] for m in e2e.values() if cell in m.get("workloads", cells)}
        assert "setup_s" in names and len(names) >= 2
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m.get("workloads", cells)) <= cells


def test_every_cell_finds_its_files():
    for w in BENCH["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.limits and cell.per_layer and cell.end_to_end
        for m in cell.per_layer:
            assert callable(harness.reader(cell.data_dir, m["name"]))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_a_new_mix_is_taken_as_data(tmp_path):
    """A traffic file and a cell added in another checkout, with no file
    edited, run by name."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    mix = json.loads((ROOT / "portbench" / "traffic" / "chat-tiered.json").read_text())
    mix["engines"] = [{"name": "solo", "placement": "device", "slots": 3, "clients": 5}]
    mix["miku"] = None
    (tmp_path / "portbench" / "traffic" / "throwaway-mix.json").write_text(json.dumps(mix))
    (tmp_path / "portbench" / "limits" / "hymba-throwaway.json").write_text(
        json.dumps({"limits": {"max_logit_gap_sd": 0.5}}))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "hymba-throwaway", "config": "hymba-1.5b",
                               "traffic": "throwaway-mix", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell(tmp_path, "hymba-throwaway")
    assert cell.mix.name == "throwaway-mix" and cell.mix.engines[0].clients == 5
    assert [m["name"] for m in cell.per_layer if "workloads" not in m]
    res = rehearse(smoke_cell("hymba-throwaway", root=tmp_path))
    assert res["correct"] and res["attempted"] > 0
    with pytest.raises(KeyError, match="no workload"):
        harness.load_cell(tmp_path, "not-a-cell")
    assert set(SMOKE) == {c["name"] for c in BENCH["configs"]}
