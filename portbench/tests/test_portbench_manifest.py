"""BENCHMARK.json against the benchmark's contract, and the harness finding
a configuration (with its reference, least-work module, smoke widths and
weight rules), a traffic mix, a metric and a cell by name."""

import json
import math
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.tests.smoke import SMOKE, rehearse, smoke_cell
from portbench.tests.test_portbench_rehearsal import FAULTS
from portbench.weights import make_weights

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
    for w in BENCH["workloads"]:  # each configuration's own modules, by path
        cell = harness.load_cell(ROOT, w["name"])
        assert callable(cell.reference.logits) and cell.smoke["vocab"] > 0
        for fn in ("decode_step", "prefill", "k4_calls"):
            assert callable(getattr(cell.counts, fn))


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
    assert cell.smoke == SMOKE["hymba-1.5b"]


NEW = Path(__file__).resolve().parent / "newconfig"


def _add_dense(tmp_path):
    """A copy of the benchmark with the configuration ``dense-smoke`` (the
    port's dense block, which ``reference/model.py`` refuses) and its cell
    added as new files and entries only."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    pb = tmp_path / "portbench"
    shutil.copy(NEW / "dense-smoke.json", pb / "configs" / "dense-smoke.json")
    shutil.copy(NEW / "reference_dense.py", pb / "reference" / "dense.py")
    (pb / "work").mkdir()
    shutil.copy(NEW / "counts_dense.py", pb / "work" / "dense.py")
    (pb / "limits" / "dense-smoke-chat.json").write_text(
        json.dumps({"limits": {"max_logit_gap_sd": 0.8, "staged_weight_diff": 0.0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dense-smoke", "source": "a test",
                             "file": "portbench/configs/dense-smoke.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "dense-smoke-chat", "config": "dense-smoke",
                               "traffic": "chat-tiered", "chips": 1, "why": "a test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return harness.load_cell(tmp_path, "dense-smoke-chat")


def test_a_new_configuration_is_taken_as_data(tmp_path, monkeypatch):
    cell = _add_dense(tmp_path)
    assert Path(cell.reference.__file__) == tmp_path / "portbench" / "reference" / "dense.py"
    assert Path(cell.counts.__file__) == tmp_path / "portbench" / "work" / "dense.py"
    from portbench.reference import model as yardstick

    with pytest.raises(ValueError, match="dense"):
        yardstick.logits(cell.model, {"embed": torch.zeros(4, 4)}, [1], [0])
    # the cell rehearses correct, its requests checked by its own reference
    recs = []
    res = rehearse(smoke_cell("dense-smoke-chat", root=tmp_path),
                   faults=lambda engines: recs.append(engines[0].rec))
    assert res["correct"], res["info"]["why_not_correct"]
    assert res["attempted"] > 0 and res["info"]["tokens_compared"] > 0
    # the model step's readers read through its counts
    rec = recs[0]
    seen = []
    for fn in ("decode_step", "prefill"):
        real = getattr(cell.counts, fn)
        monkeypatch.setattr(cell.counts, fn, lambda m, x, real=real, fn=fn:
                            seen.append(fn) or real(m, x))
    run = harness.RunData(model=cell.smoke, counts=cell.counts, mix=cell.mix, t_open=rec.t_open,
                          t_close=rec.deadline, t_return=rec.deadline, rec=rec, h2d_bytes=0,
                          h2d_seconds=0.0, trace=None)
    steps = [d for d in rec.decodes if run.in_window(d.t0)]
    pre = [p for p in rec.prefills if run.in_window(p.t0)]
    assert steps and pre
    read = {m: harness.reader(cell.data_dir, m)(run) for m in ("decode_mfu_pct", "prefill_mfu_pct")}
    assert set(seen) == {"decode_step", "prefill"}
    least = sum(cell.counts.decode_step(cell.smoke, d.active).least_seconds for d in steps)
    assert read["decode_mfu_pct"] == 100.0 * least / sum(d.t1 - d.t0 - d.staged for d in steps)
    least = sum(cell.counts.prefill(cell.smoke, p.plen).least_seconds for p in pre)
    assert read["prefill_mfu_pct"] == 100.0 * least / sum(p.t1 - p.t0 - p.staged for p in pre)
    assert cell.counts.k4_calls(cell.smoke, 100) == []
    # a planted fault, the sampler's choice moved to the next id, is caught
    bad = rehearse(smoke_cell("dense-smoke-chat", root=tmp_path), faults=FAULTS["altered_token"])
    assert bad["correct"] is False
    assert bad["checks"]["max_logit_gap_sd"]["value"] > bad["checks"]["max_logit_gap_sd"]["limit"]


def test_a_configurations_weight_rules_scale_its_own_leaves():
    """A leaf [L, E, in, out] with a declared fan-in axis is drawn at
    in^-1/2 (axis 1 would give E^-1/2), and a norm of a name the benchmark
    has not seen at 0.1 by its rank; every other leaf is the same to the bit
    with or without the rules."""
    rules = json.loads((NEW / "dense-smoke.json").read_text())["weights"]
    L, E, n_in, n_out, dh = 2, 16, 256, 64, 32
    shapes = {"embed": ((512, 128), torch.bfloat16),
              "layers": {"moe": {"w_experts_in": ((L, E, n_in, n_out), torch.bfloat16)},
                         "attn": {"q_norm": ((L, dh), torch.bfloat16),
                                  "wo": ((L, 4, dh, 128), torch.bfloat16)}},
              "final_norm": ((128,), torch.bfloat16)}
    seed, cpu = 2**31 + 77, torch.device("cpu")
    ruled = make_weights(shapes, seed, cpu, rules)
    plain = make_weights(shapes, seed, cpu)
    w = ruled["layers"]["moe"]["w_experts_in"].float()
    assert w.std().item() == pytest.approx(n_in ** -0.5, rel=0.05)
    assert plain["layers"]["moe"]["w_experts_in"].float().std().item() == \
        pytest.approx(E ** -0.5, rel=0.05)
    assert ruled["layers"]["attn"]["q_norm"].float().std().item() == pytest.approx(0.1, rel=0.3)
    for path in (("embed",), ("final_norm",), ("layers", "attn", "wo"),
                 ("layers", "attn", "q_norm")):
        a, b = ruled, plain
        for k in path:
            a, b = a[k], b[k]
        assert torch.equal(a, b), path
    assert math.isclose(ruled["layers"]["attn"]["wo"].float().std().item(), (4 * dh) ** -0.5,
                        rel_tol=0.05)
