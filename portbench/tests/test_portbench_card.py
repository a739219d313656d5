"""On a CUDA card: the control, the reference in float8 put in the
program's place, fails each cell's limit at the cell's own size, and the
program passes it, on three seeds; the traced path reduces a real trace.
Run with ``python -m pytest portbench -m card`` on the card (about 10
minutes); skipped elsewhere."""

import time
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests.smoke import CELLS

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)
#: A window that compares as many served tokens as a run does (each engine's
#: longest request, in flight or finished, and others up to the sample's size).
SECONDS = 20.0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(card, name):
    cell = harness.load_cell(ROOT, name)
    limit = cell.limits["max_logit_gap_sd"]
    for seed in SEEDS:
        res = harness.run_cell(cell, seed, SECONDS, False, device=card,
                               t_start=time.perf_counter(), control=True)
        checks = res["checks"]
        assert res["correct"], res["info"]["why_not_correct"]
        assert checks["control_max_logit_gap_sd"]["value"] > limit
        assert checks["max_logit_gap_sd"]["value"] <= limit


@pytest.mark.card
def test_a_traced_run_reads_every_per_layer_metric(card):
    cell = harness.load_cell(ROOT, "hymba-tiered-chat")
    res = harness.run_cell(cell, SEEDS[0], 8.0, True, device=card, t_start=time.perf_counter())
    assert res["correct"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
    for name, m in res["metrics"].items():
        if name.endswith("_pct"):
            assert 0 < m["value"] <= 100, name
