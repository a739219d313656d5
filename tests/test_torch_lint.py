"""Port parity: the repo lint (repro_torch.analysis.lint and ``python -m
repro_torch.analysis lint``) against the reference's (repro.analysis.lint).

Every rule must give the reference's findings (rule, path, line) on
tests/test_analysis.py's fixture sources; the torch samplers the port adds
to the nondeterminism rule are held on their own; the dynamic rules run on
the port's twins and registry; and the lint is green over src/repro_torch."""

import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis.lint as ref_lint
import repro_torch.analysis.lint as lint
from repro_torch.analysis import Finding, run_lint

REPO = Path(__file__).resolve().parents[1]
PORT_ROOT = REPO / "src" / "repro_torch"

#: (rule, source, path relative to the package) — tests/test_analysis.py's
#: fixtures, and the allowed forms beside each.
FIXTURES = {
    "counter_aug": ("counter_mutation", "def f(tc):\n    tc.inserts += 1\n",
                    "tiering/foo.py"),
    "counter_assign_subscript": ("counter_mutation",
                                 "def f(tc):\n    tc.occupancy_time = 0.0\n"
                                 "    tc.class_counts[op] = 3\n", "core/des.py"),
    "counter_in_substrate": ("counter_mutation", "def f(tc):\n    tc.inserts += 1\n",
                             "core/substrate.py"),
    "counter_in_materializer": ("counter_mutation",
                                "def _materialize_counters(tc):\n    tc.inserts += 1\n",
                                "core/des.py"),
    "counter_in_run_fluid": ("counter_mutation",
                             "def run_fluid(tc):\n    def inner():\n"
                             "        tc.inserts += 1\n", "memsim/batched/fluid.py"),
    "nondet_sources": ("nondeterminism",
                       "def f():\n    x = random.random()\n    t = time.time()\n"
                       "    y = np.random.rand(3)\n    rng = np.random.default_rng()\n",
                       "core/foo.py"),
    "nondet_seeded": ("nondeterminism",
                      "def f(seed):\n    return np.random.default_rng(seed)\n",
                      "core/foo.py"),
    "nondet_models": ("nondeterminism", "def f():\n    return random.random()\n",
                      "models/foo.py"),
    "nondet_timers": ("nondeterminism",
                      "import time\n\ndef step(vt):\n    t0 = time.perf_counter()\n"
                      "    vt.step()\n    return time.perf_counter() - t0\n",
                      "memsim/batched/fluid.py"),
    "nondet_top_level": ("nondeterminism", "import numpy as numpy\nnumpy.random.seed(0)\n",
                         "workload/foo.py"),
    "deprecated_window": ("deprecated_surface", "d = ctl.window(fast, slow)\n",
                          "memsim/foo.py"),
    "deprecated_window_in_shim": ("deprecated_surface", "d = ctl.window(fast, slow)\n",
                                  "core/controller.py"),
    "deprecated_merged": ("deprecated_surface",
                          "c = TierSetWindowedCounters(names, merged=True)\n",
                          "memsim/foo.py"),
    "deprecated_merged_in_substrate": ("deprecated_surface",
                                       "c = TierSetWindowedCounters(names, merged=True)\n",
                                       "core/substrate.py"),
    "pickle_lambda": ("scenario_pickle_ast", "Scenario(name='x', build=lambda c: c)\n",
                      "scenarios/foo.py"),
    "pickle_lambda_arg": ("scenario_pickle_ast", "Axis(lambda c: c, name='x')\n",
                          "scenarios/foo.py"),
    "pickle_outside_scenarios": ("scenario_pickle_ast",
                                 "Scenario(name='x', build=lambda c: c)\n", "core/foo.py"),
}


def _located(findings):
    return [(f.rule, f.path, f.line) for f in findings]


@pytest.mark.parametrize("case", list(FIXTURES))
def test_rule_findings_equal_the_reference(case):
    rule, src, rel = FIXTURES[case]
    tree = ast.parse(src)
    got = getattr(lint, f"rule_{rule}")(tree, rel)
    want = getattr(ref_lint, f"rule_{rule}")(tree, rel)
    assert _located(got) == _located(want)
    assert all(isinstance(f, Finding) for f in got)


def test_fixture_counts_are_the_reference_tests():
    """tests/test_analysis.py's expectations, on the port's rules."""
    def n(case):
        rule, src, rel = FIXTURES[case]
        return len(getattr(lint, f"rule_{rule}")(ast.parse(src), rel))

    assert n("counter_aug") == 1 and n("counter_assign_subscript") == 2
    assert n("counter_in_substrate") == n("counter_in_materializer") == 0
    assert n("nondet_sources") == 4 and n("nondet_timers") == 2
    assert n("nondet_seeded") == n("nondet_models") == 0
    assert n("deprecated_window") == n("deprecated_merged") == 1
    assert n("deprecated_window_in_shim") == n("deprecated_merged_in_substrate") == 0
    assert n("pickle_lambda") == 1 and n("pickle_outside_scenarios") == 0


@pytest.mark.parametrize("src,rel,lines", [
    ("x = torch.rand(3)\ny = torch.randn(2, 2)\n", "memsim/foo.py", [1, 2]),
    ("i = torch.randint(0, 9, (4,))\np = torch.randperm(8)\n", "tiering/foo.py", [1, 2]),
    ("g = torch.Generator().manual_seed(0)\nx = torch.rand(3, generator=g)\n"
     "p = torch.randperm(8, generator=g)\n", "core/foo.py", []),
    ("x = torch.rand(3)\n", "models/foo.py", []),
    ("x = torch.zeros(3)\ny = torch.rand_like(x)\n", "fabric/foo.py", []),
])
def test_nondeterminism_covers_unseeded_torch_samplers(src, rel, lines):
    found = lint.rule_nondeterminism(ast.parse(src), rel)
    assert [f.line for f in found] == lines
    assert all(f.rule == "nondeterminism" and "generator=" in f.message for f in found)


def test_twin_pairs_are_the_reference_pairs_on_the_port_classes():
    got, want = lint.twin_pairs(), ref_lint.twin_pairs()
    assert [p[0] for p in got] == [p[0] for p in want]
    for (label, fields, consumed, extra, path, _), ref in zip(got, want):
        assert (fields, consumed, extra) == ref[1:4], label
        assert "repro_torch" in path
    for label, fields, consumed, extra, path, line in got:
        assert lint.compare_twin_surfaces(label, fields, consumed, extra_allowed=extra,
                                          path=path, line=line) == []


def test_twin_parity_catches_injected_one_sided_knob():
    label, fields, consumed, extra, path, line = lint.twin_pairs()[0]
    found = lint.compare_twin_surfaces(label, fields | {"new_knob"}, consumed,
                                       extra_allowed=extra, path=path, line=line)
    assert len(found) == 1 and "new_knob" in found[0].message
    found = lint.compare_twin_surfaces(label, fields, consumed | {"phantom"},
                                       extra_allowed=extra, path=path, line=line)
    assert len(found) == 1 and "phantom" in found[0].message


def test_registered_scenarios_pickle():
    from repro_torch.scenarios import all_scenarios

    assert lint.rule_scenario_pickle_dynamic() == []
    for sc in all_scenarios():
        assert pickle.loads(pickle.dumps(sc)).name == sc.name


def test_repo_lint_is_green():
    assert lint.default_src_root() == PORT_ROOT
    assert run_lint() == []


def test_lint_finds_a_seeded_tree(tmp_path):
    """A copy of the package layout with the timers the fluid engine once
    had: both lines are found, with their rule and path."""
    (tmp_path / "memsim" / "batched").mkdir(parents=True)
    (tmp_path / "memsim" / "batched" / "fluid.py").write_text(FIXTURES["nondet_timers"][1])
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "ok.py").write_text("x = 1\n")
    found = run_lint(tmp_path, dynamic=False)
    assert _located(found) == [("nondeterminism", "memsim/batched/fluid.py", 4),
                               ("nondeterminism", "memsim/batched/fluid.py", 6)]
    assert _located(found) == _located(ref_lint.run_lint(tmp_path, dynamic=False))
    report = lint.format_report(found, 2)
    assert report.endswith("repro_torch.analysis lint: 2 finding(s) in 2 files")


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis", "lint", *args],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=600)


def test_cli_is_green_over_the_port():
    proc = _cli()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n = len(list(PORT_ROOT.rglob("*.py")))
    assert proc.stdout.strip() == f"repro_torch.analysis lint: {n} files checked, no findings"


def test_cli_exits_1_on_findings(tmp_path):
    (tmp_path / "core").mkdir()
    (tmp_path / "core" / "bad.py").write_text("import random\nx = random.random()\n")
    proc = _cli("--src", str(tmp_path), "--no-dynamic")
    assert proc.returncode == 1
    assert "core/bad.py:2: [nondeterminism]" in proc.stdout
