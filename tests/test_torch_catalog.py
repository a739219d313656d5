"""Port parity: the scenario catalog and the port's completeness.

Every scenario of the port carries the reference's metadata (title, figure,
slow, axes with their defaults and help, metrics with unit and help), the
only difference allowed being ``repro.`` -> ``repro_torch.`` inside help
texts; each catalog section equals the reference's after that substitution,
without the reference's "legacy figure module" fact (the port has no figure
modules); ``docs/torch_scenarios.md`` is ``catalog_md()`` (the counterpart
of the reference's docs-freshness test); the sweep CLI's ``--format`` and
``--profile``.  Last, an AST scan: every top-level function, class, method
and constant of ``src/repro`` is in ``src/repro_torch`` at the mirrored
path, or in :data:`OMITTED`, each group with its reason (ROADMAP.md lists
the same)."""

import ast
import contextlib
import io
import json
import os
import pathlib

import pytest

import repro.scenarios as R
from repro.scenarios.catalog import _scenario_md as ref_scenario_md
from repro.scenarios.spec import format_default as ref_format_default
from repro_torch import scenarios as P
from repro_torch.launch import sweep as sweep_cli
from repro_torch.scenarios.catalog import _scenario_md, catalog_md
from repro_torch.scenarios.spec import format_default

REPO = pathlib.Path(__file__).resolve().parents[1]


def _sub(text: str) -> str:
    return text.replace("repro.", "repro_torch.")


@pytest.mark.parametrize("name", R.names())
def test_scenario_metadata_equals_the_reference(name):
    ref, sc = R.get(name), P.get(name)
    assert (sc.title, sc.figure, sc.slow) == (ref.title, ref.figure, ref.slow)
    assert (sc.run_cell is None) == (ref.run_cell is None)
    assert [(a.name, format_default(a.default), a.help, a.is_grid) for a in sc.axes] == \
        [(a.name, ref_format_default(a.default), _sub(a.help), a.is_grid) for a in ref.axes]
    assert [(a.parse is None) for a in sc.axes] == [(a.parse is None) for a in ref.axes]
    assert [(m.name, m.unit, m.help) for m in sc.metrics] == \
        [(m.name, m.unit, _sub(m.help)) for m in ref.metrics]
    assert sc.axis_names == ref.axis_names and sc.module == ""


@pytest.mark.parametrize("name", R.names())
def test_catalog_section_equals_the_reference(name):
    ref = R.get(name)
    want = [_sub(line) for line in ref_scenario_md(ref)]
    if ref.module:
        fact = f"; legacy figure module `benchmarks/{ref.module}.py`"
        want = [line.replace(fact, "") for line in want]
    assert _scenario_md(P.get(name)) == want


def test_committed_catalog_is_fresh():
    path = REPO / "docs" / "torch_scenarios.md"
    assert path.read_text() == catalog_md(), (
        "docs/torch_scenarios.md is stale; regenerate it with PYTHONPATH=src "
        "python -m repro_torch.launch.sweep --list --format md > docs/torch_scenarios.md")
    text = catalog_md()
    assert all(f"## `{n}`" in text for n in P.names())
    assert "repro_torch.launch.sweep" in text and "benchmarks/" not in text


def _cli(argv):
    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            sweep_cli.main(argv)
        except SystemExit as ex:
            code = ex.code
    return code, out.getvalue(), err.getvalue()


def test_sweep_cli_formats_and_profile():
    args = ["fig4_latency", "--set", "threads=1,4", "--set", "tier=cxl", "--device", "cpu"]
    code, csv_out, _ = _cli(args)
    assert code == 0
    code, json_out, err = _cli(args + ["--format", "json", "--profile"])
    assert code == 0
    doc = json.loads(json_out)
    table = P.run_scenario("fig4_latency", {"threads": (1, 4), "tier": ("cxl",)},
                           device="cpu")
    assert doc["rows"] == table.rows and doc["scenario"] == "fig4_latency"
    assert csv_out == table.to_csv()
    assert [line.split(",")[0] for line in csv_out.splitlines()[1:]] == \
        [str(r["platform"]) for r in doc["rows"]]
    profile = json.loads(err.split("profile: ", 1)[1].splitlines()[0])
    assert set(profile["phases"]) == {"plan", "sweep", "reduce"}
    metrics = json.loads(err.split("metrics: ", 1)[1].splitlines()[0])
    assert metrics["counters"]["sweep.jobs"] >= 2
    code, md, _ = _cli(["--list", "--format", "md"])
    assert code == 0 and md == catalog_md()
    for argv in (["fig4_latency", "--format", "md", "--device", "cpu"],
                 ["--list", "--format", "json"]):
        code, _, err = _cli(argv)
        assert code == 2 and "--format" in err


# -- completeness: the reference's symbols, the port's, and the named omissions --

#: Reference symbols the port leaves out on purpose, by reason.  ROADMAP.md
#: ("Intentional omissions") names each group with the same reason.
OMITTED = {
    "pallas": (
        "a Pallas body or its Pallas/numpy backend plumbing: the port's kernels "
        "are CUDA C++ (src/repro_torch/kernels/csrc) with plain PyTorch versions "
        "in repro_torch/kernels/ref.py",
        {
            "kernels/decode_attention.py": ["NEG_INF", "_decode_attn_kernel",
                                            "decode_attention_kernel"],
            "kernels/ssd_scan.py": ["_ssd_kernel", "ssd_scan_kernel"],
            "kernels/ops.py": ["_use_interpret"],
            "memsim/batched/kernel.py": [
                "_BISECT_ITERS", "_EPS", "_build_fused_solver", "_build_pallas_solver",
                "_fused_solvers", "_glam_kernel", "_global_lambda_numpy",
                "_global_lambda_pallas", "_pallas_failed", "_pallas_solver",
                "_population", "backend"],
        },
    ),
    "jax": (
        "JAX-only plumbing: memory-kind shardings, HLO text, ShapeDtypeStructs, "
        "(params, axes) init pairs and logical-axis trees, sharding helpers, "
        "jax.tree_util paths, a jax.jit cache and the lax.scan layer stack (the "
        "port's Python layer loop does that work in TransformerLM._block, _run, "
        "_embed and _ffn)",
        {
            "core/tiers.py": ["with_memory_kind"],
            "roofline/hlo_costs.py": ["*"],
            "launch/dryrun.py": ["_COLLECTIVE_RE", "_DTYPE_BYTES", "_OP_LINE_RE",
                                 "_WIRE_FACTOR", "parse_collective_bytes",
                                 "_decode_state_shardings", "_maybe_fe_spec",
                                 "_replicated", "_sh"],
            "configs/__init__.py": ["_sds", "input_specs"],
            "checkpoint/ckpt.py": ["_flatten_with_paths"],
            "distributed/sharding.py": ["tree_shardings"],
            "distributed/autosharding.py": ["_top"],
            "launch/train.py": ["Trainer._state_shardings"],
            "serving/engine.py": ["ServingEngine._prefill_fn"],
            "models/attention.py": ["KV_CACHE_AXES"],
            "models/ssm.py": ["SSM_STATE_AXES"],
            "models/layers.py": ["Axes", "embedding_init", "mlp_init", "rmsnorm_init"],
            "models/transformer.py": [
                "TransformerLM.param_specs", "TransformerLM.init_shapes", "_axes_of",
                "TransformerLM._layer_init", "TransformerLM._block_body",
                "TransformerLM._run_stack", "TransformerLM._pair_view",
                "TransformerLM._pair_unview", "TransformerLM._sub_block",
                "TransformerLM._sub_decode", "TransformerLM._sub_prefill",
                "TransformerLM._ssm_forward_branch", "TransformerLM._embed_inputs",
                "TransformerLM._ffn_apply"],
        },
    ),
    "roadmap_c": (
        "a limit kept on purpose (ROADMAP C): the port has no REPRO_SWEEP_LANE or "
        "REPRO_SWEEP_PROCS; lane and processes are arguments",
        {"memsim/sweep.py": ["default_lane", "default_processes"]},
    ),
    "renamed": (
        "a second name for an object the port keeps under its public name: the "
        "reference's registry dict _REGISTRY is the port's library.SCENARIOS, "
        "which register() appends to",
        {"scenarios/registry.py": ["_REGISTRY"]},
    ),
    "distribution": (
        "a distribution leftover of ROADMAP A.3: the shard_map MoE dispatch; the "
        "port's _moe_apply and _moe_apply_meshed route per shard",
        {"models/moe.py": ["_moe_apply_sharded", "_moe_apply_local"]},
    ),
}


def _symbols(path: pathlib.Path) -> set:
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def test_every_reference_symbol_is_ported_or_named():
    ref_root, port_root = REPO / "src" / "repro", REPO / "src" / "repro_torch"
    omitted = {(f, s) for _, files in OMITTED.values() for f, syms in files.items()
               for s in syms}
    missing, stale = [], []
    for path in sorted(ref_root.rglob("*.py")):
        rel = str(path.relative_to(ref_root))
        mirror = port_root / rel
        have = _symbols(mirror) if mirror.exists() else set()
        for sym in sorted(_symbols(path) - have):
            if (rel, sym) not in omitted and (rel, "*") not in omitted:
                missing.append(f"{rel}:{sym}")
        stale += [f"{rel}:{s}" for f, s in omitted if f == rel and s != "*" and s in have]
    assert not missing, f"reference symbols absent from the port: {missing}"
    assert not stale, f"named as omitted but present in the port: {stale}"
    assert not (port_root / "roofline" / "hlo_costs.py").exists()
    assert (port_root / "roofline" / "op_costs.py").exists()
    assert os.path.exists(REPO / "ROADMAP.md")
    roadmap = (REPO / "ROADMAP.md").read_text()
    for f, syms in ((f, s) for _, files in OMITTED.values() for f, s in files.items()):
        assert f in roadmap, f"ROADMAP.md names no omission in {f}"
