"""The port stands alone: no file of src/repro_torch (nor chip_smoke.py and
kernel_ab.py) imports jax or the reference package, importing it leaves jax
unloaded, and its entry points refuse to run on a machine without CUDA
unless asked for the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "kernel_ab.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_reference(path):
    bad = {"jax", "jaxlib", "repro"} & set(_imported_roots(path))
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.kernels.ops, repro_torch.models.weights, "
            "repro_torch.launch.sweep, repro_torch.scenarios, "
            "repro_torch.memsim.batched, repro_torch.memsim.batched.fluid, "
            "repro_torch.kernels.fluid_solver, repro_torch.kernels.ssd_scan, "
            "repro_torch.models.ssm, repro_torch.configs.mamba2_2p7b, "
            "repro_torch.core.mva, repro_torch.memsim.batched.exact, "
            "repro_torch.obs.histogram, repro_torch.scenarios.planner, "
            "repro_torch.tiering, repro_torch.tiering.hook, "
            "repro_torch.memsim.batched.tiering, repro_torch.launch.train, "
            "repro_torch.train.step, repro_torch.optim, repro_torch.checkpoint, "
            "repro_torch.data, repro_torch.pytree, repro_torch.distributed, "
            "repro_torch.distributed.autosharding, repro_torch.launch.mesh, "
            "repro_torch.launch.dryrun, repro_torch.roofline.analysis, "
            "repro_torch.roofline.op_costs, repro_torch.fabric, "
            "repro_torch.fabric.topology, repro_torch.workload, "
            "repro_torch.workload.arrivals; "
            "assert 'jax' not in sys.modules and 'repro' not in sys.modules, "
            "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_without_device_raise_on_cpu_only_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: entry points run on it")
    from repro_torch import resolve_device
    from repro_torch.configs import get_arch
    from repro_torch.core.device_model import platform_a
    from repro_torch.core.littles_law import OpClass
    from repro_torch.core.mva import analyze
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import build_cluster
    from repro_torch.launch.train import Trainer
    from repro_torch.memsim.batched import run_sweep_batched
    from repro_torch.models.transformer import TransformerLM
    from repro_torch.scenarios import plan, run_scenario

    with pytest.raises(RuntimeError, match="CUDA"):
        build_cluster(n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM(get_arch("llama31-8b").smoke).init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer("qwen2.5-3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer("qwen2.5-3b", smoke=True, mesh=object())
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    jobs = [j for _, _, js in plan("corun_sweep", {"threads": 2, "mlp": 96}) for j in js]
    with pytest.raises(RuntimeError, match="CUDA"):
        run_sweep_batched(jobs)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario("corun_sweep_1k")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario("fig11_llm")
    with pytest.raises(RuntimeError, match="CUDA"):
        analyze(platform_a(), OpClass.LOAD, 16, 0)
    assert resolve_device("cpu").type == "cpu"


def test_dryrun_cli_refuses_without_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the dry run runs on its device type")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "llama31-8b", "--shape", "decode_32k"], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
