"""The port's dry run (``repro_torch.launch.dryrun``) on CPU fake ranks.

* llama31-8b ``decode_32k`` at full width on the (32, 8) production mesh
  of a 256-rank fake process group: ok, the parameters' bytes a device
  equal ``bytes_per_device`` of their placements (TP over 8 only: 2.008 GB),
  the KV cache's are its (batch over 32, sequence over 8) shards, K1 runs
  once a layer through its fake rule, and its cache is gathered along the
  sequence over ``model``.  Nothing is allocated: the cache alone is
  550 GB.
* Every arch's smoke config, a train and a prefill cell on a (4, 2) fake
  mesh: ok, parameter bytes as placed; a prefill's FLOPs over the 8 ranks
  equal the same prefill's without a mesh (where the plan repeats no work:
  not the SSM families, not MoE); the dense attention families' train step
  within 5% of the
  reference's 6·N·D bookkeeping over the parameters that enter products
  plus the attention's scores and values.
* ``shape_applicable`` skips ``long_500k`` where the reference does.
* The CLI writes the reference's ``CellResult`` keys, with
  ``seconds_trace`` in place of its lowering and compile times.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_arch as ref_get_arch
from repro.launch.dryrun import CellResult as RefCellResult
from repro_torch.configs import SHAPES, Shape, get_arch
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import CellResult, fake_process_group, run_cell
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models.transformer import TransformerLM
from repro_torch.roofline.analysis import model_flops
from repro_torch.roofline.op_costs import count_costs

HERE = os.path.dirname(os.path.abspath(__file__))
SMOKE_SHAPES = (Shape("smoke_train", 64, 8, "train"), Shape("smoke_prefill", 64, 8, "prefill"))


def test_decode_32k_full_width():
    with fake_process_group(256):
        r = run_cell("llama31-8b", "decode_32k", make_production_mesh(device="cpu"), "32x8",
                     device="cpu", verbose=False)
    assert r.ok, r.error
    assert r.memory["param_size_in_bytes"] == r.memory["param_bytes_from_placements"]
    assert r.memory["param_size_in_bytes"] == 2_008_031_232
    # k and v [32 layers, 128 / 32 rows, 32768 / 8 positions, 8, 128] bf16,
    # and the int32 lengths of 4 rows.
    cache = 2 * 32 * 4 * 4096 * 8 * 128 * 2
    assert r.memory["argument_size_in_bytes"] == 2_008_031_232 + cache + 4 * 4
    assert "decode_attention=32" in r.notes
    assert r.collective_axis_bytes["model"] >= cache * 8  # the sequence gathered
    assert r.flops_per_device > 0 and r.bytes_min_per_device <= r.bytes_per_device


def _unmeshed_prefill_flops(cfg, shape) -> float:
    """FLOPs of the same prefill on one device without a mesh."""
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    state = model.init_decode_state(shape.global_batch, shape.seq_len, "cpu")
    tokens = torch.zeros((shape.global_batch, shape.seq_len), dtype=torch.int32)
    fe = dryrun._frontend(cfg, shape.global_batch, torch.device("cpu"))
    with torch.no_grad(), count_costs() as cost:
        model.prefill(params, tokens, state, frontend_embeds=fe)
    return cost.flops


@pytest.mark.parametrize("shape", SMOKE_SHAPES, ids=lambda s: s.kind)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_cells(arch, shape):
    spec = get_arch(arch)
    spec = dataclasses.replace(spec, config=spec.smoke)
    cfg = spec.config
    with fake_process_group(8):
        r = run_cell(arch, shape, make_mesh((4, 2), ("data", "model"), "cpu"), "4x2",
                     device="cpu", spec=spec, remat="none", microbatches=1, verbose=False)
    assert r.ok, r.error
    assert r.memory["param_size_in_bytes"] == r.memory["param_bytes_from_placements"]
    total = r.flops_per_device * 8
    if shape.kind == "prefill":
        # Sharding splits the work and adds none, but where the plan repeats
        # some: each device of a model group computes the SSM's C B^T (one
        # group, replicated beside the heads) and, for a head count the
        # model axis does not divide (hymba), the whole attention.  MoE
        # capacity is per batch shard, so its work differs.
        plain = _unmeshed_prefill_flops(cfg, shape)
        if cfg.block == "moe":
            pass
        elif cfg.uses_ssm:
            assert total >= plain
        else:
            assert total == pytest.approx(plain, rel=1e-6)
    elif cfg.block == "dense" and not cfg.n_encoder_layers:
        # The reference's 6·N·D over the parameters that enter products (an
        # untied input embedding is only looked up), plus the attention's
        # scores and values, forward and backward.
        tokens = shape.global_batch * shape.seq_len
        lookup_only = 0 if cfg.tied_embeddings else cfg.vocab * cfg.d_model
        attention = 12 * tokens * shape.seq_len * cfg.n_q_heads * cfg.head_dim * cfg.n_layers
        want = model_flops(spec, shape) - 6 * lookup_only * tokens + attention
        assert total == pytest.approx(want, rel=0.05)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_long_500k_applicability(arch):
    spec = get_arch(arch)
    for name in SHAPES:
        assert spec.shape_applicable(name) == ref_get_arch(arch).shape_applicable(name)
    assert [s.name for s in spec.shapes()] == [s.name for s in ref_get_arch(arch).shapes()]
    if not spec.long_context:
        r = run_cell(arch, "long_500k", None, "32x8", device="cpu")
        assert not r.ok and r.notes == "skipped"


def test_cli_writes_cell_results(tmp_path):
    out = tmp_path / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--device", "cpu", "--arch",
         "llama31-8b", "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    (cell,) = json.loads(out.read_text())
    ref_keys = {f.name for f in dataclasses.fields(RefCellResult)}
    port_keys = {f.name for f in dataclasses.fields(CellResult)}
    assert set(cell) == port_keys
    assert port_keys == (ref_keys - {"seconds_lower", "seconds_compile"}) | {
        "seconds_trace", "collective_axis_bytes"}
    assert cell["ok"] and cell["mesh"] == "32x8" and cell["seconds_trace"] > 0
    assert cell["memory"]["param_size_in_bytes"] == cell["memory"]["param_bytes_from_placements"]
