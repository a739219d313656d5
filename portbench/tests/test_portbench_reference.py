"""The frozen plain reference against the port's models at smoke size, in
float32 on the CPU (this test imports both; the reference imports neither
``repro_torch`` nor ``repro`` nor ``jax``)."""

import ast
import dataclasses
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.reference import model as reference
from portbench.tests.smoke import SMOKE
from portbench.weights import make_weights

REF_DIR = Path(__file__).resolve().parents[1] / "reference"


def _port(name):
    from repro_torch.models.transformer import TransformerLM, param_shapes

    m = dict(SMOKE[name], dtype="float32")
    cfg = harness.model_config(m)
    w = make_weights(param_shapes(cfg), 2**31 + 3, torch.device("cpu"))
    return m, cfg, TransformerLM(cfg), w


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_matches_the_port_forward(name):
    m, cfg, lm, w = _port(name)
    tokens = torch.randint(0, cfg.vocab, (1, 53), generator=torch.Generator().manual_seed(1))
    hidden = lm.forward(w, tokens)
    port = lm.logits(w, hidden)[0]
    pos = list(range(53))
    ref = reference.logits(m, w, tokens[0].tolist(), pos)
    scale = port.abs().max()
    assert (ref - port).abs().max() <= 2e-5 * scale


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_reference_matches_prefill_then_decode(name):
    """Prefill through the cache and decode steps give the reference's
    logits at each position (past hymba's window of 16)."""
    m, cfg, lm, w = _port(name)
    seq = torch.randint(0, cfg.vocab, (40,), generator=torch.Generator().manual_seed(2))
    state = lm.init_decode_state(1, 64, torch.device("cpu"))
    logits, state = lm.prefill(w, seq[None, :20], state)
    got = [logits[0]]
    for t in seq[20:39]:
        logits, state = lm.decode_step(w, state, t[None].to(torch.int32))
        got.append(logits[0])
    ref = reference.logits(m, w, seq.tolist(), list(range(19, 39)))
    port = torch.stack(got)
    assert (ref - port).abs().max() <= 5e-5 * port.abs().max()


def test_fp8_control_differs_and_keeps_its_scale():
    m, cfg, lm, w = _port("hymba-1.5b")
    seq = list(range(1, 30))
    a = reference.logits(m, w, seq, [28])
    b = reference.logits(m, w, seq, [28], precision="fp8")
    assert not torch.equal(a, b)
    assert (a - b).abs().max() < 0.5 * a.abs().max()
    x = torch.randn(64, 16)
    q = reference.fp8_columns(x)
    assert ((q - x).abs() <= x.abs().amax(0) / 8).all()


def test_the_reference_imports_nothing_of_the_port():
    for path in REF_DIR.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("repro_torch", "repro", "jax", "jaxlib",
                                               "flax"), f"{path.name} imports {n}"


def test_unknown_block_and_precision_raise():
    m = dict(SMOKE["mamba2-2.7b"])
    with pytest.raises(ValueError):
        reference.logits(dict(m, block="dense"), {"embed": torch.zeros(4, 4)}, [1], [0])
    with pytest.raises(ValueError):
        reference.logits(m, {"embed": torch.zeros(4, 4)}, [1], [0], precision="int3")
    assert dataclasses.is_dataclass(harness.Cell)
