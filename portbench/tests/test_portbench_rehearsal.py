"""CPU rehearsals of the harness at smoke size: every cell runs end to end
and its outputs pass the check; each fault the cells can have, planted in
the timed path underneath, makes ``correct`` false; and after a rehearsal no
module of ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded (top-level
names compared whole: ``repro_torch`` passes)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench.tests.smoke import CELLS, rehearse, smoke_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", CELLS)
def test_cell_rehearses_correct(name):
    cell = smoke_cell(name)
    res = rehearse(cell)
    assert res["correct"], res["info"]["why_not_correct"]
    assert res["attempted"] > 0 and res["failed"] == 0
    m = res["metrics"]
    assert set(m) == {e["name"] for e in cell.end_to_end} >= {"output_tok_s", "setup_s"}
    assert all(v["value"] > 0 for v in m.values())
    assert res["info"]["tokens_compared"] > 0
    assert list(res)[-1] == "checks" and "max_logit_gap_sd" in res["checks"]


def _stale_state(engines):
    """Each decode step returns its state unchanged: the cache, the SSM
    states and the lengths are restored after it."""
    for eng in engines:
        step = eng.model.decode_step

        def frozen(params, state, token, step=step):
            saved = [t.clone() for d in (state.kv, state.ssm) if d for t in d.values()]
            logits, new = step(params, state, token)
            live = [t for d in (state.kv, state.ssm) if d for t in d.values()]
            for dst, src in zip(live, saved):
                dst.copy_(src)
            return logits, state

        eng.model.decode_step = frozen


def _half_batch(engines):
    """Half of the slots left out of each decode step: their logits are
    the mean of the other half's."""
    for eng in engines:
        step = eng.model.decode_step

        def half(params, state, token, step=step):
            logits, new = step(params, state, token)
            b = logits.shape[0]
            keep = max(1, b // 2)
            logits = logits.clone()
            logits[keep:] = logits[:keep].mean(dim=0, keepdim=True)
            return logits, new

        eng.model.decode_step = half


def _altered_token(engines):
    """A token altered where it is produced: the sampler's first choice
    moved to the next id."""
    for eng in engines:
        sample = eng._sample

        def moved(logits, sample=sample):
            return (sample(logits) + 1) % logits.shape[-1]

        eng._sample = moved


FAULTS = {"state_unchanged": _stale_state, "half_batch": _half_batch,
          "altered_token": _altered_token}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_makes_correct_false(name, fault):
    res = rehearse(smoke_cell(name), faults=FAULTS[fault])
    assert res["correct"] is False
    gap = res["checks"]["max_logit_gap_sd"]
    assert gap["value"] > gap["limit"]


def test_no_forbidden_module_after_a_rehearsal():
    code = ("import sys; sys.path[0:0] = [%r, %r]\n"
            "from portbench.tests.smoke import rehearse, smoke_cell\n"
            "from portbench import harness\n"
            "res = rehearse(smoke_cell('hymba-tiered-chat'), seconds=0.5)\n"
            "import json; print(json.dumps([res['correct'], harness.forbidden_modules(),"
            " sorted(n for n in sys.modules if n.split('.')[0].startswith('repro'))]))"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, bad, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == []
    assert loaded and all(n.split(".")[0] == "repro_torch" for n in loaded)


def test_forbidden_names_are_compared_whole(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert harness.forbidden_modules() == ["repro"]


def test_run_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "hymba-tiered-chat", "--seed", str(2**31 + 9), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=120,
                         cwd=ROOT)
    assert out.returncode == 2 and out.stdout == ""
