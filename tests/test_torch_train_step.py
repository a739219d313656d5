"""Port parity: the train step (repro_torch.train.step.make_train_step)
against the reference's (repro.train.step, jitted) for 3 steps in f32, both
started from one TrainState carried across through numpy
(train_state_from_numpy), on the smoke configs of qwen2.5-3b (QKV bias, tied
embedding), h2o-danube (sliding window), mamba2 (the scan, through K4's
autograd Function on the CPU) and dbrx (the MoE aux loss), and qwen2.5 with
2 microbatches, alone and with int8 error-feedback compression.

Tolerances (f32): loss, aux_loss and lr within 1e-6 relative; grad_norm
within 1e-5; each leaf of m and v within 1e-4 of that leaf's largest value
(they are linear in the gradients and their squares); params and the
master copy elementwise within 1e-5 absolute + 1e-5 relative.  AdamW
divides by sqrt(v), so an element whose gradient is rounding noise moves
by up to a step's rate whatever the noise: the params' bound is in units
of the rate (1e-3), not of the leaf.  With compression the int8 rounding of
(g + residual) / scale is discontinuous: an element within f32 noise of a
half-quantum rounds the other way in one framework.  So there each
ef_residual element is held within one quantum (twice the residual's
bound) and all but 0.1% of them within 1e-2 of a quantum (the residual is
g less its rounding, a difference of numbers up to 127 quanta, so 1e-6 of
the gradient is 1e-4 of a quantum); every other leaf is held as without
compression on all but 0.1% of its elements (the flipped ones)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.models.transformer import TransformerLM as JaxLM
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.schedule import warmup_cosine as jax_warmup_cosine
from repro.train.step import init_train_state as jax_init_train_state
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_arch as port_arch
from repro_torch.models.transformer import TransformerLM
from repro_torch.models.weights import train_state_from_numpy
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.pytree import flatten_with_paths
from repro_torch.train.step import make_train_step

torch.set_num_threads(1)

PEAK_LR = 1e-3
STEPS = 3
SCALAR_RTOL = {"loss": 1e-6, "aux_loss": 1e-6, "lr": 1e-6, "grad_norm": 1e-5}
MOMENT_REL = 1e-4
PARAM_TOL = dict(atol=1e-5, rtol=1e-5)
CASES = {  # id: (arch, microbatches, grad_compression)
    "qwen2.5-3b": ("qwen2.5-3b", 1, False),
    "h2o-danube-1.8b": ("h2o-danube-1.8b", 1, False),
    "mamba2-2.7b": ("mamba2-2.7b", 1, False),
    "dbrx-132b": ("dbrx-132b", 1, False),
    "qwen2.5-3b-microbatches2": ("qwen2.5-3b", 2, False),
    "qwen2.5-3b-microbatches2-compressed": ("qwen2.5-3b", 2, True),
}


def _schedule(warmup_cosine_fn):
    return lambda s: warmup_cosine_fn(s, peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)


def _run_both(arch, microbatches, compression):
    jcfg = dataclasses.replace(get_arch(arch).smoke, dtype=jnp.float32)
    tcfg = dataclasses.replace(port_arch(arch).smoke, dtype=torch.float32)
    jmodel, jopt = JaxLM(jcfg), JaxAdamW()
    jstep = jax.jit(jax_make_train_step(jmodel, jopt, _schedule(jax_warmup_cosine),
                                        microbatches=microbatches,
                                        grad_compression=compression))
    jstate = jax_init_train_state(jmodel, jopt, jax.random.PRNGKey(0),
                                  grad_compression=compression)
    tstate = train_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    tstep = make_train_step(TransformerLM(tcfg), AdamW(), _schedule(warmup_cosine),
                            microbatches=microbatches, grad_compression=compression)
    rng = np.random.default_rng(7)
    metrics = []
    for _ in range(STEPS):
        tokens = rng.integers(1, jcfg.vocab, (4, 32)).astype(np.int32)
        labels = rng.integers(1, jcfg.vocab, (4, 32)).astype(np.int32)
        jstate, jm = jstep(jstate, jnp.asarray(tokens), jnp.asarray(labels))
        tstate, tm = tstep(tstate, torch.from_numpy(tokens), torch.from_numpy(labels))
        metrics.append(({k: float(v) for k, v in jm.items()},
                        {k: float(v) for k, v in tm.items()}))
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, jstate)))
    got = {k: v.float().numpy() for k, v in flatten_with_paths(tstate)}
    return metrics, got, want


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(case):
    arch, microbatches, compression = CASES[case]
    metrics, got, want = _run_both(arch, microbatches, compression)
    assert sorted(got) == sorted(want)
    for step, (jm, tm) in enumerate(metrics):
        assert sorted(jm) == sorted(tm)
        for k, rtol in SCALAR_RTOL.items():
            np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-7,
                                       err_msg=f"step {step} {k}")
    assert metrics[0][1]["lr"] == 0.0 and metrics[1][1]["lr"] > 0.0
    if arch == "dbrx-132b":
        assert all(tm["aux_loss"] > 0 for _, tm in metrics)
    for key, w in want.items():
        g = got[key]
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, key
        scale = max(float(np.abs(w).max()), 1e-30)
        err = np.abs(g - w)
        if key == "opt/step":
            assert int(g) == int(w) == STEPS
            continue
        if key.startswith("ef_residual/"):
            quantum = 2 * scale  # |residual| <= quantum / 2
            assert err.max() <= 1.01 * quantum, key
            bad = err > 1e-2 * quantum
        elif key.startswith(("opt/m/", "opt/v/")):
            bad = err > MOMENT_REL * scale
        else:
            bad = err > PARAM_TOL["atol"] + PARAM_TOL["rtol"] * np.abs(w)
        if compression:
            assert bad.mean() <= 1e-3, (key, int(bad.sum()), bad.size)
        else:
            assert not bad.any(), (key, float(err.max()), scale)
