"""Port parity: checkpoints (repro_torch.checkpoint) and the Trainer's
resume.  Ports of tests/test_checkpoint.py (round trip, latest and
retention, the manifest's extra, a shape mismatch) and of
tests/test_system.py::test_train_checkpoint_resume_bit_exact; the
reference's format written by both frameworks alike; and both directions
across them: the reference's Trainer writes step 1 and the port's resumes
to step 2, matching the reference's straight step 2, and the reference's
restore_checkpoint reads what the port wrote, leaf for leaf.  Restoring
onto another mesh (the reference's elastic test) waits for the port's
distribution layer.

Tolerances: round trips and the cross-framework restore are exact; the
resumed step against the straight one, in one framework, 1e-6 (the
reference's); the port's step 2 after the reference's step 1 against the
reference's straight step 2 (f32): m and v within 1e-4 of each leaf's
scale, params and master within 1e-5 absolute + 1e-5 relative, as in
tests/test_torch_train_step.py."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_arch
from repro.launch.train import Trainer as JaxTrainer
from repro.models.transformer import TransformerLM as JaxLM
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train.step import init_train_state as jax_init_train_state
from repro_torch.checkpoint.ckpt import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_arch as port_arch
from repro_torch.launch.train import Trainer
from repro_torch.pytree import flatten_with_paths, tree_leaves

torch.set_num_threads(1)


def state_tree(scale=1.0):
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4) * scale,
                   "b": torch.ones((4,), dtype=torch.bfloat16) * scale},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves_equal(a, b):
    for (ka, x), (kb, y) in zip(flatten_with_paths(a), flatten_with_paths(b)):
        assert ka == kb and x.dtype == y.dtype and x.shape == y.shape, (ka, kb)
        assert torch.equal(x, y), ka


def test_roundtrip_exact(tmp_path):
    st = state_tree()
    save_checkpoint(str(tmp_path), 7, st)
    restored, extra = restore_checkpoint(str(tmp_path), 7, st)
    _leaves_equal(st, restored)
    assert extra == {}


def test_latest_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state_tree(scale=float(s)))
    mgr.wait()
    assert latest_step(str(tmp_path)) == 4
    kept = sorted(os.listdir(str(tmp_path)))
    assert len([k for k in kept if k.startswith("step_")]) == 2
    step, restored, _ = mgr.restore_latest(state_tree())
    assert step == 4
    _leaves_equal(state_tree(scale=4.0), restored)


def test_manager_snapshots_the_state_at_save(tmp_path):
    """The train step updates its state in place: what is written is the
    state as it was when save was called."""
    mgr = CheckpointManager(str(tmp_path))
    st = state_tree()
    mgr.save(1, st)
    st["params"]["w"].add_(100.0)
    mgr.wait()
    restored, _ = restore_checkpoint(str(tmp_path), 1, state_tree())
    _leaves_equal(state_tree(), restored)


def test_manifest_extra_roundtrip(tmp_path):
    st = state_tree()
    save_checkpoint(str(tmp_path), 3, st, extra={"loader": {"step": 42}})
    _, extra = restore_checkpoint(str(tmp_path), 3, st)
    assert extra["loader"]["step"] == 42


def test_shape_mismatch_rejected(tmp_path):
    st = state_tree()
    save_checkpoint(str(tmp_path), 1, st)
    bad = {"params": {"w": torch.zeros((2, 4)), "b": torch.zeros((4,), dtype=torch.bfloat16)},
           "step": torch.tensor(0, dtype=torch.int32)}
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), 1, bad)


def test_missing_leaf_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, state_tree())
    more = state_tree()
    more["params"]["extra"] = torch.zeros(2)
    with pytest.raises(KeyError, match="params/extra"):
        restore_checkpoint(str(tmp_path), 1, more)


def test_format_equals_the_references(tmp_path):
    """The same tree written by each framework: the same manifest (keys in
    the reference's flatten order, leaf names, shapes, dtype names) and the
    same bytes in every array."""
    st = state_tree()
    st["params"]["z"] = {"a": torch.full((2, 3), 0.1, dtype=torch.float32)}
    ref_state = {"params": {"w": jnp.asarray(st["params"]["w"].numpy()),
                            "b": jnp.ones((4,), jnp.bfloat16),
                            "z": {"a": jnp.full((2, 3), 0.1, jnp.float32)}},
                 "step": jnp.asarray(7, jnp.int32)}
    save_checkpoint(str(tmp_path / "port"), 5, st, extra={"k": 1})
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, ref_state, extra={"k": 1})
    manifests, arrays = [], []
    for side in ("port", "ref"):
        d = tmp_path / side / "step_00000005"
        manifests.append(json.loads((d / "manifest.json").read_text()))
        arrays.append(dict(np.load(d / "arrays.npz")))
    assert manifests[0] == manifests[1]
    assert [e["key"] for e in manifests[0]["leaves"]] == [
        "params/b", "params/w", "params/z/a", "step"]
    assert [e["dtype"] for e in manifests[0]["leaves"]] == [
        "bfloat16", "float32", "float32", "int32"]
    for name, arr in arrays[1].items():
        assert arrays[0][name].dtype == arr.dtype and arrays[0][name].tobytes() == arr.tobytes()


# -- the Trainer: resume, and across the frameworks -------------------------------------------


def test_train_checkpoint_resume_bit_exact(tmp_path):
    """Port of tests/test_system.py::test_train_checkpoint_resume_bit_exact:
    two paths to step 2, straight and checkpoint + resume, agree."""
    kw = dict(smoke=True, global_batch=2, seq_len=32, ckpt_every=1, device="cpu")
    t1 = Trainer("qwen2.5-3b", ckpt_dir=str(tmp_path / "a"), **kw)
    s1 = t1.train(2, log_every=100)
    t2 = Trainer("qwen2.5-3b", ckpt_dir=str(tmp_path / "b"), **kw)
    t2.train(1, log_every=100)
    t3 = Trainer("qwen2.5-3b", ckpt_dir=str(tmp_path / "b"), **kw)
    s3 = t3.train(2, resume=True, log_every=100)
    assert int(s3.opt.step) == 2 and t3.loader.step == 2
    for (k, a), (_, b) in zip(flatten_with_paths(s1), flatten_with_paths(s3)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), atol=1e-6, rtol=1e-6,
                                   err_msg=k)


def _f32_smoke(arch):
    return (dataclasses.replace(get_arch(arch).smoke, dtype=jnp.float32),
            dataclasses.replace(port_arch(arch).smoke, dtype=torch.float32))


def _reference_run(jcfg, steps, ckpt_dir=None):
    """The reference Trainer's loop (step function, loader, checkpoint with
    the loader's state), driven here: in an f32 config its master copy is
    the params' own buffers (``astype`` to their dtype) and its jitted step
    donates both, which XLA refuses, so the master is copied first."""
    t = JaxTrainer("qwen2.5-3b", config_override=jcfg, global_batch=2, seq_len=32,
                   ckpt_dir=ckpt_dir)
    state = t.init_or_resume(False)
    state = dataclasses.replace(state, opt=dataclasses.replace(
        state.opt, master=jax.tree.map(jnp.copy, state.opt.master)))
    with t.mesh:
        for _ in range(steps):
            tokens, labels = next(t.loader)
            state, _ = t.step_fn(state, jnp.asarray(tokens), jnp.asarray(labels))
    if t.ckpt:
        t.ckpt.save(steps, state, extra={"loader": t.loader.state_dict()})
        t.ckpt.wait()
    return state


def test_port_resumes_a_reference_checkpoint(tmp_path, capsys):
    jcfg, tcfg = _f32_smoke("qwen2.5-3b")
    straight = _reference_run(jcfg, 2)
    _reference_run(jcfg, 1, str(tmp_path))
    port = Trainer("qwen2.5-3b", config_override=tcfg, global_batch=2, seq_len=32,
                   ckpt_dir=str(tmp_path), device="cpu")
    resumed = port.train(2, resume=True, log_every=100)
    assert "resumed from step 1" in capsys.readouterr().out
    want = dict(flatten_with_paths(jax.tree.map(np.asarray, straight)))
    got = dict(flatten_with_paths(resumed))
    assert sorted(want) == sorted(got)
    for key, g in got.items():
        g, w = g.float().numpy(), np.asarray(want[key], np.float32)
        if key.startswith(("opt/m/", "opt/v/")):
            assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), key
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5, err_msg=key)


def test_reference_restores_a_port_checkpoint(tmp_path):
    jcfg, tcfg = _f32_smoke("mamba2-2.7b")
    port = Trainer("mamba2-2.7b", config_override=tcfg, global_batch=2, seq_len=32,
                   ckpt_dir=str(tmp_path), grad_compression=True, device="cpu")
    state = port.train(2, log_every=100)
    jmodel, jopt = JaxLM(jcfg), JaxAdamW()
    template = jax_init_train_state(jmodel, jopt, jax.random.PRNGKey(1), grad_compression=True)
    restored, extra = ref_ckpt.restore_checkpoint(str(tmp_path), 2, template)
    assert extra["loader"]["step"] == 2
    want = flatten_with_paths(state)
    got = jax.tree_util.tree_flatten_with_path(restored)[0]
    assert len(got) == len(want) == len(tree_leaves(state))
    for (path, leaf), (key, w) in zip(got, want):
        assert "/".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path) == key
        assert str(leaf.dtype) == str(w.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(leaf, np.float32), w.float().numpy())
