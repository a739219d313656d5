"""The port on a mesh: real multi-rank runs on gloo, four CPU processes
(``tests/torch_dist_worker.py``) joined through a ``FileStore`` under the
test's temporary directory, each launch with a timeout of its own.

* The qwen2.5 and mamba2 smoke configs (f32) train 3 steps on a (2, 2)
  mesh under ``TRAIN_RULES``: losses within 1e-5 (relative) and every final
  leaf within 1e-5 of the same Trainer without a mesh (which
  ``tests/test_torch_train_step.py`` holds to the reference).
* A checkpoint written on (2, 2) restores onto (4, 1), (1, 1) and no mesh
  with every leaf equal, and the reference's ``restore_checkpoint`` reads
  it: the format is unchanged.
* The llama31 smoke config decodes 4 greedy steps on (2, 2) under
  ``DECODE_RULES`` (K1's CPU implementation, its cache gathered along the
  sequence): logits within 1e-5 of their scale of the unmeshed run, tokens
  equal.  So does the mamba2 smoke config, whose SSM decode step updates
  each device's shard of the state in place (``kernels/ops.py:ssm_step``):
  its final state within 1e-5 of its scale of the unmeshed run's too.
* The dbrx smoke config's MoE layer on (2, 2) dispatches per batch shard,
  as the reference's does under a mesh.
"""

import os
import subprocess
import sys

import jax  # noqa: F401  (the reference reads the checkpoint)
import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import torch_dist_worker as worker  # noqa: E402

from repro.checkpoint.ckpt import restore_checkpoint as ref_restore  # noqa: E402
from repro_torch.checkpoint.ckpt import latest_step, restore_checkpoint  # noqa: E402
from repro_torch.distributed.autosharding import constrain  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.pytree import flatten_with_paths  # noqa: E402

#: Seconds a launch of the ranks may take (they take about 25 s together).
LAUNCH_TIMEOUT = 300


def launch(case: str, world: int, out_dir: str) -> np.lib.npyio.NpzFile:
    """Run ``case`` on ``world`` ranks; rank 0's results."""
    out = os.path.join(out_dir, f"{case}.npz")
    store = os.path.join(out_dir, f"{case}.store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
                               case, str(r), str(world), store, out],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=LAUNCH_TIMEOUT)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return np.load(out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    train = launch("train", 4, d)
    return {"dir": d, "train": train, "restore": launch("restore", 1, d),
            "decode": launch("decode", 4, d), "moe": launch("moe", 4, d)}


@pytest.mark.parametrize("arch", worker.TRAIN_ARCHS)
def test_meshed_train_matches_unmeshed(runs, arch):
    got = runs["train"]
    tr = worker.trainer(arch, None)
    state = tr.train(worker.STEPS)
    losses = np.array([h["loss"] for h in tr.history])
    np.testing.assert_allclose(got[f"{arch}/losses"], losses, rtol=1e-5, atol=0)
    for key, leaf in flatten_with_paths(state):
        np.testing.assert_allclose(got[f"{arch}/state/{key}"], leaf.float().numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)


def _written(runs):
    d = os.path.join(runs["dir"], "ckpt")
    step = latest_step(d)
    assert step == worker.STEPS
    return d, step


@pytest.mark.parametrize("target", ["restored_4x1", "restored_1x1", "no_mesh"])
def test_checkpoint_restores_onto_other_meshes(runs, target):
    d, step = _written(runs)
    trained = {k.split("/", 2)[2]: runs["train"][k] for k in runs["train"].files
               if k.startswith("qwen2.5-3b/state/")}
    if target == "no_mesh":
        template = worker.trainer("qwen2.5-3b", None).init_or_resume(resume=False)
        state, _ = restore_checkpoint(d, step, template)
        got = {k: v.float().numpy() for k, v in flatten_with_paths(state)}
    else:
        src = runs["train"] if target == "restored_4x1" else runs["restore"]
        got = {k.split("/", 1)[1]: src[k] for k in src.files if k.startswith(target + "/")}
    assert sorted(got) == sorted(trained)
    for key in trained:
        np.testing.assert_array_equal(got[key], trained[key], err_msg=key)


def test_reference_reads_meshed_checkpoint(runs):
    import jax.numpy as jnp

    d, step = _written(runs)
    template = worker.trainer("qwen2.5-3b", None).init_or_resume(resume=False)
    ref_template = jax.tree.map(
        lambda t: jnp.zeros(t.shape, jnp.int32 if t.dtype == torch.int32 else jnp.float32),
        _as_jax_tree(template))
    restored, extra = ref_restore(d, step, ref_template)
    assert "loader" in extra
    flat = {"/".join(str(getattr(k, "key", getattr(k, "name", k))) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(restored)[0]}
    for key, leaf in flatten_with_paths(template):
        np.testing.assert_array_equal(np.asarray(flat[key], np.float32),
                                      runs["train"][f"qwen2.5-3b/state/{key}"], err_msg=key)


def _as_jax_tree(state):
    """The port's TrainState as the nested dicts the reference flattens
    alike (dict keys sorted, dataclass fields in order)."""
    import dataclasses

    if dataclasses.is_dataclass(state):
        return {f.name: _as_jax_tree(getattr(state, f.name)) for f in dataclasses.fields(state)
                if getattr(state, f.name) is not None}
    if isinstance(state, dict):
        return {k: _as_jax_tree(v) for k, v in state.items()}
    return state


def test_meshed_decode_matches_unmeshed(runs):
    _decode_matches_unmeshed(runs, "llama31-8b")


def test_meshed_ssm_decode_updates_its_shards_in_place(runs):
    _decode_matches_unmeshed(runs, "mamba2-2.7b")


def _decode_matches_unmeshed(runs, arch):
    got = {k.split("/", 1)[1]: runs["decode"][k] for k in runs["decode"].files
           if k.startswith(arch + "/")}
    cfg = worker.f32_smoke(arch)
    model = TransformerLM(cfg)
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    state = model.init_decode_state(worker.BATCH, worker.PROMPT + worker.DECODE_STEPS, "cpu")
    logits_all, toks = [], []
    with torch.no_grad():
        logits, state = model.prefill(params, worker.decode_tokens(cfg.vocab), state)
        for _ in range(worker.DECODE_STEPS):
            logits_all.append(logits.numpy())
            nxt = logits.argmax(-1)
            toks.append(nxt.numpy())
            logits, state = model.decode_step(params, state, nxt)
        logits_all.append(logits.numpy())
    want = np.stack(logits_all)
    np.testing.assert_array_equal(got["tokens"], np.stack(toks))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got["logits"], want, rtol=0, atol=1e-5 * scale)
    if state.ssm is not None:
        want_h = state.ssm["h"].numpy()
        np.testing.assert_allclose(got["ssm_h"], want_h, rtol=0,
                                   atol=1e-5 * np.abs(want_h).max())


def test_meshed_moe_dispatches_per_batch_shard(runs):
    """The reference's ``_moe_apply_local`` under a mesh: each of the NS = 2
    batch shards dispatches its own tokens with its own capacity (the
    unmeshed layer on each half), and the aux loss is the whole batch's."""
    from repro_torch.models import moe

    cfg, params, x = worker.moe_inputs()
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor, activation=cfg.activation)
    halves = [moe.moe_apply(params, half, **kw)[0] for half in x.split(x.shape[0] // 2)]
    want = torch.cat(halves).numpy()
    np.testing.assert_allclose(runs["moe"]["out"], want, rtol=0, atol=1e-5 * np.abs(want).max())
    _, aux = moe.moe_apply(params, x, **kw)
    np.testing.assert_allclose(runs["moe"]["aux"], aux.numpy(), rtol=1e-5)


def test_constrain_is_identity_without_context():
    x = torch.randn(4, 8, 16)
    assert constrain(x, ("batch", "seq", "embed_act")) is x
