"""One rank of a multi-rank CPU run of the port on gloo (not a test file:
``tests/test_torch_distributed.py`` starts it, one process a rank).

    python tests/torch_dist_worker.py CASE RANK WORLD STORE OUT

Every rank joins the process group from a ``FileStore`` at STORE and runs
CASE; rank 0 writes what the test compares to OUT (an ``.npz``):

* ``train``: the qwen2.5 and mamba2 smoke configs in f32 train 3 steps on a
  (2, 2) mesh; losses and every final leaf, gathered.  The qwen2.5 run
  writes a checkpoint into OUT's directory (``ckpt``), which a Trainer on a
  (4, 1) mesh then restores (elastic resume), gathered again.
* ``restore``: a Trainer on a (1, 1) mesh restores that checkpoint.
* ``decode``: the llama31 and mamba2 smoke configs in f32 prefill 4
  prompts and decode 4 greedy steps under ``DECODE_RULES`` on a (2, 2)
  mesh, every parameter and state leaf a DTensor; logits of every step,
  the tokens and mamba2's final SSM state.
* ``moe``: the dbrx smoke config's MoE layer on a (2, 2) mesh under
  ``TRAIN_RULES``: its output and aux loss.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed.autosharding import (  # noqa: E402
    distribute_tree,
    logical_sharding_context,
)
from repro_torch.distributed.sharding import DECODE_RULES  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import Trainer  # noqa: E402
from repro_torch.models.transformer import TransformerLM  # noqa: E402
from repro_torch.pytree import flatten_with_paths  # noqa: E402

TRAIN_ARCHS = ("qwen2.5-3b", "mamba2-2.7b")
STEPS = 3
BATCH, SEQ = 4, 32
PROMPT, DECODE_STEPS = 8, 4
DECODE_ARCHS = ("llama31-8b", "mamba2-2.7b")


def f32_smoke(arch: str):
    return dataclasses.replace(get_arch(arch).smoke, dtype=torch.float32)


def trainer(arch: str, mesh, ckpt_dir=None) -> Trainer:
    return Trainer(arch, config_override=f32_smoke(arch), global_batch=BATCH, seq_len=SEQ,
                   total_steps=STEPS, ckpt_dir=ckpt_dir, device="cpu", mesh=mesh)


def gathered(state, prefix: str):
    """{prefix/path: full leaf as numpy}, every rank taking part."""
    out = {}
    for key, leaf in flatten_with_paths(state):
        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        out[f"{prefix}/{key}"] = leaf.detach().float().numpy()
    return out


def run_train(out_dir: str):
    ckpt = os.path.join(out_dir, "ckpt")
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    res = {}
    for arch in TRAIN_ARCHS:
        tr = trainer(arch, mesh, ckpt if arch == "qwen2.5-3b" else None)
        state = tr.train(STEPS)
        res[f"{arch}/losses"] = np.array([h["loss"] for h in tr.history])
        res.update(gathered(state, f"{arch}/state"))
    tr = trainer("qwen2.5-3b", make_mesh((4, 1), ("data", "model"), "cpu"), ckpt)
    res.update(gathered(tr.init_or_resume(resume=True), "restored_4x1"))
    return res


def run_restore(out_dir: str):
    tr = trainer("qwen2.5-3b", make_mesh((1, 1), ("data", "model"), "cpu"),
                 os.path.join(out_dir, "ckpt"))
    return gathered(tr.init_or_resume(resume=True), "restored_1x1")


def decode_tokens(vocab: int) -> torch.Tensor:
    return torch.from_numpy(np.random.default_rng(0).integers(0, vocab, (BATCH, PROMPT)))


def run_decode(_out_dir: str):
    res = {}
    for arch in DECODE_ARCHS:
        res.update({f"{arch}/{k}": v for k, v in meshed_decode(arch).items()})
    return res


def meshed_decode(arch: str):
    cfg = f32_smoke(arch)
    model = TransformerLM(cfg)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    params = distribute_tree(model.init(torch.Generator().manual_seed(0), "cpu"), mesh,
                             model.param_axes(), DECODE_RULES)
    state = model.init_decode_state(BATCH, PROMPT + DECODE_STEPS, "cpu")
    state = distribute_tree(state, mesh, model.decode_state_axes(), DECODE_RULES)
    tokens = distribute_tree({"t": decode_tokens(cfg.vocab)}, mesh, {"t": ("batch", "seq")},
                             DECODE_RULES)["t"]
    logits_all, toks = [], []
    with torch.no_grad(), logical_sharding_context(mesh, DECODE_RULES):
        logits, state = model.prefill(params, tokens, state)
        for _ in range(DECODE_STEPS):
            full = logits.full_tensor()
            logits_all.append(full.numpy())
            nxt = full.argmax(-1)
            toks.append(nxt.numpy())
            logits, state = model.decode_step(params, state, nxt)
        logits_all.append(logits.full_tensor().numpy())
    res = {"logits": np.stack(logits_all), "tokens": np.stack(toks)}
    if state.ssm is not None:
        res["ssm_h"] = state.ssm["h"].full_tensor().numpy()
    return res


def moe_inputs(seed: int = 0):
    """The dbrx smoke config's MoE layer (f32) and an input [4, 8, D]."""
    from repro_torch.models import moe

    cfg = f32_smoke("dbrx-132b")
    gen = torch.Generator().manual_seed(seed)
    params = moe.moe_init(cfg.d_model, cfg.d_ff, cfg.n_experts, torch.float32, gen, "cpu")
    x = torch.randn(BATCH, 8, cfg.d_model, generator=gen)
    return cfg, params, x


def run_moe(_out_dir: str):
    from repro_torch.distributed.sharding import TRAIN_RULES
    from repro_torch.models import moe

    cfg, params, x = moe_inputs()
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    axes = dict(moe.MOE_AXES)
    dp = distribute_tree(params, mesh, axes, TRAIN_RULES)
    dx = distribute_tree({"x": x}, mesh, {"x": ("batch", "seq", "embed_act")}, TRAIN_RULES)["x"]
    with logical_sharding_context(mesh, TRAIN_RULES):
        out, aux = moe.moe_apply(dp, dx, top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                                 activation=cfg.activation)
    return {"out": out.full_tensor().numpy(), "aux": aux.full_tensor().numpy()}


def main() -> None:
    case, rank, world, store, out = sys.argv[1:6]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, int(world)), rank=int(rank),
                            world_size=int(world))
    try:
        res = {"train": run_train, "restore": run_restore, "decode": run_decode,
               "moe": run_moe}[case](
            os.path.dirname(out))
        if int(rank) == 0:
            np.savez(out, **res)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
