"""Training entry point (port of ``repro/launch/train.py``): checkpoint/restart,
preemption handling, the straggler governor.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 --ckpt-dir ck
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5 --ckpt-dir ck --resume
  PYTHONPATH=src python -m repro_torch.launch.train --full --steps 6

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3 --mesh 1x1

Runs on the card unless ``--device cpu`` (and raises without CUDA).  The
data loader's state rides in each checkpoint's ``extra``, so a resumed run
sees the batches a straight run would; SIGTERM (a preemption notice)
writes a checkpoint and exits.  Checkpoints are the reference's format:
either framework resumes the other's.

With a mesh (``Trainer(mesh=...)``, ``--mesh DATAxMODEL`` over the ranks of
the process group, which one process starts alone), the state is
distributed per ``TRAIN_RULES`` (FSDP over ``data``, tensor parallelism over
``model``), a resume restores the newest checkpoint onto this mesh whatever
mesh wrote it, each global batch from the loader is distributed over the
batch axes, and the step runs inside ``logical_sharding_context``.  Every
rank draws the same seed and the same batches and keeps its own shards.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import math
import signal
import sys
import time
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.ckpt import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.core.controller import StragglerGovernor
from repro_torch.core.substrate import ControlLoop, StepTimingSubstrate
from repro_torch.data.pipeline import HostDataLoader, SyntheticTokenDataset
from repro_torch.device import resolve_device
from repro_torch.distributed.autosharding import distribute_local, logical_sharding_context
from repro_torch.distributed.sharding import (
    TRAIN_RULES,
    partition_spec_for,
    placements_for,
    tree_placements,
)
from repro_torch.launch.mesh import make_host_mesh, parse_mesh
from repro_torch.models.transformer import TransformerLM
from repro_torch.optim.adamw import AdamW, local_shard
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.pytree import tree_map
from repro_torch.train.step import (
    TrainState,
    init_train_state,
    make_train_step,
    train_state_axes,
)


class Trainer:
    def __init__(
        self,
        arch_id: str,
        *,
        smoke: bool = False,
        global_batch: int = 8,
        seq_len: int = 128,
        microbatches: int = 1,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 10,
        grad_compression: bool = False,
        remat: str = "none",
        peak_lr: float = 3e-4,
        total_steps: int = 1000,
        config_override=None,
        device=None,
        mesh=None,
    ):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.rules = TRAIN_RULES
        spec = get_arch(arch_id)
        self.cfg = config_override or (spec.smoke if smoke else spec.config)
        self.model = TransformerLM(self.cfg, remat=remat)
        self.opt = AdamW()
        self.global_batch = global_batch
        self.seq_len = seq_len
        warmup = min(100, total_steps // 10 + 1)

        def sched(s):
            return warmup_cosine(s, peak_lr=peak_lr, warmup_steps=warmup,
                                 total_steps=total_steps)

        self.step_fn = make_train_step(self.model, self.opt, sched, microbatches=microbatches,
                                       grad_compression=grad_compression)
        self.loader = HostDataLoader(SyntheticTokenDataset(vocab=self.cfg.vocab),
                                     global_batch=global_batch, seq_len=seq_len)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.ckpt_every = ckpt_every
        # Straggler control plane: per-host step times flow through the same
        # substrate/ControlLoop interface as the memory tiers; the substrate
        # returns a plain (step_times,) tuple, which the loop splats into the
        # governor's window(step_times).  One host here, one window a step.
        self.governor = StragglerGovernor(n_hosts=1)
        self.step_substrate = StepTimingSubstrate(n_hosts=1)
        self.straggler_loop = ControlLoop(self.step_substrate, self.governor, window_ns=1.0,
                                          record=False, max_history=64)
        self.grad_compression = grad_compression
        #: The newest steps' ``{"step", "loss", "seconds"}``, wall time of
        #: each step's host loop (the loss read back ends it).
        self.history: collections.deque = collections.deque(maxlen=1000)
        self._preempted = False

    def init_or_resume(self, resume: bool) -> TrainState:
        """Fresh state (params from ``TransformerLM.init`` on a generator
        seeded 0), or the latest checkpoint's in its place with the
        loader's position restored."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        state = init_train_state(self.model, self.opt, gen, self.device,
                                 grad_compression=self.grad_compression)
        placements = None
        if self.mesh is not None:
            axes = train_state_axes(self.model, self.opt,
                                    grad_compression=self.grad_compression)
            placements = tree_map(lambda pl: (self.mesh, pl),
                                  tree_placements(self.mesh, state, axes, self.rules))
            state = tree_map(lambda leaf, mp: distribute_local(leaf, *mp), state, placements)
        if resume and self.ckpt is not None:
            step, restored, extra = self.ckpt.restore_latest(state, placements=placements)
            if step is not None:
                where = f" (elastic onto {tuple(self.mesh.shape)})" if self.mesh else ""
                print(f"[train] resumed from step {step}{where}")
                if extra and "loader" in extra:
                    self.loader.load_state_dict(extra["loader"])
                return restored
        return state

    def install_preemption_handler(self) -> None:
        def handler(signum, frame):
            del signum, frame
            print("[train] SIGTERM: checkpoint-and-exit requested")
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def _batch(self, array) -> torch.Tensor:
        """A global batch from the loader on the device, distributed over the
        batch axes on a mesh."""
        t = torch.from_numpy(array).to(self.device)
        if self.mesh is None:
            return t
        spec = partition_spec_for(("batch", "seq"), t.shape, self.mesh, self.rules)
        return distribute_local(t, self.mesh, placements_for(spec, self.mesh))

    def step(self, state: TrainState, tokens, labels):
        """One train step on a global batch (numpy arrays from the loader):
        (state, metrics)."""
        ctx = (logical_sharding_context(self.mesh, self.rules) if self.mesh is not None
               else contextlib.nullcontext())
        with ctx:
            state, metrics = self.step_fn(state, self._batch(tokens), self._batch(labels))
        return state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                       for k, v in metrics.items()}

    def train(self, steps: int, *, resume: bool = False, log_every: int = 1) -> TrainState:
        self.install_preemption_handler()
        state = self.init_or_resume(resume)
        start_step = int(local_shard(state.opt.step))
        for step in range(start_step, steps):
            t0 = time.time()
            tokens, labels = next(self.loader)
            state, metrics = self.step(state, tokens, labels)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            # Straggler governor window: this host's step service time, then
            # the control loop (estimate -> HostHealth -> per-host rates).
            self.step_substrate.record_step(0, dt)
            self.straggler_loop.fire()
            self.history.append({"step": step, "loss": loss, "seconds": dt})
            if step % log_every == 0:
                print(f"[train] step={step} loss={loss:.4f} ({dt * 1e3:.0f} ms)")
            if math.isnan(loss):
                raise FloatingPointError(f"NaN loss at step {step}")
            if self.ckpt and ((step + 1) % self.ckpt_every == 0 or self._preempted):
                self.ckpt.save(step + 1, state, extra={"loader": self.loader.state_dict()})
            if self._preempted:
                print("[train] preemption checkpoint written; exiting")
                self.ckpt and self.ckpt.wait()
                sys.exit(0)
        if self.ckpt:
            self.ckpt.save(steps, state, extra={"loader": self.loader.state_dict()})
            self.ckpt.wait()
        return state


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--remat", default="none")
    ap.add_argument("--device", default=None, help="cpu for the plain path (default: the card)")
    ap.add_argument("--mesh", default=None, help="DATAxMODEL over the process group's ranks")
    args = ap.parse_args()
    mesh = None
    if args.mesh:
        data, model = parse_mesh(args.mesh)
        mesh = make_host_mesh(data=data, model=model, device=args.device)
    trainer = Trainer(
        args.arch, smoke=args.smoke, global_batch=args.global_batch, seq_len=args.seq_len,
        microbatches=args.microbatches, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        grad_compression=args.grad_compression, remat=args.remat, total_steps=args.steps,
        device=args.device, mesh=mesh,
    )
    trainer.train(args.steps, resume=args.resume)


if __name__ == "__main__":
    main()
