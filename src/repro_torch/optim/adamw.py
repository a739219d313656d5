"""AdamW with an optional f32 master copy (port of ``repro/optim/adamw.py``).

Optimizer state mirrors the parameter tree leaf for leaf: ``m`` and ``v``
are f32, ``step`` an int32 scalar, ``master`` the f32 master parameters or
None (``master=False``: params updated from their own dtype).  The update
is the reference's formula in the reference's order of operations, written
in place into ``m``, ``v``, the master copy and the parameters, a bounded
flat chunk of a leaf at a time: the card holds no whole-leaf temporaries
beside the state (qwen2.5-3b's largest leaf is 3.25 GB in f32).

On a mesh every leaf is a DTensor whose gradient, moments and master copy
share its placements, so the elementwise update runs on each device's
local shards; the global norm sums each shard's squares once across the
mesh (a replicated leaf counts once, not once per device).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterator, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.pytree import tree_leaves, tree_map

#: Elements of one flat chunk of a leaf in the in-place passes (128 MB of f32).
CHUNK = 1 << 25


def local_shard(t: Any) -> Any:
    """A DTensor's shard on this device (the tensor itself otherwise)."""
    return t.to_local() if isinstance(t, DTensor) else t


def flat_chunks(*tensors: Optional[torch.Tensor]) -> Iterator[List[Optional[torch.Tensor]]]:
    """Matching flat chunks of same-shaped contiguous tensors, or of the
    local shards of DTensors placed alike (None stays None): elementwise
    passes over them compute what one pass over the whole would."""
    flats = [None if t is None else local_shard(t).view(-1) for t in tensors]
    n = flats[0].numel()
    for start in range(0, n, CHUNK):
        yield [None if f is None else f[start:start + CHUNK] for f in flats]


@dataclasses.dataclass
class OptState:
    step: torch.Tensor  # [] int32
    m: Any  # f32 tree
    v: Any  # f32 tree
    master: Optional[Any]  # f32 master params, or None


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master: bool = True

    def init(self, params: Any) -> OptState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        device = tree_leaves(params)[0].device
        master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True), params)
                  if self.master else None)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                        m=tree_map(zeros, params), v=tree_map(zeros, params), master=master)

    def init_shapes(self, param_specs: Any) -> OptState:
        """The state's leaves as meta tensors (the dry run's shapes)."""
        def f32(p):
            return torch.empty(p.shape, dtype=torch.float32, device="meta")

        return OptState(step=torch.empty((), dtype=torch.int32, device="meta"),
                        m=tree_map(f32, param_specs), v=tree_map(f32, param_specs),
                        master=tree_map(f32, param_specs) if self.master else None)

    def state_axes(self, param_axes: Any) -> OptState:
        """Logical axes matching init's tree (the params' for every leaf)."""
        return OptState(step=(), m=param_axes, v=param_axes,
                        master=param_axes if self.master else None)

    @torch.no_grad()
    def update(self, grads: Any, state: OptState, params: Any, lr: torch.Tensor
               ) -> Tuple[Any, OptState]:
        """One AdamW step at rate ``lr``, written in place: returns
        ``(params, state)``, the same objects, updated.  Params are written
        back in their own dtype (from the master copy when there is one)."""
        state.step.add_(1)
        step = local_shard(state.step).to(torch.float32)
        lr = local_shard(lr)
        bc1 = 1.0 - self.b1 ** step
        bc2 = 1.0 - self.b2 ** step
        masters = (tree_leaves(state.master) if state.master is not None
                   else [None] * len(tree_leaves(params)))
        for g, m, v, p, ref in zip(tree_leaves(grads), tree_leaves(state.m),
                                   tree_leaves(state.v), tree_leaves(params), masters):
            for gc, mc, vc, pc, rc in flat_chunks(g, m, v, p, ref):
                g32 = gc.to(torch.float32)
                mc.mul_(self.b1).add_(g32 * (1 - self.b1))
                vc.mul_(self.b2).add_(torch.square(g32).mul_(1 - self.b2))
                del g32
                upd = mc / bc1  # mhat
                upd.div_((vc / bc2).sqrt_().add_(self.eps))
                base = rc if rc is not None else pc.to(torch.float32)
                upd.add_(base * self.weight_decay).mul_(lr)
                if rc is not None:
                    rc.sub_(upd)
                    pc.copy_(rc)
                else:
                    pc.copy_(base - upd)
        return params, state


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / global norm)`` (the norm
    of all leaves in f32), each leaf rounded back to its dtype; written in
    place.  Returns ``(grads, global norm)``."""
    leaves = tree_leaves(grads)
    sumsq = sum(torch.sum(torch.square(g.to(torch.float32))) for g in leaves)
    if isinstance(sumsq, DTensor):  # partial sums over the sharded mesh dims
        sumsq = sumsq.full_tensor()
    gnorm = torch.sqrt(sumsq)
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for g in leaves:
        for (gc,) in flat_chunks(g):
            gc.copy_(gc.to(torch.float32) * scale)
    return grads, gnorm
