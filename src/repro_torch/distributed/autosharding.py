"""Activation sharding constraints via a logical-axis context (port of
``repro/distributed/autosharding.py``).

Model code calls ``constrain(x, ("batch", "seq", "embed_act"))`` at block
boundaries.  When a :func:`logical_sharding_context` is active and ``x`` is
a DTensor on its mesh, this redistributes ``x`` to the placements its axes
resolve to through the same divisibility-aware rules as everything else;
otherwise (tests, one device, no mesh, a plain tensor) it returns ``x``.
Inside the context, plain tensors meet DTensors as replicated ones.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Placement, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.sharding import (
    ShardingRules,
    local_shape_and_offset,
    partition_spec_for,
    placements_for,
    tree_placements,
)
from repro_torch.pytree import tree_map

_state = threading.local()


def current() -> Optional[Tuple[Any, ShardingRules]]:
    """(mesh, rules) of the innermost active context, or None."""
    stack = getattr(_state, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def logical_sharding_context(mesh: Any, rules: ShardingRules):
    stack = getattr(_state, "stack", None)
    if stack is None:
        stack = _state.stack = []
    stack.append((mesh, rules))
    try:
        # Plain tensors the model makes itself (positions, masks, RoPE
        # tables) take part in DTensor ops as replicated.
        with implicit_replication():
            yield
    finally:
        stack.pop()


class _ReducePartial(torch.autograd.Function):
    """``x`` with partial sums (``Partial`` placements) redistributed to
    ``placements``.  The gradient of a sum with respect to each device's
    addend is the sum's gradient itself, so it goes back replicated on
    those mesh dimensions: DTensor's own backward would hand back a partial
    gradient (divided by the devices), on which the producing product's
    backward gathers its sharded operands and computes them whole on every
    device."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.grad_placements = [Replicate() if isinstance(p, Partial) else p
                               for p in x.placements]
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, grad):
        return grad.redistribute(grad.device_mesh, ctx.grad_placements), None


def constrain(x: torch.Tensor, logical_axes: Sequence[str]) -> torch.Tensor:
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = partition_spec_for(tuple(logical_axes), tuple(x.shape), mesh, rules)
    placements = placements_for(spec, mesh)
    if tuple(x.placements) == placements:
        return x
    if any(isinstance(p, Partial) for p in x.placements):
        return _ReducePartial.apply(x, placements)
    return x.redistribute(x.device_mesh, placements)


def to_local_as(t: torch.Tensor, mesh, placements: Sequence[Placement],
                grad_placements: Optional[Sequence[Placement]] = None) -> torch.Tensor:
    """``t`` (a DTensor, or a plain tensor that stands for a replicated
    one) redistributed to ``placements``; its local shard.  Its gradient
    goes back as a DTensor of ``grad_placements`` (default: ``placements``),
    made contiguous, as the DTensor's strides say it is."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    local = t.to_local(grad_placements=grad_placements)
    if local.requires_grad:
        local.register_hook(lambda g: g.contiguous())
    return local


def from_local(local: torch.Tensor, mesh, placements: Sequence[Placement],
               shape: Sequence[int]) -> DTensor:
    """The DTensor of global ``shape`` whose shard on this device is ``local``
    (made contiguous, as the global strides given say)."""
    stride, acc = [], 1
    for d in reversed(shape):
        stride.append(acc)
        acc *= d
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def pin_grad(x: DTensor) -> DTensor:
    """``x`` unchanged, with its gradient redistributed to ``x``'s own
    placements on the way back: DTensor's backward may otherwise shard a
    gradient along a dimension that a view cannot split (an odd head
    count)."""
    return from_local(to_local_as(x, x.device_mesh, x.placements, x.placements),
                      x.device_mesh, x.placements, x.shape)


def distribute_local(t: torch.Tensor, mesh: Any, placements: Sequence[Placement]) -> DTensor:
    """A DTensor from ``t``, a full tensor that every device holds alike (the
    same seed, the same checkpoint): each device keeps its own shard, with
    no communication.  A replicated tensor is kept as it is, not copied; a
    shard is copied, so the full tensor can be freed."""
    if all(isinstance(p, Replicate) for p in placements):
        local = t
    else:
        shape, offset = local_shape_and_offset(t.shape, mesh, placements)
        local = t
        for d, (n, o) in enumerate(zip(shape, offset)):
            if n != t.shape[d]:
                local = local.narrow(d, o, n)
        local = local.clone(memory_format=torch.contiguous_format)
    return from_local(local, mesh, placements, t.shape)


def distribute_tree(tree: Any, mesh: Any, axes_tree: Any, rules: ShardingRules) -> Any:
    """:func:`distribute_local` over a tree, each leaf placed as its logical
    axes resolve under ``rules``."""
    return tree_map(lambda t, pl: distribute_local(t, mesh, pl), tree,
                    tree_placements(mesh, tree, axes_tree, rules))


#: Mesh axes that shard the batch, and with it the parameters' FSDP dims.
BATCH_AXES = ("pod", "data")


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A meshed weight with its FSDP shards (its dims sharded over the batch
    axes) gathered, as FSDP does before a layer runs: the products then keep
    the activations' batch shards.  On the way back the gradient's partial
    sums over the batch are reduce-scattered onto the shards.  Anything but
    a DTensor is returned as it is."""
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    placements = [Replicate() if names[i] in BATCH_AXES else p
                  for i, p in enumerate(w.placements)]
    if placements == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, placements)
