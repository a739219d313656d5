"""Logical-axis sharding rules on a torch ``DeviceMesh`` (port of
``repro/distributed/sharding.py``).

Every parameter and cache leaf carries a tuple of *logical* axis names
(:meth:`repro_torch.models.transformer.TransformerLM.param_axes`).  A
:class:`ShardingRules` maps each logical axis to an ordered list of
candidate mesh-axis assignments; :func:`partition_spec_for` resolves a
tensor's tuple greedily, as the reference does:

  * a candidate is taken only if the dimension is divisible by the mesh-axis
    (product) size and none of its mesh axes is already used by this tensor;
  * otherwise the next candidate is tried; exhaustion => replicated dim.

The fallback chains encode real alternatives: KV heads shard over ``model``
when the head count divides, and fall back to sharding ``head_dim``
(whisper: 20 heads on a 16-way axis; qwen2.5: 2 KV heads), so tensor
parallelism survives awkward head counts.

A resolved spec is a tuple with one entry per tensor dimension (trailing
replicated dimensions trimmed, as ``PartitionSpec`` trims them): ``None``,
a mesh-axis name, or a tuple of names that shard the dimension jointly,
major first.  :func:`placements_for` turns it into DTensor placements, one
per mesh dimension: ``Shard(d)`` on every mesh dimension that names tensor
dimension ``d``, ``Replicate()`` elsewhere.  DTensor shards one tensor
dimension over several mesh dimensions in mesh order, which is the
major-first order of a joint axis such as ``("pod", "data")`` when the
mesh lists ``pod`` before ``data``, as every mesh of the port does.

Shape-kind differences:
  * train/prefill: batch over (pod, data); params FSDP over data x TP model.
  * decode:        batch over (pod, data); KV cache along its sequence over
    model (the kernel gathers it back: see ``kernels/ops.py``).
  * long-context decode (batch=1): KV *sequence* shards over every axis
    (context parallelism); batch replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

from torch.distributed.tensor import Placement, Replicate, Shard

from repro_torch.pytree import tree_leaves, tree_map

Candidate = Union[str, Tuple[str, ...]]
#: One tensor's resolved spec: per dimension None, an axis, or a joint axis.
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    name: str
    rules: Dict[str, List[Candidate]]

    def candidates(self, logical: str) -> List[Candidate]:
        return self.rules.get(logical, [])


def _base_rules(extra: Dict[str, List[Candidate]]) -> Dict[str, List[Candidate]]:
    rules: Dict[str, List[Candidate]] = {
        # parameters
        "layers": [],
        "embed": ["data"],  # FSDP shard
        "ffn": ["model"],
        "vocab": ["model"],
        "q_heads": ["model"],
        "kv_heads": ["model"],
        "head_dim": ["model"],  # fallback TP when heads don't divide
        "experts": ["model"],  # expert parallelism
        "experts_r": [],
        "ssm_proj": ["model"],
        "ssm_inner": ["model"],
        "ssm_conv_dim": ["model"],
        "ssm_heads": ["model"],
        "ssm_head_dim": ["model"],
        "ssm_state": [],
        "conv": [],
        # activations
        "batch": [("pod", "data"), "data"],
        "seq": [],
        "kv_seq": [],
        #: KV-cache-specific axes (decoupled from the weight head axes so
        #: decode can choose a cache layout independently of weight TP)
        "cache_heads": ["model"],
        "cache_dim": ["model"],
        # residual-stream feature dim: replicated (TP acts on heads/ffn)
        "embed_act": [],
        #: MoE dispatch buffer capacity dim over the batch axes
        "moe_cap": [("pod", "data"), "data"],
        "gathered": [],  # explicit "replicate now" (forces a weight gather)
        "data_shards": [("pod", "data"), "data"],  # shard-major MoE dispatch
        "moe_tok": [],
        "moe_cap_l": [],
    }
    rules.update(extra)
    return rules


TRAIN_RULES = ShardingRules("train", _base_rules({}))
#: Decode: the KV cache along its sequence over the model axis, cache
#: head/dim axes replicated, and no FSDP dim on weights (an embed-sharded
#: weight would be gathered every token).
DECODE_RULES = ShardingRules(
    "decode",
    _base_rules({
        "kv_seq": ["model"],
        "cache_heads": [],
        "cache_dim": [],
        "embed": [],
    }),
)
#: batch=1 long-context decode: context-parallel KV over (pod, data) AND
#: model — 500k tokens spread over every device; batch replicated.
LONG_CONTEXT_RULES = ShardingRules(
    "long_context",
    _base_rules({
        "batch": [],
        "kv_seq": [("pod", "data", "model"), ("data", "model"), "data"],
        "cache_heads": [],
        "cache_dim": [],
        "embed": ["data"],  # batch=1: data axis is otherwise idle; FSDP free
    }),
)


def rules_for_shape(kind: str, global_batch: int) -> ShardingRules:
    if kind == "decode" and global_batch == 1:
        return LONG_CONTEXT_RULES
    if kind == "decode":
        return DECODE_RULES
    return TRAIN_RULES


def mesh_axes(mesh: Any) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` with named dimensions, or of a
    mapping that stands for one (a mesh of any size without devices)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh needs named dimensions")
    return {n: int(s) for n, s in zip(names, mesh.shape)}


def _axis_size(sizes: Mapping[str, int], cand: Candidate) -> Optional[int]:
    names = (cand,) if isinstance(cand, str) else cand
    size = 1
    for n in names:
        if n not in sizes:
            return None
        size *= sizes[n]
    return size


def partition_spec_for(logical_axes: Sequence[str], shape: Sequence[int], mesh: Any,
                       rules: ShardingRules) -> Spec:
    sizes = mesh_axes(mesh)
    used: set = set()
    out: List[Any] = []
    for dim, logical in zip(shape, logical_axes):
        assigned = None
        for cand in rules.candidates(logical):
            names = (cand,) if isinstance(cand, str) else tuple(cand)
            size = _axis_size(sizes, cand)
            if size is None or size <= 1:
                continue
            if any(n in used for n in names):
                continue
            if dim % size != 0:
                continue
            assigned = names if len(names) > 1 else names[0]
            used.update(names)
            break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def placements_for(spec: Spec, mesh: Any) -> Tuple[Placement, ...]:
    """The spec as one DTensor placement per mesh dimension."""
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            where[name] = d
    return tuple(Shard(where[n]) if n in where else Replicate() for n in mesh_axes(mesh))


def shard_shape(shape: Sequence[int], spec: Spec, mesh: Any) -> Tuple[int, ...]:
    """One device's local shape of a tensor of ``shape`` laid out by ``spec``."""
    sizes = mesh_axes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            out[d] //= sizes[name]
    return tuple(out)


def local_shape_and_offset(shape: Sequence[int], mesh: Any,
                           placements: Sequence[Placement]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """This rank's shard of a tensor of ``shape`` laid out by DTensor
    ``placements`` on ``mesh``: (local shape, offset of its first element),
    each tensor dimension split evenly over the mesh dimensions that shard
    it, in mesh order."""
    size, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if size[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} does not split "
                                 f"evenly over {n} devices")
            size[p.dim] //= n
            offset[p.dim] += coord[i] * size[p.dim]
    return tuple(size), tuple(offset)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, str) for a in x)


def tree_specs(shapes_tree: Any, axes_tree: Any, mesh: Any, rules: ShardingRules) -> Any:
    """Resolved specs of a tree whose leaves have ``.shape`` (tensors, meta
    or fake tensors), given the matching tree of logical-axis tuples."""
    axes = tree_leaves_axes(axes_tree)
    leaves = tree_leaves(shapes_tree)
    if len(axes) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(axes)} axis tuples")
    specs = iter([partition_spec_for(a, tuple(t.shape), mesh, rules)
                  for a, t in zip(axes, leaves)])
    return tree_map(lambda _: next(specs), shapes_tree)


def tree_placements(mesh: Any, shapes_tree: Any, axes_tree: Any,
                    rules: ShardingRules) -> Any:
    """DTensor placements for a tree given its logical axes (the
    reference's ``tree_shardings``)."""
    return tree_map(lambda spec: placements_for(spec, mesh),
                    tree_specs(shapes_tree, axes_tree, mesh, rules))


def tree_leaves_axes(axes_tree: Any) -> List[Tuple[str, ...]]:
    """The axis tuples of an axes tree in flatten order (a tuple of names is
    a leaf, not a node)."""
    if axes_tree is None:
        return []
    if _is_axes(axes_tree):
        return [axes_tree]
    if isinstance(axes_tree, dict):
        return [a for k in sorted(axes_tree) for a in tree_leaves_axes(axes_tree[k])]
    if dataclasses.is_dataclass(axes_tree):
        return [a for f in dataclasses.fields(axes_tree)
                for a in tree_leaves_axes(getattr(axes_tree, f.name))]
    raise TypeError(f"not an axes tree: {axes_tree!r}")


def input_sharding_axes(kind: str) -> Dict[str, Any]:
    """Logical axes for step-function inputs by shape kind."""
    if kind == "train":
        return {
            "tokens": ("batch", "seq"),
            "labels": ("batch", "seq"),
            "frontend_embeds": ("batch", "seq", "embed_act"),
        }
    if kind == "prefill":
        return {
            "tokens": ("batch", "seq"),
            "frontend_embeds": ("batch", "seq", "embed_act"),
        }
    if kind == "decode":
        return {"token": ("batch",)}
    raise ValueError(kind)


def bytes_per_device(shapes_tree: Any, specs_tree: Any, mesh: Any) -> int:
    """Static byte footprint of one device's shards of a tree (leaves with
    ``.shape`` and ``.dtype``) laid out by the matching tree of specs."""
    total = 0
    for t, spec in zip(tree_leaves(shapes_tree), tree_leaves(specs_tree)):
        n = 1
        for d in shard_shape(tuple(t.shape), spec, mesh):
            n *= d
        total += n * t.dtype.itemsize
    return total
