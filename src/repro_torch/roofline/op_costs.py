"""Per-device op costs of one step, counted as it runs (the port's
counterpart of ``repro/roofline/hlo_costs.py``).

The reference parses the partitioned HLO, whose shapes are per device.  The
port runs eagerly, so :class:`count_costs` is a ``TorchDispatchMode`` that
sees the aten ops one rank runs on its local shards: it returns
``NotImplemented`` for an op on DTensors, so DTensor's own dispatch runs
and its local ops (and the functional collectives of its redistributions)
come back through the mode, at local shapes.  The shape propagation that
DTensor runs on global shapes to find an output's metadata is skipped.

* ``flops``: ``torch.utils.flop_counter``'s rules (products and
  convolutions) at local shapes; K1 and K4 by their own rule.
* ``bytes``: the inputs and outputs of every op that moves data (views,
  allocations and metadata queries excluded).  Eager torch fuses nothing,
  so this is an upper count.
* ``bytes_min``: the products' operands and results, K1's and K4's reads
  and writes, and in-place updates: the traffic no fusion removes.
* ``collective_bytes``: each functional collective's result buffer times
  the reference's ring factor (all-reduce 2, the others 1), by kind, and
  in ``axis_bytes`` by the mesh axis of its process group.
* K1 (``repro_torch::decode_attention``) and K4 (``repro_torch::ssd_scan``)
  count the bytes and operations of their bound formulas
  (:func:`decode_attention_cost`, :func:`ssd_scan_cost`).  Where the
  lengths are fake (the dry run), every cache position the window admits
  counts as valid.
* ``peak_bytes``: the most bytes held at once by storages the counted ops
  created (each storage counted while any tensor on it lives).
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

WIRE_FACTOR = {
    "all-reduce": 2.0,  # ring: reduce-scatter + all-gather phases
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
#: functional collective -> the reference's kind (DTensor moves a shard from
#: one dimension to another with its own all-to-all op on CUDA)
_COLLECTIVES = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "collective-permute",
    "_dtensor::shard_dim_alltoall": "all-to-all",
}
_KERNELS = ("decode_attention", "ssd_scan")


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in WIRE_FACTOR})
    notes: List[str] = dataclasses.field(default_factory=list)
    #: traffic per aten op name (diagnostics)
    kind_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_min: float = 0.0
    #: collective bytes by mesh axis (the same bytes as collective_bytes)
    axis_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    peak_bytes: float = 0.0
    #: launches of K1 and K4 counted
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def total_collective(self) -> float:
        return sum(self.collective_bytes.values())

    def add(self, other: "OpCost", mult: float = 1.0) -> None:
        self.flops += mult * other.flops
        self.bytes += mult * other.bytes
        self.bytes_min += mult * other.bytes_min
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] = self.collective_bytes.get(k, 0.0) + mult * v
        for k, v in other.kind_bytes.items():
            self.kind_bytes[k] = self.kind_bytes.get(k, 0.0) + mult * v
        for k, v in other.axis_bytes.items():
            self.axis_bytes[k] = self.axis_bytes.get(k, 0.0) + mult * v


def decode_attention_cost(q_shape, k_shape, esize: int, lengths: Optional[Iterable[int]],
                          window: int = 1 << 30) -> Tuple[float, float]:
    """(bytes, operations) of one K1 call: q [B, Hkv, G, Dh] and k/v
    [B, Hkv, S, Dh] of ``esize``-byte elements; only the K/V rows the mask
    keeps are read (``lengths``: each row's valid count, or None for all
    the window admits), the output written once, the int32 lengths read."""
    b, hkv, g, dh = q_shape
    s = k_shape[2]
    if lengths is None:
        valid = b * min(s, window)
    else:
        valid = sum(max(0, min(int(n), s) - max(0, int(n) - window)) for n in lengths)
    nbytes = 2 * valid * hkv * dh * esize + 2 * b * hkv * g * dh * esize + 4 * b
    flops = 4 * valid * hkv * g * dh
    return float(nbytes), float(flops)


def ssd_scan_cost(b: int, s: int, h: int, p: int, n: int, chunk: int, esize: int
                  ) -> Tuple[float, float]:
    """(bytes, operations) of one K4 call: x, B and C read once in their
    dtype, dt and a in f32, y written once, the final state in f32; the
    operations of the chunked algorithm: C B^T once per (batch row, chunk)
    at G = 1 (causal half), per head the causal (C B^T * decay) @ dx, the
    state's contribution from the second chunk on and every chunk's state
    update."""
    chunk = min(chunk, s)
    nbytes = (2 * b * s * h * p + 2 * b * s * n) * esize + b * s * h * 4 + h * 4 \
        + b * h * p * n * 4
    flops = 0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        tri = q * (q + 1) // 2
        flops += b * 2 * tri * n
        flops += b * h * (2 * tri * p + 2 * q * p * n * (2 if t0 else 1))
    return float(nbytes), float(flops)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_fake(t: torch.Tensor) -> bool:
    return type(t).__name__ == "FakeTensor" or t.device.type == "meta"


def _in_shape_propagation() -> bool:
    """Whether DTensor is running an op on global shapes for its metadata."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


class count_costs(TorchDispatchMode):
    """``with count_costs(mesh) as cost:`` counts what this rank runs into
    ``cost`` (an :class:`OpCost`).  ``mesh``: the DeviceMesh whose process
    groups name the axes of the collectives (None: axis "world")."""

    def __init__(self, mesh=None):
        super().__init__()
        self.cost = OpCost()
        self._axis: Dict[str, str] = {}
        if mesh is not None:
            for i, name in enumerate(mesh.mesh_dim_names):
                self._axis[mesh.get_group(i).group_name] = name
        self._live = 0
        self._refs: Dict[int, int] = {}

    def __enter__(self) -> OpCost:
        super().__enter__()
        return self.cost

    # -- live storage ----------------------------------------------------
    def _track(self, outs: List[torch.Tensor]) -> None:
        for t in outs:
            key = t.untyped_storage()._cdata
            if key not in self._refs:
                self._refs[key] = 0
                self._live += t.untyped_storage().nbytes()
                self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)
            self._refs[key] += 1
            weakref.finalize(t, self._release, key, t.untyped_storage().nbytes())

    def _release(self, key: int, nbytes: int) -> None:
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self._live -= nbytes

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor dispatches; its local ops come back
        out = func(*args, **kwargs)
        if _in_shape_propagation():
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        name = func._schema.name
        ns, _, op = name.partition("::")
        c = self.cost
        if ns == "repro_torch" and op in _KERNELS:
            nbytes, flops = self._kernel_cost(op, args)
            c.flops += flops
            c.bytes += nbytes
            c.bytes_min += nbytes
            c.kernel_calls[op] = c.kernel_calls.get(op, 0) + 1
            c.kind_bytes[name] = c.kind_bytes.get(name, 0.0) + nbytes
        elif name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            buf = sum(_nbytes(t) for t in outs) * WIRE_FACTOR[kind]
            c.collective_bytes[kind] += buf
            group = next((a for a in args if isinstance(a, str) and a in self._axis), None)
            axis = self._axis.get(group, "world")
            c.axis_bytes[axis] = c.axis_bytes.get(axis, 0.0) + buf
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            c.bytes += moved
            c.kind_bytes[name] = c.kind_bytes.get(name, 0.0) + moved
        elif not (func.is_view or ns == "prim" or "empty" in op or op == "wait_tensor"):
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs
                                                       if not _aliases_input(func))
            c.bytes += moved
            c.kind_bytes[name] = c.kind_bytes.get(name, 0.0) + moved
            rule = flop_registry.get(func._overloadpacket)
            if rule is not None:
                c.flops += rule(*args, **kwargs, out_val=out)
                c.bytes_min += moved
            elif _aliases_input(func):
                c.bytes_min += moved
        if not func.is_view:
            self._track([t for t in outs if not _aliases_input(func)])
        return out

    @staticmethod
    def _kernel_cost(op: str, args) -> Tuple[float, float]:
        if op == "decode_attention":
            q, k, _, lengths, window = args[:5]
            lens = None if _is_fake(lengths) else lengths.tolist()
            return decode_attention_cost(tuple(q.shape), tuple(k.shape), k.element_size(),
                                         lens, int(window))
        x, _, bmat, _, _, chunk = args[:6]
        b, s, h, p = x.shape
        return ssd_scan_cost(b, s, h, p, bmat.shape[-1], int(chunk), x.element_size())


def _aliases_input(func) -> bool:
    """An in-place op: its result is one of its inputs, written."""
    return any(r.alias_info is not None and r.alias_info.is_write
               for r in func._schema.returns)
