"""Multi-pod dry run of the port: one step of every (arch x shape x mesh)
cell, traced on fake tensors, with nothing allocated (port of
``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu --arch llama31-8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh both --out dryrun.json

One process stands in for rank 0 of a ``"fake"`` process group of 256 ranks
(the ``(data=32, model=8)`` production mesh) or 512 (``(pod=2, data=32,
model=8)``); fake collectives return without moving data, so no value
computed after one is ever read.  Each cell's state is built as fake
tensors (``FakeTensorMode``) and distributed per ``rules_for_shape`` as
DTensors; one train step, prefill or decode step then runs under
:class:`repro_torch.roofline.op_costs.count_costs`, which counts what this
rank runs on its shards.  The result has the reference's ``CellResult``
fields: per-device FLOPs, bytes (an upper count) and the minimum bytes,
collective bytes by kind (and, in ``collective_axis_bytes``, by mesh axis),
and in ``memory`` the per-device argument bytes from the placements
(``argument_size_in_bytes``, the parameters alone in
``param_size_in_bytes``) and the peak of storage the step created
(``temp_size_in_bytes``).  The reference's lowering and compile times are
one field here, ``seconds_trace``.  Runs on the card's device type unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import traceback
from typing import Any, Dict, Optional, Union

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import ARCH_IDS, SHAPES, ArchSpec, Shape, get_arch
from repro_torch.device import resolve_device
from repro_torch.distributed.autosharding import distribute_tree, logical_sharding_context
from repro_torch.distributed.sharding import (
    bytes_per_device,
    input_sharding_axes,
    rules_for_shape,
    tree_specs,
)
from repro_torch.launch.mesh import MULTI_POD, SINGLE_POD, make_production_mesh
from repro_torch.models.transformer import TransformerLM, param_shapes
from repro_torch.optim.adamw import AdamW
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.pytree import tree_leaves, tree_map
from repro_torch.roofline.op_costs import count_costs
from repro_torch.train.step import make_train_step, train_state_axes, train_state_shapes


@dataclasses.dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool
    seconds_trace: float = 0.0
    flops_per_device: float = 0.0
    bytes_per_device: float = 0.0
    bytes_min_per_device: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_axis_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    memory: Dict[str, float] = dataclasses.field(default_factory=dict)
    error: str = ""
    notes: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """A ``"fake"`` process group of ``world_size`` ranks, this process its
    rank 0, destroyed on exit (a process holds one default group)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(shapes_tree: Any, device: torch.device) -> Any:
    """Fake tensors (the active FakeTensorMode) of a tree of meta tensors."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device), shapes_tree)


def _param_meta(cfg) -> Any:
    return tree_map(lambda sd: torch.empty(sd[0], dtype=sd[1], device="meta"), param_shapes(cfg))


def _frontend(cfg, b: int, device: torch.device) -> Optional[torch.Tensor]:
    if cfg.frontend == "vision":
        return torch.empty((b, cfg.frontend_seq, cfg.d_model), dtype=torch.float32, device=device)
    if cfg.frontend == "audio":
        return torch.empty((b, cfg.encoder_seq, cfg.d_model), dtype=torch.float32, device=device)
    return None


def _inputs(kind: str, tree: Dict[str, Any], mesh, rules) -> Dict[str, Any]:
    """The step's inputs distributed by their logical axes
    (``input_sharding_axes``); a missing frontend is left out."""
    axes = input_sharding_axes(kind)
    present = {k: v for k, v in tree.items() if v is not None}
    return distribute_tree(present, mesh, {k: axes[k] for k in present}, rules)


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to run: ``fn()`` runs it on ``args`` (a tree of
    DTensors: the train state, or the parameters and the decode state);
    ``params`` are the distributed parameters, ``param_meta`` their meta
    shapes and ``param_axes`` their logical axes."""

    fn: Any
    args: Any
    params: Any
    param_meta: Any
    param_axes: Any
    notes: str = ""


def build_cell(spec: ArchSpec, shape: Shape, mesh, device: torch.device, *,
               microbatches: int = 8, remat: str = "full") -> Cell:
    """The cell's step, built inside the caller's FakeTensorMode."""
    cfg = spec.config
    b, s = shape.global_batch, shape.seq_len
    rules = rules_for_shape(shape.kind, b)
    n_dev = mesh.size()
    fe = _frontend(cfg, b, device)

    if shape.kind == "train":
        model = TransformerLM(cfg, remat=remat)
        # fp32 master weights unless the model is too large for the pod's
        # memory at 12 bytes/param of optimizer+master state.
        master = cfg.param_count() * 12 / n_dev < 6e9
        opt = AdamW(master=master)
        mb = microbatches if b % microbatches == 0 else 1

        def sched(step):
            return warmup_cosine(step, peak_lr=3e-4, warmup_steps=100, total_steps=10_000)

        step_fn = make_train_step(model, opt, sched, microbatches=mb)
        meta = train_state_shapes(model, opt)
        state = distribute_tree(_fake(meta, device), mesh, train_state_axes(model, opt), rules)
        ins = _inputs("train", {"tokens": torch.empty((b, s), dtype=torch.int32, device=device),
                                "labels": torch.empty((b, s), dtype=torch.int32, device=device),
                                "frontend_embeds": fe}, mesh, rules)

        def fn():
            return step_fn(state, ins["tokens"], ins["labels"], ins.get("frontend_embeds"))

        return Cell(fn, state, state.params, meta.params, model.param_axes(),
                    f"master={master} microbatches={mb} remat={remat}")

    model = TransformerLM(cfg)
    meta = _param_meta(cfg)
    params = distribute_tree(_fake(meta, device), mesh, model.param_axes(), rules)
    dstate = distribute_tree(model.init_decode_state(b, s, device), mesh,
                             model.decode_state_axes(), rules)
    args = {"params": params, "state": dstate}
    if shape.kind == "prefill":
        ins = _inputs("prefill", {"tokens": torch.empty((b, s), dtype=torch.int32,
                                                        device=device),
                                  "frontend_embeds": fe}, mesh, rules)

        @torch.no_grad()
        def fn():
            return model.prefill(params, ins["tokens"], dstate,
                                 frontend_embeds=ins.get("frontend_embeds"))

        return Cell(fn, args, params, meta, model.param_axes())
    if shape.kind == "decode":
        tok = _inputs("decode", {"token": torch.empty((b,), dtype=torch.int32, device=device)},
                      mesh, rules)["token"]

        @torch.no_grad()
        def fn():
            return model.decode_step(params, dstate, tok)

        return Cell(fn, args, params, meta, model.param_axes())
    raise ValueError(shape.kind)


def _local_bytes(tree: Any) -> int:
    total = 0
    for t in tree_leaves(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


def run_cell(arch_id: str, shape_name: Union[str, Shape], mesh, mesh_name: str, *,
             verbose: bool = True, microbatches: int = 8, remat: str = "full",
             device=None, spec: Optional[ArchSpec] = None) -> CellResult:
    """One cell on ``mesh`` (over a fake process group).  ``shape_name``: a
    name in ``SHAPES`` or a :class:`Shape`; ``spec``: the arch's spec in
    place of the registry's (e.g. its smoke config)."""
    dev = resolve_device(device)
    spec = spec or get_arch(arch_id)
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    res = CellResult(arch=arch_id, shape=shape.name, mesh=mesh_name, ok=False)
    if not spec.shape_applicable(shape.name) and shape.name in SHAPES:
        res.error = "shape not applicable (long_500k runs only the sub-quadratic families)"
        res.notes = "skipped"
        return res
    try:
        rules = rules_for_shape(shape.kind, shape.global_batch)
        with FakeTensorMode(), logical_sharding_context(mesh, rules):
            cell = build_cell(spec, shape, mesh, dev, microbatches=microbatches, remat=remat)
            res.notes = cell.notes
            res.memory["argument_size_in_bytes"] = float(_local_bytes(cell.args))
            res.memory["param_size_in_bytes"] = float(_local_bytes(cell.params))
            res.memory["param_bytes_from_placements"] = float(bytes_per_device(
                cell.param_meta, tree_specs(cell.param_meta, cell.param_axes, mesh, rules), mesh))
            t0 = time.perf_counter()
            with count_costs(mesh) as cost:
                cell.fn()
            res.seconds_trace = time.perf_counter() - t0
        res.memory["temp_size_in_bytes"] = float(cost.peak_bytes)
        res.flops_per_device = cost.flops
        res.bytes_per_device = cost.bytes
        res.bytes_min_per_device = cost.bytes_min
        res.collective_bytes = dict(cost.collective_bytes)
        res.collective_axis_bytes = dict(cost.axis_bytes)
        if cost.kernel_calls:
            res.notes = (res.notes + " " + " ".join(
                f"{k}={v}" for k, v in sorted(cost.kernel_calls.items()))).strip()
        res.ok = True
    except Exception as ex:  # a cell's failure is its result; the sweep goes on
        res.error = f"{type(ex).__name__}: {str(ex)[:500]}"
        if verbose:
            traceback.print_exc()
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id (default: all)")
    ap.add_argument("--shape", default=None, help="shape name (default: all)")
    ap.add_argument("--mesh", choices=("single", "multi", "both"), default="single")
    ap.add_argument("--out", default=None, help="write JSON results here")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--device", default=None, help="cpu for fake CPU tensors (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    for multi in meshes:
        shape, _ = MULTI_POD if multi else SINGLE_POD
        mesh_name = "x".join(str(n) for n in shape)
        n = 1
        for d in shape:
            n *= d
        with fake_process_group(n):
            mesh = make_production_mesh(multi_pod=multi, device=dev)
            for arch in archs:
                for shape_name in shapes:
                    r = run_cell(arch, shape_name, mesh, mesh_name, microbatches=args.microbatches,
                                 remat=args.remat, device=dev)
                    results.append(r)
                    status = "OK " if r.ok else ("SKIP" if r.notes == "skipped" else "FAIL")
                    coll = sum(r.collective_bytes.values())
                    print(f"{status} {mesh_name} {arch:28s} {shape_name:12s} "
                          f"trace={r.seconds_trace:6.1f}s flops/dev={r.flops_per_device:.3e} "
                          f"bytes/dev={r.bytes_per_device:.3e} coll/dev={coll:.3e} "
                          f"{r.error[:120]}")
                    if r.ok:
                        print(f"     memory: {r.memory}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump([r.to_json() for r in results], f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
