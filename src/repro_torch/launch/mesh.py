"""Device meshes of the port (port of ``repro/launch/mesh.py``).

The production meshes have the reference's chip counts on H100s: 256 GPUs
as ``(data=32, model=8)``, one 8-GPU NVLink node per ``model`` group, and
512 as ``(pod=2, data=32, model=8)``.  They need a process group of that
many ranks (the dry run's fake one).  :func:`make_host_mesh` spans the
ranks that exist; with no process group it first starts a one-rank group
(NCCL on the card, gloo on the CPU) from a ``FileStore`` in a temporary
directory, so it needs no free port.  Nothing here runs when the module is
imported.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

#: The production meshes: (shape, axis names).
SINGLE_POD = ((32, 8), ("data", "model"))
MULTI_POD = ((2, 32, 8), ("pod", "data", "model"))


def ensure_process_group(device=None) -> None:
    """Start a one-rank process group if none exists."""
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    path = os.path.join(tempfile.mkdtemp(prefix="repro-pg-"), "store")
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(path, 1), rank=0, world_size=1)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the process group's ranks,
    which must number the product of ``shape``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group; make_host_mesh starts one")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {tuple(shape)} needs {n} ranks, the process group "
                         f"has {dist.get_world_size()}")
    dev = resolve_device(device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    shape, axes = MULTI_POD if multi_pod else SINGLE_POD
    return make_mesh(shape, axes, device)


def make_host_mesh(*, data: Optional[int] = None, model: int = 1, device=None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the ranks that exist (tests, one card)."""
    ensure_process_group(device)
    n = dist.get_world_size()
    if data is None:
        data = n // model
    return make_mesh((data, model), ("data", "model"), device)


def parse_mesh(spec: str) -> Sequence[int]:
    """``"DATAxMODEL"`` (e.g. ``"2x2"``) -> (data, model)."""
    try:
        data, model = (int(v) for v in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh wants DATAxMODEL, e.g. 2x2, got {spec!r}") from None
    return data, model
