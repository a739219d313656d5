"""Atomic, asynchronous checkpoints in the reference's format (port of
``repro/checkpoint/ckpt.py``), so a checkpoint crosses between the
frameworks in both directions.

Format: ``<dir>/step_{step:08d}/`` holds ``arrays.npz`` (leaves named
``leaf_{i:05d}`` in the reference's flatten order: dict keys sorted,
dataclass fields in order, ``None`` dropped) and ``manifest.json`` (step,
each leaf's path key such as ``params/layers/attn/wq`` or ``opt/m/embed``,
its name, shape and dtype, and the caller's ``extra``, e.g. the data
loader's state).  bfloat16 leaves are stored as f32 with ``"bfloat16"`` in
the manifest.  Writes go to ``<dir>/tmp.<step>`` and are renamed, so a crash
mid-write never corrupts the latest checkpoint.

On a mesh, a leaf that is a DTensor is gathered in full before it is
written (every rank takes part in the gather; rank 0 of the process group
writes, and the others wait for it), so the format is the same whatever
mesh wrote it.  ``restore_checkpoint(..., placements=)`` places every leaf
on the mesh that is alive, so a checkpoint written on one mesh restores
onto another, or onto none (elastic restore).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed.autosharding import distribute_local
from repro_torch.pytree import flatten_with_paths, tree_map, tree_unflatten


def _host_copy(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of the leaf, in full (a DTensor is gathered)."""
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    return leaf.detach().to("cpu", copy=True)


def _is_writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _host_array(leaf: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(the array to store, the leaf's dtype name as the manifest keeps it)."""
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)  # npz cannot hold bfloat16
    return t.numpy(), name


def save_checkpoint(directory: str, step: int, state: Any, *,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    if any(isinstance(leaf, DTensor) for _, leaf in flatten_with_paths(state)):
        state = tree_map(_host_copy, state)
        final = os.path.join(directory, f"step_{step:08d}")
        if _is_writer():
            _write(directory, step, state, extra)
        _barrier()
        return final
    return _write(directory, step, state, extra)


def _write(directory: str, step: int, state: Any, extra: Optional[Dict[str, Any]]) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}")
    final = os.path.join(directory, f"step_{step:08d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {}
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(flatten_with_paths(state)):
        arr, dtype = _host_array(leaf)
        name = f"leaf_{i:05d}"
        arrays[name] = arr
        manifest["leaves"].append({"key": key, "name": name, "shape": list(arr.shape),
                                   "dtype": dtype})
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        m = re.match(r"step_(\d+)$", name)
        if m and os.path.exists(os.path.join(directory, name, "manifest.json")):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: int, state_template: Any, *,
                       placements: Any = None) -> Tuple[Any, Dict[str, Any]]:
    """The checkpoint's leaves in the template's structure, matched by path
    key, each cast to its template leaf's dtype and put on its device.
    ``placements`` — a tree like the template of ``(mesh, placements)``
    pairs, or None — distributes each leaf onto a mesh, each device keeping
    its shard.  Raises ``KeyError`` on a leaf missing from the checkpoint
    and ``ValueError`` on a shape mismatch.  Returns (state, extra)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = np.load(os.path.join(path, "arrays.npz"))
    by_key = {e["key"]: e["name"] for e in manifest["leaves"]}
    restored = []
    for key, tmpl in flatten_with_paths(state_template):
        if key not in by_key:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[by_key[key]]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"leaf {key!r}: checkpoint shape {arr.shape} != "
                             f"template {tuple(tmpl.shape)}")
        restored.append(torch.from_numpy(arr if arr.flags.writeable else arr.copy()).to(
            device=tmpl.device, dtype=tmpl.dtype))
    state = tree_unflatten(state_template, restored)
    if placements is not None:
        state = tree_map(lambda leaf, mp: distribute_local(leaf, *mp), state, placements)
    return state, manifest["extra"]


class CheckpointManager:
    """Asynchronous checkpoints with retention.  ``save`` copies the state
    to host memory at once (the train step updates it in place afterwards)
    and writes on a worker thread, keeping the newest ``keep``; ``wait``
    fences (before exit or on preemption)."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: List[Future] = []
        self._lock = threading.Lock()

    def save(self, step: int, state: Any, extra: Optional[Dict[str, Any]] = None) -> Future:
        host_state = tree_map(_host_copy, state)
        if not _is_writer():
            fut: Future = Future()
            fut.set_result(os.path.join(self.directory, f"step_{step:08d}"))
            return fut

        def work():
            p = save_checkpoint(self.directory, step, host_state, extra=extra)
            self._gc()
            return p

        fut = self._pool.submit(work)
        with self._lock:
            self._pending.append(fut)
        return fut

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for name in os.listdir(self.directory)
                       if (m := re.match(r"step_(\d+)$", name)))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()
        _barrier()

    def restore_latest(self, state_template: Any, *, placements: Any = None):
        """(step, state, extra) of the newest checkpoint, or (None, None,
        None) when there is none; ``placements`` as in
        :func:`restore_checkpoint`."""
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        state, extra = restore_checkpoint(self.directory, step, state_template,
                                          placements=placements)
        return step, state, extra
