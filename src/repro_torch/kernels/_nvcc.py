"""Build the port's CUDA sources with ``nvcc`` and count kernel launches.

Each source compiles for ``sm_90a`` into a shared library with a plain C
interface under ``kernels/_build/`` (ignored by git), named by the hash of
the source and its flags, so a stale build is never reused.  ptxas's
register and spill report is kept beside each library (``.ptxas.txt``).
Nothing is built when a module is imported: the kernel wrappers build at
their first launch, and :func:`build` takes several sources at once so
their ``nvcc`` processes run together.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"


class LaunchCounter:
    """A plain integer count of kernel launches.  Every counter made is
    listed in :data:`COUNTERS`, so a caller that records launches into a
    CUDA graph can take the recording's counts back and add them again at
    each replay."""

    def __init__(self) -> None:
        self.count = 0
        COUNTERS.append(self)

    def reset(self) -> None:
        self.count = 0


#: Every :class:`LaunchCounter`, in the order they were made.
COUNTERS: List[LaunchCounter] = []


@dataclasses.dataclass(frozen=True)
class CudaSource:
    """One ``.cu`` file under ``csrc/`` and the extra ``nvcc`` flags it needs."""

    name: str
    flags: Tuple[str, ...] = ()

    @property
    def path(self) -> Path:
        return CSRC / f"{self.name}.cu"

    def library(self) -> Path:
        digest = hashlib.sha256(self.path.read_bytes())
        if self.flags:
            digest.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.name}-{digest.hexdigest()[:12]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(*sources: CudaSource) -> List[Path]:
    """Compile every source whose library does not exist yet, all ``nvcc``
    processes at once; returns the libraries in argument order.  Raises
    with the compiler's output if any build fails."""
    libs = [s.library() for s in sources]
    todo = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas=-v", *src.flags, "-shared", "-Xcompiler", "-fPIC",
               "-o", tmp, str(src.path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        todo.append((src, lib, tmp, proc))
    errors = []
    for src, lib, tmp, proc in todo:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {src.path.name} ({proc.returncode}):\n{err}")
            continue
        lib.with_suffix(".ptxas.txt").write_text(err)
        os.replace(tmp, lib)  # atomic: a concurrent build sees a whole file
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs
