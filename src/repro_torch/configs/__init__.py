"""Architecture registry of the port: every config of ``repro.configs``,
copied so the port imports nothing from the reference, and the four input
shapes of the dry run (``train_4k``, ``prefill_32k``, ``decode_32k`` and
``long_500k``, which only the sub-quadratic families run)."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.transformer import ModelConfig

@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS: List[str] = ["llama31-8b", "mamba2-2.7b", "gemma2-27b", "h2o-danube-1.8b",
                       "stablelm-12b", "qwen2.5-3b", "hymba-1.5b", "internvl2-2b",
                       "whisper-large-v3", "dbrx-132b", "llama4-maverick-400b-a17b"]

_MODULES: Dict[str, str] = {
    "llama31-8b": "llama31_8b",
    "mamba2-2.7b": "mamba2_2p7b",
    "gemma2-27b": "gemma2_27b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "stablelm-12b": "stablelm_12b",
    "qwen2.5-3b": "qwen25_3b",
    "hymba-1.5b": "hymba_1p5b",
    "internvl2-2b": "internvl2_2b",
    "whisper-large-v3": "whisper_large_v3",
    "dbrx-132b": "dbrx_132b",
    "llama4-maverick-400b-a17b": "llama4_maverick",
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    #: sub-quadratic decode state (SSM / SWA / local-global) => long_500k runs
    long_context: bool
    notes: str = ""

    def shapes(self) -> List[Shape]:
        out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
        if self.long_context:
            out.append(SHAPES["long_500k"])
        return out

    def shape_applicable(self, shape_name: str) -> bool:
        if shape_name == "long_500k":
            return self.long_context
        return shape_name in SHAPES


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; ported: {', '.join(ARCH_IDS)}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SPEC


def all_archs() -> List[ArchSpec]:
    return [get_arch(a) for a in ARCH_IDS]
