"""Architecture registry of the port: every config of ``repro.configs``,
copied so the port imports nothing from the reference."""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List

from repro_torch.models.transformer import ModelConfig

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
    notes: str = ""


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet; ported: {', '.join(ARCH_IDS)}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SPEC
