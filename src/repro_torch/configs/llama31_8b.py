"""llama31-8b — the paper's own LLM-serving case-study model (§6 runs
LLaMA 3.1 8B); a copy of ``repro/configs/llama31_8b.py``."""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama31-8b",
    n_layers=32,
    d_model=4096,
    n_q_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    block="dense",
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama31-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="dense",
    )


SPEC = ArchSpec(
    arch_id="llama31-8b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,
    notes="paper §6 case-study model (serving engine)",
)
