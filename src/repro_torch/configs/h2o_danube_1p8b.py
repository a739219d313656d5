"""h2o-danube-1.8b — llama+mistral mix with sliding-window attention
(arXiv:2401.16818).

Assigned: 24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

A copy of ``repro/configs/h2o_danube_1p8b.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    n_layers=24,
    d_model=2560,
    n_q_heads=32,
    n_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab=32000,
    block="dense",
    window_pattern="swa",
    sliding_window=4096,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="danube-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="dense",
        window_pattern="swa",
        sliding_window=16,
    )


SPEC = ArchSpec(
    arch_id="h2o-danube-1.8b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=True,  # SWA: decode state bounded by the window
    notes="mistral-style SWA(4096)",
)
