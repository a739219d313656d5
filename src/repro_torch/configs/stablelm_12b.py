"""stablelm-12b — dense GQA with per-head QK norm (StableLM-2 family).

Assigned: 40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352.

A copy of ``repro/configs/stablelm_12b.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-12b",
    n_layers=40,
    d_model=5120,
    n_q_heads=32,
    n_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab=100352,
    block="dense",
    norm="layernorm",
    qk_norm=True,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="dense",
        norm="layernorm",
        qk_norm=True,
    )


SPEC = ArchSpec(
    arch_id="stablelm-12b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,  # pure full attention: long_500k skipped
    notes="layernorm + per-head qk-norm",
)
