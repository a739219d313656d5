"""dbrx-132b — fine-grained MoE, 16 experts top-4 (databricks/dbrx-base).

Assigned: 40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352,
MoE 16e top-4.  Analytic: ~132B total / ~36B active.

A copy of ``repro/configs/dbrx_132b.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    n_layers=40,
    d_model=6144,
    n_q_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    block="moe",
    n_experts=16,
    top_k=4,
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab=512,
        block="moe",
        n_experts=4,
        top_k=2,
    )


SPEC = ArchSpec(
    arch_id="dbrx-132b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,  # full attention
    notes="16 experts top-4 every layer; sort-based dispatch",
)
