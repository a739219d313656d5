"""llama4-maverick-400b-a17b — interleaved MoE, 128 experts top-1 + shared
expert, early-fusion multimodal (frontend out of scope for the LM shapes).

Assigned: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048,
MoE 128e top-1.  Uniform per-layer MoE with these numbers gives ~780B total;
the published 400B-total/17B-active reconciles with *interleaved* dense/MoE
layers (24+24) and dense d_ff=16384, which is what Maverick ships and what
is implemented here (dense/MoE pairs).  Active params ≈ 17B either way.

A copy of ``repro/configs/llama4_maverick.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    n_layers=48,
    d_model=5120,
    n_q_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    block="moe",
    n_experts=128,
    top_k=1,
    shared_expert_ff=8192,
    moe_every=2,
    d_ff_dense=16384,
    rope_theta=500_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-smoke",
        n_layers=4,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=128,
        vocab=512,
        block="moe",
        n_experts=4,
        top_k=1,
        shared_expert_ff=128,
        moe_every=2,
        d_ff_dense=256,
    )


SPEC = ArchSpec(
    arch_id="llama4-maverick-400b-a17b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,  # treated as full attention per assignment
    notes="interleaved dense/MoE pairs; 128e top-1 + shared expert",
)
