"""internvl2-2b — VLM: stubbed InternViT patch embeddings + InternLM2-1.8B
backbone (arXiv:2404.16821).

Assigned: 24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553.
The vision frontend is a STUB per the assignment: input_specs() provides 256
precomputed patch embeddings fused into the first positions (early fusion).

A copy of ``repro/configs/internvl2_2b.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    n_layers=24,
    d_model=2048,
    n_q_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=92553,
    block="dense",
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_seq=256,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="dense",
        frontend="vision",
        frontend_seq=8,
    )


SPEC = ArchSpec(
    arch_id="internvl2-2b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,  # pure full attention backbone
    notes="vision frontend stubbed (precomputed patch embeddings)",
)
