"""qwen2.5-3b — dense GQA with QKV bias (Qwen2.5 family).

Assigned: 36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.

A copy of ``repro/configs/qwen25_3b.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_q_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    block="dense",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tied_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="dense",
        qkv_bias=True,
        tied_embeddings=True,
    )


SPEC = ArchSpec(
    arch_id="qwen2.5-3b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,  # pure full attention
    notes="QKV bias, 8:1 GQA ratio",
)
