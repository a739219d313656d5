"""hymba-1.5b — hybrid parallel attention + Mamba heads (arXiv:2411.13676).

Assigned: 32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001 ssm_state=16.
Window pattern: full attention at layers {0, L/2, L-1}, SWA(1024) elsewhere
(the paper's meta-token + cross-layer-KV-sharing tricks are orthogonal to the
memory-tiering study and omitted; noted in DESIGN.md).

A copy of ``repro/configs/hymba_1p5b.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    n_layers=32,
    d_model=1600,
    n_q_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    block="hybrid",
    window_pattern="hymba",
    sliding_window=1024,
    rope_theta=10_000.0,
    ssm_state=16,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    tied_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hymba-smoke",
        n_layers=4,
        d_model=128,
        n_q_heads=5,
        n_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="hybrid",
        window_pattern="hymba",
        sliding_window=16,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=16,
        tied_embeddings=True,
    )


SPEC = ArchSpec(
    arch_id="hymba-1.5b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=True,  # hybrid: SSM state + SWA hot window
    notes="parallel attn+mamba heads, mean-fused; meta tokens omitted",
)
