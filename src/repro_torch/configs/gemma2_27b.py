"""gemma2-27b — local/global alternating attention with logit soft-capping
(arXiv:2408.00118).

Assigned: 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000.
The most paper-representative arch for tiered KV: the SWA half keeps a
window-sized hot KV; the global half's long-tail KV is the cold tier.

A copy of ``repro/configs/gemma2_27b.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    n_layers=46,
    d_model=4608,
    n_q_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab=256000,
    block="dense",
    window_pattern="gemma2",
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    query_scale=(4608 / 32) ** -0.5,  # query_pre_attn_scalar = d_model/n_heads
    activation="gelu",
    use_post_norms=True,
    tied_embeddings=True,
    embed_scale=True,
    rope_theta=10_000.0,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-smoke",
        n_layers=4,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="dense",
        window_pattern="gemma2",
        sliding_window=16,
        attn_softcap=50.0,
        final_softcap=30.0,
        activation="gelu",
        use_post_norms=True,
        tied_embeddings=True,
        embed_scale=True,
    )


SPEC = ArchSpec(
    arch_id="gemma2-27b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=True,  # half the layers are SWA; global-layer decode is O(S)
    notes="local/global alternating + softcaps + post-norms",
)
