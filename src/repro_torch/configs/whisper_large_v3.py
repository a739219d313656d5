"""whisper-large-v3 — encoder-decoder, conv frontend stubbed
(arXiv:2212.04356).

Assigned: 32L d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866.
The conv1d audio frontend is a STUB: input_specs() provides 1500 precomputed
frame embeddings (30 s at the post-conv 10 ms hop).  Adaptations noted in
DESIGN.md: gated MLP instead of plain GELU MLP; RoPE on decoder self-attn in
place of learned absolute positions (backbone-stress-equivalent).

A copy of ``repro/configs/whisper_large_v3.py``.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    n_layers=32,
    d_model=1280,
    n_q_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab=51866,
    block="dense",
    norm="layernorm",
    activation="gelu",
    rope_theta=10_000.0,
    n_encoder_layers=32,
    encoder_seq=1500,
    frontend="audio",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        block="dense",
        norm="layernorm",
        activation="gelu",
        n_encoder_layers=2,
        encoder_seq=32,
        frontend="audio",
    )


SPEC = ArchSpec(
    arch_id="whisper-large-v3",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,  # full attention enc-dec
    notes="enc-dec; conv frontend stubbed; MHA (kv=q=20)",
)
