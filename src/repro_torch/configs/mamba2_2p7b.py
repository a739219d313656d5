"""mamba2-2.7b — attention-free SSD state-space model (arXiv:2405.21060); a
copy of ``repro/configs/mamba2_2p7b.py``.

64 layers, d_model 2560, d_ff 0, vocab 50280, ssm_state 128: d_inner =
2 * d_model = 5120 and head_dim 64 give 80 SSM heads in one group.  It has
no KV cache, so the serving cluster's per-token KV bytes are 0 and each
host-engine step streams weights only.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    n_q_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab=50280,
    block="ssm",
    rope_theta=None,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_expand=2,
    tied_embeddings=True,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke",
        n_layers=2,
        d_model=128,
        n_q_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab=512,
        block="ssm",
        rope_theta=None,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=16,
        tied_embeddings=True,
    )


SPEC = ArchSpec(
    arch_id="mamba2-2.7b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=True,  # O(1) decode state
    notes="attention-free SSD; no KV cache, the decode state is O(1) per slot",
)
