"""nemotron3-nano-30b-a3b — NVIDIA-Nemotron-3-Nano-30B-A3B (``nemotron_h``),
huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16 config.json.

A port-only family (the reference package has none): 52 layers of three
kinds by ``hybrid_override_pattern``, each ``x + mixer(rmsnorm(x))`` with
epsilon 1e-5: 23 Mamba-2 (64 heads of 64, so d_inner 4,096; state 128 in 8
groups, conv 4 with a bias, the gated norm over groups of 512 channels,
chunk 128), 23 dropless MoE (a sigmoid router over 128 experts with a
choice bias, top 6, the chosen scores normalised and scaled by 2.5, relu²
experts of 1,856 and a shared relu² expert of 3,712) and 6 grouped-query
attention layers (32 query and 2 KV heads of 128, no bias).  d_model 2,688,
vocab 131,072, untied: 31,577,940,288 parameters.  The attention layers take
no rotary embedding (``rope_theta`` None): positions come from the Mamba
layers, as this port reads the published modelling code; the published
config carries a ``rope_theta`` of 10,000, which is not checked here.
"""

from repro_torch.configs import ArchSpec
from repro_torch.models.transformer import ModelConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"

CONFIG = ModelConfig(
    name="nemotron3-nano-30b-a3b",
    n_layers=52,
    d_model=2688,
    n_q_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=1856,
    vocab=131072,
    block="mixed",
    layer_pattern=PATTERN,
    rope_theta=None,
    activation="relu2",
    norm_eps=1e-5,
    n_experts=128,
    router_experts=128,
    top_k=6,
    router="sigmoid",
    routed_scaling=2.5,
    shared_expert_ff=3712,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_heads=64,
    ssm_groups=8,
    ssm_chunk=128,
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron3-nano-smoke",
        n_layers=6,
        d_model=128,
        n_q_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=64,
        vocab=512,
        block="mixed",
        layer_pattern="MEM*EM",
        rope_theta=None,
        activation="relu2",
        norm_eps=1e-5,
        n_experts=8,
        top_k=2,
        router="sigmoid",
        routed_scaling=2.5,
        shared_expert_ff=128,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_heads=8,
        ssm_groups=2,
        ssm_chunk=16,
    )


SPEC = ArchSpec(
    arch_id="nemotron3-nano-30b-a3b",
    config=CONFIG,
    smoke=smoke_config(),
    long_context=False,  # six layers of full attention
    notes="Mamba-2, dropless MoE and attention layers of their own kinds in one stack",
)
