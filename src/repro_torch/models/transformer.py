"""The port's ``TransformerLM`` (``repro/models/transformer.py``): the
llama, gemma2, h2o-danube, stablelm and qwen2.5 attention families, the
MoE families (dbrx: an MoE FFN in every layer; llama4-maverick: dense/MoE
pairs), mamba2, hymba's hybrid block (parallel attention and SSM heads on
one normed input, mean-fused), whisper's encoder-decoder (a non-causal
encoder over stubbed frame embeddings, cross-attention in every decoder
layer) and internvl2's early fusion (stubbed patch embeddings replace the
first prompt positions), and Nemotron-H's stack of layers of three kinds
(``block="mixed"``: one mixer a layer, Mamba-2, a dropless MoE or attention,
as ``layer_pattern`` says).

Parameters keep the reference's stacked ``[L, ...]`` leaves and names
(a paired stack's ``{"dense": [L/2, ...], "moe": [L/2, ...]}``), so
``repro_torch.models.weights.params_from_numpy`` maps the reference's tree
onto the port's.  ``lax.scan`` over layers becomes a Python loop over the
flat layer index: layer ``2p + j`` of a paired stack is sublayer ``j`` of
pair ``p``, which is also its slot in the reference's pair view of the
flat ``[L, ...]`` decode state.  Decode state is mutable: ``prefill`` and
``decode_step`` write the KV caches and the SSM states in place and return
a state that shares them.

Training differentiates ``forward`` with autograd.  A full-sequence pass
unbinds each stacked leaf once (its backward is one ``stack``, where one
``select`` a layer would add a zero tensor of the whole leaf per layer),
and ``remat`` checkpoints each layer's body: "full" saves only its input,
"dots" also the outputs of its matrix products (XLA's ``checkpoint_dots``).

On a mesh the parameters and the decode state are DTensors
(``distributed/``) and the model runs inside a
``logical_sharding_context``: the residual stream is constrained to
``ACT`` where blocks meet and where each sublayer's output rejoins it (as
the reference constrains its block boundaries), and each layer's FSDP
shards are gathered before it runs.  :meth:`TransformerLM.param_axes` and
:meth:`TransformerLM.decode_state_axes` give every leaf's logical axes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.device import resolve_device
from repro_torch.distributed.autosharding import constrain, gather_fsdp
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    Params,
    embed_init,
    embed_lookup,
    dense_init,
    layernorm,
    mlp_apply,
    rmsnorm,
    softcap,
    unembed,
)
from repro_torch.pytree import tree_map

FULL_WINDOW = 1 << 30  # "window" larger than any sequence = dense attention
#: Activation-checkpointing policies of a layer's body under autograd.
REMAT_POLICIES = ("none", "full", "dots")
#: The matrix products whose outputs ``remat="dots"`` saves.
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default)
#: Per-layer window patterns: all full; all sliding; gemma2's local (even)
#: and global (odd) layers; hymba's full first, middle and last layers.
WINDOW_PATTERNS = ("full", "swa", "gemma2", "hymba")
#: Logical axes of the residual stream [B, S, D], where meshed blocks meet.
ACT = ("batch", "seq", "embed_act")
#: A mixed stack's layer kinds: pattern letter -> the key of its stack.
LAYER_KINDS = {"M": "mamba", "E": "experts", "*": "attention"}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Copy of the reference's ``ModelConfig``; ``dtype`` is a torch dtype.
    An unknown block, window pattern, norm, activation or frontend raises
    ``ValueError``, as does an inconsistent MoE config: ``block="moe"``
    without ``0 < top_k <= n_experts``, experts on another block,
    ``moe_every`` other than 1 or 2, or dense/MoE pairs over an odd number
    of layers.

    The settings of the port's own mixed stack (``block="mixed"``,
    Nemotron-H), which the reference's config does not have, are init-only:
    the constructor takes them and keeps them as attributes of the same
    names, but they are not dataclass fields, so the configs of the other
    families compare field by field with the reference's as before.  Their
    defaults leave every other family as it was.  ``layer_pattern``: one
    letter a layer, ``M`` Mamba-2, ``E`` the dropless MoE, ``*`` attention;
    ``ssm_heads``: the SSM head count that sets d_inner (0: ``ssm_expand x
    d_model``); ``norm_eps``: every RMSNorm's epsilon, the SSM's gated norm's
    too (None: each norm's default); ``router``: ``"softmax"`` (the capacity
    path) or ``"sigmoid"`` (the dropless path's biased sigmoid);
    ``routed_scaling``: the routed experts' gates' factor; ``n_experts``
    counts the experts whose weights this device holds, the first
    ``n_experts`` of the router's ``router_experts`` (0: as many as are
    held; :attr:`router_width`).  ``activation="relu2"``
    makes the experts ungated relu² MLPs.  A pattern whose letters do not
    match the other fields raises ``ValueError``."""

    name: str
    n_layers: int
    d_model: int
    n_q_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block: str = "dense"
    rope_theta: Optional[float] = 10_000.0
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    sliding_window: Optional[int] = None
    window_pattern: str = "full"
    norm: str = "rms"
    activation: str = "silu"
    tied_embeddings: bool = False
    embed_scale: bool = False
    use_post_norms: bool = False
    n_experts: int = 0
    top_k: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    #: 1 = every layer MoE (dbrx); 2 = alternating dense/MoE pairs (llama4
    #: maverick: 24 dense + 24 MoE layers, 400B total / 17B active).
    moe_every: int = 1
    d_ff_dense: int = 0  # dense sub-layer FFN width when moe_every == 2 (0: 2 x d_ff)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 128
    n_encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper: 30 s of 10 ms frames after the conv stub
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_seq: int = 0  # vision: patch embeddings fused into the first positions
    dtype: torch.dtype = torch.bfloat16
    layer_pattern: dataclasses.InitVar[Optional[str]] = None
    ssm_heads: dataclasses.InitVar[int] = 0
    norm_eps: dataclasses.InitVar[Optional[float]] = None
    router: dataclasses.InitVar[str] = "softmax"
    routed_scaling: dataclasses.InitVar[float] = 1.0
    router_experts: dataclasses.InitVar[int] = 0

    def __post_init__(self, layer_pattern, ssm_heads, norm_eps, router, routed_scaling,
                      router_experts) -> None:
        for name, value in (("layer_pattern", layer_pattern), ("ssm_heads", ssm_heads),
                            ("norm_eps", norm_eps), ("router", router),
                            ("routed_scaling", routed_scaling),
                            ("router_experts", router_experts)):
            object.__setattr__(self, name, value)
        for field, allowed in (("block", ("dense", "moe", "ssm", "hybrid", "mixed")),
                               ("window_pattern", WINDOW_PATTERNS), ("norm", ("rms", "layernorm")),
                               ("activation", ("silu", "gelu", "relu2")),
                               ("router", ("softmax", "sigmoid")),
                               ("frontend", (None, "vision", "audio"))):
            if getattr(self, field) not in allowed:
                raise ValueError(f"{self.name}: {field}={getattr(self, field)!r} is not one of "
                                 f"{allowed}")
        mixed = self.block == "mixed" or layer_pattern is not None
        if mixed:
            self._check_pattern()
        if self.uses_attention and self.n_q_heads % self.n_kv_heads:
            raise ValueError("n_q_heads must be a multiple of n_kv_heads")
        if mixed:
            return
        if router != "softmax" or self.activation == "relu2":
            raise ValueError(f"{self.name}: router={router!r} and activation="
                             f"{self.activation!r} are the mixed stack's (block='mixed')")
        if self.block == "moe" and not 0 < self.top_k <= self.n_experts:
            raise ValueError(f"{self.name}: an MoE block needs 0 < top_k <= n_experts, got "
                             f"top_k={self.top_k}, n_experts={self.n_experts}")
        if self.block != "moe" and self.n_experts:
            raise ValueError(f"{self.name}: n_experts={self.n_experts} on block="
                             f"{self.block!r}; experts need block='moe'")
        if self.moe_every not in (1, 2):
            raise ValueError(f"{self.name}: moe_every={self.moe_every} is not 1 or 2")
        if self.paired and self.n_layers % 2:
            raise ValueError(f"{self.name}: dense/MoE pairs need an even n_layers, got "
                             f"{self.n_layers}")

    def _check_pattern(self) -> None:
        """A mixed stack's pattern against the other fields."""
        pat = self.layer_pattern
        bad = []
        if self.block != "mixed" or not pat:
            bad.append(f"block={self.block!r} with layer_pattern={pat!r}")
        else:
            if set(pat) - set(LAYER_KINDS) or len(pat) != self.n_layers:
                bad.append(f"a pattern of {len(pat)} layers over {sorted(set(pat))}, "
                           f"n_layers={self.n_layers}")
            if ("M" in pat) != (self.ssm_state > 0):
                bad.append(f"ssm_state={self.ssm_state}")
            if ("*" in pat) != (self.n_q_heads > 0 and self.n_kv_heads > 0
                                and self.head_dim > 0):
                bad.append(f"attention heads {self.n_q_heads}/{self.n_kv_heads} of "
                           f"{self.head_dim}")
            experts = "E" in pat
            if experts != (self.n_experts > 0) or (experts and not (
                    0 < self.top_k <= self.router_width
                    and self.n_experts <= self.router_width
                    and self.router == "sigmoid" and self.activation == "relu2"
                    and self.d_ff > 0)):
                bad.append(f"experts {self.n_experts} held of {self.router_width}, top_k="
                           f"{self.top_k}, router={self.router!r}, activation="
                           f"{self.activation!r}, d_ff={self.d_ff}")
            if self.ssm_state and self.ssm_dims["n_heads"] % self.ssm_groups:
                bad.append(f"{self.ssm_dims['n_heads']} SSM heads in {self.ssm_groups} groups")
        if bad:
            raise ValueError(f"{self.name}: the layer pattern does not match the config: "
                             + "; ".join(bad))

    @property
    def uses_attention(self) -> bool:
        if self.block == "mixed":
            return "*" in self.layer_pattern
        return self.block in ("dense", "moe", "hybrid")

    @property
    def uses_ssm(self) -> bool:
        if self.block == "mixed":
            return "M" in self.layer_pattern
        return self.block in ("ssm", "hybrid")

    @property
    def router_width(self) -> int:
        """The experts the router chooses among."""
        return self.router_experts or self.n_experts

    @property
    def n_attn_layers(self) -> int:
        """Layers that keep a KV cache."""
        if self.block == "mixed":
            return self.layer_pattern.count("*")
        return self.n_layers if self.uses_attention else 0

    def kind_layers(self, letter: str) -> int:
        """Layers of one kind of a mixed stack's pattern."""
        return self.layer_pattern.count(letter) if self.block == "mixed" else 0

    @property
    def ssm_dims(self) -> Dict[str, int]:
        return ssm_lib.ssm_dims(self.d_model, expand=self.ssm_expand,
                                head_dim=self.ssm_head_dim, d_state=self.ssm_state,
                                n_groups=self.ssm_groups, n_heads=self.ssm_heads)

    @property
    def paired(self) -> bool:
        return self.block == "moe" and self.moe_every == 2

    @property
    def n_scan(self) -> int:
        """Stacked steps (a dense/MoE pair counts as one)."""
        return self.n_layers // 2 if self.paired else self.n_layers

    def param_count(self) -> int:
        """Analytic parameter count (the reference's, for 6·N·D
        bookkeeping).  A mixed stack counts every leaf, norms and biases
        included, with the experts this device holds."""
        if self.block == "mixed":
            def count(tree):
                return sum(count(v) if isinstance(v, dict) else math.prod(v)
                           for v in tree.values())

            return count(_shapes(self))
        d, f, L = self.d_model, self.d_ff, self.n_layers
        n = self.vocab * d  # embed
        if not self.tied_embeddings:
            n += self.vocab * d
        attn_per = d * self.head_dim * (self.n_q_heads * 2 + self.n_kv_heads * 2)
        per_layer = 0
        if self.uses_attention:
            per_layer += attn_per
        if self.block == "moe":
            n_moe_layers = L // 2 if self.paired else L
            n_dense_layers = L - n_moe_layers
            n += n_moe_layers * (
                attn_per
                + d * self.n_experts
                + 3 * d * f * self.n_experts
                + (3 * d * self.shared_expert_ff if self.shared_expert_ff else 0)
            )
            dense_ff = self.d_ff_dense or 2 * f
            n += n_dense_layers * (attn_per + 3 * d * dense_ff)
            per_layer = 0  # fully accounted above
            L = 0
        elif self.block in ("dense", "hybrid") and f > 0:
            per_layer += 3 * d * f
        if self.uses_ssm:
            dims = self.ssm_dims
            per_layer += d * dims["d_in_proj"] + dims["d_inner"] * d
            per_layer += dims["d_conv"] * dims["conv_dim"]
        n += L * per_layer
        if self.n_encoder_layers:
            enc_per = attn_per + 3 * d * f
            n += self.n_encoder_layers * enc_per
            n += self.n_layers * attn_per  # decoder cross-attention
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts; a mixed stack:
        each MoE layer's held experts at the share of a token's top_k
        choices that fall on them, rounded down)."""
        if self.block == "mixed":
            per_expert = 2 * self.d_model * self.d_ff
            n_moe = self.kind_layers("E")
            routed = n_moe * per_expert * self.top_k * self.n_experts // self.router_width
            return self.param_count() - n_moe * self.n_experts * per_expert + routed
        if self.block != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_moe_layers = self.n_layers // 2 if self.paired else self.n_layers
        total = self.param_count()
        moe_all = n_moe_layers * 3 * d * f * self.n_experts
        moe_active = n_moe_layers * 3 * d * f * self.top_k
        return total - moe_all + moe_active

    def window_sizes(self) -> List[int]:
        """Per-layer attention windows, one per flat layer (the reference's
        ``[n_scan, 2]`` for a paired stack, flattened): ``sliding_window``
        (or full) on the pattern's local layers, ``FULL_WINDOW`` on the
        others."""
        w = self.sliding_window or FULL_WINDOW
        n = self.n_layers
        if self.window_pattern == "swa":
            return [w] * n
        if self.window_pattern == "gemma2":
            return [w if i % 2 == 0 else FULL_WINDOW for i in range(n)]
        if self.window_pattern == "hymba":
            full_at = {0, n // 2, n - 1}
            return [FULL_WINDOW if i in full_at else w for i in range(n)]
        return [FULL_WINDOW] * n


@dataclasses.dataclass
class DecodeState:
    """Per-slot decoding state: k/v [L, B, S_max, Hkv, Dh] (None without
    attention), per-slot ``length`` [B] int32 (tokens already seen), the
    SSM state (None without SSM layers): h [L, B, H, P, N] f32 and conv
    [L, B, K-1, conv_dim] in the model's dtype, and the encoder memory's
    projections ``cross_kv`` k/v [L, B, T_enc, Hkv, Dh] (None without an
    encoder).  A mixed stack keeps KV for its attention layers and SSM
    states for its Mamba layers only (L their count, in pattern order), and
    ``moe``: an int64 [2] device counter that each ``prefill`` and
    ``decode_step`` sets to the requests its MoE layers routed to held
    experts and the held experts they touched, summed over the layers (None
    without the dropless MoE)."""

    kv: Optional[Dict[str, torch.Tensor]]
    length: torch.Tensor
    ssm: Optional[Dict[str, torch.Tensor]] = None
    cross_kv: Optional[Dict[str, torch.Tensor]] = None
    moe: Optional[torch.Tensor] = None


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree, leaf names as in the reference; each leaf is
    ``(shape, dtype)``: ``cfg.dtype``, except the SSM leaves the reference
    keeps in float32."""
    def leaves(tree, in_ssm=False):
        return {k: leaves(v, in_ssm or k == "ssm") if isinstance(v, dict)
                else (v, torch.float32 if in_ssm and k in ssm_lib.F32_LEAVES else cfg.dtype)
                for k, v in tree.items()}

    return leaves(_shapes(cfg))


#: Logical axes of one attention tree's leaves and of an MLP's (after the
#: stacked ``layers`` axis).
ATTN_AXES = {
    "wq": ("embed", "q_heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("q_heads", "head_dim", "embed"),
    "bq": ("q_heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
    "q_norm": ("head_dim",),
    "k_norm": ("head_dim",),
}
MLP_AXES = {"w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"), "w_down": ("ffn", "embed")}
_SUBTREE_AXES = {"attn": ATTN_AXES, "cross": ATTN_AXES, "mlp": MLP_AXES, "shared": MLP_AXES,
                 "moe": {**moe_lib.MOE_AXES, **moe_lib.DROPLESS_AXES}, "ssm": ssm_lib.SSM_AXES}


def param_axes(cfg: ModelConfig) -> Dict:
    """The parameters' logical axes (the reference's ``param_axes``): a
    tuple of axis names per leaf, in :func:`param_shapes`' structure.  A
    stacked leaf leads with ``layers``; a layer's norms are ``embed``, as
    are the final norms; the embedding and the LM head ``(vocab, embed)``."""
    def walk(tree, parent, stacked):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, k, stacked or k in ("layers", "enc_layers"))
            else:
                ax = _SUBTREE_AXES.get(parent, {}).get(k) or (
                    ("vocab", "embed") if k in ("embed", "lm_head") else ("embed",))
                out[k] = ("layers",) + ax if stacked else ax
        return out

    return walk(_shapes(cfg), None, False)


def _attn_shapes(cfg: ModelConfig, L: int, *, extras: bool = True) -> Dict:
    """One stacked attention tree; ``extras``: the config's QKV biases and
    QK-norm (the cross-attention has neither)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
    shapes = {"wq": (L, d, hq, dh), "wk": (L, d, hkv, dh), "wv": (L, d, hkv, dh),
              "wo": (L, hq, dh, d)}
    if extras and cfg.qkv_bias:
        shapes.update(bq=(L, hq, dh), bk=(L, hkv, dh), bv=(L, hkv, dh))
    if extras and cfg.qk_norm:
        shapes.update(q_norm=(L, dh), k_norm=(L, dh))
    return shapes


def _sublayer_shapes(cfg: ModelConfig, L: int, *, use_attn: bool, use_ssm: bool,
                     cross: bool, ffn: Optional[str], d_ff: int) -> Dict:
    """One stack of layers, leaves in the reference's ``_sublayer_init``
    order: attention, cross-attention, SSM, then the FFN (``ffn``: "mlp",
    "moe" or None) of width ``d_ff``."""
    d, f = cfg.d_model, d_ff
    layers: Dict = {}
    if use_attn:
        layers["attn"] = _attn_shapes(cfg, L)
        layers["pre_attn_norm"] = (L, d)
        if cfg.use_post_norms:
            layers["post_attn_norm"] = (L, d)
    if cross:
        layers["cross"] = _attn_shapes(cfg, L, extras=False)
        layers["pre_cross_norm"] = (L, d)
    if use_ssm:
        layers["ssm"] = ssm_lib.ssm_shapes(d, cfg.ssm_dims, L)
        if not use_attn:
            layers["pre_ssm_norm"] = (L, d)
    if ffn == "moe":  # no post norm, as in the reference
        layers["moe"] = moe_lib.moe_shapes(d, f, cfg.n_experts, L, cfg.shared_expert_ff)
        layers["pre_mlp_norm"] = (L, d)
    elif ffn == "mlp":
        layers["mlp"] = {"w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)}
        layers["pre_mlp_norm"] = (L, d)
        if cfg.use_post_norms:
            layers["post_mlp_norm"] = (L, d)
    return layers


def _decoder_stack(cfg: ModelConfig, make: Callable[..., Dict]) -> Dict:
    """The decoder's ``layers`` tree from ``make(L, **sublayer keywords)``:
    one stack of ``n_layers``, or a paired stack's dense sublayers (FFN
    ``d_ff_dense`` or 2 x ``d_ff``) and then its MoE sublayers, which have
    no cross-attention, ``n_layers / 2`` each, in the reference's order."""
    cross = cfg.n_encoder_layers > 0
    if cfg.paired:
        return {"dense": make(cfg.n_scan, use_attn=True, use_ssm=False, cross=cross,
                              ffn="mlp", d_ff=cfg.d_ff_dense or 2 * cfg.d_ff),
                "moe": make(cfg.n_scan, use_attn=True, use_ssm=False, cross=False,
                            ffn="moe", d_ff=cfg.d_ff)}
    # The SSM block, and a dense or hybrid one without an FFN width, has no FFN.
    ffn = {"moe": "moe", "dense": "mlp", "hybrid": "mlp"}.get(cfg.block)
    return make(cfg.n_layers, use_attn=cfg.uses_attention, use_ssm=cfg.uses_ssm,
                cross=cross, ffn=ffn if cfg.block == "moe" or cfg.d_ff > 0 else None,
                d_ff=cfg.d_ff)


def _kinds(cfg: ModelConfig) -> List[Tuple[str, str, int]]:
    """A mixed stack's kinds in the order they first appear: (pattern
    letter, the key of its stack, its layers)."""
    letters = dict.fromkeys(cfg.layer_pattern)
    return [(c, LAYER_KINDS[c], cfg.kind_layers(c)) for c in letters]


def _mixed_shapes(cfg: ModelConfig) -> Dict:
    """A mixed stack's ``layers``: a stack of each kind, each layer one
    mixer and its pre-norm."""
    d = cfg.d_model
    layers: Dict = {}
    for letter, key, L in _kinds(cfg):
        if letter == "M":
            layers[key] = {"ssm": ssm_lib.ssm_shapes(d, cfg.ssm_dims, L), "pre_ssm_norm": (L, d)}
        elif letter == "E":
            layers[key] = {"moe": moe_lib.dropless_shapes(d, cfg.d_ff, cfg.n_experts,
                                                          cfg.router_width, L,
                                                          cfg.shared_expert_ff),
                           "pre_mlp_norm": (L, d)}
        else:
            layers[key] = {"attn": _attn_shapes(cfg, L), "pre_attn_norm": (L, d)}
    return layers


def _shapes(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab, d),
              "layers": _mixed_shapes(cfg) if cfg.block == "mixed" else _decoder_stack(
                  cfg, lambda L, **kw: _sublayer_shapes(cfg, L, **kw))}
    if cfg.n_encoder_layers:
        shapes["enc_layers"] = _sublayer_shapes(cfg, cfg.n_encoder_layers, use_attn=True,
                                                use_ssm=False, cross=False, ffn="mlp",
                                                d_ff=cfg.d_ff)
        shapes["enc_final_norm"] = (d,)
    shapes["final_norm"] = (d,)
    if not cfg.tied_embeddings:
        shapes["lm_head"] = (cfg.vocab, d)
    return shapes


def _unstack(layers: Params, n: int) -> List[Params]:
    """The ``n`` layer views of a stacked tree, each leaf unbound once."""
    def split(tree):
        return {k: split(v) if isinstance(v, dict) else torch.unbind(v) for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    parts = split(layers)
    return [pick(parts, i) for i in range(n)]


def _decoder_layers(cfg: ModelConfig, layers: Params) -> List[Params]:
    """Every flat decoder layer's view, each stacked leaf unbound once: for
    a paired stack, layer ``i`` is the dense sublayer of pair ``i // 2`` at
    even ``i`` and its MoE sublayer at odd ``i``."""
    if cfg.paired:
        dense, moe = _unstack(layers["dense"], cfg.n_scan), _unstack(layers["moe"], cfg.n_scan)
        return [sub for pair in zip(dense, moe) for sub in pair]
    return _unstack(layers, cfg.n_layers)


def _mixed_layers(cfg: ModelConfig, layers: Params) -> List[Tuple[str, int, Params]]:
    """A mixed stack's layers in pattern order: (letter, index in its
    kind's stack, view), each stacked leaf unbound once."""
    views = {key: _unstack(layers[key], n) for _, key, n in _kinds(cfg)}
    seen: Dict[str, int] = {}
    out = []
    for letter in cfg.layer_pattern:
        j = seen.get(letter, 0)
        seen[letter] = j + 1
        out.append((letter, j, views[LAYER_KINDS[letter]][j]))
    return out


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


class TransformerLM:
    """The LM of every ported family: ``init``, ``forward``, ``encode``,
    ``logits``, ``prefill`` and one-token ``decode_step`` with an explicit
    :class:`DecodeState`."""

    def __init__(self, cfg: ModelConfig, *, remat: str = "none"):
        if remat not in REMAT_POLICIES:
            raise ValueError(f"remat={remat!r} is not one of {REMAT_POLICIES}")
        self.cfg = cfg
        self.remat = remat

    def _maybe_remat(self, body: Callable, *args):
        """``body(*args)``, checkpointed under autograd as ``remat`` says."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return body(*args)
        if self.remat == "full":
            return checkpoint(body, *args, use_reentrant=False)
        return checkpoint(body, *args, use_reentrant=False, context_fn=functools.partial(
            create_selective_checkpoint_contexts, _dots_policy))

    def param_axes(self) -> Dict:
        return param_axes(self.cfg)

    def decode_state_axes(self) -> DecodeState:
        """The decode state's logical axes, in :class:`DecodeState`'s
        structure (the reference's ``decode_state_axes``)."""
        cfg = self.cfg
        kv_ax = {"k": ("layers", "batch", "kv_seq", "cache_heads", "cache_dim"),
                 "v": ("layers", "batch", "kv_seq", "cache_heads", "cache_dim")}
        ssm_ax = {"h": ("layers", "batch", "ssm_heads", "ssm_head_dim", "ssm_state"),
                  "conv": ("layers", "batch", "conv", "ssm_conv_dim")}
        return DecodeState(kv=kv_ax if cfg.uses_attention else None,
                           ssm=ssm_ax if cfg.uses_ssm else None,
                           cross_kv=kv_ax if cfg.n_encoder_layers else None,
                           length=("batch",),
                           moe=("moe_counts",) if cfg.kind_layers("E") else None)

    # ------------------------------------------------------------------ init
    def _sublayer_init(self, L: int, generator: torch.Generator, dev: torch.device, *,
                       use_attn: bool, use_ssm: bool, cross: bool, ffn: Optional[str],
                       d_ff: int) -> Params:
        """One stack of layers, drawn in the leaf order of
        :func:`_sublayer_shapes`."""
        cfg = self.cfg
        dt = cfg.dtype
        d, f, hq, hkv, dh = cfg.d_model, d_ff, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        layers: Params = {}
        if use_attn:
            layers["attn"] = attn.attention_init(d, hq, hkv, dh, dt, generator, dev, stacked=L,
                                                 qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm)
            layers["pre_attn_norm"] = zeros(L, d)
            if cfg.use_post_norms:
                layers["post_attn_norm"] = zeros(L, d)
        if cross:
            layers["cross"] = attn.attention_init(d, hq, hkv, dh, dt, generator, dev, stacked=L)
            layers["pre_cross_norm"] = zeros(L, d)
        if use_ssm:
            layers["ssm"] = ssm_lib.ssm_init(d, cfg.ssm_dims, dt, generator, dev, stacked=L)
            if not use_attn:
                layers["pre_ssm_norm"] = zeros(L, d)
        if ffn == "moe":
            layers["moe"] = moe_lib.moe_init(d, f, cfg.n_experts, dt, generator, dev,
                                             stacked=L, shared_expert_ff=cfg.shared_expert_ff)
            layers["pre_mlp_norm"] = zeros(L, d)
        elif ffn == "mlp":
            layers["mlp"] = {
                "w_gate": dense_init(d, (L, d, f), dt, generator, dev),
                "w_up": dense_init(d, (L, d, f), dt, generator, dev),
                "w_down": dense_init(f, (L, f, d), dt, generator, dev),
            }
            layers["pre_mlp_norm"] = zeros(L, d)
            if cfg.use_post_norms:
                layers["post_mlp_norm"] = zeros(L, d)
        return layers

    def _mixed_init(self, generator: torch.Generator, dev: torch.device) -> Params:
        """A mixed stack's layers, drawn in the order of :func:`_mixed_shapes`."""
        cfg = self.cfg
        dt, d = cfg.dtype, cfg.d_model
        layers: Params = {}
        for letter, key, L in _kinds(cfg):
            norm = torch.zeros((L, d), dtype=dt, device=dev)
            if letter == "M":
                layers[key] = {"ssm": ssm_lib.ssm_init(d, cfg.ssm_dims, dt, generator, dev,
                                                       stacked=L), "pre_ssm_norm": norm}
            elif letter == "E":
                layers[key] = {"moe": moe_lib.dropless_init(
                    d, cfg.d_ff, cfg.n_experts, cfg.router_width, dt, generator, dev,
                    stacked=L, shared_expert_ff=cfg.shared_expert_ff), "pre_mlp_norm": norm}
            else:
                layers[key] = {"attn": attn.attention_init(
                    d, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim, dt, generator, dev,
                    stacked=L, qkv_bias=cfg.qkv_bias, qk_norm=cfg.qk_norm),
                    "pre_attn_norm": norm}
        return layers

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Random weights from ``generator`` (which must live on ``device``):
        truncated-normal dense and embedding leaves, zero norms and biases,
        and the SSM's fixed ``A_log``, ``D`` and ``dt_bias``.  Leaves come in
        the reference's order."""
        cfg = self.cfg
        dev = resolve_device(device)
        d = cfg.d_model
        params: Params = {"embed": embed_init((cfg.vocab, d), cfg.dtype, generator, dev)}
        if cfg.block == "mixed":
            params["layers"] = self._mixed_init(generator, dev)
        else:
            params["layers"] = _decoder_stack(
                cfg, lambda L, **kw: self._sublayer_init(L, generator, dev, **kw))
        if cfg.n_encoder_layers:
            params["enc_layers"] = self._sublayer_init(cfg.n_encoder_layers, generator, dev,
                                                       use_attn=True, use_ssm=False,
                                                       cross=False, ffn="mlp", d_ff=cfg.d_ff)
            params["enc_final_norm"] = torch.zeros(d, dtype=cfg.dtype, device=dev)
        params["final_norm"] = torch.zeros(d, dtype=cfg.dtype, device=dev)
        if not cfg.tied_embeddings:
            params["lm_head"] = embed_init((cfg.vocab, d), cfg.dtype, generator, dev)
        return params

    # ------------------------------------------------------------- embedding
    def _embed(self, params: Params, tokens: torch.Tensor,
               frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings; for a vision frontend, ``frontend_embeds``
        [B, F, D] (stubbed patch embeddings, cast to the model's dtype)
        replace the first F positions (early fusion)."""
        cfg = self.cfg
        x = embed_lookup(params["embed"], tokens)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model**0.5, dtype=x.dtype)
        if frontend_embeds is not None and cfg.frontend == "vision":
            n = frontend_embeds.shape[1]
            if tokens.shape[1] < n:
                raise ValueError(f"{cfg.name}: a prompt of {tokens.shape[1]} tokens cannot "
                                 f"hold {n} patch embeddings")
            x = torch.cat([frontend_embeds.to(x.dtype), x[:, n:]], dim=1)
        return constrain(x, ACT)

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """The residual stream's norm: RMSNorm or LayerNorm (``cfg.norm``),
        with ``cfg.norm_eps`` where it is set."""
        eps = self.cfg.norm_eps
        if self.cfg.norm == "rms":
            return rmsnorm(x, scale) if eps is None else rmsnorm(x, scale, eps)
        return layernorm(x, scale) if eps is None else layernorm(x, scale, eps=eps)

    @property
    def _ssm_eps(self) -> float:
        """The SSM's gated norm's epsilon."""
        return 1e-6 if self.cfg.norm_eps is None else self.cfg.norm_eps

    def _ffn(self, layer: Params, x: torch.Tensor
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The layer's FFN sub-block: (x, the MoE's load-balance aux loss, or
        None for the MLP).  The identity for a layer without one (the SSM
        block: d_ff = 0).  The MoE routes all of the call's tokens at once,
        so a prompt's capacity is that of its whole length."""
        cfg = self.cfg
        if "moe" in layer:
            h = self._norm(x, layer["pre_mlp_norm"])
            m, aux = moe_lib.moe_apply(layer["moe"], h, top_k=cfg.top_k,
                                       capacity_factor=cfg.capacity_factor,
                                       activation=cfg.activation)
            return x + constrain(m, ACT), aux
        if "mlp" not in layer:
            return x, None
        h = self._norm(x, layer["pre_mlp_norm"])
        m = constrain(mlp_apply(layer["mlp"], h, activation=cfg.activation), ACT)
        if cfg.use_post_norms:
            m = self._norm(m, layer["post_mlp_norm"])
        return x + m, None

    def _attn_out(self, layer: Params, a: torch.Tensor) -> torch.Tensor:
        """The attention sub-block's output before the residual add."""
        a = constrain(a, ACT)
        if self.cfg.use_post_norms:
            return self._norm(a, layer["post_attn_norm"])
        return a

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        table = params["embed"] if cfg.tied_embeddings else params["lm_head"]
        logits = unembed(x, gather_fsdp(table))
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        return logits

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return self._logits(params, hidden)

    # ------------------------------------------------------- train / prefill
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed (stubbed conv) frame
        embeddings [B, T, D]: non-causal attention without RoPE and the
        gated MLP per layer, then ``enc_final_norm``."""
        cfg = self.cfg
        b, t = frames.shape[:2]
        positions = torch.arange(t, device=frames.device)[None, :].expand(b, t)
        x = frames.to(cfg.dtype)
        for layer in _unstack(params["enc_layers"], cfg.n_encoder_layers):
            x = constrain(x, ACT)
            layer = tree_map(gather_fsdp, layer)
            h = self._norm(x, layer["pre_attn_norm"])
            x = x + constrain(attn.attend_full(layer["attn"], h, positions, rope_theta=None,
                                               window=FULL_WINDOW, causal=False), ACT)
            x, _ = self._ffn(layer, x)
        return self._norm(x, params["enc_final_norm"])

    def _cross_memory(self, params: Params, frontend_embeds: Optional[torch.Tensor],
                      layers: Optional[List[Params]] = None
                      ) -> Optional[Dict[str, torch.Tensor]]:
        """Each decoder layer's cross-attention K/V of the encoded frames,
        stacked [L, B, T, Hkv, Dh]; None without an encoder.  ``layers``:
        the decoder's unstacked layers, if the caller has them."""
        cfg = self.cfg
        if not cfg.n_encoder_layers:
            return None
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs its frame "
                             "embeddings (frontend_embeds)")
        enc = self.encode(params, frontend_embeds)
        layers = layers or _decoder_layers(cfg, params["layers"])
        kv = [attn.project_memory_kv(tree_map(gather_fsdp, layer["cross"]), enc)
              for layer in layers]
        return {"k": torch.stack([k for k, _ in kv]), "v": torch.stack([v for _, v in kv])}

    def _cross(self, layer: Params, x: torch.Tensor, memory, i: int) -> torch.Tensor:
        """The cross-attention sub-block of decoder layer ``i`` (the
        identity without an encoder memory)."""
        if memory is None:
            return x
        h = self._norm(x, layer["pre_cross_norm"])
        return x + constrain(attn.attend_cross(layer["cross"], h, memory["k"][i],
                                               memory["v"][i]), ACT)

    def _block(self, layer: Params, x: torch.Tensor, positions: torch.Tensor, window: int,
               i: int, kv: Optional[Dict[str, torch.Tensor]],
               ssm: Optional[Dict[str, torch.Tensor]],
               memory: Optional[Dict[str, torch.Tensor]]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Flat decoder layer ``i`` over the whole sequence: (x, its MoE aux
        loss or None).  Writes its K/V prefix into ``kv`` and its SSM
        branch's final scan and conv states into ``ssm``."""
        cfg = self.cfg
        x = constrain(x, ACT)
        layer = tree_map(gather_fsdp, layer)

        def ssm_branch(h):
            out, st = ssm_lib.ssm_branch(layer["ssm"], h, cfg.ssm_dims, chunk=cfg.ssm_chunk)
            if ssm is not None:
                ssm["h"][i] = st["h"]
                ssm["conv"][i] = st["conv"]
            return constrain(out, ACT)

        if "attn" not in layer:  # pure SSM block
            h = self._norm(x, layer["pre_ssm_norm"])
            return self._ffn(layer, x + ssm_branch(h))
        h = self._norm(x, layer["pre_attn_norm"])
        if kv is not None:
            _, k, v = attn.project_qkv(layer["attn"], h, positions, rope_theta=cfg.rope_theta)
            attn.write_cache_prefix(kv["k"][i], k)
            attn.write_cache_prefix(kv["v"][i], v)
        a = attn.attend_full(
            layer["attn"], h, positions, rope_theta=cfg.rope_theta,
            window=window, softcap_value=cfg.attn_softcap,
            query_scale=cfg.query_scale,
        )
        if "ssm" in layer:  # hybrid: parallel heads, mean-fused
            a = 0.5 * (a + ssm_branch(h))
        x = self._cross(layer, x + self._attn_out(layer, a), memory, i)
        return self._ffn(layer, x)

    def _mixed_block(self, layer: Params, x: torch.Tensor, positions: torch.Tensor,
                     letter: str, j: int, kv: Optional[Dict[str, torch.Tensor]],
                     ssm: Optional[Dict[str, torch.Tensor]],
                     counts: Optional[torch.Tensor]) -> torch.Tensor:
        """One layer of a mixed stack over the whole sequence, ``x +
        mixer(norm(x))``; ``j`` is its index in its kind's stack, where it
        writes its K/V prefix or its final scan and conv states."""
        cfg = self.cfg
        x = constrain(x, ACT)
        layer = tree_map(gather_fsdp, layer)
        if letter == "M":
            h = self._norm(x, layer["pre_ssm_norm"])
            out, st = ssm_lib.ssm_branch(layer["ssm"], h, cfg.ssm_dims, chunk=cfg.ssm_chunk,
                                         eps=self._ssm_eps)
            if ssm is not None:
                ssm["h"][j] = st["h"]
                ssm["conv"][j] = st["conv"]
            return x + constrain(out, ACT)
        if letter == "E":
            h = self._norm(x, layer["pre_mlp_norm"])
            return x + constrain(moe_lib.dropless_apply(
                layer["moe"], h, top_k=cfg.top_k, scaling=cfg.routed_scaling, counts=counts), ACT)
        h = self._norm(x, layer["pre_attn_norm"])
        if kv is not None:
            _, k, v = attn.project_qkv(layer["attn"], h, positions, rope_theta=cfg.rope_theta)
            attn.write_cache_prefix(kv["k"][j], k)
            attn.write_cache_prefix(kv["v"][j], v)
        a = attn.attend_full(layer["attn"], h, positions, rope_theta=cfg.rope_theta,
                             window=FULL_WINDOW, softcap_value=cfg.attn_softcap,
                             query_scale=cfg.query_scale)
        return x + self._attn_out(layer, a)

    def _run_mixed(self, params: Params, tokens: torch.Tensor,
                   kv: Optional[Dict[str, torch.Tensor]] = None,
                   ssm: Optional[Dict[str, torch.Tensor]] = None,
                   counts: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A mixed stack over the whole sequence: hidden states after the
        final norm.  Writes each attention layer's K/V prefix into ``kv``,
        each Mamba layer's final states into ``ssm``, and the MoE layers'
        counts into ``counts``."""
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(params, tokens)
        for letter, j, layer in _mixed_layers(self.cfg, params["layers"]):
            x = self._maybe_remat(
                functools.partial(self._mixed_block, positions=positions, letter=letter, j=j,
                                  kv=kv, ssm=ssm, counts=counts), layer, x)
        return self._norm(x, params["final_norm"])

    def _decode_mixed(self, params: Params, state: DecodeState, token: torch.Tensor
                      ) -> torch.Tensor:
        """One decode step of a mixed stack: logits [B, V]; the caches, the
        SSM states and the MoE counts are written in place."""
        cfg = self.cfg
        x = self._embed(params, token[:, None])  # [B,1,D]
        if state.moe is not None:
            state.moe.zero_()
        for letter, j, layer in _mixed_layers(cfg, params["layers"]):
            x = constrain(x, ACT)
            layer = tree_map(gather_fsdp, layer)
            if letter == "M":
                h = self._norm(x, layer["pre_ssm_norm"])
                y, new = ssm_lib.ssm_step(
                    layer["ssm"], h, {"h": state.ssm["h"][j], "conv": state.ssm["conv"][j]},
                    cfg.ssm_dims, eps=self._ssm_eps)  # the state's h in place
                state.ssm["conv"][j] = new["conv"]
                x = x + constrain(y, ACT)
            elif letter == "E":
                h = self._norm(x, layer["pre_mlp_norm"])
                x = x + constrain(moe_lib.dropless_apply(
                    layer["moe"], h, top_k=cfg.top_k, scaling=cfg.routed_scaling,
                    counts=state.moe), ACT)
            else:
                h = self._norm(x, layer["pre_attn_norm"])
                cache = {"k": state.kv["k"][j], "v": state.kv["v"][j]}
                a = attn.attend_cached(layer["attn"], h, cache, state.length,
                                       rope_theta=cfg.rope_theta, window=FULL_WINDOW,
                                       softcap_value=cfg.attn_softcap,
                                       query_scale=cfg.query_scale)
                x = x + self._attn_out(layer, a)
        x = self._norm(x, params["final_norm"])
        return self._logits(params, x)[:, 0, :]

    def _run(self, params: Params, layers: List[Params], tokens: torch.Tensor,
             frontend_embeds: Optional[torch.Tensor] = None,
             kv: Optional[Dict[str, torch.Tensor]] = None,
             ssm: Optional[Dict[str, torch.Tensor]] = None,
             memory: Optional[Dict[str, torch.Tensor]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence stack over ``layers`` (:func:`_decoder_layers`):
        (hidden states after the final norm, the MoE layers' aux losses
        summed in f32).  Writes each layer's K/V
        prefix into ``kv`` and each SSM branch's final scan and conv states
        into ``ssm``.  A hybrid layer's attention and SSM branch read the
        same normed input and are mean-fused; ``memory`` is the encoder's
        cross K/V.  Each layer's body is checkpointed as ``remat`` says."""
        cfg = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(params, tokens, frontend_embeds)
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (layer, window) in enumerate(zip(layers, cfg.window_sizes())):
            x, aux = self._maybe_remat(
                functools.partial(self._block, positions=positions, window=window, i=i,
                                  kv=kv, ssm=ssm, memory=memory), layer, x)
            if aux is not None:
                aux_total = aux_total + aux
        return self._norm(x, params["final_norm"]), aux_total

    def forward(self, params: Params, tokens: torch.Tensor, *,
                frontend_embeds: Optional[torch.Tensor] = None, return_aux: bool = False):
        """Full-sequence forward: hidden states [B, S, D] after the final
        norm, or with ``return_aux`` (hidden, aux) as the reference's
        ``forward`` returns them: aux is the MoE layers' load-balance losses
        summed in f32 (0 without MoE).  ``frontend_embeds``: patch
        embeddings (vision) or the encoder's frames (audio, required)."""
        if self.cfg.block == "mixed":
            x = self._run_mixed(params, tokens)
            return (x, torch.zeros((), dtype=torch.float32, device=x.device)) if return_aux else x
        layers = _decoder_layers(self.cfg, params["layers"])
        x, aux = self._run(params, layers, tokens, frontend_embeds,
                           memory=self._cross_memory(params, frontend_embeds, layers))
        return (x, aux) if return_aux else x

    # ---------------------------------------------------------------- serving
    def init_decode_state(self, batch: int, max_len: int, device=None) -> DecodeState:
        cfg = self.cfg
        dev = resolve_device(device)
        kv = ssm = cross_kv = None

        def zeros_kv(seq, layers=cfg.n_layers):
            shape = (layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                    "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}

        if cfg.uses_attention:
            kv = zeros_kv(max_len, cfg.n_attn_layers)
        if cfg.uses_ssm:
            dims = cfg.ssm_dims
            n = cfg.kind_layers("M") if cfg.block == "mixed" else cfg.n_layers
            ssm = {
                "h": torch.zeros((n, batch, dims["n_heads"], dims["head_dim"],
                                  dims["d_state"]), dtype=torch.float32, device=dev),
                "conv": torch.zeros((n, batch, dims["d_conv"] - 1,
                                     dims["conv_dim"]), dtype=cfg.dtype, device=dev),
            }
        if cfg.n_encoder_layers:
            cross_kv = zeros_kv(cfg.encoder_seq)
        moe = (torch.zeros(2, dtype=torch.int64, device=dev) if cfg.kind_layers("E")
               else None)
        return DecodeState(kv=kv, ssm=ssm, cross_kv=cross_kv,
                           length=torch.zeros(batch, dtype=torch.int32, device=dev), moe=moe)

    def decode_step(
        self,
        params: Params,
        state: DecodeState,
        token: torch.Tensor,  # [B] int
    ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step for every slot, inactive ones included:
        (logits [B, V], state with length + 1)."""
        cfg = self.cfg
        if cfg.block == "mixed":
            logits = self._decode_mixed(params, state, token)
            return logits, dataclasses.replace(state, length=state.length + 1)
        x = self._embed(params, token[:, None])  # [B,1,D]
        length = state.length

        def ssm_step(layer, h, i):
            y, new = ssm_lib.ssm_step(
                layer["ssm"], h, {"h": state.ssm["h"][i], "conv": state.ssm["conv"][i]},
                cfg.ssm_dims)  # the state's h in place
            state.ssm["conv"][i] = new["conv"]
            return constrain(y, ACT)

        layers = _decoder_layers(cfg, params["layers"])
        for i, (layer, window) in enumerate(zip(layers, cfg.window_sizes())):
            x = constrain(x, ACT)
            layer = tree_map(gather_fsdp, layer)
            if "attn" not in layer:  # pure SSM block: the recurrence
                h = self._norm(x, layer["pre_ssm_norm"])
                x, _ = self._ffn(layer, x + ssm_step(layer, h, i))
                continue
            h = self._norm(x, layer["pre_attn_norm"])
            cache = {"k": state.kv["k"][i], "v": state.kv["v"][i]}
            a = attn.attend_cached(
                layer["attn"], h, cache, length, rope_theta=cfg.rope_theta,
                window=window, softcap_value=cfg.attn_softcap,
                query_scale=cfg.query_scale,
            )
            if "ssm" in layer:  # hybrid: the recurrence on the same input
                a = 0.5 * (a + ssm_step(layer, h, i))
            x = self._cross(layer, x + self._attn_out(layer, a), state.cross_kv, i)
            x, _ = self._ffn(layer, x)
        x = self._norm(x, params["final_norm"])
        logits = self._logits(params, x)[:, 0, :]
        return logits, dataclasses.replace(state, length=length + 1)

    def prefill(
        self,
        params: Params,
        tokens: torch.Tensor,  # [B, S]
        state: DecodeState,
        *,
        frontend_embeds: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, DecodeState]:
        """Prefill the caches, the SSM states and the cross K/V with a
        prompt (and, for an encoder-decoder, the frames it attends to);
        returns (last logits [B,V], state)."""
        b, s = tokens.shape
        if self.cfg.block == "mixed":
            if state.moe is not None:
                state.moe.zero_()
            x = self._run_mixed(params, tokens, state.kv, state.ssm, state.moe)
            logits = self._logits(params, x[:, -1:, :])[:, 0, :]
            length = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
            return logits, dataclasses.replace(state, length=length)
        layers = _decoder_layers(self.cfg, params["layers"])
        memory = self._cross_memory(params, frontend_embeds, layers)
        cross_kv = state.cross_kv
        if memory is not None:
            if cross_kv is not None and cross_kv["k"].shape == memory["k"].shape:
                for name in cross_kv:
                    cross_kv[name].copy_(memory[name])
            else:  # frames of another length than the state's buffer
                cross_kv = memory
        x, _ = self._run(params, layers, tokens, frontend_embeds, state.kv, state.ssm, memory)
        logits = self._logits(params, x[:, -1:, :])[:, 0, :]
        length = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return logits, dataclasses.replace(state, cross_kv=cross_kv, length=length)
