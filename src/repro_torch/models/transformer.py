"""The decoder of the port (``TransformerLM``'s dense and pure-SSM paths
from ``repro/models/transformer.py``): the llama, gemma2, h2o-danube,
stablelm and qwen2.5 attention families and mamba2.

Parameters keep the reference's stacked ``[L, ...]`` leaves and names, so
``repro_torch.models.weights.params_from_numpy`` maps the reference's tree
onto the port's.  ``lax.scan`` over layers becomes a Python loop over the
leading index.  Decode state is mutable: ``prefill`` and ``decode_step``
write the KV caches and the SSM states in place and return a state that
shares them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
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

FULL_WINDOW = 1 << 30  # "window" larger than any sequence = dense attention
#: Per-layer window patterns: all full; all sliding; gemma2's local (even)
#: and global (odd) layers; hymba's full first, middle and last layers.
WINDOW_PATTERNS = ("full", "swa", "gemma2", "hymba")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Copy of the reference's ``ModelConfig`` for the dense and pure-SSM
    families; ``dtype`` is a torch dtype.  Flags of families the port has
    not reached yet (MoE, hybrid, encoder, frontend) raise
    ``NotImplementedError`` instead of being ignored; an unknown window
    pattern, norm or activation raises ``ValueError``."""

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
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_chunk: int = 128
    n_encoder_layers: int = 0
    frontend: Optional[str] = None
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        unported = {
            f"block={self.block!r}": self.block not in ("dense", "ssm"),
            "n_experts (MoE)": self.n_experts != 0,
            "n_encoder_layers (encoder)": self.n_encoder_layers != 0,
            "frontend": self.frontend is not None,
        }
        bad = [k for k, v in unported.items() if v]
        if bad:
            raise NotImplementedError(
                f"{self.name}: {', '.join(bad)} not ported yet "
                "(dense and pure-SSM paths only)"
            )
        for field, allowed in (("window_pattern", WINDOW_PATTERNS), ("norm", ("rms", "layernorm")),
                               ("activation", ("silu", "gelu"))):
            if getattr(self, field) not in allowed:
                raise ValueError(f"{self.name}: {field}={getattr(self, field)!r} is not one of "
                                 f"{allowed}")
        if self.uses_attention and self.n_q_heads % self.n_kv_heads:
            raise ValueError("n_q_heads must be a multiple of n_kv_heads")

    @property
    def uses_attention(self) -> bool:
        return self.block in ("dense", "moe", "hybrid")

    @property
    def uses_ssm(self) -> bool:
        return self.block in ("ssm", "hybrid")

    @property
    def ssm_dims(self) -> Dict[str, int]:
        return ssm_lib.ssm_dims(self.d_model, expand=self.ssm_expand,
                                head_dim=self.ssm_head_dim, d_state=self.ssm_state,
                                n_groups=self.ssm_groups)

    def window_sizes(self) -> List[int]:
        """Per-layer attention windows: ``sliding_window`` (or full) on the
        pattern's local layers, ``FULL_WINDOW`` on the others."""
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
    attention), per-slot ``length`` [B] int32 (tokens already seen), and
    the SSM state (None without SSM layers): h [L, B, H, P, N] f32 and
    conv [L, B, K-1, conv_dim] in the model's dtype."""

    kv: Optional[Dict[str, torch.Tensor]]
    length: torch.Tensor
    ssm: Optional[Dict[str, torch.Tensor]] = None


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree, leaf names as in the reference; each leaf is
    ``(shape, dtype)``: ``cfg.dtype``, except the SSM leaves the reference
    keeps in float32."""
    def leaves(tree, in_ssm=False):
        return {k: leaves(v, in_ssm or k == "ssm") if isinstance(v, dict)
                else (v, torch.float32 if in_ssm and k in ssm_lib.F32_LEAVES else cfg.dtype)
                for k, v in tree.items()}

    return leaves(_shapes(cfg))


def _shapes(cfg: ModelConfig) -> Dict:
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    if cfg.block == "ssm":
        layers = {"ssm": ssm_lib.ssm_shapes(d, cfg.ssm_dims, L), "pre_ssm_norm": (L, d)}
    else:
        hq, hkv, dh = cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim
        attn_shapes = {"wq": (L, d, hq, dh), "wk": (L, d, hkv, dh),
                       "wv": (L, d, hkv, dh), "wo": (L, hq, dh, d)}
        if cfg.qkv_bias:
            attn_shapes.update(bq=(L, hq, dh), bk=(L, hkv, dh), bv=(L, hkv, dh))
        if cfg.qk_norm:
            attn_shapes.update(q_norm=(L, dh), k_norm=(L, dh))
        layers = {"attn": attn_shapes, "pre_attn_norm": (L, d)}
        if cfg.use_post_norms:
            layers["post_attn_norm"] = (L, d)
        layers["mlp"] = {"w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)}
        layers["pre_mlp_norm"] = (L, d)
        if cfg.use_post_norms:
            layers["post_mlp_norm"] = (L, d)
    shapes = {"embed": (cfg.vocab, d), "layers": layers, "final_norm": (d,)}
    if not cfg.tied_embeddings:
        shapes["lm_head"] = (cfg.vocab, d)
    return shapes


def _layer(layers: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked ``[L, ...]`` tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


class TransformerLM:
    """Decoder LM, dense or pure SSM: ``init``, ``forward``, ``logits``,
    ``prefill`` and one-token ``decode_step`` with an explicit
    :class:`DecodeState`."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def init(self, generator: torch.Generator, device=None) -> Params:
        """Random weights from ``generator`` (which must live on ``device``):
        truncated-normal dense and embedding leaves, zero norms and biases,
        and the SSM's fixed ``A_log``, ``D`` and ``dt_bias``.  Leaves come in
        the reference's order."""
        cfg = self.cfg
        dev = resolve_device(device)
        dt = cfg.dtype
        d, f, hq, dh = cfg.d_model, cfg.d_ff, cfg.n_q_heads, cfg.head_dim
        L = cfg.n_layers

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        params: Params = {"embed": embed_init((cfg.vocab, d), dt, generator, dev)}
        if cfg.block == "ssm":
            params["layers"] = {
                "ssm": ssm_lib.ssm_init(d, cfg.ssm_dims, dt, generator, dev, stacked=L),
                "pre_ssm_norm": zeros(L, d),
            }
        else:
            layers = {
                "attn": attn.attention_init(d, hq, cfg.n_kv_heads, dh, dt, generator, dev,
                                            stacked=L, qkv_bias=cfg.qkv_bias,
                                            qk_norm=cfg.qk_norm),
                "pre_attn_norm": zeros(L, d),
            }
            if cfg.use_post_norms:
                layers["post_attn_norm"] = zeros(L, d)
            layers["mlp"] = {
                "w_gate": dense_init(d, (L, d, f), dt, generator, dev),
                "w_up": dense_init(d, (L, d, f), dt, generator, dev),
                "w_down": dense_init(f, (L, f, d), dt, generator, dev),
            }
            layers["pre_mlp_norm"] = zeros(L, d)
            if cfg.use_post_norms:
                layers["post_mlp_norm"] = zeros(L, d)
            params["layers"] = layers
        params["final_norm"] = zeros(d)
        if not cfg.tied_embeddings:
            params["lm_head"] = embed_init((cfg.vocab, d), dt, generator, dev)
        return params

    # ------------------------------------------------------------- embedding
    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        x = embed_lookup(params["embed"], tokens)
        if self.cfg.embed_scale:
            x = x * torch.tensor(self.cfg.d_model**0.5, dtype=x.dtype)
        return x

    def _norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """The residual stream's norm: RMSNorm or LayerNorm (``cfg.norm``)."""
        if self.cfg.norm == "rms":
            return rmsnorm(x, scale)
        return layernorm(x, scale)

    def _ffn(self, layer: Params, x: torch.Tensor) -> torch.Tensor:
        """The layer's MLP sub-block; the identity for a layer without one
        (the SSM block: d_ff = 0)."""
        if "mlp" not in layer:
            return x
        h = self._norm(x, layer["pre_mlp_norm"])
        m = mlp_apply(layer["mlp"], h, activation=self.cfg.activation)
        if self.cfg.use_post_norms:
            m = self._norm(m, layer["post_mlp_norm"])
        return x + m

    def _attn_out(self, layer: Params, a: torch.Tensor) -> torch.Tensor:
        """The attention sub-block's output before the residual add."""
        if self.cfg.use_post_norms:
            return self._norm(a, layer["post_attn_norm"])
        return a

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        table = params["embed"] if cfg.tied_embeddings else params["lm_head"]
        logits = unembed(x, table)
        if cfg.final_softcap:
            logits = softcap(logits, cfg.final_softcap)
        return logits

    def logits(self, params: Params, hidden: torch.Tensor) -> torch.Tensor:
        return self._logits(params, hidden)

    # ------------------------------------------------------- train / prefill
    def _run(self, params: Params, tokens: torch.Tensor,
             kv: Optional[Dict[str, torch.Tensor]] = None,
             ssm: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Full-sequence stack; writes each layer's K/V prefix into ``kv``
        and each SSM layer's final scan and conv states into ``ssm``."""
        cfg = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(params, tokens)
        for i, window in enumerate(cfg.window_sizes()):
            layer = _layer(params["layers"], i)
            if "attn" not in layer:  # pure SSM block
                h = self._norm(x, layer["pre_ssm_norm"])
                out, st = ssm_lib.ssm_branch(layer["ssm"], h, cfg.ssm_dims,
                                             chunk=cfg.ssm_chunk)
                if ssm is not None:
                    ssm["h"][i] = st["h"]
                    ssm["conv"][i] = st["conv"]
                x = self._ffn(layer, x + out)
                continue
            h = self._norm(x, layer["pre_attn_norm"])
            if kv is not None:
                _, k, v = attn.project_qkv(layer["attn"], h, positions,
                                           rope_theta=cfg.rope_theta)
                kv["k"][i, :, :s] = k.to(kv["k"].dtype)
                kv["v"][i, :, :s] = v.to(kv["v"].dtype)
            x = x + self._attn_out(layer, attn.attend_full(
                layer["attn"], h, positions, rope_theta=cfg.rope_theta,
                window=window, softcap_value=cfg.attn_softcap,
                query_scale=cfg.query_scale,
            ))
            x = self._ffn(layer, x)
        return self._norm(x, params["final_norm"])

    def forward(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward: hidden states [B, S, D] after the final norm."""
        return self._run(params, tokens)

    # ---------------------------------------------------------------- serving
    def init_decode_state(self, batch: int, max_len: int, device=None) -> DecodeState:
        cfg = self.cfg
        dev = resolve_device(device)
        kv = ssm = None
        if cfg.uses_attention:
            shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            kv = {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                  "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}
        if cfg.uses_ssm:
            dims = cfg.ssm_dims
            ssm = {
                "h": torch.zeros((cfg.n_layers, batch, dims["n_heads"], dims["head_dim"],
                                  dims["d_state"]), dtype=torch.float32, device=dev),
                "conv": torch.zeros((cfg.n_layers, batch, dims["d_conv"] - 1,
                                     dims["conv_dim"]), dtype=cfg.dtype, device=dev),
            }
        return DecodeState(kv=kv, ssm=ssm,
                           length=torch.zeros(batch, dtype=torch.int32, device=dev))

    def decode_step(
        self,
        params: Params,
        state: DecodeState,
        token: torch.Tensor,  # [B] int
    ) -> Tuple[torch.Tensor, DecodeState]:
        """One decode step for every slot, inactive ones included:
        (logits [B, V], state with length + 1)."""
        cfg = self.cfg
        x = self._embed(params, token[:, None])  # [B,1,D]
        length = state.length
        for i, window in enumerate(cfg.window_sizes()):
            layer = _layer(params["layers"], i)
            if "attn" not in layer:  # pure SSM block: the recurrence
                h = self._norm(x, layer["pre_ssm_norm"])
                y, new = ssm_lib.ssm_step(
                    layer["ssm"], h, {"h": state.ssm["h"][i], "conv": state.ssm["conv"][i]},
                    cfg.ssm_dims)
                state.ssm["h"][i] = new["h"]
                state.ssm["conv"][i] = new["conv"]
                x = self._ffn(layer, x + y)
                continue
            h = self._norm(x, layer["pre_attn_norm"])
            cache = {"k": state.kv["k"][i], "v": state.kv["v"][i]}
            x = x + self._attn_out(layer, attn.attend_cached(
                layer["attn"], h, cache, length, rope_theta=cfg.rope_theta,
                window=window, softcap_value=cfg.attn_softcap,
                query_scale=cfg.query_scale,
            ))
            x = self._ffn(layer, x)
        x = self._norm(x, params["final_norm"])
        logits = self._logits(params, x)[:, 0, :]
        return logits, DecodeState(kv=state.kv, ssm=state.ssm, length=length + 1)

    def prefill(
        self,
        params: Params,
        tokens: torch.Tensor,  # [B, S]
        state: DecodeState,
    ) -> Tuple[torch.Tensor, DecodeState]:
        """Prefill the caches and SSM states with a prompt; returns (last
        logits [B,V], state)."""
        b, s = tokens.shape
        x = self._run(params, tokens, state.kv, state.ssm)
        logits = self._logits(params, x[:, -1:, :])[:, 0, :]
        length = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return logits, DecodeState(kv=state.kv, ssm=state.ssm, length=length)
