"""The port's ``TransformerLM`` (``repro/models/transformer.py`` without
MoE): the llama, gemma2, h2o-danube, stablelm and qwen2.5 attention
families, mamba2, hymba's hybrid block (parallel attention and SSM heads
on one normed input, mean-fused), whisper's encoder-decoder (a non-causal
encoder over stubbed frame embeddings, cross-attention in every decoder
layer) and internvl2's early fusion (stubbed patch embeddings replace the
first prompt positions).

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
    """Copy of the reference's ``ModelConfig`` without the MoE fields;
    ``dtype`` is a torch dtype.  MoE (``block="moe"``, ``n_experts``) is not
    ported yet and raises ``NotImplementedError`` instead of being ignored;
    an unknown block, window pattern, norm, activation or frontend raises
    ``ValueError``."""

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
    encoder_seq: int = 1500  # whisper: 30 s of 10 ms frames after the conv stub
    frontend: Optional[str] = None  # None | "vision" | "audio"
    frontend_seq: int = 0  # vision: patch embeddings fused into the first positions
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self) -> None:
        if self.block == "moe" or self.n_experts != 0:
            raise NotImplementedError(f"{self.name}: MoE (block='moe', n_experts) is not "
                                      "ported yet")
        for field, allowed in (("block", ("dense", "ssm", "hybrid")),
                               ("window_pattern", WINDOW_PATTERNS), ("norm", ("rms", "layernorm")),
                               ("activation", ("silu", "gelu")),
                               ("frontend", (None, "vision", "audio"))):
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
    attention), per-slot ``length`` [B] int32 (tokens already seen), the
    SSM state (None without SSM layers): h [L, B, H, P, N] f32 and conv
    [L, B, K-1, conv_dim] in the model's dtype, and the encoder memory's
    projections ``cross_kv`` k/v [L, B, T_enc, Hkv, Dh] (None without an
    encoder)."""

    kv: Optional[Dict[str, torch.Tensor]]
    length: torch.Tensor
    ssm: Optional[Dict[str, torch.Tensor]] = None
    cross_kv: Optional[Dict[str, torch.Tensor]] = None


def param_shapes(cfg: ModelConfig) -> Dict:
    """The parameter tree, leaf names as in the reference; each leaf is
    ``(shape, dtype)``: ``cfg.dtype``, except the SSM leaves the reference
    keeps in float32."""
    def leaves(tree, in_ssm=False):
        return {k: leaves(v, in_ssm or k == "ssm") if isinstance(v, dict)
                else (v, torch.float32 if in_ssm and k in ssm_lib.F32_LEAVES else cfg.dtype)
                for k, v in tree.items()}

    return leaves(_shapes(cfg))


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
                     cross: bool) -> Dict:
    """One stack of layers, leaves in the reference's ``_sublayer_init``
    order: attention, cross-attention, SSM, MLP."""
    d, f = cfg.d_model, cfg.d_ff
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
    if use_attn:  # the SSM block has no MLP
        layers["mlp"] = {"w_gate": (L, d, f), "w_up": (L, d, f), "w_down": (L, f, d)}
        layers["pre_mlp_norm"] = (L, d)
        if cfg.use_post_norms:
            layers["post_mlp_norm"] = (L, d)
    return layers


def _shapes(cfg: ModelConfig) -> Dict:
    d = cfg.d_model
    shapes = {"embed": (cfg.vocab, d),
              "layers": _sublayer_shapes(cfg, cfg.n_layers, use_attn=cfg.uses_attention,
                                         use_ssm=cfg.uses_ssm, cross=cfg.n_encoder_layers > 0)}
    if cfg.n_encoder_layers:
        shapes["enc_layers"] = _sublayer_shapes(cfg, cfg.n_encoder_layers, use_attn=True,
                                                use_ssm=False, cross=False)
        shapes["enc_final_norm"] = (d,)
    shapes["final_norm"] = (d,)
    if not cfg.tied_embeddings:
        shapes["lm_head"] = (cfg.vocab, d)
    return shapes


def _layer(layers: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked ``[L, ...]`` tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


class TransformerLM:
    """The LM of every ported family: ``init``, ``forward``, ``encode``,
    ``logits``, ``prefill`` and one-token ``decode_step`` with an explicit
    :class:`DecodeState`."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------------ init
    def _sublayer_init(self, L: int, generator: torch.Generator, dev: torch.device, *,
                       use_attn: bool, use_ssm: bool, cross: bool) -> Params:
        """One stack of layers, drawn in the leaf order of
        :func:`_sublayer_shapes`."""
        cfg = self.cfg
        dt = cfg.dtype
        d, f, hq, hkv, dh = cfg.d_model, cfg.d_ff, cfg.n_q_heads, cfg.n_kv_heads, cfg.head_dim

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
        if use_attn:
            layers["mlp"] = {
                "w_gate": dense_init(d, (L, d, f), dt, generator, dev),
                "w_up": dense_init(d, (L, d, f), dt, generator, dev),
                "w_down": dense_init(f, (L, f, d), dt, generator, dev),
            }
            layers["pre_mlp_norm"] = zeros(L, d)
            if cfg.use_post_norms:
                layers["post_mlp_norm"] = zeros(L, d)
        return layers

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Random weights from ``generator`` (which must live on ``device``):
        truncated-normal dense and embedding leaves, zero norms and biases,
        and the SSM's fixed ``A_log``, ``D`` and ``dt_bias``.  Leaves come in
        the reference's order."""
        cfg = self.cfg
        dev = resolve_device(device)
        d = cfg.d_model
        params: Params = {
            "embed": embed_init((cfg.vocab, d), cfg.dtype, generator, dev),
            "layers": self._sublayer_init(cfg.n_layers, generator, dev,
                                          use_attn=cfg.uses_attention, use_ssm=cfg.uses_ssm,
                                          cross=cfg.n_encoder_layers > 0),
        }
        if cfg.n_encoder_layers:
            params["enc_layers"] = self._sublayer_init(cfg.n_encoder_layers, generator, dev,
                                                       use_attn=True, use_ssm=False,
                                                       cross=False)
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
    def encode(self, params: Params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder over precomputed (stubbed conv) frame
        embeddings [B, T, D]: non-causal attention without RoPE and the
        gated MLP per layer, then ``enc_final_norm``."""
        cfg = self.cfg
        b, t = frames.shape[:2]
        positions = torch.arange(t, device=frames.device)[None, :].expand(b, t)
        x = frames.to(cfg.dtype)
        for i in range(cfg.n_encoder_layers):
            layer = _layer(params["enc_layers"], i)
            h = self._norm(x, layer["pre_attn_norm"])
            x = x + attn.attend_full(layer["attn"], h, positions, rope_theta=None,
                                     window=FULL_WINDOW, causal=False)
            x = self._ffn(layer, x)
        return self._norm(x, params["enc_final_norm"])

    def _cross_memory(self, params: Params, frontend_embeds: Optional[torch.Tensor]
                      ) -> Optional[Dict[str, torch.Tensor]]:
        """Each decoder layer's cross-attention K/V of the encoded frames,
        stacked [L, B, T, Hkv, Dh]; None without an encoder."""
        cfg = self.cfg
        if not cfg.n_encoder_layers:
            return None
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: an encoder-decoder model needs its frame "
                             "embeddings (frontend_embeds)")
        enc = self.encode(params, frontend_embeds)
        kv = [attn.project_memory_kv(_layer(params["layers"]["cross"], i), enc)
              for i in range(cfg.n_layers)]
        return {"k": torch.stack([k for k, _ in kv]), "v": torch.stack([v for _, v in kv])}

    def _cross(self, layer: Params, x: torch.Tensor, memory, i: int) -> torch.Tensor:
        """The cross-attention sub-block of decoder layer ``i`` (the
        identity without an encoder memory)."""
        if memory is None:
            return x
        h = self._norm(x, layer["pre_cross_norm"])
        return x + attn.attend_cross(layer["cross"], h, memory["k"][i], memory["v"][i])

    def _run(self, params: Params, tokens: torch.Tensor,
             frontend_embeds: Optional[torch.Tensor] = None,
             kv: Optional[Dict[str, torch.Tensor]] = None,
             ssm: Optional[Dict[str, torch.Tensor]] = None,
             memory: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """Full-sequence stack; writes each layer's K/V prefix into ``kv``
        and each SSM branch's final scan and conv states into ``ssm``.  A
        hybrid layer's attention and SSM branch read the same normed input
        and are mean-fused; ``memory`` is the encoder's cross K/V."""
        cfg = self.cfg
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
        x = self._embed(params, tokens, frontend_embeds)

        def ssm_branch(layer, h, i):
            out, st = ssm_lib.ssm_branch(layer["ssm"], h, cfg.ssm_dims, chunk=cfg.ssm_chunk)
            if ssm is not None:
                ssm["h"][i] = st["h"]
                ssm["conv"][i] = st["conv"]
            return out

        for i, window in enumerate(cfg.window_sizes()):
            layer = _layer(params["layers"], i)
            if "attn" not in layer:  # pure SSM block
                h = self._norm(x, layer["pre_ssm_norm"])
                x = self._ffn(layer, x + ssm_branch(layer, h, i))
                continue
            h = self._norm(x, layer["pre_attn_norm"])
            if kv is not None:
                _, k, v = attn.project_qkv(layer["attn"], h, positions,
                                           rope_theta=cfg.rope_theta)
                kv["k"][i, :, :s] = k.to(kv["k"].dtype)
                kv["v"][i, :, :s] = v.to(kv["v"].dtype)
            a = attn.attend_full(
                layer["attn"], h, positions, rope_theta=cfg.rope_theta,
                window=window, softcap_value=cfg.attn_softcap,
                query_scale=cfg.query_scale,
            )
            if "ssm" in layer:  # hybrid: parallel heads, mean-fused
                a = 0.5 * (a + ssm_branch(layer, h, i))
            x = self._cross(layer, x + self._attn_out(layer, a), memory, i)
            x = self._ffn(layer, x)
        return self._norm(x, params["final_norm"])

    def forward(self, params: Params, tokens: torch.Tensor, *,
                frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence forward: hidden states [B, S, D] after the final
        norm.  ``frontend_embeds``: patch embeddings (vision) or the
        encoder's frames (audio, required)."""
        return self._run(params, tokens, frontend_embeds,
                         memory=self._cross_memory(params, frontend_embeds))

    # ---------------------------------------------------------------- serving
    def init_decode_state(self, batch: int, max_len: int, device=None) -> DecodeState:
        cfg = self.cfg
        dev = resolve_device(device)
        kv = ssm = cross_kv = None

        def zeros_kv(seq):
            shape = (cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                    "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}

        if cfg.uses_attention:
            kv = zeros_kv(max_len)
        if cfg.uses_ssm:
            dims = cfg.ssm_dims
            ssm = {
                "h": torch.zeros((cfg.n_layers, batch, dims["n_heads"], dims["head_dim"],
                                  dims["d_state"]), dtype=torch.float32, device=dev),
                "conv": torch.zeros((cfg.n_layers, batch, dims["d_conv"] - 1,
                                     dims["conv_dim"]), dtype=cfg.dtype, device=dev),
            }
        if cfg.n_encoder_layers:
            cross_kv = zeros_kv(cfg.encoder_seq)
        return DecodeState(kv=kv, ssm=ssm, cross_kv=cross_kv,
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

        def ssm_step(layer, h, i):
            y, new = ssm_lib.ssm_step(
                layer["ssm"], h, {"h": state.ssm["h"][i], "conv": state.ssm["conv"][i]},
                cfg.ssm_dims)
            state.ssm["h"][i] = new["h"]
            state.ssm["conv"][i] = new["conv"]
            return y

        for i, window in enumerate(cfg.window_sizes()):
            layer = _layer(params["layers"], i)
            if "attn" not in layer:  # pure SSM block: the recurrence
                h = self._norm(x, layer["pre_ssm_norm"])
                x = self._ffn(layer, x + ssm_step(layer, h, i))
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
            x = self._ffn(layer, x)
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
        memory = self._cross_memory(params, frontend_embeds)
        cross_kv = state.cross_kv
        if memory is not None:
            if cross_kv is not None and cross_kv["k"].shape == memory["k"].shape:
                for name in cross_kv:
                    cross_kv[name].copy_(memory[name])
            else:  # frames of another length than the state's buffer
                cross_kv = memory
        x = self._run(params, tokens, frontend_embeds, state.kv, state.ssm, memory)
        logits = self._logits(params, x[:, -1:, :])[:, 0, :]
        length = torch.full((b,), s, dtype=torch.int32, device=tokens.device)
        return logits, dataclasses.replace(state, cross_kv=cross_kv, length=length)
