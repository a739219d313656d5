"""Shared layer primitives: norms, RoPE, the gated MLP, embeddings.

Port of ``repro/models/layers.py``.  Parameters are plain nested dicts of
tensors with the reference's leaf names, so the weights bridge
(:mod:`repro_torch.models.weights`) maps one tree onto the other.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.autosharding import from_local, to_local_as
from repro_torch.distributed.sharding import local_shape_and_offset

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# Initializers (explicit torch.Generator; variance-scaled truncated normal)
# ---------------------------------------------------------------------------

#: f32 elements drawn per chunk, so initialising a stacked full-width leaf
#: needs a bounded temporary beside the low-precision result.
_INIT_CHUNK = 1 << 26


def _normal(shape: Sequence[int], dtype: torch.dtype, scale: float,
            generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal(key, -2, 2)``), drawn in f32."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = out.view(-1)
    for start in range(0, flat.numel(), _INIT_CHUNK):
        n = min(_INIT_CHUNK, flat.numel() - start)
        tmp = torch.empty(n, dtype=torch.float32, device=device)
        torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=generator)
        flat[start:start + n] = tmp.mul_(scale)
    return out


def dense_init(in_dim: int, shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device) -> torch.Tensor:
    return _normal(shape, dtype, in_dim**-0.5, generator, device)


def embed_init(shape: Sequence[int], dtype: torch.dtype,
               generator: torch.Generator, device: torch.device) -> torch.Tensor:
    return _normal(shape, dtype, 1.0, generator, device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the zero-centred ``1 + scale`` weight (init 0 = identity)."""
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + scale.float())).to(dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the same zero-centred ``1 + scale`` weight,
    applied once, and an optional bias."""
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    xf = xf * (1.0 + scale.float())
    if bias is not None:
        xf = xf + bias.float()
    return xf.to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device = torch.device("cpu")) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., S, H, Dh]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs  # [..., S, Dh/2]
    sin = torch.sin(angles)[..., None, :]  # [..., S, 1, Dh/2]
    cos = torch.cos(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_apply(params: Params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """``(act(x W_gate) * x W_up) W_down``; GELU is the tanh approximation
    (the reference's ``jax.nn.gelu(approximate=True)``)."""
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if activation == "silu":
        act = F.silu(gate)
    elif activation == "gelu":
        act = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(activation)
    return (act * up) @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` [V, D] at ``tokens``.  A meshed table looks up on
    each device's shard: a mesh dimension that shards the vocabulary gives
    each device the rows it holds (zero elsewhere), summed across it; one
    that shards the batch of tokens keeps it; the table is gathered on any
    other (its FSDP shards)."""
    if not isinstance(table, DTensor):
        return F.embedding(tokens, table)
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = from_local(tokens, mesh, [Replicate()] * mesh.ndim, tokens.shape)
    tp, ip, op, tg = [], [], [], []
    for pt, pi in zip(table.placements, tokens.placements):
        if isinstance(pt, Shard) and pt.dim == 0:
            plan = (Shard(0), Replicate(), Partial(), Shard(0))
        elif isinstance(pi, Shard) and pi.dim == 0:
            plan = (Replicate(), Shard(0), Shard(0), Partial())
        else:
            plan = (Replicate(),) * 4
        for out, pl in zip((tp, ip, op, tg), plan):
            out.append(pl)
    local = to_local_as(table, mesh, tp, tg)
    _, offset = local_shape_and_offset(table.shape, mesh, tp)
    ids = to_local_as(tokens, mesh, ip) - offset[0]
    mine = (ids >= 0) & (ids < local.shape[0])
    rows = F.embedding(ids.clamp(0, local.shape[0] - 1), local)
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype))
    return from_local(rows, mesh, op, (*tokens.shape, table.shape[1]))


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits via the (possibly tied) embedding table: [..., D] -> [..., V]."""
    return x @ table.t()


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2 logit soft-capping: cap * tanh(x / cap)."""
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)

