"""Grouped-query attention with KV caches (port of ``repro/models/attention.py``):
GQA, optional QKV biases (qwen2.5) and per-head QK-norm (stablelm-2),
per-layer windows (gemma2's local layers, SWA), logit soft-capping
(gemma2) and whisper's non-causal encoder and cross-attention.

* ``attend_full`` — training/prefill attention over the whole sequence:
  grouped score and value products with a causal (or, for an encoder,
  symmetric) window mask and f32 softmax, on plain tensors; above
  ``Q_BLOCK`` query rows it takes the queries in blocks of ``Q_BLOCK``
  against all keys, as the reference does, each block checkpointed under
  autograd.
* ``attend_cached`` — one-token decode: writes the new K/V into the cache
  in place (the port's caches are mutable) and runs the flash-decode kernel
  through :func:`repro_torch.kernels.ops.decode_attention`, where the
  reference computed the same attention with einsums.
* ``attend_cross`` — attention against the encoder memory's K/V, unmasked
  and without RoPE: plain tensors for a prompt, the flash-decode kernel for
  one decode token (every memory row valid).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.models.layers import Params, apply_rope, dense_init, rmsnorm

NEG_INF = -2.3819763e38  # large negative for masking (bf16-safe)

#: Above this sequence length ``attend_full`` takes the queries in row
#: blocks of this size, so live scores are [B, H, Q_BLOCK, S] (exact).
Q_BLOCK = 1024


def attention_init(
    d_model: int,
    n_q: int,
    n_kv: int,
    head_dim: int,
    dtype: torch.dtype,
    generator: torch.Generator,
    device: torch.device,
    *,
    stacked: Optional[int] = None,
    qkv_bias: bool = False,
    qk_norm: bool = False,
) -> Params:
    lead = (stacked,) if stacked else ()
    params: Params = {
        "wq": dense_init(d_model, lead + (d_model, n_q, head_dim), dtype, generator, device),
        "wk": dense_init(d_model, lead + (d_model, n_kv, head_dim), dtype, generator, device),
        "wv": dense_init(d_model, lead + (d_model, n_kv, head_dim), dtype, generator, device),
        "wo": dense_init(n_q * head_dim, lead + (n_q, head_dim, d_model), dtype,
                         generator, device),
    }
    if qkv_bias:
        for name, heads in (("bq", n_q), ("bk", n_kv), ("bv", n_kv)):
            params[name] = torch.zeros(lead + (heads, head_dim), dtype=dtype, device=device)
    if qk_norm:
        for name in ("q_norm", "k_norm"):
            params[name] = torch.zeros(lead + (head_dim,), dtype=dtype, device=device)
    return params


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, D] x [D, H, K] -> [B, S, H, K]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def project_qkv(
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    rope_theta: Optional[float],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: [B, S, D] -> q [B,S,Hq,Dh], k/v [B,S,Hkv,Dh]: biases, then the
    per-head QK-norm (RMSNorm whatever the model's norm), then RoPE."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if "q_norm" in params:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def _grouped_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q [B,S,Hq,Dh] x k [B,T,Hkv,Dh] -> scores [B,Hq,S,T] with GQA groups."""
    b, s, hq, dh = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, dh).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,S,Dh]
    kt = k.permute(0, 2, 3, 1)[:, :, None]  # [B,Hkv,1,Dh,T]
    return (qg @ kt).reshape(b, hq, s, k.shape[1])


def _grouped_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs [B,Hq,S,T] x v [B,T,Hkv,Dh] -> [B,S,Hq,Dh]."""
    b, hq, s, t = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, hkv, hq // hkv, s, t)
    vv = v.permute(0, 2, 1, 3)[:, :, None]  # [B,Hkv,1,T,Dh]
    out = pg @ vv  # [B,Hkv,G,S,Dh]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, v.shape[3])


def _out_project(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """[B, S, Hq, Dh] x [Hq, Dh, D] -> [B, S, D]."""
    return out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def _attention_core(
    q: torch.Tensor,  # [B,Sq,Hq,Dh] (pre-scaled)
    k: torch.Tensor,  # [B,T,Hkv,Dh]
    v: torch.Tensor,  # [B,T,Hkv,Dh]
    qpos: torch.Tensor,  # [B,Sq]
    tpos: torch.Tensor,  # [B,T]
    *,
    window: int,
    softcap_value: Optional[float],
    causal: bool,
    dtype: torch.dtype,
) -> torch.Tensor:
    """Windowed attention of a block of queries against all keys: key t
    attends to query s iff 0 <= s - t < window (causal), else iff
    |s - t| < window.  Returns [B,Sq,Hq,Dh]."""
    scores = _grouped_scores(q, k)  # [B,Hq,Sq,T]
    if softcap_value is not None:
        scores = softcap_value * torch.tanh(scores / softcap_value)
    sp = qpos[:, :, None]
    tp = tpos[:, None, :]
    if causal:
        mask = (tp <= sp) & (sp - tp < window)
    else:
        mask = (sp - tp).abs() < window
    scores = torch.where(mask[:, None], scores, torch.tensor(NEG_INF, dtype=scores.dtype,
                                                             device=scores.device))
    probs = torch.softmax(scores.float(), dim=-1).to(dtype)
    return _grouped_values(probs, v)


def _blocked(core, q: torch.Tensor, q_block: int, *args) -> torch.Tensor:
    """``core(q rows, *row args)`` in row blocks of ``q_block`` when S >
    ``q_block`` and ``q_block`` divides S (so the [B, H, S, T] score tensor
    never exists), else in one shot; ``args`` are [B, S] position rows.
    Under autograd each block is checkpointed, as the reference's
    ``jax.checkpoint`` per block: the backward recomputes one block's
    scores at a time instead of keeping every block's."""
    s = q.shape[1]
    if s <= q_block or s % q_block != 0:
        return core(q, *args)
    if torch.is_grad_enabled():
        run = functools.partial(checkpoint, core, use_reentrant=False)
    else:
        run = core
    return torch.cat([run(q[:, i:i + q_block], *(a[:, i:i + q_block] for a in args))
                      for i in range(0, s, q_block)], dim=1)


def attend_full(
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    rope_theta: Optional[float],
    window: int,
    softcap_value: Optional[float] = None,
    causal: bool = True,
    query_scale: Optional[float] = None,
    q_block: int = Q_BLOCK,
) -> torch.Tensor:
    """Full-sequence attention (training / prefill): key t attends to query
    s iff 0 <= s - t < window (causal), or iff |s - t| < window (the
    encoder's ``causal=False``).  Queries go in blocks of ``q_block`` rows
    when S > ``q_block`` and ``q_block`` divides S; otherwise in one shot."""
    dh = params["wq"].shape[-1]
    q, k, v = project_qkv(params, x, positions, rope_theta=rope_theta)
    scale = query_scale if query_scale is not None else dh**-0.5
    q = q * scale

    def core(qc, pc):
        return _attention_core(qc, k, v, pc, positions, window=window,
                               softcap_value=softcap_value, causal=causal, dtype=x.dtype)

    return _out_project(_blocked(core, q, q_block, positions), params["wo"])


def attend_cross(
    params: Params,
    x: torch.Tensor,
    memory_k: torch.Tensor,  # [B, T, Hkv, Dh]
    memory_v: torch.Tensor,  # [B, T, Hkv, Dh]
    *,
    q_block: int = 0,
) -> torch.Tensor:
    """Cross-attention against precomputed encoder K/V (whisper's decoder):
    no RoPE, no mask, scale ``Dh**-0.5``.  One query row (decode) runs the
    flash-decode kernel with every one of the T memory rows valid; a
    prompt takes the plain grouped products, in blocks of ``q_block`` (0:
    ``Q_BLOCK``) rows as :func:`attend_full` does.  Returns [B, S, D]."""
    q = _project(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    b, s, _, dh = q.shape
    if s == 1:
        lengths = torch.full((b,), memory_k.shape[1], dtype=torch.int32, device=x.device)
        out = ops.decode_attention(q[:, 0], memory_k, memory_v, lengths, scale=dh**-0.5)
        return _out_project(out[:, None].to(x.dtype), params["wo"])
    q = q * dh**-0.5

    def core(qc):
        probs = torch.softmax(_grouped_scores(qc, memory_k).float(), dim=-1).to(x.dtype)
        return _grouped_values(probs, memory_v)

    return _out_project(_blocked(core, q, q_block or Q_BLOCK), params["wo"])


def project_memory_kv(params: Params, memory: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder memory [B, T, D] -> its K and V [B, T, Hkv, Dh] under one
    layer's cross-attention weights (and biases, where it has them)."""
    k = _project(memory, params["wk"])
    v = _project(memory, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    return k, v


def init_kv_cache(
    batch: int, max_len: int, n_kv: int, head_dim: int, dtype: torch.dtype,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attend_cached(
    params: Params,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    length: torch.Tensor,
    *,
    rope_theta: Optional[float],
    window: int,
    softcap_value: Optional[float] = None,
    query_scale: Optional[float] = None,
) -> torch.Tensor:
    """One-token decode.  x: [B, 1, D]; cache k/v: [B, S_max, Hkv, Dh],
    updated in place; ``length`` [B] = tokens already in the cache (the new
    token lands at index ``length``).  Returns [B, 1, D]."""
    b = x.shape[0]
    s_max = cache["k"].shape[1]
    positions = length[:, None]  # [B,1]
    q, k_new, v_new = project_qkv(params, x, positions, rope_theta=rope_theta)
    # The reference's dynamic_update_slice clamps the start index so the
    # write stays inside the cache: a slot that idles past max_len keeps
    # overwriting the last row.
    idx = length.clamp(max=s_max - 1).long()
    rows = torch.arange(b, device=x.device)
    cache["k"][rows, idx] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][rows, idx] = v_new[:, 0].to(cache["v"].dtype)
    dh = q.shape[-1]
    scale = query_scale if query_scale is not None else dh**-0.5
    # The kernel counts valid tokens (mask pos < lengths); the new token
    # sits at index ``length``, so it sees length + 1 of them.
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], length + 1,
                               window=window, softcap=softcap_value, scale=scale)
    return _out_project(out[:, None].to(x.dtype), params["wo"])
