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

A cache that is a DTensor is written on each device's shard
(:func:`write_cache_prefix`, :func:`write_cache_token`): the new rows
follow the cache's batch and head placements, and each device keeps the
part of them that falls in its range of the sequence.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.autosharding import from_local, pin_grad, to_local_as
from repro_torch.distributed.sharding import local_shape_and_offset
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


def _whole_heads(w: torch.Tensor, head_dim: int) -> torch.Tensor:
    """A meshed weight whose head dimension (``head_dim``) is sharded, the
    rules' fallback for a head count that a mesh dimension does not divide,
    gathered along it: the products split their columns into whole heads."""
    if isinstance(w, DTensor) and any(isinstance(p, Shard) and p.dim == head_dim
                                      for p in w.placements):
        return w.redistribute(w.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == head_dim else p
            for p in w.placements])
    return w


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, S, D] x [D, H, K] -> [B, S, H, K].  Meshed with a head count
    that a mesh dimension does not divide, the weight's head dimension and
    the product's flat H x K columns are gathered on it before the columns
    split into heads, and so is the gradient on the way back."""
    w2 = _whole_heads(w, w.ndim - 1).reshape(w.shape[0], -1)
    if not isinstance(w2, DTensor) or all(w.shape[1] % n == 0 for n in w2.device_mesh.shape):
        return (x @ w2).reshape(*x.shape[:-1], *w.shape[1:])
    mesh = w2.device_mesh
    y = x @ pin_grad(w2)
    y = y.redistribute(mesh, [Replicate() if isinstance(p, Shard) and p.dim == y.ndim - 1
                              else p for p in y.placements])
    return pin_grad(y.reshape(*x.shape[:-1], *w.shape[1:]))


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
        q = q + _whole_heads(params["bq"], 1)
        k = k + _whole_heads(params["bk"], 1)
        v = v + _whole_heads(params["bv"], 1)
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
    flat = out.reshape(*out.shape[:2], -1)
    wo2 = _whole_heads(wo, 1).reshape(-1, wo.shape[-1])
    if isinstance(flat, DTensor) and any(wo.shape[0] % n for n in flat.device_mesh.shape):
        # The gradients must split back into whole heads.
        flat, wo2 = pin_grad(flat), pin_grad(wo2)
    return flat @ wo2


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


def _on_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               *rows: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, *rows)`` -> [B, S, Hq, Dh] (q [B, S, Hq, Dh], k/v
    [B, T, Hkv, Dh], ``rows`` [B, ...] such as positions), meshed on each
    device's shards: batch rows and whole groups of
    query heads with their KV heads are independent, so a mesh dimension
    that shards either's batch shards all three, one that shards heads (and
    divides both head counts) shards all three's heads, and any other is
    gathered.  Local gradients are then exact on every shard."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, *rows)
    mesh = q.device_mesh
    hq, hkv = q.shape[2], k.shape[2]
    k_pl = k.placements if isinstance(k, DTensor) else [Replicate()] * mesh.ndim
    pl = []
    for i, (pq, pk) in enumerate(zip(q.placements, k_pl)):
        n = mesh.size(i)
        if Shard(0) in (pq, pk):
            pl.append(Shard(0))
        elif Shard(2) in (pq, pk) and hq % n == 0 and hkv % n == 0:
            pl.append(Shard(2))
        else:
            pl.append(Replicate())
    row_pl = [p if p == Shard(0) else Replicate() for p in pl]
    out = fn(*(to_local_as(t, mesh, pl, pl) for t in (q, k, v)),
             *(to_local_as(r, mesh, row_pl) for r in rows))
    return from_local(out, mesh, pl, (*q.shape[:3], v.shape[3]))


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

    def attend(q, k, v, pos):
        def core(qc, pc):
            return _attention_core(qc, k, v, pc, pos, window=window,
                                   softcap_value=softcap_value, causal=causal, dtype=x.dtype)

        return _blocked(core, q, q_block, pos)

    return _out_project(_on_shards(attend, q, k, v, positions), params["wo"])


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

    def attend(q, k, v):
        def core(qc):
            probs = torch.softmax(_grouped_scores(qc, k).float(), dim=-1).to(x.dtype)
            return _grouped_values(probs, v)

        return _blocked(core, q, q_block or Q_BLOCK)

    return _out_project(_on_shards(attend, q, memory_k, memory_v), params["wo"])


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


def _cache_local(cache: DTensor, new: torch.Tensor, new_dims: Tuple[Optional[int], ...]):
    """(this device's shard of ``cache`` [B, S, H, D], its offset along S,
    ``new``'s shard laid out like it): ``new_dims[d]`` is the dimension of
    ``new`` that cache dimension ``d`` shards, or None (S)."""
    mesh = cache.device_mesh
    placements = [Shard(new_dims[p.dim]) if isinstance(p, Shard) and new_dims[p.dim] is not None
                  else Replicate() for p in cache.placements]
    _, offset = local_shape_and_offset(cache.shape, mesh, cache.placements)
    return cache.to_local(), offset[1], to_local_as(new, mesh, placements)


def write_cache_prefix(cache: torch.Tensor, new: torch.Tensor) -> None:
    """cache[:, :s] = new ([B, s, H, D]), in place."""
    s = new.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, :s] = new.to(cache.dtype)
        return
    local, lo, new_l = _cache_local(cache, new, (0, None, 2, 3))
    a, b = max(lo, 0), min(lo + local.shape[1], s)
    if a < b:
        local[:, a - lo:b - lo] = new_l[:, a:b].to(local.dtype)


def write_cache_token(cache: torch.Tensor, idx: torch.Tensor, new: torch.Tensor) -> None:
    """cache[r, idx[r]] = new[r] for every row r (new [B, H, D]), in place."""
    if not isinstance(cache, DTensor):
        rows = torch.arange(cache.shape[0], device=cache.device)
        cache[rows, idx] = new.to(cache.dtype)
        return
    local, lo, new_l = _cache_local(cache, new, (0, None, 1, 2))
    idx_l = to_local_as(idx, cache.device_mesh, [
        Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
        for p in cache.placements])
    pos = idx_l - lo
    mine = (pos >= 0) & (pos < local.shape[1])
    pos = pos.clamp(0, local.shape[1] - 1)
    rows = torch.arange(local.shape[0], device=local.device)
    local[rows, pos] = torch.where(mine[:, None, None], new_l.to(local.dtype), local[rows, pos])


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
    s_max = cache["k"].shape[1]
    positions = length[:, None]  # [B,1]
    q, k_new, v_new = project_qkv(params, x, positions, rope_theta=rope_theta)
    # The reference's dynamic_update_slice clamps the start index so the
    # write stays inside the cache: a slot that idles past max_len keeps
    # overwriting the last row.
    idx = length.clamp(max=s_max - 1).long()
    write_cache_token(cache["k"], idx, k_new[:, 0])
    write_cache_token(cache["v"], idx, v_new[:, 0])
    dh = q.shape[-1]
    scale = query_scale if query_scale is not None else dh**-0.5
    # The kernel counts valid tokens (mask pos < lengths); the new token
    # sits at index ``length``, so it sees length + 1 of them.
    out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], length + 1,
                               window=window, softcap=softcap_value, scale=scale)
    return _out_project(out[:, None].to(x.dtype), params["wo"])
