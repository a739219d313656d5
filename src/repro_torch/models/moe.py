"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro/models/moe.py``'s single-shard path, ``_moe_apply_local`` at one
shard).

Covers dbrx (16 experts, top-4) and llama4-maverick (128 experts, top-1,
plus a shared expert).  The dispatch is the reference's sort/gather/scatter
pipeline, step for step, since the result depends on it: requests beyond an
expert's capacity are dropped in the order of a stable sort of the flat
expert ids, so which tokens lose an expert is decided by the same rule.
Where a jax primitive has no exact torch counterpart:

* ``jax.lax.top_k`` puts the lower index first on ties; ``torch.topk``
  promises no order, so the top k come from a stable descending sort;
* ``.at[slot].set(mode="drop")`` becomes a buffer with one trash row that
  every dropped request writes to, cut off afterwards;
* the combine ``.at[token].add`` becomes a scatter of each contribution
  back to its flat position ``token * k + j`` (the inverse of the sort) and
  a sum over the k choices: deterministic, where ``index_add_`` on CUDA is
  atomic and its order varies.

The expert products are batched matrix products over ``[E, C, D] x
[E, D, F]``, as the reference computes them outside any Pallas kernel.
Expert weights are indexed, never copied: a layer's ``[E, D, F]`` stack is
a view of the stacked ``[L, E, D, F]`` leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init


def moe_shapes(d_model: int, d_ff: int, n_experts: int, stacked: Optional[int] = None,
               shared_expert_ff: int = 0) -> Dict:
    """The MoE leaves' shapes in the reference's order: the router, the
    stacked experts' gate, up and down projections, and the shared
    expert's where ``shared_expert_ff`` > 0."""
    lead = (stacked,) if stacked else ()
    shapes: Dict = {
        "router": lead + (d_model, n_experts),
        "w_gate": lead + (n_experts, d_model, d_ff),
        "w_up": lead + (n_experts, d_model, d_ff),
        "w_down": lead + (n_experts, d_ff, d_model),
    }
    if shared_expert_ff > 0:
        shapes["shared"] = {
            "w_gate": lead + (d_model, shared_expert_ff),
            "w_up": lead + (d_model, shared_expert_ff),
            "w_down": lead + (shared_expert_ff, d_model),
        }
    return shapes


def moe_init(d_model: int, d_ff: int, n_experts: int, dtype: torch.dtype,
             generator: torch.Generator, device: torch.device, *,
             stacked: Optional[int] = None, shared_expert_ff: int = 0) -> Params:
    """Truncated-normal leaves scaled by their input width, drawn in the
    order of :func:`moe_shapes`."""
    def init(shapes):
        # Each leaf's input width is its second-to-last dimension.
        return {k: init(v) if isinstance(v, dict)
                else dense_init(v[-2], v, dtype, generator, device)
                for k, v in shapes.items()}

    return init(moe_shapes(d_model, d_ff, n_experts, stacked, shared_expert_ff))


def capacity(tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """Requests an expert takes in one call: ``max(top_k, cf * T * k / E)``,
    truncated and capped at the call's T tokens."""
    return min(int(max(top_k, capacity_factor * tokens * top_k / n_experts)), tokens)


def route(params: Params, x: torch.Tensor, top_k: int
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [T, D] -> (gates [T, E] f32, top_vals [T, k], top_idx [T, k]): the
    router product in x's dtype, then f32 and a softmax; the top k with the
    lower expert first on ties, renormalised to sum to one."""
    gates = torch.softmax((x @ params["router"]).float(), dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    top_vals, top_idx = vals[:, :top_k], idx[:, :top_k]
    top_vals = top_vals / torch.clamp(top_vals.sum(dim=-1, keepdim=True), min=1e-9)
    return gates, top_vals, top_idx


def dispatch(top_idx: torch.Tensor, n_experts: int, cap: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flat requests ``t * k + j`` sorted stably by expert: (sort_idx,
    sorted expert ids, slot ``expert * cap + rank`` in the expert buffer,
    keep = rank < cap), each [T * k] in sorted order."""
    flat_e = top_idx.reshape(-1)
    sort_idx = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[sort_idx]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(n_experts, device=flat_e.device), side="left")
    rank = torch.arange(flat_e.numel(), device=flat_e.device) - group_start[sorted_e]
    return sort_idx, sorted_e, sorted_e * cap + rank, rank < cap


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    return F.silu(x) if activation == "silu" else F.gelu(x, approximate="tanh")


def moe_apply(params: Params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, activation: str = "silu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], the Switch load-balance aux loss, a
    scalar f32).  All B x S tokens of the call share each expert's
    capacity."""
    b, s, d = x.shape
    e = params["router"].shape[-1]
    t = b * s
    xf = x.reshape(t, d)
    gates, top_vals, top_idx = route(params, xf, top_k)

    # Load-balance auxiliary loss (Switch-style): E * sum_e f_e * p_e.
    me = gates.mean(dim=0)
    flat_idx = top_idx.reshape(-1)
    assign_mean = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, flat_idx, torch.full(flat_idx.shape, 1.0 / (t * top_k), device=x.device))
    aux = e * torch.sum(me * assign_mean)

    cap = capacity(t, top_k, e, capacity_factor)
    sort_idx, _, slot, keep = dispatch(top_idx, e, cap)
    token_of = sort_idx // top_k
    gate_of = top_vals.reshape(-1)[sort_idx]

    # Dispatch into [E * C, D]; dropped requests land in the trash row.
    buf = xf.new_zeros(e * cap + 1, d)
    buf[torch.where(keep, slot, e * cap)] = xf[token_of]
    xe = buf[:e * cap].view(e, cap, d)

    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    y = torch.bmm(_act(g, activation) * u, params["w_down"]).view(e * cap, d)

    # Combine: each request's gated output back at its flat position, then
    # the sum over the k choices of each token.
    contrib = y[torch.where(keep, slot, 0)] * (keep.to(x.dtype) * gate_of.to(x.dtype))[:, None]
    per_choice = torch.empty_like(contrib)
    per_choice[sort_idx] = contrib
    out = per_choice.view(t, top_k, d).sum(dim=1)

    if "shared" in params:
        sh = params["shared"]
        out = out + (_act(xf @ sh["w_gate"], activation) * (xf @ sh["w_up"])) @ sh["w_down"]
    return out.view(b, s, d), aux
