"""Mixture-of-Experts FFN with sort-based token dispatch (port of
``repro/models/moe.py``'s ``_moe_apply_local``: at one shard, and on a mesh
per batch shard, as the reference runs it under a mesh).

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

Beside it, the dropless layer of Nemotron-H (:func:`dropless_apply`), a
path of its own that the capacity path above (kept for parity with the
reference) does not share: a sigmoid router with a per-expert bias used
for the choice only, the chosen experts' unbiased scores normalised to sum
one and scaled, ungated relu² experts and a shared expert, and no request
dropped.  The layer is told which experts it holds (a run of the router's
outputs, all of them or one device's share under expert parallelism): it
routes over every expert, computes its own experts' part of the result for
the requests routed to them, each held expert over its own requests only,
and the shared expert; what other devices' experts would add is not its to
compute.  Its shapes are fixed by the token count and nothing in it waits
on the host, so a CUDA graph holds it.  In bf16 on a CUDA card the held
experts' products are the library's grouped products
(``torch._grouped_mm`` over each expert's run of the sorted requests);
elsewhere a plain version with the same result computes each held expert
over every request and keeps each request's own expert's row.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.autosharding import BATCH_AXES, from_local, to_local_as

from repro_torch.models.layers import Params, dense_init
from repro_torch.pytree import tree_map


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


#: Logical axes of the MoE leaves (after the stacked ``layers`` axis); the
#: shared expert's leaves are an MLP's.
MOE_AXES = {
    "router": ("embed", "experts_r"),
    "w_gate": ("experts", "embed", "ffn"),
    "w_up": ("experts", "embed", "ffn"),
    "w_down": ("experts", "ffn", "embed"),
}


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


def _expert_ffn(xe: torch.Tensor, params: Params, activation: str) -> torch.Tensor:
    """[E, C, D] -> [E, C, D]: each expert's gated FFN on its buffer."""
    g = torch.bmm(xe, params["w_gate"])
    u = torch.bmm(xe, params["w_up"])
    return torch.bmm(_act(g, activation) * u, params["w_down"])


def moe_apply(params: Params, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, activation: str = "silu"
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] -> (out [B, S, D], the Switch load-balance aux loss, a
    scalar f32).  All B x S tokens of the call share each expert's
    capacity."""
    if isinstance(x, DTensor):
        return _moe_apply_meshed(params, x, top_k=top_k, capacity_factor=capacity_factor,
                                 activation=activation)
    return _moe_apply(params, x, top_k=top_k, capacity_factor=capacity_factor,
                      activation=activation)


def _moe_apply_meshed(params: Params, x: DTensor, *, top_k: int, capacity_factor: float,
                      activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MoE layer on a mesh, as the reference's ``_moe_apply_local``
    runs under a mesh: the tokens are viewed as NS shards along the batch
    axes (NS = their size when it divides the batch, else 1), and each
    shard routes, ranks and dispatches its own tokens with a capacity of
    its own, on the devices that hold its rows; the load-balance statistics
    are averaged over the shards, so the aux loss is the whole call's.  The
    experts' FFNs run where the experts live (the expert weights' mesh
    dimensions, each device its experts' rows of the dispatch buffer; every
    other dimension of the weights gathered), and their outputs are gathered
    back before the combine.  The sort, rank and scatter have no DTensor
    strategy, so each device runs them on its plain local tokens."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rep = [Replicate()] * mesh.ndim
    ns = 1
    for i, name in enumerate(names):
        if name in BATCH_AXES:
            ns *= mesh.size(i)
    sharded = ns > 1 and x.shape[0] % ns == 0
    if not sharded:
        ns = 1
    rows = [Shard(0) if sharded and n in BATCH_AXES else Replicate() for n in names]
    # Local gradients of weights every device of a row shard uses are partial
    # sums over the row shards.
    partial = [Partial() if isinstance(r, Shard) else Replicate() for r in rows]
    ep = [Shard(0) if isinstance(p, Shard) and p.dim == 0 else Replicate()
          for p in params["w_gate"].placements]
    ep_grad = [p if isinstance(p, Shard) else g for p, g in zip(ep, partial)]
    local = {k: (tree_map(lambda t: to_local_as(t, mesh, rep, partial), v) if k == "shared"
                 else to_local_as(v, mesh, ep, ep_grad) if k.startswith("w_")
                 else to_local_as(v, mesh, rep, partial)) for k, v in params.items()}
    e = params["router"].shape[-1]
    expert_dims = [n for n, p in zip(names, ep) if isinstance(p, Shard)]
    sub = mesh[tuple(expert_dims)] if expert_dims else None

    def experts(xe, _params, act):
        # This shard's [E, C, D] -> its experts' rows -> every expert's.
        if sub is None:
            return _expert_ffn(xe, local, act)
        sub_rep, sub_ep = [Replicate()] * sub.ndim, [Shard(0)] * sub.ndim
        mine = to_local_as(from_local(xe, sub, sub_rep, xe.shape), sub, sub_ep)
        y = _expert_ffn(mine, local, act)
        return to_local_as(from_local(y, sub, sub_ep, (e, *y.shape[1:])), sub, sub_rep)

    def balance(me, assign):
        if ns > 1:  # the mean over the row shards
            me, assign = (to_local_as(from_local(v / ns, mesh, partial, v.shape), mesh, rep)
                          for v in (me, assign))
        return e * torch.sum(me * assign)

    out, aux = _moe_apply(local, to_local_as(x, mesh, rows, rows), top_k=top_k,
                          capacity_factor=capacity_factor, activation=activation,
                          experts=experts, balance=balance)
    return from_local(out, mesh, rows, x.shape), from_local(aux, mesh, rep, ())


def _balance(me: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    return me.shape[0] * torch.sum(me * assign)


def _moe_apply(params: Params, x: torch.Tensor, *, top_k: int, capacity_factor: float,
               activation: str, experts=_expert_ffn, balance=_balance
               ) -> Tuple[torch.Tensor, torch.Tensor]:
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
    aux = balance(me, assign_mean)

    cap = capacity(t, top_k, e, capacity_factor)
    sort_idx, _, slot, keep = dispatch(top_idx, e, cap)
    token_of = sort_idx // top_k
    gate_of = top_vals.reshape(-1)[sort_idx]

    # Dispatch into [E * C, D]; dropped requests land in the trash row.
    buf = xf.new_zeros(e * cap + 1, d)
    buf[torch.where(keep, slot, e * cap)] = xf[token_of]
    xe = buf[:e * cap].view(e, cap, d)

    y = experts(xe, params, activation).view(e * cap, d)

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


# ---------------------------------------------------------------------------
# The dropless layer (Nemotron-H)
# ---------------------------------------------------------------------------


def dropless_shapes(d_model: int, d_ff: int, held: int, router_experts: int,
                    stacked: int, shared_expert_ff: int = 0) -> Dict:
    """The dropless layer's leaves: the router over all ``router_experts``
    and its choice bias, the ``held`` experts' up and down projections (leaf
    names of their own, so that a rule by name cannot reach the shared
    expert's), and the shared expert's."""
    lead = (stacked,)
    shapes: Dict = {
        "router": lead + (d_model, router_experts),
        "router_bias": lead + (router_experts,),
        "w_experts_in": lead + (held, d_model, d_ff),
        "w_experts_out": lead + (held, d_ff, d_model),
    }
    if shared_expert_ff > 0:
        shapes["shared"] = {"w_up": lead + (d_model, shared_expert_ff),
                            "w_down": lead + (shared_expert_ff, d_model)}
    return shapes



#: Logical axes of the dropless layer's own leaves (beside the router's,
#: in :data:`MOE_AXES`; its shared expert's are an MLP's).
DROPLESS_AXES = {
    "router_bias": ("experts_r",),
    "w_experts_in": ("experts", "embed", "ffn"),
    "w_experts_out": ("experts", "ffn", "embed"),
}


def dropless_init(d_model: int, d_ff: int, held: int, router_experts: int,
                  dtype: torch.dtype, generator: torch.Generator, device: torch.device, *,
                  stacked: int, shared_expert_ff: int = 0) -> Params:
    """Truncated-normal products scaled by their input width and a zero
    choice bias, in the order of :func:`dropless_shapes`."""
    def init(name, shape):
        if isinstance(shape, dict):
            return {k: init(k, v) for k, v in shape.items()}
        if name == "router_bias":
            return torch.zeros(shape, dtype=dtype, device=device)
        return dense_init(shape[-2], shape, dtype, generator, device)

    return init(None, dropless_shapes(d_model, d_ff, held, router_experts, stacked,
                                      shared_expert_ff))


def route_sigmoid(params: Params, x: torch.Tensor, top_k: int, scaling: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, D] -> (weights [T, k] f32, experts [T, k]): the router product
    in f32, a sigmoid; the top k of score + bias, the lower expert first on
    ties; each chosen expert's unbiased score over their sum, times
    ``scaling``."""
    scores = torch.sigmoid(x.float() @ params["router"].float())
    choice = scores + params["router_bias"].float()
    idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :top_k]
    w = scores.gather(1, idx)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scaling, idx


def relu2(x: torch.Tensor) -> torch.Tensor:
    """relu(x)² in x's dtype (a bf16 square is taken in f32 and rounded once)."""
    return torch.relu(x).square()


def _grouped_experts_library(x: torch.Tensor, rows: torch.Tensor, gates: torch.Tensor,
                             dest: torch.Tensor, offsets: torch.Tensor, w_in: torch.Tensor,
                             w_out: torch.Tensor) -> torch.Tensor:
    """[R, D] f32: each sorted request ``r`` (token ``rows[r]``, flat choice
    ``dest[r]``) of held expert ``e`` (``offsets[e] <= r < offsets[e + 1]``)
    gives ``gates[r] * relu(x @ w_in[e])^2 @ w_out[e]`` at row ``dest[r]``,
    each expert's products only over its own requests: two grouped products
    of the library.  Rows of requests no held expert takes hold whatever the
    library left there; the caller masks them."""
    ends = offsets[1:].to(torch.int32)
    h = relu2(torch._grouped_mm(x[rows], w_in, offs=ends))
    y = torch._grouped_mm(h, w_out, offs=ends)
    out = torch.empty((rows.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    out[dest] = y * gates[:, None]  # f32 by promotion
    return out


def _grouped_experts_plain(x: torch.Tensor, rows: torch.Tensor, gates: torch.Tensor,
                           dest: torch.Tensor, offsets: torch.Tensor, w_in: torch.Tensor,
                           w_out: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`_grouped_experts_library`: each held
    expert over every sorted request, each request keeping its own expert's
    row (0 where no held expert takes it), with no host sync."""
    xs = x[rows]
    pos = torch.arange(rows.shape[0], device=x.device)
    expert = torch.searchsorted(offsets, pos, right=True) - 1  # held: past the last run
    y = torch.zeros((rows.shape[0], x.shape[1]), dtype=torch.float32, device=x.device)
    for e in range(w_in.shape[0]):
        ye = (relu2(xs @ w_in[e]) @ w_out[e]).float()
        y = torch.where((expert == e)[:, None], ye, y)
    out = torch.zeros_like(y)
    out[dest] = y * gates[:, None]
    return out


def dropless_apply(params: Params, x: torch.Tensor, *, top_k: int, scaling: float,
                   first: int = 0, counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, S, D] -> [B, S, D]: the shared expert's output plus the part of
    the routed experts' that the held experts ``first .. first + E - 1``
    give (E = the stack's experts), each routed request's output weighted by
    its gate and the k choices of a token summed in f32.  ``counts`` (an
    int64 [2] device tensor), if given, gains the requests routed to held
    experts and the held experts touched, on the device, with no host
    sync."""
    b, s, d = x.shape
    t = b * s
    xf = x.reshape(t, d)
    gates, idx = route_sigmoid(params, xf, top_k, scaling)
    w_in, w_out = params["w_experts_in"], params["w_experts_out"]
    held = w_in.shape[0]
    local = idx.reshape(-1) - first
    mine = (local >= 0) & (local < held)
    key = torch.where(mine, local, held)  # the requests of other experts sort last
    order = torch.argsort(key, stable=True)
    offsets = torch.searchsorted(key[order], torch.arange(held + 1, device=x.device))
    if counts is not None:
        counts[0] += offsets[-1]
        counts[1] += (offsets[1:] > offsets[:-1]).sum()
    args = (xf, order // top_k, gates.reshape(-1)[order], order, offsets, w_in, w_out)
    if xf.is_cuda and xf.dtype == torch.bfloat16:
        per_choice = _grouped_experts_library(*args)
    else:
        per_choice = _grouped_experts_plain(*args)
    routed = torch.where(mine[:, None], per_choice, 0.0).view(t, top_k, d).sum(dim=1)
    if "shared" in params:
        sh = params["shared"]
        routed = routed + (relu2(xf @ sh["w_up"]) @ sh["w_down"]).float()
    return routed.to(x.dtype).view(b, s, d)
