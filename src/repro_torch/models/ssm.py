"""Mamba2 state-space duality (SSD) blocks — port of ``repro/models/ssm.py``.

The chunked SSD algorithm splits the sequence into chunks of Q tokens.
Within a chunk the recurrence becomes an attention-like quadratic product;
across chunks a [H, P, N] f32 state is carried.  :func:`ssd_chunked` is the
plain version, with the reference's bf16 casts; :func:`ssd` is what the
model calls: on a CUDA tensor it launches the hand-written scan kernel
(:func:`repro_torch.kernels.ops.ssd_scan`), on a CPU tensor it runs
:func:`ssd_chunked`.  Under autograd it goes through :class:`SSDScan`,
whose forward is that same dispatch and whose backward differentiates
:func:`ssd_chunked` (the function the reference differentiates) on the
saved inputs; the kernel's own outputs carry no gradient.  Decode is the
single-step recurrence (:func:`ssm_step`), which updates the f32 state in
place: on a CUDA tensor in one fused kernel
(:func:`repro_torch.kernels.ops.ssm_step`), on a CPU tensor by the plain
version, the reference's arithmetic.

Parameters keep the reference's leaf names; ``A_log``, ``D`` and
``dt_bias`` are float32 whatever the model's dtype.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.autosharding import constrain, from_local, to_local_as
from repro_torch.kernels import ops
from repro_torch.models.layers import Params, dense_init, rmsnorm

#: Leaves kept in float32 whatever the model's dtype (``ssm.py:54-58`` of
#: the reference).
F32_LEAVES = ("A_log", "D", "dt_bias")


def ssm_dims(d_model: int, *, expand: int = 2, head_dim: int = 64,
             d_state: int = 128, n_groups: int = 1, d_conv: int = 4,
             n_heads: int = 0) -> Dict[str, int]:
    """The SSM block's sizes.  d_inner is ``n_heads x head_dim`` where the
    head count is given (Nemotron-H: 64 heads of 64 beside a d_model of
    2,688), else ``expand x d_model``."""
    d_inner = n_heads * head_dim if n_heads else expand * d_model
    n_heads = d_inner // head_dim
    conv_dim = d_inner + 2 * n_groups * d_state
    return dict(
        d_inner=d_inner,
        n_heads=n_heads,
        head_dim=head_dim,
        d_state=d_state,
        n_groups=n_groups,
        d_conv=d_conv,
        conv_dim=conv_dim,
        d_in_proj=2 * d_inner + 2 * n_groups * d_state + n_heads,
    )


def ssm_shapes(d_model: int, dims: Dict[str, int], stacked: int) -> Dict:
    """Leaf shapes of one stacked SSM parameter tree."""
    lead = (stacked,)
    h, di = dims["n_heads"], dims["d_inner"]
    return {
        "in_proj": lead + (d_model, dims["d_in_proj"]),
        "conv_w": lead + (dims["d_conv"], dims["conv_dim"]),
        "conv_b": lead + (dims["conv_dim"],),
        "A_log": lead + (h,),
        "D": lead + (h,),
        "dt_bias": lead + (h,),
        "norm": lead + (di,),
        "out_proj": lead + (di, d_model),
    }


#: Logical axes of the SSM leaves (after the stacked ``layers`` axis).
SSM_AXES = {
    "in_proj": ("embed", "ssm_proj"),
    "conv_w": ("conv", "ssm_conv_dim"),
    "conv_b": ("ssm_conv_dim",),
    "A_log": ("ssm_heads",),
    "D": ("ssm_heads",),
    "dt_bias": ("ssm_heads",),
    "norm": ("ssm_inner",),
    "out_proj": ("ssm_inner", "embed"),
}


def ssm_init(d_model: int, dims: Dict[str, int], dtype: torch.dtype,
             generator: torch.Generator, device: torch.device, *,
             stacked: int) -> Params:
    """Random weights as the reference draws them: truncated-normal
    projections and conv, zero bias and norm, ``A_log = log(1..16)``,
    ``D = 1``, ``dt_bias = softplus^-1(0.01)``."""
    shapes = ssm_shapes(d_model, dims, stacked)
    h = dims["n_heads"]
    f32 = dict(dtype=torch.float32, device=device)
    lead = torch.ones((stacked, 1), **f32)
    return {
        "in_proj": dense_init(d_model, shapes["in_proj"], dtype, generator, device),
        "conv_w": dense_init(dims["d_conv"], shapes["conv_w"], dtype, generator, device),
        "conv_b": torch.zeros(shapes["conv_b"], dtype=dtype, device=device),
        "A_log": lead * torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "D": torch.ones(shapes["D"], **f32),
        "dt_bias": lead * torch.log(torch.expm1(torch.full((h,), 0.01, **f32))),
        "norm": torch.zeros(shapes["norm"], dtype=dtype, device=device),
        "out_proj": dense_init(dims["d_inner"], shapes["out_proj"], dtype, generator,
                               device),
    }


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                           ) -> torch.Tensor:
    """x: [B, S, C]; w: [K, C] depthwise causal conv along S (no flip, as
    the reference's ``conv_general_dilated``).  The result is laid out
    [B, S, C] in memory, so the scan kernel reads its x, B and C views with
    contiguous rows.  Meshed, it runs on each device's shards: channels
    where the weight shards them, batch rows where x shards them (the
    weight's and bias's local gradients are then partial sums)."""
    if isinstance(x, DTensor):
        mesh = x.device_mesh
        xp, wp, bp, wg = [], [], [], []
        for px, pw in zip(x.placements, w.placements):
            if isinstance(pw, Shard) and pw.dim == 1:
                plan = (Shard(2), Shard(1), Shard(0), Shard(1))
            elif isinstance(px, Shard) and px.dim == 0:
                plan = (Shard(0), Replicate(), Replicate(), Partial())
            else:
                plan = (Replicate(),) * 4
            for out, pl in zip((xp, wp, bp, wg), plan):
                out.append(pl)
        bg = [Shard(0) if isinstance(g, Shard) else g for g in wg]
        out = _causal_depthwise_conv(to_local_as(x, mesh, xp, xp),
                                     to_local_as(w, mesh, wp, wg),
                                     to_local_as(b, mesh, bp, bg))
        return from_local(out, mesh, xp, x.shape)
    k, c = w.shape
    pad = F.pad(x.transpose(1, 2), (k - 1, 0))  # [B, C, S + K - 1]
    out = F.conv1d(pad, w.t()[:, None, :], groups=c)  # [B, C, S]
    return out.transpose(1, 2).contiguous() + b


def _split_proj(params: Params, x: torch.Tensor, dims: Dict[str, int]):
    di, gn = dims["d_inner"], dims["n_groups"] * dims["d_state"]
    zxbcdt = x @ params["in_proj"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]  # [B, S, H]
    return z, xbc, dt


def _conv_views(xbc_conv: torch.Tensor, dims: Dict[str, int]):
    """Views of the conv output as x [B,S,H,P], B and C [B,S,G,N] (no copy:
    the kernels read them by strides)."""
    di, g, n = dims["d_inner"], dims["n_groups"], dims["d_state"]
    xs = xbc_conv[..., :di].unflatten(-1, (dims["n_heads"], dims["head_dim"]))
    bmat = xbc_conv[..., di: di + g * n].unflatten(-1, (g, n))
    cmat = xbc_conv[..., di + g * n:].unflatten(-1, (g, n))
    return xs, bmat, cmat


def _prep_inputs(params: Params, xbc_conv: torch.Tensor, dt: torch.Tensor,
                 dims: Dict[str, int]):
    """:func:`_conv_views`, and the f32 dt and a."""
    xs, bmat, cmat = _conv_views(xbc_conv, dims)
    dt = F.softplus(dt.float() + params["dt_bias"])  # [B, S, H]
    a = -torch.exp(params["A_log"])  # [H]
    return xs, bmat, cmat, dt, a


def ssd_chunked(
    xs: torch.Tensor,  # [B, S, H, P]
    bmat: torch.Tensor,  # [B, S, G, N]
    cmat: torch.Tensor,  # [B, S, G, N]
    dt: torch.Tensor,  # [B, S, H] (post-softplus, f32)
    a: torch.Tensor,  # [H] (negative, f32)
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,  # [B, H, P, N]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, a loop over chunks carrying the [B, H, P, N] f32
    state; the reference's casts of ``w``, ``dx`` and the inter-chunk term
    to the inputs' dtype are kept.  Returns (y [B, S, H, P], final state)."""
    b, s, h, p = xs.shape
    g, n = bmat.shape[2], bmat.shape[3]
    chunk = min(chunk, s)
    s_orig = s
    if s % chunk != 0:
        # Zero-pad to a chunk multiple: dt = 0 makes padded steps exact
        # no-ops (decay exp(0) = 1, zero state contribution).
        pad = chunk - s % chunk
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        cmat = F.pad(cmat, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        s = s + pad
    nc, q = s // chunk, chunk
    rep = h // g  # heads per group
    dtype = xs.dtype
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xs.device))

    xs_c = xs.reshape(b, nc, q, h, p)
    b_c = bmat.reshape(b, nc, q, g, n)
    c_c = cmat.reshape(b, nc, q, g, n)
    dt_c = dt.reshape(b, nc, q, h)

    carry = (initial_state.float() if initial_state is not None
             else torch.zeros((b, h, p, n), dtype=torch.float32, device=xs.device))
    ys = []
    for c in range(nc):
        x_q, b_q, c_q, dt_q = xs_c[:, c], b_c[:, c], c_c[:, c], dt_c[:, c]
        da = dt_q * a  # [B, Q, H]
        cum = torch.cumsum(da, dim=1)  # [B, Q, H]

        # Intra-chunk quadratic term.
        rel = cum[:, :, None, :] - cum[:, None, :, :]  # [B, Q, Q, H]
        decay = torch.where(mask[None, :, :, None], torch.exp(rel), 0.0)
        scores = torch.einsum("bqgn,bkgn->bqkg", c_q, b_q)  # [B, Q, Q, G]
        scores = scores.repeat_interleave(rep, dim=-1)  # [B, Q, Q, H]
        w = (scores.float() * decay).to(dtype)
        dx = (dt_q[..., None] * x_q.float()).to(dtype)
        y_q = torch.einsum("bqkh,bkhp->bqhp", w, dx)

        # Inter-chunk contribution from the carried state.
        c_heads = c_q.repeat_interleave(rep, dim=2).float()  # [B, Q, H, N]
        y_q = y_q + torch.einsum("bqhn,bhpn->bqhp", torch.exp(cum)[..., None] * c_heads,
                                 carry).to(dtype)

        # State update: new = decay_total * old + sum_q tail[q] dt[q] B[q] x[q]^T.
        tail = torch.exp(cum[:, -1:, :] - cum)  # [B, Q, H]
        b_heads = b_q.repeat_interleave(rep, dim=2).float()  # [B, Q, H, N]
        weighted_x = (tail * dt_q)[..., None] * x_q.float()  # [B, Q, H, P]
        s_chunk = torch.einsum("bqhp,bqhn->bhpn", weighted_x, b_heads)
        total_decay = torch.exp(da.sum(dim=1))  # [B, H]
        carry = carry * total_decay[:, :, None, None] + s_chunk
        ys.append(y_q)
    y = torch.stack(ys, dim=1).reshape(b, s, h, p)
    return y[:, :s_orig], carry


def _scan(xs: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, dt: torch.Tensor,
          a: torch.Tensor, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan kernel on CUDA tensors (B and C of one group as [B, S, N],
    of several as [B, S, G, N]), :func:`ssd_chunked` on CPU tensors."""
    if xs.device.type == "cuda":
        if bmat.shape[2] == 1:
            bmat, cmat = bmat[:, :, 0], cmat[:, :, 0]
        return ops.ssd_scan(xs, dt, bmat, cmat, a, chunk=chunk)
    return ssd_chunked(xs, bmat, cmat, dt, a, chunk=chunk)


class SSDScan(torch.autograd.Function):
    """The scan under autograd.  Forward: :func:`_scan` (the kernel on CUDA
    tensors).  Backward: :func:`ssd_chunked` recomputed on the saved inputs
    under grad and differentiated, so each input's gradient is the plain
    scan's, whichever path made the forward."""

    @staticmethod
    def forward(ctx, xs, bmat, cmat, dt, a, chunk):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xs, bmat, cmat, dt, a)
        return _scan(xs, bmat, cmat, dt, a, chunk)

    @staticmethod
    def backward(ctx, grad_y, grad_state):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, state = ssd_chunked(*inputs, chunk=ctx.chunk)
        pairs = [(out, g) for out, g in ((y, grad_y), (state, grad_state)) if g is not None]
        wrt = [t for t in inputs if t.requires_grad]
        got = iter(torch.autograd.grad([out for out, _ in pairs], wrt,
                                       [g for _, g in pairs], allow_unused=True))
        return (*(next(got) if t.requires_grad else None for t in inputs), None)


def ssd(xs: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, dt: torch.Tensor,
        a: torch.Tensor, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's scan: the scan kernel on CUDA tensors, :func:`ssd_chunked`
    on CPU tensors, through :class:`SSDScan` when an input requires grad.
    Each head reads the B and C of its group."""
    if isinstance(xs, DTensor):
        return _ssd_local(xs, bmat, cmat, dt, a, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xs, bmat, cmat, dt, a)):
        return SSDScan.apply(xs, bmat, cmat, dt, a, chunk)
    return _scan(xs, bmat, cmat, dt, a, chunk)


def _ssd_local(xs: DTensor, bmat, cmat, dt, a, chunk: int):
    """The scan of DTensors on each device's shards (K4's placements,
    :func:`repro_torch.kernels.ops.ssd_scan_placements`), differentiable:
    on a mesh dimension that shards the heads, B's and C's local gradients
    are partial sums over the local heads; on one that shards the batch,
    ``a``'s are partial sums over the local rows."""
    mesh = xs.device_mesh
    xp, dtp, bcp, ap, sp = ops.ssd_scan_placements(xs)
    heads = [isinstance(p, Shard) and p.dim == 2 for p in xp]
    if any(heads) and bmat.shape[2] > 1:
        raise NotImplementedError("a scan whose heads are sharded takes one group of B and C")
    rows = [isinstance(p, Shard) and p.dim == 0 for p in xp]
    bc_grad = [Partial() if h else p for h, p in zip(heads, bcp)]
    a_grad = [Partial() if r else p for r, p in zip(rows, ap)]
    y, state = ssd(to_local_as(xs, mesh, xp, xp), to_local_as(bmat, mesh, bcp, bc_grad),
                   to_local_as(cmat, mesh, bcp, bc_grad), to_local_as(dt, mesh, dtp, dtp),
                   to_local_as(a, mesh, ap, a_grad), chunk=chunk)
    b, _, h, p = xs.shape
    return (from_local(y, mesh, xp, xs.shape),
            from_local(state, mesh, sp, (b, h, p, bmat.shape[-1])))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor, groups: int,
                eps: float) -> torch.Tensor:
    """The gated RMSNorm before ``out_proj``, ``rmsnorm(y * silu(z))`` over
    each of ``groups`` equal runs of channels (Mamba-2's ``RMSNormGated``
    with ``group_size = d_inner / n_groups``); one group is the whole row."""
    g = y * F.silu(z)
    if groups == 1:
        return rmsnorm(g, scale, eps)
    shape = g.shape
    return rmsnorm(g.unflatten(-1, (groups, -1)), scale.unflatten(-1, (groups, -1)),
                   eps).reshape(shape)


def ssm_branch(params: Params, x: torch.Tensor, dims: Dict[str, int], *, chunk: int,
               eps: float = 1e-6) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence SSM block: (out [B, S, D], {"h": final scan state
    [B, H, P, N] f32, "conv": the last K-1 rows of the pre-conv projection
    [B, K-1, conv_dim]}) — the reference's ``_ssm_forward_branch``."""
    b, s = x.shape[0], x.shape[1]
    z, xbc, dt_raw = _split_proj(params, x, dims)
    xbc_c = F.silu(_causal_depthwise_conv(xbc, params["conv_w"], params["conv_b"]))
    xs, bmat, cmat, dt, a = _prep_inputs(params, xbc_c, dt_raw, dims)
    # Meshed, the scan's heads shard as their weights do (the slices above
    # come out gathered), so no device scans heads it does not hold.
    xs = constrain(xs, ("batch", "seq", "ssm_heads", "ssm_head_dim"))
    dt = constrain(dt, ("batch", "seq", "ssm_heads"))
    y, hfinal = ssd(xs, bmat, cmat, dt, a, chunk=chunk)
    y = y.reshape(b, s, dims["d_inner"])
    y = y + (params["D"].repeat_interleave(dims["head_dim"])
             * xs.reshape(b, s, -1).float()).to(x.dtype)
    y = _gated_norm(y, z, params["norm"], dims["n_groups"], eps)
    out = y @ params["out_proj"]
    return out, {"h": hfinal, "conv": xbc[:, -(dims["d_conv"] - 1):, :]}


def ssm_forward(params: Params, x: torch.Tensor, dims: Dict[str, int], *,
                chunk: int = 128) -> torch.Tensor:
    """[B, S, D] -> [B, S, D]."""
    return ssm_branch(params, x, dims, chunk=chunk)[0]


# ---------------------------------------------------------------------------
# Decode path (recurrent single step)
# ---------------------------------------------------------------------------


def init_ssm_state(batch: int, dims: Dict[str, int], dtype: torch.dtype = torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    return {
        "h": torch.zeros((batch, dims["n_heads"], dims["head_dim"], dims["d_state"]),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, dims["d_conv"] - 1, dims["conv_dim"]), dtype=dtype,
                            device=device),
    }


def ssm_step(
    params: Params,
    x: torch.Tensor,  # [B, 1, D]
    state: Dict[str, torch.Tensor],
    dims: Dict[str, int],
    *,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token: (out [B, 1, D], new state).  The recurrent state
    ``state["h"]`` is updated in place (:func:`repro_torch.kernels.ops.ssm_step`:
    the fused kernel on the card) and is the new state's ``"h"``; the conv
    window is returned new, for the caller to store."""
    b = x.shape[0]
    z, xbc, dt_raw = _split_proj(params, x, dims)  # [B, 1, *]
    # Conv over the rolling window [conv_state | new].
    window = torch.cat([state["conv"], xbc], dim=1)  # [B, K, conv]
    conv_out = torch.einsum("bkc,kc->bc", window, params["conv_w"]) + params["conv_b"]
    conv_out = F.silu(conv_out)[:, None, :]  # [B, 1, conv]
    xs, bmat, cmat = _conv_views(conv_out, dims)
    y = ops.ssm_step(state["h"], xs[:, 0], dt_raw[:, 0], bmat[:, 0], cmat[:, 0],
                     params["dt_bias"], params["A_log"], params["D"])  # [B, H, P]
    y = y.reshape(b, 1, dims["d_inner"]).to(x.dtype)
    y = _gated_norm(y, z, params["norm"], dims["n_groups"], eps)
    out = y @ params["out_proj"]
    return out, {"h": state["h"], "conv": window[:, 1:, :]}
