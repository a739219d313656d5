"""Model-layout wrappers of the port's model kernels (port of
``repro/kernels/ops.py``): flash-decode GQA, the SSD chunked scan and the
SSM decode step.

Each kernel is a torch operator (``torch.ops.repro_torch.decode_attention``
and ``torch.ops.repro_torch.ssd_scan``), registered through
``torch.library.Library`` with three implementations: on a CUDA tensor the
hand-written kernel, on a CPU tensor the plain version (there is no
fallback from one to the other), and a fake rule that gives the outputs'
shapes and dtypes, so fake and meta tensors (the dry run) reach the
operators by dispatch and never through a raw pointer.  A plain CUDA
tensor, whose pointer is its own, goes to the launcher directly: the
operator's dispatch adds about 20 us a call on the host, which the
decode step, bound by its host, would pay once a layer.

A DTensor never reaches an operator: :func:`decode_attention` and the
model's scan (``models/ssm.py:_ssd_local``, differentiable) redistribute
its inputs to placements on which the kernel computes its own function on
each device's shards, call the kernel on the local tensors and wrap the
result (:func:`decode_attention_placements`, :func:`ssd_scan_placements`):

* K1: batch shards stay; query and KV heads shard together, Hq / n query
  heads over the Hkv / n KV heads they group on; a cache sharded along its
  sequence is gathered along it first (a cross-device combine of the
  kernel's partial softmax statistics is not written yet), as is anything
  else.
* K4: batch shards stay; SSM heads shard with their dt and ``a``, B and C
  replicated beside them; anything else is replicated.
* The SSM decode step (:func:`ssm_step_placements`): the placements are
  the state's own, so its local shard is updated in place; batch shards
  stay, heads shard with dt_raw, dt_bias, A_log and D (B and C replicated
  at one group, sharded by group at several), a shard of the head dim
  takes x's and y's alike.

The SSM decode step (:func:`ssm_step`, which the reference has no kernel
for) registers no operator: a plain CUDA tensor goes to its launcher, and
a CPU, fake or meta tensor runs its plain version,
:func:`repro_torch.kernels.ssm_step.ssm_step_ref`, whose ops dispatch as
any other.

The reference's padding of G to 8 existed for the TPU's sublane tiling and
is dropped: the kernel takes any G.  The reference's halving of the scan's
chunk until it divides S is dropped too (a prime prompt length would fall
to chunk 1): S is padded to a chunk multiple with dt = 0 instead, as
``models/ssm.py::ssd_chunked`` does.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.distributed.autosharding import from_local, to_local_as
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.ref import decode_attention_ref, ssd_scan_chunked_ref
from repro_torch.kernels.ssd_scan import ssd_scan_cuda
from repro_torch.kernels.ssm_step import ssm_step_cuda, ssm_step_ref

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor lengths, int window, "
            "float? softcap, float? scale) -> Tensor")
_LIB.define("ssd_scan(Tensor x, Tensor dt, Tensor b, Tensor c, Tensor a, int chunk) "
            "-> (Tensor, Tensor)")


def _decode_attention_cuda_impl(q, k, v, lengths, window, softcap, scale):
    return decode_attention_cuda(q, k, v, lengths, window=window, softcap=softcap, scale=scale)


def _decode_attention_cpu_impl(q, k, v, lengths, window, softcap, scale):
    return decode_attention_ref(q, k, v, lengths, window=window, softcap=softcap, scale=scale)


def _decode_attention_fake(q, k, v, lengths, window, softcap, scale):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _ssd_scan_cuda_impl(x, dt, b, c, a, chunk):
    # The kernel reads the model layout by strides and pads a ragged last
    # chunk itself.
    return ssd_scan_cuda(x, dt, b, c, a, chunk=chunk)


def _ssd_scan_cpu_impl(x, dt, b, c, a, chunk):
    if b.dim() == 4:  # G groups: each group's heads scanned with its B and C
        hg = x.shape[2] // b.shape[2]
        parts = [_ssd_scan_cpu_impl(x[:, :, i * hg:(i + 1) * hg], dt[:, :, i * hg:(i + 1) * hg],
                                    b[:, :, i], c[:, :, i], a[i * hg:(i + 1) * hg], chunk)
                 for i in range(b.shape[2])]
        return torch.cat([y for y, _ in parts], dim=2), torch.cat([s for _, s in parts], dim=1)
    y, state = ssd_scan_chunked_ref(x.transpose(1, 2), dt.transpose(1, 2),
                                    torch.stack([b, c], dim=2), a, chunk=chunk)
    return y.transpose(1, 2).contiguous(), state


def _ssd_scan_fake(x, dt, b, c, a, chunk):
    bb, _, h, p = x.shape
    return (torch.empty(x.shape, dtype=x.dtype, device=x.device),
            torch.empty((bb, h, p, b.shape[-1]), dtype=torch.float32, device=x.device))


_LIB.impl("decode_attention", _decode_attention_cuda_impl, "CUDA")
_LIB.impl("decode_attention", _decode_attention_cpu_impl, "CPU")
_LIB.impl("ssd_scan", _ssd_scan_cuda_impl, "CUDA")
_LIB.impl("ssd_scan", _ssd_scan_cpu_impl, "CPU")
torch.library.register_fake("repro_torch::decode_attention", _decode_attention_fake, lib=_LIB)
torch.library.register_fake("repro_torch::ssd_scan", _ssd_scan_fake, lib=_LIB)


def _is_cuda_tensor(t: torch.Tensor) -> bool:
    """A plain tensor in CUDA memory (not a fake, meta or subclass tensor)."""
    return type(t) is torch.Tensor and t.is_cuda


# ---------------------------------------------------------------------------
# DTensor rules
# ---------------------------------------------------------------------------


def _sharded_on(p: Placement, dim: int) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def decode_attention_placements(q: DTensor, k: DTensor
                                ) -> Tuple[List[Placement], List[Placement], List[Placement]]:
    """(q and output, k and v, lengths) placements, per mesh dimension, on
    which K1 runs on local shards.  q is [B, Hq, Dh] and k [B, S, Hkv, Dh]:
    a mesh dimension that shards the batch of either shards all batches; one
    that shards the heads of either, where both head counts divide, shards
    both; any other is replicated (a cache sharded along S is gathered)."""
    mesh = q.device_mesh
    hq, hkv = q.shape[1], k.shape[2]
    qp, kp, lp = [], [], []
    for i, (pq, pk) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if _sharded_on(pq, 0) or _sharded_on(pk, 0):
            qp.append(Shard(0)), kp.append(Shard(0)), lp.append(Shard(0))
        elif (_sharded_on(pq, 1) or _sharded_on(pk, 2)) and hq % n == 0 and hkv % n == 0:
            qp.append(Shard(1)), kp.append(Shard(2)), lp.append(Replicate())
        else:
            qp.append(Replicate()), kp.append(Replicate()), lp.append(Replicate())
    return qp, kp, lp


def ssd_scan_placements(x: DTensor) -> Tuple[List[Placement], ...]:
    """(x and y, dt, B and C, a, the final state) placements, per mesh
    dimension, on which K4 runs on local shards.  x is [B, S, H, P], dt
    [B, S, H], B and C [B, S, ..., N], a [H], the state [B, H, P, N]."""
    xp, dtp, bcp, ap, sp = [], [], [], [], []
    for p in x.placements:
        if _sharded_on(p, 0):
            plan = (Shard(0), Shard(0), Shard(0), Replicate(), Shard(0))
        elif _sharded_on(p, 2):
            plan = (Shard(2), Shard(2), Replicate(), Shard(0), Shard(1))
        else:
            plan = (Replicate(),) * 5
        for out, pl in zip((xp, dtp, bcp, ap, sp), plan):
            out.append(pl)
    return xp, dtp, bcp, ap, sp


def ssm_step_placements(h: DTensor, groups: int) -> Tuple[List[Placement], ...]:
    """(state, x and y, dt_raw, B and C, dt_bias/A_log/D) placements, per
    mesh dimension, on which the SSM decode step runs on local shards.  h
    is [B, H, P, N], x [B, H, P], dt_raw [B, H], B and C [B, G, N], the
    per-head leaves [H].  The state keeps its own placements, so its shard
    is updated in place; a state sharded along N, or by head at several
    groups that the shards do not split whole, is refused."""
    mesh = h.device_mesh
    heads = h.shape[1]
    hp, xp, dtp, bcp, pp = [], [], [], [], []
    for i, p in enumerate(h.placements):
        n = mesh.size(i)
        if isinstance(p, Replicate):
            plan = (Replicate(),) * 5
        elif _sharded_on(p, 0):
            plan = (Shard(0), Shard(0), Shard(0), Shard(0), Replicate())
        elif _sharded_on(p, 1) and (groups == 1 or (heads % n == 0 and groups % n == 0)):
            bc = Replicate() if groups == 1 else Shard(1)
            plan = (Shard(1), Shard(1), Shard(1), bc, Shard(0))
        elif _sharded_on(p, 2):
            plan = (Shard(2), Shard(2), Replicate(), Replicate(), Replicate())
        else:
            raise NotImplementedError(
                f"the SSM decode step takes no state placed {p} on a mesh dimension of {n} "
                f"({heads} heads, {groups} groups)")
        for out, pl in zip((hp, xp, dtp, bcp, pp), plan):
            out.append(pl)
    return hp, xp, dtp, bcp, pp


# ---------------------------------------------------------------------------
# Model-layout entry points
# ---------------------------------------------------------------------------


def decode_attention(
    q: torch.Tensor,  # [B, Hq, Dh] (one new token per sequence)
    k: torch.Tensor,  # [B, S, Hkv, Dh] (model layout) — newest at lengths-1
    v: torch.Tensor,  # [B, S, Hkv, Dh]
    lengths: torch.Tensor,  # [B] valid token counts
    *,
    window: int = 1 << 30,
    softcap: Optional[float] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash-decode GQA.  Returns [B, Hq, Dh]."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        mesh = (q if isinstance(q, DTensor) else k).device_mesh
        q, k = (t if isinstance(t, DTensor) else from_local(t, mesh, [Replicate()] * mesh.ndim,
                                                             t.shape) for t in (q, k))
        qp, kp, lp = decode_attention_placements(q, k)
        out = decode_attention(to_local_as(q, mesh, qp), to_local_as(k, mesh, kp),
                               to_local_as(v, mesh, kp), to_local_as(lengths, mesh, lp),
                               window=window, softcap=softcap, scale=scale)
        return from_local(out, mesh, qp, q.shape)
    b, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if g * hkv != hq:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode_attention has no path for device {q.device}")
    qg = q.reshape(b, hkv, g, dh)
    # [B, Hkv, S, Dh] views: the kernel reads rows by stride, no copy.
    args = (qg, k.transpose(1, 2), v.transpose(1, 2), lengths.to(torch.int32), int(window),
            softcap, scale)
    if _is_cuda_tensor(q):
        out = _decode_attention_cuda_impl(*args)
    else:
        out = torch.ops.repro_torch.decode_attention(*args)
    return out.reshape(b, hq, dh)


def ssd_scan(
    x: torch.Tensor,  # [B, S, H, P] (model layout)
    dt: torch.Tensor,  # [B, S, H] f32 (post-softplus)
    bmat: torch.Tensor,  # [B, S, N] (G = 1) or [B, S, G, N]
    cmat: torch.Tensor,  # [B, S, N] or [B, S, G, N]
    a: torch.Tensor,  # [H] f32 negative
    *,
    chunk: int = 128,
    initial_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan with chunks of ``min(chunk, S)`` steps.  Returns
    (y [B, S, H, P] in x's dtype, final state [B, H, P, N] f32).  No path of
    the reference seeds the state, so ``initial_state`` must be None."""
    if initial_state is not None:
        raise NotImplementedError("ssd_scan starts from a zero state")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"ssd_scan has no path for device {x.device}")
    args = (x, dt.float(), bmat, cmat, a.float(), min(chunk, x.shape[1]))
    if _is_cuda_tensor(x):
        return _ssd_scan_cuda_impl(*args)
    return torch.ops.repro_torch.ssd_scan(*args)


def ssm_step(
    h: torch.Tensor,  # [B, H, P, N] f32, updated in place
    x: torch.Tensor,  # [B, H, P]
    dt_raw: torch.Tensor,  # [B, H] (before dt_bias and the softplus)
    bmat: torch.Tensor,  # [B, G, N]
    cmat: torch.Tensor,  # [B, G, N]
    dt_bias: torch.Tensor,  # [H] f32
    a_log: torch.Tensor,  # [H] f32
    d: torch.Tensor,  # [H] f32
) -> torch.Tensor:
    """One decode step of the SSM recurrence: ``h`` updated in place;
    returns y [B, H, P] in x's dtype.  The fused kernel on plain CUDA
    tensors, the plain version on CPU, fake and meta tensors; DTensors step
    on each device's shards (:func:`ssm_step_placements`)."""
    args = (h, x, dt_raw, bmat, cmat, dt_bias, a_log, d)
    dtensors = [t for t in args if isinstance(t, DTensor)]
    if dtensors:
        mesh = dtensors[0].device_mesh
        if not isinstance(h, DTensor):
            h = from_local(h, mesh, [Replicate()] * mesh.ndim, h.shape)
        hp, xp, dtp, bcp, pp = ssm_step_placements(h, bmat.shape[1])
        y = ssm_step(to_local_as(h, mesh, hp), to_local_as(x, mesh, xp),
                     to_local_as(dt_raw, mesh, dtp), to_local_as(bmat, mesh, bcp),
                     to_local_as(cmat, mesh, bcp), *(to_local_as(t, mesh, pp)
                                                     for t in (dt_bias, a_log, d)))
        return from_local(y, mesh, xp, x.shape)
    if _is_cuda_tensor(h):
        return ssm_step_cuda(*args)
    return ssm_step_ref(*args)
