"""Plain float32 forward pass of the served models, for the output check.

The math is the published models' as the port states them
(``configs/<config>.json``): a tied embedding; per layer RMSNorm with the
zero-centred ``1 + scale`` weight; grouped-query attention with rotate-half
RoPE and a causal window; mamba2's SSM block (in-projection split into z,
xBC and dt, a causal depthwise conv of width 4 with SiLU, the SSD
recurrence with ``dt = softplus(dt + dt_bias)`` and ``A = -exp(A_log)``,
the ``D`` skip, a gated RMSNorm and the out-projection); hymba's hybrid
block, whose attention and SSM heads read one normed input and are
averaged, then a SwiGLU MLP; mamba2's pure SSM block without an MLP.

It takes the same weight tree that the benchmark hands the program (leaf
names of the port's layout, stacked over layers), reads each layer's
leaves in float32 one layer at a time, and returns the logits at the
positions asked for.  ``precision="fp8"`` is the control: every matrix
product's weight rounded to float8 e4m3 with a scale per output channel,
the rest as in float32.

TF32 is switched off while it runs, so float32 products are float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Sequence

import torch
import torch.nn.functional as F

FULL_WINDOW = 1 << 30
Q_ROWS = 1024
SSD_CHUNK = 128
#: The largest finite float8 e4m3 value.
E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """TF32 off for cuBLAS and cuDNN, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8_columns(w: torch.Tensor) -> torch.Tensor:
    """``w`` [in, out] rounded to e4m3 with one scale per output column."""
    scale = w.abs().amax(dim=0, keepdim=True).clamp_min(1e-30) / E4M3_MAX
    return (w / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _weight(w: torch.Tensor, precision: str, n_in: int = 1) -> torch.Tensor:
    """A product's weight, its first ``n_in`` dimensions the input's, as
    [in, out] float32, in the precision asked for."""
    w = w.to(torch.float32).reshape(math.prod(w.shape[:n_in]), -1)
    return fp8_columns(w) if precision == "fp8" else w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x [S, H, Dh] at positions 0..S-1, rotate-half form."""
    s, dh = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    sin, cos = ang.sin()[:, None, :], ang.cos()[:, None, :]
    x1, x2 = x[..., : dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(m: Dict, p: Dict, h: torch.Tensor, window: int, precision: str) -> torch.Tensor:
    s = h.shape[0]
    hq, hkv, dh = m["n_q_heads"], m["n_kv_heads"], m["head_dim"]
    q = (h @ _weight(p["wq"], precision)).view(s, hq, dh)
    k = (h @ _weight(p["wk"], precision)).view(s, hkv, dh)
    v = (h @ _weight(p["wv"], precision)).view(s, hkv, dh)
    if m.get("rope_theta"):
        q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    q = q * dh ** -0.5
    g = hq // hkv
    kk = k.permute(1, 2, 0)  # [Hkv, Dh, S]
    vv = v.permute(1, 0, 2)  # [Hkv, S, Dh]
    tpos = torch.arange(s, device=h.device)
    out = []
    for q0 in range(0, s, Q_ROWS):
        qb = q[q0:q0 + Q_ROWS]  # [R, Hq, Dh]
        r = qb.shape[0]
        qg = qb.view(r, hkv, g, dh).permute(1, 2, 0, 3).reshape(hkv, g * r, dh)
        scores = (qg @ kk).view(hkv, g, r, s)
        spos = tpos[q0:q0 + r, None]
        keep = (tpos[None, :] <= spos) & (spos - tpos[None, :] < window)
        scores = scores.masked_fill(~keep, float("-inf"))
        probs = torch.softmax(scores, dim=-1).view(hkv, g * r, s)
        o = (probs @ vv).view(hkv, g, r, dh).permute(2, 0, 1, 3).reshape(r, hq * dh)
        out.append(o)
    return torch.cat(out) @ _weight(p["wo"], precision, n_in=2)


def ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
        cmat: torch.Tensor, chunk: int = SSD_CHUNK) -> torch.Tensor:
    """y_t = sum_{k<=t} (C_t . B_k) exp(sum_{k<j<=t} dt_j a) dt_k x_k, by
    chunks with a carried float32 state.  x [S, H, P], dt [S, H], a [H],
    B and C [S, H, N] (already repeated to the heads)."""
    s, h, p = x.shape
    n = bmat.shape[-1]
    state = x.new_zeros(h, p, n)
    ys = []
    for c0 in range(0, s, chunk):
        xq, dq = x[c0:c0 + chunk], dt[c0:c0 + chunk]
        bq, cq = bmat[c0:c0 + chunk], cmat[c0:c0 + chunk]
        q = xq.shape[0]
        cum = torch.cumsum(dq * a, dim=0)  # [Q, H]
        rel = cum[:, None, :] - cum[None, :, :]  # [Q, Q, H]
        keep = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[:, :, None]
        decay = rel.masked_fill(~keep, float("-inf")).exp()
        w = torch.einsum("qhn,khn->qkh", cq, bq) * decay
        y = torch.einsum("qkh,khp->qhp", w, dq[..., None] * xq)
        y = y + torch.einsum("qhn,hpn->qhp", cum.exp()[..., None] * cq, state)
        tail = (cum[-1:] - cum).exp() * dq  # [Q, H]
        state = (state * cum[-1].exp()[:, None, None]
                 + torch.einsum("qhp,qhn->hpn", tail[..., None] * xq, bq))
        ys.append(y)
    return torch.cat(ys)


def ssm_block(m: Dict, p: Dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    s = h.shape[0]
    di = m["ssm_expand"] * m["d_model"]
    pdim, n, g = m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    nh = di // pdim
    zxbcdt = h @ _weight(p["in_proj"], precision)
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * g * n], zxbcdt[:, 2 * di + 2 * g * n:]
    w = p["conv_w"].float()  # [K, C]
    kw = w.shape[0]
    padded = F.pad(xbc, (0, 0, kw - 1, 0))
    conv = sum(padded[j:j + s] * w[j] for j in range(kw)) + p["conv_b"].float()
    conv = F.silu(conv)
    xs = conv[:, :di].view(s, nh, pdim)
    bmat = conv[:, di:di + g * n].view(s, g, n).repeat_interleave(nh // g, dim=1)
    cmat = conv[:, di + g * n:].view(s, g, n).repeat_interleave(nh // g, dim=1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y = ssd(xs, dt, a, bmat, cmat) + p["D"].float()[None, :, None] * xs
    y = rmsnorm(y.reshape(s, di) * F.silu(z), p["norm"])
    return y @ _weight(p["out_proj"], precision)


def mlp(p: Dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    gate = h @ _weight(p["w_gate"], precision)
    up = h @ _weight(p["w_up"], precision)
    return (F.silu(gate) * up) @ _weight(p["w_down"], precision)


def _layer(tree: Dict, i: int) -> Dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def windows(m: Dict) -> List[int]:
    n, w = m["n_layers"], m.get("sliding_window") or FULL_WINDOW
    pattern = m.get("window_pattern", "full")
    if pattern == "hymba":
        return [FULL_WINDOW if i in (0, n // 2, n - 1) else w for i in range(n)]
    if pattern == "swa":
        return [w] * n
    return [FULL_WINDOW] * n


def logits(m: Dict, weights: Dict, tokens: Sequence[int], positions: Sequence[int], *,
           precision: str = "f32") -> torch.Tensor:
    """float32 logits [len(positions), vocab] of the model over ``tokens``
    at ``positions`` (each predicting the token after it)."""
    if m["block"] not in ("ssm", "hybrid"):
        raise ValueError(f"the reference serves the ssm and hybrid blocks, not {m['block']!r}")
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    table = weights["embed"]
    dev = table.device
    with torch.no_grad(), exact_float32():
        ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        x = table[ids].float()
        for i, window in enumerate(windows(m)):
            p = _layer(weights["layers"], i)
            if m["block"] == "ssm":
                x = x + ssm_block(m, p["ssm"], rmsnorm(x, p["pre_ssm_norm"]), precision)
                continue
            h = rmsnorm(x, p["pre_attn_norm"])
            x = x + 0.5 * (attention(m, p["attn"], h, window, precision)
                           + ssm_block(m, p["ssm"], h, precision))
            x = x + mlp(p["mlp"], rmsnorm(x, p["pre_mlp_norm"]), precision)
        pos = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
        hidden = rmsnorm(x[pos], weights["final_norm"])
        head = table.float().t()
        if precision == "fp8":
            head = fp8_columns(head)
        return hidden @ head
