"""The published peaks of one NVIDIA H100 and the least bytes and
operations of the port's decode step, its prefill, and one call of each of
its kernels K1 (flash-decode GQA) and K4 (the SSD chunked scan).

Every function counts what its inputs need and no more: each input byte
read once, each output byte written once, and the operations of the work
the inputs ask for (a causal, windowed attention counts only the key rows
its window keeps).  So ``least_seconds`` is a lower bound on the time of the
work, and a share of it over a measured time cannot pass 100%.

``m`` is the ``model`` object of a configuration file
(``configs/<config>.json``), in the port's ``ModelConfig`` field names.
Every configuration names its least-work module (the file's ``counts``),
which exposes ``decode_step(m, active)``, ``prefill(m, s)`` and
``k4_calls(m, s)``; this module is that of the configurations whose layers
are all alike (hymba-1.5b, mamba2-2.7b), and holds the peaks, :class:`Work`
and :func:`share_pct` that every configuration's counts and every reader
share.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

#: NVIDIA H100 SXM data sheet, dense rates: bf16 tensor-core FLOP/s and HBM3
#: bytes/s, at the card's full 700 W power limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
FULL_WINDOW = 1 << 30
BF16 = 2
F32 = 4


@dataclasses.dataclass(frozen=True)
class Work:
    flops: float
    bytes: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    @property
    def least_seconds(self) -> float:
        """The larger of operations over peak FLOP/s and bytes over peak
        bandwidth."""
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)

    @property
    def bound_by(self) -> str:
        return "flops" if self.flops / PEAK_BF16_FLOPS >= self.bytes / PEAK_HBM_BYTES else "bytes"


ZERO = Work(0.0, 0.0)


def uses_attention(m: Dict) -> bool:
    return m["block"] in ("dense", "hybrid")


def uses_ssm(m: Dict) -> bool:
    return m["block"] in ("ssm", "hybrid")


def ssm_dims(m: Dict) -> Dict[str, int]:
    d_inner = m["ssm_expand"] * m["d_model"]
    h = d_inner // m["ssm_head_dim"]
    n, g = m["ssm_state"], m["ssm_groups"]
    conv_dim = d_inner + 2 * g * n
    return dict(d_inner=d_inner, n_heads=h, head_dim=m["ssm_head_dim"], d_state=n,
                n_groups=g, d_conv=4, conv_dim=conv_dim, d_in_proj=2 * d_inner + 2 * g * n + h)


def windows(m: Dict) -> List[int]:
    """Each layer's attention window (``FULL_WINDOW`` for full attention)."""
    n, w = m["n_layers"], m.get("sliding_window") or FULL_WINDOW
    pattern = m.get("window_pattern", "full")
    if pattern == "swa":
        return [w] * n
    if pattern == "hymba":
        full = {0, n // 2, n - 1}
        return [FULL_WINDOW if i in full else w for i in range(n)]
    if pattern != "full":
        raise ValueError(f"window pattern {pattern!r}")
    return [FULL_WINDOW] * n


def matmul_params_per_layer(m: Dict) -> int:
    """Weights one token multiplies in one layer (every product's weight)."""
    d, n = m["d_model"], 0
    if uses_attention(m):
        n += d * m["head_dim"] * (2 * m["n_q_heads"] + 2 * m["n_kv_heads"])
    if m["d_ff"] and m["block"] != "ssm":
        n += 3 * d * m["d_ff"]
    if uses_ssm(m):
        s = ssm_dims(m)
        n += d * s["d_in_proj"] + s["d_inner"] * d
    return n


def param_bytes(m: Dict) -> int:
    """Every weight once, in bf16, but the SSM's f32 ``A_log``, ``D`` and
    ``dt_bias``: the embedding (tied: read again as the LM head, counted
    once), each layer's products, norms, depthwise conv and SSM scalars."""
    d, L = m["d_model"], m["n_layers"]
    per = matmul_params_per_layer(m) * BF16
    if uses_attention(m):
        per += d * BF16  # pre_attn_norm
        if m["d_ff"]:
            per += d * BF16  # pre_mlp_norm
    if uses_ssm(m):
        s = ssm_dims(m)
        per += (s["d_conv"] * s["conv_dim"] + s["conv_dim"] + s["d_inner"]) * BF16
        per += 3 * s["n_heads"] * F32
        if not uses_attention(m):
            per += d * BF16  # pre_ssm_norm
    table = m["vocab"] * d * BF16 * (1 if m["tied_embeddings"] else 2)
    return L * per + table + d * BF16


def kv_row_bytes(m: Dict) -> int:
    """One token's K and V in one attention layer."""
    return 2 * m["n_kv_heads"] * m["head_dim"] * BF16


def k1_call(keys: Sequence[int], hq: int, hkv: int, dh: int, esize: int = BF16) -> Work:
    """One flash-decode call over the slots whose valid key rows (within
    the window) are ``keys``: q and the output once, each kept K and V row
    once; QK^T and PV at 2 operations a multiply-add."""
    rows = sum(keys)
    nbytes = 2 * rows * hkv * dh * esize + 2 * len(keys) * hq * dh * esize + 4 * len(keys)
    return Work(4.0 * rows * hq * dh, nbytes)


def k4_call(s: int, h: int, p: int, n: int, esize: int = BF16, batch: int = 1,
            groups: int = 1) -> Work:
    """One SSD scan over ``s`` steps: x, dt (f32), B and C (``groups`` of
    each, shared by the heads of a group) in, y and the f32 final state out;
    the recurrence's 4 operations per (step, head, P, N) (the state's update
    and its read-out), the least any schedule needs."""
    tokens = batch * s
    nbytes = (tokens * (2 * h * p * esize + h * F32 + 2 * groups * n * esize)
              + batch * h * p * n * F32 + h * F32)
    return Work(4.0 * tokens * h * p * n, nbytes)


def k1_keys(m: Dict, lengths: Iterable[int], s_max: int, layer_window: int) -> List[int]:
    """Key rows K1 reads for each slot: the kernel sees ``length + 1``
    valid rows (the new token included), at most the cache's, within the
    window."""
    return [min(length + 1, s_max, layer_window) for length in lengths]


def decode_step(m: Dict, active: Sequence[int]) -> Work:
    """One decode step of the slots whose cache lengths (tokens already
    seen) are ``active``: every weight once, each kept K/V row read, the new
    rows written, each SSM and conv state read and written, the logits out;
    the products, attention and the scan's update."""
    b = len(active)
    if not b:
        return ZERO
    d, v = m["d_model"], m["vocab"]
    flops = 2.0 * b * (matmul_params_per_layer(m) * m["n_layers"] + v * d)
    nbytes = float(param_bytes(m) + b * v * BF16)
    if uses_attention(m):
        hq, hkv, dh = m["n_q_heads"], m["n_kv_heads"], m["head_dim"]
        for w in windows(m):
            keys = [min(length + 1, w) for length in active]
            flops += 4.0 * sum(keys) * hq * dh
            nbytes += (sum(keys) - b) * kv_row_bytes(m) + b * kv_row_bytes(m)
    if uses_ssm(m):
        s = ssm_dims(m)
        state = s["n_heads"] * s["head_dim"] * s["d_state"]
        conv = (s["d_conv"] - 1) * s["conv_dim"] * BF16
        flops += 4.0 * b * state * m["n_layers"]
        nbytes += b * m["n_layers"] * (2 * state * F32 + 2 * conv)
    return Work(flops, nbytes)


def causal_pairs(s: int, w: int) -> int:
    """(query, key) pairs a causal window of ``w`` keeps over ``s`` tokens."""
    if w >= s:
        return s * (s + 1) // 2
    return w * (w + 1) // 2 + (s - w) * w


def prefill(m: Dict, s: int) -> Work:
    """One batch-1 prefill of ``s`` tokens: every weight once, the K/V
    rows and SSM states it leaves, the last position's logits; the products
    of every token, the windowed causal attention, each SSM layer's scan
    (:func:`k4_call`) and depthwise conv."""
    d, v = m["d_model"], m["vocab"]
    flops = 2.0 * s * matmul_params_per_layer(m) * m["n_layers"] + 2.0 * v * d
    nbytes = float(param_bytes(m) + s * BF16 + v * BF16)
    if uses_attention(m):
        hq, dh = m["n_q_heads"], m["head_dim"]
        for w in windows(m):
            flops += 4.0 * causal_pairs(s, w) * hq * dh
            nbytes += s * kv_row_bytes(m)
    if uses_ssm(m):
        sd = ssm_dims(m)
        scan = k4_call(s, sd["n_heads"], sd["head_dim"], sd["d_state"], groups=sd["n_groups"])
        flops += m["n_layers"] * (scan.flops + 2.0 * s * sd["d_conv"] * sd["conv_dim"])
        nbytes += m["n_layers"] * (sd["n_heads"] * sd["head_dim"] * sd["d_state"] * F32
                                   + (sd["d_conv"] - 1) * sd["conv_dim"] * BF16)
    return Work(flops, nbytes)


def k4_calls(m: Dict, s: int) -> List[Work]:
    """The least work of each K4 launch of a batch-1 prefill of ``s``
    tokens: one scan a layer, every layer alike; none without SSM layers."""
    if not uses_ssm(m):
        return []
    sd = ssm_dims(m)
    return [k4_call(s, sd["n_heads"], sd["head_dim"], sd["d_state"],
                    groups=sd["n_groups"])] * m["n_layers"]


def share_pct(least: float, measured: float) -> float:
    """``least`` over ``measured`` seconds, in percent."""
    if measured <= 0:
        raise ValueError("a share needs a measured time above 0")
    return 100.0 * least / measured


def attn_layers(m: Dict) -> List[Tuple[int, int]]:
    """(layer, window) of each attention layer."""
    return list(enumerate(windows(m))) if uses_attention(m) else []
