"""The least work of Nemotron-H (``nemotron3-nano-30b-a3b``), the
configuration's least-work module: ``decode_step(m, active)``,
``prefill(m, s)`` and ``k4_calls(m, s)`` as :mod:`portbench.counts` gives
them for models whose layers are all alike, here over the pattern's three
kinds, and the routed experts' work (:func:`moe_expected`,
:func:`expert_work`), for a reader of the expert products' roofline.

Every weight is read once, but the embedding, of which only the looked-up
rows are; each attention layer's kept K/V rows are read and the new ones
written; each Mamba layer's f32 SSM state and conv state are read and
written; a prefill's scans are K4's (:func:`portbench.counts.k4_call`, with
8 groups of B and C).  The routed experts are counted at their expectation
under uniform routing over the router's ``router_experts``: of a step's
``tokens x top_k`` choices a layer, ``n_experts / router_experts`` fall on
the experts held, each ``4 x d_model x d_ff`` operations; and each held
expert is touched (its two matrices read) with probability ``1 - (1 -
1 / router_experts)^(tokens x top_k)``.

These two counts are expectations, not bounds: the program's routing is
not uniform (random weights and a choice bias favour some experts), and a
step that concentrates its requests on fewer experts reads fewer bytes
than counted.  They stay under 100% of the measured time in practice
because the model step's shares read 3-18% of their peaks today (PERF.md
§6) and the experts are about half of a decode step's least bytes; the
reader of the experts' own roofline takes the program's counts of the
traced steps wherever it can.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

from portbench.counts import BF16, F32, ZERO, Work, causal_pairs, k4_call, kv_row_bytes


def _ssm(m: Dict) -> Dict[str, int]:
    h, p, n, g = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    d_inner = h * p
    conv_dim = d_inner + 2 * g * n
    return dict(d_inner=d_inner, n_heads=h, head_dim=p, d_state=n, n_groups=g, d_conv=4,
                conv_dim=conv_dim, d_in_proj=2 * d_inner + 2 * g * n + h)


def layers(m: Dict, letter: str) -> int:
    return m["layer_pattern"].count(letter)


def router_experts(m: Dict) -> int:
    return m.get("router_experts") or m["n_experts"]


def dense_params(m: Dict) -> int:
    """Weights one token multiplies outside the routed experts, over all
    layers: attention, Mamba's projections, the routers and the shared
    experts (the LM head is counted apart)."""
    d, s = m["d_model"], _ssm(m)
    attn = d * m["head_dim"] * (2 * m["n_q_heads"] + 2 * m["n_kv_heads"])
    mamba = d * s["d_in_proj"] + s["d_inner"] * d
    moe = d * router_experts(m) + 2 * d * m["shared_expert_ff"]
    return layers(m, "*") * attn + layers(m, "M") * mamba + layers(m, "E") * moe


def other_bytes(m: Dict) -> int:
    """Every weight but the routed experts and the embedding, once, in
    bf16 (the SSM's A_log, D and dt_bias in f32): products, norms, the
    conv, the routers' biases, the LM head and the final norm."""
    d, s = m["d_model"], _ssm(m)
    per_m = (s["d_conv"] * s["conv_dim"] + s["conv_dim"] + s["d_inner"] + d) * BF16
    per_m += 3 * s["n_heads"] * F32
    per_e = (router_experts(m) + d) * BF16
    per_a = d * BF16
    norms = layers(m, "M") * per_m + layers(m, "E") * per_e + layers(m, "*") * per_a
    return dense_params(m) * BF16 + norms + m["vocab"] * d * BF16 + d * BF16


def moe_expected(m: Dict, tokens: int) -> Tuple[float, float]:
    """(requests routed to held experts, held experts touched), summed over
    the MoE layers, of a call over ``tokens`` tokens, at their expectation
    under uniform routing."""
    r, held, n = router_experts(m), m["n_experts"], layers(m, "E")
    choices = tokens * m["top_k"]
    return (n * choices * held / r, n * held * (1.0 - (1.0 - 1.0 / r) ** choices))


def expert_work(m: Dict, requests: float, experts: float) -> Work:
    """The routed experts' least work: each touched expert's two matrices
    read once, 4 x d_model x d_ff operations a request."""
    per = m["d_model"] * m["d_ff"]
    return Work(4.0 * per * requests, 2.0 * per * BF16 * experts)


def _ssm_state_bytes(m: Dict) -> int:
    s = _ssm(m)
    return (s["n_heads"] * s["head_dim"] * s["d_state"] * F32
            + (s["d_conv"] - 1) * s["conv_dim"] * BF16)


def decode_step(m: Dict, active: Sequence[int]) -> Work:
    """One decode step of the slots whose cache lengths are ``active``."""
    b = len(active)
    if not b:
        return ZERO
    d, v = m["d_model"], m["vocab"]
    flops = 2.0 * b * (dense_params(m) + v * d)
    nbytes = float(other_bytes(m) + b * d * BF16 + b * v * BF16)
    hq, dh = m["n_q_heads"], m["head_dim"]
    keys = sum(length + 1 for length in active)
    flops += layers(m, "*") * 4.0 * keys * hq * dh
    nbytes += layers(m, "*") * keys * kv_row_bytes(m)
    s = _ssm(m)
    state = s["n_heads"] * s["head_dim"] * s["d_state"]
    flops += layers(m, "M") * 4.0 * b * state
    nbytes += layers(m, "M") * b * 2 * _ssm_state_bytes(m)
    return Work(flops, nbytes) + expert_work(m, *moe_expected(m, b))


def prefill(m: Dict, s: int) -> Work:
    """One batch-1 prefill of ``s`` tokens, the last position's logits."""
    d, v = m["d_model"], m["vocab"]
    flops = 2.0 * s * dense_params(m) + 2.0 * v * d
    nbytes = float(other_bytes(m) + s * d * BF16 + s * BF16 + v * BF16)
    flops += layers(m, "*") * 4.0 * causal_pairs(s, s) * m["n_q_heads"] * m["head_dim"]
    nbytes += layers(m, "*") * s * kv_row_bytes(m)
    sd = _ssm(m)
    scan = k4_calls(m, s)
    flops += math.fsum(w.flops for w in scan) + layers(m, "M") * 2.0 * s * sd["d_conv"] * \
        sd["conv_dim"]
    nbytes += layers(m, "M") * _ssm_state_bytes(m)
    return Work(flops, nbytes) + expert_work(m, *moe_expected(m, s))


def k4_calls(m: Dict, s: int) -> List[Work]:
    """The least work of each K4 launch of a batch-1 prefill of ``s``
    tokens: one scan a Mamba layer, B and C in ``ssm_groups`` groups."""
    sd = _ssm(m)
    return [k4_call(s, sd["n_heads"], sd["head_dim"], sd["d_state"],
                    groups=sd["n_groups"])] * layers(m, "M")
