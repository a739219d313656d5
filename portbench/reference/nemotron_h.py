"""Plain float32 forward pass of Nemotron-H (``nemotron_h``:
NVIDIA-Nemotron-3-Nano-30B-A3B), the reference of the configuration
``nemotron3-nano-30b-a3b``, for the output check.

The published layer equations: 52 layers by ``layer_pattern``, each
``x + mixer(rmsnorm(x))`` with epsilon ``norm_eps``, the mixer one of

* ``M``, Mamba-2: the in-projection split into z, xBC and dt; a causal
  depthwise conv of width 4 with its bias and SiLU; x of ``ssm_heads``
  heads of ``ssm_head_dim``, B and C of ``ssm_groups`` groups, each head
  reading its group's; the SSD recurrence with ``dt = softplus(dt +
  dt_bias)`` and ``A = -exp(A_log)``; the ``D`` skip; the gated RMSNorm
  ``rmsnorm(y * silu(z))`` over each group's d_inner / groups channels;
  the out-projection;
* ``E``, the MoE: a sigmoid over the router's outputs (all the router's
  experts), the top ``top_k`` of score + ``router_bias`` (the lower expert
  first on ties), their unbiased scores over their sum times
  ``routed_scaling``; each chosen expert ``down(relu(up(x))^2)``; a shared
  expert of the same form added once;
* ``*``, attention: grouped-query, full and causal, no bias, no rotary
  embedding (``rope_theta`` None; see below).

Then the final RMSNorm and the untied LM head.

**The experts held.**  The weights hold the first ``n_experts`` of the
router's experts (one device's share under expert parallelism, or all of
them).  The router routes over every expert; this reference computes the
held experts' part of the routed sum for the requests routed to them, and
the shared expert.  What the experts held elsewhere would add is left out,
as the program leaves it out: that partial result goes on to the next
layer.

**Departures from the published model**, each as the program makes it too
(the configuration file's ``departures``): (1) only the held experts'
part of the routed sum, as above; (2) the attention layers apply no rotary
embedding: HF's ``nemotron_h`` code, as recalled here (no copy in the
repository), applies none, though the config carries ``rope_theta``
10,000; (3) the norms' weights are stored zero-centred, ``1 + scale``, as
every norm of the port's (a parametrisation, not a change of the
function); (4) the router's choice bias is stored in the model's dtype
(bf16), where the published checkpoint keeps ``e_score_correction_bias``
in float32; (5) the expert sum is taken in float32, where the published
code adds the experts' outputs in the model's dtype.

It takes the weight tree the benchmark hands the program (the port's leaf
names, each kind's layers stacked: ``layers/mamba``, ``layers/experts``,
``layers/attention``), reads each layer's leaves in float32 only when it
reaches that layer (an expert's only when a request is routed to it), and
returns the logits at the positions asked for.  ``precision="fp8"`` is the
control: every matrix product's weight, the router's and the experts'
included, rounded to float8 e4m3 with a scale per output channel.  It
imports nothing of the port; TF32 is off while it runs.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from portbench.reference.model import (FULL_WINDOW, SSD_CHUNK, _layer, _weight, attention,
                                       exact_float32, fp8_columns, rmsnorm, ssd)

#: Pattern letter -> the key of its kind's stack.
KINDS = {"M": "mamba", "E": "experts", "*": "attention"}


def mamba(m: Dict, p: Dict, h: torch.Tensor, precision: str) -> torch.Tensor:
    s = h.shape[0]
    nh, pdim, n, g = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"], m["ssm_groups"]
    di = nh * pdim
    zxbcdt = h @ _weight(p["in_proj"], precision)
    z, xbc, dt = zxbcdt[:, :di], zxbcdt[:, di:2 * di + 2 * g * n], zxbcdt[:, 2 * di + 2 * g * n:]
    w = p["conv_w"].float()  # [K, C]
    kw = w.shape[0]
    padded = F.pad(xbc, (0, 0, kw - 1, 0))
    conv = F.silu(sum(padded[j:j + s] * w[j] for j in range(kw)) + p["conv_b"].float())
    xs = conv[:, :di].view(s, nh, pdim)
    bmat = conv[:, di:di + g * n].view(s, g, n).repeat_interleave(nh // g, dim=1)
    cmat = conv[:, di + g * n:].view(s, g, n).repeat_interleave(nh // g, dim=1)
    dt = F.softplus(dt + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    y = ssd(xs, dt, a, bmat, cmat, SSD_CHUNK) + p["D"].float()[None, :, None] * xs
    gated = (y.reshape(s, di) * F.silu(z)).view(s, g, di // g)
    y = rmsnorm(gated, p["norm"].view(g, di // g), m["norm_eps"]).reshape(s, di)
    return y @ _weight(p["out_proj"], precision)


def relu2(x: torch.Tensor) -> torch.Tensor:
    return torch.relu(x).square()


def route(m: Dict, p: Dict, h: torch.Tensor, precision: str):
    """(weights [S, k], experts [S, k]) of the biased sigmoid router."""
    scores = torch.sigmoid(h @ _weight(p["router"], precision))
    choice = scores + p["router_bias"].float()
    idx = torch.sort(choice, dim=-1, descending=True, stable=True)[1][:, :m["top_k"]]
    w = scores.gather(1, idx)
    return w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m["routed_scaling"], idx


def moe(m: Dict, p: Dict, h: torch.Tensor, precision: str, *, first: int = 0,
        shared: bool = True) -> torch.Tensor:
    """The held experts ``first ..`` (as many as the weights hold) over the
    requests routed to them, and with ``shared`` the shared expert."""
    gates, idx = route(m, p, h, precision)
    out = torch.zeros_like(h)
    for e in range(p["w_experts_in"].shape[0]):
        tok, slot = (idx == first + e).nonzero(as_tuple=True)
        if tok.numel():  # a token chooses an expert once, so no row repeats
            y = relu2(h[tok] @ _weight(p["w_experts_in"][e], precision))
            y = y @ _weight(p["w_experts_out"][e], precision)
            out[tok] = out[tok] + y * gates[tok, slot, None]
    if shared and "shared" in p:
        sh = p["shared"]
        out = out + relu2(h @ _weight(sh["w_up"], precision)) @ _weight(sh["w_down"], precision)
    return out


def logits(m: Dict, weights: Dict, tokens: Sequence[int], positions: Sequence[int], *,
           precision: str = "f32") -> torch.Tensor:
    """float32 logits [len(positions), vocab] of the model over ``tokens``
    at ``positions`` (each predicting the token after it)."""
    if m["block"] != "mixed":
        raise ValueError(f"this reference serves the mixed block, not {m['block']!r}")
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    eps = m["norm_eps"]
    table = weights["embed"]
    dev = table.device
    with torch.no_grad(), exact_float32():
        ids = torch.as_tensor(list(tokens), dtype=torch.long, device=dev)
        x = table[ids].float()
        seen: Dict[str, int] = {}
        for letter in m["layer_pattern"]:
            j = seen.get(letter, 0)
            seen[letter] = j + 1
            p = _layer(weights["layers"][KINDS[letter]], j)
            if letter == "M":
                x = x + mamba(m, p["ssm"], rmsnorm(x, p["pre_ssm_norm"], eps), precision)
            elif letter == "E":
                x = x + moe(m, p["moe"], rmsnorm(x, p["pre_mlp_norm"], eps), precision)
            else:
                x = x + attention(m, p["attn"], rmsnorm(x, p["pre_attn_norm"], eps),
                                  FULL_WINDOW, precision)
        pos = torch.as_tensor(list(positions), dtype=torch.long, device=dev)
        hidden = rmsnorm(x[pos], weights["final_norm"], eps)
        head = weights["lm_head"].float().t()
        if precision == "fp8":
            head = fp8_columns(head)
        return hidden @ head
