"""Plain float32 forward pass of the port's dense block, the reference
module of the test configuration ``dense-smoke``: per layer RMSNorm,
grouped-query attention with RoPE and the SwiGLU MLP, each added to the
residual, then the final norm and an untied LM head.  It reuses the
yardstick's pieces (:mod:`portbench.reference.model`) and, like it, imports
nothing of the port."""

from typing import Dict, Sequence

import torch

from portbench.reference.model import (_layer, attention, exact_float32, fp8_columns, mlp,
                                       rmsnorm, windows)


def logits(m: Dict, weights: Dict, tokens: Sequence[int], positions: Sequence[int], *,
           precision: str = "f32") -> torch.Tensor:
    if m["block"] != "dense":
        raise ValueError(f"this reference serves the dense block, not {m['block']!r}")
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r}")
    table = weights["embed"]
    with torch.no_grad(), exact_float32():
        ids = torch.as_tensor(list(tokens), dtype=torch.long, device=table.device)
        x = table[ids].float()
        for i, window in enumerate(windows(m)):
            p = _layer(weights["layers"], i)
            x = x + attention(m, p["attn"], rmsnorm(x, p["pre_attn_norm"]), window, precision)
            x = x + mlp(p["mlp"], rmsnorm(x, p["pre_mlp_norm"]), precision)
        pos = torch.as_tensor(list(positions), dtype=torch.long, device=table.device)
        hidden = rmsnorm(x[pos], weights["final_norm"])
        head = (table if m["tied_embeddings"] else weights["lm_head"]).float().t()
        if precision == "fp8":
            head = fp8_columns(head)
        return hidden @ head
