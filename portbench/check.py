"""The output check that decides ``correct``.

Once the window has closed, a sample drawn from the seed of the requests
whose tokens reached the host inside it, with each engine's longest among
them, is run through the configuration's plain float32 reference (the module
its file names under ``reference``; :mod:`portbench.reference.model` for
hymba-1.5b and mamba2-2.7b) over its prompt and every token the engine
served it.  A served token is greedy, so under the reference it should be
the best or within rounding of it: the number compared is the widest gap by
which a served token's logit lies below the reference's best, in standard
deviations of the reference's logits at that position, over the sample
(``max_logit_gap_sd``: a scale of its own, so the number reads alike across
widths and depths).  A cell with a host-placed engine also compares the
engine's staged weights, as the last step copied them, with the weights the
benchmark made, bit for bit (``staged_weight_diff``, limit 0).

The control (``control=True``, never in the benchmark's own runs) is the
reference in float8: at each position of the same prompts and tokens, the
gap under the float32 reference of the token that float8 puts first.
"""

from __future__ import annotations

from types import ModuleType
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

#: Served tokens the sample aims at, over all engines.
SAMPLE_TOKENS = 256


def sample(tracks: Sequence, n_engines: int, seed: int, in_window) -> List:
    """Tracks to check: per engine, the longest with a token inside the
    window, then others in a seeded order until the engine's share of
    :data:`SAMPLE_TOKENS` served tokens is reached."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 0xC0FFEE])
    chosen = []
    share = max(1, SAMPLE_TOKENS // n_engines)
    for e in range(n_engines):
        cands = [t for t in tracks if t.engine == e and t.req.output
                 and any(in_window(s) for s in t.stamps)]
        if not cands:
            continue
        cands.sort(key=lambda t: t.req.rid)
        longest = max(cands, key=lambda t: (len(t.req.prompt) + len(t.req.output), -t.req.rid))
        rest = [cands[i] for i in rng.permutation(len(cands)) if cands[i] is not longest]
        got, tokens = [longest], len(longest.req.output)
        for t in rest:
            if tokens >= share:
                break
            got.append(t)
            tokens += len(t.req.output)
        chosen.extend(got)
    return chosen


def logit_gaps(reference: ModuleType, model: Dict, weights: Dict, tracks: Sequence, *,
               control: bool = False) -> Dict[str, float]:
    """The widest gap of the served tokens under ``reference`` (a module
    with ``logits(m, weights, tokens, positions, *, precision)``), the
    served tokens compared, and with ``control`` the widest gap of float8's
    first choices."""
    worst, worst_ctl, n = 0.0, 0.0, 0
    for t in tracks:
        out = list(t.req.output)
        seq = list(t.req.prompt) + out[:-1]
        pos = list(range(len(t.req.prompt) - 1, len(seq)))
        ref = reference.logits(model, weights, seq, pos)
        best = ref.max(dim=-1).values
        sd = ref.std(dim=-1)
        served = ref.gather(1, torch.as_tensor(out, device=ref.device)[:, None])[:, 0]
        worst = max(worst, float(((best - served) / sd).max()))
        n += len(out)
        if control:
            low = reference.logits(model, weights, seq, pos, precision="fp8")
            pick = low.argmax(dim=-1)
            lost = (best - ref.gather(1, pick[:, None])[:, 0]) / sd
            worst_ctl = max(worst_ctl, float(lost.max()))
        del ref
    res = {"max_logit_gap_sd": worst, "tokens_compared": float(n),
           "requests_compared": float(len(tracks))}
    if control:
        res["control_max_logit_gap_sd"] = worst_ctl
    return res


def staged_weight_diff(staged: Dict, weights: Dict) -> float:
    """Largest absolute difference over every leaf of two trees."""
    worst = 0.0
    for k, v in weights.items():
        if isinstance(v, dict):
            worst = max(worst, staged_weight_diff(staged[k], v))
        elif not torch.equal(staged[k], v):
            worst = max(worst, float((staged[k].float() - v.float()).abs().max()))
    return worst


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Optional[str]:
    """None when every compared number is within its limit, else why not."""
    bad = [f"{k} {numbers.get(k)!r} > {limits[k]!r}" for k in limits
           if not (k in numbers and numbers[k] <= limits[k])]
    return "; ".join(bad) or None
