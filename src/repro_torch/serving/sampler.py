"""Token samplers (greedy / temperature / top-k), port of
``repro/serving/sampler.py``.  Random draws take an explicit
``torch.Generator``; they cannot match the reference's bits, only its
distribution."""

from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Argmax over the vocabulary (first index on ties, as ``jnp.argmax``)."""
    del generator
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature(logits: torch.Tensor, generator: torch.Generator,
                temp: float = 0.8, top_k: int = 0) -> torch.Tensor:
    """Sample from softmax(logits / temp), restricted to the top ``top_k``
    logits when ``top_k > 0``."""
    logits = logits.float() / max(temp, 1e-6)
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.tensor(-torch.inf, device=logits.device),
                             logits)
    probs = torch.softmax(logits, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)
