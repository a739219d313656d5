"""The one generator of every traffic mix: a closed loop, one client per
slot, greedy decoding, token ids uniform over the vocabulary.

A mix (``traffic/<mix>.json``) names its engines (placement, slots,
clients), its prompt and output length distributions, ``max_len``, the deck
size and the public trace its lengths follow (``source``).  Lengths are drawn
from a *deck*: ``deck`` stratified quantiles of each distribution, the prompt
and the output decks apart; a client takes the next card, and a spent deck is
dealt again.  Each engine deals its decks in one fixed order, whatever the
seed: the seed draws the token ids (and the weights), never the sizes or
their order, so two seeds ask the same work of a window.  The warm-up fill
gives each client one request whose output length is a stratified draw of
the tokens a request in flight still has to make in the loop's steady state:
r in 1..longest with weight P(output >= r) (a slot is caught part way
through a request, long requests more often), so the window opens at the
steady state's completion rate.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

DISTS = ("uniform", "log_uniform")


@dataclasses.dataclass(frozen=True)
class LengthDist:
    dist: str
    min: int
    max: int

    def __post_init__(self) -> None:
        if self.dist not in DISTS:
            raise ValueError(f"length distribution {self.dist!r} is not one of {DISTS}")
        if not 1 <= self.min <= self.max:
            raise ValueError(f"lengths need 1 <= min <= max, got {self.min}..{self.max}")

    def _log_span(self):
        return math.log(self.min), math.log(self.max + 1)

    def quantile(self, u: float) -> int:
        """The length at quantile ``u`` in (0, 1), within [min, max]."""
        if self.dist == "uniform":
            x = self.min + u * (self.max - self.min + 1)
            return min(self.max, int(math.floor(x)))
        lo, hi = self._log_span()
        return min(self.max, int(math.floor(math.exp(lo + u * (hi - lo)))))

    def cdf(self, x: int) -> float:
        """P(length <= x)."""
        if self.dist == "uniform":
            u = (x - self.min + 1) / (self.max - self.min + 1)
        else:
            lo, hi = self._log_span()
            u = (math.log(max(x + 1, 1)) - lo) / (hi - lo)
        return min(1.0, max(0.0, u))

    def stratified(self, n: int) -> List[int]:
        return [self.quantile((i + 0.5) / n) for i in range(n)]

    def residual_stratified(self, n: int) -> List[int]:
        """``n`` stratified quantiles of the steady state's residual length:
        r in 1..max with weight P(length >= r)."""
        cum, acc = [], 0.0
        for r in range(1, self.max + 1):
            acc += 1.0 - self.cdf(r - 1)
            cum.append(acc)
        return [1 + min(self.max - 1, bisect.bisect_left(cum, (i + 0.5) / n * acc))
                for i in range(n)]


@dataclasses.dataclass(frozen=True)
class EngineSpec:
    name: str
    placement: str  # "device" | "host"
    slots: int
    clients: int


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    engines: List[EngineSpec]
    prompt: LengthDist
    output: LengthDist
    max_len: int
    deck: int
    #: MIKU settings (None: no controller), as ``launch/serve.py``'s
    #: ``build_cluster`` sets them.
    miku: Optional[Dict[str, float]]
    window_ns: float

    @property
    def has_host(self) -> bool:
        return any(e.placement == "host" for e in self.engines)


def load_mix(path: Path) -> Mix:
    raw = json.loads(Path(path).read_text())
    engines = [EngineSpec(**e) for e in raw["engines"]]
    for e in engines:
        if e.placement not in ("device", "host"):
            raise ValueError(f"{path}: placement {e.placement!r}")
        if e.slots < 1 or e.clients < 1:
            raise ValueError(f"{path}: an engine needs slots and clients")
    mix = Mix(name=Path(path).stem, engines=engines, prompt=LengthDist(**raw["prompt"]),
              output=LengthDist(**raw["output"]), max_len=int(raw["max_len"]),
              deck=int(raw["deck"]), miku=raw.get("miku"),
              window_ns=float(raw["window_ns"]))
    if mix.prompt.max + mix.output.max >= mix.max_len:
        raise ValueError(f"{path}: max_len {mix.max_len} cannot hold the longest request")
    return mix


class Deck:
    """Stratified lengths dealt in a fixed order (see the module docstring)."""

    def __init__(self, dist: LengthDist, size: int, rng: np.random.Generator):
        self.values = dist.stratified(size)
        self.rng = rng  # the dealing order's, not the cell seed's
        self.order: List[int] = []

    def draw(self) -> int:
        if not self.order:
            self.order = [self.values[i] for i in self.rng.permutation(len(self.values))]
        return self.order.pop()


@dataclasses.dataclass
class Spec:
    """One request as a client sends it."""

    client: int
    prompt: List[int]
    max_new_tokens: int


class ClientPool:
    """The clients of one engine: the warm-up fill and every next request.
    Token ids come from the cell seed and the engine's index; the lengths
    and their order from the engine's index alone."""

    def __init__(self, mix: Mix, engine: int, vocab: int, seed: int):
        self.spec = mix.engines[engine]
        self.vocab = vocab
        self._tok_rng = np.random.default_rng([int(seed) & (2**63 - 1), engine])
        order = np.random.default_rng([engine, 0x0DEC])
        self.prompts = Deck(mix.prompt, mix.deck, np.random.default_rng(order.integers(2**63)))
        self.outputs = Deck(mix.output, mix.deck, np.random.default_rng(order.integers(2**63)))
        warm = mix.output.residual_stratified(self.spec.clients)
        self._warm = [warm[i] for i in order.permutation(self.spec.clients)]

    def _prompt(self) -> List[int]:
        n = self.prompts.draw()
        return self._tok_rng.integers(0, self.vocab, size=n).tolist()

    def warmup(self) -> List[Spec]:
        """One request per client, outputs the steady state's residuals."""
        return [Spec(c, self._prompt(), self._warm[c]) for c in range(self.spec.clients)]

    def next(self, client: int) -> Spec:
        return Spec(client, self._prompt(), self.outputs.draw())
