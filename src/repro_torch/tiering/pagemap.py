"""Page-granularity address-space model: page → tier + decayed hotness.

A copy of ``repro.tiering.pagemap`` (numpy).

A :class:`PageMap` holds one :class:`PageRegion` per tracked workload: an
array of per-page tier assignments (tier *codes* — positions in the
platform's ordered tier list, fast tier first) and an exponentially-decayed
per-page hotness counter, the software analogue of TPP's NUMA-hint-fault /
PEBS access sampling.

Access tracking is *sampled from real station accounting*: each control
window the DES hook feeds the region the number of requests its workload
actually completed, and the region distributes them over its pages per its
access pattern (a drifting hot set — the canonical tiered-memory stressor).
Hotness therefore scales with delivered bandwidth, not with offered load:
a throttled workload generates proportionally fewer promotion signals,
exactly like hint-fault sampling on real hardware.

Placement *re-resolution* closes the loop: the access-weighted per-tier
fractions (:meth:`PageRegion.tier_fractions`) become the workload's live
routing vector, so migrating a page genuinely moves its future accesses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HotSetPattern:
    """A drifting hot-set access distribution over a region's pages.

    ``hot_fraction`` of the pages receive ``hot_weight`` of the accesses
    (uniform within each group); the hot window is circular and advances
    ``drift_pages`` per window — hot-set *drift*, the workload property that
    separates tiering policies (a static placement decays as the hot set
    walks off it; a hotness policy chases it).
    """

    hot_fraction: float = 0.125
    hot_weight: float = 0.9
    drift_pages: float = 0.0
    hot_start: int = 0

    def __post_init__(self) -> None:
        if not 0.0 < self.hot_fraction <= 1.0:
            raise ValueError(f"hot_fraction must be in (0, 1], got "
                             f"{self.hot_fraction}")
        if not 0.0 <= self.hot_weight <= 1.0:
            raise ValueError(f"hot_weight must be in [0, 1], got "
                             f"{self.hot_weight}")


class PageRegion:
    """One workload's pages: tier codes, hotness, and its access pattern."""

    def __init__(
        self,
        name: str,
        n_pages: int,
        page_bytes: int,
        tier_codes: Sequence[int],
        pattern: HotSetPattern,
        n_tiers: int,
        home_slow: int = 1,
    ) -> None:
        if n_pages <= 0:
            raise ValueError(f"region {name!r}: n_pages must be positive")
        self.name = name
        self.n_pages = n_pages
        self.page_bytes = page_bytes
        self.tier = np.asarray(tier_codes, dtype=np.int64).copy()
        if self.tier.shape != (n_pages,):
            raise ValueError(
                f"region {name!r}: {n_pages} pages but "
                f"{self.tier.shape[0]} tier assignments"
            )
        self.hotness = np.zeros(n_pages, dtype=np.float64)
        self.pattern = pattern
        self.n_tiers = n_tiers
        #: Demotion target: the slow tier this region's cold pages fall back
        #: to (its dominant initial slow tier).
        self.home_slow = home_slow
        self._hot_start = float(pattern.hot_start % n_pages)

    # -- access model ------------------------------------------------------
    def access_weights(self) -> np.ndarray:
        """Per-page access probability under the current hot window."""
        n = self.n_pages
        n_hot = max(1, int(round(self.pattern.hot_fraction * n)))
        if n_hot >= n:
            return np.full(n, 1.0 / n)
        w = np.full(n, (1.0 - self.pattern.hot_weight) / (n - n_hot))
        hot_idx = (np.arange(n_hot) + int(self._hot_start)) % n
        w[hot_idx] = self.pattern.hot_weight / n_hot
        return w

    def record_window(self, n_accesses: float, decay: float) -> None:
        """Fold one window's sampled accesses into the hotness counters
        (exponential decay, TPP/Autotiering style), then drift the hot set."""
        self.hotness *= decay
        if n_accesses > 0:
            self.hotness += n_accesses * self.access_weights()
        if self.pattern.drift_pages:
            self._hot_start = (
                self._hot_start + self.pattern.drift_pages
            ) % self.n_pages

    # -- placement views ---------------------------------------------------
    def tier_fractions(self) -> np.ndarray:
        """Access-weighted fraction of this region's traffic per tier code —
        the workload's live routing vector (sums to 1)."""
        return np.bincount(
            self.tier, weights=self.access_weights(), minlength=self.n_tiers
        )

    def resident_pages(self, tier_code: int) -> int:
        """How many of this region's pages currently live on ``tier_code``."""
        return int(np.count_nonzero(self.tier == tier_code))

    def pages_on(self, tier_code: int) -> np.ndarray:
        """Page indices currently resident on ``tier_code``."""
        return np.flatnonzero(self.tier == tier_code)


class PageMap:
    """The tracked address space: regions + the shared fast-tier budget.

    ``fast_capacity_pages`` bounds how many pages (across all regions) the
    fast tier can hold — the capacity pressure that forces watermark
    demotion.  ``move`` is the only mutation path; the migration engine
    calls it when a page's copy traffic has actually completed through the
    modeled stations, so placement lags bandwidth exactly as on hardware.
    """

    def __init__(
        self,
        tier_names: Sequence[str],
        fast_capacity_pages: int,
        decay: float = 0.5,
    ) -> None:
        if len(tier_names) < 2:
            raise ValueError("PageMap needs a fast tier plus >= 1 slow tier")
        self.tier_names: Tuple[str, ...] = tuple(tier_names)
        self.fast_capacity_pages = int(fast_capacity_pages)
        self.decay = float(decay)
        self.regions: Dict[str, PageRegion] = {}

    # -- construction ------------------------------------------------------
    def add_region(
        self,
        name: str,
        n_pages: int,
        page_bytes: int,
        placement: Dict[str, float],
        pattern: Optional[HotSetPattern] = None,
    ) -> PageRegion:
        """Add a region with contiguous initial placement: the first
        ``placement[tier0] * n_pages`` pages on tier 0, the next run on the
        next named tier, and so on (tier order = platform order)."""
        if name in self.regions:
            raise ValueError(f"duplicate region {name!r}")
        unknown = set(placement) - set(self.tier_names)
        if unknown:
            raise ValueError(
                f"region {name!r}: unknown tier(s) {sorted(unknown)}; "
                f"page map tiers are {', '.join(self.tier_names)}"
            )
        total = sum(placement.values())
        if abs(total - 1.0) > 1e-6:
            raise ValueError(
                f"region {name!r}: placement fractions sum to {total}, "
                "expected 1.0"
            )
        # Cumulative-boundary assignment: per-tier runs are the rounded
        # cumulative fractions, so counts always sum to exactly n_pages (no
        # per-tier rounding drift, no truncated final run) and slow_counts
        # reflects the pages actually assigned.
        codes = np.zeros(n_pages, dtype=np.int64)
        bounds = []
        acc = 0.0
        for tier in self.tier_names:
            acc += placement.get(tier, 0.0)
            bounds.append(int(round(acc * n_pages)))
        bounds[-1] = n_pages  # absorb the validated <=1e-6 residue exactly
        start = 0
        slow_counts: Dict[int, int] = {}
        for code, end in enumerate(bounds):
            end = max(start, min(end, n_pages))
            codes[start:end] = code
            if code > 0 and end > start:
                slow_counts[code] = end - start
            start = end
        home = max(slow_counts, key=slow_counts.get) if slow_counts else 1
        region = PageRegion(
            name, n_pages, page_bytes, codes,
            pattern or HotSetPattern(), len(self.tier_names), home_slow=home,
        )
        self.regions[name] = region
        return region

    # -- accounting --------------------------------------------------------
    def record_window(self, name: str, n_accesses: float) -> None:
        """Feed one window's sampled accesses into region ``name``'s hotness."""
        self.regions[name].record_window(n_accesses, self.decay)

    def fast_pages_used(self) -> int:
        """Total pages resident on the fast tier across all regions."""
        return sum(r.resident_pages(0) for r in self.regions.values())

    def fast_fraction(self, name: str) -> float:
        """Access-weighted fraction of a region's traffic on the fast tier."""
        return float(self.regions[name].tier_fractions()[0])

    def placement_fractions(self, name: str) -> Dict[str, float]:
        """Region ``name``'s live access-weighted tier fractions, by tier name."""
        fr = self.regions[name].tier_fractions()
        return {t: float(fr[i]) for i, t in enumerate(self.tier_names)}

    def move(self, name: str, page: int, dst_code: int) -> None:
        """Flip one page's resident tier (called on migration completion)."""
        self.regions[name].tier[page] = dst_code

    def occupancy(self) -> Dict[str, int]:
        """Resident page counts per tier name, across regions."""
        out = {t: 0 for t in self.tier_names}
        for r in self.regions.values():
            for code, t in enumerate(self.tier_names):
                out[t] += r.resident_pages(code)
        return out
