"""MigrationEngine: policy decisions → MIGRATE request traffic → page moves.

A copy of ``repro.tiering.engine``; in the port the MIGRATE requests run
on the batched lane's fluid engine, whose twin of this class is
:class:`repro_torch.memsim.batched.tiering.VectorTiering`.

A migration job (move page P from tier S to tier D) is not an instantaneous
bookkeeping flip: the copy must travel the slow link.  Each queued job owes
``reqs_per_page`` best-effort MIGRATE macro-requests on its *traffic tier*
(the slow side of the move: the source of a promotion, the destination of
a demotion), issued by the hook's per-slow-tier migration pseudo-workloads.
The requests occupy ToR entries and station slots, queue behind demand
traffic, are counted in the per-tier window deltas MIKU watches, and obey
MIKU's tier-addressed throttles like any other slow-tier actor.

Only when enough MIGRATE requests have *completed* does the engine retire
the job and flip the page's tier in the :class:`PageMap`, so placement
improvements lag the modeled copy bandwidth, and a throttled migration
path visibly delays them.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, Iterable, Set, Tuple

from repro_torch.tiering.pagemap import PageMap


@dataclasses.dataclass(frozen=True)
class MigrationJob:
    """One page move, in platform tier codes (0 = fast tier)."""

    region: str
    page: int
    src: int
    dst: int

    @property
    def traffic_tier(self) -> int:
        """The slow link the copy crosses: src for promotions, dst for
        demotions (a fast↔slow move always has exactly one slow side)."""
        return self.src if self.src != 0 else self.dst

    @property
    def is_promotion(self) -> bool:
        return self.dst == 0


class MigrationEngine:
    """Per-slow-tier migration job queues + completion-credit accounting.

    ``reqs_per_page`` maps each slow tier code to the MIGRATE macro-requests
    one page copy costs on that tier (page_bytes / bytes-per-macro-request).
    ``on_completions`` consumes completed-request credit FIFO: jobs retire in
    enqueue order, each flipping its page in the PageMap.
    """

    def __init__(self, reqs_per_page: Dict[int, int]) -> None:
        self.reqs_per_page = {
            t: max(1, int(n)) for t, n in reqs_per_page.items()
        }
        self._queues: Dict[int, Deque[MigrationJob]] = {
            t: deque() for t in self.reqs_per_page
        }
        self._credit: Dict[int, int] = {t: 0 for t in self.reqs_per_page}
        self._queued: Set[Tuple[str, int]] = set()
        # Lifetime counters (the per-window deltas are the hook's job).
        self.pages_promoted = 0
        self.pages_demoted = 0
        self.migrated_bytes = 0

    # -- queue management --------------------------------------------------
    def is_queued(self, region: str, page: int) -> bool:
        """Whether this (region, page) already has copy traffic queued."""
        return (region, page) in self._queued

    def queued_promotions(self) -> int:
        """Promotions in flight — they already claim fast-tier capacity."""
        return sum(
            1 for q in self._queues.values() for j in q if j.is_promotion
        )

    def queued_demotions(self) -> int:
        """Demotions in flight — fast-tier pages already on their way out
        (watermark logic must not re-demote for the same occupancy gap)."""
        return sum(
            1 for q in self._queues.values() for j in q if not j.is_promotion
        )

    def enqueue(self, jobs: Iterable[MigrationJob]) -> int:
        """Queue migration jobs (deduped per page); returns how many were
        accepted."""
        n = 0
        for job in jobs:
            key = (job.region, job.page)
            if key in self._queued:
                continue
            tier = job.traffic_tier
            if tier not in self._queues:
                raise KeyError(
                    f"migration job targets slow tier code {tier}, but the "
                    f"engine only carries {sorted(self._queues)}"
                )
            self._queues[tier].append(job)
            self._queued.add(key)
            n += 1
        return n

    def pending_reqs(self, tier_code: int) -> int:
        """MIGRATE macro-requests still owed on one slow tier (issue gate
        for that tier's migration pseudo-workload)."""
        q = self._queues.get(tier_code)
        if not q:
            return 0
        rpp = self.reqs_per_page[tier_code]
        return max(0, len(q) * rpp - self._credit[tier_code])

    def backlog_pages(self) -> int:
        """Pages whose copy traffic has not yet completed."""
        return sum(len(q) for q in self._queues.values())

    # -- completion path ---------------------------------------------------
    def on_completions(
        self, tier_code: int, n_reqs: int, pagemap: PageMap
    ) -> Tuple[int, int]:
        """Credit ``n_reqs`` completed MIGRATE requests on one slow tier;
        retire fully-paid jobs FIFO, flipping their pages.  Returns
        (pages_promoted, pages_demoted) this call."""
        if tier_code not in self._queues:
            return (0, 0)
        self._credit[tier_code] += int(n_reqs)
        rpp = self.reqs_per_page[tier_code]
        q = self._queues[tier_code]
        promoted = demoted = 0
        while q and self._credit[tier_code] >= rpp:
            job = q.popleft()
            self._credit[tier_code] -= rpp
            self._queued.discard((job.region, job.page))
            pagemap.move(job.region, job.page, job.dst)
            self.migrated_bytes += pagemap.regions[job.region].page_bytes
            if job.is_promotion:
                promoted += 1
            else:
                demoted += 1
        if not q:
            # Surplus credit with an empty queue is over-issued traffic (the
            # pseudo-workload drains its outstanding window after the
            # backlog empties) — real overhead, but it pays for no page.
            self._credit[tier_code] = 0
        self.pages_promoted += promoted
        self.pages_demoted += demoted
        return promoted, demoted

    def counters(self) -> Dict[str, int]:
        """Cumulative engine counters (promoted/demoted pages, bytes, backlog)."""
        return {
            "pages_promoted": self.pages_promoted,
            "pages_demoted": self.pages_demoted,
            "migrated_bytes": self.migrated_bytes,
            "backlog_pages": self.backlog_pages(),
        }
