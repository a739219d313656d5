"""Deterministic synthetic data pipeline with document packing and host
sharding: a copy of ``repro/data/pipeline.py`` (numpy only), so the port's
batches equal the reference's byte for byte.

A seeded Zipf-ish token source generates variable-length "documents",
which are packed into fixed-length training sequences (EOS separators,
greedy first-fit) and sharded per host.  Every host computes its shard
purely from (seed, step, shard_index): no coordination, bit-exact restarts
(checkpoint/resume determinism) and elastic resharding.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np

EOS = 0


@dataclasses.dataclass(frozen=True)
class SyntheticTokenDataset:
    """Zipf-distributed tokens in variable-length documents."""

    vocab: int
    seed: int = 1234
    mean_doc_len: int = 512
    zipf_a: float = 1.3

    def documents(self, shard: int, start_doc: int = 0) -> Iterator[np.ndarray]:
        i = start_doc
        while True:
            rng = np.random.default_rng(
                (self.seed * 1_000_003 + shard) * 1_000_003 + i
            )
            length = max(8, int(rng.exponential(self.mean_doc_len)))
            toks = rng.zipf(self.zipf_a, size=length)
            toks = np.clip(toks, 1, self.vocab - 1).astype(np.int32)
            yield toks
            i += 1


def pack_documents(
    docs: Iterator[np.ndarray], seq_len: int, batch: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy packing into [batch, seq_len+1]; returns (tokens, labels)."""
    rows: List[np.ndarray] = []
    cur: List[int] = []
    need = seq_len + 1
    while len(rows) < batch:
        doc = next(docs)
        pos = 0
        while pos < len(doc) and len(rows) < batch:
            space = need - len(cur)
            take = min(space, len(doc) - pos)
            cur.extend(doc[pos : pos + take].tolist())
            pos += take
            if len(cur) == need:
                rows.append(np.asarray(cur, np.int32))
                cur = []
            elif pos >= len(doc):
                cur.append(EOS)
                if len(cur) == need:
                    rows.append(np.asarray(cur, np.int32))
                    cur = []
    arr = np.stack(rows)  # [B, S+1]
    return arr[:, :-1], arr[:, 1:]


@dataclasses.dataclass
class HostDataLoader:
    """Per-host loader: yields this host's [B_host, S] shard of each global
    batch, deterministically from (seed, step, shard)."""

    dataset: SyntheticTokenDataset
    global_batch: int
    seq_len: int
    shard_index: int = 0
    num_shards: int = 1
    step: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_shards == 0
        return self.global_batch // self.num_shards

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        return self

    def __next__(self) -> Tuple[np.ndarray, np.ndarray]:
        # Each (step, shard) gets a disjoint deterministic document stream.
        stream_id = self.step * self.num_shards + self.shard_index
        docs = self.dataset.documents(shard=stream_id)
        self.step += 1
        return pack_documents(docs, self.seq_len, self.host_batch)

    def state_dict(self) -> dict:
        return {"step": self.step, "shard_index": self.shard_index,
                "num_shards": self.num_shards}

    def load_state_dict(self, d: dict) -> None:
        self.step = int(d["step"])
        # shard/num_shards may legitimately change on elastic resharding.
