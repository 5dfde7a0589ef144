"""Skew-aware token data pipeline.

Documents have wildly varying lengths (a Zipf-ish distribution — the same
heavy-tail shape as Fig. 15). Packing them naively onto data-parallel
shards yields *padding skew*: some shards carry long documents and others
mostly padding, so the slowest shard gates every synchronous step.

This is partitioning skew with keys = length buckets, and the pipeline
reuses the paper's machinery directly: a :class:`RoutingTable` over length
buckets routes documents to shards, a ReshapeController-style monitor
watches per-shard queued-token counts (phi) and rewrites the table
(SBR: a bucket's documents split across shards by fraction).

The port's copy of ``repro.data.pipeline`` (numpy only), on the port's
``RoutingTable`` and ``assign_helpers``: the same batches from the same
seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.partitioner import RoutingTable
from ..core.skew_test import assign_helpers


@dataclasses.dataclass
class PipelineConfig:
    seq_len: int = 1024
    batch_per_shard: int = 4
    n_shards: int = 8
    n_buckets: int = 8
    vocab: int = 50_000
    eta_tokens: float = 4_096.0
    tau_tokens: float = 2_048.0
    seed: int = 0


def zipf_doc_lengths(n: int, seq_len: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.3, n)
    return np.clip(raw * 16, 16, seq_len).astype(np.int64)


class SkewAwarePipeline:
    """Routes documents (keyed by length bucket) to DP shards; rebalances
    with Reshape when a shard's queued-token backlog runs ahead."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.routing = RoutingTable(cfg.n_buckets, cfg.n_shards, init="hash")
        self.queues: List[List[np.ndarray]] = [[] for _ in range(cfg.n_shards)]
        self.queued_tokens = np.zeros(cfg.n_shards)
        self.rng = np.random.default_rng(cfg.seed)
        self.rebalances = 0

    def _bucket(self, length: int) -> int:
        edges = np.linspace(0, self.cfg.seq_len, self.cfg.n_buckets + 1)[1:-1]
        return int(np.searchsorted(edges, length))

    def ingest(self, lengths: np.ndarray) -> None:
        buckets = np.array([self._bucket(l) for l in lengths], dtype=np.int64)
        dests = self.routing.route_chunk(buckets)
        for l, d in zip(lengths, dests):
            doc = self.rng.integers(0, self.cfg.vocab, size=int(l))
            self.queues[int(d)].append(doc)
            self.queued_tokens[int(d)] += int(l)
        self._maybe_rebalance()

    def _maybe_rebalance(self) -> None:
        phi = self.queued_tokens.copy()
        assignment = assign_helpers(phi, self.cfg.eta_tokens,
                                    self.cfg.tau_tokens, max_helpers=1)
        for s, helpers in assignment.items():
            h = helpers[0]
            # SBR phase-2 style: split every bucket routed to s by the
            # load-equalizing fraction r = (phi_s - phi_h) / (2 phi_s).
            r = float(np.clip((phi[s] - phi[h]) / (2 * max(phi[s], 1e-9)),
                              0.0, 1.0))
            if r <= 0.02:
                continue
            for k in self.routing.keys_of(int(s)):
                row = self.routing.weights[int(k)].copy()
                moved = row[int(s)] * r
                row[int(s)] -= moved
                row[int(h)] += moved
                self.routing.restore_keys([int(k)], row[None])
            self.rebalances += 1

    def next_batch(self) -> Optional[Dict[str, np.ndarray]]:
        """Pack one [n_shards * batch_per_shard, seq_len] batch (padded)."""
        cfg = self.cfg
        B = cfg.n_shards * cfg.batch_per_shard
        tokens = np.zeros((B, cfg.seq_len), dtype=np.int32)
        mask = np.zeros((B, cfg.seq_len), dtype=np.int32)
        row = 0
        for s in range(cfg.n_shards):
            for _ in range(cfg.batch_per_shard):
                filled = 0
                while self.queues[s] and filled < cfg.seq_len:
                    doc = self.queues[s][0]
                    take = min(len(doc), cfg.seq_len - filled)
                    tokens[row, filled:filled + take] = doc[:take]
                    mask[row, filled:filled + take] = 1
                    filled += take
                    if take == len(doc):
                        self.queues[s].pop(0)
                    else:
                        self.queues[s][0] = doc[take:]
                    self.queued_tokens[s] -= take
                row += 1
        if mask.sum() == 0:
            return None
        labels = np.roll(tokens, -1, axis=1)
        return {"tokens": tokens, "labels": labels, "mask": mask}

    def padding_skew(self) -> float:
        """Max/mean queued tokens across shards (1.0 = perfectly even)."""
        mean = self.queued_tokens.mean()
        return float(self.queued_tokens.max() / max(mean, 1e-9))
