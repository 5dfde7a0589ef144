"""Skew-handling baselines from the paper's evaluation (§7.1).

Flux [48]   — adaptive SBK with fixed granularity: on detection, transfer a
              set of whole keys ("mini-partitions") from the skewed worker
              to its helper.  CANNOT split a single hot key, so with one
              heavy hitter it can only move the small keys off the worker
              (the §7.4 failure mode: LB ratio ~0.06).

Flow-Join [47] — static SBR: sample the first ``detect_ticks`` of input to
              find heavy-hitter keys, then ONCE split each heavy key 50/50
              (round-robin) between its owner and a helper.  Never adapts
              again, and ignores the actual loads — so it over-transfers
              when the helper has its own load, and cannot react to
              distribution changes (§7.8).

Both reuse the engine adapter protocol so they attach to the same operators
as :class:`~repro_torch.core.controller.ReshapeController`.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core import load_transfer
from ..core.skew_test import assign_helpers, skew_test
from ..core.controller import OperatorAdapter
from ..core.state_migration import choose_strategy
from ..core.types import MitigationEvent, ReshapeConfig, TransferMode


class _BaselineController:
    """Shared scaffolding: metric cadence, event log, strategy resolution."""

    mode: TransferMode

    def __init__(self, adapter: OperatorAdapter, cfg: Optional[ReshapeConfig] = None):
        self.adapter = adapter
        self.cfg = cfg or ReshapeConfig()
        self.events: List[MitigationEvent] = []
        self.iterations_total = 0
        self.strategy = choose_strategy(adapter.traits, self.mode)
        self._tick = -1

    def _log(self, tick: int, kind: str, s: int, helpers: Sequence[int], **detail) -> None:
        self.events.append(MitigationEvent(tick=tick, kind=kind, skewed=s,
                                           helpers=tuple(helpers), detail=dict(detail)))

    def _due(self, tick: int) -> bool:
        self._tick = tick
        if tick < self.cfg.initial_delay_ticks:
            return False
        return (tick - self.cfg.initial_delay_ticks) % self.cfg.metric_period == 0

    def metric_messages(self) -> int:
        return self.adapter.num_workers * max(
            0, (self._tick - self.cfg.initial_delay_ticks) // self.cfg.metric_period + 1
        )


class FluxController(_BaselineController):
    """Flux: iterative whole-key transfers (SBK, fixed granularity)."""

    mode = TransferMode.SBK

    def __init__(self, adapter, cfg=None):
        super().__init__(adapter, cfg)
        self.assigned: Dict[int, int] = {}   # skewed -> helper (sticky)

    def step(self, tick: int) -> None:
        if not self._due(tick):
            return
        phi = self.adapter.workloads()
        busy: List[int] = []
        for s, h in self.assigned.items():
            busy.extend((s, h))
        assignment = assign_helpers(
            phi, self.cfg.eta, self.cfg.tau, busy=busy, max_helpers=1
        )
        for s, helpers in assignment.items():
            h = self.cfg.pinned_helpers.get(s, helpers[0])
            self._transfer(tick, s, h, phi)
        # Re-balance sticky pairs when they diverge again (Flux adapts by
        # moving more mini-partitions, still whole keys only).
        for s, h in list(self.assigned.items()):
            if skew_test(phi[s], phi[h], self.cfg.eta, self.cfg.tau):
                self._transfer(tick, s, h, phi)

    def _transfer(self, tick: int, s: int, h: int, phi: np.ndarray) -> None:
        key_shares = self.adapter.key_shares(s)
        total_share = sum(key_shares.values())
        if total_share <= 0:
            return
        # Move keys approximating half the (share-space) gap — but never a
        # fraction of a key: Flux's fixed mini-partition granularity.
        phi_total = max(float(phi.sum()), 1.0)
        gap_share = (phi[s] - phi[h]) / phi_total * total_share
        keys, got = load_transfer.sbk_key_subset(key_shares, gap_share / 2.0)
        # Exclude keys whose share alone dominates: they are the partition
        # anchor (moving the single hot key merely relocates the skew).
        keys = [k for k in keys if key_shares[k] < total_share * 0.5] or keys[:0]
        if not keys:
            self._log(tick, "flux_noop", s, (h,), reason="only-hot-key")
            self.assigned.setdefault(s, h)
            return
        self.adapter.begin_migration(s, [h], self.mode)
        for k in keys:
            self.adapter.routing.move_key(int(k), h)
        self.assigned[s] = h
        self.iterations_total += 1
        self._log(tick, "flux_transfer", s, (h,), keys=len(keys), share=round(got, 4))


class FlowJoinController(_BaselineController):
    """Flow-Join: one-shot heavy-hitter detection, fixed 50/50 SBR split."""

    mode = TransferMode.SBR

    def __init__(self, adapter, cfg=None, *, detect_ticks: int = 2,
                 heavy_multiple: float = 2.0):
        super().__init__(adapter, cfg)
        self.detect_ticks = int(detect_ticks)
        self.heavy_multiple = float(heavy_multiple)
        self.fired = False

    def step(self, tick: int) -> None:
        if self.fired or not self._due(tick):
            return
        if tick < self.cfg.initial_delay_ticks + self.detect_ticks:
            return
        self.fired = True
        routing = self.adapter.routing
        num_workers = self.adapter.num_workers
        phi = self.adapter.workloads()
        # Heavy hitters: key share above heavy_multiple x the fair
        # per-worker share, from the initial sample only.
        shares: Dict[int, float] = {}
        for w in range(num_workers):
            shares.update(self.adapter.key_shares(w))
        fair = 1.0 / num_workers
        heavy = sorted((k for k, v in shares.items() if v >= self.heavy_multiple * fair),
                       key=lambda k: -shares[k])
        heavy_owners = {int(routing.owner[k]) for k in heavy}
        taken: set = set()
        order = np.argsort(phi)  # least-loaded helpers first
        for k in heavy:
            owner = int(routing.owner[k])
            helper = self.cfg.pinned_helpers.get(owner)
            if helper is None:
                helper = next((int(w) for w in order if int(w) != owner
                               and int(w) not in taken and int(w) not in heavy_owners), None)
            if helper is None:
                continue
            taken.add(helper)
            self.adapter.begin_migration(owner, [helper], self.mode)
            # Fixed 50/50 round-robin split, loads not consulted (§7.2).
            routing.split_key(int(k), [owner, helper], [0.5, 0.5])
            self.iterations_total += 1
            self._log(tick, "flowjoin_split", owner, (helper,), key=int(k),
                      share=round(shares[k], 4))
