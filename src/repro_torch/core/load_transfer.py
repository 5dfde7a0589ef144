"""Two-phase, result-aware load transfer (paper §3) + LR accounting (§4.1).

Phase 1 ("catch-up") removes the *existing* queue imbalance by redirecting
the skewed worker's future input to the helper(s); phase 2 installs a steady
split so future arrivals stay balanced.  The split planning lives here; the
*when* (detection, phase transitions, iterations) lives in
:mod:`repro_torch.core.controller`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .partitioner import RoutingTable
from .types import TransferMode


# --------------------------------------------------------------------- #
# Phase-2 split math                                                     #
# --------------------------------------------------------------------- #
def phase2_fraction(f_s: float, f_h: float) -> float:
    """Fraction r of S's future input to redirect to a single helper H.

    Equalizes future arrivals: ``f_s*(1-r) = f_h + f_s*r`` giving
    ``r = (f_s - f_h) / (2 f_s)``.  The paper's running example
    (J6:J4 = 26:7) yields r = 19/52 ~= 9/26, i.e. "redirect 9 out of every
    26 tuples" (§3.1).  Clamped to [0, 1]; r = 0 when S is not ahead.
    """
    if f_s <= 0:
        return 0.0
    return float(np.clip((f_s - f_h) / (2.0 * f_s), 0.0, 1.0))


def phase2_fractions_multi(f_s: float, f_helpers: Sequence[float]) -> List[float]:
    """Per-helper redirect fractions for the §6.2 multi-helper setting.

    Every participant should end at the average share
    ``avg = (f_s + sum(f_helpers)) / (n+1)``; helper i receives
    ``max(avg - f_h_i, 0)`` of the operator input, expressed as a fraction
    of S's input.
    """
    f_h = np.asarray(f_helpers, dtype=np.float64)
    n = len(f_h)
    if n == 0 or f_s <= 0:
        return []
    avg = (f_s + f_h.sum()) / (n + 1)
    gives = np.clip(avg - f_h, 0.0, None)
    total = gives.sum()
    max_total = max(f_s - avg, 0.0)
    if total > max_total > 0:
        gives *= max_total / total  # S cannot give more than it has above avg
    return [float(g / f_s) for g in gives]


def sbk_key_subset(
    key_shares: Dict[int, float], target: float
) -> Tuple[List[int], float]:
    """Greedy subset of S's keys whose summed share approaches ``target``.

    SBK cannot split a key, so the best it can do is a subset-sum
    approximation: take keys in descending share order while they fit.
    Returns (keys, achieved_share).  When one heavy-hitter key dominates,
    the achieved share is far below target -- exactly the Flux failure mode
    the paper demonstrates (§7.4).
    """
    chosen: List[int] = []
    acc = 0.0
    for k, share in sorted(key_shares.items(), key=lambda kv: -kv[1]):
        if share <= 0:
            continue
        if acc + share <= target + 1e-12:
            chosen.append(k)
            acc += share
    return chosen, acc


# --------------------------------------------------------------------- #
# Plans: pure descriptions of a routing-table rewrite                    #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class TransferPlan:
    """A planned routing-table rewrite for one (S, helpers) mitigation."""

    mode: TransferMode
    skewed: int
    helpers: Tuple[int, ...]
    keys: Tuple[int, ...]              # keys whose rows are rewritten
    rows: np.ndarray                   # [len(keys), num_workers] stochastic
    # Expected share of the *operator's* future input that moves off S.
    moved_share: float = 0.0

    def apply(self, table: RoutingTable) -> None:
        table.restore_keys(list(self.keys), self.rows)


def plan_phase1(
    table: RoutingTable,
    skewed: int,
    helpers: Sequence[int],
    *,
    full_partition: bool = True,
    key_shares: Optional[Dict[int, float]] = None,
) -> TransferPlan:
    """Catch-up plan: future input of S -> helpers (round-robin across them).

    ``full_partition=False`` redirects only S's heaviest key (the
    reduced-state-transfer alternative of §3.2); it needs ``key_shares``.
    """
    owned = table.owned_by(skewed)
    if full_partition or key_shares is None:
        keys = [int(k) for k in owned if table.weights[k, skewed] > 0]
    else:
        owned_shares = {int(k): key_shares.get(int(k), 0.0) for k in owned}
        keys = [max(owned_shares, key=owned_shares.get)] if owned_shares else []
    rows = np.zeros((len(keys), table.num_workers), dtype=np.float64)
    for i, k in enumerate(keys):
        h = helpers[i % len(helpers)]
        rows[i] = table.weights[k]
        rows[i, h] += rows[i, skewed]
        rows[i, skewed] = 0.0
    moved = 0.0
    if key_shares:
        moved = sum(key_shares.get(k, 0.0) for k in keys)
    return TransferPlan(
        mode=TransferMode.SBR,  # phase 1 is mode-agnostic; rows are one-hot
        skewed=skewed,
        helpers=tuple(helpers),
        keys=tuple(keys),
        rows=rows,
        moved_share=moved,
    )


def plan_phase2(
    table: RoutingTable,
    skewed: int,
    helpers: Sequence[int],
    shares: np.ndarray,
    *,
    mode: TransferMode,
    key_shares: Optional[Dict[int, float]] = None,
) -> TransferPlan:
    """Steady-state plan from predicted worker shares ``shares`` (f_hat).

    SBR: every key owned by S is split ``1-r`` to S and ``r_i`` to helper i.
    SBK: a greedy key subset moves wholly to the helper(s).

    ``shares`` are the *unmitigated* predicted shares (what each worker's
    partition would receive), so the plan is computed from owner-attributed
    load even while a phase-1 redirect is active.
    """
    owned = [int(k) for k in table.owned_by(skewed)]
    f_s = float(shares[skewed])
    if mode is TransferMode.SBR:
        fracs = phase2_fractions_multi(f_s, [float(shares[h]) for h in helpers])
        keep = 1.0 - sum(fracs)
        rows = np.zeros((len(owned), table.num_workers), dtype=np.float64)
        for i, _ in enumerate(owned):
            rows[i, skewed] = keep
            for h, r in zip(helpers, fracs):
                rows[i, h] += r
        return TransferPlan(
            mode=mode,
            skewed=skewed,
            helpers=tuple(helpers),
            keys=tuple(owned),
            rows=rows,
            moved_share=f_s * sum(fracs),
        )

    # SBK: move whole keys.
    if key_shares is None:
        key_shares = {k: f_s / max(len(owned), 1) for k in owned}
    within = {k: key_shares.get(k, 0.0) for k in owned}
    per_helper_target = (
        phase2_fractions_multi(f_s, [float(shares[h]) for h in helpers])
    )
    keys_out: List[int] = []
    rows_out: List[np.ndarray] = []
    moved_total = 0.0
    remaining = dict(within)
    for h, r in zip(helpers, per_helper_target):
        target = r * f_s
        chosen, got = sbk_key_subset(remaining, target)
        for k in chosen:
            row = np.zeros(table.num_workers, dtype=np.float64)
            row[h] = 1.0
            keys_out.append(k)
            rows_out.append(row)
            remaining.pop(k, None)
        moved_total += got
    # Keys staying with S revert to one-hot on S (undo phase-1 redirect).
    for k in remaining:
        row = np.zeros(table.num_workers, dtype=np.float64)
        row[skewed] = 1.0
        keys_out.append(k)
        rows_out.append(row)
    rows = (
        np.stack(rows_out)
        if rows_out
        else np.zeros((0, table.num_workers), dtype=np.float64)
    )
    return TransferPlan(
        mode=mode,
        skewed=skewed,
        helpers=tuple(helpers),
        keys=tuple(keys_out),
        rows=rows,
        moved_share=moved_total,
    )


# --------------------------------------------------------------------- #
# Load-reduction accounting (§4.1, §6.2)                                 #
# --------------------------------------------------------------------- #
def load_reduction(
    unmitigated_totals: Dict[int, float],
    mitigated_totals: Dict[int, float],
) -> float:
    """LR = max(sigma)_unmitigated - max(sigma)_mitigated over S+helpers."""
    if not unmitigated_totals or not mitigated_totals:
        return 0.0
    return max(unmitigated_totals.values()) - max(mitigated_totals.values())


def max_load_reduction(unmitigated_totals: Dict[int, float]) -> float:
    """LR_max = (f_S - avg(f)) * T : ideal equalization (§4.1/§6.2)."""
    vals = np.asarray(list(unmitigated_totals.values()), dtype=np.float64)
    if vals.size == 0:
        return 0.0
    return float(vals.max() - vals.mean())
