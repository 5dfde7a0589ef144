"""Helper-count selection under state-migration cost (paper §6.2).

Adding helpers raises the ideal load reduction LR_max (the average share
falls) but also raises the state-migration time M, which shrinks
``F = (L - M*t) * f_hat_S`` -- the future S-tuples still available for
transfer once migration completes.  The achievable reduction is
``chi = min(LR_max, F)``; we add helpers while chi improves and stop right
before it starts decreasing (Figure 13).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class HelperChoice:
    helpers: List[int]
    chi: float
    lr_max: float
    future_tuples: float
    migration_ticks: float


def chi_for_helpers(
    f_hat: np.ndarray,
    skewed: int,
    helpers: Sequence[int],
    *,
    tuples_left: float,
    rate: float,
    migration_ticks: float,
) -> Tuple[float, float, float]:
    """Return (chi, LR_max, F) for a candidate helper set.

    Args:
      f_hat: predicted workload shares of all workers.
      tuples_left: L, future tuples to be processed by the operator.
      rate: t, tuples processed per tick by the operator.
      migration_ticks: M, estimated state-migration time for this set.
    """
    members = [skewed, *helpers]
    shares = f_hat[members]
    lr_max = float((shares[0] - shares.mean()) * tuples_left)
    future = max(tuples_left - migration_ticks * rate, 0.0) * float(f_hat[skewed])
    return min(lr_max, future), lr_max, future


def choose_helpers(
    f_hat: np.ndarray,
    skewed: int,
    candidates: Sequence[int],
    *,
    tuples_left: float,
    rate: float,
    migration_ticks_fn: Callable[[int], float],
    max_helpers: int,
) -> HelperChoice:
    """Greedy §6.2 scan: add candidates (ascending workload) while chi rises.

    ``migration_ticks_fn(n)`` models M as a function of the helper count --
    more helpers means more replicas/partitions of S's state to ship.
    """
    order = sorted(candidates, key=lambda w: f_hat[w])
    best = HelperChoice([], 0.0, 0.0, 0.0, 0.0)
    current: List[int] = []
    for cand in order[:max_helpers]:
        trial = current + [cand]
        m = float(migration_ticks_fn(len(trial)))
        chi, lr_max, fut = chi_for_helpers(
            f_hat,
            skewed,
            trial,
            tuples_left=tuples_left,
            rate=rate,
            migration_ticks=m,
        )
        if chi < best.chi - 1e-12:
            break  # chi started decreasing: stop right before (Fig. 13)
        current = trial
        best = HelperChoice(list(trial), chi, lr_max, fut, m)
    return best
