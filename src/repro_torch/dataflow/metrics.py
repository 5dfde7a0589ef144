"""Evaluation metrics from the paper's §7.

  * load-balancing ratio (§7.4): min/max of the tuple totals allotted to a
    skewed worker and its helper, sampled periodically, averaged per run;
  * observed-vs-actual result ratio (§7.2): from the sink's snapshot
    series, |observed(a)/observed(b) − actual| over time;
  * representativeness distance: total-variation distance between the
    visible partial result distribution and the final one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class PairLoadSampler:
    """Periodic sampler of the (S, H) load-balancing ratio (§7.4).

    ``totals_fn`` returns per-worker lifetime received-tuple counts; the
    ratio at a sample is min/max over the pair (higher = more balanced).
    """

    skewed: int
    helper: int
    samples: List[float] = dataclasses.field(default_factory=list)

    def sample(self, received_totals: np.ndarray, baseline: Optional[np.ndarray] = None) -> None:
        a = float(received_totals[self.skewed])
        b = float(received_totals[self.helper])
        if baseline is not None:           # measure only post-detection deltas
            a -= float(baseline[self.skewed])
            b -= float(baseline[self.helper])
        if max(a, b) <= 0:
            return
        self.samples.append(min(a, b) / max(a, b))

    @property
    def average(self) -> float:
        return float(np.mean(self.samples)) if self.samples else 0.0


def ratio_series(
    series: Sequence[Tuple[int, np.ndarray]], key_a: int, key_b: int, actual: float
) -> List[Tuple[int, float]]:
    """|observed a/b − actual| over time from the sink snapshots (§7.2)."""
    out: List[Tuple[int, float]] = []
    for tick, counts in series:
        if counts[key_b] > 0:
            out.append((tick, abs(counts[key_a] / counts[key_b] - actual)))
    return out


def convergence_tick(series, key_a, key_b, actual, tol: float = 0.10) -> Optional[int]:
    """First tick at which the observed ratio is within tol of actual and
    stays there (the paper's 'reached the actual ratio' moment)."""
    diffs = ratio_series(series, key_a, key_b, actual)
    good_from: Optional[int] = None
    for tick, d in diffs:
        if d <= tol * actual:
            if good_from is None:
                good_from = tick
        else:
            good_from = None
    return good_from


def representativeness(series, final_counts: np.ndarray) -> List[Tuple[int, float]]:
    """Total-variation distance of the visible distribution vs final."""
    p = final_counts / max(final_counts.sum(), 1)
    out = []
    for tick, counts in series:
        tot = counts.sum()
        if tot == 0:
            continue
        q = counts / tot
        out.append((tick, 0.5 * float(np.abs(p - q).sum())))
    return out


def area_under(series_xy: Sequence[Tuple[int, float]]) -> float:
    """Trapezoid area of a (tick, value) series: lower = converged sooner."""
    if len(series_xy) < 2:
        return 0.0
    xs = np.array([x for x, _ in series_xy], dtype=np.float64)
    ys = np.array([y for _, y in series_xy], dtype=np.float64)
    return float(np.trapezoid(ys, xs))


def load_reduction_measured(
    unmitigated_totals: Dict[int, float], mitigated_totals: Dict[int, float]
) -> float:
    """LR per §4.1/§6.2 from two runs' per-worker totals."""
    return max(unmitigated_totals.values()) - max(mitigated_totals.values())
