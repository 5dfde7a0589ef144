"""Workload estimation (paper §3.2, §4.3.2).

The controller keeps a sliding sample of per-worker workload observations and
predicts each worker's *future incoming workload share* with a mean-model
estimator psi (the paper's choice, §7.1).  The estimator also reports its
standard error of prediction

    eps = d * sqrt(1 + 1/n)          (mean model, [44, 51])

which Algorithm 1 uses to steer tau: a small sample gives a large eps (bad
phase-2 split), a large sample gives a small eps but risks starting too late.
"""
from __future__ import annotations

import collections
import math
from typing import Deque, Iterable, Sequence, Tuple

import numpy as np


def seq_sum(values: Iterable[float]) -> float:
    """Canonical strictly-sequential (left-to-right) float64 sum.

    Every statistic the controller's decisions depend on — the sample
    mean, the standard error, the predicted-share normalizer — funnels
    through this one reduction so the device-resident controller twin
    (:mod:`repro.dataflow.device`) can replicate it bit-for-bit with a
    fixed-order masked accumulation.  ``np.sum``/``np.mean`` use pairwise
    blocking, which XLA cannot be forced to reproduce; a plain sequential
    chain of IEEE-754 adds can.
    """
    acc = 0.0
    for v in values:
        acc += float(v)
    return acc


class MeanModelEstimator:
    """Mean-model workload estimator for one worker.

    Observations are *increments* of received workload per tick (arrival
    counts), so the mean predicts the future arrival rate.
    """

    def __init__(self, window: int = 64):
        if window < 2:
            raise ValueError("window must be >= 2")
        self.window = window
        self._obs: Deque[float] = collections.deque(maxlen=window)

    def observe(self, value: float) -> None:
        self._obs.append(float(value))

    def reset(self) -> None:
        """Drop the sample (paper §4.3.1: restart sampling at each t_i)."""
        self._obs.clear()

    @property
    def n(self) -> int:
        return len(self._obs)

    def predict(self) -> float:
        """Predicted future per-tick workload (the sample mean).

        Computed with the canonical sequential sum (:func:`seq_sum`) so
        the device-resident controller reproduces it bit-for-bit.
        """
        if not self._obs:
            return 0.0
        return seq_sum(self._obs) / len(self._obs)

    def stderr(self) -> float:
        """Standard error of prediction, eps = d*sqrt(1+1/n).

        Returns +inf with fewer than two observations: an empty sample
        cannot justify a phase-2 split.  Uses the same sequential
        mean / sum-of-squared-deviations order as the device twin.
        """
        n = len(self._obs)
        if n < 2:
            return float("inf")
        mean = seq_sum(self._obs) / n
        ssq = seq_sum((v - mean) * (v - mean) for v in self._obs)
        d = math.sqrt(ssq / (n - 1))
        return d * math.sqrt(1.0 + 1.0 / n)


class WorkloadTracker:
    """Per-operator tracker: one estimator per worker + current workloads.

    ``phi`` is the instantaneous workload metric (unprocessed-queue size,
    paper §2.1); ``rate`` estimators model future arrivals for phase 2.
    """

    def __init__(self, num_workers: int, window: int = 64):
        self.num_workers = num_workers
        self.phi = np.zeros(num_workers, dtype=np.float64)
        self.received_total = np.zeros(num_workers, dtype=np.float64)
        self._estimators = [MeanModelEstimator(window) for _ in range(num_workers)]
        #: prediction horizon: tuples of operator input per unit workload
        #: (the paper predicts per 2,000 input tuples, §7.6).
        self.horizon = 2000.0

    def update(self, phi: Sequence[float], arrived: Sequence[float]) -> None:
        """Record one metric-collection round.

        Args:
          phi: current unprocessed-queue sizes, one per worker.
          arrived: tuples received since the previous round, one per worker
            (owner-attributed). Converted to per-horizon shares before being
            fed to the estimators — the paper's §7.6 setting models the
            workload as "the expected number of tuples in the next 2,000
            tuples", which is also the scale of the eps range [98, 110].
            Rounds with no arrivals keep the existing sample.
        """
        phi = np.asarray(phi, dtype=np.float64)
        arrived = np.asarray(arrived, dtype=np.float64)
        if phi.shape != (self.num_workers,) or arrived.shape != (self.num_workers,):
            raise ValueError("metric vectors must have one entry per worker")
        self.phi = phi
        self.received_total += arrived
        total = seq_sum(arrived)
        if total > 0:
            scaled = arrived * (self.horizon / total)
            for est, a in zip(self._estimators, scaled):
                est.observe(float(a))

    def reset_samples(self, workers: Sequence[int]) -> None:
        for w in workers:
            self._estimators[w].reset()

    def predicted_rates(self) -> np.ndarray:
        return np.array([e.predict() for e in self._estimators])

    def predicted_shares(self) -> np.ndarray:
        """f_hat_w: predicted fraction of the operator's future input."""
        rates = self.predicted_rates()
        total = seq_sum(rates)
        if total <= 0:
            return np.full(self.num_workers, 1.0 / self.num_workers)
        return rates / total

    def stderr_pair(self, s: int, h: int) -> float:
        """eps for the (S, H) pair: the worst of the two estimators.

        The phase-2 split is only as good as the *least* certain of the two
        predictions, so the controller keys Algorithm 1 off the max.
        """
        return max(self._estimators[s].stderr(), self._estimators[h].stderr())

    def sample_size(self, w: int) -> int:
        return self._estimators[w].n
