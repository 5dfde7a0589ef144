"""Dynamic adjustment of the skew-detection threshold tau (paper §4.3, §6.1).

Algorithm 1: keep the estimator's standard error eps inside a user range
[eps_l, eps_u].

  * skew-test passes but eps > eps_u  -> the sample is too small for a good
    phase-2 split; mitigate now but RAISE tau for the next iteration.
  * skew-test fails  and eps < eps_l  -> the sample is already good; waiting
    for the gap to reach tau would squander future tuples, so LOWER tau to
    the current gap and start mitigation right away.

§6.1 correction: when state migration takes M ticks, detection must fire
early so the *transfer* starts at the intended gap:
``tau' = tau - (f_hat_S - f_hat_H) * t * M``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .types import ReshapeConfig


@dataclasses.dataclass
class TauDecision:
    tau: float                   # threshold to use going forward
    action: str                  # "increase" | "decrease" | "keep"
    mitigate_now: bool           # decrease-branch fires mitigation directly


def adjust_tau(
    phi_s: float,
    phi_h: float,
    eps: float,
    tau: float,
    cfg: ReshapeConfig,
    *,
    adjustments_used: int = 0,
) -> TauDecision:
    """One evaluation of Algorithm 1 for an (S, H) pair."""
    if not cfg.adaptive_tau or adjustments_used >= cfg.max_tau_adjustments:
        return TauDecision(tau, "keep", phi_s - phi_h >= tau and phi_s >= cfg.eta)

    gap = phi_s - phi_h
    passes = gap >= tau and phi_s >= cfg.eta

    if passes and eps > cfg.eps_upper:
        # Mitigate now (we cannot un-detect), but demand a bigger sample
        # next iteration: tau += fixed increment (paper §7.6 uses +50).
        return TauDecision(tau + cfg.tau_increase, "increase", True)

    if not passes and eps < cfg.eps_lower and gap > 0 and phi_s >= cfg.eta:
        # Sample already good: drop tau to the current gap, fire now.
        return TauDecision(max(gap, 1e-9), "decrease", True)

    return TauDecision(tau, "keep", passes)


def tau_prime(
    tau_n: float,
    f_hat_s: float,
    f_hat_h: float,
    rate: float,
    migration_ticks: float,
) -> float:
    """§6.1: earlier effective threshold under migration time M.

    The gap keeps widening at ``(f_hat_s - f_hat_h) * rate`` per tick while
    state is in flight; detect early by exactly that much.
    """
    widen = max(f_hat_s - f_hat_h, 0.0) * rate * migration_ticks
    return max(tau_n - widen, 0.0)
