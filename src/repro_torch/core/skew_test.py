"""Skew detection (paper §2.1).

Worker L is skewed with helper-candidate C iff

    phi_L >= eta                 (1)   -- L is computationally burdened
    phi_L - phi_C >= tau         (2)   -- the gap is big enough to act on

The controller evaluates the test over all ordered worker pairs and then
greedily pairs each skewed worker (most-loaded first) with its least-loaded
unassigned candidate (paper §2.1 "helper workers selection").
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def skew_test(phi_l: float, phi_c: float, eta: float, tau: float) -> bool:
    """Inequalities (1) and (2) for a single (L, C) pair."""
    return phi_l >= eta and (phi_l - phi_c) >= tau


def skew_pairs(
    phi: Sequence[float],
    eta: float,
    tau: float,
    *,
    busy: Sequence[int] = (),
) -> List[Tuple[int, int]]:
    """All (skewed, candidate) pairs passing the skew test.

    ``busy`` marks workers already engaged in a mitigation (either role);
    they are excluded from both sides, matching the controller behaviour
    that one worker participates in at most one transfer at a time.
    """
    phi = np.asarray(phi, dtype=np.float64)
    excluded = set(busy)
    pairs: List[Tuple[int, int]] = []
    for l in range(len(phi)):
        if l in excluded:
            continue
        for c in range(len(phi)):
            if c == l or c in excluded:
                continue
            if skew_test(float(phi[l]), float(phi[c]), eta, tau):
                pairs.append((l, c))
    return pairs


def assign_helpers(
    phi: Sequence[float],
    eta: float,
    tau: float,
    *,
    busy: Sequence[int] = (),
    max_helpers: int = 1,
) -> Dict[int, List[int]]:
    """Greedy skewed->helpers assignment.

    Most-loaded skewed workers pick first; each picks its lowest-workload
    candidates that are not themselves skewed and not already assigned.
    With ``max_helpers == 1`` this is exactly the paper's §2.1 policy; the
    §6.2 multi-helper refinement (cost-aware helper-count choice) is applied
    on top by :mod:`repro_torch.core.helpers`.
    """
    phi = np.asarray(phi, dtype=np.float64)
    pairs = skew_pairs(phi, eta, tau, busy=busy)
    if not pairs:
        return {}
    candidates: Dict[int, List[int]] = {}
    for l, c in pairs:
        candidates.setdefault(l, []).append(c)

    skewed_order = sorted(candidates, key=lambda w: -phi[w])
    taken = set(busy) | set(candidates.keys())  # skewed workers can't help
    out: Dict[int, List[int]] = {}
    for s in skewed_order:
        helpers = [c for c in sorted(candidates[s], key=lambda w: phi[w]) if c not in taken]
        helpers = helpers[:max_helpers]
        if helpers:
            out[s] = helpers
            taken.update(helpers)
    return out
