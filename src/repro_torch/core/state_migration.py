"""State-migration policy (paper §5, Fig. 10) and cost model (§6.1).

The *decision tree*:

  immutable state              -> REPLICATE (copy keyed state, flip routing)
  mutable   state + SBK        -> PAUSE_RESUME or MARKERS (synchronized)
  mutable   state + SBR        -> SCATTERED (no synchronization possible;
                                   partial states merged at END/watermark)

Scattered state is only legal for operators that (1) can merge partial
states and (2) block output until the merge -- `can_scatter` checks both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .types import MigrationStrategy, StateMutability, TransferMode


@dataclasses.dataclass(frozen=True)
class OperatorTraits:
    """Operator phase attributes consulted at workflow-compile time."""

    name: str
    mutability: StateMutability
    # Downstream order requirement forces SBK upstream (paper §3.1(b)).
    order_sensitive_downstream: bool = False
    # Mutable-state mergeability: can partial per-scope states be combined?
    mergeable_state: bool = False
    # Does the operator block output until all input is consumed?
    blocking: bool = False
    prefer_markers: bool = True  # markers over pause-resume when SBK+mutable


def choose_mode(traits: OperatorTraits, requested: TransferMode) -> TransferMode:
    """Result-aware mode choice (§3.1 conclusion).

    SBR is preferred for representative early results *unless* a downstream
    operator imposes an input-order requirement, in which case SBK.
    """
    if traits.order_sensitive_downstream:
        return TransferMode.SBK
    return requested


def can_scatter(traits: OperatorTraits) -> bool:
    """Sufficient conditions for resolving scattered state (§5.4)."""
    return traits.mergeable_state and traits.blocking


def choose_strategy(
    traits: OperatorTraits, mode: TransferMode
) -> Optional[MigrationStrategy]:
    """Fig. 10 decision tree. ``None`` means the combination is illegal."""
    if traits.mutability is StateMutability.IMMUTABLE:
        return MigrationStrategy.REPLICATE
    if mode is TransferMode.SBK:
        return (
            MigrationStrategy.MARKERS
            if traits.prefer_markers
            else MigrationStrategy.PAUSE_RESUME
        )
    # mutable + SBR
    if can_scatter(traits):
        return MigrationStrategy.SCATTERED
    return None


def migration_ticks(
    state_units: float, migration_rate: float, *, per_helper_overhead: float = 0.0,
    n_helpers: int = 1,
) -> float:
    """Estimated migration time M (§6.1).

    Modeled as state volume over a transfer rate plus a per-helper fixed
    cost (§7.11 shows M growing with the helper count: 17 s at 1 helper to
    39 s at 24 helpers).
    """
    if migration_rate <= 0:
        raise ValueError("migration_rate must be positive")
    if migration_rate == float("inf"):
        return per_helper_overhead * n_helpers
    return state_units * n_helpers / migration_rate + per_helper_overhead * n_helpers
