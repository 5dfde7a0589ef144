"""Reshape: adaptive result-aware skew handling (the paper's contribution).

Layout:
  types.py            configs, enums, accounting dataclasses
  skew_test.py        eq. (1)-(2) detection + helper assignment (§2.1)
  estimator.py        mean-model workload estimator psi + stderr eps (§4.3.2)
  partitioner.py      the adaptive partition function (routing table)
  load_transfer.py    SBK/SBR planning, two phases (§3), LR accounting (§4.1)
  adaptive_tau.py     Algorithm 1 + §6.1 migration-time correction
  helpers.py          multi-helper selection chi = min(LR_max, F) (§6.2)
  state_migration.py  mutability -> migration strategy (Fig. 10, §5)
  controller.py       the periodic controller tying it all together
  ops.py              tensor twins of the routing rule (plain PyTorch)
  moe_balancer.py     Reshape on MoE expert routing (SBK migration, SBR
                      replication of a hot expert)
"""
from .types import (
    MigrationStrategy,
    MitigationEvent,
    MitigationPhase,
    ReshapeConfig,
    StateMutability,
    TransferMode,
)
from .skew_test import assign_helpers, skew_pairs, skew_test
from .estimator import MeanModelEstimator, WorkloadTracker
from .partitioner import RoutingTable
from .load_transfer import (
    TransferPlan,
    load_reduction,
    max_load_reduction,
    phase2_fraction,
    phase2_fractions_multi,
    plan_phase1,
    plan_phase2,
    sbk_key_subset,
)
from .adaptive_tau import TauDecision, adjust_tau, tau_prime
from .helpers import HelperChoice, chi_for_helpers, choose_helpers
from .state_migration import (
    OperatorTraits,
    can_scatter,
    choose_mode,
    choose_strategy,
    migration_ticks,
)
from .controller import OperatorAdapter, ReshapeController

__all__ = [
    "MigrationStrategy",
    "MitigationEvent",
    "MitigationPhase",
    "ReshapeConfig",
    "StateMutability",
    "TransferMode",
    "assign_helpers",
    "skew_pairs",
    "skew_test",
    "MeanModelEstimator",
    "WorkloadTracker",
    "RoutingTable",
    "TransferPlan",
    "load_reduction",
    "max_load_reduction",
    "phase2_fraction",
    "phase2_fractions_multi",
    "plan_phase1",
    "plan_phase2",
    "sbk_key_subset",
    "TauDecision",
    "adjust_tau",
    "tau_prime",
    "HelperChoice",
    "chi_for_helpers",
    "choose_helpers",
    "OperatorTraits",
    "can_scatter",
    "choose_mode",
    "choose_strategy",
    "migration_ticks",
    "OperatorAdapter",
    "ReshapeController",
]
