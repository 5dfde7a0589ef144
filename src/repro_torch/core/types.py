"""Shared types and configuration for the Reshape control plane.

Terminology follows the paper:
  * worker      -- one parallel instance of an operator (a mesh shard).
  * skewed (S)  -- computationally overburdened worker.
  * helper (H)  -- worker chosen to share S's load.
  * phi_w       -- workload metric of worker w (unprocessed-queue size).
  * eta         -- absolute-burden threshold (eq. 1).
  * tau         -- workload-gap threshold (eq. 2).
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class TransferMode(enum.Enum):
    """Load-transfer approach (paper §3.1)."""

    SBK = "split_by_keys"      # move whole keys; preserves per-key order
    SBR = "split_by_records"   # split records of a key across workers


class StateMutability(enum.Enum):
    """Keyed-state mutability of an operator phase (paper §5.1)."""

    IMMUTABLE = "immutable"    # e.g. HashJoin probe: state only read
    MUTABLE = "mutable"        # e.g. GroupBy, Sort, HashJoin build


class MigrationStrategy(enum.Enum):
    """State-migration strategy (paper §5.2-5.4, Fig. 10)."""

    REPLICATE = "replicate"        # immutable: copy state, flip routing
    PAUSE_RESUME = "pause_resume"  # mutable + SBK: quiesce, move, resume
    MARKERS = "markers"            # mutable + SBK: marker-synchronized
    SCATTERED = "scattered"        # mutable + SBR: split state, merge at END


class MitigationPhase(enum.Enum):
    """Per (S, H) mitigation state machine (paper §3.2)."""

    IDLE = 0
    MIGRATING = 1   # state transfer in flight (cost modeled, §6.1)
    PHASE_ONE = 2   # catch-up: redirect S's future input to H
    PHASE_TWO = 3   # steady state: split future input by predicted load


@dataclasses.dataclass
class ReshapeConfig:
    """Knobs of the Reshape controller.

    Defaults mirror the paper's experimental setting (§7.1): eta = tau = 100,
    mean-model estimator, one helper per skewed worker.
    """

    eta: float = 100.0                 # eq. (1) absolute threshold
    tau: float = 100.0                 # eq. (2) gap threshold (initial)
    mode: TransferMode = TransferMode.SBR
    # Adaptive-tau (Algorithm 1). `None` bounds disable adaptation.
    adaptive_tau: bool = True
    eps_lower: Optional[float] = 98.0
    eps_upper: Optional[float] = 110.0
    tau_increase: float = 50.0         # fixed increment (paper §7.6)
    max_tau_adjustments: int = 3       # paper allows up to 3 per execution
    # Estimator: how many most-recent ticks form the workload sample.
    sample_window: int = 64
    # Helper selection (§6.2). 1 reproduces the default single-helper mode.
    max_helpers: int = 1
    # Control-message latency in ticks (paper §7.5 injects delays).
    control_delay_ticks: int = 0
    # Collect metrics every `metric_period` ticks (§7.9 overhead study).
    metric_period: int = 1
    # Initial delay before metric collection starts (paper uses 2 s).
    initial_delay_ticks: int = 2
    # Phase-1 implementation: redirect the whole partition of S (True) or
    # only its heaviest key (False) -- the two §3.2 alternatives.
    phase1_full_partition: bool = True
    # Ablation switch for the §7.3 experiment: skip the catch-up phase and
    # go straight to the steady-state split.
    enable_phase1: bool = True
    # Phase-2 tolerance: queues considered "similar" within this fraction.
    catchup_tolerance: float = 0.10
    # §6.1: skip migration when estimated migration time exceeds the
    # estimated remaining execution time.
    migration_time_guard: bool = True
    # Modeled migration throughput (state units per tick) for §6.1/§6.2.
    migration_rate: float = float("inf")
    # Retire a phase-2 mitigation after the pair's workload gap has stayed
    # under tau for this many consecutive metric rounds, freeing the
    # (skewed, helpers) workers for future detections.  None = one full
    # sample window; 0 disables retirement (mitigations stay active until
    # the operator finishes).
    retire_after: Optional[int] = None
    # Experiment harness: force the helper of a given skewed worker
    # (paper §7.2 pins worker 4 / worker 17 as CA's helper).
    pinned_helpers: dict = dataclasses.field(default_factory=dict)
    # Memory-pressure trigger (out-of-core spill tier): run an eager
    # detection round as soon as the device plane posts a mem-pressure
    # event, instead of waiting for the next scheduled metric round.
    # Lowers pressure->mitigation latency at the cost of off-grid
    # rounds (so device-resident controllers refuse to arm under it).
    pressure_rounds: bool = False

    def __post_init__(self) -> None:
        if self.eta < 0 or self.tau < 0:
            raise ValueError("eta and tau must be non-negative")
        if self.adaptive_tau and (self.eps_lower is None or self.eps_upper is None):
            raise ValueError("adaptive_tau requires eps bounds")
        if (
            self.eps_lower is not None
            and self.eps_upper is not None
            and self.eps_lower > self.eps_upper
        ):
            raise ValueError("eps_lower must be <= eps_upper")
        if self.max_helpers < 1:
            raise ValueError("need at least one helper")


@dataclasses.dataclass
class MitigationEvent:
    """One controller decision, kept for accounting / the experiment logs."""

    tick: int
    kind: str                  # "detect" | "phase1" | "phase2" | "tau+" | ...
    skewed: int
    helpers: tuple
    detail: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LoadReductionReport:
    """Load-reduction accounting (paper §4.1, eq. 3).

    LR = max(sigma_S, sigma_H)_unmitigated - max(sigma_S, sigma_H)_mitigated
    where sigma_w is the total input received by worker w over the run.
    """

    unmitigated_max: float
    mitigated_max: float

    @property
    def load_reduction(self) -> float:
        return self.unmitigated_max - self.mitigated_max

    @staticmethod
    def ideal(total_inputs: dict) -> float:
        """LR_max for a skewed worker and its helpers (§6.2).

        ``total_inputs`` maps worker id -> unmitigated total input; the first
        entry is S. LR_max = (f_S - avg(f)) * T expressed in tuples.
        """
        vals = list(total_inputs.values())
        if not vals:
            return 0.0
        s = vals[0]
        return s - sum(vals) / len(vals)
