"""The Reshape controller (paper §2, §4).

The controller is host-side logic that, once per metric period:

  1. collects per-worker workload metrics (unprocessed-queue sizes) and
     owner-attributed arrival counts,
  2. advances every active (S, helpers) mitigation state machine
     (MIGRATING -> PHASE_ONE -> PHASE_TWO -> possibly a new iteration),
  3. runs the skew test (with the adaptive tau of Algorithm 1 and the §6.1
     migration-time correction) over the remaining workers and starts new
     mitigations.

Routing-table rewrites are *control messages*: they are queued and become
visible to the data plane only after ``control_delay_ticks`` (paper §7.5
studies exactly this latency).  The controller never touches tuple data --
it only swaps the partition function, which in the JAX setting is a traced
array argument of the jitted step (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from . import adaptive_tau, load_transfer
from .skew_test import assign_helpers
from .estimator import WorkloadTracker
from .helpers import choose_helpers
from .partitioner import RoutingTable
from .state_migration import OperatorTraits, choose_mode, choose_strategy, migration_ticks
from .types import (
    MitigationEvent,
    MitigationPhase,
    ReshapeConfig,
    TransferMode,
)


class OperatorAdapter(Protocol):
    """What the controller needs from a skew-prone operator.

    Implemented by the dataflow engine (queue-based workers) and by the MoE
    balancer (expert shards).
    """

    num_workers: int
    traits: OperatorTraits
    routing: RoutingTable  # partition function at the *previous* operator

    def workloads(self) -> np.ndarray:
        """phi_w: current unprocessed-queue size per worker."""
        ...

    def arrivals_by_owner(self) -> np.ndarray:
        """Owner-attributed arrivals since the last collection.

        Attribution by the key's *owner* (pre-mitigation primary) keeps the
        phase-2 share prediction unbiased while a phase-1 redirect is live.
        """
        ...

    def key_shares(self, worker: int) -> Dict[int, float]:
        """Observed input share per key owned by ``worker``."""
        ...

    def state_units(self, worker: int, mode: TransferMode) -> float:
        """Size of the keyed state that a mitigation would migrate."""
        ...

    def begin_migration(
        self, skewed: int, helpers: Sequence[int], mode: TransferMode
    ) -> None:
        """Kick off the state transfer (REPLICATE / MARKERS / SCATTERED)."""
        ...

    def tuples_left(self) -> float:
        """Estimated future tuples the operator will still receive (L)."""
        ...

    def processing_rate(self) -> float:
        """t: tuples the operator processes per tick (all workers)."""
        ...


@dataclasses.dataclass
class _Mitigation:
    skewed: int
    helpers: List[int]
    mode: TransferMode
    phase: MitigationPhase
    migration_end: float = 0.0
    iteration: int = 1
    phase1_keys: Tuple[int, ...] = ()
    calm_rounds: int = 0    # consecutive phase-2 rounds with gap < tau


@dataclasses.dataclass
class _PendingUpdate:
    apply_at: int
    plan: load_transfer.TransferPlan


class ReshapeController:
    """Adaptive skew handling for one operator (paper §2-§6)."""

    def __init__(
        self,
        adapter: OperatorAdapter,
        cfg: Optional[ReshapeConfig] = None,
    ):
        self.adapter = adapter
        self.cfg = cfg or ReshapeConfig()
        self.tracker = WorkloadTracker(adapter.num_workers, self.cfg.sample_window)
        self.tau = float(self.cfg.tau)
        self.tau_adjustments = 0
        self.mitigations: Dict[int, _Mitigation] = {}
        self.events: List[MitigationEvent] = []
        self.iterations_total = 0
        self._pending: List[_PendingUpdate] = []
        self._tick = -1
        #: metric rounds executed in-dispatch by a device-resident twin
        #: (no per-round O(W) host metric messages for those rounds).
        self.rounds_on_device = 0
        #: boundary readbacks on the device plane: each ``sync_stats``
        #: drain that feeds this controller is one O(W) transfer and is
        #: accounted like a metric-collection round.
        self.sync_readbacks = 0
        #: memory-pressure mitigation hook (out-of-core tiering): the
        #: device plane posts ``(worker, tick)`` here when an edge
        #: crosses its spill high watermark — a skew split of the fat
        #: worker sheds exactly the partition whose growth forced the
        #: spill.  Pending events are consumed at the next metric round
        #: (or eagerly, with ``cfg.pressure_rounds``) and counted in
        #: ``pressure_consumed``.
        self.pressure_events: List[tuple] = []
        self.pressure_consumed = 0
        # Resolve the transfer mode once, at "workflow compile time" (§3.1).
        self.mode = choose_mode(adapter.traits, self.cfg.mode)
        self.strategy = choose_strategy(adapter.traits, self.mode)
        if self.strategy is None:
            # Illegal combination (mutable + SBR, non-mergeable): fall back
            # to SBK, which is always safe.
            self.mode = TransferMode.SBK
            self.strategy = choose_strategy(adapter.traits, self.mode)

    # ------------------------------------------------------------------ #
    # Public API                                                          #
    # ------------------------------------------------------------------ #
    @property
    def busy_workers(self) -> List[int]:
        out: List[int] = []
        for m in self.mitigations.values():
            out.append(m.skewed)
            out.extend(m.helpers)
        return out

    def note_memory_pressure(self, worker: int, tick: int) -> None:
        """Device-plane spill hook: ``worker`` crossed its edge's high
        watermark at ``tick``.  Recording is decision-neutral (the skew
        test itself is unchanged); consumption happens at the next
        metric round, or immediately eager when ``cfg.pressure_rounds``
        is set (the mitigation-latency knob)."""
        self.pressure_events.append((int(worker), int(tick)))

    def step(self, tick: int) -> None:
        """One controller round. Call every engine tick."""
        self._tick = tick
        self._flush_control_messages(tick)
        if tick < self.cfg.initial_delay_ticks:
            return
        eager = bool(self.cfg.pressure_rounds) and bool(self.pressure_events)
        if (tick - self.cfg.initial_delay_ticks) % self.cfg.metric_period != 0:
            if not eager:
                return
        if self.pressure_events:
            # Consume pending mem-pressure triggers: the metric round
            # below already re-ranks workloads, so the fat worker the
            # spill flagged is exactly the one the skew test examines.
            self.pressure_consumed += len(self.pressure_events)
            self.pressure_events.clear()
        self.tracker.update(self.adapter.workloads(), self.adapter.arrivals_by_owner())
        self._advance_mitigations(tick)
        self._detect(tick)

    def metric_messages(self) -> int:
        """Metric-collection traffic so far (for the §7.9 overhead study).

        Host plane: one O(W) message set per metric round.  Device plane:
        a metric round that drains ``sync_stats()`` is one O(W) readback,
        not free — each boundary drain counts like a round
        (``sync_readbacks``), while rounds the device-resident controller
        ran entirely in-dispatch (``rounds_on_device``) cost no host
        traffic and are subtracted."""
        rounds = max(
            0,
            (self._tick - self.cfg.initial_delay_ticks) // self.cfg.metric_period + 1,
        )
        host_rounds = max(0, rounds - self.rounds_on_device)
        return self.adapter.num_workers * (host_rounds + self.sync_readbacks)

    # ------------------------------------------------------------------ #
    # Control-message queue (models §7.5 latency)                         #
    # ------------------------------------------------------------------ #
    def _send(self, tick: int, plan: load_transfer.TransferPlan) -> None:
        self._pending.append(
            _PendingUpdate(apply_at=tick + self.cfg.control_delay_ticks, plan=plan)
        )
        if self.cfg.control_delay_ticks == 0:
            self._flush_control_messages(tick)

    def _flush_control_messages(self, tick: int) -> None:
        ready = [p for p in self._pending if p.apply_at <= tick]
        self._pending = [p for p in self._pending if p.apply_at > tick]
        for p in ready:
            p.plan.apply(self.adapter.routing)

    # ------------------------------------------------------------------ #
    # Mitigation state machine                                            #
    # ------------------------------------------------------------------ #
    def _advance_mitigations(self, tick: int) -> None:
        phi = self.tracker.phi
        done: List[int] = []
        for s, m in self.mitigations.items():
            if m.phase is MitigationPhase.MIGRATING:
                if tick >= m.migration_end:
                    self._start_phase1(tick, m)
            elif m.phase is MitigationPhase.PHASE_ONE:
                # Phase 1 ends when the helper has caught up with (or blown
                # past, between two metric rounds) the skewed worker.
                q_s, q_h = phi[m.skewed], max(phi[h] for h in m.helpers)
                top = max(q_s, q_h, 1.0)
                if q_h >= q_s - self.cfg.catchup_tolerance * top:
                    self._start_phase2(tick, m)
            elif m.phase is MitigationPhase.PHASE_TWO:
                # Divergence beyond tau => another iteration (§4.3.1: "at
                # t3, their workload difference exceeds tau"). Divergence
                # can go EITHER way — a distribution change (§7.8) may
                # overload the helper via its own keys, in which case the
                # new iteration re-fits the split fractions downward (no
                # catch-up phase: the state is already in place). Algorithm
                # 1 may raise tau for the next iteration when the estimate
                # was too uncertain (eps > eps_u).
                q_s, q_h = phi[m.skewed], min(phi[h] for h in m.helpers)
                q_hmax = max(phi[h] for h in m.helpers)
                s_ahead = q_s >= self.cfg.eta and q_s - q_h >= self.tau
                h_ahead = q_hmax >= self.cfg.eta and q_hmax - q_s >= self.tau
                if not (s_ahead or h_ahead):
                    # Calm round: the pair's gap stayed under tau.  After a
                    # full window of calm the mitigation is complete — the
                    # phase-2 split keeps routing, but the state machine
                    # retires and frees (S, helpers) for new detections.
                    m.calm_rounds += 1
                    window = (self.cfg.retire_after
                              if self.cfg.retire_after is not None
                              else self.cfg.sample_window)
                    if window > 0 and m.calm_rounds >= window:
                        done.append(s)
                        self._log(tick, "retire", m.skewed, m.helpers,
                                  iteration=m.iteration,
                                  calm_rounds=m.calm_rounds)
                    continue
                m.calm_rounds = 0
                eps = self.tracker.stderr_pair(m.skewed, m.helpers[0])
                if (
                    self.cfg.adaptive_tau
                    and np.isfinite(eps)
                    and eps > self.cfg.eps_upper
                    and self.tau_adjustments < self.cfg.max_tau_adjustments
                ):
                    new_tau = self.tau + self.cfg.tau_increase
                    self._log(tick, "tau_increase", m.skewed, m.helpers,
                              old=self.tau, new=new_tau)
                    self.tau = new_tau
                    self.tau_adjustments += 1
                m.iteration += 1
                self.iterations_total += 1
                self.tracker.reset_samples([m.skewed, *m.helpers])
                if s_ahead:
                    self._start_phase1(tick, m)
                else:
                    self._start_phase2(tick, m)
        for s in done:
            del self.mitigations[s]

    def _start_phase1(self, tick: int, m: _Mitigation) -> None:
        if not self.cfg.enable_phase1:      # §7.3 ablation: no catch-up
            self._start_phase2(tick, m)
            return
        shares = self.adapter.key_shares(m.skewed)
        plan = load_transfer.plan_phase1(
            self.adapter.routing,
            m.skewed,
            m.helpers,
            full_partition=self.cfg.phase1_full_partition,
            key_shares=shares,
        )
        m.phase1_keys = plan.keys
        m.phase = MitigationPhase.PHASE_ONE
        self._send(tick, plan)
        self._log(tick, "phase1", m.skewed, m.helpers, keys=len(plan.keys),
                  iteration=m.iteration)

    def _start_phase2(self, tick: int, m: _Mitigation) -> None:
        shares = self.tracker.predicted_shares()
        key_shares = self.adapter.key_shares(m.skewed)
        plan = load_transfer.plan_phase2(
            self.adapter.routing,
            m.skewed,
            m.helpers,
            shares,
            mode=self.mode,
            key_shares=key_shares,
        )
        m.phase = MitigationPhase.PHASE_TWO
        self._send(tick, plan)
        self._log(
            tick, "phase2", m.skewed, m.helpers,
            moved_share=round(plan.moved_share, 4), mode=self.mode.value,
            iteration=m.iteration,
        )

    # ------------------------------------------------------------------ #
    # Detection                                                           #
    # ------------------------------------------------------------------ #
    def _detect(self, tick: int) -> None:
        phi = self.tracker.phi
        busy = self.busy_workers
        detect_tau = self._effective_tau()
        # Adaptive tau: evaluate Algorithm 1 on the currently worst pair.
        # The increase branch mitigates NOW under the old tau and raises tau
        # for the next iteration; the decrease branch lowers tau to the
        # current gap so the mitigation fires right away (§4.3.2).
        free = [w for w in range(self.adapter.num_workers) if w not in busy]
        if len(free) >= 2:
            s = max(free, key=lambda w: phi[w])
            h = min(free, key=lambda w: phi[w])
            eps = self.tracker.stderr_pair(s, h)
            if np.isfinite(eps):
                decision = adaptive_tau.adjust_tau(
                    phi[s], phi[h], eps, self.tau, self.cfg,
                    adjustments_used=self.tau_adjustments,
                )
                if decision.action != "keep":
                    self._log(tick, f"tau_{decision.action}", s, (h,),
                              old=self.tau, new=decision.tau)
                    self.tau = decision.tau
                    self.tau_adjustments += 1
                    if decision.action == "decrease":
                        detect_tau = decision.tau

        assignment = assign_helpers(
            phi, self.cfg.eta, detect_tau, busy=busy,
            max_helpers=max(len(phi) - 1, 1),
        )
        for s, candidates in assignment.items():
            self._begin_mitigation(tick, s, candidates)

    def _effective_tau(self) -> float:
        """tau' of §6.1: detect earlier when migration takes time."""
        if not self.cfg.migration_time_guard:
            return self.tau
        rate = self.adapter.processing_rate()
        if rate <= 0 or self.cfg.migration_rate == float("inf"):
            return self.tau
        f_hat = self.tracker.predicted_shares()
        order = np.argsort(-f_hat)
        f_s, f_h = float(f_hat[order[0]]), float(f_hat[order[-1]])
        m = migration_ticks(
            self.adapter.state_units(int(order[0]), self.mode),
            self.cfg.migration_rate,
        )
        return adaptive_tau.tau_prime(self.tau, f_s, f_h, rate, m)

    def _begin_mitigation(self, tick: int, s: int, candidates: List[int]) -> None:
        if s in self.cfg.pinned_helpers:        # experiment harness (§7.2)
            pin = self.cfg.pinned_helpers[s]
            if pin in self.busy_workers:
                return
            candidates = [pin]
        f_hat = self.tracker.predicted_shares()
        rate = self.adapter.processing_rate()
        left = self.adapter.tuples_left()
        state = self.adapter.state_units(s, self.mode)

        choice = choose_helpers(
            f_hat,
            s,
            candidates,
            tuples_left=left,
            rate=rate,
            migration_ticks_fn=lambda n: migration_ticks(
                state, self.cfg.migration_rate, n_helpers=n
            ),
            max_helpers=self.cfg.max_helpers,
        )
        if not choice.helpers:
            return
        # §6.1 precondition: skip if migration outlasts the execution.
        if self.cfg.migration_time_guard and rate > 0:
            time_left = left / rate
            if choice.migration_ticks > time_left:
                self._log(tick, "skip_migration", s, tuple(choice.helpers),
                          migration=choice.migration_ticks, time_left=time_left)
                return

        m = _Mitigation(
            skewed=s,
            helpers=list(choice.helpers),
            mode=self.mode,
            phase=MitigationPhase.MIGRATING,
            migration_end=tick + choice.migration_ticks,
        )
        self.mitigations[s] = m
        self.iterations_total += 1
        self.adapter.begin_migration(s, choice.helpers, self.mode)
        self._log(
            tick, "detect", s, tuple(choice.helpers),
            chi=round(choice.chi, 2), migration_ticks=choice.migration_ticks,
            tau=self.tau,
        )
        if choice.migration_ticks <= 0:
            self._start_phase1(tick, m)

    def _log(self, tick: int, kind: str, s: int, helpers: Sequence[int], **detail):
        self.events.append(
            MitigationEvent(tick=tick, kind=kind, skewed=s,
                            helpers=tuple(helpers), detail=dict(detail))
        )
