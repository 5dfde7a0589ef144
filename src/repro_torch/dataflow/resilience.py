"""Resilience subsystem: incidents, retry/backoff, deterministic chaos.

Counterpart of ``repro.dataflow.resilience``; one seed gives the same
:class:`FaultPlan` in both packages (the same ``numpy`` draws).  The
paper's value proposition — representative early results during
pipelined execution (§2.2) — only survives production failures if the
engine does.  This module supplies the three pillars the rest of the
package builds on:

Incident log
    Every demotion, mismatch arbitration, retry, checkpoint-corruption
    detection and recovery is recorded as a structured
    :class:`Incident` (kind, tick, edge, cause, action) on a queryable
    :class:`IncidentLog`.  The engine owns one (``engine.incidents``);
    module-level sites with no engine handle (the radix cliff in
    :mod:`repro_torch.dataflow.exchange`) record on the process-wide
    :data:`GLOBAL` log.  One-time ``RuntimeWarning``s remain as the
    human-facing signal; the log is the machine-facing one tests and
    benches assert on.

Retry / backoff
    :class:`RetryPolicy` bounds how often a failing device dispatch is
    retried (with exponential backoff) before the edge or controller is
    demoted drain-first to the host path instead of propagating the
    failure.  The engine carries one (``engine.retry_policy``).

Deterministic chaos harness
    A seeded :class:`FaultPlan` schedules a taxonomy of faults —
    worker volatile-state loss, device-dispatch failure, straggler
    throttle, corrupted / missing checkpoint, dropped / delayed control
    messages, mid-run device-budget shrink (``mem-pressure``, absorbed
    by the spill tier), corrupted host spill segment
    (``spill-corrupt``, healed by rollback to the last valid cut) —
    and :class:`ChaosRunner` drives the engine loop,
    injecting them at super-tick seams (a fault tick interior to a
    fused window forces a seam there, so mid-super-tick boundaries are
    exercised too) and recovering through the hardened
    :class:`~repro_torch.dataflow.checkpoint.CheckpointCoordinator`.  Every
    schedule is replayable from its seed; the core invariant is that
    under *any* injected schedule ``Sink.series`` is bit-identical to
    the fault-free run on every plane.

Recovery protocol: faults that perturb deterministic progress
(straggler, control-message loss, worker loss) are healed by rolling
back to the newest cut taken at-or-before the injection tick — the
coordinator suppresses cuts while a fault is active, so the rollback
target is always fault-free.  Transient dispatch failures are healed
in place by the retry path (or, once the retries are spent, by a
drain-first demotion of the edge to the per-chunk torch exchange, which
is bit-exact by construction), so they never need a rollback.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


class InjectedDispatchFault(RuntimeError):
    """Raised inside the device-dispatch path by an injected fault."""


class CheckpointError(RuntimeError):
    """No valid checkpoint could be restored."""


# --------------------------------------------------------------------- #
# Incidents                                                              #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class Incident:
    """One structured resilience event (what went wrong, what was done)."""

    kind: str                 # "demotion" | "retry" | "recovery" | ...
    tick: int                 # engine tick when recorded (-1: unknown)
    edge: Optional[str]       # op/edge name, None for engine-global
    cause: str                # why it fired
    action: str               # what the engine did about it
    attempt: int = 0          # retry ordinal (0 for non-retry incidents)


class IncidentLog:
    """Append-only, queryable event log (one per engine; one global)."""

    def __init__(self) -> None:
        self.incidents: List[Incident] = []

    def record(self, kind: str, *, tick: int = -1,
               edge: Optional[str] = None, cause: str = "",
               action: str = "", attempt: int = 0) -> Incident:
        inc = Incident(kind, int(tick), edge, cause, action, int(attempt))
        self.incidents.append(inc)
        return inc

    def query(self, kind: Optional[str] = None, *,
              edge: Optional[str] = None,
              cause: Optional[str] = None) -> List[Incident]:
        """Incidents matching every given filter (``cause`` is substring)."""
        return [i for i in self.incidents
                if (kind is None or i.kind == kind)
                and (edge is None or i.edge == edge)
                and (cause is None or cause in i.cause)]

    def count(self, kind: Optional[str] = None, **kw) -> int:
        return len(self.query(kind, **kw))

    def kinds(self) -> Dict[str, int]:
        return dict(collections.Counter(i.kind for i in self.incidents))

    def clear(self) -> None:
        self.incidents.clear()

    def __len__(self) -> int:
        return len(self.incidents)

    def __iter__(self) -> Iterator[Incident]:
        return iter(self.incidents)


#: process-wide log for sites with no engine handle (e.g. the radix
#: cliff in ``scatter_order``, a module-level function).
GLOBAL = IncidentLog()


def global_incidents() -> IncidentLog:
    return GLOBAL


# --------------------------------------------------------------------- #
# Retry / backoff                                                        #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class RetryPolicy:
    """Bounded exponential backoff for device-dispatch failures.

    ``max_attempts`` is the number of *retries* after the first failure;
    once exhausted the caller demotes drain-first instead of
    propagating.  Delays default to zero (simulation ticks are the unit
    of time here; wall-clock sleeps only matter for real deployments
    and would slow the test suite for nothing).
    """

    max_attempts: int = 3
    base_delay_s: float = 0.0
    backoff: float = 2.0
    max_delay_s: float = 0.25

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (1-based)."""
        if self.base_delay_s <= 0.0:
            return 0.0
        return min(self.base_delay_s * self.backoff ** (attempt - 1),
                   self.max_delay_s)

    def sleep(self, attempt: int) -> None:
        d = self.delay_s(attempt)
        if d > 0.0:
            time.sleep(d)


# --------------------------------------------------------------------- #
# Fault taxonomy                                                         #
# --------------------------------------------------------------------- #
WORKER_LOSS = "worker-loss"        # a worker's volatile state vanishes
DISPATCH_FAIL = "dispatch-fail"    # the resident device dispatch raises
STRAGGLER = "straggler"            # an operator's service rate collapses
CORRUPT_CUT = "corrupt-cut"        # the newest checkpoint is corrupted
MISSING_CUT = "missing-cut"        # the newest checkpoint disappears
CTRL_DROP = "ctrl-drop"            # pending control messages are dropped
CTRL_DELAY = "ctrl-delay"          # pending control messages are delayed
MEM_PRESSURE = "mem-pressure"      # device budget shrinks, forcing spill
SPILL_CORRUPT = "spill-corrupt"    # a host spill segment fails its CRC

ALL_FAULT_KINDS: Tuple[str, ...] = (
    WORKER_LOSS, DISPATCH_FAIL, STRAGGLER, CORRUPT_CUT, MISSING_CUT,
    CTRL_DROP, CTRL_DELAY, MEM_PRESSURE, SPILL_CORRUPT)

#: faults the engine keeps running under until "detected" (duration in
#: ticks); everything else is crash-like: detected and recovered at the
#: injection seam.
_DURATION_KINDS = (STRAGGLER, CTRL_DROP, CTRL_DELAY, MEM_PRESSURE)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``tick``: injection tick (a super-tick seam; the runner forces a
    seam there if the tick would be interior to a fused window).
    ``duration``: ticks the engine keeps running under the fault before
    it is detected and recovery rolls back (0 = crash-like, recovered
    at the injection seam).  ``target`` selects a worker/operator
    deterministically (modulo the available count).  ``count`` is the
    number of consecutive dispatch failures for ``dispatch-fail``.
    """

    kind: str
    tick: int
    duration: int = 0
    target: int = 0
    count: int = 1


class FaultPlan:
    """A deterministic, replayable fault schedule."""

    def __init__(self, events: Sequence[FaultEvent]):
        for ev in events:
            if ev.kind not in ALL_FAULT_KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}")
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.tick, e.kind)))

    @classmethod
    def from_seed(cls, seed: int, *, max_tick: int = 100,
                  n_faults: int = 4,
                  kinds: Sequence[str] = ALL_FAULT_KINDS,
                  min_tick: int = 1) -> "FaultPlan":
        """Seeded random schedule — same seed, same plan, replayable."""
        import numpy as np
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(int(n_faults)):
            kind = kinds[int(rng.integers(0, len(kinds)))]
            tick = int(rng.integers(min_tick, max(min_tick + 1, max_tick)))
            duration = (int(rng.integers(1, 8))
                        if kind in _DURATION_KINDS else 0)
            events.append(FaultEvent(kind, tick, duration,
                                     target=int(rng.integers(0, 64)),
                                     count=int(rng.integers(1, 4))))
        return cls(events)

    def describe(self) -> str:
        return "; ".join(f"{e.kind}@{e.tick}"
                         + (f"+{e.duration}" if e.duration else "")
                         for e in self.events) or "(no faults)"


# --------------------------------------------------------------------- #
# The chaos runner                                                       #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class _ActiveFault:
    event: FaultEvent
    recover_at: int
    undo: Optional[object] = None     # callable restoring injected knobs
    rollback: bool = False            # heal via checkpoint rollback


class ChaosRunner:
    """Drives the engine loop under a :class:`FaultPlan`.

    The runner owns a hardened
    :class:`~repro_torch.dataflow.checkpoint.CheckpointCoordinator` (cuts on
    the ``every_ticks`` grid, suppressed while a fault is active so
    every rollback target is fault-free) and installs itself as
    ``engine.chaos`` so the device plane's dispatch paths can consume
    pending injected dispatch failures.  Faults are injected one at a
    time (an event arriving while another fault is active waits for its
    recovery), which keeps every schedule's recovery sequence
    deterministic and replayable.
    """

    def __init__(self, engine, plan: FaultPlan, *, every_ticks: int = 20,
                 retention: int = 4, store: Optional[str] = None):
        from .checkpoint import CheckpointCoordinator
        self.engine = engine
        self.plan = plan
        self.coord = CheckpointCoordinator(
            engine, every_ticks, retention=retention, store=store)
        self._queue: List[FaultEvent] = list(plan.events)
        self._active: List[_ActiveFault] = []
        self._pending_dispatch_faults = 0
        self.injected: Dict[str, int] = collections.Counter()
        self.recovered = 0
        engine.chaos = self

    # ---- device-plane hook -------------------------------------------- #
    def dispatch_fault(self, runtime) -> None:
        """Called by the device plane right before a dispatch; raises
        while injected dispatch failures are pending (each call consumes
        one, so a retry after the pending failures drain succeeds)."""
        if self._pending_dispatch_faults > 0:
            self._pending_dispatch_faults -= 1
            raise InjectedDispatchFault(
                "chaos: injected device-dispatch failure")

    # ---- the engine loop ---------------------------------------------- #
    def run(self, max_ticks: int = 200_000) -> int:
        eng = self.engine
        try:
            while True:
                while not eng.done() and eng.tick < max_ticks:
                    t = eng.tick
                    for f in [f for f in self._active
                              if f.recover_at <= t]:
                        self._recover(f)
                    while (self._queue and self._queue[0].tick <= t
                           and not self._active):
                        self._inject(self._queue.pop(0))
                    if not self._active:
                        self.coord.maybe_checkpoint()
                    eng.run_super_tick(self._window(max_ticks))
                if eng.tick < max_ticks:
                    # Queued rollback events whose tick the run already
                    # reached: their pending injection forced window
                    # seams (``_window`` clamps at the next rollback
                    # event), and the perturbed schedule may finish
                    # *early* — before the per-tick injection check
                    # fires.  Inject now; the recovery below rolls back
                    # past the seam and the replay is canonical.  Events
                    # strictly beyond the final tick never clamped a
                    # window (the clamp only binds inside a window's
                    # horizon), so dropping them is perturbation-free.
                    while (self._queue and not self._active
                           and self._queue[0].kind != DISPATCH_FAIL
                           and self._queue[0].tick <= eng.tick):
                        self._inject(self._queue.pop(0))
                if eng.tick >= max_ticks:
                    break
                # The engine finished while a fault was still active:
                # its progress diverged, so recovery must still roll
                # back past the injection and replay fault-free.  (A
                # crash-like duration-0 fault recovers inside ``_inject``
                # itself, so test doneness — not ``_active`` — to decide
                # whether a rollback reopened the run.)
                for f in list(self._active):
                    self._recover(f)
                if eng.done():
                    break
        finally:
            eng.chaos = None
        return eng.tick

    def _window(self, max_ticks: int) -> int:
        """Next fused-window width: the engine's own fusibility bound,
        additionally cut at the next *rollback-healed* injection tick
        and the next fault recovery tick.

        Window partitioning is only bit-identity-preserving along the
        canonical schedule, so the runner may force a seam ONLY where
        everything after the previous cut gets rolled back and replayed
        canonically: rollback faults qualify (recovery restores a cut
        taken at a canonical window start and replays), dispatch faults
        and mem-pressure do not (healed in place) — those inject at the
        next natural seam instead, and checkpoints are interval-based
        (:meth:`CheckpointCoordinator.maybe_checkpoint`) precisely so
        cuts never force seams of their own."""
        eng = self.engine
        t0 = eng.tick
        horizon = max(1, min(eng.batch_ticks, max_ticks - t0))
        k = eng._fusible_ticks(horizon) if horizon > 1 else 1
        stop = t0 + k
        in_place = (DISPATCH_FAIL, MEM_PRESSURE)
        for ev in self._queue:
            if ev.kind not in in_place:
                stop = min(stop, max(ev.tick, t0 + 1))
                break
        for f in self._active:
            if f.rollback:
                stop = min(stop, max(f.recover_at, t0 + 1))
        return max(1, stop - t0)

    # ---- injection ----------------------------------------------------- #
    def _stateful_ops(self) -> List:
        from .operators import Sink
        return [o for o in self.engine.ops
                if o.workers and not isinstance(o, Sink)]

    def _target_op(self, ev: FaultEvent):
        ops = self._stateful_ops()
        return ops[ev.target % len(ops)] if ops else None

    def _inject(self, ev: FaultEvent) -> None:
        eng = self.engine
        log = eng.incidents
        self.injected[ev.kind] += 1
        undo = None
        rollback = False
        detail = ""
        if ev.kind == DISPATCH_FAIL:
            self._pending_dispatch_faults += ev.count
            detail = f"next {ev.count} device dispatches fail"
        elif ev.kind == WORKER_LOSS:
            op = self._target_op(ev)
            if op is not None:
                w = op.workers[ev.target % op.num_workers]
                k, v = w.queue.snapshot()
                w.queue.restore((k[:0], v[:0]), w.queue.received_total)
                if hasattr(w.state, "clear"):
                    w.state.clear()
                if hasattr(w.scattered, "clear"):
                    w.scattered.clear()
                detail = (f"{op.name}[{ev.target % op.num_workers}] "
                          f"volatile state lost")
            rollback = True
        elif ev.kind == STRAGGLER:
            op = self._target_op(ev)
            if op is not None:
                old = op.service_rate
                op.service_rate = max(1, old // 4)
                undo = lambda op=op, old=old: setattr(  # noqa: E731
                    op, "service_rate", old)
                detail = (f"{op.name} service rate {old} -> "
                          f"{op.service_rate} for {ev.duration} ticks")
            rollback = True
        elif ev.kind == CORRUPT_CUT:
            detail = ("latest cut corrupted"
                      if self.coord.corrupt_latest()
                      else "no corruptible cut (initial only)")
            rollback = True
        elif ev.kind == MISSING_CUT:
            detail = ("latest cut dropped" if self.coord.drop_latest()
                      else "no droppable cut (initial only)")
            rollback = True
        elif ev.kind == CTRL_DROP:
            n = 0
            for att in eng.controllers:
                pend = getattr(att.controller, "_pending", None)
                if pend:
                    n += len(pend)
                    pend.clear()
            detail = f"{n} pending control messages dropped"
            rollback = True
        elif ev.kind == CTRL_DELAY:
            n = 0
            for att in eng.controllers:
                for p in getattr(att.controller, "_pending", ()):
                    p.apply_at += max(1, ev.duration)
                    n += 1
            detail = f"{n} pending control messages delayed"
            rollback = True
        elif ev.kind == MEM_PRESSURE:
            # Shrink one device edge's memory budget mid-run: the spill
            # tier must absorb the squeeze (watermark eviction to host
            # segments), keeping results bit-identical — healed by undo
            # alone, no rollback (spill is exact by construction).
            rts = [o.device for o in eng.ops
                   if getattr(o, "device", None) is not None]
            if rts:
                rt = rts[ev.target % len(rts)]
                old = rt.budget_cfg
                shrunk = 8 * max(1, rt.W)
                rt.set_budget(shrunk)
                undo = lambda rt=rt, old=old: setattr(  # noqa: E731
                    rt, "budget_cfg", old)
                detail = (f"{rt.op.name} device budget shrunk to "
                          f"{shrunk} cells for {ev.duration} ticks")
            else:
                detail = "no device runtime (host plane)"
        elif ev.kind == SPILL_CORRUPT:
            # Flip a byte in a spilled host segment.  The CRC catches it
            # on any read back; the chaos heal is crash-like rollback to
            # the last valid cut (restore clears the spill tier, so the
            # poisoned segment is discarded and the replay is canonical).
            n = 0
            for o in eng.ops:
                rt = getattr(o, "device", None)
                sp = getattr(rt, "spill", None)
                if sp is not None and sp.corrupt_one():
                    n += 1
                    detail = f"{o.name}: one spill segment corrupted"
                    break
            if not n:
                detail = "no spill segments (nothing spilled yet)"
            rollback = True
        log.record("fault", tick=eng.tick, cause=ev.kind,
                   action=detail or "injected")
        if ev.kind == DISPATCH_FAIL:
            return          # healed in place by the retry/demotion path
        f = _ActiveFault(ev, eng.tick + max(0, ev.duration), undo,
                         rollback)
        self._active.append(f)
        if ev.duration <= 0:
            self._recover(f)    # crash-like: detected at this seam

    def _recover(self, f: _ActiveFault) -> None:
        eng = self.engine
        if f.undo is not None:
            f.undo()
        if f in self._active:
            self._active.remove(f)
        self.recovered += 1
        if f.rollback:
            cut = self.coord.recover(at_or_before=f.event.tick)
            eng.incidents.record(
                "chaos-recover", tick=eng.tick, cause=f.event.kind,
                action=f"rolled back to cut tick={cut.tick}")
        else:
            eng.incidents.record("chaos-recover", tick=eng.tick,
                                 cause=f.event.kind, action="cleared")
