"""Resilience primitives: incidents and retry/backoff.

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

The seeded chaos harness of the JAX package (``FaultPlan`` /
``ChaosRunner`` in ``repro.dataflow.resilience``) is not ported yet.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterator, List, Optional


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
