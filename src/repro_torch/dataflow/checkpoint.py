"""Incremental, checksummed checkpointing + recovery (paper §2.2).

Counterpart of ``repro.dataflow.checkpoint``.  A cut is a boundary of the
device-resident plane: every runtime materializes into the host
structures first (``sync_host``, the spill tier's segments included), and
``restore`` hands each runtime the restored host truth
(``DeviceOpRuntime.on_restore``), which drops the device state and the
spill tier and uploads again.

The paper uses Chandy-Lamport-style marker checkpoints (Flink [17]); a
checkpoint captures worker states *and the current partitioning logic*,
and during state migration the skewed worker forwards the marker to its
helpers (no cyclic dependency: skewed and helper sets are disjoint).
In this engine ticks are atomic, so a snapshot taken between ticks is
exactly the post-marker-alignment cut — queues, keyed/scattered state,
routing tables, controller phase machines (a mitigation checkpointed in
MIGRATING/PHASE_ONE resumes there after recovery).

``snapshot`` returns a plain dict of copies; ``restore`` writes them
back **in place** (routing ``owner`` arrays are shared views held by
operators, so they must be mutated, not replaced).  The cut is fully
isolated: nothing in it aliases live engine state, so no post-snapshot
mutation can corrupt it (see ``tests/test_resilience.py``).

Incremental cuts
----------------
:class:`CutBuilder` dirty-tracks the two deep-copy-heavy section kinds
— per-edge routing/exchange dicts and per-operator worker dicts — with
cheap integer signatures (``tuples_sent`` / routing ``version`` /
``units_moved`` per edge; per-worker ``received_total`` /
``processed_total`` / ``emitted_total``, state sizes, the in-edge
versions and the global migration counter per op).  A section whose
signature is unchanged since the previous cut is *reused by reference*
(sections are immutable once built, so sharing across cuts is safe) —
an idle operator costs O(1) per cut instead of a deep copy.  The
signatures are value-equality comparisons, so they stay correct across
restores (a rolled-back engine re-matches the cut it was rolled back
to).

Checksums and corruption detection
----------------------------------
Every section gets a CRC32 over its pickled bytes, cached alongside
the section (a reused section reuses its CRC, keeping incremental cuts
cheap); a cut's checksum combines the section CRCs.  ``recover``
re-derives the checksum from the actual payload before restoring, so a
corrupted cut is *detected* and recovery falls back to the previous
valid cut instead of silently loading garbage.  Cuts optionally
persist to disk (``store=``) as CRC-framed pickle files with bounded
retention; a corrupted file is likewise detected and skipped at load.

:class:`CheckpointCoordinator` drives periodic cuts on the
``every_ticks`` grid (one cut per boundary — the historical tick-0
double cut is gone), keeps ``retention`` cuts, and records every
corruption detection and recovery on the engine's incident log.
"""
from __future__ import annotations

import copy
import dataclasses
import glob
import os
import pickle
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .engine import Engine
from .operators import Sink
from .resilience import CheckpointError


def _snap_routing(rt) -> Dict:
    rt.sync_counters()       # device-resident counters: materialize
    return dict(
        weights=rt.weights.copy(),
        owner=rt.owner.copy(),
        version=rt.version,
        credit=rt._credit.copy(),
        count=rt._count.copy(),
    )


def _restore_routing(rt, s: Dict) -> None:
    rt._count_owner = None   # the host copy becomes authoritative
    rt.weights[:] = s["weights"]
    rt.owner[:] = s["owner"]
    rt.version = s["version"]
    rt._credit[:] = s["credit"]
    rt._count[:] = s["count"]
    rt.invalidate_cache()    # weights/version written directly


def _snap_controller(ctrl) -> Dict:
    out = dict(
        cls=type(ctrl).__name__,
        events_len=len(ctrl.events),
        iterations_total=ctrl.iterations_total,
    )
    if hasattr(ctrl, "tau"):
        out.update(
            tau=ctrl.tau,
            tau_adjustments=ctrl.tau_adjustments,
            mitigations=copy.deepcopy(ctrl.mitigations),
            pending=copy.deepcopy(ctrl._pending),
            tracker=dict(
                phi=ctrl.tracker.phi.copy(),
                received=ctrl.tracker.received_total.copy(),
                obs=[list(e._obs) for e in ctrl.tracker._estimators],
            ),
        )
    if hasattr(ctrl, "assigned"):
        out["assigned"] = dict(ctrl.assigned)
    if hasattr(ctrl, "fired"):
        out["fired"] = ctrl.fired
    return out


def _restore_controller(ctrl, s: Dict) -> None:
    ctrl.events = ctrl.events[: s["events_len"]]
    ctrl.iterations_total = s["iterations_total"]
    if "tau" in s:
        ctrl.tau = s["tau"]
        ctrl.tau_adjustments = s["tau_adjustments"]
        ctrl.mitigations = copy.deepcopy(s["mitigations"])
        ctrl._pending = copy.deepcopy(s["pending"])
        ctrl.tracker.phi = s["tracker"]["phi"].copy()
        ctrl.tracker.received_total = s["tracker"]["received"].copy()
        for est, obs in zip(ctrl.tracker._estimators, s["tracker"]["obs"]):
            est._obs.clear()
            est._obs.extend(obs)
    if "assigned" in s:
        ctrl.assigned = dict(s["assigned"])
    if "fired" in s:
        ctrl.fired = s["fired"]


# --------------------------------------------------------------------- #
# Sections                                                               #
# --------------------------------------------------------------------- #
def _snap_edge(e) -> Dict:
    return dict(routing=_snap_routing(e.routing), tuples_sent=e.tuples_sent,
                sent_per_worker=e.sent_per_worker.copy(),
                units_moved=e.units_moved, strategy=e.strategy)


def _snap_op(op) -> Dict:
    o = dict(
        finished=op.finished,
        arrived=None if op.arrived_by_key is None else op.arrived_by_key.copy(),
        totals=None if op.key_arrivals_total is None else op.key_arrivals_total.copy(),
        workers=[
            dict(
                queue=w.queue.snapshot(),
                received=w.queue.received_total,
                processed=w.stats.processed_total,
                emitted=w.stats.emitted_total,
                state=copy.deepcopy(w.state),
                scattered=copy.deepcopy(w.scattered),
            )
            for w in op.workers
        ],
    )
    if isinstance(op, Sink):
        o["counts"] = op.counts.copy()
        o["sums"] = op.sums.copy()
        # Copy the row arrays too: the cut must stay valid even if a
        # consumer mutates a live series row in place (isolation).
        o["series"] = [(t, c.copy()) for t, c in op.series]
    return o


def _snap_meta(engine: Engine) -> Dict:
    snap: Dict = dict(tick=engine.tick,
                      state_units_moved=engine.state_units_moved)
    snap["sources"] = [dict(pos=s.pos, finished=s.finished)
                      for s in engine.sources]
    snap["controllers"] = [_snap_controller(a.controller)
                          for a in engine.controllers]
    return snap


# ---- dirty signatures ------------------------------------------------- #
def _edge_sig(e) -> Tuple:
    return (e.tuples_sent, e.routing.version, float(e.units_moved),
            e.strategy)


def _state_len(s) -> int:
    try:
        return len(s)
    except TypeError:
        return -1


def _op_sig(engine: Engine, op, in_edges) -> Tuple:
    sig: List = [bool(op.finished), float(engine.state_units_moved)]
    for e in in_edges:
        sig.append((e.routing.version, float(e.units_moved)))
    for w in op.workers:
        sig.append((w.queue.received_total, w.stats.processed_total,
                    w.stats.emitted_total, _state_len(w.state),
                    _state_len(w.scattered)))
    if op.arrived_by_key is not None:
        sig.append((int(op.arrived_by_key.sum()),
                    int(op.key_arrivals_total.sum())))
    if isinstance(op, Sink):
        sig.append(len(op.series))
    return tuple(sig)


# ---- checksums -------------------------------------------------------- #
def _section_crc(obj) -> int:
    return zlib.crc32(pickle.dumps(obj, protocol=4))


def compute_crc(snap: Dict) -> int:
    """Checksum of a cut, re-derived from the actual payload.

    Combines the meta section's CRC with every edge/op section's CRC in
    order; bit-for-bit the same combination :class:`CutBuilder` caches,
    so a cut verifies iff no byte of its content changed since it was
    taken."""
    meta = {k: v for k, v in snap.items() if k not in ("edges", "ops")}
    h = zlib.crc32(_section_crc(meta).to_bytes(4, "little"))
    for sec in snap["edges"]:
        h = zlib.crc32(_section_crc(sec).to_bytes(4, "little"), h)
    for sec in snap["ops"]:
        h = zlib.crc32(_section_crc(sec).to_bytes(4, "little"), h)
    return h


# --------------------------------------------------------------------- #
# Full snapshot / restore (public, unchanged contract)                   #
# --------------------------------------------------------------------- #
def snapshot(engine: Engine) -> Dict:
    """Consistent engine checkpoint at a tick boundary (full copy).

    A checkpoint is one of the device plane's materialization
    boundaries: every device-resident operator first syncs its rings,
    keyed state and counters into the host structures this snapshot
    copies, so the cut is bit-identical to the host plane's.  Row-state
    operators (HashJoinBuild / RangeSort) materialize through the same
    path, and fused chains need no special casing: every stage owns its
    own rings/fold/mirrors, so the per-runtime ``sync_host`` cuts
    through a chain exactly as it cuts through per-edge runtimes.
    """
    for op in engine.ops:
        if op.device is not None:
            op.device.sync_host()
    snap = _snap_meta(engine)
    snap["edges"] = [_snap_edge(e) for e in engine.edges]
    snap["ops"] = [_snap_op(op) for op in engine.ops]
    return snap


def restore(engine: Engine, snap: Dict) -> None:
    """Recovery: restore states from the checkpoint and continue (§2.2)."""
    # Reconcile armed device-resident controllers first: the host event
    # log and tick mirror lag in-dispatch decisions until a boundary
    # drain, and ``_restore_controller`` truncates the *live* event list
    # to the snapshot's length — draining makes it live before the cut.
    for att in engine.controllers:
        dev = att.op.device
        if dev is not None and dev.ctrl is not None and dev.ctrl.active:
            dev.ctrl.drain()
    engine.tick = snap["tick"]
    engine.state_units_moved = snap["state_units_moved"]
    for s, ss in zip(engine.sources, snap["sources"]):
        s.pos, s.finished = ss["pos"], ss["finished"]
    for e, es in zip(engine.edges, snap["edges"]):
        # Suppress migration listeners while rewriting tables: recovery
        # installs state and routing together, no marker protocol needed.
        listener, e.routing.listener = e.routing.listener, None
        _restore_routing(e.routing, es["routing"])
        e.routing.listener = listener
        # The restored table may carry splits/moves the destination never
        # saw as a rewrite (listener suppressed): conservatively re-arm the
        # owned/scattered mask if any arrival could land off-owner.
        rt = e.routing
        if ((np.count_nonzero(rt.weights, axis=1) > 1).any()
                or not np.array_equal(rt.owner, rt.weights.argmax(axis=1))):
            e.dst.may_scatter = True
        e.tuples_sent = es["tuples_sent"]
        e.exchange.sent_per_worker[:] = es["sent_per_worker"]
        e.units_moved = es["units_moved"]
        e.strategy = es["strategy"]
    for op, os_ in zip(engine.ops, snap["ops"]):
        op.finished = os_["finished"]
        if os_["arrived"] is not None:
            op.arrived_by_key[:] = os_["arrived"]
            op.key_arrivals_total[:] = os_["totals"]
        for w, ws in zip(op.workers, os_["workers"]):
            w.queue.restore(ws["queue"], ws["received"])
            w.stats.processed_total = ws["processed"]
            w.stats.emitted_total = ws["emitted"]
            w.state = copy.deepcopy(ws["state"])
            w.scattered = copy.deepcopy(ws["scattered"])
        if isinstance(op, Sink):
            op.counts[:] = os_["counts"]
            op.sums[:] = os_["sums"]
            # Row arrays copied both ways: the engine's live series must
            # never alias the cut's (isolation survives repeat restores).
            op.series = [(t, c.copy()) for t, c in os_["series"]]
    for att, cs in zip(engine.controllers, snap["controllers"]):
        _restore_controller(att.controller, cs)
    # Device-resident operators replay from the restored host truth: the
    # device copies are dropped and eagerly re-uploaded (mid-super-tick
    # failures thus resume from the last boundary, counters and queues
    # bit-identical to the host plane).  ``on_restore`` also clears each
    # runtime's chain-tick mark, so a restored fused chain re-forms (or
    # falls back per-edge, if the restored tables' tokens no longer
    # match) on the first post-recovery super-tick.
    for op in engine.ops:
        if op.device is not None:
            op.device.on_restore()


# --------------------------------------------------------------------- #
# Incremental, checksummed cuts                                          #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Cut:
    """One checkpoint: payload + checksum (+ optional persisted file)."""

    seq: int
    tick: int
    payload: Dict
    crc: int
    path: Optional[str] = None


class CutBuilder:
    """Builds cuts, reusing clean sections (and their CRCs) when
    ``incremental`` — see the module docstring for the dirty keys."""

    def __init__(self, engine: Engine, incremental: bool = True):
        self.engine = engine
        self.incremental = bool(incremental)
        # per-section cache: (signature, section, crc)
        self._edges: List[Optional[Tuple]] = []
        self._ops: List[Optional[Tuple]] = []
        self.copied_edges = self.reused_edges = 0
        self.copied_ops = self.reused_ops = 0
        self._in_edges = None

    def _op_in_edges(self):
        if self._in_edges is None:
            self._in_edges = [[e for e in self.engine.edges if e.dst is op]
                              for op in self.engine.ops]
        return self._in_edges

    def build(self) -> Tuple[Dict, int]:
        """One cut: ``(payload, crc)`` with clean sections shared with
        the previous cut (sections are immutable once built)."""
        engine = self.engine
        for op in engine.ops:
            if op.device is not None:
                op.device.sync_host()
        snap = _snap_meta(engine)
        h = zlib.crc32(_section_crc(
            {k: v for k, v in snap.items()}).to_bytes(4, "little"))
        edges: List[Dict] = []
        self._edges += [None] * (len(engine.edges) - len(self._edges))
        for i, e in enumerate(engine.edges):
            sig = _edge_sig(e)
            cached = self._edges[i] if self.incremental else None
            if cached is not None and cached[0] == sig:
                _, sec, crc = cached
                self.reused_edges += 1
            else:
                sec = _snap_edge(e)
                crc = _section_crc(sec)
                self._edges[i] = (sig, sec, crc)
                self.copied_edges += 1
            edges.append(sec)
            h = zlib.crc32(crc.to_bytes(4, "little"), h)
        ops: List[Dict] = []
        self._ops += [None] * (len(engine.ops) - len(self._ops))
        for i, (op, ine) in enumerate(zip(engine.ops,
                                          self._op_in_edges())):
            sig = _op_sig(engine, op, ine)
            cached = self._ops[i] if self.incremental else None
            if cached is not None and cached[0] == sig:
                _, sec, crc = cached
                self.reused_ops += 1
            else:
                sec = _snap_op(op)
                crc = _section_crc(sec)
                self._ops[i] = (sig, sec, crc)
                self.copied_ops += 1
            ops.append(sec)
            h = zlib.crc32(crc.to_bytes(4, "little"), h)
        snap["edges"] = edges
        snap["ops"] = ops
        return snap, h


# --------------------------------------------------------------------- #
# Disk persistence                                                       #
# --------------------------------------------------------------------- #
def save_cut(cut: Cut, store: str) -> str:
    """Persist one cut as a CRC-framed pickle file; returns the path."""
    os.makedirs(store, exist_ok=True)
    body = pickle.dumps(dict(seq=cut.seq, tick=cut.tick, crc=cut.crc,
                             payload=cut.payload), protocol=4)
    data = zlib.crc32(body).to_bytes(4, "little") + body
    path = os.path.join(store, f"cut-{cut.seq:06d}.ckpt")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    cut.path = path
    return path


def load_cut(path: str) -> Cut:
    """Load + verify one persisted cut (file framing and payload CRC)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 4 or zlib.crc32(data[4:]) != int.from_bytes(
            data[:4], "little"):
        raise CheckpointError(f"corrupt checkpoint file: {path}")
    d = pickle.loads(data[4:])
    cut = Cut(d["seq"], d["tick"], d["payload"], d["crc"], path=path)
    if compute_crc(cut.payload) != cut.crc:
        raise CheckpointError(f"checkpoint payload failed CRC: {path}")
    return cut


def load_latest(store: str) -> Cut:
    """Newest valid persisted cut; corrupted files are skipped."""
    for path in sorted(glob.glob(os.path.join(store, "cut-*.ckpt")),
                       reverse=True):
        try:
            return load_cut(path)
        except CheckpointError:
            continue
    raise CheckpointError(f"no valid checkpoint under {store}")


# --------------------------------------------------------------------- #
# The coordinator                                                        #
# --------------------------------------------------------------------- #
class CheckpointCoordinator:
    """Periodic incremental cuts + verified recovery.

    ``every_ticks`` is the cut grid; ``retention`` bounds the in-memory
    (and on-disk, with ``store=``) cut history; ``incremental=False``
    forces full deep copies (the A/B baseline for the recovery bench).
    Recovery verifies the cut's checksum against its payload and falls
    back to the previous valid cut on mismatch, recording a
    ``checkpoint-corrupt`` incident; successful recoveries record a
    ``recovery`` incident with the replayed-ticks cost.
    """

    def __init__(self, engine: Engine, every_ticks: int = 50, *,
                 retention: int = 3, incremental: bool = True,
                 store: Optional[str] = None):
        self.engine = engine
        self.every = int(every_ticks)
        self.retention = max(1, int(retention))
        self.store = store
        self.builder = CutBuilder(engine, incremental)
        self.cuts: List[Cut] = []
        self.checkpoints_taken = 0
        self.recoveries = 0
        self.replayed_ticks = 0
        self.corrupt_detected = 0
        self._seq = 0
        self.checkpoint()            # the initial cut (counted honestly)

    # ---- back-compat -------------------------------------------------- #
    @property
    def last(self) -> Dict:
        """Payload of the newest cut (legacy accessor)."""
        return self.cuts[-1].payload

    def _log(self):
        return getattr(self.engine, "incidents", None)

    # ---- cutting ------------------------------------------------------- #
    def checkpoint(self) -> Cut:
        snap, crc = self.builder.build()
        cut = Cut(self._seq, self.engine.tick, snap, crc)
        self._seq += 1
        self.cuts.append(cut)
        self.checkpoints_taken += 1
        if self.store:
            save_cut(cut, self.store)
        while len(self.cuts) > self.retention:
            dropped = self.cuts.pop(0)
            if dropped.path and os.path.exists(dropped.path):
                os.remove(dropped.path)
        return cut

    def maybe_checkpoint(self) -> Optional[Cut]:
        """Cut iff at least ``every_ticks`` passed since the last cut.

        Interval-based (not ``tick % every``), so a batched caller that
        polls at its natural window starts gets cuts exactly there —
        forcing a seam onto the grid would change the window partition,
        which is *not* bit-identity-preserving in general.  On a
        per-tick loop the interval degenerates to the classic grid.
        One cut per boundary: the historical tick-0 double cut
        (``__init__`` then the first grid hit, ``t - last == 0``) and
        post-recovery same-tick re-cuts are skipped, so counts stay
        honest.
        """
        t = self.engine.tick
        if self.every <= 0 or t - self.cuts[-1].tick < self.every:
            return None
        return self.checkpoint()

    # ---- fault injection hooks (chaos harness) ------------------------- #
    def corrupt_latest(self) -> bool:
        """Tamper the newest cut's payload (and file) so its CRC fails.
        Refuses when only the initial cut exists (nothing to fall back
        to); returns whether a cut was corrupted."""
        if len(self.cuts) < 2:
            return False
        cut = self.cuts[-1]
        cut.payload["state_units_moved"] = (
            float(cut.payload["state_units_moved"]) + 1.0e6)
        if cut.path and os.path.exists(cut.path):
            with open(cut.path, "r+b") as f:
                f.seek(8)
                b = f.read(1)
                f.seek(8)
                f.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        return True

    def drop_latest(self) -> bool:
        """Delete the newest cut (and file); refuses on the last one."""
        if len(self.cuts) < 2:
            return False
        cut = self.cuts.pop()
        if cut.path and os.path.exists(cut.path):
            os.remove(cut.path)
        return True

    # ---- recovery ------------------------------------------------------ #
    def recover(self, *, at_or_before: Optional[int] = None) -> Cut:
        """Restore the newest valid cut (optionally at-or-before a
        tick), CRC-verifying and falling back past corrupted cuts."""
        log = self._log()
        t_fail = self.engine.tick
        while True:
            cand = [c for c in self.cuts
                    if at_or_before is None or c.tick <= at_or_before]
            if not cand:
                raise CheckpointError("no valid checkpoint to restore")
            cut = cand[-1]
            if compute_crc(cut.payload) != cut.crc:
                self.corrupt_detected += 1
                self.cuts.remove(cut)
                if cut.path and os.path.exists(cut.path):
                    os.remove(cut.path)
                if log is not None:
                    log.record(
                        "checkpoint-corrupt", tick=t_fail,
                        cause=f"cut seq={cut.seq} tick={cut.tick} "
                              f"failed CRC verification",
                        action="fall back to previous valid cut")
                continue
            restore(self.engine, cut.payload)
            self.recoveries += 1
            self.replayed_ticks += max(0, t_fail - cut.tick)
            # Cuts newer than the restored one describe a future the
            # rolled-back timeline will re-reach (or, under chaos, a
            # fault-tainted one): drop them so the grid re-cuts.
            self.cuts = [c for c in self.cuts if c.tick <= cut.tick]
            if log is not None:
                log.record(
                    "recovery", tick=t_fail,
                    cause=f"failure at tick {t_fail}",
                    action=f"restored cut tick={cut.tick} "
                           f"(replays {max(0, t_fail - cut.tick)} ticks)")
            return cut

    def fail_and_recover(self) -> None:
        """Simulate losing a worker's volatile state; restore the
        newest valid cut."""
        self.recover()

    def run(self, max_ticks: int = 200_000, fail_at=()) -> int:
        fail_at = set(fail_at)
        while not self.engine.done() and self.engine.tick < max_ticks:
            if self.engine.tick in fail_at:
                fail_at.discard(self.engine.tick)
                self.fail_and_recover()
            self.maybe_checkpoint()
            self.engine.run_tick()
        return self.engine.tick
