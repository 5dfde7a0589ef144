"""The pipelined dataflow engine (Amber/Flink stand-in).

Bulk-synchronous-per-chunk pipelined execution (DESIGN.md §7-1):

  tick t:
    1. every Source emits up to ``emit_rate`` tuples, routed through its
       out-edge's RoutingTable into downstream worker queues;
    2. operators (topological order) each let every worker consume up to
       ``service_rate`` queued tuples; outputs are routed downstream
       *within the same tick* (pipelining: an upstream output is visible
       to the downstream operator immediately);
    3. END propagation: an operator whose upstreams have all finished and
       whose queues are empty fires ``on_end`` (scattered-state merge,
       blocked output release) and forwards END;
    4. attached skew controllers run (metric collection, phase machine,
       detection) — their routing rewrites are the control messages;
    5. the sink snapshots the user-visible result series.

State-migration synchronization (paper §5) is implemented on the routing
rewrite itself: because ticks are atomic, a table rewrite *is* the
marker-aligned point at which no chunk is in flight, so

  immutable state     -> REPLICATE  : copy scopes to new mass receivers
  mutable + SBK       -> MARKERS    : move scope state, flip ownership
  mutable + SBR       -> SCATTERED  : nothing now; merge at END markers

Fault tolerance mirrors §2.2: :mod:`repro_torch.dataflow.checkpoint`
snapshots queues/state/routing/controller at tick boundaries (aligned
markers) and the engine can restore and replay after an injected worker
failure (:class:`~repro_torch.dataflow.resilience.ChaosRunner`).

Data plane
----------
Every edge delegates chunk routing to the fused columnar exchange
subsystem (:mod:`repro_torch.dataflow.exchange`): one backend call per chunk
returns a :class:`~repro_torch.dataflow.exchange.ScatterPlan` — destinations,
per-worker histogram, and a stable destination-grouping placement — so a
send is a single partition→rank→scatter pass with no separate sort.  The
partition backend — ``"torch"`` (default: the CUDA exchange kernel on the
engine's ``device``) or ``"numpy"`` (the host plane; bit-identical
destinations) — is chosen per engine via ``Engine(partition_backend=...)``
or globally via the ``REPRO_PARTITION_BACKEND`` environment variable.
Under the torch backend, ``Engine(device_executor="jit")`` promotes every
eligible edge (a single-upstream Filter / Project / GroupByAgg / Sink /
HashJoinBuild / HashJoinProbe / RangeSort destination) into the
device-resident plane (:mod:`repro_torch.dataflow.device`): chunks, ring
queues, split counters and keyed folds / row stores stay on the device for
a whole super-tick, one dispatch per edge (or per fused chain of
routing-equivalent edges), and the host materializes state only at the
boundaries ``_fusible_ticks`` computes; with ``device_budget`` each
resident edge bounds its resident entries and spills cold spans to
checksummed host segments (:mod:`repro_torch.dataflow.spill`).  The
default, ``device_executor="host"``, keeps the per-chunk torch exchange on
every edge.  ``Engine(reference=True)`` swaps in the pre-refactor
tuple-at-a-time oracle (:mod:`repro_torch.dataflow.reference`) for
equivalence tests.

Batched tick scheduler
----------------------
``Engine(batch_ticks=K)`` fuses up to K consecutive ticks into one
*super-tick*: one source emission of ``K * emit_rate`` tuples, one
``K * service_rate`` queue pop + process + exchange send per operator —
per-chunk Python dispatch, partition and scatter costs amortize K-fold
while the data-plane arithmetic is unchanged.  Fusion never crosses a
result or control boundary: a window always ends at (or before) the next
``Sink.snapshot_every`` tick, the next controller metric-collection tick
and the next pending control-message delivery tick, so the user-visible
result cadence and the control plane observe the same tick grid as the
per-tick scheduler.  Within a window, controllers and sink snapshots are
stepped through every covered tick in order (interior ticks are no-ops by
construction of the window).  The schedule depends only on configuration,
so runs are bit-identical across the numpy and torch planes (and the JAX
package's planes) for a given ``batch_ticks``.  An armed in-dispatch
controller (``device_controller``) runs its metric rounds inside the
window, so they no longer bound it; on the same windows its decisions
equal the host-stepped controller's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.controller import ReshapeController
from ..core.partitioner import RoutingTable
from ..core.state_migration import choose_strategy
from ..core.types import MigrationStrategy, ReshapeConfig, StateMutability, TransferMode
from ..devices import DeviceSpec, resolve_device
from .device import DeviceChunk
from .spill import resolve_budget
from .exchange import (BackendSpec, DeviceExchange, Exchange,
                       TorchPartitionBackend, get_backend)
from .operators import Operator, Sink
from .resilience import IncidentLog, RetryPolicy
from .tuples import Chunk, concat


class Source:
    """Bounded stream replayed at ``emit_rate`` tuples per tick."""

    def __init__(self, name: str, keys: np.ndarray, vals: np.ndarray, emit_rate: int):
        self.name = name
        self.keys = np.asarray(keys, dtype=np.int64)
        self.vals = np.asarray(vals, dtype=np.float64)
        self.emit_rate = int(emit_rate)
        self.pos = 0
        self.out_edge: Optional["Edge"] = None
        self.finished = False

    @property
    def remaining(self) -> int:
        return int(self.keys.size - self.pos)

    def emit(self, ticks: int = 1) -> Optional[Chunk]:
        """Emit up to ``ticks * emit_rate`` tuples as one contiguous chunk
        (bit-identical to ``ticks`` consecutive single-tick emissions)."""
        if self.pos >= self.keys.size:
            self.finished = True
            return None
        end = min(self.pos + ticks * self.emit_rate, self.keys.size)
        chunk = (self.keys[self.pos:end], self.vals[self.pos:end])
        self.pos = end
        if self.pos >= self.keys.size:
            self.finished = True
        return chunk


class Edge:
    """A partitioned exchange: RoutingTable + destination operator.

    The data plane (route + scatter) lives in the edge's
    :class:`~repro_torch.dataflow.exchange.Exchange`; the edge keeps the control
    plane: migration-strategy synchronization on routing rewrites.
    """

    def __init__(self, dst: Operator, num_keys: int, *, init: str = "hash",
                 backend: BackendSpec = None, device: DeviceSpec = "cuda",
                 reference: bool = False):
        self.dst = dst
        #: which plane carries this edge: "jit" (the device-resident
        #: runtime; the JAX package's name, run eagerly here),
        #: "demoted(<reason>)", or None (the per-chunk backend exchange);
        #: set by Engine._wire_device.
        self.device_plane: Optional[str] = None
        self.routing = RoutingTable(num_keys, dst.num_workers, init=init)
        dst.ensure_key_stats(num_keys)
        dst.owner_of = self.routing.owner           # shared view
        dst.expected_end_markers = 0                # engine recounts below
        #: migration strategy for rewrites on this edge; set when a
        #: controller is attached (engine default: replicate-or-scatter).
        self.strategy: Optional[MigrationStrategy] = None
        self.routing.listener = self._on_rewrite
        if reference:
            from .reference import ReferenceExchange
            self.exchange = ReferenceExchange(self.routing, dst)
        else:
            self.exchange = Exchange(self.routing, dst, backend, device)
        self.units_moved = 0.0

    @property
    def tuples_sent(self) -> int:
        return self.exchange.tuples_sent

    @tuples_sent.setter
    def tuples_sent(self, n: int) -> None:
        self.exchange.tuples_sent = int(n)

    @property
    def sent_per_worker(self) -> np.ndarray:
        """Per-worker tuples routed over this edge (the backend histogram)."""
        return self.exchange.sent_per_worker

    def send(self, chunk) -> None:
        if (isinstance(chunk, DeviceChunk)
                and not isinstance(self.exchange, DeviceExchange)):
            # Device -> host plane boundary: materialize + compact.
            chunk = chunk.to_host()
        self.exchange.send(chunk)

    # ---- state-migration synchronization (paper §5, Fig. 10) ---------- #
    def _on_rewrite(self, keys: List[int], old_rows: np.ndarray, new_rows: np.ndarray) -> None:
        op = self.dst
        strategy = self.strategy
        if strategy is None:
            # No controller: infer from mutability (Fig. 10 defaults).
            strategy = (
                MigrationStrategy.REPLICATE
                if op.traits.mutability is StateMutability.IMMUTABLE
                else MigrationStrategy.SCATTERED
            )
        # A rewrite that moves or copies state is a materialization boundary
        # for the device plane: the migrations below read/write host keyed
        # state.  A SCATTERED rewrite touches no state, so it is not one:
        # the resident runtime picks the new table (and may_scatter) up at
        # its next dispatch, and chunks staged before the rewrite still
        # route under the table they were sent under.
        if strategy is not MigrationStrategy.SCATTERED:
            op._device_sync()
        # From now on arrivals may land off-owner: stateful operators must
        # run the owned/scattered mask (skipped pre-rewrite, hash init).
        op.may_scatter = True
        if strategy in (MigrationStrategy.MARKERS, MigrationStrategy.PAUSE_RESUME):
            # Fold stray fragments to owners before any whole-key move, so
            # the moved scope is complete (the marker-synchronized point).
            if hasattr(op, "merge_scattered"):
                op.merge_scattered()
        for i, k in enumerate(keys):
            k = int(k)
            owner = int(self.routing.owner[k])
            receivers = np.nonzero(new_rows[i] > 0)[0]
            if strategy is MigrationStrategy.REPLICATE:
                # Copy the scope to every worker that now receives records
                # of it and lacks the state (immutable: safe to share).
                for w in receivers:
                    w = int(w)
                    if w != owner and k not in op.workers[w].state:
                        self.units_moved += op.migrate_state(owner, w, [k], replicate=True)
            elif strategy in (MigrationStrategy.MARKERS, MigrationStrategy.PAUSE_RESUME):
                # Mutable + SBK: a one-hot rewrite moves the scope. The
                # tick-atomic rewrite is the marker-aligned point.
                if receivers.size == 1 and int(receivers[0]) != owner:
                    dst_w = int(receivers[0])
                    self.units_moved += op.migrate_state(owner, dst_w, [k], replicate=False)
                    self.routing.owner[k] = dst_w
            # SCATTERED: nothing at rewrite time; merged at END (§5.4).


@dataclasses.dataclass
class _Attached:
    op: Operator
    edge: Edge
    controller: ReshapeController


class EngineAdapter:
    """Bridges one (edge, operator) pair to the ReshapeController protocol."""

    def __init__(self, engine: "Engine", op: Operator, edge: Edge):
        self.engine = engine
        self.op = op
        self.edge = edge
        self.num_workers = op.num_workers
        self.traits = op.traits
        self.routing = edge.routing

    def workloads(self) -> np.ndarray:
        return self.op.workloads()

    def arrivals_by_owner(self) -> np.ndarray:
        arrived = self.op.arrived_by_key
        out = np.zeros(self.num_workers, dtype=np.float64)
        if arrived is not None:
            np.add.at(out, self.routing.owner, arrived.astype(np.float64))
            arrived[:] = 0
        return out

    def key_shares(self, worker: int) -> Dict[int, float]:
        totals = self.op.key_arrivals_total
        if totals is None:
            return {}
        grand = max(float(totals.sum()), 1.0)
        owned = np.nonzero(self.routing.owner == worker)[0]
        return {int(k): float(totals[k]) / grand for k in owned if totals[k] > 0}

    def state_units(self, worker: int, mode: TransferMode) -> float:
        return self.op.state_units(worker, mode)

    def begin_migration(self, skewed: int, helpers: Sequence[int], mode: TransferMode) -> None:
        strategy = choose_strategy(self.op.traits, mode)
        if strategy is MigrationStrategy.REPLICATE:
            # "the state of all keys are sent to the helper in the first
            # phase" (§3.2): replicate S's whole partition state.
            scopes = [int(k) for k in np.nonzero(self.routing.owner == skewed)[0]]
            for h in helpers:
                moved = self.op.migrate_state(skewed, int(h), scopes, replicate=True)
                self.engine.state_units_moved += moved
        # MARKERS moves at the routing rewrite; SCATTERED merges at END.

    def tuples_left(self) -> float:
        return self.engine.tuples_left_for(self.op)

    def processing_rate(self) -> float:
        return float(self.op.num_workers * self.op.service_rate)


class Engine:
    """A DAG of sources, operators and partitioned edges.

    ``partition_backend`` selects the exchange backend for every edge
    (``"torch"`` | ``"numpy"`` | a PartitionBackend instance | None for
    the REPRO_PARTITION_BACKEND env default, else ``"torch"``); it is
    resolved once and shared by every edge.  ``device`` (default
    ``"cuda"``) is where the torch backend runs; without a card the engine
    raises unless ``device="cpu"``.  ``batch_ticks=K`` enables the batched
    tick scheduler (see module docstring) — ``run`` fuses up to K ticks per
    super-chunk pass, never crossing a sink-snapshot or controller
    boundary.

    ``device_executor`` picks the plane of eligible edges under the torch
    backend, with the JAX package's names: ``"host"`` (the default) keeps
    the per-chunk torch exchange on every edge, and ``"jit"`` promotes them
    to the device-resident runtime on ``device``, which the port runs
    eagerly, without tracing.  The default is the per-chunk plane because
    it is the faster one on the card so far: an eager resident dispatch
    costs more than the per-chunk round trip it saves (``PERF.md``).
    Ineligible edges (2-D payloads, a second upstream, a probe whose emit
    block would pass ``MAX_EMIT_CELLS`` with no ``device_budget`` set)
    always use the per-chunk exchange.

    ``device_chain`` (default: the ``REPRO_DEVICE_CHAIN`` environment
    variable, on unless it is ``"0"``) fuses consecutive resident edges
    whose routing tables are provably routing-equivalent
    (``RoutingTable.routing_token``) into one dispatch with one placement
    per super-tick; ``False`` keeps every edge apart, with the same bits.

    ``device_budget`` bounds each resident edge's device entries (an int
    or str cell count, a :class:`~repro_torch.dataflow.spill.SpillConfig`
    for other watermarks, or None for the ``REPRO_DEVICE_BUDGET``
    environment variable; unset, the spill tier is off): crossing the high
    watermark evicts cold spans to checksummed host segments instead of
    growing device state.

    ``device_controller`` (default: the ``REPRO_DEVICE_CONTROLLER``
    environment variable, off unless it is ``"1"``) runs each eligible
    attached controller (SBR + SCATTERED, one helper, no control delay) on
    its resident edge, inside the dispatch window: every metric round is
    one launch of the ``ctrl_step`` kernel, rounds no longer cut fused
    spans, and the host controller is reconciled at boundaries
    (:class:`~repro_torch.dataflow.device.DeviceController`).  Off, the
    host-stepped controller stays the oracle it is compared with.

    ``reference=True`` runs the pre-refactor tuple-at-a-time data plane
    instead (the testing oracle); it keeps no edge resident.

    So the switches of the resident plane are ``device_executor``,
    ``device_chain``, ``device_budget`` and ``device_controller``, each
    with its environment variable where it has one.
    """

    def __init__(self, *, partition_backend: BackendSpec = None,
                 batch_ticks: int = 1, device: DeviceSpec = "cuda",
                 device_executor: str = "host",
                 device_chain: Optional[bool] = None,
                 device_controller: Optional[bool] = None,
                 device_budget=None, reference: bool = False):
        if device_executor not in ("jit", "host"):
            raise ValueError(f"unknown device executor {device_executor!r}; "
                             f"choose from 'jit' and 'host'")
        self.device = resolve_device(device)
        self.partition_backend = get_backend(partition_backend, self.device)
        self.reference = bool(reference)
        self.device_executor = device_executor
        if device_chain is None:
            import os
            device_chain = os.environ.get("REPRO_DEVICE_CHAIN", "1") != "0"
        self.device_chain = bool(device_chain)
        if device_controller is None:
            import os
            device_controller = (
                os.environ.get("REPRO_DEVICE_CONTROLLER", "0") == "1")
        self.device_controller = bool(device_controller)
        #: per-edge device budget (cells) of the spill tier, resolved once
        #: (see :func:`repro_torch.dataflow.spill.resolve_budget`); each
        #: resident runtime starts from it.
        self.device_budget = resolve_budget(device_budget)
        self.batch_ticks = max(1, int(batch_ticks))
        self.sources: List[Source] = []
        self.ops: List[Operator] = []                 # topological order
        self.edges: List[Edge] = []
        self.upstreams: Dict[str, List[object]] = {}  # op.name -> producers
        self.controllers: List[_Attached] = []
        self.sink: Optional[Sink] = None
        self.tick = 0
        self.state_units_moved = 0.0
        self.ticks_to_finish: Optional[int] = None
        #: scheduler bookkeeping for the device plane's chain fusion:
        #: `_super_serial` names the current super-tick (a chain head
        #: marks the followers it advanced so their own ticks are
        #: skipped), `_super_k` is its width (follower budgets are
        #: ``k * service_rate``), `super_ticks` counts windows (the
        #: bench's placements-per-super-tick denominator).
        self._super_serial = 0
        self._super_k = 1
        self.super_ticks = 0
        #: resilience layer (see :mod:`repro_torch.dataflow.resilience`):
        #: structured queryable trail of every demotion, retry,
        #: mismatch-arbitration and recovery on this engine, plus the
        #: retry/backoff policy device dispatch consults before demoting.
        #: ``chaos`` is set by an active ChaosRunner (fault injection).
        self.incidents = IncidentLog()
        self.retry_policy = RetryPolicy()
        self.chaos = None

    # ---- graph construction ------------------------------------------- #
    def add_source(self, src: Source) -> Source:
        self.sources.append(src)
        return src

    def add_op(self, op: Operator) -> Operator:
        self.ops.append(op)
        self.upstreams.setdefault(op.name, [])
        if isinstance(op, Sink):
            self.sink = op
        return op

    def connect(self, producer, consumer: Operator, num_keys: int, *, init: str = "hash") -> Edge:
        edge = Edge(consumer, num_keys, init=init,
                    backend=self.partition_backend, device=self.device,
                    reference=self.reference)
        producer.out_edge = edge
        self.edges.append(edge)
        self.upstreams.setdefault(consumer.name, []).append(producer)
        self._wire_device(edge, consumer, producer)
        return edge

    def _wire_device(self, edge: Edge, consumer: Operator,
                     producer=None) -> None:
        """Promote an eligible torch edge into the device-resident plane.

        Eligible: the engine runs the torch backend without ``reference``,
        ``device_executor`` is not ``"host"``, and the destination is a
        single-upstream Filter / Project / GroupByAgg / Sink /
        HashJoinBuild / HashJoinProbe / RangeSort with a bounded
        (worker x key) dense structure
        (:func:`repro_torch.dataflow.device.wireable`).  A second upstream
        demotes an already promoted destination.  Ineligible edges keep
        the per-chunk exchange.

        Consecutive resident edges are also chain-linked when the producer
        is itself a resident Filter, Project or HashJoinProbe: the link is
        structural only, and each dispatch decides whether the chain fuses
        (:meth:`~repro_torch.dataflow.device.DeviceOpRuntime.
        _chain_for_dispatch`).
        """
        if (self.reference or self.device_executor == "host"
                or not isinstance(self.partition_backend,
                                  TorchPartitionBackend)):
            return
        from . import device as dev
        multi = len(self.upstreams[consumer.name]) > 1
        if multi and consumer.device is not None:
            consumer.device.demote("multiple upstreams")
            return
        if multi or not dev.wireable(consumer, edge.routing.num_keys):
            return
        runtime = dev.DeviceOpRuntime(consumer, edge, self)
        consumer.device = runtime
        edge.exchange = DeviceExchange(edge.routing, consumer, runtime)
        edge.device_plane = "jit"
        up = getattr(producer, "device", None)
        if isinstance(up, dev.DeviceOpRuntime) and up.kind in dev.MAP_KINDS:
            up.chain_down = runtime
            runtime.chain_up = up

    def attach_controller(
        self,
        op: Operator,
        cfg: Optional[ReshapeConfig] = None,
        controller_cls=ReshapeController,
        **kwargs,
    ):
        edge = self._in_edge(op)
        op.track_key_stats = True      # arm the per-chunk metric fold
        adapter = EngineAdapter(self, op, edge)
        controller = controller_cls(adapter, cfg, **kwargs)
        edge.strategy = getattr(controller, "strategy", None)
        self.controllers.append(_Attached(op, edge, controller))
        if self.device_controller and op.device is not None:
            op.device.arm_controller(controller)
        return controller

    def _in_edge(self, op: Operator) -> Edge:
        for e in self.edges:
            if e.dst is op:
                return e
        raise ValueError(f"no edge into {op.name}")

    # ---- execution ------------------------------------------------------ #
    def tuples_left_for(self, op: Operator) -> float:
        """Future tuples this operator will still receive: everything not
        yet emitted upstream plus everything queued upstream of it."""
        left = 0.0
        frontier = list(self.upstreams.get(op.name, []))
        seen = set()
        while frontier:
            node = frontier.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            if isinstance(node, Source):
                left += node.remaining
            else:
                left += node.backlog_total()
                frontier.extend(self.upstreams.get(node.name, []))
        return left

    def run_tick(self) -> None:
        """One engine tick (the per-tick scheduler; == run_super_tick(1))."""
        self.run_super_tick(1)

    def run_super_tick(self, k: int) -> None:
        """Advance ``k`` fused ticks with one super-chunk pass per operator.

        Data plane: one source emission of ``k * emit_rate`` tuples, one
        ``k * service_rate`` pop + process + exchange send per operator
        (topo order, so upstream super-output is visible downstream within
        the same window — pipelining at window granularity).  Control
        plane: END propagation once at the window end, then controllers
        and the sink snapshot are stepped through every covered tick in
        order; callers must pick ``k`` via :meth:`_fusible_ticks` so no
        interior tick carries a control or snapshot event.
        """
        t0 = self.tick
        # Name the window for the device plane's chain fusion: a chain
        # head advances its followers inside its own dispatch and marks
        # them with this serial so their ticks below are skipped.
        self._super_serial += 1
        self._super_k = k
        self.super_ticks += 1
        # 1. sources emit (one contiguous chunk == k per-tick emissions)
        for src in self.sources:
            if not src.finished:
                chunk = src.emit(k)
                if chunk is not None and src.out_edge is not None:
                    src.out_edge.send(chunk)
        # 2. operators process (topo order; outputs visible downstream now).
        # A window's output chunks (one per emitting worker) ride a single
        # exchange send: one fused partition + scatter per operator per
        # super-tick.
        for op in self.ops:
            if op.finished:
                continue
            if (op.device is not None
                    and op.device._chain_serial == self._super_serial):
                continue            # advanced by its chain head's dispatch
            outs = op.tick(k * op.service_rate)
            if outs and op.out_edge is not None:
                op.out_edge.send(outs[0] if len(outs) == 1 else concat(outs))
        # 3. END propagation
        for op in self.ops:
            if op.finished:
                continue
            ups = self.upstreams.get(op.name, [])
            if ups and all(self._producer_done(u) for u in ups) and op.queues_empty():
                outs = op.on_end()
                if outs and op.out_edge is not None:
                    op.out_edge.send(outs[0] if len(outs) == 1
                                     else concat(outs))
        # 4 + 5. controllers and sink snapshot, through every covered tick
        # (interior ticks are no-ops when k came from _fusible_ticks).
        # The window end is a control boundary: drain device-resident
        # per-key arrival stats for monitored operators so the metric
        # rounds read exactly what the host plane would have folded.
        # With ``device_controller`` an armed runtime instead runs every
        # covered metric round in-dispatch (one ``ctrl_step`` launch, no
        # stats readback); its host twin is skipped below and reconciled
        # at the next boundary.
        for att in self.controllers:
            dev = att.op.device
            if dev is None:
                continue
            if (self.device_controller and dev.ctrl is None
                    and not att.op.finished):
                dev.arm_controller(att.controller)   # late/post-restore arm
            ctrl = dev.ctrl
            if (ctrl is not None and ctrl.active
                    and ctrl.host is att.controller):
                if att.op.finished:
                    ctrl.drain()
                else:
                    ctrl.super_tick(t0, k)
                continue
            dev.sync_stats()
            if hasattr(att.controller, "sync_readbacks"):
                # one O(W) boundary readback feeding this controller
                att.controller.sync_readbacks += 1
        for t in range(t0, t0 + k):
            for att in self.controllers:
                if att.op.finished:
                    continue
                dev = att.op.device
                if (dev is not None and dev.ctrl is not None
                        and dev.ctrl.active
                        and dev.ctrl.host is att.controller):
                    continue     # already stepped inside the dispatch
                att.controller.step(t)
            if self.sink is not None:
                self.sink.snapshot(t)
        self.tick = t0 + k

    def _fusible_ticks(self, horizon: int) -> int:
        """Width of the next fused window, starting at the current tick.

        Bounded by ``horizon`` and by the next control/result boundary —
        the earliest tick at which the sink snapshots, any attached
        controller collects metrics, or a pending control message becomes
        deliverable.  A boundary tick may only be the *last* tick of a
        window (its event runs at the window end, exactly where the
        per-tick scheduler would run it after that tick's data pass).
        """
        if horizon <= 1:
            return 1
        t0 = self.tick
        nxt = t0 + horizon - 1          # latest admissible window end
        if self.sink is not None:
            # snapshot_every may be 0 or None ("periodic snapshots off",
            # only the END snapshot): no result boundary bounds fusion.
            # int() the truthy case only — int(None) raises.
            every = int(self.sink.snapshot_every or 0)
            if every > 0:
                nxt = min(nxt, t0 + (-t0) % every)
        for att in self.controllers:
            if att.op.finished:
                continue
            ctrl = att.controller
            if getattr(ctrl, "fired", False):
                continue                # one-shot controller already fired
            cfg = getattr(ctrl, "cfg", None)
            if cfg is None:             # unknown cadence: stay tick-exact
                return 1
            dev = getattr(att.op, "device", None)
            if (dev is not None and dev.ctrl is not None
                    and dev.ctrl.active and dev.ctrl.host is ctrl):
                # Device-resident controller: its metric rounds run
                # inside the fused dispatch, so they are no longer
                # window boundaries.  Only deliverable control messages
                # (never pending for an armed controller, but cheap to
                # honor) still cut.
                pending = [p.apply_at
                           for p in getattr(ctrl, "_pending", ())]
                if pending:
                    nxt = min(nxt, max(t0, min(pending)))
                continue
            period = max(1, int(getattr(cfg, "metric_period", 1)))
            delay = int(getattr(cfg, "initial_delay_ticks", 0))
            # First actionable tick (FlowJoin defers past its detection
            # sample); the metric grid stays phased on `delay`.
            start = max(t0, delay + int(getattr(ctrl, "detect_ticks", 0)))
            nxt = min(nxt, start + (delay - start) % period)
            pending = [p.apply_at for p in getattr(ctrl, "_pending", ())]
            if pending:
                nxt = min(nxt, max(t0, min(pending)))
        return max(1, nxt - t0 + 1)

    def _producer_done(self, node) -> bool:
        return bool(node.finished)

    def done(self) -> bool:
        return all(s.finished for s in self.sources) and all(o.finished for o in self.ops)

    def run(self, max_ticks: int = 100_000) -> int:
        while not self.done() and self.tick < max_ticks:
            if self.batch_ticks == 1:
                self.run_super_tick(1)
            else:
                self.run_super_tick(self._fusible_ticks(
                    min(self.batch_ticks, max_ticks - self.tick)))
        if self.done() and self.ticks_to_finish is None:
            self.ticks_to_finish = self.tick
        return self.tick
