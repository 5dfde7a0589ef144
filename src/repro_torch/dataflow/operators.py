"""Physical operators of the pipelined dataflow engine.

Each operator runs ``num_workers`` parallel workers (the paper's workers);
every worker owns an unprocessed-data queue (the phi metric source) and a
keyed state whose mutability class drives the migration strategy (paper §5,
Table 1):

  HashJoin probe   immutable   key -> build rows         REPLICATE
  HashJoin build   mutable     key -> build rows         MARKERS
  GroupBy          mutable     key -> (count, sum)       MARKERS/SCATTERED
  Sort (range)     mutable     range -> sorted buffer    MARKERS/SCATTERED
  Filter/Project   stateless
  Sink             terminal: accumulates the user-visible result series

The engine moves chunks, not tuples (DESIGN.md §7-1); a worker processes at
most ``service_rate`` tuples per tick.  Scattered state (mutable + SBR,
§5.4) is kept per (worker, scope) and merged to the scope's owner at END
markers before any blocked output is released.

Columnar state layout
---------------------
Keyed state is array-backed (:mod:`repro_torch.dataflow.state`): GroupBy holds
dense ``(counts, sums)`` columns folded per chunk with ``np.bincount``;
Sort and the join build side hold per-scope row buffers appended one column
*slice* per key segment (CSR on ``freeze()``); the join probe side counts
matches with a single dense gather.  The containers still speak the old
``dict``-of-scopes mapping protocol, so state migration (REPLICATE /
MARKERS / SCATTERED, paper §5), END-marker merges, checkpointing and tests
operate on scope-level views while the per-tuple Python loops are gone.
Chunks arrive pre-partitioned from the exchange subsystem
(:mod:`repro_torch.dataflow.exchange`) via :meth:`Operator.receive_sorted`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.state_migration import OperatorTraits
from ..core.types import StateMutability, TransferMode
from .state import AggStore, ScopeRows, segment_starts
from .tuples import Chunk, WorkerQueue, first_col


#: Key-stats fold crossover: a chunk with fewer than ``num_keys / ratio``
#: records updates arrival counts with scattered ``np.add.at`` instead of a
#: dense ``np.bincount`` (which allocates and folds O(num_keys) regardless
#: of chunk size).  Both are exact integer adds — results are identical.
SPARSE_FOLD_RATIO = 16


@dataclasses.dataclass
class WorkerStats:
    processed_total: int = 0          # tuples consumed
    emitted_total: int = 0            # tuples produced downstream


class Worker:
    """One parallel instance of an operator."""

    def __init__(self, wid: int):
        self.wid = wid
        self.queue = WorkerQueue()
        self.stats = WorkerStats()
        # Keyed state: scope -> val. Scope is an int key (hash ops) or a
        # range id (range ops). Stateful operators swap these dicts for
        # array-backed containers (AggStore / ScopeRows) at graph-build
        # time; both speak the same mapping protocol. `scattered` holds
        # parts of scopes whose owner is another worker (§5.4).
        self.state: Dict[int, object] = {}
        self.scattered: Dict[int, object] = {}


class Operator:
    """Base class. Subclasses implement ``process`` and state hooks."""

    #: traits consulted at workflow-compile time (§3.1 / Fig. 10)
    traits = OperatorTraits("abstract", StateMutability.IMMUTABLE)

    #: container class for array-backed keyed state (None = plain dict)
    state_factory: Optional[Callable[[int], object]] = None

    #: device-plane runtime (set by the engine when this operator's input
    #: edge is promoted into :mod:`repro.dataflow.device`); when active,
    #: queues + keyed state live on the accelerator and ``tick`` runs the
    #: fused jitted step instead of the host pop/process loop.
    device = None

    def __init__(self, name: str, num_workers: int, service_rate: int):
        self.name = name
        self.num_workers = num_workers
        self.service_rate = int(service_rate)
        self.workers = [Worker(w) for w in range(num_workers)]
        self.out_edge = None            # set by the engine
        self.finished = False           # all input consumed + END handled
        self.ended_inputs = 0           # END markers received
        self.expected_end_markers = 1   # one per upstream operator
        # Per-key arrival counts since the last metric collection
        # (owner-attributed by the adapter).  The fold is armed only when a
        # controller attaches (`track_key_stats`): unmonitored operators
        # skip the per-chunk O(n) stats pass entirely.
        self.arrived_by_key: Optional[np.ndarray] = None
        self.key_arrivals_total: Optional[np.ndarray] = None
        self.track_key_stats = False
        # Flipped by the input edge on its first routing rewrite: until
        # then every arrival is owner-routed by construction (hash init),
        # so stateful operators skip the per-chunk owned/scattered mask.
        self.may_scatter = False
        # Shared view of the input edge's RoutingTable.owner array: the
        # pre-mitigation primary of every scope. Mutable ops use it to
        # classify arrivals as owned vs scattered (paper §5.4).
        self.owner_of: Optional[np.ndarray] = None

    def _owned(self, worker: Worker, key: int) -> bool:
        return self.owner_of is None or int(self.owner_of[key]) == worker.wid

    def _owned_mask(self, worker: Worker, keys: np.ndarray) -> np.ndarray:
        if self.owner_of is None:
            return np.ones(keys.shape[0], dtype=bool)
        return self.owner_of[keys] == worker.wid

    # -- data plane ----------------------------------------------------- #
    def ensure_key_stats(self, num_keys: int) -> None:
        if self.arrived_by_key is None:
            self.arrived_by_key = np.zeros(num_keys, dtype=np.int64)
            self.key_arrivals_total = np.zeros(num_keys, dtype=np.int64)
            self._alloc_state(num_keys)

    def _alloc_state(self, num_keys: int) -> None:
        """Swap untouched dict state for the operator's array container."""
        if self.state_factory is None:
            return
        for w in self.workers:
            if isinstance(w.state, dict) and not w.state:
                w.state = self.state_factory(num_keys)
            if isinstance(w.scattered, dict) and not w.scattered:
                w.scattered = self.state_factory(num_keys)

    def receive(self, wid: int, keys: np.ndarray, vals: np.ndarray) -> None:
        self.workers[wid].queue.push(keys, vals)
        self._fold_key_stats(keys)

    def _fold_key_stats(self, keys: np.ndarray) -> None:
        """One key-stats update per chunk (armed by ``track_key_stats``):
        dense ``bincount`` (O(num_keys) allocation + fold) for ordinary
        chunks, scattered ``np.add.at`` when the chunk is tiny relative to
        the key space so wide key spaces never pay O(num_keys) per chunk."""
        if (not self.track_key_stats or self.arrived_by_key is None
                or not keys.size):
            return
        if keys.size * SPARSE_FOLD_RATIO < self.arrived_by_key.size:
            np.add.at(self.arrived_by_key, keys, 1)
            np.add.at(self.key_arrivals_total, keys, 1)
        else:
            bc = np.bincount(keys, minlength=self.arrived_by_key.size)
            self.arrived_by_key += bc
            self.key_arrivals_total += bc

    def receive_sorted(self, keys: np.ndarray, vals: np.ndarray,
                       bounds: np.ndarray) -> None:
        """Scatter a destination-grouped chunk: worker w gets the slice
        ``[bounds[w], bounds[w+1])``."""
        for w in range(self.num_workers):
            a, b = int(bounds[w]), int(bounds[w + 1])
            if b > a:
                self.workers[w].queue.push(keys[a:b], vals[a:b])
        self._fold_key_stats(keys)

    def receive_scatter(self, keys: np.ndarray, vals: np.ndarray,
                        plan) -> None:
        """Fused delivery from the exchange: gather each worker's records
        straight into its ring-buffer segment (``queue.alloc`` + one
        ``np.take(..., out=...)`` per column) — the one-pass
        partition→rank→scatter tail.  An identity plan (single live
        destination) degenerates to one plain push of the whole chunk.
        Equivalent record-for-record to ``receive_sorted`` on
        ``plan.take``-grouped columns."""
        order = plan.gather_indices()
        if order is None:
            self.workers[int(np.argmax(plan.hist))].queue.push(keys, vals)
        else:
            bounds = plan.bounds
            for w in np.flatnonzero(plan.hist):
                a, b = int(bounds[w]), int(bounds[w + 1])
                kv, vv = self.workers[int(w)].queue.alloc(b - a, keys, vals)
                np.take(keys, order[a:b], axis=0, out=kv)
                np.take(vals, order[a:b], axis=0, out=vv)
        self._fold_key_stats(keys)

    def tick(self, budget: Optional[int] = None) -> List[Chunk]:
        """Each worker consumes up to ``budget`` queued tuples (default one
        tick's ``service_rate``; the batched scheduler passes a K-tick
        super-chunk budget) and processes them in one pass; returns
        outputs."""
        if budget is None:
            budget = self.service_rate
        if self.device is not None:
            # Device plane: one fused jitted dispatch (partition → rank →
            # scatter → budgeted pop → fold/map) replaces the host loop;
            # stateless outputs are forwarded downstream by the runtime.
            return self.device.tick(budget)
        outs: List[Chunk] = []
        for w in self.workers:
            keys, vals = w.queue.pop(budget)
            if keys.size == 0:
                continue
            w.stats.processed_total += int(keys.size)
            out = self.process(w, keys, vals)
            if out is not None and out[0].size:
                w.stats.emitted_total += int(out[0].size)
                outs.append(out)
        return outs

    def process(self, worker: Worker, keys: np.ndarray, vals: np.ndarray) -> Optional[Chunk]:
        raise NotImplementedError

    # -- END handling (blocking operators override) ---------------------- #
    def on_end(self) -> List[Chunk]:
        """Called when END markers arrived from every upstream worker set
        and all queues are drained. Returns any final output chunks."""
        self.finished = True
        return []

    def queues_empty(self) -> bool:
        return self.backlog_total() == 0

    def backlog_total(self) -> int:
        """Total unprocessed tuples across workers (plane-independent)."""
        if self.device is not None:
            return self.device.backlog_total()
        return sum(len(w.queue) for w in self.workers)

    # -- device-plane boundary helpers ----------------------------------- #
    def _device_sync(self) -> None:
        """Materialize device-resident state before the host reads it."""
        if self.device is not None:
            self.device.sync_host()

    def _device_stale(self) -> None:
        """The host mutated keyed state: reload the device copy."""
        if self.device is not None:
            self.device.mark_state_stale()

    # -- state migration hooks (paper §5) -------------------------------- #
    def state_units(self, wid: int, mode: TransferMode) -> float:
        """Size of the keyed state a mitigation would ship (abstract units)."""
        self._device_sync()
        return float(sum(self._scope_size(v) for v in self.workers[wid].state.values()))

    @staticmethod
    def _scope_size(val) -> int:
        try:
            return len(val)  # type: ignore[arg-type]
        except TypeError:
            return 1

    def migrate_state(self, src: int, dst: int, scopes: Sequence[int], *, replicate: bool) -> float:
        """Move (or copy) the given scopes' state src -> dst.

        Returns the number of state units shipped. ``replicate=True`` keeps
        the source copy (immutable state / SBR split-key sharing).
        """
        self._device_sync()
        moved = 0.0
        s, d = self.workers[src], self.workers[dst]
        for scope in scopes:
            if scope not in s.state:
                continue
            val = s.state[scope]
            moved += self._scope_size(val)
            d.state[scope] = self._copy_scope(val)
            if not replicate:
                del s.state[scope]
        if moved:
            self._device_stale()
        return moved

    @staticmethod
    def _copy_scope(val):
        if isinstance(val, list):
            return list(val)
        if isinstance(val, np.ndarray):
            return val.copy()
        return val

    # -- metrics ---------------------------------------------------------- #
    def workloads(self) -> np.ndarray:
        if self.device is not None:
            return self.device.workloads()
        return np.array([len(w.queue) for w in self.workers], dtype=np.float64)

    def received_totals(self) -> np.ndarray:
        if self.device is not None:
            return self.device.received_totals()
        return np.array([w.queue.received_total for w in self.workers], dtype=np.float64)


# ----------------------------------------------------------------------- #
# Stateless operators                                                      #
# ----------------------------------------------------------------------- #
class Filter(Operator):
    """Keeps tuples whose (key, val) passes a predicate."""

    traits = OperatorTraits("filter", StateMutability.IMMUTABLE)

    def __init__(self, name, num_workers, service_rate,
                 predicate: Callable[[np.ndarray, np.ndarray], np.ndarray]):
        super().__init__(name, num_workers, service_rate)
        self.predicate = predicate

    def process(self, worker, keys, vals):
        mask = self.predicate(keys, vals)
        if mask.all():          # all-pass: forward the views, copy nothing
            return keys, vals
        return keys[mask], vals[mask]


class Project(Operator):
    """Applies (keys, vals) -> (keys', vals') elementwise.

    ``preserves_keys=True`` declares that ``fn`` never changes a
    record's key (it only transforms vals) — the contract that lets the
    device plane fuse this stage into a multi-edge chain and reuse the
    upstream edge's placement (:mod:`repro.dataflow.device`).  A
    re-keying ``fn`` must leave it False (the default): a chained stage
    would otherwise scatter records by their *old* key's placement.
    """

    traits = OperatorTraits("project", StateMutability.IMMUTABLE)

    def __init__(self, name, num_workers, service_rate,
                 fn: Callable[[np.ndarray, np.ndarray], Chunk],
                 preserves_keys: bool = False):
        super().__init__(name, num_workers, service_rate)
        self.fn = fn
        self.preserves_keys = bool(preserves_keys)

    def process(self, worker, keys, vals):
        return self.fn(keys, vals)


# ----------------------------------------------------------------------- #
# Shared behavior of row-buffer (CSR-style) keyed state                    #
# ----------------------------------------------------------------------- #
class _RowStateOp(Operator):
    """Operators whose scope value is a growing row buffer (ScopeRows)."""

    state_factory = ScopeRows

    @staticmethod
    def _scope_size(val) -> int:
        if isinstance(val, list):
            return int(sum(np.size(a) for a in val))
        return 1

    def state_units(self, wid: int, mode: TransferMode) -> float:
        rows = self.device.owned_rows(wid) if self.device is not None else None
        if rows is not None:
            return float(rows)          # the resident row log's mirror
        self._device_sync()
        st = self.workers[wid].state
        if isinstance(st, ScopeRows):
            return float(st.total_rows())
        return super().state_units(wid, mode)

    def _append_segments(self, worker: Worker, keys: np.ndarray,
                         vals: np.ndarray) -> None:
        """Route each key segment of the chunk to owned vs scattered rows."""
        order = np.argsort(keys, kind="stable")
        ks, vs = keys[order], vals[order]
        starts = segment_starts(ks)
        bounds = np.r_[starts, ks.size]
        for i, s in enumerate(starts):
            k = int(ks[s])
            table = worker.state if self._owned(worker, k) else worker.scattered
            table.append_scope(k, vs[s:bounds[i + 1]])

    def merge_scattered(self) -> int:
        """Ship scattered row buffers to their scope owners (§5.4)."""
        self._device_sync()
        moved = 0
        for w in self.workers:
            scat = w.scattered
            if not isinstance(scat, ScopeRows):
                continue
            for k in scat.present_scopes():
                owner = (self.workers[int(self.owner_of[k])]
                         if self.owner_of is not None else w)
                moved += owner.state.extend_from(scat, int(k))
            scat.clear()
        if moved:
            self._device_stale()
        return moved


# ----------------------------------------------------------------------- #
# HashJoin                                                                 #
# ----------------------------------------------------------------------- #
class HashJoinProbe(_RowStateOp):
    """Probe phase of HashJoin: immutable keyed state (paper Table 1).

    The build side is installed up-front via :meth:`install_build` (the
    paper's running example assumes the build phase finished, §3.1); each
    probe tuple emits one output per matching build row.  Match counting is
    one dense gather over the CSR row-length column.
    """

    traits = OperatorTraits(
        "hashjoin_probe",
        StateMutability.IMMUTABLE,
        mergeable_state=True,
        blocking=False,
    )

    def __init__(self, name, num_workers, service_rate, *, order_sensitive_downstream=False):
        super().__init__(name, num_workers, service_rate)
        self.traits = dataclasses.replace(
            HashJoinProbe.traits, order_sensitive_downstream=order_sensitive_downstream
        )

    def install_build(self, routing, build_keys: np.ndarray, build_vals: np.ndarray) -> None:
        """Partition the build table by the current routing owner.

        Routed through the exchange's fused counting-scatter placement
        (one stable grouping pass + one contiguous slice per receiving
        worker) instead of a per-unique-worker boolean-mask loop — the
        same ``ScatterPlan`` shape every edge send uses.
        """
        from .exchange import ScatterPlan, _bounds_of, scatter_order
        # Mid-run installs mutate host keyed state: materialize the
        # device copy first (the migrate_state/merge_scattered pattern),
        # else the post-install reload would rebuild rings from a stale
        # host snapshot and drop device-resident backlog.
        self._device_sync()
        bk = np.asarray(build_keys, dtype=np.int64)
        bv = np.asarray(build_vals, dtype=np.float64)
        self.ensure_key_stats(routing.num_keys)
        dest = routing.owner[bk]
        hist = np.bincount(dest, minlength=self.num_workers)
        plan = ScatterPlan(dest, hist, _bounds_of(hist),
                           order=scatter_order(dest, hist))
        gk, gv = plan.take(bk), plan.take(bv)
        for w in np.flatnonzero(hist):
            a, b = int(plan.bounds[w]), int(plan.bounds[w + 1])
            self.workers[int(w)].state.extend_segments(gk[a:b], gv[a:b])
        self._device_stale()

    def process(self, worker, keys, vals):
        # A split build key can hold rows in *both* the owned table and
        # `scattered` (SBR ships later build rows to helpers without
        # merging); match multiplicity is the SUM of both row sets — a
        # present-mask select would drop whichever side it didn't pick.
        matches = worker.state.counts_of(keys)
        if len(worker.scattered):
            matches = matches + worker.scattered.counts_of(keys)
        # Emit one tuple per (probe tuple x build match); join payload is
        # the probe val (enough for count/sum analytics downstream).
        out_keys = np.repeat(keys, matches)
        out_vals = np.repeat(vals, matches, axis=0)
        return out_keys, out_vals


class HashJoinBuild(_RowStateOp):
    """Build phase: mutable keyed state (key -> build rows)."""

    traits = OperatorTraits(
        "hashjoin_build",
        StateMutability.MUTABLE,
        mergeable_state=True,
        blocking=True,
    )

    def process(self, worker, keys, vals):
        self._append_segments(worker, keys, first_col(vals))
        return None

    def on_end(self):
        self.merge_scattered()
        self.finished = True
        return []


# ----------------------------------------------------------------------- #
# GroupBy (hash-based, blocking)                                           #
# ----------------------------------------------------------------------- #
class GroupByAgg(Operator):
    """count/sum per key; mutable, mergeable, blocking (paper §5.4).

    State is a dense (counts, sums) column pair per worker; a chunk folds
    in with two ``np.bincount`` calls split by the owned/scattered mask.
    """

    traits = OperatorTraits(
        "groupby",
        StateMutability.MUTABLE,
        mergeable_state=True,
        blocking=True,
    )

    state_factory = AggStore

    def process(self, worker, keys, vals):
        v = first_col(vals)
        if not self.may_scatter:    # no rewrite yet: all arrivals owned
            worker.state.add_many(keys, v)
            return None
        owned = self._owned_mask(worker, keys)
        if owned.all():
            worker.state.add_many(keys, v)
        else:
            worker.state.add_many(keys[owned], v[owned])
            worker.scattered.add_many(keys[~owned], v[~owned])
        return None

    @staticmethod
    def _scope_size(val) -> int:
        return 1

    def state_units(self, wid: int, mode: TransferMode) -> float:
        self._device_sync()
        return float(len(self.workers[wid].state))

    def merge_scattered(self) -> int:
        """Ship every scattered scope to its owner and fold it in (§5.4).

        Returns the number of scattered scopes merged (state units moved).
        """
        self._device_sync()
        moved = 0
        for w in self.workers:
            scat = w.scattered
            if not isinstance(scat, AggStore):
                continue
            sk = scat.present_scopes()
            if sk.size == 0:
                continue
            owners = (self.owner_of[sk] if self.owner_of is not None
                      else np.full(sk.size, w.wid))
            for o in np.unique(owners):
                self.workers[int(o)].state.merge_from(scat, sk[owners == o])
            moved += int(sk.size)
            scat.clear()
        if moved:
            self._device_stale()
        return moved

    def on_end(self):
        self.merge_scattered()
        self.finished = True
        outs = []
        for w in self.workers:
            ks = w.state.present_scopes()
            if ks.size == 0:
                continue
            cs = w.state.sums[ks]
            w.stats.emitted_total += int(ks.size)
            outs.append((ks.astype(np.int64), cs.astype(np.float64)))
        return outs


# ----------------------------------------------------------------------- #
# Sort (range-partitioned, blocking)                                       #
# ----------------------------------------------------------------------- #
class RangeSort(_RowStateOp):
    """Range-partitioned sort on ``vals``; scope = range id = routing key.

    Keys arriving here are *range ids* (the range partitioner upstream maps
    sort-attribute -> range id); vals are the sort attribute.  State is one
    growing buffer per range, appended one column slice per key segment;
    SBR splits a range's records across workers producing scattered buffers
    merged at END (paper Fig. 11).
    """

    traits = OperatorTraits(
        "sort",
        StateMutability.MUTABLE,
        mergeable_state=True,
        blocking=True,
    )

    def process(self, worker, keys, vals):
        self._append_segments(worker, keys, first_col(vals))
        return None

    def on_end(self):
        self.merge_scattered()
        self.finished = True
        outs = []
        for w in self.workers:
            for k in w.state.present_scopes():
                buf = np.sort(w.state.scope_array(int(k)))
                w.stats.emitted_total += int(buf.size)
                outs.append((np.full(buf.size, k, dtype=np.int64), buf))
        return outs

    def sorted_output(self) -> np.ndarray:
        """Globally sorted values: ranges in order, each locally sorted.

        Valid mid-run too: un-merged *scattered* buffers (an active SBR
        split parks a range's overflow rows on helper workers until the
        END merge) are folded in, so an exploratory query during a
        mitigation sees every received record, not just owner-resident
        ones.  Device-resident state is materialized first.
        """
        self._device_sync()
        per_range: Dict[int, List[np.ndarray]] = {}
        for w in self.workers:
            for table in (w.state, w.scattered):
                for k, parts in table.items():
                    per_range.setdefault(int(k), []).extend(parts)
        out = []
        for k in sorted(per_range):
            out.append(np.sort(np.concatenate(per_range[k])))
        return np.concatenate(out) if out else np.zeros(0)


# ----------------------------------------------------------------------- #
# Sink: the user-visible result accumulator                                #
# ----------------------------------------------------------------------- #
class Sink(Operator):
    """Terminal operator: accumulates per-key result counts over time.

    ``series`` records (tick, counts.copy()) snapshots — the bar chart the
    analyst watches (paper Figs. 3/6/16-19).
    """

    traits = OperatorTraits("sink", StateMutability.MUTABLE, mergeable_state=True,
                            blocking=False)

    def __init__(self, name, num_keys, *, snapshot_every: int = 1):
        super().__init__(name, num_workers=1, service_rate=2**31 - 1)
        self.counts = np.zeros(num_keys, dtype=np.int64)
        self.sums = np.zeros(num_keys, dtype=np.float64)
        self.series: List[Tuple[int, np.ndarray]] = []
        self.snapshot_every = snapshot_every
        self._tick = 0

    def process(self, worker, keys, vals):
        self.counts += np.bincount(keys, minlength=self.counts.size)
        self.sums += np.bincount(keys, weights=first_col(vals),
                                 minlength=self.sums.size)
        return None

    def snapshot(self, tick: int) -> None:
        self._tick = tick
        # snapshot_every of 0 or None disables the periodic series (the
        # END snapshot in `on_end` still fires); the modulo would raise
        # on either degenerate value.
        if self.snapshot_every and tick % self.snapshot_every == 0:
            if self.device is not None:
                # The boundary readback: the result columns leave the
                # device only on the snapshot grid.
                self.device.sync_sink_counts()
            self.series.append((tick, self.counts.copy()))

    def on_end(self):
        self.finished = True
        if self.device is not None:
            self.device.sync_host()
        self.series.append((self._tick + 1, self.counts.copy()))
        return []
