"""The device-resident exchange plane: one eager dispatch per edge per super-tick.

Counterpart of ``repro.dataflow.device``.  An eligible edge keeps its whole
data plane on the engine's device between host boundaries: the staged
chunks, the per-worker ring queues, the routing constants (float32 row-CDF,
split mask, owners), the per-key split counters, and the destination's
keyed fold (GroupByAgg), row store (HashJoinBuild / RangeSort) or sink
columns live as ``torch`` tensors, and :meth:`DeviceOpRuntime.tick`
advances them — split counters → partition → within-destination rank →
ring scatter → budgeted pop → fold / row append / map (Filter, Project) —
in one dispatch per edge per super-tick.  The JAX package traces that
dispatch into one jitted program; here it runs eagerly, as a few dozen
tensor operations on the current stream, and updates the state tensors in
place (the runtime owns them; nothing else holds a reference).

Every ingest and every sink fold goes through the hand-written CUDA kernel
K2 :func:`repro_torch.kernels.partition.partition_scatter_fold` (its plain
PyTorch version on the CPU): one pass gives the destination, the
within-destination rank and the histogram over the chunk's live lanes, and
its per-key count column is the key-arrival stats fold.  On a one-hot
table the split counters are skipped and the counters are 0: under the
saturated CDF a one-hot row sends every threshold u < 1 to its primary, so
the destinations equal ``primary[key]`` bit for bit.

Host readback is confined to

  * one stacked O(num_workers) copy per dispatch step — histogram, popped
    counts and, for maps, emitted counts or, for row state, owned rows
    appended — that keeps the exact host mirrors (queue lengths,
    ``sent_per_worker``, worker stats, the owned-row counts the
    controller's state-size reads use) without touching record data, and
  * materialization only at the boundaries the batched scheduler already
    computes: sink snapshots (:meth:`sync_sink_counts`, a copy only if the
    sink folded since the last one), controller metric rounds
    (:meth:`sync_stats`), END markers, routing rewrites that move or copy
    state and migrations (:meth:`sync_host`).  A SCATTERED rewrite touches
    no state and is no boundary.  ``sync_host`` copies the live span of
    each ring and only the rows appended to the row log since the previous
    boundary (the log is append-only, and the host keeps what it was given
    before); the JAX plane re-materializes the whole log, which under an
    active mitigation — a rewrite every few ticks — makes a run quadratic
    in its length.

Chunks handed from one device operator to the next stay on the device as
padded, validity-masked :class:`DeviceChunk` buffers (a Filter's output
has dead lanes anywhere in it); an edge that is not resident compacts
them on the host (``Edge.send``).

Bit-exactness: destinations, ranks, histograms, queue contents, split
counters, row stores and every integer metric are identical to the host
numpy plane.  Only float sums may differ in their last bits: GroupByAgg
sums fold with ``index_add_`` (atomic order on the card), and the sink
adds K2's float32 per-chunk sums to its float64 columns, as the JAX
package's kernel sink does, so sink sums differ from the host plane's in
about the 7th digit.  The cross-plane contract is therefore stated on
``Sink.series``, ``Sink.counts``, the counters and the mirrors, all
integers.

Not ported yet from the JAX plane (each in ``ROADMAP.md``): the
HashJoinProbe expand stage (probe edges keep the per-chunk exchange),
multi-edge chain fusion, the spill tier and checkpoint restore
(``on_restore``), the in-dispatch controller and the sanitizers.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels import partition as kpart
from .tuples import Chunk, ring_span

__all__ = ["DeviceChunk", "DeviceOpRuntime", "StepSpec", "UserFunctionError",
           "wireable"]

#: fold-state ceiling: skip device wiring when W * K explodes.
MAX_FOLD_CELLS = 1 << 22

#: pop-window ceiling: a ring-backed operator's per-super-tick budget
#: bounds the static window width B; "effectively unbounded" service rates
#: (the Sink idiom, 2**31-1) would demand an absurd window, so such
#: operators stay on the per-chunk path (the Sink itself has no rings).
MAX_SERVICE_RATE = 1 << 20

State = Dict[str, torch.Tensor]
Consts = Dict[str, torch.Tensor]


def wireable(op, num_keys: int) -> bool:
    """Is ``op`` a device-wireable destination for an edge of ``num_keys``?

    Exact types only (a subclass may override ``process``): Filter,
    Project, GroupByAgg, Sink, HashJoinBuild and RangeSort.  The dense
    per-(worker, key) fold keeps wide key spaces on the per-chunk path, and
    K2 takes at most ``MAX_WORKERS`` destinations.
    """
    from .operators import (Filter, GroupByAgg, HashJoinBuild, Project,
                            RangeSort, Sink)
    if type(op) not in (Filter, Project, GroupByAgg, Sink, HashJoinBuild,
                        RangeSort):
        return False
    # Row-state operators keep no dense [W, K] structure (their state is a
    # [W, rcap] row log), so only the K-sized routing consts gate them.
    if type(op) in (HashJoinBuild, RangeSort):
        cells_ok = num_keys <= MAX_FOLD_CELLS
    else:
        cells_ok = op.num_workers * num_keys <= MAX_FOLD_CELLS
    return (cells_ok and op.num_workers <= kpart.MAX_WORKERS
            and (type(op) is Sink or op.service_rate <= MAX_SERVICE_RATE))


class UserFunctionError(RuntimeError):
    """A Filter predicate or Project map failed on device tensors."""


# --------------------------------------------------------------------- #
# Device chunks                                                          #
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class DeviceChunk:
    """A padded, validity-masked chunk resident on the device.

    ``n_live`` is the host-known number of live lanes (exact: it comes from
    the emitting step's metric readback), so the engine makes control
    decisions — skip empty sends, END detection — without reading the mask.
    """

    keys: torch.Tensor           # [NB] int64
    vals: torch.Tensor           # [NB] float64
    valid: torch.Tensor          # [NB] bool
    n_live: int

    def to_host(self) -> Chunk:
        """Materialize + compact (the device -> host plane boundary), with
        one device-to-host copy of the three columns."""
        packed = torch.stack([self.keys, self.vals.view(torch.int64),
                              self.valid.to(torch.int64)]).cpu().numpy()
        live = packed[2].astype(bool)
        return packed[0][live], packed[1].view(np.float64)[live]


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """The static shape of one dispatch step."""

    kind: str        # "fold" | "filter" | "project" | "sink" | "rows"
    W: int                       # destination workers
    K: int                       # key-space size
    cap: int                     # ring capacity (power of two)
    B: int                       # pop-window width (max budget)
    any_split: bool              # routing table carries split keys
    may_scatter: bool            # owned/scattered fold split armed
    track_stats: bool            # per-key arrival stats fold armed
    fn: Optional[Callable] = None   # Filter predicate / Project map
    M: int = 1                   # probe fanout bound (probe not ported)
    rcap: int = 0                # rows: segment-store capacity (pow2)


# --------------------------------------------------------------------- #
# Step building blocks                                                   #
# --------------------------------------------------------------------- #
# Flat state buffers carry one sentinel cell past their [W, cap] grid:
# dead lanes of a scatter are aimed at it, which takes the place of JAX's
# ``.at[...].set(mode="drop")`` without a host synchronisation (boolean
# indexing would read the mask back to learn its size).

def _grid(buf: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """The ``[rows, cols]`` view of a flat buffer without its sentinel."""
    return buf[:rows * cols].view(rows, cols)


_IOTA: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def _iota(n: int, device: torch.device) -> torch.Tensor:
    """``arange(n)`` int64 on ``device``, made once and only read."""
    t = _IOTA.get((n, device))
    if t is None:
        t = _IOTA[(n, device)] = torch.arange(n, dtype=torch.int64,
                                              device=device)
    return t


def _split_counters(spec: StepSpec, consts: Consts, count: torch.Tensor,
                    keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Device twin of ``RoutingTable.advance_counters``: per-record running
    split-key counters (within-chunk occurrence + persistent count); the
    persistent counts in ``count`` advance in place.  Dead lanes and
    one-hot keys consume nothing.  Integer ops only, so nothing
    reassociates."""
    live = valid & consts["is_split"][keys]
    n = keys.shape[0]
    arange = _iota(n, keys.device)
    sent = torch.where(live, keys, spec.K)        # dead lanes sort last
    order = torch.argsort(sent, stable=True)
    sk = sent[order]
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = sk[1:] != sk[:-1]
    seg_start = torch.cummax(torch.where(starts, arange, 0), dim=0).values
    occ = torch.empty_like(arange)
    occ[order] = arange - seg_start
    counters = torch.where(live, count[keys] + occ, 0)
    count.index_add_(0, keys, live.to(torch.int64))
    return counters


def _fold_stats(state: State, counts: torch.Tensor) -> None:
    """Per-key arrival stats fold (armed when a controller monitors the
    operator): ``counts`` is K2's per-key live-lane count."""
    state["arrived"] += counts
    state["totals"] += counts


def _ingest(spec: StepSpec, consts: Consts, state: State,
            chunk: DeviceChunk) -> torch.Tensor:
    """Route + ring-scatter one staged chunk through K2; returns K2's int32
    histogram.  K2 takes the chunk's int64 keys and counters (None when no
    key is split: all zero) and float64 vals as they are and narrows them
    as ``.to(torch.int32)`` / ``.to(torch.float32)`` would, so the call is
    one launch with no cast or fill before it."""
    keys, vals, valid = chunk.keys, chunk.vals, chunk.valid
    counters = (_split_counters(spec, consts, state["count"], keys, valid)
                if spec.any_split else None)
    dest, rank, hist, fcnt, _ = kpart.partition_scatter_fold(
        keys, counters, vals, valid, consts["cdf"])
    _push(spec, state, keys, vals, valid, dest, rank, hist)
    if spec.track_stats:
        _fold_stats(state, fcnt)
    return hist


def _push(spec: StepSpec, state: State, keys, vals, valid, dest, rank,
          hist) -> None:
    d = dest.to(torch.int64)
    pos = (state["tail"][d] + rank) % spec.cap
    flat = torch.where(valid, d * spec.cap + pos, spec.W * spec.cap)
    state["rk"].index_put_((flat,), keys)
    state["rv"].index_put_((flat,), vals)
    state["tail"] += hist


def _pop(spec: StepSpec, state: State, budget: int):
    """Budgeted pop of a ``[W, B]`` window: (keys, vals, mask, take)."""
    head = state["head"]
    take = torch.clamp(state["tail"] - head, max=int(budget))    # [W]
    iot = _iota(spec.B, head.device)
    idx = (head[:, None] + iot[None, :]) % spec.cap
    wmask = iot[None, :] < take[:, None]                          # [W, B]
    wk = _grid(state["rk"], spec.W, spec.cap).gather(1, idx)
    wv = _grid(state["rv"], spec.W, spec.cap).gather(1, idx)
    head += take
    return wk, wv, wmask, take


def _as_window(x, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A user function's result (numpy or torch, scalar or ``[W, B]``) as a
    ``[W, B]`` tensor on ``like``'s device."""
    t = torch.as_tensor(x, device=like.device).to(dtype)
    return t.expand(like.shape)


def _map_stage(spec: StepSpec, wk: torch.Tensor, wv: torch.Tensor,
               wmask: torch.Tensor):
    """Apply a Filter predicate / Project map to a popped ``[W, B]``
    window; returns (out_keys, out_vals, keep).  The user function sees
    torch tensors on the device and may return numpy or torch values; any
    exception it (or the coercion of its result) raises becomes a
    :class:`UserFunctionError`."""
    try:
        if spec.kind == "filter":
            return wk, wv, wmask & _as_window(spec.fn(wk, wv), wk,
                                              torch.bool)
        ok, ov = spec.fn(wk, wv)
        return (_as_window(ok, wk, wk.dtype), _as_window(ov, wv, wv.dtype),
                wmask)
    except Exception as exc:
        raise UserFunctionError(
            f"{spec.kind} function failed on device tensors "
            f"({type(exc).__name__}: {exc})") from exc


def _fold_rows(spec: StepSpec, consts: Consts, state: State, wk, wv, wmask,
               take) -> torch.Tensor:
    """Segment-append of a popped ``[W, B]`` window into the device row
    store (the HashJoinBuild / RangeSort tail): lane *j* of worker *w*
    lands at ``row_len[w] + j`` (the window's live lanes are a prefix) with
    its key and an owned flag frozen at fold time — the device mirror of
    ``_RowStateOp._append_segments``, kept as one flat arrival-order log per
    worker and regrouped by key only at host boundaries.  Returns the
    number of owned rows appended per worker."""
    dev = wk.device
    wid = _iota(spec.W, dev)[:, None]
    owned = wmask & (consts["owner"][wk] == wid)
    pos = state["rlen"][:, None] + _iota(spec.B, dev)[None, :]
    flat = torch.where(wmask, wid * spec.rcap + pos,
                       spec.W * spec.rcap).reshape(-1)
    state["bk"].index_put_((flat,), wk.reshape(-1))
    state["bv"].index_put_((flat,), wv.reshape(-1))
    state["bo"].index_put_((flat,), owned.reshape(-1))
    state["rlen"] += take
    return owned.sum(dim=1)


def _fold_popped(spec: StepSpec, consts: Consts, state: State, wk, wv,
                 wmask) -> None:
    """Owned/scattered keyed fold of a popped ``[W, B]`` window (the
    GroupByAgg tail).  Counts add exactly; float64 sums add with
    ``index_add_`` (atomic order on the card)."""
    wid = _iota(spec.W, wk.device)[:, None]
    owned = (consts["owner"][wk] == wid) if spec.may_scatter else wmask
    flat = (wid * spec.K + wk).reshape(-1)
    wvf = wv.reshape(-1)
    for prefix, m in (("", wmask & owned), ("scat_", wmask & ~owned)):
        mf = m.reshape(-1)
        state[prefix + "counts"].index_add_(0, flat, mf.to(torch.int64))
        state[prefix + "sums"].index_add_(0, flat, torch.where(mf, wvf, 0.0))
        # ``present |= m``: live lanes set their cell, dead ones the sentinel.
        state[prefix + "present"].index_put_(
            (torch.where(mf, flat, spec.W * spec.K),), mf)


def _step(spec: StepSpec, consts: Consts, state: State,
          chunk: Optional[DeviceChunk], budget: int):
    """One fold / rows / map step: optional ingest, pop, tail.  Returns
    (metrics, out chunk columns or None): ``metrics`` stacks the int64
    histogram, the popped counts and, for a map, the emitted counts or, for
    rows, the owned rows appended, per worker."""
    if chunk is not None:
        hist = _ingest(spec, consts, state, chunk).to(torch.int64)
    else:
        hist = torch.zeros(spec.W, dtype=torch.int64,
                           device=state["tail"].device)
    wk, wv, wmask, take = _pop(spec, state, budget)
    if spec.kind == "rows":
        owned = _fold_rows(spec, consts, state, wk, wv, wmask, take)
        return torch.stack([hist, take, owned]), None
    if spec.kind == "fold":
        _fold_popped(spec, consts, state, wk, wv, wmask)
        return torch.stack([hist, take]), None
    ok, ov, keep = _map_stage(spec, wk, wv, wmask)
    out = (ok.reshape(-1), ov.reshape(-1), keep.reshape(-1))
    return torch.stack([hist, take, keep.sum(dim=1)]), out


def _sink_step(spec: StepSpec, ones_cdf: torch.Tensor, state: State,
               chunk: DeviceChunk) -> None:
    """Fold one staged chunk into the sink columns through K2 (W == 1: the
    ones CDF routes every lane to worker 0; the kernel's per-key counts and
    float32 sums are the fold)."""
    _, _, _, fcnt, fsum = kpart.partition_scatter_fold(
        chunk.keys, None, chunk.vals, chunk.valid, ones_cdf)
    if spec.track_stats:
        _fold_stats(state, fcnt)
    state["counts"] += fcnt
    state["sums"] += fsum


def _pow2(n: int) -> int:
    p = 256
    while p < n:
        p <<= 1
    return p


# --------------------------------------------------------------------- #
# The per-(edge, operator) runtime                                        #
# --------------------------------------------------------------------- #
class DeviceOpRuntime:
    """Owns one destination operator's device residency.

    Created by the engine when an edge's destination is wireable and the
    resident plane is selected.  The host keeps exact integer mirrors
    (queue lengths, received/processed/emitted totals) updated from the
    O(W) per-dispatch metrics; record data stays on the device until
    :meth:`sync_host`.
    """

    def __init__(self, op, edge, engine):
        from .operators import (Filter, GroupByAgg, HashJoinBuild, Project,
                                RangeSort, Sink)

        self.op = op
        self.edge = edge
        self.engine = engine
        self.device = engine.device
        self.routing = edge.routing
        self.kind = {Filter: "filter", Project: "project",
                     GroupByAgg: "fold", Sink: "sink",
                     HashJoinBuild: "rows", RangeSort: "rows"}[type(op)]
        self.W = op.num_workers
        self.K = edge.routing.num_keys
        self.NB = 0                    # upload padding width
        self.B = 0                     # pop-window width
        self.cap = 0                   # ring capacity (pow2)
        self.rcap = 0                  # rows segment-store capacity (pow2)
        #: rows kind: per-worker row-log length (exact host mirror, the
        #: twin of ``ScopeRows.total_rows()`` across state + scattered).
        self.rows_len = np.zeros(op.num_workers, dtype=np.int64)
        #: rows kind: per-worker prefix of the row log already in the host
        #: ScopeRows (the log is append-only, so a boundary materializes
        #: only the rows appended since the last one).
        self.rows_synced = np.zeros(op.num_workers, dtype=np.int64)
        #: rows kind: per-worker owned rows (exact host mirror of the owned
        #: ScopeRows' ``total_rows()``), so the controller's state-size
        #: reads need no boundary.
        self.rows_owned = np.zeros(op.num_workers, dtype=np.int64)
        self.state: Optional[State] = None    # allocated at first dispatch
        self.consts: Optional[Consts] = None
        self._consts_version = -1
        self._dispatched = False
        self.staged: List[DeviceChunk] = []
        self.staged_live = 0
        # host mirrors (exact integers, updated per dispatch)
        self.lens = np.zeros(self.W, dtype=np.int64)
        self.received = np.zeros(self.W, dtype=np.int64)
        self._fn = getattr(op, "predicate", None) or getattr(op, "fn", None)
        self._pull = self._pull_counters    # stable identity (ownership)
        self._host_fresh = False   # host copies match device state
        self._reload_pending = False   # host mutated: reload pre-dispatch
        self._consts_split = False  # any_split of the uploaded consts
        #: placement (partition + scatter) executions, one per ingested
        #: chunk (``DeviceExchange.placements``).
        self.placements = 0
        #: the routing token under which all current ring content was
        #: placed (None = mixed/unknown): the placement epoch that chain
        #: fusion (not ported yet) must match before reusing a placement.
        self._placed_token = None
        # Chain links and the in-dispatch controller are not ported; the
        # engine reads these attributes on every operator's runtime.
        self.chain_up: Optional["DeviceOpRuntime"] = None
        self.chain_down: Optional["DeviceOpRuntime"] = None
        self._chain_serial = -1
        self.ctrl = None
        #: the sink's [K, 1] ones CDF for K2, built once.
        self._ones_cdf: Optional[torch.Tensor] = None
        #: the sink folded since its columns were last read back.
        self._sink_dirty = False

    # ---- small helpers ------------------------------------------------ #
    def _spec(self, any_split: Optional[bool] = None) -> StepSpec:
        rt = self.routing
        rt._refresh_derived()
        if any_split is None:
            any_split = bool(rt._any_split)
        return StepSpec(kind=self.kind, W=self.W, K=self.K, cap=self.cap,
                        B=self.B, any_split=bool(any_split),
                        may_scatter=bool(self.op.may_scatter),
                        track_stats=bool(self.op.track_key_stats
                                         and self.op.arrived_by_key
                                         is not None),
                        fn=self._fn, rcap=self.rcap)

    def _put(self, a, dtype: torch.dtype) -> torch.Tensor:
        """Upload a host array (always a copy, also on the CPU)."""
        return torch.tensor(a, dtype=dtype, device=self.device)

    def backlog_total(self) -> int:
        return int(self.lens.sum()) + self.staged_live

    def workloads(self) -> np.ndarray:
        out = self.lens.astype(np.float64)
        if self.W == 1:
            out = out + float(self.staged_live)
        return out

    def received_totals(self) -> np.ndarray:
        return self.received.astype(np.float64)

    def owned_rows(self, worker: int) -> Optional[int]:
        """Rows kind: the owned rows of ``worker`` from the exact mirror, or
        None when the host copy is the one to read (no device state yet, or
        a host mutation not reloaded)."""
        if self.kind != "rows" or self.state is None or self._reload_pending:
            return None
        return int(self.rows_owned[worker])

    def _live_token(self):
        """The routing token of the live table (the JAX plane returns None
        while its in-dispatch controller holds unreconciled rewrites; that
        controller is not ported)."""
        return self.routing.routing_token()

    # ---- demotion (per-chunk fallback) -------------------------------- #
    def demote(self, reason: str) -> None:
        """Fall back to the per-chunk torch exchange (2-D vals, a user
        function that fails on device tensors, or a second in-edge)."""
        from .exchange import Exchange
        staged, self.staged, self.staged_live = self.staged, [], 0
        if self.kind == "sink":
            # Staged sink chunks were accounted at stage time; the re-send
            # below accounts again.  Back the mirror out *before* sync_host
            # materializes it into queue.received_total.
            for ch in staged:
                self.received[0] -= ch.n_live
        if self.state is not None:
            self.sync_host()
        self.op.device = None
        old = self.edge.exchange
        ex = Exchange(self.routing, self.op, self.engine.partition_backend)
        ex.tuples_sent = old.tuples_sent
        ex.sent_per_worker[:] = old.sent_per_worker
        if self.kind == "sink":
            for ch in staged:
                ex.tuples_sent -= ch.n_live
                ex.sent_per_worker[0] -= ch.n_live
        self.edge.exchange = ex
        self.edge.device_plane = f"demoted({reason})"
        self.engine.incidents.record(
            "demotion", tick=self.engine.tick, edge=self.op.name,
            cause=reason, action="per-chunk torch exchange")
        for ch in staged:
            k, v = ch.to_host() if isinstance(ch, DeviceChunk) else ch
            if len(k):
                ex.send((k, v))

    # ---- staging (DeviceExchange.send lands here) --------------------- #
    def stage(self, chunk: Union[Chunk, DeviceChunk]) -> None:
        if isinstance(chunk, DeviceChunk):
            if chunk.n_live:
                self._append(chunk)
            return
        keys, vals = chunk
        n = int(keys.shape[0])
        if n == 0:
            return
        if getattr(vals, "ndim", 1) != 1:
            self.demote("2-D vals")
            self.edge.exchange.send(chunk)
            return
        if n > self.NB:
            self.NB = _pow2(n)
        self._append(self._upload(keys, vals))

    def _append(self, chunk: DeviceChunk) -> None:
        if not self.staged:
            # Pin the routing constants of the table version this chunk was
            # *sent* under: a rewrite between stage and dispatch flushes the
            # staged backlog with exactly these constants.
            self._refresh_consts()
        self.staged.append(chunk)
        self.staged_live += chunk.n_live
        self._host_fresh = False
        if self.kind == "sink":
            # Single-worker sink: the histogram is known without a dispatch,
            # and staged chunks may cross a super-tick boundary — account at
            # send time exactly like the host plane.
            self.edge.exchange.account(
                np.array([chunk.n_live], dtype=np.int64))
            self.received[0] += chunk.n_live

    def _upload(self, keys: np.ndarray, vals: np.ndarray) -> DeviceChunk:
        """Pad a host chunk to ``NB`` lanes and upload it in one copy (keys
        and the bits of the float64 vals share one int64 buffer); the mask
        is made on the device."""
        n = int(keys.shape[0])
        buf = np.zeros((2, self.NB), np.int64)
        buf[0, :n] = keys
        buf[1].view(np.float64)[:n] = vals
        t = torch.from_numpy(buf).to(self.device)
        valid = torch.arange(self.NB, device=self.device) < n
        return DeviceChunk(t[0], t[1].view(torch.float64), valid, n)

    # ---- device state lifecycle --------------------------------------- #
    def _alloc_state(self) -> None:
        z = torch.zeros(self.K, dtype=torch.int64, device=self.device)
        self.state = dict(count=z, arrived=z.clone(), totals=z.clone())
        if self.kind == "sink":
            self._ones_cdf = torch.ones((self.K, 1), dtype=torch.float32,
                                        device=self.device)
        self._load_host_state()

    def _load_host_state(self) -> None:
        """Host -> device: (re)load keyed state, rings and mirrors from the
        operator's host structures (initial wiring, post-migration
        staleness)."""
        op = self.op
        W = self.W
        self._reload_pending = False
        self._host_fresh = False
        # Host-loaded queue content has unknown placement provenance.
        self._placed_token = None
        st = self.state
        if self.kind != "sink":
            cap = self.cap
            rk = np.zeros(W * cap + 1, np.int64)
            rv = np.zeros(W * cap + 1, np.float64)
            for w, worker in enumerate(op.workers):
                k, v = worker.queue.snapshot()
                if v.ndim != 1:
                    raise ValueError("device plane requires 1-D vals")
                ln = int(k.size)
                rk[w * cap:w * cap + ln] = k
                rv[w * cap:w * cap + ln] = v
                self.lens[w] = ln
                self.received[w] = worker.queue.received_total
            st.update(rk=self._put(rk, torch.int64),
                      rv=self._put(rv, torch.float64),
                      head=torch.zeros(W, dtype=torch.int64,
                                       device=self.device),
                      tail=self._put(self.lens, torch.int64))
        if self.kind == "fold":
            for prefix, table in (("", "state"), ("scat_", "scattered")):
                cols = [getattr(w, table).export_dense() for w in op.workers]
                st[prefix + "counts"] = self._put(
                    np.concatenate([c[0] for c in cols]), torch.int64)
                st[prefix + "sums"] = self._put(
                    np.concatenate([c[1] for c in cols]), torch.float64)
                st[prefix + "present"] = self._put(
                    np.concatenate([c[2] for c in cols] + [[False]]),
                    torch.bool)
        if self.kind == "rows":
            need = max(int(w.state.total_rows() + w.scattered.total_rows())
                       for w in op.workers)
            if need + self.B > self.rcap:
                self.rcap = _pow2(2 * max(need + self.B, 1))
            rcap = self.rcap
            bk = np.zeros(W * rcap + 1, np.int64)
            bv = np.zeros(W * rcap + 1, np.float64)
            bo = np.zeros(W * rcap + 1, bool)
            for w, worker in enumerate(op.workers):
                ok_k, ok_v = worker.state.export_rows()
                sc_k, sc_v = worker.scattered.export_rows()
                n1, n2 = int(ok_k.size), int(sc_k.size)
                base = w * rcap
                bk[base:base + n1] = ok_k
                bv[base:base + n1] = ok_v
                bo[base:base + n1] = True
                bk[base + n1:base + n1 + n2] = sc_k
                bv[base + n1:base + n1 + n2] = sc_v
                self.rows_len[w] = n1 + n2
                self.rows_owned[w] = n1
            self.rows_synced[:] = self.rows_len
            st.update(bk=self._put(bk, torch.int64),
                      bv=self._put(bv, torch.float64),
                      bo=self._put(bo, torch.bool),
                      rlen=self._put(self.rows_len, torch.int64))
        if self.kind == "sink":
            st.update(counts=self._put(op.counts, torch.int64),
                      sums=self._put(op.sums, torch.float64))
            # ``sync_host`` materializes staged sink chunks as host queue
            # content; a reload after a host mutation re-stages that
            # backlog in their place (the received mirror is stage-
            # accounted and stays as it is).
            k, v = op.workers[0].queue.snapshot()
            if k.size:
                self.staged = [self._restage(k, v)]
                self.staged_live = int(k.size)

    def _restage(self, keys: np.ndarray, vals: np.ndarray) -> DeviceChunk:
        if keys.shape[0] > self.NB:
            self.NB = _pow2(int(keys.shape[0]))
        return self._upload(keys, vals)

    def _ensure_ready(self) -> None:
        """Grow the static shapes (cap / B / rcap) and allocate device
        state."""
        budget_cap = self.engine.batch_ticks * self.op.service_rate
        if self.kind != "sink" and budget_cap > self.B:
            self.B = int(budget_cap)
        need = int(self.lens.max(initial=0)) + self.staged_live
        if self.state is None:
            self.cap = max(self.cap, _pow2(2 * max(need, 1)))
            self._alloc_state()
        elif need > self.cap and self.kind != "sink":
            self.cap = _pow2(2 * need)
            self._regrow_rings()
        if self.kind == "rows" and self.state is not None:
            rows = int(self.rows_len.max(initial=0))
            if rows + self.B > self.rcap:
                # The row log only grows (appends, never pops): double it
                # so the next dispatch's worst-case append (<= B rows) fits.
                self.rcap = _pow2(2 * (rows + self.B))
                self._regrow_rowstore()

    def _regrow_rings(self) -> None:
        """Re-layout the rings at a larger capacity (content preserved)."""
        W = self.W
        old_cap = (self.state["rk"].numel() - 1) // W
        rk = _grid(self.state["rk"], W, old_cap).cpu().numpy()
        rv = _grid(self.state["rv"], W, old_cap).cpu().numpy()
        head = self.state["head"].cpu().numpy()
        new_k = np.zeros(W * self.cap + 1, np.int64)
        new_v = np.zeros(W * self.cap + 1, np.float64)
        for w in range(W):
            ln = int(self.lens[w])
            idx = ring_span(head[w], ln, old_cap)
            new_k[w * self.cap:w * self.cap + ln] = rk[w, idx]
            new_v[w * self.cap:w * self.cap + ln] = rv[w, idx]
        self.state.update(rk=self._put(new_k, torch.int64),
                          rv=self._put(new_v, torch.float64),
                          head=torch.zeros(W, dtype=torch.int64,
                                           device=self.device),
                          tail=self._put(self.lens, torch.int64))

    def _regrow_rowstore(self) -> None:
        """Re-layout the flat row log at a larger capacity (append-only: no
        ring wrap, so regrowth is a prefix copy per worker)."""
        W = self.W
        old = (self.state["bk"].numel() - 1) // W
        grown = {}
        for name in ("bk", "bv", "bo"):
            buf = self.state[name]
            new = torch.zeros(W * self.rcap + 1, dtype=buf.dtype,
                              device=self.device)
            _grid(new, W, self.rcap)[:, :old] = _grid(buf, W, old)
            grown[name] = new
        self.state.update(grown)

    # ---- routing constants / split counters --------------------------- #
    def _refresh_consts(self) -> None:
        rt = self.routing
        rt._refresh_derived()
        if self.consts is None or self._consts_version != rt.version:
            self.consts = dict(cdf=self._put(rt.cdf32, torch.float32),
                               is_split=self._put(rt._is_split, torch.bool),
                               owner=self._put(rt.owner, torch.int64))
            self._consts_version = rt.version
            self._consts_split = bool(rt._any_split)

    def _pull_counters(self) -> np.ndarray:
        return self.state["count"].cpu().numpy()

    def _claim_counters(self) -> None:
        rt = self.routing
        if rt._count_owner is not self._pull:
            rt.sync_counters()          # a previous owner's last word
            self.state["count"] = self._put(rt._count, torch.int64)
            rt._count_owner = self._pull

    # ---- the super-tick dispatch -------------------------------------- #
    def _prep(self, budget: int) -> None:
        """Pre-dispatch lifecycle: widen the pop window, allocate/grow
        device state, apply deferred host reloads, claim counters, flush
        version-stale staged chunks under their pinned constants, then
        refresh to the live table."""
        if self.kind != "sink" and int(budget) > self.B:
            # A caller outpaced the batch_ticks sizing (a manual
            # run_super_tick with a wider window): widen the pop window.
            self.B = int(budget)
        self._ensure_ready()
        if self._reload_pending:
            self._reload_pending = False
            self._load_host_state()
        if self.kind != "sink":
            self._claim_counters()
        self._flush_stale_staged()
        self._refresh_consts()

    def _flush_stale_staged(self) -> None:
        """Staged chunks route under the table they were *sent* under: the
        rewrite listener fires after the weights moved, so a chunk staged
        before it is ingested (budget 0) with the constants pinned at stage
        time, then the caller refreshes to the live table."""
        if (not self.staged or self.consts is None
                or self._consts_version == self.routing.version):
            return
        chunks = list(self.staged)
        self._dispatch(self._spec(any_split=self._consts_split), chunks, 0)
        self.staged, self.staged_live = [], 0

    def _check_fn(self, budget: int) -> None:
        """Run a Filter / Project function once on a window of zeros before
        the first dispatch, as the JAX plane traces it on abstract values:
        a function that cannot run on device tensors then fails before any
        state has moved."""
        B = max(self.B, int(budget),
                self.engine.batch_ticks * self.op.service_rate, 1)
        wk = torch.zeros((self.W, B), dtype=torch.int64, device=self.device)
        wv = torch.zeros((self.W, B), dtype=torch.float64, device=self.device)
        _map_stage(self._spec(), wk, wv, torch.zeros_like(wk, dtype=torch.bool))

    def tick(self, budget: int) -> List:
        if not self.staged and not self.lens.any():
            return []                  # nothing to ingest or pop
        if not self._dispatched and self.kind in ("filter", "project"):
            try:
                self._check_fn(budget)
            except UserFunctionError as exc:
                # Only the user's function demotes the edge; a kernel,
                # build or CUDA error propagates.
                warnings.warn(
                    f"device plane: {exc}; demoting {self.op.name!r} to the "
                    f"per-chunk path", RuntimeWarning, stacklevel=2)
                self.demote("user fn")
                return self.op.tick(budget)
        self._host_fresh = False
        self._prep(budget)
        chunks, self.staged, self.staged_live = self.staged, [], 0
        return self._dispatch(self._spec(), chunks, budget)

    def flush_staged(self) -> None:
        """Route staged chunks into the rings without popping (budget 0).

        A blocking upstream's END flush can stage a chunk *after* this
        operator's tick in the same super-tick; the host plane would
        already have routed it into the queues, so every boundary read
        first flushes to keep queue lengths, received totals and key stats
        bit-identical.  The sink keeps its staged chunks (they materialize
        as queue content instead)."""
        if self.staged and self.kind != "sink" and self.op.device is self:
            self.tick(0)

    def _dispatch(self, spec: StepSpec, chunks: List[DeviceChunk],
                  budget: int) -> List:
        if chunks and self.kind != "sink":
            # Placement epoch: the ingested chunks are placed under the
            # current table iff the uploaded consts are current.
            tok = (self._live_token()
                   if self._consts_version == self.routing.version else None)
            if int(self.lens.sum()) == 0:
                self._placed_token = tok
            elif self._placed_token != tok:
                self._placed_token = None
        if self.kind == "sink":
            for ch in chunks:          # received accounted at stage time
                _sink_step(spec, self._ones_cdf, self.state, ch)
                # The host-plane pop happens in this same tick slot.
                self.op.workers[0].stats.processed_total += ch.n_live
            self._dispatched = True
            self._sink_dirty = self._sink_dirty or bool(chunks)
            return []
        seq = ([(c, 0) for c in chunks[:-1]] + [(chunks[-1], budget)]
               if chunks else [(None, budget)])
        outs: List[DeviceChunk] = []
        for ch, b in seq:
            metrics, out = _step(spec, self.consts, self.state, ch, b)
            if ch is not None:
                self.placements += 1
            self._dispatched = True
            metrics = metrics.cpu().numpy()             # the one readback
            hist, take = metrics[0], metrics[1]
            self.edge.exchange.account(hist)
            self.received += hist
            self.lens += hist - take
            if self.kind == "rows":   # every popped row was appended
                self.rows_len += take
                self.rows_owned += metrics[2]
            for w, worker in enumerate(self.op.workers):
                worker.stats.processed_total += int(take[w])
            if out is not None:
                em = metrics[2]
                for w, worker in enumerate(self.op.workers):
                    worker.stats.emitted_total += int(em[w])
                n_live = int(em.sum())
                if n_live:
                    outs.append(DeviceChunk(*out, n_live))
        # Emission happens here (inside the op's tick slot) so the
        # downstream edge sees outputs in exactly the host plane's order.
        if outs and self.op.out_edge is not None:
            for oc in outs:
                self.op.out_edge.send(oc)
        return []

    # ---- boundary materialization ------------------------------------- #
    def _gather_spans(self, names, start: torch.Tensor, lens: np.ndarray,
                      stride: int, ring: bool) -> List[Tuple[np.ndarray, ...]]:
        """Download, for every worker ``w``, the ``lens[w]`` cells from
        ``start[w]`` of row ``w`` of each named flat buffer (wrapping at the
        row width for a ring) in one device-to-host copy; returns one tuple
        of numpy columns per worker."""
        total = int(lens.sum())
        lens_t = torch.from_numpy(lens).to(self.device)
        wid = torch.repeat_interleave(
            torch.arange(self.W, dtype=torch.int64, device=self.device),
            lens_t, output_size=total)
        first = torch.cumsum(lens_t, dim=0) - lens_t
        pos = start[wid] + torch.arange(total, dtype=torch.int64,
                                        device=self.device) - first[wid]
        flat = wid * stride + (pos % stride if ring else pos)
        cols = [self.state[n][flat] for n in names]
        packed = torch.stack([c.view(torch.int64) if c.is_floating_point()
                              else c.to(torch.int64) for c in cols])
        packed = packed.cpu().numpy()
        host = [packed[i].view(np.float64) if c.is_floating_point()
                else packed[i].astype(bool) if c.dtype == torch.bool
                else packed[i] for i, c in enumerate(cols)]
        bounds = np.r_[0, np.cumsum(lens)]
        return [tuple(h[bounds[w]:bounds[w + 1]] for h in host)
                for w in range(self.W)]

    def sync_stats(self) -> None:
        """Drain the device per-key arrival accumulators into the host
        arrays the controller adapter reads (metric-round boundary)."""
        self.flush_staged()
        if self.state is None or self.op.arrived_by_key is None:
            return
        a, t = torch.stack([self.state["arrived"],
                            self.state["totals"]]).cpu().numpy()
        if a.any():
            self.op.arrived_by_key += a
            self.op.key_arrivals_total += t
            self.state["arrived"].zero_()
            self.state["totals"].zero_()

    def sync_sink_counts(self) -> None:
        """Sink-snapshot boundary: materialize the result columns only (a
        readback only if the sink folded since the last one)."""
        if self.state is not None and self._sink_dirty:
            c, s = torch.stack([self.state["counts"],
                                self.state["sums"].view(torch.int64)]
                               ).cpu().numpy()
            self.op.counts[:] = c
            self.op.sums[:] = s.view(np.float64)
            self._sink_dirty = False

    def sync_host(self) -> None:
        """Full device -> host materialization (END, routing rewrite,
        migration, demotion).  Device state stays authoritative afterwards;
        :meth:`mark_state_stale` if the host copies are then mutated.
        Idempotent between dispatches."""
        self.flush_staged()
        if self.state is None or self._host_fresh:
            return
        if self._reload_pending:
            # The host was mutated after the last sync and no dispatch has
            # run since: the host copies are *ahead* of the device.
            return
        op = self.op
        W = self.W
        if self.kind != "sink":
            # The live span of every ring only (its backlog), not the grid.
            spans = self._gather_spans(("rk", "rv"), self.state["head"],
                                       self.lens, self.cap, ring=True)
            for w, worker in enumerate(op.workers):
                worker.queue.restore(spans[w], int(self.received[w]))
        if self.kind == "fold":
            cols = {name: _grid(self.state[name], W, self.K).cpu().numpy()
                    for name in ("counts", "sums", "present", "scat_counts",
                                 "scat_sums", "scat_present")}
            for w, worker in enumerate(op.workers):
                worker.state.load_dense(cols["counts"][w], cols["sums"][w],
                                        cols["present"][w])
                worker.scattered.load_dense(cols["scat_counts"][w],
                                            cols["scat_sums"][w],
                                            cols["scat_present"][w])
        if self.kind == "rows":
            # Append the rows logged since the last boundary to the host
            # ScopeRows pair (owned flag -> state vs scattered), regrouped
            # by key; the stable grouping inside ``extend_segments`` keeps
            # each scope's arrival order, so scope arrays are bit-identical
            # to the host plane's per-chunk segment appends.  The host holds
            # the older rows already: a rewrite boundary (every few ticks
            # under an active mitigation) costs the new rows, not the log.
            new = self._gather_spans(
                ("bk", "bv", "bo"), torch.from_numpy(self.rows_synced).to(
                    self.device), self.rows_len - self.rows_synced,
                self.rcap, ring=False)
            for (k_w, v_w, o_w), worker in zip(new, op.workers):
                worker.state.extend_segments(k_w[o_w], v_w[o_w])
                worker.scattered.extend_segments(k_w[~o_w], v_w[~o_w])
            self.rows_synced[:] = self.rows_len
        if self.kind == "sink":
            self.sync_sink_counts()
            parts = [ch.to_host() for ch in self.staged]
            if parts:
                k = np.concatenate([p[0] for p in parts])
                v = np.concatenate([p[1] for p in parts])
            else:
                k = np.zeros(0, np.int64)
                v = np.zeros(0, np.float64)
            op.workers[0].queue.restore((k, v), int(self.received[0]))
        self.sync_stats()
        self.routing.sync_counters()
        self._host_fresh = True

    def mark_state_stale(self) -> None:
        """The host copies were mutated (migration / merge): reload the
        device state from them before the next dispatch.  Deferred, so a
        rewrite migrating m keys costs one download and one upload."""
        if self.state is None:
            return
        self.routing.sync_counters()
        self.routing._count_owner = None
        self._host_fresh = False
        self._reload_pending = True
        self._consts_version = -1
