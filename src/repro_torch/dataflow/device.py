"""The device-resident exchange plane: one eager dispatch per edge per super-tick.

Counterpart of ``repro.dataflow.device``.  An eligible edge keeps its whole
data plane on the engine's device between host boundaries: the staged
chunks, the per-worker ring queues, the routing constants (float32 row-CDF,
split mask, owners), the per-key split counters, and the destination's
keyed fold (GroupByAgg), row store (HashJoinBuild / RangeSort), build-match
table (HashJoinProbe) or sink columns live as ``torch`` tensors, and
:meth:`DeviceOpRuntime.tick` advances them — split counters → partition →
within-destination rank → ring scatter → budgeted pop → fold / row append /
map (Filter, Project) / probe expansion — in one dispatch per edge (or per
fused chain) per super-tick.  The JAX package traces that
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

The probe (HashJoinProbe) kind: the installed build side is immutable, so
the probe is stateless per record given a dense ``[W, K]`` match-count
table (owned and scattered build rows summed, reloaded from the host
whenever a migration or ``install_build`` marks it stale).  Its step pops
a budgeted window and expands it (:func:`repro_torch.kernels.ref.
match_expand`): each live lane emitted ``mcounts[w, key]`` times into a
padded ``[W, B * M]`` block, ``M`` the largest match count, so the emit
buffer covers the worst case and nothing carries over.  An edge whose
``W * B * M`` would pass ``MAX_EMIT_CELLS`` emits in sub-budget dispatches
when a device budget is set (:meth:`DeviceOpRuntime._tick_probe_chunked`,
one ``degraded-emit`` incident) and otherwise demotes to the per-chunk
path (``probe fanout``); with a budget it demotes only when one record's
fanout alone, ``W * M``, passes the ceiling.

Multi-edge chain fusion: consecutive resident edges whose tables are
routing-equivalent (``RoutingTable.routing_token`` equal; tokens exist
only for one-hot tables) share one placement.  A record sits on worker
*w* of a Filter, a key-preserving Project or a probe exactly because the
upstream table's primary of its key is *w*, so under an equal table its
destination downstream is *w* again: the stage hands its follower a
pre-placed ``[W, B]`` block (:func:`_push_placed`, a per-row cumsum rank
and no partition) and the whole chain advances in one dispatch per
super-tick (:func:`_chain_step`).  Fusibility is re-checked every
dispatch (:meth:`DeviceOpRuntime._chain_for_dispatch`): a rewrite that
splits or moves a key, backlog placed under an older table, a demotion,
END, a manual tick with another budget or ``Engine(device_chain=False)``
keeps the edges apart, every stage with its exact host mirrors.  The
chain's one placement counts at its head; a fused follower's
``DeviceExchange.placements`` stays 0.  Two places differ from the JAX
plane:

  * the sink tail.  The JAX plane keeps a sink per edge when it folds
    through the kernel, because its chain tail folds by a plain
    scatter-add.  Every sink of the port folds through K2, and so does a
    sink at the tail of a chain: the carry's flat keys and vals, ``keep``
    as the valid mask, the ones CDF.  ``Sink.counts`` is bit-identical to
    the per-edge fold, and the sums stay within the plane's bound below.
  * failures.  The JAX plane un-fuses on any exception of a first fused
    dispatch, which would hide a kernel fault here.  The port runs each
    never-dispatched member's Filter / Project function on a window of
    zeros before the first fused dispatch; only a
    :class:`UserFunctionError` there un-fuses (a ``chain-fallback``
    incident) and replays per edge, where the stage's own tick demotes
    it.  A K2, build or CUDA error inside a fused dispatch propagates, as
    it does per edge.

Memory tiering (the spill tier): with ``Engine(device_budget=cells)`` or
``REPRO_DEVICE_BUDGET`` (:mod:`repro_torch.dataflow.spill`) each edge
bounds its *resident* entries, the budget split evenly across workers.
Crossing ``high_wm`` of a worker's share evicts cold spans down to
``low_wm``: for a ring the newest resident records, past what the next
pops can reach; for a row store the oldest rows, a prefix of the
append-only log.  Evicted spans become CRC-checked host
:class:`~repro_torch.dataflow.spill.SpillSegment` objects, so that per worker
the logical record order stays ``[resident][spilled]``; ``lens`` and
``rows_len`` keep counting resident plus spilled, so every decision stays
that of an unspilled run.  Where the JAX plane copies a whole store to
the host and back on every eviction, the port moves only the spans:

  * an eviction gathers the evicted spans of every evicting worker in one
    device-to-host copy (:meth:`DeviceOpRuntime._gather_spans`); a row
    eviction then shifts each worker's live suffix to the front of its
    row on the device;
  * span positions come from the device's ``head`` / ``tail`` and the
    host's exact counts, with no read of a device cursor per worker;
  * before a dispatch, :meth:`~DeviceOpRuntime._spill_refill` re-appends
    the logically next segments until each ring covers its pop budget, in
    one scatter for all workers; the next two segments of a worker are
    kept on the device ahead of it (``SpillState.prefetch``), copied
    from pinned host memory with ``non_blocking=True`` on the current
    stream, the pinned source held beside the copy until the refill uses
    it (after that the caching host allocator's stream event keeps the
    block from reuse until the copy is done);
  * fresh pushes that land behind spilled spans move to the spill tail
    after the dispatch (:meth:`~DeviceOpRuntime._spill_demote_fresh`);
  * the row log's sync is incremental (above), so ``rows_synced`` counts
    logical rows: a boundary takes the unsynced rows from the segments
    (CRC-checked) before the device's suffix.

A high-watermark crossing records one ``mem-pressure`` incident a worker
and hands the attached controller ``note_memory_pressure``; it re-arms
below the low watermark.  Growth past the budget's allocation cap records
one ``regrow-capped`` incident and grows all the same.  A fused chain
stays apart while any member holds spilled spans or would cross its high
watermark (:meth:`~DeviceOpRuntime._spill_gate`).

Checkpoints and chaos: a cut is a boundary (``sync_host``, spill tier
included); :meth:`~DeviceOpRuntime.on_restore` drops the device state and
the spill tier and uploads the restored host truth at once, so a restored
backlog is poppable on the next tick; restored backlog has no known
placement, so a chain re-fuses only after it drains.  Before each
dispatch :meth:`~DeviceOpRuntime._chaos_dispatch_ok` consumes the faults a
:class:`~repro_torch.dataflow.resilience.ChaosRunner` injected: up to
``RetryPolicy.max_attempts`` retries in place, then a drain-first demotion
to the per-chunk torch exchange.  Only an injected fault is retried; a
K2, build or CUDA error propagates.  Under ``REPRO_SANITIZE=1`` every
``sync_host`` checks the mirrors against the device and the spill tier
and the fold sums for NaN and inf (:meth:`~DeviceOpRuntime.
_sanitize_check`).

Bit-exactness: destinations, ranks, histograms, queue contents, split
counters, row stores and every integer metric are identical to the host
numpy plane.  Only float sums may differ in their last bits: GroupByAgg
sums fold with ``index_add_`` (atomic order on the card), and the sink
adds K2's float32 per-chunk sums to its float64 columns, as the JAX
package's kernel sink does, so sink sums differ from the host plane's in
about the 7th digit (within c * 2^-23 * sum|v| per key, c its count).
The cross-plane contract is therefore stated on ``Sink.series``,
``Sink.counts``, the counters and the mirrors, all integers.

The in-dispatch controller (:class:`DeviceController`): with
``Engine(device_controller=True)`` or ``REPRO_DEVICE_CONTROLLER=1`` an
eligible attached ``ReshapeController`` (SBR + SCATTERED, one helper, no
control delay) runs every metric round on the device, one launch of the
hand-written ``ctrl_step`` kernel a super-tick in which a round fires
(:mod:`repro_torch.kernels.ctrl_step`; its plain version on the CPU), and
the routing consts are rewritten in place.  Metric rounds then cut no
fused span and cost no ``sync_stats`` readback: one epoch scalar comes
back a step.  The host controller is reconciled at boundaries by replaying
the device's observation log, 64 windows at most (:meth:`DeviceController.
drain`); a rewrite made in-dispatch leaves ``routing.version`` unchanged
until then, so :meth:`DeviceOpRuntime._live_token` is None meanwhile and
staged chunks are flushed before each step, under the consts they were
sent under.  Decisions, tau, mitigations and every routing rewrite equal
the host-stepped controller's bit for bit; a mismatch at a drain is a
``ctrl-mismatch`` incident and the host wins.  One departure from the JAX
plane: the END merge of the monitored operator stands the controller down
without a ``ctrl-demotion`` incident.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..analysis import sanitize as _sanitize
from ..kernels import ctrl_step as kctrl
from ..kernels import partition as kpart
from ..kernels.ref import match_expand
from . import spill as spill_tier
from .resilience import InjectedDispatchFault
from .tuples import Chunk, ring_span

__all__ = ["CtrlSpec", "DeviceChunk", "DeviceController", "DeviceOpRuntime",
           "StepSpec", "UserFunctionError", "ctrl_state_from_numpy",
           "wireable"]

#: fold-state ceiling: skip device wiring when W * K explodes.
MAX_FOLD_CELLS = 1 << 22

#: pop-window ceiling: a ring-backed operator's per-super-tick budget
#: bounds the static window width B; "effectively unbounded" service rates
#: (the Sink idiom, 2**31-1) would demand an absurd window, so such
#: operators stay on the per-chunk path (the Sink itself has no rings).
MAX_SERVICE_RATE = 1 << 20

#: probe-expand ceiling: the emit buffer is W * B * M lanes (M = the largest
#: per-(worker, key) build-match count, so it covers the worst case and no
#: output ever waits past the host plane's tick); a build table skewed
#: enough to pass it emits in sub-budget dispatches under a device budget
#: and demotes the edge without one.
MAX_EMIT_CELLS = 1 << 22

#: kinds that emit downstream (and may lead or continue a fused chain).
MAP_KINDS = ("filter", "project", "probe")

State = Dict[str, torch.Tensor]
Consts = Dict[str, torch.Tensor]


def wireable(op, num_keys: int) -> bool:
    """Is ``op`` a device-wireable destination for an edge of ``num_keys``?

    Exact types only (a subclass may override ``process``): Filter,
    Project, GroupByAgg, Sink, HashJoinBuild, HashJoinProbe and RangeSort.
    The dense per-(worker, key) structures (the keyed fold, the probe's
    match table) keep wide key spaces on the per-chunk path, and K2 takes
    at most ``MAX_WORKERS`` destinations.
    """
    from .operators import (Filter, GroupByAgg, HashJoinBuild,
                            HashJoinProbe, Project, RangeSort, Sink)
    if type(op) not in (Filter, Project, GroupByAgg, Sink, HashJoinBuild,
                        HashJoinProbe, RangeSort):
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

    kind: str   # "fold" | "filter" | "project" | "sink" | "probe" | "rows"
    W: int                       # destination workers
    K: int                       # key-space size
    cap: int                     # ring capacity (power of two)
    B: int                       # pop-window width (max budget)
    any_split: bool              # routing table carries split keys
    may_scatter: bool            # owned/scattered fold split armed
    track_stats: bool            # per-key arrival stats fold armed
    fn: Optional[Callable] = None   # Filter predicate / Project map
    M: int = 1                   # probe: largest per-record match fanout
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


def _push_placed(spec: StepSpec, state: State, ok, ov, keep, hist) -> None:
    """Ring-scatter a pre-placed ``[W, E]`` block (a fused chain's ingest):
    row ``w``'s live lanes append to ring ``w`` in lane order.  The upstream
    edge's partition placed the records and routing-token equality proves
    this edge would place them the same way, so the within-destination rank
    is a per-row cumsum and no partition runs."""
    kin = keep.to(torch.int64)
    rank = torch.cumsum(kin, dim=1) - kin
    pos = (state["tail"][:, None] + rank) % spec.cap
    wid = _iota(spec.W, keep.device)[:, None]
    flat = torch.where(keep, wid * spec.cap + pos,
                       spec.W * spec.cap).reshape(-1)
    state["rk"].index_put_((flat,), ok.reshape(-1))
    state["rv"].index_put_((flat,), ov.reshape(-1))
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


def _pop_and_tail(spec: StepSpec, consts: Consts, state: State,
                  budget: int):
    """Pop a ``[W, B]`` window and run the stage's tail on it: returns
    (take, the third metric row, out block or None): the emitted counts of
    a map or probe, the owned rows appended by a row-state stage, None
    after a keyed fold.  The out block (keys, vals, keep) is ``[W, B]`` for
    a Filter / Project and ``[W, B * M]`` for a probe, each live lane
    repeated by its build-match count (``np.repeat`` per worker)."""
    wk, wv, wmask, take = _pop(spec, state, budget)
    if spec.kind == "rows":
        return take, _fold_rows(spec, consts, state, wk, wv, wmask, take), None
    if spec.kind == "fold":
        _fold_popped(spec, consts, state, wk, wv, wmask)
        return take, None, None
    out = (match_expand(wk, wv, wmask, state["mcounts"], spec.B * spec.M)
           if spec.kind == "probe" else _map_stage(spec, wk, wv, wmask))
    return take, out[2].sum(dim=1), out


def _step(spec: StepSpec, consts: Consts, state: State,
          chunk: Optional[DeviceChunk], budget: int):
    """One fold / rows / map / probe step: optional ingest, pop, tail.
    Returns (metrics, out chunk columns or None): ``metrics`` stacks the
    int64 histogram, the popped counts and the third row of
    :func:`_pop_and_tail` (if any), per worker."""
    if chunk is not None:
        hist = _ingest(spec, consts, state, chunk).to(torch.int64)
    else:
        hist = torch.zeros(spec.W, dtype=torch.int64,
                           device=state["tail"].device)
    take, third, out = _pop_and_tail(spec, consts, state, budget)
    if out is not None:
        out = tuple(t.reshape(-1) for t in out)
    return torch.stack([hist, take] if third is None
                       else [hist, take, third]), out


def _sink_fold(spec: StepSpec, ones_cdf: torch.Tensor, state: State,
               keys, vals, valid) -> None:
    """Fold masked lanes into the sink columns through K2 (W == 1: the ones
    CDF routes every lane to worker 0; the kernel's per-key counts and
    float32 sums are the fold)."""
    _, _, _, fcnt, fsum = kpart.partition_scatter_fold(
        keys, None, vals, valid, ones_cdf)
    if spec.track_stats:
        _fold_stats(state, fcnt)
    state["counts"] += fcnt
    state["sums"] += fsum


def _chain_step(specs: List[StepSpec], consts: List[Consts],
                states: List[State], chunk: Optional[DeviceChunk],
                budgets: List[int], ones_cdf: Optional[torch.Tensor]):
    """Advance a fused chain in one dispatch, the counterpart of the JAX
    plane's ``_make_step_chain``: the head ingests through K2 (the chain's
    one placement); every later stage takes its predecessor's pre-placed
    block (:func:`_push_placed`), pops its own budget and maps, expands or
    folds; a sink tail folds the block through K2.  Returns (metrics, out):
    ``metrics`` stacks three ``[W]`` rows per stage (histogram, popped,
    third row of :func:`_pop_and_tail` or zeros; a sink's last two are
    zero), read back once; ``out`` is the tail's flat emit block, if it
    emits."""
    rows: List[torch.Tensor] = []
    carry = None
    for i, (spec, st) in enumerate(zip(specs, states)):
        if i == 0:
            hist = (_ingest(spec, consts[0], st, chunk).to(torch.int64)
                    if chunk is not None else
                    torch.zeros(spec.W, dtype=torch.int64,
                                device=st["count"].device))
        else:
            ok, ov, keep = carry
            hist = keep.sum(dim=1)
            kf, vf, mf = ok.reshape(-1), ov.reshape(-1), keep.reshape(-1)
            if spec.kind == "sink":
                _sink_fold(spec, ones_cdf, st, kf, vf, mf)
                zero = torch.zeros_like(hist)
                rows += [hist, zero, zero]
                carry = None
                continue
            if spec.track_stats:
                one = mf.to(torch.int64)
                st["arrived"].index_add_(0, kf, one)
                st["totals"].index_add_(0, kf, one)
            _push_placed(spec, st, ok, ov, keep, hist)
        take, third, carry = _pop_and_tail(spec, consts[i], st, budgets[i])
        rows += [hist, take, torch.zeros_like(take) if third is None
                 else third]
    out = None if carry is None else tuple(t.reshape(-1) for t in carry)
    return torch.stack(rows), out


def _pow2(n: int) -> int:
    p = 256
    while p < n:
        p <<= 1
    return p


# --------------------------------------------------------------------- #
# The in-dispatch skew controller                                        #
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class CtrlSpec:
    """The static half of the controller step.  The JAX package's spec also
    carries ``KMAX``, the widest window, which only bounds its traced tick
    loop; the kernel and its plain version loop over ``k`` itself."""

    W: int                     # workers
    K: int                     # key space
    window: int                # estimator sample window
    R: int                     # observation-log capacity (windows)
    eta: float
    metric_period: int
    initial_delay: int
    adaptive_tau: bool
    eps_lower: float
    eps_upper: float
    tau_increase: float
    max_tau_adjustments: int
    catchup_tolerance: float
    retire_window: int         # 0 = never retire
    enable_phase1: bool
    horizon: float             # tracker prediction horizon (tuples)


def ctrl_state_from_numpy(d: Dict[str, np.ndarray],
                          device) -> Dict[str, torch.Tensor]:
    """The controller state of the JAX package's ``DeviceController.cstate``
    (its arrays read into numpy) as this port's: a dict of tensors of
    :data:`repro_torch.kernels.ctrl_step.STATE_DTYPES` on ``device``."""
    return {name: torch.tensor(np.asarray(d[name]), dtype=dtype,
                               device=device)
            for name, dtype in kctrl.STATE_DTYPES.items()}


class _ReplayAdapter:
    """Adapter shim for the boundary drain: replays the device-logged
    observations of past windows through the host ``ReshapeController``, so
    the host twin re-derives, bit for bit, every decision the device
    controller made in-dispatch.  ``key_shares`` is decision-neutral for the
    eligible configuration (SBR phase 2 ignores it; full-partition phase 1
    uses it only for the unlogged ``moved`` field)."""

    def __init__(self, base):
        self.num_workers = base.num_workers
        self.traits = base.traits
        self.routing = base.routing
        self._phi = np.zeros(base.num_workers)
        self._arr = np.zeros(base.num_workers)
        self._drained = True
        self._left = 0.0
        self._rate = 0.0

    def set_window(self, phi, arr, left, rate):
        self._phi = np.asarray(phi, dtype=np.float64)
        self._arr = np.asarray(arr, dtype=np.float64).copy()
        self._drained = False
        self._left = float(left)
        self._rate = float(rate)

    def workloads(self):
        return self._phi.copy()

    def arrivals_by_owner(self):
        if self._drained:
            return np.zeros(self.num_workers)
        self._drained = True
        return self._arr

    def key_shares(self, worker):
        return {}

    def state_units(self, worker, mode):
        return 0.0

    def begin_migration(self, skewed, helpers, mode):
        return None

    def tuples_left(self):
        return self._left

    def processing_rate(self):
        return self._rate


class DeviceController:
    """Device-resident twin of one armed ``ReshapeController``.

    While active, the engine stops host-stepping the controller: each
    super-tick calls :meth:`super_tick`, which runs every covered metric
    round in one launch of the ``ctrl_step`` kernel
    (:mod:`repro_torch.kernels.ctrl_step`, its plain version on the CPU)
    against the device-held state ``cstate``, rewriting the routing consts
    in place, with one epoch scalar read back.  At every materialization
    boundary, and whenever the observation log holds ``LOG_CAP`` windows,
    :meth:`drain` replays the logged windows through the host controller
    (the bit-exact oracle and arbiter), then compares the host-derived
    routing consts with the device's and lets the host win on a mismatch
    (a ``ctrl-mismatch`` incident).  Anything that mutates host keyed state
    mid-run deactivates it (a ``ctrl-demotion`` incident) and host stepping
    resumes from the drained twin.  The END merge of the monitored operator
    is no demotion: the controller drains and stands down, as the engine
    steps no finished operator's controller anyway.
    """

    #: observation-log capacity: drain when this many windows accumulate.
    LOG_CAP = 64

    def __init__(self, rt: "DeviceOpRuntime", controller):
        self.rt = rt
        self.host = controller
        self.active = False
        self.reason: Optional[str] = None   # why deactivated
        self.cstate: Optional[Dict[str, torch.Tensor]] = None
        self.spec: Optional[CtrlSpec] = None
        self.meta: List[tuple] = []  # (t0, k, tuples_left, rate) per window
        self.epoch_host = 0          # device epoch after the last step
        self.epoch_synced = 0        # device epoch at the last drain
        self._last_tick = controller._tick
        #: steps launched (one epoch readback each) and drains that
        #: replayed a log (one readback of the log and the consts each).
        self.steps = 0
        self.drains = 0

    # ---- eligibility -------------------------------------------------- #
    @staticmethod
    def ineligible_reason(controller, rt) -> Optional[str]:
        """None iff this (controller, runtime) pair may run in-dispatch.

        The device twin replicates the paper's default control path: SBR +
        SCATTERED (rewrites move no state), one helper, full-partition
        phase 1, no control delay, instant migration.  Anything else stays
        on the host path."""
        from ..core.controller import ReshapeController
        from ..core.types import MigrationStrategy, TransferMode
        if type(controller) is not ReshapeController:
            return "controller subclass"
        cfg = controller.cfg
        if controller.mode is not TransferMode.SBR:
            return f"transfer mode {controller.mode.value}"
        if controller.strategy is not MigrationStrategy.SCATTERED:
            return f"strategy {controller.strategy}"
        if cfg.control_delay_ticks != 0:
            return "control delay"
        if getattr(cfg, "pressure_rounds", False):
            # Eager pressure-triggered rounds fire off the metric grid;
            # the step covers grid-aligned rounds only.
            return "pressure rounds"
        if cfg.max_helpers != 1:
            return "multi-helper"
        if not cfg.phase1_full_partition:
            return "partial-key phase 1"
        if cfg.migration_rate != float("inf"):
            return "finite migration rate"
        if cfg.pinned_helpers:
            return "pinned helpers"
        if cfg.adaptive_tau and (cfg.eps_lower is None
                                 or cfg.eps_upper is None):
            return "unbounded adaptive tau"
        if rt.kind == "sink":
            return "sink"
        if rt.W < 2:
            return "single worker"
        return None

    @property
    def routing_dirty(self) -> bool:
        """True while the device consts carry rewrites the host table has
        not seen yet (between an in-dispatch rewrite and the next drain)."""
        return self.epoch_host != self.epoch_synced

    # ---- arming / state build ----------------------------------------- #
    def arm(self) -> bool:
        # Scattered-arrival masking must be on from the first armed
        # dispatch: an in-dispatch rewrite cannot flip it afterwards.  On
        # one-hot tables the mask is the identity, so arming early is
        # bit-neutral.
        self.rt.op.may_scatter = True
        return self._build()

    def _build(self) -> bool:
        """(Re)build the device controller state from the host twin.
        Returns False, deactivating, when the host state is not
        representable on the device."""
        from ..core.types import MitigationPhase
        host = self.host
        cfg = host.cfg
        rt = self.rt
        for m in host.mitigations.values():
            if (len(m.helpers) != 1
                    or m.phase not in (MitigationPhase.PHASE_ONE,
                                       MitigationPhase.PHASE_TWO)):
                self.deactivate("non-reformable mitigation", drain=False)
                return False
        if host._pending:
            self.deactivate("pending control messages", drain=False)
            return False
        retire = (cfg.retire_after if cfg.retire_after is not None
                  else cfg.sample_window)
        self.spec = CtrlSpec(
            W=rt.W, K=rt.K, window=int(cfg.sample_window), R=self.LOG_CAP,
            eta=float(cfg.eta), metric_period=max(1, int(cfg.metric_period)),
            initial_delay=int(cfg.initial_delay_ticks),
            adaptive_tau=bool(cfg.adaptive_tau),
            eps_lower=float(cfg.eps_lower
                            if cfg.eps_lower is not None else -np.inf),
            eps_upper=float(cfg.eps_upper
                            if cfg.eps_upper is not None else np.inf),
            tau_increase=float(cfg.tau_increase),
            max_tau_adjustments=int(cfg.max_tau_adjustments),
            catchup_tolerance=float(cfg.catchup_tolerance),
            retire_window=int(retire),
            enable_phase1=bool(cfg.enable_phase1),
            horizon=float(host.tracker.horizon))
        table = rt.routing
        window = int(cfg.sample_window)
        obs = np.zeros((rt.W, window))
        obs_n = np.zeros(rt.W, np.int32)
        obs_pos = np.zeros(rt.W, np.int32)
        for w, est in enumerate(host.tracker._estimators):
            vals = list(est._obs)
            obs[w, :len(vals)] = vals
            obs_n[w] = len(vals)
            obs_pos[w] = len(vals) % window
        mit = np.zeros((5, rt.W), np.int32)   # active, helper, phase, calm, seq
        for seq, (s, m) in enumerate(host.mitigations.items()):
            mit[:, s] = (1, m.helpers[0], int(m.phase.value),
                         int(m.calm_rounds), seq)
        rt._refresh_consts(force=True)
        put = rt._put
        self.cstate = dict(
            weights=put(table.weights, torch.float64),
            cdf=rt.consts["cdf"], primary=put(table._primary, torch.int64),
            is_split=rt.consts["is_split"], owner=rt.consts["owner"],
            obs=put(obs, torch.float64), obs_n=put(obs_n, torch.int32),
            obs_pos=put(obs_pos, torch.int32),
            tau=put(float(host.tau), torch.float64),
            tau_adj=put(int(host.tau_adjustments), torch.int32),
            mit_active=put(mit[0].astype(bool), torch.bool),
            mit_helper=put(mit[1], torch.int32),
            mit_phase=put(mit[2], torch.int32),
            mit_calm=put(mit[3], torch.int32),
            mit_seq=put(mit[4], torch.int32),
            seq_next=put(len(host.mitigations), torch.int32),
            epoch=put(0, torch.int32),
            log_phi=put(np.zeros((self.LOG_CAP, rt.W)), torch.float64),
            log_arr=put(np.zeros((self.LOG_CAP, rt.W)), torch.float64),
            log_n=put(0, torch.int32))
        self.meta = []
        self.epoch_host = self.epoch_synced = 0
        self._last_tick = host._tick
        self.active = True
        self.reason = None
        return True

    # ---- the per-super-tick in-dispatch step -------------------------- #
    def super_tick(self, t0: int, k: int) -> None:
        host = self.host
        cfg = host.cfg
        rt = self.rt
        chaos = rt.engine.chaos
        if chaos is not None and not self._chaos_dispatch_ok(chaos):
            # Demoted drain-first; the engine's armed branch skipped the
            # boundary sync for this window, so run it here (the per-tick
            # loop below the boundary host-steps).
            rt.sync_stats()
            return
        rt.flush_staged()       # boundary sends land before the rounds
        delay = int(cfg.initial_delay_ticks)
        period = max(1, int(cfg.metric_period))
        fired = [t for t in range(t0, t0 + k)
                 if t >= delay and (t - delay) % period == 0]
        self._last_tick = t0 + k - 1
        if not fired:
            return              # no metric round in this window
        if len(self.meta) >= self.spec.R:
            self.drain()        # observation log full: reconcile first
        left = float(host.adapter.tuples_left())
        rate = float(host.adapter.processing_rate())
        arrived = (rt.state["arrived"] if rt.state is not None
                   else torch.zeros(rt.K, dtype=torch.int64,
                                    device=rt.device))
        c = self.cstate
        kctrl.ctrl_step(self.spec, c, arrived, rt.workloads(), t0, k, left,
                        rate)
        # The kernel rewrote the consts in place; the dict names them.
        rt.consts = dict(cdf=c["cdf"], is_split=c["is_split"],
                         owner=c["owner"])
        self.meta.append((t0, k, left, rate))
        self.epoch_host = int(c["epoch"])      # the one readback
        self.steps += 1
        host.rounds_on_device += len(fired)

    # ---- boundary drain: mirror decisions into the host twin ---------- #
    def drain(self) -> None:
        if not self.active:
            return
        host = self.host
        rt = self.rt
        table = rt.routing
        meta, self.meta = self.meta, []
        if not meta:
            if self._last_tick > host._tick:
                host._tick = self._last_tick
            return
        c = self.cstate
        n = int(c["log_n"])
        if n != len(meta):
            raise RuntimeError("controller observation log out of step")
        logs = torch.stack([c["log_phi"][:n], c["log_arr"][:n]]).cpu().numpy()
        shim = _ReplayAdapter(host.adapter)
        saved_adapter = host.adapter
        saved_listener = table.listener
        table.listener = None   # the device already routed post-rewrite
        host.adapter = shim
        try:
            for (t0, k, left, rate), phi, arr in zip(meta, logs[0], logs[1]):
                shim.set_window(phi, arr, left, rate)
                for t in range(t0, t0 + k):
                    host.step(t)
        finally:
            host.adapter = saved_adapter
            table.listener = saved_listener
        if self._last_tick > host._tick:
            host._tick = self._last_tick
        host.sync_readbacks += 1
        self.drains += 1
        # Arbitration: the host twin is the oracle.  Its replayed table must
        # equal the device's bit for bit; on a mismatch the host wins and
        # the device consts are overwritten from it.
        table._refresh_derived()
        host_consts = dict(weights=table.weights, cdf=table.cdf32,
                           primary=table._primary, is_split=table._is_split)
        if not all(np.array_equal(c[name].cpu().numpy(), value)
                   for name, value in host_consts.items()):
            warnings.warn(
                "device controller: in-dispatch decisions diverged from the "
                "host twin; host wins", RuntimeWarning, stacklevel=2)
            eng = rt.engine
            eng.incidents.record(
                "ctrl-mismatch", tick=eng.tick, edge=rt.op.name,
                cause="in-dispatch decisions diverged from the host twin",
                action="host wins; device consts re-uploaded")
            for name, value in host_consts.items():
                c[name].copy_(torch.from_numpy(np.ascontiguousarray(value)))
        c["log_n"].zero_()
        rt.consts = dict(cdf=c["cdf"], is_split=c["is_split"],
                         owner=c["owner"])
        rt._consts_version = table.version
        rt._consts_split = bool(table._any_split)
        self.epoch_synced = self.epoch_host

    # ---- retry/backoff against injected dispatch faults --------------- #
    def _chaos_dispatch_ok(self, chaos) -> bool:
        """Consume any injected dispatch fault with retry/backoff; once the
        retries are spent demote the controller drain-first (host stepping
        resumes, bit-identical) and return False.  Only an injected fault
        is caught: a build or launch error of the kernel propagates."""
        eng = self.rt.engine
        policy = eng.retry_policy
        for attempt in range(policy.max_attempts + 1):
            try:
                chaos.dispatch_fault(self.rt)
                return True
            except InjectedDispatchFault as exc:
                if attempt < policy.max_attempts:
                    eng.incidents.record(
                        "retry", tick=eng.tick, edge=self.rt.op.name,
                        cause=str(exc), action="retry controller dispatch",
                        attempt=attempt + 1)
                    policy.sleep(attempt + 1)
        self.deactivate("dispatch retries exhausted", drain=True)
        return False

    # ---- lifecycle ---------------------------------------------------- #
    def deactivate(self, reason: str, drain: bool = True,
                   record: bool = True) -> None:
        """Stand down to host stepping, draining pending decisions first
        unless the caller knows there are none worth keeping; ``record``
        logs it as a ``ctrl-demotion``."""
        if self.active:
            if drain:
                self.drain()
            if record:
                eng = self.rt.engine
                eng.incidents.record(
                    "ctrl-demotion", tick=eng.tick, edge=self.rt.op.name,
                    cause=reason, action="host-stepped controller resumes")
        self.active = False
        self.reason = reason

    def on_restore(self) -> None:
        """Checkpoint restore: in-flight device decisions die with the
        restored state; re-form from the restored host twin, or demote when
        its mitigation state is not representable in-dispatch."""
        self.meta = []
        self.epoch_host = self.epoch_synced = 0
        self.active = False
        self._build()


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
        from .operators import (Filter, GroupByAgg, HashJoinBuild,
                                HashJoinProbe, Project, RangeSort, Sink)

        self.op = op
        self.edge = edge
        self.engine = engine
        self.device = engine.device
        self.routing = edge.routing
        self.kind = {Filter: "filter", Project: "project",
                     GroupByAgg: "fold", Sink: "sink",
                     HashJoinProbe: "probe", HashJoinBuild: "rows",
                     RangeSort: "rows"}[type(op)]
        self.W = op.num_workers
        self.K = edge.routing.num_keys
        self.NB = 0                    # upload padding width
        self.B = 0                     # pop-window width
        self.cap = 0                   # ring capacity (pow2)
        self.M = 1                     # probe emit fanout bound
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
        # ---- spill tier (memory tiering; see the module docstring) ---- #
        #: entries of ``lens`` / ``rows_len`` held in host spill segments
        #: (exact mirrors: resident = total - spilled).
        self.spilled_lens = np.zeros(self.W, dtype=np.int64)
        self.spilled_rows = np.zeros(self.W, dtype=np.int64)
        self.budget_cfg = engine.device_budget
        self.spill: Optional[spill_tier.SpillState] = None
        self._b_limit: Optional[int] = None   # chunked-probe B clamp
        self._degraded_once = False           # one-time degraded-emit
        self._regrow_capped_once = False      # one-time regrow-capped
        self._fn = getattr(op, "predicate", None) or getattr(op, "fn", None)
        self._pull = self._pull_counters    # stable identity (ownership)
        self._host_fresh = False   # host copies match device state
        self._reload_pending = False   # host mutated: reload pre-dispatch
        self._consts_split = False  # any_split of the uploaded consts
        #: placement (partition + scatter) executions, one per ingested
        #: chunk (``DeviceExchange.placements``); a fused chain counts its
        #: one placement at the head, so a fused follower's stays 0.
        self.placements = 0
        #: the routing token under which all current ring content was
        #: placed (None = mixed/unknown).  Chain fusion requires it to equal
        #: the chain's token: equal *current* tables prove nothing about
        #: backlog placed under an older version (both edges rewritten in
        #: lockstep keep equal tokens, but records queued before sit on the
        #: old primary's ring and a pre-placed push would mis-deliver them).
        self._placed_token = None
        # Chain links (set by Engine._wire_device).  The engine skips a
        # follower's own tick in the super-tick whose serial it carries.
        self.chain_up: Optional["DeviceOpRuntime"] = None
        self.chain_down: Optional["DeviceOpRuntime"] = None
        self._chain_serial = -1
        #: a fused dispatch's pre-check failed: this head stays apart.
        self._chain_disabled = False
        # ---- in-dispatch control plane (set by arm_controller) ------- #
        self.ctrl: Optional[DeviceController] = None
        #: the memoized reason a controller was refused, if one was.
        self._ctrl_refused: Optional[str] = None
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
        if self.ctrl is not None and self.ctrl.active:
            # An in-dispatch rewrite may split keys mid-window: take the
            # split-aware path up front.  On one-hot tables the saturated
            # CDF routes every draw to the primary, so this is bit-neutral
            # while no key is split.
            any_split = True
        return StepSpec(kind=self.kind, W=self.W, K=self.K, cap=self.cap,
                        B=self.B, any_split=bool(any_split),
                        may_scatter=bool(self.op.may_scatter),
                        track_stats=bool(self.op.track_key_stats
                                         and self.op.arrived_by_key
                                         is not None),
                        fn=self._fn, M=self.M, rcap=self.rcap)

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
        """The owned rows of ``worker`` without a boundary, or None when the
        host copy is the one to read after a sync.  Rows kind: the exact
        mirror, once device state exists and no host mutation awaits a
        reload.  Probe kind: the host's build rows, which the device never
        changes (it holds only their counts)."""
        if self.kind == "probe":
            return int(self.op.workers[worker].state.total_rows())
        if self.kind != "rows" or self.state is None or self._reload_pending:
            return None
        return int(self.rows_owned[worker])

    def _live_token(self):
        """The routing token of the live (possibly device-rewritten) table.
        While the in-dispatch controller holds rewrites the host table has
        not seen yet, no host-side token describes the device consts: chain
        fusion and placement epochs treat the table as unprovable (None)
        until the next drain reconciles."""
        if (self.ctrl is not None and self.ctrl.active
                and self.ctrl.routing_dirty):
            return None
        return self.routing.routing_token()

    # ---- in-dispatch control plane ------------------------------------ #
    def arm_controller(self, controller) -> bool:
        """Attach a device-resident twin of ``controller`` (idempotent).
        Returns True when armed; a refusal is memoized per runtime."""
        if self.ctrl is not None:
            if self.ctrl.host is controller:
                return self.ctrl.active
            self.ctrl.deactivate("controller replaced")
            self.ctrl = None
        if self._ctrl_refused is not None:
            return False
        reason = DeviceController.ineligible_reason(controller, self)
        if reason is not None:
            self._ctrl_refused = reason
            return False
        ctrl = DeviceController(self, controller)
        if not ctrl.arm():
            return False
        self.ctrl = ctrl
        return True

    def _at_end(self) -> bool:
        """Is the operator at its END (every producer done, no backlog)?
        ``on_end`` merges scattered state only then."""
        eng = self.engine
        return (all(eng._producer_done(u)
                    for u in eng.upstreams.get(self.op.name, ()))
                and self.op.queues_empty())

    # ---- demotion (per-chunk fallback) -------------------------------- #
    def demote(self, reason: str) -> None:
        """Fall back to the per-chunk torch exchange (2-D vals, a user
        function that fails on device tensors, a second in-edge, a probe
        fanout past ``MAX_EMIT_CELLS``, or injected dispatch faults past
        the retry policy); the edge leaves any chain.  ``sync_host`` folds
        the spill tier into the host structures first; an armed controller
        drains and demotes before anything moves."""
        from .exchange import Exchange
        if self.ctrl is not None:
            self.ctrl.deactivate(f"demoted({reason})", drain=True)
            self.ctrl = None
        self._unlink_chain()
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
        if (self.staged and self.kind != "sink"
                and self._consts_version != self.routing.version):
            # The table was rewritten since the staged chunks were sent (a
            # SCATTERED rewrite is no boundary): place them under the
            # constants they were sent under before this chunk, sent under
            # the new table, joins the backlog.
            self.tick(0)
            if self.op.device is not self:      # demoted by that tick
                self.edge.send(chunk)
                return
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
        # The host structures hold the whole content (``sync_host`` folds
        # the spill tier back in before any host mutation), so everything
        # uploaded here is resident: the spill tier restarts empty.
        self.spilled_lens[:] = 0
        self.spilled_rows[:] = 0
        if self.spill is not None:
            self.spill.clear()
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
        if self.kind == "probe":
            # Dense match table: owned + scattered build rows summed per
            # (worker, key) (a split build key may hold rows in both); M,
            # the largest count, sizes the emit block.
            mc = np.stack([w.state.counts + w.scattered.counts
                           for w in op.workers])
            st["mcounts"] = self._put(mc, torch.int64)
            self.M = max(int(mc.max(initial=1)), 1)
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

    def _ensure_ready(self, incoming: int = 0) -> None:
        """Grow the static shapes (cap / B / rcap) and allocate device
        state.  ``incoming`` bounds the records a ring takes inside the next
        dispatch without being staged: a chain follower's ring ``w`` takes
        at most its upstream's emit bound from upstream ring ``w``, so the
        capacity must cover them or the pre-placed push would wrap onto
        live entries."""
        budget_cap = self.engine.batch_ticks * self.op.service_rate
        if self._b_limit is not None:
            # Chunked probe emission: the widening must not pass the emit
            # block the chunk loop sized.
            budget_cap = min(budget_cap, self._b_limit)
        if self.kind != "sink" and budget_cap > self.B:
            self.B = int(budget_cap)
        # Capacity covers the resident share only: spilled entries come
        # back through the budget-covering refill, never all at once.
        need = (int((self.lens - self.spilled_lens).max(initial=0))
                + self.staged_live + int(incoming))
        if self.state is None:
            self.cap = max(self.cap, _pow2(2 * max(need, 1)))
            self._alloc_state()
        elif need > self.cap and self.kind != "sink":
            self.cap = self._capped_growth(_pow2(2 * need), "ring")
            self._regrow_rings()
        if self.kind == "rows" and self.state is not None:
            rows = int((self.rows_len - self.spilled_rows).max(initial=0))
            if rows + self.B > self.rcap:
                # The row log only grows (appends, never pops): double it
                # so the next dispatch's worst-case append (<= B rows) fits.
                self.rcap = self._capped_growth(_pow2(2 * (rows + self.B)),
                                                "row store")
                self._regrow_rowstore()

    def _capped_growth(self, new_cap: int, what: str) -> int:
        """Growth past the budget's allocation cap means eviction could not
        keep this edge bounded (a burst larger than the budget itself):
        grow all the same, and record it once."""
        cfg = self.budget_cfg
        if cfg is not None:
            limit = _pow2(2 * (cfg.per_worker(self.W) + max(self.B, 1)))
            if new_cap > limit and not self._regrow_capped_once:
                self._regrow_capped_once = True
                self.engine.incidents.record(
                    "regrow-capped", tick=self.engine.tick,
                    edge=self.op.name,
                    cause=f"{what} regrowth to {new_cap} cells exceeds "
                          f"the device-budget cap {limit}",
                    action="grow past the budget (burst exceeds it); "
                           "spill resumes bounding the steady state")
        return new_cap

    def _regrow_rings(self) -> None:
        """Re-layout the rings at a larger capacity (content preserved)."""
        W = self.W
        old_cap = (self.state["rk"].numel() - 1) // W
        rk = _grid(self.state["rk"], W, old_cap).cpu().numpy()
        rv = _grid(self.state["rv"], W, old_cap).cpu().numpy()
        head = self.state["head"].cpu().numpy()
        new_k = np.zeros(W * self.cap + 1, np.int64)
        new_v = np.zeros(W * self.cap + 1, np.float64)
        resident = self.lens - self.spilled_lens
        for w in range(W):
            ln = int(resident[w])
            idx = ring_span(head[w], ln, old_cap)
            new_k[w * self.cap:w * self.cap + ln] = rk[w, idx]
            new_v[w * self.cap:w * self.cap + ln] = rv[w, idx]
        self.state.update(rk=self._put(new_k, torch.int64),
                          rv=self._put(new_v, torch.float64),
                          head=torch.zeros(W, dtype=torch.int64,
                                           device=self.device),
                          tail=self._put(resident, torch.int64))

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

    # ---- spill tier (memory tiering; see the module docstring) --------- #
    def set_budget(self, budget) -> None:
        """(Re)configure this edge's device budget mid-run (the chaos
        ``mem-pressure`` fault shrinks it; its undo restores).  ``None``
        stops eviction but keeps spilled spans reachable (refill goes on
        draining them)."""
        self.budget_cfg = spill_tier.resolve_budget(budget)

    def _spill_upload(self, a: np.ndarray):
        """The prefetcher's upload of one segment column: on the card a
        copy from pinned host memory with ``non_blocking=True`` on the
        current stream; returns (device copy, pinned source), the source
        held until the refill consumes the copy."""
        src = torch.from_numpy(a)
        if self.device.type != "cuda":
            return src.clone(), None
        pinned = src.pin_memory()
        return pinned.to(self.device, non_blocking=True), pinned

    def _spill_corrupt_incident(self, exc) -> None:
        self.engine.incidents.record(
            "spill-corrupt", tick=self.engine.tick, edge=self.op.name,
            cause=str(exc),
            action="recover from the last valid checkpoint cut")

    def _spill_refill(self, budget: int) -> None:
        """Re-append logically next spilled ring spans until the pop window
        is covered by resident records: per worker, refill stops when
        ``resident >= budget`` or the worker's spill ring drains, so the
        dispatch's ``take = min(budget, resident)`` equals the host plane's
        ``min(budget, total)`` and takes the logically first records.  One
        scatter appends every worker's segments (prefetched device copies,
        else uploaded now); each segment's CRC is checked on its host
        bytes first."""
        sp = self.spill
        if (sp is None or self.state is None or self._reload_pending
                or self.kind == "sink" or not sp.any()):
            return
        budget = int(budget)
        res = self.lens - self.spilled_lens
        got = np.zeros(self.W, dtype=np.int64)
        cols: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for w in range(self.W):
            while sp.rings[w] and int(res[w] + got[w]) < budget:
                try:
                    seg, dev = sp.pop_ring_front(w)
                except spill_tier.SpillCorruptError as exc:
                    self._spill_corrupt_incident(exc)
                    raise
                if dev is None:
                    dev = tuple(self._spill_upload(a) for a in seg.arrays)
                cols.append((dev[0][0], dev[1][0]))
                got[w] += seg.n
        if cols:
            need = int((res + got).max())
            if need > self.cap:
                self.cap = _pow2(2 * (need + budget))
                self._regrow_rings()
            dev_got = torch.from_numpy(got).to(self.device)
            total = int(got.sum())
            wid = torch.repeat_interleave(_iota(self.W, self.device), dev_got,
                                          output_size=total)
            first = torch.cumsum(dev_got, dim=0) - dev_got
            off = torch.arange(total, dtype=torch.int64,
                               device=self.device) - first[wid]
            flat = wid * self.cap + (self.state["tail"][wid] + off) % self.cap
            self.state["rk"].index_put_((flat,), torch.cat([c[0] for c in cols]))
            self.state["rv"].index_put_((flat,), torch.cat([c[1] for c in cols]))
            self.state["tail"] += dev_got
            self.spilled_lens -= got
        for w in range(self.W):
            if sp.rings[w]:
                sp.prefetch(w, self._spill_upload)

    def _spill_admit(self, budget: int) -> None:
        """Watermark check before a dispatch: evict cold resident spans to
        the host spill tier and raise the ``mem-pressure`` signal on a
        high-watermark crossing (hysteresis: it re-arms below the low
        watermark)."""
        cfg = self.budget_cfg
        if (cfg is None or self.kind == "sink" or self.state is None
                or self._reload_pending):
            return
        L = cfg.per_worker(self.W)
        high = max(int(L * cfg.high_wm), 1)
        low = max(int(L * cfg.low_wm), 1)
        budget = int(budget)
        res = self.lens - self.spilled_lens
        over = np.flatnonzero(res > max(high, budget))
        rows_over = over[:0]
        calm = res <= low
        if self.kind == "rows":
            rres = self.rows_len - self.spilled_rows
            rows_over = np.flatnonzero(rres > high)
            calm &= rres <= low
        if (over.size or rows_over.size) and self.spill is None:
            self.spill = spill_tier.SpillState(cfg, self.W)
        if over.size:
            self._spill_evict_rings(over, keep=max(low, budget))
        if rows_over.size:
            self._spill_evict_rows(rows_over, keep=low)
        sp = self.spill
        if sp is None:
            return
        pressured = np.zeros(self.W, dtype=bool)
        pressured[over] = True
        pressured[rows_over] = True
        for w in np.flatnonzero(pressured & ~sp.pressure_active):
            sp.pressure_active[w] = True
            self.engine.incidents.record(
                "mem-pressure", tick=self.engine.tick, edge=self.op.name,
                cause=f"worker {w}: resident device state crossed the high "
                      f"watermark ({high} of {L} cells/worker)",
                action="spill cold spans to host; notify the attached "
                       "controller")
            self._notify_pressure(int(w))
        sp.pressure_active[calm & ~pressured] = False

    def _spill_evict_rings(self, ws: np.ndarray, keep: int) -> None:
        """Move the newest resident ring records of each listed worker (the
        next pops cannot reach them) into checksummed host segments at the
        spill front (they are logically just before any spilled span): one
        device-to-host copy for all workers, and the tails pulled back."""
        res = self.lens - self.spilled_lens
        m = np.zeros(self.W, dtype=np.int64)
        m[ws] = np.maximum(res[ws] - int(keep), 0)
        if m.any():
            start = self.state["head"] + torch.from_numpy(res - m).to(
                self.device)
            spans = self._gather_spans(("rk", "rv"), start, m, self.cap,
                                       ring=True)
            for w in np.flatnonzero(m):
                self.spill.prepend_ring(w, spill_tier.SpillSegment(
                    tuple(a.copy() for a in spans[w]), int(m[w])))
            self.spilled_lens += m
            self.state["tail"] -= torch.from_numpy(m).to(self.device)
        for w in ws:
            self.spill.prefetch(int(w), self._spill_upload)

    def _spill_evict_rows(self, ws: np.ndarray, keep: int) -> None:
        """Spill the oldest rows (a prefix per worker) of the device row
        log: one device-to-host copy of the evicted prefixes, then each
        worker's live suffix shifted to the front of its row on the device.
        The log is append-only and read back only at boundaries, so the
        prefix is the coldest span and never comes back mid-run."""
        rres = self.rows_len - self.spilled_rows
        m = np.zeros(self.W, dtype=np.int64)
        m[ws] = np.maximum(rres[ws] - int(keep), 0)
        if not m.any():
            return
        spans = self._gather_spans(
            ("bk", "bv", "bo"), torch.zeros(self.W, dtype=torch.int64,
                                            device=self.device),
            m, self.rcap, ring=False)
        for w in np.flatnonzero(m):
            self.spill.append_rows(w, spill_tier.SpillSegment(
                tuple(a.copy() for a in spans[w]), int(m[w])))
        self.spilled_rows += m
        dev_m = torch.from_numpy(m).to(self.device)
        src = _iota(self.rcap, self.device)[None, :] + dev_m[:, None]
        dead = src >= self.state["rlen"][:, None]
        src = src.clamp_(max=self.rcap - 1)
        for name in ("bk", "bv", "bo"):
            grid = _grid(self.state[name], self.W, self.rcap)
            grid.copy_(grid.gather(1, src).masked_fill_(dead, 0))
        self.state["rlen"] -= dev_m

    def _spill_demote_fresh(self, pushed: np.ndarray) -> None:
        """Fresh pushes landed behind spilled spans: move them to the spill
        tier's logical end so each worker's order stays
        ``[resident][spilled]`` (this dispatch's pops never reached them:
        the refill made ``resident >= budget`` first)."""
        m = np.where([bool(r) for r in self.spill.rings], pushed, 0)
        if not m.any():
            return
        res = self.lens - self.spilled_lens
        start = self.state["head"] + torch.from_numpy(res - m).to(
            self.device)
        spans = self._gather_spans(("rk", "rv"), start, m, self.cap,
                                   ring=True)
        for w in np.flatnonzero(m):
            self.spill.append_ring(w, spill_tier.SpillSegment(
                tuple(a.copy() for a in spans[w]), int(m[w])))
        self.spilled_lens += m
        self.state["tail"] -= torch.from_numpy(m).to(self.device)

    def _spill_gate(self, budget: int) -> bool:
        """Must this edge stay per edge (unfused) this dispatch?  Yes while
        it holds spilled spans (refill and re-tiering run per edge only) or
        when its projected resident count would cross the high watermark,
        so a chain dispatch never needs to evict."""
        if self.spill is not None and self.spill.any():
            return True
        cfg = self.budget_cfg
        if cfg is None or self.kind == "sink":
            return False
        high = max(int(cfg.per_worker(self.W) * cfg.high_wm), 1)
        res = int((self.lens - self.spilled_lens).max(initial=0))
        if self.kind == "rows":
            res = max(res, int((self.rows_len
                                - self.spilled_rows).max(initial=0)))
        return res + self.staged_live + int(budget) > max(high, int(budget))

    def _notify_pressure(self, worker: int) -> None:
        """Memory pressure is a mitigation trigger: hand the signal to the
        attached host controller (splitting the fat worker sheds the hot
        partition's growth)."""
        for att in self.engine.controllers:
            if att.op is not self.op:
                continue
            note = getattr(att.controller, "note_memory_pressure", None)
            if note is not None:
                note(worker, self.engine.tick)

    # ---- routing constants / split counters --------------------------- #
    def _refresh_consts(self, force: bool = False) -> None:
        rt = self.routing
        rt._refresh_derived()
        if self.ctrl is not None and self.ctrl.active and not force:
            # While armed, the device consts are ahead of the host table
            # between drains: never overwrite them from the host copy.  A
            # host-side version bump the controller did not make (an
            # out-of-band rewrite) demotes the control plane first.
            if self._consts_version == rt.version:
                return
            self.ctrl.deactivate("out-of-band table rewrite")
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
    def _prep(self, budget: int, incoming: int = 0) -> None:
        """Pre-dispatch lifecycle of the per-edge and chain paths: widen the
        pop window, allocate/grow device state, apply deferred host reloads,
        claim counters, flush version-stale staged chunks under their pinned
        constants, then refresh to the live table."""
        if self.kind != "sink" and int(budget) > self.B:
            # A caller outpaced the batch_ticks sizing (a manual
            # run_super_tick with a wider window): widen the pop window.
            self.B = int(budget)
        self._ensure_ready(incoming)
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
        chaos = self.engine.chaos
        if chaos is not None and not self._chaos_dispatch_ok(chaos):
            return self.op.tick(budget)    # demoted: the host path replays
        if self.kind == "probe" and not self._probe_capacity_ok(budget):
            if self.budget_cfg is not None:
                # With a device budget the cliff degrades instead: emit in
                # sub-budget dispatches.
                return self._tick_probe_chunked(budget)
            # A build table (or budget) skewed enough that the padded emit
            # block W * B * M would pass the ceiling: the per-chunk path
            # takes any fanout.
            self.demote("probe fanout")
            return self.op.tick(budget)
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
        chain = self._chain_for_dispatch(budget)
        if chain is not None:
            return self._dispatch_chain(chain, budget)
        self._host_fresh = False
        self._spill_refill(budget)
        self._prep(budget)
        self._spill_admit(budget)
        chunks, self.staged, self.staged_live = self.staged, [], 0
        return self._dispatch(self._spec(), chunks, budget)

    def _chaos_dispatch_ok(self, chaos) -> bool:
        """Consume the injected dispatch faults with retry/backoff; once the
        retries are spent, demote this edge drain-first (the per-chunk path
        replays the tick bit-identically) and return False.  Only an
        injected fault is caught: a K2, build or CUDA error propagates."""
        policy = self.engine.retry_policy
        for attempt in range(policy.max_attempts + 1):
            try:
                chaos.dispatch_fault(self)
                return True
            except InjectedDispatchFault as exc:
                if attempt < policy.max_attempts:
                    self.engine.incidents.record(
                        "retry", tick=self.engine.tick, edge=self.op.name,
                        cause=str(exc), action="retry device dispatch",
                        attempt=attempt + 1)
                    policy.sleep(attempt + 1)
        self.demote("dispatch retries exhausted")
        return False

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

    # ---- the probe's emit capacity ------------------------------------ #
    def _host_fanout(self) -> int:
        """The largest per-(worker, key) build-match count, from host
        state."""
        mc = max((int((w.state.counts + w.scattered.counts).max(initial=0))
                  for w in self.op.workers), default=0)
        return max(mc, 1)

    def _probe_capacity_ok(self, budget: int) -> bool:
        """Would the probe's emit block stay within ``MAX_EMIT_CELLS``?  The
        host state's fanout counts whenever the device match table is absent
        or stale (``install_build`` or a migration just ran)."""
        B = max(self.B, int(budget),
                self.engine.batch_ticks * self.op.service_rate)
        M = (self.M if self.state is not None and not self._reload_pending
             else self._host_fanout())
        return self.W * B * M <= MAX_EMIT_CELLS

    def _tick_probe_chunked(self, budget: int) -> List:
        """The probe-fanout cliff under a device budget: pop and expand in
        sub-budget dispatches whose emit block ``W * b * M`` stays within
        ``MAX_EMIT_CELLS`` (one ``degraded-emit`` incident).  Bit-exact
        against one dispatch of the whole budget: prefix pops compose, and
        splitting a window keeps each lane's expansion order.  Only a
        record whose fanout alone passes the ceiling (``W * M``) demotes."""
        M = max(self.M if self.state is not None and not self._reload_pending
                else self._host_fanout(), 1)
        if self.W * M > MAX_EMIT_CELLS:
            self.demote("probe fanout")
            return self.op.tick(budget)
        b_limit = max(MAX_EMIT_CELLS // (self.W * M), 1)
        self._b_limit = b_limit
        self.B = min(self.B, b_limit)
        if not self._degraded_once:
            self._degraded_once = True
            self.engine.incidents.record(
                "degraded-emit", tick=self.engine.tick, edge=self.op.name,
                cause=f"probe emit buffer W*B*M over MAX_EMIT_CELLS "
                      f"(W={self.W}, M={M})",
                action=f"chunked emission at B<={b_limit} (no demotion)")
        self._host_fresh = False
        left = int(budget)
        first = True
        while True:
            b = min(left, b_limit)
            self._spill_refill(b)
            self._prep(b)
            self._spill_admit(b)
            chunks: List[DeviceChunk] = []
            if first:                   # after _prep flushed a stale backlog
                chunks, self.staged, self.staged_live = self.staged, [], 0
                first = False
            self._dispatch(self._spec(), chunks, b)
            left -= b
            # ``lens`` counts spilled records too: stop only when nothing
            # is left to pop anywhere.
            if left <= 0 or b == 0 or not self.lens.any():
                return []

    def _emit_bound(self, budget: int) -> int:
        """The most records one ring of this stage hands its chain follower
        in one dispatch: the pop budget, times the match fanout for a
        probe."""
        return int(budget) * (self.M if self.kind == "probe" else 1)

    # ---- chain fusion (one placement for routing-equivalent edges) ---- #
    def _preserves_keys(self) -> bool:
        """May this stage's output reuse its input placement?  A Filter only
        masks and a probe repeats its input records, so always; a Project
        only if it declares ``preserves_keys=True``."""
        if self.kind in ("filter", "probe"):
            return True
        return bool(getattr(self.op, "preserves_keys", False))

    def _unlink_chain(self) -> None:
        if self.chain_up is not None:
            self.chain_up.chain_down = None
            self.chain_up = None
        if self.chain_down is not None:
            self.chain_down.chain_up = None
            self.chain_down = None

    def _placement_current(self, tok) -> bool:
        """Was every record this stage would hand downstream placed under
        the chain's token?  Empty rings are current; staged chunks count
        only if they will be placed under the live table (a version-stale
        backlog flushes under the old one)."""
        if self.staged and self._consts_version != self.routing.version:
            return False
        return self._placed_token == tok or int(self.lens.sum()) == 0

    def _chain_for_dispatch(self, budget: int):
        """The fused chain ``[self, ...]`` to advance in one dispatch, or
        None to stay per edge.  Re-checked every dispatch: the routing
        tokens must be equal along the chain (one-hot tables only), every
        member device-wired and unfinished, every non-tail stage
        key-preserving, and the budget the scheduler's ``k *
        service_rate`` so the followers' budgets are known (a manual tick
        with another budget stays per edge)."""
        eng = self.engine
        if (self.kind not in MAP_KINDS or self.chain_down is None
                or self._chain_disabled or not eng.device_chain
                or self.op.device is not self or self.op.finished
                or not self._preserves_keys()
                or budget != eng._super_k * self.op.service_rate
                or self._spill_gate(budget)):
            return None
        tok = self._live_token()
        if tok is None:
            return None
        members = [self]
        r = self
        while True:
            d = r.chain_down
            if (d is None or d.op.device is not d or d.op.finished
                    or d._live_token() != tok):
                break
            d_budget = eng._super_k * d.op.service_rate
            if d.kind == "probe" and not d._probe_capacity_ok(d_budget):
                break                   # d's own tick demotes or chunks it
            if d._spill_gate(d_budget):
                break                   # d must evict or refill per edge
            members.append(d)
            if (d.kind not in MAP_KINDS or d._chain_disabled
                    or not d._preserves_keys()):
                break                   # d is the chain's tail
            r = d
        if len(members) < 2:
            return None
        # Equal current tables are not enough: every record a non-tail
        # stage hands downstream must have been placed under that token.
        if not all(m._placement_current(tok) for m in members[:-1]):
            return None
        return members

    def _dispatch_chain(self, members: List["DeviceOpRuntime"],
                        budget: int) -> List:
        """Advance the fused chain in one dispatch (in the head's tick slot;
        the engine skips the followers' own ticks this super-tick by
        ``_chain_serial``).  Per-stage metrics keep the same exact host
        mirrors the per-edge dispatches keep."""
        eng = self.engine
        budgets = [eng._super_k * r.op.service_rate for r in members]
        budgets[0] = int(budget)
        # Before any state moves: every follower's user function must run
        # on device tensors (the head's ran in its tick).  Only such a
        # failure un-fuses; the stage's own tick then demotes it with its
        # incident.
        for r, b in zip(members[1:], budgets[1:]):
            if not r._dispatched and r.kind in ("filter", "project"):
                try:
                    r._check_fn(b)
                except UserFunctionError as exc:
                    warnings.warn(
                        f"device plane: {exc}; the fused chain at "
                        f"{self.op.name!r} falls back to per-edge dispatch",
                        RuntimeWarning, stacklevel=3)
                    eng.incidents.record(
                        "chain-fallback", tick=eng.tick, edge=self.op.name,
                        cause=str(exc), action="per-edge dispatch")
                    self._chain_disabled = True
                    return self.tick(budget)
        for r in members[1:]:
            if r.staged:                # leftovers of an unfused window
                r.tick(0)               # budget 0 never chains: per edge
        if any(r.op.device is not r for r in members):
            return self.tick(budget)    # a leftover demoted its stage
        tok = self._live_token()
        empty_before = []
        for i, r in enumerate(members):
            r._host_fresh = False
            empty_before.append(int(r.lens.sum()) == 0)
            # A follower's rings take up to the upstream stage's emit bound
            # inside the dispatch (the upstream's M is final: its _prep ran).
            r._prep(budgets[i],
                    members[i - 1]._emit_bound(budgets[i - 1]) if i else 0)
        chunks, self.staged, self.staged_live = self.staged, [], 0
        chunk = chunks[0] if len(chunks) == 1 else None
        if len(chunks) > 1:
            # Several staged chunks (END flushes): ingest per edge first
            # (budget 0 pops nothing), then run the chain pop-only, as the
            # per-edge [(c, 0), ..., (c, B)] sequence does.
            self._dispatch(self._spec(), chunks, 0)
        tail = members[-1]
        metrics, out = _chain_step(
            [r._spec() for r in members], [r.consts for r in members],
            [r.state for r in members], chunk, budgets, tail._ones_cdf)
        metrics = metrics.cpu().numpy()             # the one readback
        if chunk is not None:
            self.placements += 1        # the chain's one placement
        for i, (r, was_empty) in enumerate(zip(members, empty_before)):
            r._dispatched = True
            # Everything delivered in this dispatch was placed under the
            # chain's token (fusibility proved any older backlog shares it).
            r._placed_token = (tok if was_empty or r._placed_token == tok
                               else None)
            if i:
                r._chain_serial = eng._super_serial
            hist, take, third = metrics[3 * i:3 * i + 3]
            r.edge.exchange.account(hist)
            r.received += hist
            if r.kind == "sink":        # no rings: folded on arrival
                r.op.workers[0].stats.processed_total += int(hist.sum())
                r._sink_dirty = r._sink_dirty or bool(hist.any())
                continue
            r.lens += hist - take
            if r.kind == "rows":        # every popped row was appended
                r.rows_len += take
                r.rows_owned += third
            emits = r.kind in MAP_KINDS
            for w, worker in enumerate(r.op.workers):
                worker.stats.processed_total += int(take[w])
                if emits:
                    worker.stats.emitted_total += int(third[w])
        if out is not None:             # an emitting tail sends downstream
            n_live = int(metrics[-1].sum())
            if n_live and tail.op.out_edge is not None:
                tail.op.out_edge.send(DeviceChunk(*out, n_live))
        return []

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
                _sink_fold(spec, self._ones_cdf, self.state, ch.keys,
                           ch.vals, ch.valid)
                # The host-plane pop happens in this same tick slot.
                self.op.workers[0].stats.processed_total += ch.n_live
            self._dispatched = True
            self._sink_dirty = self._sink_dirty or bool(chunks)
            return []
        seq = ([(c, 0) for c in chunks[:-1]] + [(chunks[-1], budget)]
               if chunks else [(None, budget)])
        outs: List[DeviceChunk] = []
        pushed = np.zeros(self.W, dtype=np.int64)
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
            pushed += hist
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
        if (self.spill is not None and pushed.any()
                and any(self.spill.rings)):
            # Ordering invariant: fresh pushes behind spilled spans re-tier
            # to the spill tail (see _spill_demote_fresh).
            self._spill_demote_fresh(pushed)
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
        arrays the controller adapter reads (metric-round boundary).

        An armed in-dispatch controller first mirrors its decisions into
        the host twin (:meth:`DeviceController.drain`), so everything after
        (the adapter's arrival drain, checkpoint cuts, rewrites) sees a
        reconciled control plane."""
        if self.ctrl is not None and self.ctrl.active:
            self.ctrl.drain()
        self.flush_staged()
        if self.state is None or self.op.arrived_by_key is None:
            return
        a, t = torch.stack([self.state["arrived"],
                            self.state["totals"]]).cpu().numpy()
        pending = a.any()
        if not pending and self.ctrl is not None:
            # The in-dispatch controller drains ``arrived`` itself (its
            # owner-aggregated copy feeds the estimators), but the
            # cumulative per-key totals still reach the host.
            pending = t.any()
        if pending:
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
        if _sanitize.enabled():
            # Before any span is read: a forked mirror would mis-size it.
            self._sanitize_check()
        op = self.op
        W = self.W
        if self.kind != "sink":
            # The live span of every ring only (its backlog), not the grid,
            # then the spilled spans: the logical order is
            # [resident][spilled].
            spans = self._gather_spans(("rk", "rv"), self.state["head"],
                                       self.lens - self.spilled_lens,
                                       self.cap, ring=True)
            for w, worker in enumerate(op.workers):
                k_w, v_w = spans[w]
                if self.spilled_lens[w]:
                    segs = self._drain(self.spill.drain_ring, w)
                    k_w = np.concatenate([k_w] + [g.arrays[0] for g in segs])
                    v_w = np.concatenate([v_w] + [g.arrays[1] for g in segs])
                worker.queue.restore((k_w, v_w), int(self.received[w]))
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
            # ``rows_synced`` counts logical rows; the first
            # ``spilled_rows`` of them sit in the spill tier and device row
            # i is logical row ``spilled_rows + i``.
            first = np.maximum(self.rows_synced, self.spilled_rows)
            new = self._gather_spans(
                ("bk", "bv", "bo"), torch.from_numpy(
                    first - self.spilled_rows).to(self.device),
                self.rows_len - first, self.rcap, ring=False)
            for w, worker in enumerate(op.workers):
                k_w, v_w, o_w = new[w]
                if self.rows_synced[w] < self.spilled_rows[w]:
                    old = self._spilled_rows_from(w, int(self.rows_synced[w]))
                    k_w, v_w, o_w = (np.concatenate([a, b])
                                     for a, b in zip(old, (k_w, v_w, o_w)))
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

    def _drain(self, drain, w: int):
        """``SpillState.drain_ring`` / ``drain_rows`` of worker ``w``, the
        CRC failure recorded as a ``spill-corrupt`` incident."""
        try:
            return drain(w)
        except spill_tier.SpillCorruptError as exc:
            self._spill_corrupt_incident(exc)
            raise

    def _spilled_rows_from(self, w: int, start: int):
        """Worker ``w``'s spilled rows from logical row ``start`` on, as
        (keys, vals, owned) columns; only the segments read are
        CRC-checked."""
        parts, base = [], 0
        for seg in self.spill.rows[w]:
            if base + seg.n > start:
                if not seg.verify():
                    self._drain(self.spill.drain_rows, w)   # records, raises
                lo = max(start - base, 0)
                parts.append(tuple(a[lo:] for a in seg.arrays))
            base += seg.n
        return tuple(np.concatenate(c) for c in zip(*parts))

    def _sanitize_check(self) -> None:
        """Boundary sanitizers (``REPRO_SANITIZE=1``): cross-check the
        exact host mirrors against the device truth, the spill tier's
        segments against the spilled mirrors, and fold sums against NaN and
        inf.  Violations are structured incidents (``sanitize-mirror`` /
        ``sanitize-spill`` / ``sanitize-nan``) plus a hard failure."""
        st = self.state
        problems = []
        cursors = []
        if self.kind != "sink":
            cursors.append(st["tail"] - st["head"])
        if self.kind == "rows":
            cursors.append(st["rlen"])
        sums = [name for name in ("sums", "scat_sums") if name in st]
        finite = [bool(torch.isfinite(st[name]).all()) for name in sums]
        dev = torch.stack(cursors).cpu().numpy() if cursors else []
        if self.kind != "sink":
            resident = self.lens - self.spilled_lens
            if not np.array_equal(dev[0], resident):
                problems.append((
                    "sanitize-mirror",
                    f"queue-length mirror {resident.tolist()} (total "
                    f"{self.lens.tolist()} - spilled "
                    f"{self.spilled_lens.tolist()}) != device tail-head "
                    f"{dev[0].tolist()}"))
        if self.kind == "rows":
            rres = self.rows_len - self.spilled_rows
            if not np.array_equal(dev[1], rres):
                problems.append((
                    "sanitize-mirror",
                    f"rows_len mirror {rres.tolist()} (total "
                    f"{self.rows_len.tolist()} - spilled "
                    f"{self.spilled_rows.tolist()}) != device rlen "
                    f"{dev[1].tolist()}"))
        for w in range(self.W):
            ring = self.spill.ring_len(w) if self.spill else 0
            rows = self.spill.rows_len(w) if self.spill else 0
            if (ring != int(self.spilled_lens[w])
                    or rows != int(self.spilled_rows[w])):
                problems.append((
                    "sanitize-spill",
                    f"worker {w}: spill segments hold {ring} ring / {rows} "
                    f"row records but mirrors say "
                    f"{int(self.spilled_lens[w])} / "
                    f"{int(self.spilled_rows[w])}"))
        for name, ok in zip(sums, finite):
            if not ok:
                problems.append(("sanitize-nan",
                                 f"non-finite values in fold state {name!r}"))
        for kind, cause in problems:
            self.engine.incidents.record(
                kind, tick=self.engine.tick, edge=self.op.name, cause=cause,
                action="fail (REPRO_SANITIZE=1)")
        if problems:
            raise _sanitize.SanitizeError(
                f"device-plane sanitizer tripped at a sync_host boundary on "
                f"{self.op.name!r}: " + "; ".join(c for _, c in problems))

    def mark_state_stale(self) -> None:
        """The host copies were mutated (migration / merge): reload the
        device state from them before the next dispatch.  Deferred, so a
        rewrite migrating m keys costs one download and one upload.

        An armed controller cannot replicate a host-side migration or merge:
        it drains and demotes (``host state mutated``).  The merge of the
        operator's END is the exception: the engine steps no finished
        operator's controller, so it drains and stands down unrecorded."""
        if self.ctrl is not None and self.ctrl.active:
            if self._at_end():
                self.ctrl.deactivate("END", record=False)
            else:
                self.ctrl.deactivate("host state mutated")
        if self.state is None:
            return
        self.routing.sync_counters()
        self.routing._count_owner = None
        self._host_fresh = False
        self._reload_pending = True
        self._consts_version = -1

    def on_restore(self) -> None:
        """Checkpoint restore rewrote every host structure: drop the device
        state and the spill tier and upload the restored host truth now.

        The upload is eager: a restored backlog must be poppable on the
        next tick even if no chunk ever arrives again (the sources may be
        exhausted), or END would never propagate.  The reload also resets
        the spilled mirrors, ``rows_synced`` and ``rows_owned``, and leaves
        the restored backlog with no known placement, so a chain re-fuses
        only once it drains."""
        self.state = None
        self.consts = None
        self._consts_version = -1
        self._chain_serial = -1        # never "already ticked" after it
        self._reload_pending = False
        self._host_fresh = False
        self._sink_dirty = False
        self.staged, self.staged_live = [], 0
        self.spilled_lens[:] = 0
        self.spilled_rows[:] = 0
        if self.spill is not None:
            self.spill.clear()
        for w, worker in enumerate(self.op.workers):
            self.lens[w] = len(worker.queue)
            self.received[w] = worker.queue.received_total
        if self.kind == "sink":
            self.lens[:] = 0
        if not self.op.finished:
            self._ensure_ready()       # upload rings, state and backlog now
        if self.ctrl is not None:
            self.ctrl.on_restore()     # re-form from the restored twin
