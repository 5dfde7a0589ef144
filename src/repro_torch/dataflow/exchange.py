"""The columnar exchange subsystem: fused one-pass routing for every edge.

An :class:`Exchange` owns the data-plane side of one partitioned edge.  Per
chunk it asks its pluggable :class:`PartitionBackend` for a single fused
:class:`ScatterPlan` — destination worker per record, the per-worker
histogram (the workload metric phi), and the *scatter placement* that
groups the chunk by destination — then materializes each worker's
contiguous slice with one fancy-index pass per column.  There is no
separate sort stage: the plan's placement is produced by the partition
itself (torch: within-destination ranks from the CUDA kernel; numpy: a
two-pass counting permutation, with identity fast paths when the chunk is
already grouped).

Scatter-plan protocol
---------------------
``ScatterPlan`` carries exactly one of three placements, applied by
:meth:`ScatterPlan.take`:

``order=None, pos=None``  identity — the chunk is already destination-
                          grouped (single live destination; e.g. every
                          edge into a 1-worker Sink).  ``take`` returns
                          the input array untouched: zero copies.
``order``                 gather indices: ``grouped = arr[order]``.
``pos``                   scatter slots ``bounds[dest] + rank`` (rank =
                          within-destination arrival index, the fused
                          counting-scatter form): ``grouped[pos] = arr``.

All three are *stable*: each worker receives its records in stream
(arrival) order, bit-identical to a stable ``argsort(dest)`` — the
contract that keeps per-worker FIFO replay and the fairness of initial
results (paper §4) identical across backends and the reference plane.

Backends
--------
``torch``   (default) the hand-written CUDA exchange kernel
            :func:`repro_torch.kernels.partition.partition_scatter` on the
            backend's device (plain PyTorch versions on ``device="cpu"``).
            The host keeps the per-key counters; each chunk's keys and
            counters are uploaded, the kernel emits destination,
            within-destination rank and histogram into one buffer, which
            comes back in one copy, and the host places
            record *i* at ``bounds[dest[i]] + rank[i]`` — no sort.
``numpy``   the host plane: ``RoutingTable.advance_counters`` + the
            canonical fixed-point inverse-CDF rule, pure numpy.  Its
            grouping permutation comes from :func:`scatter_order`:
            numpy's stable integer argsort on the int16-cast
            destinations, which for small integers *is* a two-pass
            counting (radix) scatter — O(n + W), not a comparison sort.
            Past ``MAX_RADIX_WORKERS`` a full-width stable argsort keeps
            correctness (one-time RuntimeWarning: it is a comparison
            sort again).

Both backends route through the same per-key counters owned by the edge's
``RoutingTable``, so backends can be swapped mid-run — or compared record
for record — without perturbing the low-discrepancy sequence.

Select a backend per engine (``Engine(partition_backend=...)``), per edge,
or globally via the ``REPRO_PARTITION_BACKEND`` environment variable.
Under the torch backend the engine promotes eligible edges to a
:class:`DeviceExchange`, whose ``send`` only stages the chunk for the
destination's device-resident runtime (:mod:`repro_torch.dataflow.device`).
"""
from __future__ import annotations

import dataclasses
import os
import warnings
import weakref
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.partitioner import RoutingTable
from ..devices import DeviceSpec, resolve_device
from ..kernels import partition as kpart
from .tuples import Chunk

#: Largest worker count the int16 radix cast in :func:`scatter_order` can
#: represent; beyond it the cast would wrap around silently and scatter
#: records to the wrong workers.
MAX_RADIX_WORKERS = int(np.iinfo(np.int16).max)


#: set once the first wide (> MAX_RADIX_WORKERS) fallback has warned.
_WARNED_WIDE_FALLBACK = False


def scatter_order(dest: np.ndarray, hist: np.ndarray) -> Optional[np.ndarray]:
    """Stable counting-scatter permutation grouping ``dest`` by worker.

    Returns gather indices ``order`` such that ``dest[order]`` is
    non-decreasing with equal destinations kept in arrival order, or
    ``None`` when the chunk is already grouped (at most one destination
    received records — the identity fast path, which makes every edge
    into a single-worker operator sort-free and copy-free).

    The general path is numpy's stable argsort of the int16-cast
    destinations: for bounded small integers numpy selects its radix
    sort, i.e. a two-pass counting scatter in O(n + W) — benchmarked
    faster than one-hot-cumsum rank composition at every (n, W) this
    engine runs.  The cast is guarded: ``hist.size`` (== num_workers)
    must fit int16 or worker ids would silently wrap; past the limit the
    full-width stable argsort keeps correctness (O(n log n) comparison
    sort) and a one-time :class:`RuntimeWarning` flags the perf cliff.
    """
    if np.count_nonzero(hist) <= 1:
        return None
    if hist.size > MAX_RADIX_WORKERS:  # int16 would wrap: fall back wide
        global _WARNED_WIDE_FALLBACK
        if not _WARNED_WIDE_FALLBACK:
            _WARNED_WIDE_FALLBACK = True
            warnings.warn(
                f"scatter_order: {hist.size} workers exceeds the int16 "
                f"radix-sort limit ({MAX_RADIX_WORKERS}); falling back to "
                f"a full-width stable argsort (correct, but O(n log n) "
                f"per chunk instead of the counting scatter). "
                f"(warned once)", RuntimeWarning, stacklevel=2)
            # Module-level site (no engine in scope): the process-wide
            # incident log keeps the cliff queryable, once per process
            # exactly like the warning.
            from . import resilience
            resilience.GLOBAL.record(
                "radix-cliff",
                cause=f"{hist.size} workers > int16 radix limit "
                      f"({MAX_RADIX_WORKERS})",
                action="full-width stable argsort")
        return np.argsort(dest, kind="stable")
    return np.argsort(dest.astype(np.int16), kind="stable")


@dataclasses.dataclass
class ScatterPlan:
    """One chunk's fused routing decision: destinations + placement.

    ``bounds[w] : bounds[w + 1]`` is worker ``w``'s slice of the grouped
    chunk; ``hist`` doubles as the per-worker traffic metric.  Exactly one
    of ``order`` / ``pos`` is set (or neither: identity, already grouped).
    """

    dest: np.ndarray                     # [n] destination worker ids
    hist: np.ndarray                     # [W] records per worker
    bounds: np.ndarray                   # [W + 1] slice boundaries
    order: Optional[np.ndarray] = None   # gather: grouped = arr[order]
    pos: Optional[np.ndarray] = None     # scatter: grouped[pos] = arr

    def take(self, arr: np.ndarray) -> np.ndarray:
        """Group one column by destination (stable; zero-copy if identity)."""
        if self.order is not None:
            return arr[self.order]
        if self.pos is not None:
            out = np.empty_like(arr)
            out[self.pos] = arr
            return out
        return arr

    def gather_indices(self) -> Optional[np.ndarray]:
        """Placement as gather indices (``None`` = identity).

        A ``pos``-form plan (kernel ranks) is inverted once — a single
        O(n) scatter of ``arange`` — so consumers can gather each worker's
        slice ``order[bounds[w]:bounds[w+1]]`` straight into its queue.
        """
        if self.order is None and self.pos is not None:
            self.order = np.empty(self.pos.size, dtype=np.int64)
            self.order[self.pos] = np.arange(self.pos.size, dtype=np.int64)
        return self.order


def _bounds_of(hist: np.ndarray) -> np.ndarray:
    bounds = np.zeros(hist.size + 1, dtype=np.int64)
    np.cumsum(hist, out=bounds[1:])
    return bounds


class PartitionBackend:
    """Computes the fused routing decision for one chunk.

    Implementations must consume ``routing.advance_counters(keys)`` exactly
    once per chunk so the deterministic low-discrepancy sequence advances
    identically under every backend.  ``partition`` returns the raw
    (destinations, histogram) pair; ``partition_scatter`` additionally
    returns the grouping placement as a :class:`ScatterPlan` — the default
    implementation derives it on the host via :func:`scatter_order`, and
    backends that can compute within-destination ranks during the
    partition itself (the CUDA kernel) override it.
    """

    name = "abstract"

    def partition(self, routing: RoutingTable,
                  keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (dest [n] int64, hist [num_workers] int64)."""
        raise NotImplementedError

    def partition_scatter(self, routing: RoutingTable,
                          keys: np.ndarray) -> ScatterPlan:
        """One-pass fused partition + grouping placement for a chunk."""
        dest, hist = self.partition(routing, keys)
        return ScatterPlan(dest, hist, _bounds_of(hist),
                           order=scatter_order(dest, hist))


class NumpyPartitionBackend(PartitionBackend):
    """Host path: fixed-point inverse-CDF routing in pure numpy."""

    name = "numpy"

    def partition(self, routing, keys):
        counters = routing.advance_counters(keys)
        dest = routing.route_lowdiscrepancy(keys, counters)
        hist = np.bincount(dest, minlength=routing.num_workers)
        return dest, hist


class TorchPartitionBackend(PartitionBackend):
    """Device path: the CUDA exchange kernel (histogram + ranks in one call).

    The host still owns the per-key counters (one ``advance_counters`` per
    chunk); the kernel receives the int32 keys and counters plus the
    host-computed float32 row-CDF, so its destinations match the numpy
    backend bit for bit.  The device copy of each table's CDF is cached per
    :class:`RoutingTable`, keyed by the identity of the host ``cdf32``
    array: every rewrite builds a new array, while ``version`` can return
    to an earlier value with other weights after a checkpoint restore.
    """

    name = "torch"

    def __init__(self, device: DeviceSpec = "cuda"):
        self.device = resolve_device(device)
        self._cdf: "weakref.WeakKeyDictionary[RoutingTable, tuple]" = (
            weakref.WeakKeyDictionary())

    def _device_cdf(self, routing: RoutingTable) -> torch.Tensor:
        host = routing.cdf32
        hit = self._cdf.get(routing)
        if hit is not None and hit[0] is host:
            return hit[1]
        dev = torch.from_numpy(host).to(self.device)
        self._cdf[routing] = (host, dev)
        return dev

    def _device_call(self, routing, keys, fn):
        counters = routing.advance_counters(keys)
        # astype(np.int32) wraps, as the JAX package's Pallas backend does.
        k = torch.from_numpy(np.asarray(keys).astype(np.int32))
        c = torch.from_numpy(counters.astype(np.int32))
        return fn(k.to(self.device), c.to(self.device),
                  self._device_cdf(routing))

    def partition(self, routing, keys):
        dest, hist = self._device_call(routing, keys, kpart.partition)
        return (dest.cpu().numpy().astype(np.int64),
                hist.cpu().numpy().astype(np.int64))

    def partition_scatter(self, routing, keys):
        # K1's three outputs lie in one buffer: one copy to the host.
        out = self._device_call(
            routing, keys, lambda k, c, cdf: kpart.partition_scatter(
                k, c, cdf, packed=True)).cpu().numpy().astype(np.int64)
        n = len(keys)
        dest, hist = out[:n], out[2 * n:]
        bounds = _bounds_of(hist)
        # Fused placement: each record's slot is its destination's base
        # offset plus its within-destination arrival rank (kernel output).
        pos = bounds[dest] + out[n:2 * n]
        return ScatterPlan(dest, hist, bounds, pos=pos)


_BACKENDS = {
    "numpy": NumpyPartitionBackend,
    "torch": TorchPartitionBackend,
}

BackendSpec = Union[None, str, PartitionBackend]


def get_backend(spec: BackendSpec = None,
                device: DeviceSpec = "cuda") -> PartitionBackend:
    """Resolve a backend: instance, name, or None (env var, then torch).

    ``device`` serves the ``torch`` backend; an instance keeps its own.
    """
    if isinstance(spec, PartitionBackend):
        return spec
    if spec is None:
        spec = os.environ.get("REPRO_PARTITION_BACKEND", "torch")
    try:
        cls = _BACKENDS[spec]
    except KeyError:
        raise ValueError(
            f"unknown partition backend {spec!r}; "
            f"choose from {sorted(_BACKENDS)}") from None
    return cls(device) if cls is TorchPartitionBackend else cls()


class Exchange:
    """Fused chunk routing for one edge (the data-plane hot path).

    ``send`` asks the backend for one :class:`ScatterPlan` (partition +
    placement in a single fused pass), groups each column with one
    fancy-index application, and hands every worker its contiguous slice;
    the plan histogram doubles as the slice boundaries and as the
    per-worker traffic metric (``sent_per_worker``).
    """

    def __init__(self, routing: RoutingTable, dst, backend: BackendSpec = None,
                 device: DeviceSpec = "cuda"):
        self.routing = routing
        self.dst = dst
        self.backend = get_backend(backend, device)
        self.tuples_sent = 0
        self.sent_per_worker = np.zeros(routing.num_workers, dtype=np.int64)
        #: partition+scatter placements computed on this edge (one per
        #: chunk).
        self.placements = 0

    def send(self, chunk: Chunk) -> None:
        keys, vals = chunk
        n = int(keys.size)
        if n == 0:
            return
        plan = self.backend.partition_scatter(self.routing, keys)
        self.placements += 1
        self.tuples_sent += n
        self.sent_per_worker += plan.hist
        receive = getattr(self.dst, "receive_scatter", None)
        if receive is not None:
            # Fused delivery: gather each worker's records straight into
            # its ring-buffer segment — no intermediate grouped array.
            receive(keys, vals, plan)
        else:  # minimal receive_sorted-only targets (test doubles)
            self.dst.receive_sorted(plan.take(keys), plan.take(vals),
                                    plan.bounds)


class DeviceExchange:
    """Device-plane edge: ``send`` stages the chunk on the device.

    The work happens in the destination operator's dispatch
    (:class:`repro_torch.dataflow.device.DeviceOpRuntime`): one dispatch
    per super-tick performs partition → rank → ring scatter → budgeted pop
    → fold for this edge.  ``send`` only stages — a host chunk is uploaded
    once (padded + masked), a :class:`~repro_torch.dataflow.device.DeviceChunk`
    from an upstream device operator is adopted as is, so consecutive
    device edges never round-trip through the host.  ``account`` is fed by
    the runtime's O(num_workers) per-dispatch metric readback, keeping
    ``tuples_sent`` / ``sent_per_worker`` exact.
    """

    def __init__(self, routing: RoutingTable, dst, runtime):
        self.routing = routing
        self.dst = dst
        self.runtime = runtime
        self.tuples_sent = 0
        self.sent_per_worker = np.zeros(routing.num_workers, dtype=np.int64)

    @property
    def placements(self):
        """Placement executions on this edge: one per ingested chunk."""
        return self.runtime.placements

    def account(self, hist: np.ndarray) -> None:
        self.tuples_sent += int(hist.sum())
        self.sent_per_worker += hist

    def send(self, chunk) -> None:
        self.runtime.stage(chunk)
