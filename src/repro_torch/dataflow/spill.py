"""Host spill tier for the device plane (out-of-core tiering).

Counterpart of ``repro.dataflow.spill``.  The device plane keeps ring
queues and row-store segments as ``torch`` tensors that grow by amortized
doubling; on the card that makes every edge bounded by its memory.  This
module supplies the host side of a watermark-based spill tier:

  * ``SpillConfig`` -- a per-edge device budget (in cells) with low/high
    watermarks.  Resolved from an ``Engine(device_budget=...)`` kwarg or
    the ``REPRO_DEVICE_BUDGET`` environment variable.
  * ``SpillSegment`` -- one checksummed span of cold state in pinned
    host memory (plain numpy; CRC32 over the raw bytes, verified on
    every re-upload and on ``sync_host``).
  * ``SpillState`` -- per-worker ordered segment stores plus a
    double-buffered prefetch cache that keeps the next spans already
    uploaded ahead of the pop cursor, so a refill never blocks the
    dispatch on a cold host read.  The runtime's ``upload`` callable
    decides what the cache holds (the port's copies a segment from
    pinned host memory to the card with ``non_blocking=True`` and keeps
    the pinned source beside the device copy); the segments themselves
    stay numpy, so their CRC is verified on host bytes before every
    re-upload.

Ordering invariant (rings): per worker the live records in logical
order are ``[resident][spilled]``.  Eviction takes the *newest* resident
records (the tail of the device ring) and prepends them to the spill
deque; refill pops the deque front (the logically-next records) and
re-appends them at the device ring tail; freshly-pushed records that do
not fit are appended at the deque back.  Row stores spill their oldest
rows (a prefix per worker) and are only read back at ``sync_host``.

The accounting mirrors owned by the device runtime (``lens`` /
``rows_len``) always count resident *plus* spilled records, so
workloads, backlog, END detection and controller decisions are
bit-identical to an unspilled run.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import zlib
from typing import Deque, List, Optional, Tuple

import numpy as np

__all__ = [
    "SpillConfig",
    "SpillSegment",
    "SpillState",
    "resolve_budget",
]

# Prefetch depth: how many front segments per worker stay pre-uploaded.
PREFETCH_DEPTH = 2


@dataclasses.dataclass(frozen=True)
class SpillConfig:
    """Per-edge device memory budget with spill watermarks.

    ``budget_cells`` bounds the *resident* entries of one edge (ring
    entries plus row-store rows, split evenly across workers).  Crossing
    ``high_wm`` of the per-worker share triggers eviction down to
    ``low_wm`` (hysteresis: the ``mem-pressure`` signal re-arms only
    after falling back under the low watermark).
    """

    budget_cells: int
    high_wm: float = 0.75
    low_wm: float = 0.5

    def __post_init__(self) -> None:
        if self.budget_cells <= 0:
            raise ValueError("budget_cells must be positive")
        if not (0.0 < self.low_wm <= self.high_wm <= 1.0):
            raise ValueError("need 0 < low_wm <= high_wm <= 1")

    def per_worker(self, num_workers: int) -> int:
        """Resident-entry limit for one worker (floor of 8 keeps tiny
        budgets functional: a dispatch always has room to stage)."""
        return max(self.budget_cells // max(1, num_workers), 8)


def resolve_budget(value=None) -> Optional[SpillConfig]:
    """Normalize a budget knob to a ``SpillConfig`` (or ``None`` = off).

    Accepts an int/str cell count, a ready ``SpillConfig``, or ``None``
    -- which falls back to ``REPRO_DEVICE_BUDGET`` in the environment.
    """
    if value is None:
        env = os.environ.get("REPRO_DEVICE_BUDGET", "").strip()
        if not env:
            return None
        value = env
    if isinstance(value, SpillConfig):
        return value
    return SpillConfig(budget_cells=int(value))


class SpillSegment:
    """One checksummed cold span in host memory.

    Holds a tuple of parallel numpy arrays (keys/vals[/flags]) of
    ``n`` records each, dtype-preserving so a round trip through the
    spill tier is bit-exact.  The CRC is computed at spill time and
    re-verified on every read back (refill, ``sync_host``).
    """

    __slots__ = ("arrays", "n", "crc")

    def __init__(self, arrays: Tuple[np.ndarray, ...], n: int):
        self.arrays = tuple(np.ascontiguousarray(a) for a in arrays)
        self.n = int(n)
        self.crc = self._checksum()

    def _checksum(self) -> int:
        c = 0
        for a in self.arrays:
            c = zlib.crc32(a.tobytes(), c)
        return c

    def verify(self) -> bool:
        return self._checksum() == self.crc

    def corrupt(self) -> None:
        """Flip one byte in place (chaos injection: ``spill-corrupt``)."""
        flat = self.arrays[0].view(np.uint8).reshape(-1)
        if flat.size:
            flat[0] ^= 0xFF


class SpillCorruptError(RuntimeError):
    """A spill segment failed its CRC check on read back."""

    def __init__(self, worker: int, store: str):
        super().__init__(f"spill segment CRC mismatch (worker {worker}, "
                         f"{store} store)")
        self.worker = worker
        self.store = store


class SpillState:
    """Per-worker spill stores + prefetch cache for one device runtime."""

    def __init__(self, cfg: SpillConfig, num_workers: int):
        self.cfg = cfg
        self.num_workers = int(num_workers)
        # Ring segments, deque per worker, logical order front->back.
        self.rings: List[Deque[SpillSegment]] = [
            collections.deque() for _ in range(self.num_workers)]
        # Row-store prefix segments, oldest first.
        self.rows: List[List[SpillSegment]] = [
            [] for _ in range(self.num_workers)]
        # Double-buffered prefetch: per worker a list of
        # (segment, device_arrays) pairs covering the deque front.
        self._prefetch: List[list] = [[] for _ in range(self.num_workers)]
        # mem-pressure hysteresis, armed per worker.
        self.pressure_active = np.zeros(self.num_workers, dtype=bool)
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.evictions = 0
        self.refills = 0
        self.rows_spilled = 0

    # ------------------------------------------------------------- #
    # totals (feed the sanitize cross-check and the mirrors)         #
    # ------------------------------------------------------------- #
    def ring_len(self, w: int) -> int:
        return sum(s.n for s in self.rings[w])

    def rows_len(self, w: int) -> int:
        return sum(s.n for s in self.rows[w])

    def any(self) -> bool:
        return any(self.rings[w] or self.rows[w]
                   for w in range(self.num_workers))

    # ------------------------------------------------------------- #
    # ring segment movement                                          #
    # ------------------------------------------------------------- #
    def prepend_ring(self, w: int, seg: SpillSegment) -> None:
        """Eviction: newest resident records become the deque front."""
        self.rings[w].appendleft(seg)
        self.evictions += 1
        self._drop_prefetch(w)

    def append_ring(self, w: int, seg: SpillSegment) -> None:
        """Overflow of fresh pushes: logically-last records, deque back."""
        self.rings[w].append(seg)
        self.evictions += 1
        if len(self.rings[w]) <= PREFETCH_DEPTH:
            self._drop_prefetch(w)

    def pop_ring_front(self, w: int):
        """Refill: pop the logically-next segment.

        Returns ``(segment, device_arrays_or_None)``; device arrays are
        the pre-uploaded copies when the prefetcher had them staged.
        Raises ``SpillCorruptError`` on a CRC mismatch.
        """
        seg = self.rings[w].popleft()
        if not seg.verify():
            self._prefetch[w] = []
            raise SpillCorruptError(w, "ring")
        dev = None
        if self._prefetch[w] and self._prefetch[w][0][0] is seg:
            dev = self._prefetch[w].pop(0)[1]
            self.prefetch_hits += 1
        else:
            self._prefetch[w] = []
            self.prefetch_misses += 1
        self.refills += 1
        return seg, dev

    def prefetch(self, w: int, upload) -> None:
        """Keep the front ``PREFETCH_DEPTH`` segments pre-uploaded.

        ``upload`` maps a host array to its device copy (the runtime's
        ``_spill_upload``: a pinned, ``non_blocking`` copy on the card);
        staging happens between dispatches so the next refill finds its
        span already on device (double buffering ahead of the pop
        cursor).
        """
        buf = self._prefetch[w]
        staged = {id(seg) for seg, _ in buf}
        for seg in list(self.rings[w])[:PREFETCH_DEPTH]:
            if len(buf) >= PREFETCH_DEPTH:
                break
            if id(seg) in staged:
                continue
            buf.append((seg, tuple(upload(a) for a in seg.arrays)))

    def _drop_prefetch(self, w: int) -> None:
        self._prefetch[w] = []

    # ------------------------------------------------------------- #
    # row-store segments                                             #
    # ------------------------------------------------------------- #
    def append_rows(self, w: int, seg: SpillSegment) -> None:
        self.rows[w].append(seg)
        self.rows_spilled += 1

    def drain_rows(self, w: int) -> List[SpillSegment]:
        """All spilled row segments, oldest first, CRC-verified."""
        segs = self.rows[w]
        for seg in segs:
            if not seg.verify():
                raise SpillCorruptError(w, "rows")
        return segs

    def drain_ring(self, w: int) -> List[SpillSegment]:
        """All spilled ring segments in logical order, CRC-verified."""
        segs = list(self.rings[w])
        for seg in segs:
            if not seg.verify():
                raise SpillCorruptError(w, "ring")
        return segs

    # ------------------------------------------------------------- #
    # chaos hook                                                     #
    # ------------------------------------------------------------- #
    def corrupt_one(self) -> bool:
        """Corrupt the first available segment (chaos: spill-corrupt)."""
        for w in range(self.num_workers):
            if self.rings[w]:
                self.rings[w][0].corrupt()
                self._drop_prefetch(w)
                return True
            if self.rows[w]:
                self.rows[w][0].corrupt()
                return True
        return False

    def clear(self) -> None:
        for w in range(self.num_workers):
            self.rings[w].clear()
            self.rows[w] = []
            self._prefetch[w] = []
        self.pressure_active[:] = False
