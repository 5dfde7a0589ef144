"""Columnar tuple chunks and per-worker queues for the pipelined engine.

The engine moves data in *chunks* -- parallel (keys, vals) numpy arrays --
instead of tuple-at-a-time (DESIGN.md §3 "assumptions changed").  A worker's
unprocessed queue is a contiguous ring buffer whose length in tuples is the
paper's workload metric phi: ``push`` appends with a single copy into the
backing arrays, and ``pop`` of *any* prefix -- one tick's ``service_rate``
or a batched scheduler's K-tick super-chunk -- is zero-copy, returning
views of the contiguous ``[head, head + n)`` span.  The old chunk-deque
(pop = deque walk + concat per tick) is gone.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Chunk = Tuple[np.ndarray, np.ndarray]  # (keys int64 [n], vals float64 [n] or [n, m])


def empty_chunk() -> Chunk:
    return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.float64)


def ring_span(head: int, length: int, cap: int) -> np.ndarray:
    """Wrap-aware element indices of a ring segment ``[head, head+length)``.

    The device exchange plane (:mod:`repro.dataflow.device`) backs each
    worker's queue with a fixed-capacity device ring addressed by
    monotone head/tail counters; this is the shared host-side address
    rule for materializing such a segment (checkpoint cuts, capacity
    regrowth) so host and device views of a ring can never disagree.
    """
    return (int(head) + np.arange(int(length))) % int(cap)


def first_col(vals: np.ndarray) -> np.ndarray:
    """Scalar payload column of a 1-D or 2-D value array."""
    return vals if vals.ndim == 1 else vals[:, 0]


def concat(chunks) -> Chunk:
    ks = [c[0] for c in chunks if c[0].size]
    vs = [c[1] for c in chunks if c[1].size]
    if not ks:
        return empty_chunk()
    return np.concatenate(ks), np.concatenate(vs)


class WorkerQueue:
    """Unprocessed-data queue of one worker (the phi metric source).

    A contiguous ring buffer over two backing arrays (keys, vals).  Pushes
    copy into ``[tail, tail + n)``; pops advance ``head`` and return
    *views* -- zero-copy, no concatenation.  When the tail hits capacity
    the consumed prefix is recycled: the live span is compacted to the
    front when at least half the buffer is slack, else the buffer doubles
    (amortized O(1) per tuple either way).

    Aliasing contract: a popped view stays valid until the next ``push``
    to the *same* queue.  The engine upholds this by construction -- every
    pop is fully consumed (processed, with outputs re-materialized by the
    exchange gather) before its queue can receive again; checkpointing
    uses ``snapshot`` (a copy) rather than pops.
    """

    __slots__ = ("_keys", "_vals", "_head", "_tail", "received_total")

    _MIN_CAPACITY = 256

    def __init__(self) -> None:
        self._keys: Optional[np.ndarray] = None
        self._vals: Optional[np.ndarray] = None
        self._head = 0
        self._tail = 0
        self.received_total = 0  # sigma_w: lifetime tuples received

    def __len__(self) -> int:
        return self._tail - self._head

    def _reserve(self, n: int, keys: np.ndarray, vals: np.ndarray) -> None:
        if self._keys is None:
            cap = max(self._MIN_CAPACITY, 2 * n)
            self._keys = np.empty(cap, dtype=keys.dtype)
            self._vals = np.empty((cap,) + vals.shape[1:], dtype=vals.dtype)
            return
        if vals.shape[1:] != self._vals.shape[1:]:
            raise ValueError(
                f"payload width changed mid-queue: buffer holds "
                f"{self._vals.shape[1:]}, push has {vals.shape[1:]}")
        cap = self._keys.shape[0]
        if self._tail + n <= cap:
            return
        live = self._tail - self._head
        if live + n <= cap // 2:
            # Recycle the consumed prefix (the ring wrap, kept contiguous).
            self._keys[:live] = self._keys[self._head:self._tail]
            self._vals[:live] = self._vals[self._head:self._tail]
        else:
            cap = max(2 * (live + n), self._MIN_CAPACITY)
            keys_new = np.empty(cap, dtype=self._keys.dtype)
            vals_new = np.empty((cap,) + self._vals.shape[1:],
                                dtype=self._vals.dtype)
            keys_new[:live] = self._keys[self._head:self._tail]
            vals_new[:live] = self._vals[self._head:self._tail]
            self._keys, self._vals = keys_new, vals_new
        self._head, self._tail = 0, live

    def push(self, keys: np.ndarray, vals: np.ndarray) -> None:
        n = keys.shape[0]
        if n == 0:
            return
        self._reserve(n, keys, vals)
        t = self._tail
        self._keys[t:t + n] = keys
        self._vals[t:t + n] = vals
        self._tail = t + n
        self.received_total += n

    def alloc(self, n: int, keys_like: np.ndarray,
              vals_like: np.ndarray) -> Chunk:
        """Reserve the next ``n`` slots and return them as writable views.

        The fused exchange gathers each worker's records straight into the
        returned segments (``np.take(..., out=view)``), skipping the
        intermediate grouped array a ``push`` would copy from.  The
        ``*_like`` arrays only donate dtype and payload width.  The caller
        must fill the views before the queue is read.
        """
        self._reserve(n, keys_like, vals_like)
        t = self._tail
        self._tail = t + n
        self.received_total += n
        return self._keys[t:t + n], self._vals[t:t + n]

    def pop(self, n: int) -> Chunk:
        """Remove and return up to n tuples from the head (zero-copy views)."""
        got = min(int(n), self._tail - self._head)
        if got <= 0:
            return empty_chunk()
        h = self._head
        self._head = h + got
        return self._keys[h:h + got], self._vals[h:h + got]

    def snapshot(self) -> Chunk:
        """Copy of the queue contents (for checkpointing)."""
        if self._keys is None or self._head == self._tail:
            return empty_chunk()
        return (self._keys[self._head:self._tail].copy(),
                self._vals[self._head:self._tail].copy())

    def restore(self, chunk: Chunk, received_total: int) -> None:
        self._keys = None
        self._vals = None
        self._head = self._tail = 0
        if chunk[0].size:
            self.push(np.asarray(chunk[0]), np.asarray(chunk[1]))
        self.received_total = received_total
