"""The adaptive partition function (paper §2.2, §3).

A ``RoutingTable`` is the materialization of "the partitioning logic at the
previous operator": a dense ``[num_keys, num_workers]`` row-stochastic matrix
``weights`` where ``weights[k, w]`` is the fraction of key *k*'s future
records sent to worker *w*.

  * hash partitioning      -> one-hot rows (k % num_workers)
  * SBK transfer           -> a row's single 1 moves to another column
  * SBR transfer           -> a row splits mass across several columns
  * phase-1 full redirect  -> all rows owned by S point at H

On TPU this table is a *traced argument* of the jitted step, so the
controller changes the partitioning logic by swapping a small array between
micro-batch steps -- the JAX analogue of Amber/Chi control messages (see
DESIGN.md §3).  Record-level splitting is deterministic: the host path uses
deficit round-robin (exact conservation: over n records of a key, worker w
receives ``round(n*w[k,w])`` within ±1), and the chunked/jitted path uses
inverse-CDF routing on a per-record low-discrepancy sequence.

Canonical inverse-CDF rule
--------------------------
Every chunked routing path -- ``route_chunk``/``route_lowdiscrepancy`` here,
:func:`repro_torch.core.ops.route_records` (the torch twin) and the CUDA exchange
kernel :func:`repro_torch.kernels.partition.partition` -- evaluates the *same*
bit-exact rule, so host and device can never disagree on a destination:

  u(c)  = ((c + 1) * GOLDEN_FIX mod 2^32) >> 8, scaled to float32 in [0, 1)
  dest  = #{w : u >= cdf32[k, w]}, clipped to num_workers - 1

``GOLDEN_FIX = floor(frac(phi) * 2^32)`` is the golden ratio in 32-bit
fixed point (Knuth's multiplicative-hash constant), so the sequence is the
classic Weyl low-discrepancy sequence computed in exact integer arithmetic;
the top 24 bits convert to float32 losslessly.  ``cdf32`` is the row-wise
float32 cumulative sum of the routing weights, computed once per table
version on the host and shared with the device kernel.  The comparison is
``u >= cdf`` everywhere (no epsilon slack on either side).
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

#: frac(phi) in 32-bit fixed point: floor(0.6180339887 * 2^32).
GOLDEN_FIX = np.uint32(2654435769)

#: GOLDEN_FIX reinterpreted as int32 (two's complement) for device code
#: whose multiplies wrap mod 2^32 on signed 32-bit lanes.
GOLDEN_FIX_I32 = int(np.uint32(2654435769).astype(np.int32))

_U24_SCALE = np.float32(1.0 / (1 << 24))


def ld_thresholds(counters: np.ndarray) -> np.ndarray:
    """Low-discrepancy threshold u in [0, 1) per record, exact in float32.

    ``counters`` is any per-key monotone record index (int-like).  The
    computation is pure 32-bit integer arithmetic (wrapping multiply by the
    fixed-point golden ratio), so numpy, torch and the CUDA kernel produce
    identical bits.
    """
    c = np.asarray(counters).astype(np.uint32, copy=False)
    bits = (c + np.uint32(1)) * GOLDEN_FIX          # wraps mod 2^32
    return (bits >> np.uint32(8)).astype(np.float32) * _U24_SCALE


def routing_cdf32(weights: np.ndarray) -> np.ndarray:
    """Canonical float32 row-CDF of a routing-weight matrix.

    Computed on the host with a sequential cumsum; device kernels take this
    array as an input instead of re-deriving it so rounding is identical.

    Entries from each row's last positive-weight column onward are
    saturated to 1.0: a float32 row total can round *below* 1 (e.g.
    0.99999994 == the largest threshold ``ld_thresholds`` can emit), and
    without saturation a record whose u reaches the total would count past
    the last live worker and land on a zero-weight one.  With saturation,
    ``u < 1`` guarantees destinations only ever carry positive routing
    weight (zero-weight workers *between* live ones are already
    unreachable: their CDF entry equals the previous one bit-for-bit, so
    the >= count always skips them).
    """
    w = np.asarray(weights)
    cdf = np.cumsum(w.astype(np.float32), axis=1, dtype=np.float32)
    num_workers = w.shape[1]
    last = num_workers - 1 - np.argmax((w > 0)[:, ::-1], axis=1)
    cols = np.arange(num_workers)
    cdf[cols[None, :] >= last[:, None]] = np.float32(1.0)
    return cdf


def inverse_cdf_destinations(u: np.ndarray, cdf_rows: np.ndarray,
                             num_workers: int) -> np.ndarray:
    """dest = #{w : u >= cdf[w]} clipped to the last worker."""
    dest = (u[:, None] >= cdf_rows).sum(axis=1)
    return np.minimum(dest, num_workers - 1).astype(np.int64)


class RoutingTable:
    """Mutable key->worker routing with fractional splits."""

    def __init__(self, num_keys: int, num_workers: int, *, init: str = "hash"):
        if num_keys < 1 or num_workers < 1:
            raise ValueError("need at least one key and one worker")
        self.num_keys = num_keys
        self.num_workers = num_workers
        self.weights = np.zeros((num_keys, num_workers), dtype=np.float64)
        if init == "hash":
            self.weights[np.arange(num_keys), np.arange(num_keys) % num_workers] = 1.0
        elif init == "uniform":
            self.weights[:] = 1.0 / num_workers
        else:
            raise ValueError(f"unknown init {init!r}")
        # `owner` tracks the pre-mitigation primary of each key so phase
        # transitions and scattered-state merges know where state belongs.
        self.owner = self.weights.argmax(axis=1).astype(np.int64)
        self.version = 0
        # Deficit round-robin accumulators for exact record splitting.
        self._credit = np.zeros((num_keys, num_workers), dtype=np.float64)
        # Per-key record counters for the vectorized low-discrepancy path.
        self._count = np.zeros(num_keys, dtype=np.int64)
        # Derived routing structures (float32 row-CDF shared with device
        # kernels, one-hot primaries, split-key mask); recomputed lazily
        # whenever `version` moves.
        self._cdf32: Optional[np.ndarray] = None
        self._primary: Optional[np.ndarray] = None
        self._is_split: Optional[np.ndarray] = None
        self._any_split = False
        self._derived_version = -1
        # Routing-equivalence fingerprint cache (see `routing_token`);
        # the weights-derived half is invalidated with the rest of the
        # derived state on every version bump.
        self._token: Optional[int] = None
        # Optional listener(keys, old_rows, new_rows) fired on any rewrite.
        # Engines use it to synchronize state migration with the partition
        # change (the "markers" strategy of §5.3: both happen at the same
        # chunk boundary).
        self.listener = None
        # When a device exchange plane owns the per-key counters (they
        # advance on the accelerator), this holds its puller: a callable
        # returning the authoritative counter array.  ``sync_counters``
        # materializes on demand (checkpoints); a *host* ``advance``
        # additionally steals ownership back, so mid-run backend swaps
        # just work — the device copy is pulled once and the host
        # sequence continues bit-exactly.
        self._count_owner = None

    # ------------------------------------------------------------------ #
    # Mutations (each bumps `version`; engines treat a version change as  #
    # "the previous operator changed its partitioning logic").            #
    # ------------------------------------------------------------------ #
    def copy(self) -> "RoutingTable":
        self.sync_counters()
        rt = RoutingTable(self.num_keys, self.num_workers)
        rt.weights = self.weights.copy()
        rt.owner = self.owner.copy()
        rt.version = self.version
        rt._credit = self._credit.copy()
        rt._count = self._count.copy()
        return rt

    def _check_key(self, key: int) -> None:
        if not 0 <= key < self.num_keys:
            raise IndexError(f"key {key} out of range")

    def _notify(self, keys, old_rows, new_rows) -> None:
        if self.listener is not None:
            self.listener(list(keys), np.asarray(old_rows), np.asarray(new_rows))

    def keys_of(self, worker: int) -> np.ndarray:
        """Keys whose current routing sends any mass to ``worker``."""
        return np.nonzero(self.weights[:, worker] > 0)[0]

    def owned_by(self, worker: int) -> np.ndarray:
        return np.nonzero(self.owner == worker)[0]

    def move_key(self, key: int, dst: int) -> None:
        """SBK: send *all* future records of ``key`` to ``dst``."""
        self._check_key(key)
        old = self.weights[key].copy()
        self.weights[key] = 0.0
        self.weights[key, dst] = 1.0
        self._credit[key] = 0.0
        self.version += 1
        self._notify([key], old[None], self.weights[key][None])

    def split_key(self, key: int, workers: Sequence[int], fracs: Sequence[float]) -> None:
        """SBR: split future records of ``key`` across ``workers``."""
        self._check_key(key)
        fracs = np.asarray(fracs, dtype=np.float64)
        if len(workers) != len(fracs):
            raise ValueError("workers/fracs length mismatch")
        if np.any(fracs < 0) or not np.isclose(fracs.sum(), 1.0):
            raise ValueError("fractions must be non-negative and sum to 1")
        old = self.weights[key].copy()
        self.weights[key] = 0.0
        for w, f in zip(workers, fracs):
            self.weights[key, int(w)] = float(f)
        self._credit[key] = 0.0
        self.version += 1
        self._notify([key], old[None], self.weights[key][None])

    def redirect_worker(
        self, src: int, dst: int, *, keys: Optional[Iterable[int]] = None
    ) -> List[int]:
        """Phase-1 catch-up: route future input of ``src`` to ``dst``.

        With ``keys=None`` the whole partition of ``src`` is redirected (the
        paper's primary phase-1 implementation); otherwise only ``keys``
        (the reduced-state-transfer alternative, §3.2).
        Returns the list of redirected keys.
        """
        if keys is None:
            keys = self.keys_of(src).tolist()
        moved: List[int] = []
        old_rows = []
        for k in keys:
            self._check_key(int(k))
            mass = self.weights[int(k), src]
            if mass <= 0:
                continue
            old_rows.append(self.weights[int(k)].copy())
            self.weights[int(k), src] = 0.0
            self.weights[int(k), dst] += mass
            moved.append(int(k))
        if moved:
            self.version += 1
            self._notify(moved, np.stack(old_rows), self.weights[moved])
        return moved

    def restore_keys(self, keys: Iterable[int], weights: np.ndarray) -> None:
        """Install explicit rows (used when phase 2 replaces phase 1)."""
        keys = list(keys)
        w = np.asarray(weights, dtype=np.float64)
        if w.shape != (len(keys), self.num_workers):
            raise ValueError("weights shape mismatch")
        if np.any(w < 0) or not np.allclose(w.sum(axis=1), 1.0):
            raise ValueError("rows must be stochastic")
        old_rows = np.stack([self.weights[int(k)].copy() for k in keys]) if keys else w
        for row, k in enumerate(keys):
            self._check_key(int(k))
            self.weights[int(k)] = w[row]
            self._credit[int(k)] = 0.0
        if keys:
            self.version += 1
            self._notify([int(k) for k in keys], old_rows, w)

    # ------------------------------------------------------------------ #
    # Routing application                                                 #
    # ------------------------------------------------------------------ #
    def _refresh_derived(self) -> None:
        if self._derived_version != self.version:
            w = self.weights
            self._cdf32 = routing_cdf32(w)
            self._primary = w.argmax(axis=1).astype(np.int64)
            self._is_split = np.count_nonzero(w > 0, axis=1) > 1
            self._any_split = bool(self._is_split.any())
            self._token = None
            self._derived_version = self.version

    def routing_token(self):
        """Cheap equivalence fingerprint of the *pure* routing function.

        Two tables whose tokens compare equal are provably
        routing-equivalent: they send any record stream to identical
        destinations, **independently of their per-key counters**, so a
        downstream edge may reuse an upstream edge's placement (the
        device plane's multi-edge chain fusion).  That holds exactly when
        neither table has split keys — a one-hot table's destination is
        the counter-free gather ``primary[key]`` — so a table with any
        split key returns ``None`` (never equivalent to anything: its
        destinations depend on private counter state even against an
        identically-weighted twin).

        The token is ``(num_keys, num_workers, hash(primary),
        hash(owner))``.  The instance ``version`` counter is deliberately
        *not* part of it: versions count mutations per instance and are
        meaningless across instances (two fresh tables both read 0; two
        independently-rewritten tables with identical weights may read 3
        and 7) — content is what proves equivalence, and any version
        bump that changes routing changes the content hash too.  The
        weights-derived half is cached via ``_derived_version`` (every
        mutation invalidates it); ``owner`` is hashed per call because
        MARKERS migrations rewrite it *without* a version bump (direct
        element writes — there is no epoch to cache against, and a
        missed write site would silently fuse non-equivalent edges).
        The per-call cost is one O(num_keys) hash per chain edge per
        super-tick, bounded by the device plane's ``MAX_FOLD_CELLS``
        key-space ceiling and amortized over the super-tick's record
        volume — correctness over an epoch-counter micro-optimization.
        """
        self._refresh_derived()
        if self._any_split:
            return None
        if self._token is None:
            self._token = hash(self._primary.tobytes())
        return (self.num_keys, self.num_workers, self._token,
                hash(self.owner.tobytes()))

    @property
    def cdf32(self) -> np.ndarray:
        """Float32 row-CDF of ``weights``, cached per table version."""
        self._refresh_derived()
        return self._cdf32

    def invalidate_cache(self) -> None:
        """Drop derived caches (call after writing weights/version directly,
        e.g. checkpoint restore)."""
        self._cdf32 = None
        self._primary = None
        self._is_split = None
        self._any_split = False
        self._token = None
        self._derived_version = -1

    def sync_counters(self) -> None:
        """Materialize device-owned per-key counters into ``_count``.

        No-op when the host owns them.  Ownership is unchanged: the
        device plane keeps advancing; this is the checkpoint-boundary
        read.
        """
        if self._count_owner is not None:
            self._count[:] = self._count_owner()

    def advance_counters(self, keys: np.ndarray) -> np.ndarray:
        """Per-record running per-key counters for a chunk; advances the
        persistent per-key counts.

        If a device plane owns the counters, they are materialized first
        and ownership returns to the host (the backend-swap handshake).

        Stateless routing (`route_lowdiscrepancy`, the torch twin, the CUDA
        kernel) consumes the returned counters, so an exchange backend owns
        exactly one stateful step: this one.  Only *split* keys consume the
        low-discrepancy sequence — a one-hot key's destination is
        counter-independent under the canonical rule, so its counter is
        left untouched (and the returned entry is 0) until a rewrite
        actually splits it.  Every routing path shares this policy, which
        keeps destinations identical across backends and the reference
        plane.
        """
        if self._count_owner is not None:
            self.sync_counters()
            self._count_owner = None
        keys = np.asarray(keys, dtype=np.int64)
        counters = np.zeros(keys.size, dtype=np.int64)
        if keys.size == 0:
            return counters
        self._refresh_derived()
        if not self._any_split:
            return counters
        split = self._is_split[keys]
        idx = np.flatnonzero(split)
        if idx.size == 0:
            return counters
        sk = keys[idx]
        # Running per-key occurrence index within this chunk.
        order = np.argsort(sk, kind="stable")
        sorted_keys = sk[order]
        n = sorted_keys.size
        starts_mask = np.empty(n, dtype=bool)
        starts_mask[0] = True
        np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=starts_mask[1:])
        starts = np.flatnonzero(starts_mask)
        seg_lens = np.diff(np.append(starts, n))
        local_idx = np.arange(n) - np.repeat(starts, seg_lens)
        occ = np.empty(n, dtype=np.int64)
        occ[order] = local_idx
        counters[idx] = self._count[sk] + occ
        self._count[sorted_keys[starts]] += seg_lens
        return counters

    def route(self, keys: np.ndarray) -> np.ndarray:
        """Exact host-side routing of a chunk of records (deficit RR).

        For every record the key's per-worker credit is incremented by the
        row weights and the record goes to the worker with the largest
        credit, whose credit is then decremented by 1.  Over any prefix the
        per-worker allocation of a key deviates from the ideal split by < 1.
        """
        keys = np.asarray(keys, dtype=np.int64)
        out = np.empty(keys.shape[0], dtype=np.int64)
        credit = self._credit
        weights = self.weights
        for i, k in enumerate(keys):
            credit[k] += weights[k]
            w = int(np.argmax(credit[k]))
            credit[k, w] -= 1.0
            out[i] = w
        return out

    def route_chunk(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized routing of a chunk (the engine's hot path).

        Uses persistent per-key counters + the fixed-point golden-ratio
        low-discrepancy sequence, so a key split r/(1-r) deviates from the
        ideal allocation by O(log n) over any window while staying fully
        deterministic and bit-identical to the device kernel.
        """
        keys = np.asarray(keys, dtype=np.int64)
        if keys.size == 0:
            return np.zeros(0, dtype=np.int64)
        return self.route_lowdiscrepancy(keys, self.advance_counters(keys))

    def route_lowdiscrepancy(self, keys: np.ndarray, counters: np.ndarray) -> np.ndarray:
        """Stateless routing: inverse CDF at a fixed-point golden-ratio
        sequence point (the canonical rule, see module docstring).

        ``counters[i]`` is the running per-key record index of record *i*
        (any monotone per-key counter works).  This form is jittable --
        :func:`repro_torch.core.ops.route_records` is the torch twin, and
        :func:`repro_torch.kernels.partition.partition` the CUDA kernel; all
        three produce identical destinations for identical inputs.
        """
        keys = np.asarray(keys, dtype=np.int64)
        self._refresh_derived()
        dest = self._primary[keys]
        if self._any_split:
            m = self._is_split[keys]
            idx = np.flatnonzero(m)
            if idx.size:
                u = ld_thresholds(np.asarray(counters)[idx])
                dest[idx] = inverse_cdf_destinations(
                    u, self._cdf32[keys[idx]], self.num_workers)
        return dest

    # ------------------------------------------------------------------ #
    # Introspection                                                       #
    # ------------------------------------------------------------------ #
    def expected_share(self, key_freq: np.ndarray) -> np.ndarray:
        """Per-worker expected input share under key distribution."""
        kf = np.asarray(key_freq, dtype=np.float64)
        kf = kf / max(kf.sum(), 1e-12)
        return kf @ self.weights

    def as_array(self) -> np.ndarray:
        return self.weights.copy()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"RoutingTable(keys={self.num_keys}, workers={self.num_workers}, "
            f"version={self.version})"
        )


def routing_table_from_numpy(state) -> RoutingTable:
    """A :class:`RoutingTable` holding another table's state.

    ``state`` maps ``weights``, ``owner``, ``_count``, ``_credit`` and
    ``version`` to numpy arrays (a scalar for ``version``), as read off a
    table of the JAX package, so a run can carry its routing state across
    to this package and go on routing bit-identically.  Derived caches are
    rebuilt from the weights on first use.
    """
    weights = np.array(state["weights"], dtype=np.float64)
    if weights.ndim != 2:
        raise ValueError(f"weights must be [num_keys, num_workers], got "
                         f"shape {weights.shape}")
    rt = RoutingTable(*weights.shape)
    rt.weights = weights
    rt.owner = np.array(state["owner"], dtype=np.int64)
    rt._count = np.array(state["_count"], dtype=np.int64)
    rt._credit = np.array(state["_credit"], dtype=np.float64)
    rt.version = int(state["version"])
    if (rt.owner.shape != weights.shape[:1] or rt._count.shape != weights.shape[:1]
            or rt._credit.shape != weights.shape):
        raise ValueError("owner/_count/_credit do not match the weights' shape")
    rt.invalidate_cache()
    return rt
