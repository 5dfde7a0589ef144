"""Array-backed keyed-state containers for the stateful operators.

The engine's hot path updates keyed state per *chunk*, not per tuple, so a
worker's state lives in dense numpy arrays indexed by scope id:

  AggStore   scope -> (count, sum)        dense int64/float64 columns
  ScopeRows  scope -> growing row buffer  per-scope lists of column slices
                                          plus a dense per-scope row count

Both containers speak the ``MutableMapping`` protocol with the exact value
shapes the old dict-of-scopes state used — ``AggStore[k] == (count, sum)``,
``ScopeRows[k] == [np.ndarray, ...]`` — so the cold control plane (state
migration, scattered-state merge at END markers, checkpoint deepcopy, test
introspection) is unchanged, while the data plane reads/writes whole
columns:

  AggStore.add_many(keys, vals)            bincount into (counts, sums)
  ScopeRows.extend_segments(keys, vals)    one list-append per key *segment*
  ScopeRows.counts_of(keys)                vectorized match counting (CSR
                                           row lengths; joins probe with it)

``ScopeRows.freeze()`` materializes the classic CSR (offsets, rows) pair
for bulk export (sorted run emission, device transfer).
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np


def segment_starts(sorted_keys: np.ndarray) -> np.ndarray:
    """Start offsets of equal-key segments in a sorted key array."""
    if sorted_keys.size == 0:
        return np.zeros(0, dtype=np.int64)
    return np.r_[0, np.nonzero(np.diff(sorted_keys))[0] + 1]


class AggStore:
    """Dense per-scope (count, sum) aggregate state.

    A scope is "present" once touched; ``items()`` iterates present scopes
    in ascending scope order.
    """

    __slots__ = ("counts", "sums", "present")

    def __init__(self, num_scopes: int):
        self.counts = np.zeros(num_scopes, dtype=np.int64)
        self.sums = np.zeros(num_scopes, dtype=np.float64)
        self.present = np.zeros(num_scopes, dtype=bool)

    # -- data plane ----------------------------------------------------- #
    def add_many(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Fold a column of (key, val) records into the aggregates."""
        if keys.size == 0:
            return
        n = self.counts.size
        self.counts += np.bincount(keys, minlength=n)
        self.sums += np.bincount(keys, weights=vals, minlength=n)
        self.present[keys] = True

    def merge_from(self, other: "AggStore", scopes: np.ndarray) -> None:
        """Fold ``other``'s given scopes into this store (END merge)."""
        self.counts[scopes] += other.counts[scopes]
        self.sums[scopes] += other.sums[scopes]
        self.present[scopes] = True

    def present_scopes(self) -> np.ndarray:
        return np.nonzero(self.present)[0]

    def clear(self) -> None:
        self.counts[:] = 0
        self.sums[:] = 0
        self.present[:] = False

    # -- device-plane hooks --------------------------------------------- #
    def load_dense(self, counts: np.ndarray, sums: np.ndarray,
                   present: np.ndarray) -> None:
        """Overwrite from dense columns (device -> host materialization).

        The device exchange plane folds a worker's aggregates in dense
        ``[num_scopes]`` device columns and lazily materializes them here
        at host boundaries (checkpoints, END merges, migrations); the
        mapping protocol and everything built on it then operate on the
        exact same state a host-plane run would hold.
        """
        self.counts[:] = counts
        self.sums[:] = sums
        self.present[:] = present

    def export_dense(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense columns for the device fold (host -> device upload)."""
        return self.counts, self.sums, self.present

    # -- mapping protocol (control plane / tests / checkpoints) --------- #
    def __contains__(self, k: int) -> bool:
        return bool(self.present[k])

    def __getitem__(self, k: int) -> Tuple[int, float]:
        if not self.present[k]:
            raise KeyError(k)
        return int(self.counts[k]), float(self.sums[k])

    def __setitem__(self, k: int, val: Tuple[int, float]) -> None:
        self.counts[k], self.sums[k] = int(val[0]), float(val[1])
        self.present[k] = True

    def __delitem__(self, k: int) -> None:
        if not self.present[k]:
            raise KeyError(k)
        self.counts[k] = 0
        self.sums[k] = 0.0
        self.present[k] = False

    def __len__(self) -> int:
        return int(self.present.sum())

    def __iter__(self) -> Iterator[int]:
        return iter(int(k) for k in self.present_scopes())

    def keys(self):
        return list(self)

    def values(self):
        return [self[k] for k in self]

    def items(self):
        return [(k, self[k]) for k in self]

    def get(self, k: int, default=None):
        return self[k] if k in self else default


class ScopeRows:
    """Per-scope variable-length row buffers with a dense length index.

    The hot path appends whole column *slices* per scope (one Python-level
    operation per key segment, not per record) and reads row counts as one
    gather; the cold path sees a mapping scope -> list-of-arrays exactly
    like the old dict state.  ``freeze()`` yields CSR (offsets, rows).
    """

    __slots__ = ("counts", "present", "parts")

    def __init__(self, num_scopes: int):
        self.counts = np.zeros(num_scopes, dtype=np.int64)
        self.present = np.zeros(num_scopes, dtype=bool)
        self.parts: Dict[int, List[np.ndarray]] = {}

    # -- data plane ----------------------------------------------------- #
    def append_scope(self, k: int, rows: np.ndarray) -> None:
        if rows.size == 0 and k in self.parts:
            return
        self.parts.setdefault(k, []).append(rows)
        self.counts[k] += rows.size
        self.present[k] = True

    def extend_segments(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Append a chunk of (key, row) records, one slice per key segment.

        ``keys`` need not be sorted; a stable argsort groups equal keys
        while preserving their arrival order.
        """
        if keys.size == 0:
            return
        order = np.argsort(keys, kind="stable")
        ks, vs = keys[order], vals[order]
        starts = segment_starts(ks)
        bounds = np.r_[starts, ks.size]
        for i, s in enumerate(starts):
            self.append_scope(int(ks[s]), vs[s:bounds[i + 1]])

    def counts_of(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized per-record row count (join match counting)."""
        return self.counts[keys]

    def extend_from(self, other: "ScopeRows", k: int) -> int:
        """Move scope ``k``'s parts from ``other`` into this store."""
        parts = other.parts.get(k, [])
        moved = int(sum(p.size for p in parts))
        if parts:
            self.parts.setdefault(k, []).extend(parts)
            self.counts[k] += moved
            self.present[k] = True
        return moved

    def scope_array(self, k: int) -> np.ndarray:
        parts = self.parts.get(k, [])
        if not parts:
            return np.zeros(0, dtype=np.float64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def present_scopes(self) -> np.ndarray:
        return np.nonzero(self.present)[0]

    def total_rows(self) -> int:
        return int(self.counts.sum())

    def freeze(self) -> Tuple[np.ndarray, np.ndarray]:
        """CSR export: (offsets [num_scopes+1], rows [total_rows])."""
        offsets = np.zeros(self.counts.size + 1, dtype=np.int64)
        np.cumsum(self.counts, out=offsets[1:])
        rows = np.zeros(int(offsets[-1]), dtype=np.float64)
        for k, parts in self.parts.items():
            if parts:
                rows[offsets[k]:offsets[k + 1]] = np.concatenate(parts)
        return offsets, rows

    def export_rows(self) -> Tuple[np.ndarray, np.ndarray]:
        """Keyed row export: (keys [total_rows], rows [total_rows]).

        Rows come out grouped by scope in ascending scope order with each
        scope's rows in arrival order — exactly the layout the device
        exchange plane uploads into its flat per-worker segment store,
        chosen so that a later regroup by key (stable) reproduces every
        scope array bit-for-bit (:meth:`extend_segments` is the inverse).
        """
        offsets, rows = self.freeze()
        keys = np.repeat(np.arange(self.counts.size, dtype=np.int64),
                         self.counts)
        return keys, rows

    def clear(self) -> None:
        self.counts[:] = 0
        self.present[:] = False
        self.parts.clear()

    # -- mapping protocol (control plane / tests / checkpoints) --------- #
    def __contains__(self, k: int) -> bool:
        return bool(self.present[k])

    def __getitem__(self, k: int) -> List[np.ndarray]:
        if not self.present[k]:
            raise KeyError(k)
        return self.parts.setdefault(k, [])

    def __setitem__(self, k: int, parts: List[np.ndarray]) -> None:
        old = int(sum(p.size for p in self.parts.get(k, [])))
        parts = [np.asarray(p) for p in parts]
        self.parts[k] = parts
        self.counts[k] += sum(p.size for p in parts) - old
        self.present[k] = True

    def __delitem__(self, k: int) -> None:
        if not self.present[k]:
            raise KeyError(k)
        self.parts.pop(k, None)
        self.counts[k] = 0
        self.present[k] = False

    def __len__(self) -> int:
        return int(self.present.sum())

    def __iter__(self) -> Iterator[int]:
        return iter(int(k) for k in self.present_scopes())

    def keys(self):
        return list(self)

    def values(self):
        return [self[k] for k in self]

    def items(self):
        return [(k, self[k]) for k in self]

    def get(self, k: int, default=None):
        return self[k] if k in self else default
