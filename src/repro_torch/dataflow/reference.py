"""Pre-refactor tuple-at-a-time data plane, kept as a testing oracle.

Counterpart of ``repro.dataflow.reference`` (``Engine(reference=True)``).

These classes are the engine's original dict-state / per-tuple-loop
implementations, preserved verbatim so the columnar exchange subsystem can
be verified against them end-to-end: the same workload run under
``Engine(reference=True)`` and under the default engine must produce a
bit-identical ``Sink.series``.

Do not use these in new workflows — they are O(records) Python loops.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .exchange import Exchange
from .operators import (
    GroupByAgg,
    HashJoinBuild,
    HashJoinProbe,
    RangeSort,
)
from .tuples import Chunk


class ReferenceExchange(Exchange):
    """The original ``Edge.send``: O(workers x records) boolean-mask scatter.

    Routing still goes through ``RoutingTable.route_chunk`` (the canonical
    rule), so destinations — and therefore results — match the columnar
    exchange exactly; only the scatter strategy differs.
    """

    def __init__(self, routing, dst):
        super().__init__(routing, dst, "numpy")

    def send(self, chunk: Chunk) -> None:
        keys, vals = chunk
        if keys.size == 0:
            return
        dest = self.routing.route_chunk(keys)
        self.placements += 1
        self.tuples_sent += int(keys.size)
        self.sent_per_worker += np.bincount(dest, minlength=self.sent_per_worker.size)
        for w in range(self.dst.num_workers):
            m = dest == w
            if m.any():
                self.dst.receive(w, keys[m], vals[m])


class RefHashJoinProbe(HashJoinProbe):
    """Dict-state probe: per-tuple ``len(state.get(k, ...))`` lookups."""

    state_factory = None

    def install_build(self, routing, build_keys, build_vals):
        owner = routing.owner
        for k, v in zip(build_keys, build_vals):
            w = int(owner[int(k)])
            self.workers[w].state.setdefault(int(k), []).append(float(v))

    def process(self, worker, keys, vals):
        # Sum owned + scattered rows (a split build key may hold both).
        matches = np.array(
            [len(worker.state.get(int(k), ()))
             + len(worker.scattered.get(int(k), ()))
             for k in keys],
            dtype=np.int64,
        )
        out_keys = np.repeat(keys, matches)
        out_vals = np.repeat(vals, matches, axis=0)
        return out_keys, out_vals

    @staticmethod
    def _scope_size(val) -> int:
        return len(val)

    def state_units(self, wid, mode):
        return float(sum(len(v) for v in self.workers[wid].state.values()))


class RefHashJoinBuild(HashJoinBuild):
    """Dict-state build: per-tuple appends."""

    state_factory = None

    def process(self, worker, keys, vals):
        from .tuples import first_col
        for k, v in zip(keys, first_col(vals)):
            k = int(k)
            table = worker.state if self._owned(worker, k) else worker.scattered
            table.setdefault(k, []).append(float(v))
        return None

    def merge_scattered(self) -> int:
        moved = 0
        for w in self.workers:
            for k, rows in list(w.scattered.items()):
                owner = self.workers[int(self.owner_of[k])] if self.owner_of is not None else w
                owner.state.setdefault(k, []).extend(rows)
                moved += len(rows)
            w.scattered.clear()
        return moved

    @staticmethod
    def _scope_size(val) -> int:
        return len(val)

    def state_units(self, wid, mode):
        return float(sum(len(v) for v in self.workers[wid].state.values()))


class RefGroupByAgg(GroupByAgg):
    """Dict-state groupby: per-tuple (count, sum) folds."""

    state_factory = None

    def process(self, worker, keys, vals):
        from .tuples import first_col
        for k, v in zip(keys, first_col(vals)):
            k = int(k)
            table = worker.state if self._owned(worker, k) else worker.scattered
            cnt, sm = table.get(k, (0, 0.0))
            table[k] = (cnt + 1, sm + float(v))
        return None

    def state_units(self, wid, mode):
        return float(len(self.workers[wid].state))

    def merge_scattered(self) -> int:
        moved = 0
        for w in self.workers:
            for k, (cnt, sm) in list(w.scattered.items()):
                owner = self.workers[int(self.owner_of[k])] if self.owner_of is not None else w
                c0, s0 = owner.state.get(k, (0, 0.0))
                owner.state[k] = (c0 + cnt, s0 + sm)
                moved += 1
            w.scattered.clear()
        return moved

    def on_end(self):
        self.merge_scattered()
        self.finished = True
        outs = []
        for w in self.workers:
            if not w.state:
                continue
            # ascending-key emission to mirror the columnar operator
            ks = np.array(sorted(w.state), dtype=np.int64)
            cs = np.array([w.state[int(k)][1] for k in ks], dtype=np.float64)
            w.stats.emitted_total += int(ks.size)
            outs.append((ks, cs))
        return outs


class RefRangeSort(RangeSort):
    """Dict-state range sort: per-unique-key mask selection."""

    state_factory = None

    def process(self, worker, keys, vals):
        from .tuples import first_col
        v1 = first_col(vals)
        for k in np.unique(keys):
            sel = v1[keys == k]
            k = int(k)
            table = worker.state if self._owned(worker, k) else worker.scattered
            table.setdefault(k, []).append(sel)
        return None

    def state_units(self, wid, mode):
        return float(sum(sum(a.size for a in v)
                         for v in self.workers[wid].state.values()))

    def merge_scattered(self) -> int:
        moved = 0
        for w in self.workers:
            for k, parts in list(w.scattered.items()):
                owner = self.workers[int(self.owner_of[k])] if self.owner_of is not None else w
                owner.state.setdefault(k, []).extend(parts)
                moved += sum(p.size for p in parts)
            w.scattered.clear()
        return moved

    def on_end(self):
        self.merge_scattered()
        self.finished = True
        outs = []
        for w in self.workers:
            for k in sorted(w.state):
                buf = np.sort(np.concatenate(w.state[k])) if w.state[k] else np.zeros(0)
                w.stats.emitted_total += int(buf.size)
                outs.append((np.full(buf.size, k, dtype=np.int64), buf))
        return outs

    def sorted_output(self) -> np.ndarray:
        per_range: Dict[int, List[np.ndarray]] = {}
        for w in self.workers:
            for table in (w.state, w.scattered):   # mid-run: fold splits in
                for k, parts in table.items():
                    per_range.setdefault(k, []).extend(parts)
        out = []
        for k in sorted(per_range):
            out.append(np.sort(np.concatenate(per_range[k])))
        return np.concatenate(out) if out else np.zeros(0)


#: columnar operator class -> reference (pre-refactor) twin
REFERENCE_OPS = {
    GroupByAgg: RefGroupByAgg,
    HashJoinProbe: RefHashJoinProbe,
    HashJoinBuild: RefHashJoinBuild,
    RangeSort: RefRangeSort,
}
