#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the last line:

1. card    the card's name, count, and ``nvidia-smi`` name and power limit;
2. build   nvcc builds every kernel source (one process each, in parallel)
           and the ``-Xptxas -v`` lines are printed;
3. kernels each CUDA kernel against its plain PyTorch version on the card
           at odd shapes and at the real exchange shape (N = 2^24 records,
           K = 65,536 keys, W = 64 workers): K1/K3 bit for bit; K2 with all
           lanes live, suffix padding and random holes in the mask, with
           dest / rank / hist / fold_counts bit for bit and fold_sums within
           a bound from each key's count of a float64 sum of the same
           values; CUDA-event times of kernel and plain version, and the
           bound from the card's memory rate;
4. main    the paper's workflows with the Reshape controller on
           ``device="cuda"``, path by path, each driven with the kernels'
           launch counts set to 0 just before it and read just after it:
             W3 resident        1.5M orders (TPC-H SF1 ORDERS),
                                ``device_executor="jit"``: both edges on
                                the device-resident plane (K2);
             W1 resident-mixed  ``"jit"``: filter and sink edges resident
                                (K2), the probe edge per chunk (K1);
             W1, W2, W3 per-chunk  the builders' default executor: every
                                chunk of every edge through K1;
           then each workflow once on the host ``numpy`` plane.  Ticks,
           ``Sink.series``, ``Sink.counts``, per-edge ``sent_per_worker``,
           controller events and the sort's row state must be identical to
           the host run, and results must equal the datasets' ground truth.
           ``Sink.sums`` must equal the host run's on a per-chunk path, and
           lie within c * 2^-23 * sum|v| of it on a resident one (c the
           key's count; the resident sink adds K2's float32 chunk sums);
5. replay  K2 against its plain version on the very inputs the resident
           paths gave it: the first call at each (N, K, W) of each path
           (W3's ingest and its one sink call of the whole sorted output,
           W1's filter ingest and sink calls), checked as in phase 3 and
           timed;
6. report  one JSON line of kernels, the card line, and the ``{"ok": ...}``
           line last.

Without a card, or run from a directory that holds only this file, it exits
non-zero and prints no result.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import enum
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
#: tensor cores (the kernels' compares are float32).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

#: The real exchange shape of the kernel phase.
REAL_N, REAL_K, REAL_W = 2**24, 65_536, 64
#: Share of dead lanes in K2's real-shape mask.
REAL_DEAD = 0.1
#: Workflow sizes of the main path: W1 at twice the datasets' CI scale
#: (144,592 tweets), W2 at its default 60k sales, W3 at TPC-H SF1's 1.5M
#: orders.
W1_SCALE, W2_TUPLES, W3_TUPLES = 2.0, 60_000, 1_500_000

SOURCE = "src/repro_torch/kernels/csrc/partition.cu"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*parts) -> None:
    print(*parts, flush=True)


# --------------------------------------------------------------------- #
# 3. kernels                                                             #
# --------------------------------------------------------------------- #
def make_inputs(torch, seed: int, n: int, num_keys: int, num_workers: int,
                split_frac: float):
    """Keys, int32 counters and a row-CDF: one-hot rows, and ``split_frac``
    of the rows split over 2-8 workers (Dirichlet weights)."""
    import numpy as np
    from repro_torch.core.ops import saturated_cdf32

    rng = np.random.default_rng(seed)
    w = np.zeros((num_keys, num_workers))
    w[np.arange(num_keys), rng.integers(0, num_workers, num_keys)] = 1.0
    for k in np.flatnonzero(rng.random(num_keys) < split_frac):
        m = int(rng.integers(2, min(8, num_workers) + 1)) if num_workers > 1 else 1
        cols = rng.choice(num_workers, size=m, replace=False)
        w[k] = 0.0
        w[k, cols] = rng.dirichlet(np.ones(m))
    keys = torch.from_numpy(rng.integers(0, num_keys, n).astype(np.int32))
    counters = torch.from_numpy(
        rng.integers(-2**31, 2**31 - 1, n).astype(np.int32))
    cdf = saturated_cdf32(torch.from_numpy(w))
    return keys.cuda(), counters.cuda(), cdf.cuda()


def fold_inputs(torch, seed: int, n: int, num_keys: int, num_workers: int,
                mask: str, split_frac: float = 0.3):
    """K2's inputs: ``make_inputs`` plus float32 vals and a lane mask that
    is all live, suffix-padded (the upload's padding) or holed (a Filter's
    dead lanes anywhere)."""
    import numpy as np
    keys, counters, cdf = make_inputs(torch, seed, n, num_keys, num_workers,
                                      split_frac)
    rng = np.random.default_rng(seed + 10_000)
    vals = rng.uniform(-10.0, 10.0, n).astype(np.float32)
    if mask == "live":
        valid = np.ones(n, bool)
    elif mask == "suffix":
        valid = np.arange(n) < n - n // 4
    else:
        valid = rng.random(n) >= (REAL_DEAD if mask == "real" else 0.3)
    return (keys, counters, torch.from_numpy(vals).cuda(),
            torch.from_numpy(valid).cuda(), cdf)


def check_fold(torch, name: str, got, want, args) -> float:
    """K2's integer outputs bit for bit against the plain version, and both
    versions' fold_sums against a float64 sum of the same float32 values.
    Any order of c additions of float32 values is within c * 2^-24 * sum|v|
    of the exact sum (first-order bound); the check allows twice that.
    Returns the kernel's max |fold_sums - float64 sum|."""
    err = max_abs_err(got[:4], want[:4])
    check(err == 0, f"{name}: integer outputs disagree with the plain "
                    f"version: max |err| {err}")
    keys, _, vals, valid, cdf = args
    num_keys = cdf.shape[0]
    live = valid & (keys >= 0) & (keys < num_keys)
    slot = torch.where(live, keys.long(), 0)
    v64 = torch.where(live, vals.double(), 0.0)
    exact = torch.zeros(num_keys, dtype=torch.float64,
                        device=keys.device).index_add_(0, slot, v64)
    sumabs = torch.zeros_like(exact).index_add_(0, slot, v64.abs())
    tol = got[3].double() * 2.0**-23 * sumabs
    for sums in (got[4], want[4]):
        dev = (sums.double() - exact).abs()
        check(bool((dev <= tol).all()),
              f"{name}: fold_sums beyond c * 2^-23 * sum|v| of the float64 "
              f"sum (max |err| {float(dev.max()):.3g})")
    return float((got[4].double() - exact).abs().max()) if num_keys else 0.0


def max_abs_err(got, want) -> int:
    err = 0
    for g, p in zip(got, want):
        check(g.shape == p.shape and g.dtype == p.dtype,
              f"shape/dtype {tuple(g.shape)} {g.dtype} vs {tuple(p.shape)} {p.dtype}")
        if g.numel():
            err = max(err, int((g.long() - p.long()).abs().max()))
    return err


def time_ms(torch, fn, args, reps: int) -> float:
    for _ in range(3):
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n: int, num_keys: int, num_workers: int, per_record_bytes: int,
             per_key_bytes: int = 0):
    """Least time on the card: bytes (inputs read once, outputs written
    once) over the memory rate vs N*W float32 compares over the fp32 rate."""
    nbytes = (per_record_bytes * n + 4 * num_keys * num_workers
              + 4 * num_workers + per_key_bytes * num_keys)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * num_workers / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch, kpart, ref):
    """Bit-exact comparisons and timings; returns the per-kernel records."""
    max_workers = kpart.MAX_WORKERS
    errs = {"partition_scatter": 0, "partition": 0}
    pairs = (("partition_scatter", kpart.partition_scatter, ref.partition_scatter),
             ("partition", kpart.partition, ref.partition))
    seed = 0
    for n in (1, 1023, 1025, 2**20 + 7):
        for num_workers in (1, 20, 48, 64, max_workers):
            seed += 1
            args = make_inputs(torch, seed, n, 4096, num_workers, 0.3)
            for name, kernel, plain in pairs:
                err = max_abs_err(kernel(*args), plain(*args))
                check(err == 0, f"{name} disagrees with its plain version "
                                f"at N={n} W={num_workers}: max |err| {err}")
                errs[name] = max(errs[name], err)
    torch.cuda.synchronize()
    log(f"kernels: K1/K3 bit-identical to the plain versions at N in "
        f"{{1, 1023, 1025, 2^20+7}} x W in {{1, 20, 48, 64, {max_workers}}}")

    k2 = "partition_scatter_fold"
    errs[k2] = 0.0
    for n in (1, 1023, 1025, 2**20 + 7):
        for num_workers in (1, 20, 48, 64, max_workers):
            for mask in ("live", "suffix", "holes"):
                seed += 1
                args = fold_inputs(torch, seed, n, 4096, num_workers, mask)
                errs[k2] = max(errs[k2], check_fold(
                    torch, f"{k2} N={n} W={num_workers} mask={mask}",
                    kpart.partition_scatter_fold(*args),
                    ref.partition_scatter_fold(*args), args))
    torch.cuda.synchronize()
    log(f"kernels: {k2} integer outputs bit-identical to the plain version, "
        f"fold_sums within c * 2^-23 * sum|v| of float64, at N in "
        f"{{1, 1023, 1025, 2^20+7}} x W in {{1, 20, 48, 64, {max_workers}}} "
        f"x mask in {{live, suffix, holes}}")

    args = make_inputs(torch, 99, REAL_N, REAL_K, REAL_W, 0.01)
    records = []
    for name, kernel, plain, per_record, replaces in (
            ("partition_scatter", kpart.partition_scatter, ref.partition_scatter,
             16, "src/repro/kernels/partition.py:226"),
            ("partition", kpart.partition, ref.partition, 12,
             "src/repro/kernels/partition.py:81")):
        err = max_abs_err(kernel(*args), plain(*args))
        check(err == 0, f"{name} disagrees with its plain version at the "
                        f"real shape: max |err| {err}")
        errs[name] = max(errs[name], err)
        ms = time_ms(torch, kernel, args, 50)
        plain_ms = time_ms(torch, plain, args, 20)
        b_ms, b_by = bound_ms(REAL_N, REAL_K, REAL_W, per_record)
        log(f"kernels: {name} N={REAL_N} K={REAL_K} W={REAL_W}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"{100 * b_ms / ms:.1f}% of bound; library: none, no single "
            f"PyTorch call computes this function)")
        records.append(dict(name=name, route="cuda", source=SOURCE,
                            replaces=replaces, launches=0,
                            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None))
    del args
    torch.cuda.empty_cache()

    args = fold_inputs(torch, 98, REAL_N, REAL_K, REAL_W, "real", 0.01)
    errs[k2] = max(errs[k2], check_fold(
        torch, f"{k2} at the real shape", kpart.partition_scatter_fold(*args),
        ref.partition_scatter_fold(*args), args))
    ms = time_ms(torch, kpart.partition_scatter_fold, args, 50)
    plain_ms = time_ms(torch, ref.partition_scatter_fold, args, 10)
    # Compulsory bytes: keys, counters, vals (4 N each) and the 1-byte mask
    # in, dest and rank (4 N each) out, the cdf table, hist and both folds.
    b_ms, b_by = bound_ms(REAL_N, REAL_K, REAL_W, 21, 8)
    log(f"kernels: {k2} N={REAL_N} K={REAL_K} W={REAL_W} "
        f"({REAL_DEAD:.0%} dead lanes): {ms:.4f} ms (plain {plain_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of "
        f"bound; library: none, no single PyTorch call computes this "
        f"function)")
    records.append(dict(name=k2, route="cuda", source=SOURCE,
                        replaces="src/repro/kernels/partition.py:286",
                        launches=0, max_abs_err=errs[k2], ms=ms,
                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        library_ms=None))
    del args
    torch.cuda.empty_cache()

    # The end-to-end chunk size: one tick of W1 (48 workers x 4 records).
    small = make_inputs(torch, 7, 192, 56, 48, 0.05)
    small_ms = time_ms(torch, kpart.partition_scatter, small, 500)
    log(f"kernels: partition_scatter at the W1 chunk size N=192 K=56 W=48: "
        f"{small_ms:.5f} ms a call (CUDA events, 500 calls)")
    return records, small_ms


# --------------------------------------------------------------------- #
# 4. main path                                                           #
# --------------------------------------------------------------------- #
def plain_events(events):
    """Controller events as plain values (enums by name)."""
    def plain(x):
        if isinstance(x, enum.Enum):
            return x.name
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x.item() if hasattr(x, "item") else x
    return [plain(dataclasses.asdict(e)) for e in events]


def same_series(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        t1 == t2 and np.array_equal(c1, c2) for (t1, c1), (t2, c2) in zip(a, b))


#: Card paths of the main phase: (label, builder, kwargs, device_executor;
#: None = the builders' default, the per-chunk plane).
PATHS = (
    ("W3 resident", "build_w3", dict(n_tuples=W3_TUPLES), "jit"),
    ("W1 resident-mixed", "build_w1", dict(scale=W1_SCALE), "jit"),
    ("W1 per-chunk", "build_w1", dict(scale=W1_SCALE), None),
    ("W2 per-chunk", "build_w2", dict(n_tuples=W2_TUPLES), None),
    ("W3 per-chunk", "build_w3", dict(n_tuples=W3_TUPLES), None),
)
KERNELS = ("partition_scatter", "partition_scatter_fold", "partition")
#: Edge planes each card path must show, and the kernels it must (True) or
#: must not (False) launch.
EXPECT = {
    "W3 resident": (["jit", "jit"], dict(partition_scatter=False,
                                         partition_scatter_fold=True)),
    "W1 resident-mixed": (["jit", None, "jit"],
                          dict(partition_scatter=True,
                               partition_scatter_fold=True)),
}
PER_CHUNK = dict(partition_scatter=True, partition_scatter_fold=False)


class FoldRecorder:
    """Stands in for K2's wrapper during the card paths and calls it.

    Keeps the inputs of the first call at each (path, N, K, W), for the
    replay against the plain version, and every sink call's (keys, vals,
    valid), for the bound on the sink's float sums.  The wrapped function
    still counts its own launches."""

    def __init__(self, kpart):
        self.kernel = kpart.partition_scatter_fold
        self.label = ""
        self.first = {}
        self.sink_calls = []

    # The wrapper counts its launches on the name it has in its module,
    # which is this recorder while it stands in: forward the count.
    @property
    def launches(self) -> int:
        return self.kernel.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.kernel.launches = n

    def __call__(self, keys, counters, vals, valid, cdf):
        num_keys, num_workers = cdf.shape
        key = (self.label, keys.numel(), num_keys, num_workers)
        if key not in self.first:
            self.first[key] = tuple(t.clone() for t in
                                    (keys, counters, vals, valid, cdf))
        if num_workers == 1:
            self.sink_calls.append((keys, vals, valid))
        return self.kernel(keys, counters, vals, valid, cdf)

    def sink_abs_sums(self, torch, num_keys: int):
        """Per key, the sum of |v| over the live lanes of the sink calls
        recorded since the last call."""
        out = torch.zeros(num_keys, dtype=torch.float64, device="cuda")
        for keys, vals, valid in self.sink_calls:
            live = valid & (keys >= 0) & (keys < num_keys)
            out.index_add_(0, torch.where(live, keys.long(), 0),
                           torch.where(live, vals.double().abs(), 0.0))
        self.sink_calls = []
        return out.cpu().numpy()


def run_workflow(dataflow, factory: str, kw, backend: str, executor=None):
    """Run one workflow with the Reshape controller; returns it, its wall
    time, the host-clock seconds and calls of the per-chunk exchange
    backend, of the resident runtime's dispatches and of its boundary
    materializations (``sync_host`` / ``sync_stats`` /
    ``sync_sink_counts``), and the routing-only share.  Times are
    exclusive: a timed call made inside another (the per-chunk exchange of
    a chunk a resident Filter emits, a boundary's flush dispatch) counts
    for itself only."""
    from repro_torch.dataflow.device import DeviceOpRuntime

    if executor is not None:
        kw = dict(kw, device_executor=executor)
    wf = getattr(dataflow, factory)(strategy="reshape", device="cuda",
                                    partition_backend=backend, **kw)
    exchange = wf.engine.partition_backend
    spent = {"exchange": [0.0, 0], "dispatch": [0.0, 0],
             "boundary": [0.0, 0]}
    stack = []          # [start, seconds of timed calls nested inside]

    def timed(fn, what):
        def wrapper(*args):
            stack.append([time.perf_counter(), 0.0])
            try:
                return fn(*args)
            finally:
                start, inner = stack.pop()
                took = time.perf_counter() - start
                spent[what][0] += took - inner
                spent[what][1] += 1
                if stack:
                    stack[-1][1] += took
        return wrapper

    exchange.partition_scatter = timed(exchange.partition_scatter, "exchange")
    methods = {"_dispatch": "dispatch", "sync_host": "boundary",
               "sync_stats": "boundary", "sync_sink_counts": "boundary"}
    saved = {m: getattr(DeviceOpRuntime, m) for m in methods}
    for m, what in methods.items():
        setattr(DeviceOpRuntime, m, timed(saved[m], what))
    try:
        t0 = time.perf_counter()
        wf.run()
        if backend == "torch":
            import torch
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for m, fn in saved.items():
            setattr(DeviceOpRuntime, m, fn)
    # Routing-only entry point (K3): where the monitored edge's final table
    # sends the whole stream, i.e. the per-worker share after mitigation.
    _, share = wf.engine.partition_backend.partition(
        wf.edges[0].routing.copy(), wf.engine.sources[0].keys)
    return wf, wall, spent, share


def ground_truth_ok(factory, wf, datasets) -> bool:
    import numpy as np
    if factory == "build_w1":
        return np.array_equal(wf.sink.counts, datasets.tweet_counts(W1_SCALE))
    if factory == "build_w2":
        spec = datasets.DsbSpec()
        items = datasets.dsb_sales(W2_TUPLES, spec, 1)[1]
        tot = np.zeros(spec.num_items, np.int64)
        for w in wf.meta["groupby"].workers:
            for k, (cnt, _) in w.state.items():
                tot[k] += cnt
        return np.array_equal(tot, np.bincount(items, minlength=spec.num_items))
    return np.array_equal(wf.monitored[0].sorted_output(),
                          np.sort(wf.meta["prices"]))


def same_row_state(a, b) -> bool:
    """Per-worker ScopeRows equality (state and scattered): scope sets and
    exact scope arrays, after materializing device-resident state."""
    import numpy as np
    a._device_sync()
    b._device_sync()
    for wa, wb in zip(a.workers, b.workers):
        for ta, tb in ((wa.state, wb.state), (wa.scattered, wb.scattered)):
            if set(ta.keys()) != set(tb.keys()):
                return False
            for k in ta.keys():
                if not np.array_equal(ta.scope_array(int(k)),
                                      tb.scope_array(int(k))):
                    return False
    return True


def main_path(torch, kpart):
    """Drive every card path (launch counts zeroed just before each and read
    just after), then hold each against one host numpy run of the same
    workflow.  Returns the launches per kernel, summed over the paths, and
    the K2 inputs the recorder kept."""
    import numpy as np
    from repro_torch import dataflow
    from repro_torch.dataflow import datasets

    kernels = {name: getattr(kpart, name) for name in KERNELS}
    rec = FoldRecorder(kpart)
    kpart.partition_scatter_fold = rec
    cards = {}
    try:
        for label, factory, kw, executor in PATHS:
            for fn in kernels.values():
                fn.launches = 0
            rec.label = label
            run = run_workflow(dataflow, factory, kw, "torch", executor)
            torch.cuda.synchronize()
            counts = {name: fn.launches for name, fn in kernels.items()}
            absum = (rec.sink_abs_sums(torch, run[0].sink.counts.size)
                     if executor == "jit" else None)
            cards[label] = run + (counts, absum)
    finally:
        kpart.partition_scatter_fold = rec.kernel
    launches = {name: sum(c[4][name] for c in cards.values())
                for name in KERNELS}
    for label in EXPECT:
        widths = {k[3] for k in rec.first if k[0] == label}
        check(1 in widths and max(widths) > 1,
              f"{label}: K2 was not called at both the ingest and the sink")

    hosts = {}
    for label, factory, kw, executor in PATHS:
        key = (factory, tuple(sorted(kw.items())))
        if key not in hosts:
            hosts[key] = run_workflow(dataflow, factory, kw, "numpy")
        host, host_wall, host_spent, host_share = hosts[key]
        wf, wall, spent, share, counts, absum = cards[label]
        planes, must = EXPECT.get(label, ([None] * len(wf.engine.edges),
                                          PER_CHUNK))
        check([e.device_plane for e in wf.engine.edges] == planes,
              f"{label}: edge planes {[e.device_plane for e in wf.engine.edges]}"
              f", expected {planes}")
        check(not wf.engine.incidents.query(kind="demotion"),
              f"{label}: an edge was demoted")
        for name, launched in must.items():
            check((counts[name] > 0) == launched,
                  f"{label}: {name} launched {counts[name]} times")
        check(counts["partition"] > 0, f"{label}: partition never launched")
        check(wf.engine.tick == host.engine.tick, f"{label}: ticks differ")
        check(same_series(wf.sink.series, host.sink.series),
              f"{label}: Sink.series differs from the host plane")
        check(np.array_equal(wf.sink.counts, host.sink.counts),
              f"{label}: Sink.counts differ")
        if absum is None:
            check(np.array_equal(wf.sink.sums, host.sink.sums),
                  f"{label}: Sink.sums differ from the host plane")
            sums = "sums identical"
        else:
            # Each float32 chunk sum is within c * 2^-24 * sum|v| of the
            # exact one (the cast and the additions, first order); the
            # check allows twice that, per key.
            dev = np.abs(wf.sink.sums - host.sink.sums)
            tol = wf.sink.counts * 2.0**-23 * absum
            check(bool((dev <= tol).all()),
                  f"{label}: Sink.sums beyond c * 2^-23 * sum|v| of the "
                  f"host plane's (max |err| {dev.max():.6g})")
            rel = dev / np.maximum(np.abs(host.sink.sums), 1e-300)
            sums = (f"sums max |err| {dev.max():.6g}, max relative "
                    f"{rel.max():.3g}, at most {(dev / np.maximum(tol, 1e-300)).max():.3g} "
                    f"of the bound")
        for e1, e2 in zip(wf.engine.edges, host.engine.edges):
            check(np.array_equal(e1.sent_per_worker, e2.sent_per_worker),
                  f"{label}: sent_per_worker differs")
        events = plain_events(wf.controllers[0].events)
        check(events == plain_events(host.controllers[0].events),
              f"{label}: controller events differ")
        check(np.array_equal(share, host_share),
              f"{label}: routing-only partition differs")
        check(ground_truth_ok(factory, wf, datasets),
              f"{label}: result differs from the dataset's ground truth")
        if factory == "build_w3":
            check(same_row_state(wf.monitored[0], host.monitored[0]),
                  f"{label}: the sort's row state differs")
        tuples = int(wf.engine.sources[0].keys.size)
        parts = "; ".join(
            f"{what} {sec:.3f} s in {calls} calls"
            + (f", {1e6 * sec / calls:.1f} us each" if calls else "")
            for what, (sec, calls) in spent.items())
        log(f"main: {label}: {tuples} tuples, {wf.engine.tick} ticks, "
            f"{len(events)} controller events, "
            f"{wf.edges[0].routing.version} rewrites of the monitored "
            f"edge, launches "
            f"K1 {counts['partition_scatter']} / "
            f"K2 {counts['partition_scatter_fold']} / "
            f"K3 {counts['partition']}: cuda {wall:.3f} s "
            f"({tuples / wall:.0f} tuples/s; {parts}), numpy host plane "
            f"{host_wall:.3f} s ({tuples / host_wall:.0f} tuples/s); "
            f"identical, {sums}")
    return launches, rec.first


def replay_phase(torch, kpart, ref, first) -> float:
    """K2 against its plain version on the inputs the resident paths gave
    it (the first call at each shape of each path), timed.  Returns the
    kernel's max |fold_sums - float64 sum|."""
    k2 = "partition_scatter_fold"
    err = 0.0
    for (label, n, num_keys, num_workers), args in first.items():
        what = f"{label} N={n} K={num_keys} W={num_workers}"
        err = max(err, check_fold(torch, f"{k2} on {what}",
                                  kpart.partition_scatter_fold(*args),
                                  ref.partition_scatter_fold(*args), args))
        small = n <= 1 << 16
        ms = time_ms(torch, kpart.partition_scatter_fold, args,
                     200 if small else 20)
        plain_ms = time_ms(torch, ref.partition_scatter_fold, args,
                           50 if small else 5)
        b_ms, b_by = bound_ms(n, num_keys, num_workers, 21, 8)
        log(f"replay: {k2} on {what} ({int(args[3].sum())} live lanes): "
            f"{ms:.5f} ms a call (plain {plain_ms:.5f} ms, bound "
            f"{b_ms:.6f} ms by {b_by}; CUDA events, {200 if small else 20}"
            f" / {50 if small else 5} calls); integers bit-identical")
    return err


# --------------------------------------------------------------------- #
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import partition as kpart
    from repro_torch.kernels import ref

    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {kind} x{count} | torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build()
    log(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")

    records, small_ms = kernel_phase(torch, kpart, ref)
    t0 = time.perf_counter()
    launches, first = main_path(torch, kpart)
    log(f"main: all workflows in {time.perf_counter() - t0:.1f} s; "
        f"partition_scatter at the W1 chunk size {small_ms:.5f} ms a call")
    replay_err = replay_phase(torch, kpart, ref, first)
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if rec["name"] == "partition_scatter_fold":
            rec["max_abs_err"] = max(rec["max_abs_err"], replay_err)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
