#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the last line:

1. card    the card's name, count, and ``nvidia-smi`` name and power limit;
2. build   nvcc builds every kernel source (one process each, in parallel)
           and the ``-Xptxas -v`` lines are printed;
3. kernels each CUDA kernel against its plain PyTorch version on the card,
           bit for bit, at odd shapes and at the real exchange shape
           (N = 2^24 records, K = 65,536 keys, W = 64 workers); CUDA-event
           times of both, and the bound from the card's memory rate;
4. main    the paper's workflows W1, W2 and W3 with the Reshape controller
           on ``device="cuda"`` (every chunk of every edge through the
           partition kernel), then each on the host ``numpy`` plane: ticks,
           ``Sink.series``, ``Sink.counts``, per-edge ``sent_per_worker`` and
           controller events must be identical, and results must equal the
           datasets' ground truth.  The kernels' launch counts are zeroed
           just before this phase and read just after it;
5. report  one JSON line of kernels, the card line, and the ``{"ok": ...}``
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


def bound_ms(n: int, num_keys: int, num_workers: int, per_record_bytes: int):
    """Least time on the card: bytes (inputs read once, outputs written
    once) over the memory rate vs N*W float32 compares over the fp32 rate."""
    nbytes = per_record_bytes * n + 4 * num_keys * num_workers + 4 * num_workers
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


WORKFLOWS = (
    ("W1", "build_w1", dict(scale=W1_SCALE)),
    ("W2", "build_w2", dict(n_tuples=W2_TUPLES)),
    ("W3", "build_w3", dict(n_tuples=W3_TUPLES)),
)


def run_workflow(dataflow, factory: str, kw, backend: str):
    """Run one workflow; returns it, its wall time, the host-clock time
    spent inside the exchange backend's per-chunk calls, and the share."""
    wf = getattr(dataflow, factory)(strategy="reshape", device="cuda",
                                    partition_backend=backend, **kw)
    exchange = wf.engine.partition_backend
    inner, spent = exchange.partition_scatter, [0.0]

    def timed(routing, keys):
        t = time.perf_counter()
        plan = inner(routing, keys)
        spent[0] += time.perf_counter() - t
        return plan

    exchange.partition_scatter = timed
    t0 = time.perf_counter()
    wf.run()
    wall = time.perf_counter() - t0
    # Routing-only entry point (K3): where the monitored edge's final table
    # sends the whole stream, i.e. the per-worker share after mitigation.
    _, share = wf.engine.partition_backend.partition(
        wf.edges[0].routing.copy(), wf.engine.sources[0].keys)
    return wf, wall, spent[0], share


def ground_truth_ok(name, wf, datasets) -> bool:
    import numpy as np
    if name == "W1":
        return np.array_equal(wf.sink.counts, datasets.tweet_counts(W1_SCALE))
    if name == "W2":
        spec = datasets.DsbSpec()
        items = datasets.dsb_sales(W2_TUPLES, spec, 1)[1]
        tot = np.zeros(spec.num_items, np.int64)
        for w in wf.meta["groupby"].workers:
            for k, (cnt, _) in w.state.items():
                tot[k] += cnt
        return np.array_equal(tot, np.bincount(items, minlength=spec.num_items))
    return np.array_equal(wf.monitored[0].sorted_output(),
                          np.sort(wf.meta["prices"]))


def main_path(torch, kpart):
    import numpy as np
    from repro_torch import dataflow
    from repro_torch.dataflow import datasets

    kpart.partition_scatter.launches = 0
    kpart.partition.launches = 0
    runs = {}
    for name, factory, kw in WORKFLOWS:
        before = kpart.partition_scatter.launches
        wf, wall, spent, share = run_workflow(dataflow, factory, kw, "torch")
        torch.cuda.synchronize()
        runs[name] = (wf, wall, spent, share,
                      kpart.partition_scatter.launches - before)
    launches = {"partition_scatter": kpart.partition_scatter.launches,
                "partition": kpart.partition.launches}

    for name, factory, kw in WORKFLOWS:
        wf, wall, spent, share, k1 = runs[name]
        host, host_wall, host_spent, host_share = run_workflow(
            dataflow, factory, kw, "numpy")
        check(k1 > 0, f"{name}: partition_scatter never launched")
        check(wf.engine.tick == host.engine.tick, f"{name}: ticks differ")
        check(same_series(wf.sink.series, host.sink.series),
              f"{name}: Sink.series differs from the host plane")
        check(np.array_equal(wf.sink.counts, host.sink.counts),
              f"{name}: Sink.counts differ")
        for e1, e2 in zip(wf.engine.edges, host.engine.edges):
            check(np.array_equal(e1.sent_per_worker, e2.sent_per_worker),
                  f"{name}: sent_per_worker differs")
        events = plain_events(wf.controllers[0].events)
        check(events == plain_events(host.controllers[0].events),
              f"{name}: controller events differ")
        check(np.array_equal(share, host_share),
              f"{name}: routing-only partition differs")
        check(ground_truth_ok(name, wf, datasets),
              f"{name}: result differs from the dataset's ground truth")
        tuples = int(wf.engine.sources[0].keys.size)
        log(f"main: {name} {tuples} tuples, {wf.engine.tick} ticks, "
            f"{len(events)} controller events, {k1} partition_scatter "
            f"launches: cuda {wall:.3f} s ({tuples / wall:.0f} tuples/s, "
            f"{spent:.3f} s in the exchange backend, "
            f"{1e6 * spent / k1:.1f} us a chunk), numpy host plane "
            f"{host_wall:.3f} s ({tuples / host_wall:.0f} tuples/s, "
            f"{host_spent:.3f} s in the exchange backend); identical")
    check(launches["partition"] > 0, "partition never launched")
    return launches


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
    launches = main_path(torch, kpart)
    log(f"main: all workflows in {time.perf_counter() - t0:.1f} s; "
        f"partition_scatter at the W1 chunk size {small_ms:.5f} ms a call")
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
