#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the last line:

1. card    the card's name, count, and ``nvidia-smi`` name and power limit;
2. build   nvcc builds every kernel source (one process each, in parallel)
           and the ``-Xptxas -v`` lines are printed; K4's tiles and stream
           kernels and K5's wgmma kernel must hold wgmma (HGMMA) in their
           SASS (``cuobjdump``);
3. kernels each CUDA kernel against its plain PyTorch version on the card
           at odd shapes, on both sides of K1's and K2's one-tile limit
           (N = 4095, 4096, 4097), and at the real exchange shape (N = 2^24
           records, K = 65,536 keys, W = 64 workers): K1/K3 bit for bit; K2
           with all lanes live, suffix padding and random holes in the
           mask, with dest / rank / hist / fold_counts bit for bit and
           fold_sums within a bound from each key's count of a float64 sum
           of the same values; all three again on adversarial tables (rows
           whose float32 CDF rounds above 1 before the last positive
           column, zero columns, all-zero rows, one live column) with
           thresholds at 0, at 1 - 2^-24 and beside the rows' entries; K2
           on the resident plane's wide columns (int64 keys and counters,
           no counters, float64 vals); CUDA-event times of kernel and plain
           version, the bound from the card's memory rate, and the stream
           operations of one multi-tile call under the profiler (K1 and K3
           must make one); then the in-dispatch controller's step
           ``ctrl_step`` (``csrc/ctrl_step.cu``, one block, warp 0 running
           the rounds) against its plain version from random controller
           states with mitigations live in both phases, W 20, 48 and 64, a
           quarter and half of the workers mitigating, window 64, and two
           wide states (W 150: phi staged past the launch's parameter
           block; W 200 at window 160: the rings read in place), k 1 and
           16: every state field bit for bit;
4. main    the paper's workflows with the Reshape controller on
           ``device="cuda"``, path by path, each driven with the kernels'
           launch counts set to 0 just before it and read just after it:
             W3 resident        1.5M orders (TPC-H SF1 ORDERS),
                                ``device_executor="jit"``: both edges on
                                the device-resident plane (K2);
             W3 resident spill  the same with a 375,000-cell device budget
                                (a quarter of the sort's row store) under
                                ``REPRO_SANITIZE=1``: the spill tier must
                                engage (``mem-pressure``, the sort's rows
                                spilled, the controller's pressure
                                consumed), with no demotion; row and ring
                                evictions, refills and prefetch hits are
                                printed, and its host seconds (``spill``);
             W3 resident armed  W3 resident under
                                ``REPRO_DEVICE_CONTROLLER=1``: every metric
                                round on the card, one ``ctrl_step`` launch
                                and one epoch readback a tick, the host
                                controller reconciled by a drain every 64
                                windows; its rounds must equal the
                                host-stepped controller's, its launches its
                                steps, with no ``ctrl-mismatch`` or
                                ``ctrl-demotion``; tau, mitigations and the
                                routing weights and counters equal the host
                                plane's (``ctrl step`` and ``ctrl drain``
                                host seconds, steps and drains printed);
             W3 resident armed k16  the same driven by fixed windows of
                                ``ARMED_K`` = 16 ticks beside the host
                                plane driven by the same windows (metric
                                rounds no longer cut them);
             W3 resident chaos  the spill path driven by a ``ChaosRunner``
                                under ``CHAOS_PLAN`` (each of the nine
                                fault kinds once; cuts every 1,000 ticks,
                                4 kept): every kind injected, each healed
                                (a retry for the dispatch faults, a
                                ``recovery`` for each rolled-back kind),
                                the spill corruption on a real segment,
                                no demotion; cuts, their seconds and the
                                replayed ticks are printed;
             W1 resident        ``"jit"``: the filter, probe and sink
                                edges resident (K2, no K1), the Filter ->
                                Probe chain fused (one placement a
                                super-tick) until the controller's first
                                rewrite of the probe table, per edge after;
             W1 resident chunked-probe  a device budget nothing reaches
                                and the probe's ``MAX_EMIT_CELLS`` half its
                                first emit block: the probe emits in two
                                sub-dispatches a tick (one
                                ``degraded-emit``, no ``probe fanout``
                                demotion);
             W1 resident unfused  the same with ``REPRO_DEVICE_CHAIN=0``:
                                every edge its own placement, no fused
                                dispatch (the cost of fusion, same call);
             W1 resident-mixed  the probe's emit ceiling set to 0, so its
                                edge demotes (``probe fanout``) on the
                                first tick and the resident filter's
                                device chunks cross to it per chunk
                                (compacted on the host, then K1; K2 on the
                                filter and sink edges);
             W4 resident        80,000 tuples, 40 workers, 42 keys (paper
                                §7.8), ``"jit"``: the probe and sink edges
                                resident (K2);
             W1, W2, W3 per-chunk  the builders' default executor: every
                                chunk of every edge through K1;
           then each workflow once on the host ``numpy`` plane.  Ticks,
           ``Sink.series``, ``Sink.counts``, per-edge ``sent_per_worker``,
           controller events and the sort's row state must be identical to
           the host run, and results must equal the datasets' ground truth;
           no edge may be demoted but W1 resident-mixed's probe edge (for
           ``probe fanout``), no fused chain may fall back, W1 resident's
           probe edge must have paid placements, fewer than the host
           plane's, and the unfused and mixed paths as many as the host
           plane's (each edge's placements, the fused dispatches and the
           time of the per-tick fusion check are printed).
           ``Sink.sums`` must equal the host run's on a per-chunk path, and
           lie within c * 2^-23 * sum|v| of it on a resident one (c the
           key's count; the resident sink adds K2's float32 chunk sums);
           ``ctrl_step`` must launch on the armed paths and on no other;
5. replay  K1 and K3 bit for bit on the first call of each path that
           launched them, and K2 against its plain version on the very
           inputs the resident paths gave it: the first call at each
           (N, K, W) of each path (W3's ingest and its one sink call of the
           whole sorted output, W1's filter and probe ingests and sink
           calls on each resident path, W4's probe ingest and sink calls),
           checked
           as in phase 3; each timed beside its bound at that shape, the
           host's time to submit a call, the card's own time and the
           stream operations one call makes (under the profiler; K1 and K3
           must make one, K2 one on one tile) and the
           launch floor (the library's empty kernel through the same
           ctypes path, timed the same way); and one per-chunk exchange
           call under the profiler, whose copies are counted; then
           ``ctrl_step`` from the state the W3 armed path held at its
           ``CTRL_PICK``-th call (k 1 and 16, bit for bit), timed there at k
           1 and 16 by CUDA events beside its submit time, its plain version
           (on the host), the bound (the larger of its throughput bound and
           its critical path: the dependent float64 operations the state
           needs, counted by ``ctrl_chain``, at the card's add latency
           measured by a one-thread chain, plus the launch floor) and the
           launch floor;
6. model kernels  (run after phase 3) K4 ``segment_matmul`` (bf16 and
           float32; odd shapes and OLMoE-1B-7B's expert products at C = 4,
           1780 and 2048; dense and with ``rows`` all 0, all C and ragged
           with NaN in x past them; each call on the kernel its shape calls
           for) and K5 ``flash_attention`` (bf16 on its wgmma kernel,
           float32 at one length on its fma kernel; causal and full; 1 and
           3 query heads per KV head; S in {1, 63, 512, 4096}; each also
           from ``[B, S, H, hd]`` views, which must give the same bits)
           against their plain versions within bounds
           stated in ``check_segment_matmul`` and ``check_flash``; and K6
           ``rwkv_scan`` (hd in {16, 32, 64}, T in {1, 63, 445, 4096}, with
           and without state0, float32 and the model's bf16 r, k, v; views
           in the model's layout and odd hd at one length, all bf16 too)
           within the bound stated in ``check_rwkv``, timed at the serve's
           shape with the host's submit time, the card's own time, the
           stream operations of a call (one) and the launch floor;
7. serve   OLMoE-1B-7B at full width (16 layers, ~6.9e9 float32 weights
           from seed 0, bf16 compute) behind ``ServeEngine`` on the card:
           batch 4, 8 requests with prompts of 64-512 tokens, 16 new tokens
           each, every kernel's count set to 0 just before and read just
           after; K4 must have launched 3 times a layer a model call, the
           prefills' on its tiles kernel and the decode steps' on its stream
           kernel, K5 once a layer a prefill, every call on its wgmma
           kernel, every token must lie in the vocabulary and every logit
           be finite.  Prefill seconds, ms per
           decode step and tokens/s, beside the ``nvidia-smi`` line.  Then
           K4 and K5 are replayed against their plain versions on the
           serve's own inputs (the first call at each shape; K4 with the
           serve's rows and dense) and timed beside the plain version,
           ``torch.bmm`` / ``scaled_dot_product_attention`` and the bound
           (K4's live bound with rows, and the dense one); K5 also at
           OLMoE's 4096-token context;
8. slice   OLMoE-1B-7B at full width and 2 layers with the same weights on
           the card (K4, K5) and on the host (their plain versions): a
           2 x 64 prefill and 4 teacher-forced decode steps: at the
           tokens whose experts stayed on both sides, logits within
           ``SLICE_TOL`` and greedy tokens equal wherever the top-2 margin
           exceeds it; at most ``SLICE_MOVED`` tokens with moved experts,
           their logits within ``SLICE_CAP``;
9. rwkv    RWKV6-1.6B at full width (24 layers, ~1.48e9 float32 weights
           from seed 0, bf16 compute) behind ``ServeEngine`` with the serve's
           constants, every kernel's count set to 0 just before and read
           just after: K6 must launch once a layer a model call, every token
           lie in the vocabulary and every logit be finite; K6 replayed
           against its plain version on the serve's own prefill and decode
           inputs (bf16 r, k, v, float32 w), timed beside the plain version
           and the bound, with the host's and the card's side of a call as
           in phase 6; then the slice
           check at 2 layers, card (K6) against host (its plain version),
           every position of a 2 x 64 prompt and 4 teacher-forced decode
           steps within ``RWKV_SLICE_TOL``, greedy tokens equal wherever
           the card's top-2 margin exceeds it;
10. report one JSON line of kernels (K1-K6 and ctrl_step), the card line, and the
           ``{"ok": ...}`` line last.

Without a card, or run from a directory that holds only this file, it exits
non-zero and prints no result.  It imports nothing of JAX.

    python3 chip_smoke.py --readings   # not part of the smoke

builds the kernels and prints the readings behind ``SLICE_TOL`` and
``RWKV_SLICE_TOL`` (each slice check at three seeds, sound and with planted
kernel faults, the RWKV6 one sound at seven more) and one decode step of
each full-width serve taken apart (the kernels' calls, the weight casts,
the device's busy share under the profiler; the RWKV6 step also with the
layout copies K6 does without and with ``F.silu`` for the gate's silu).

    python3 chip_smoke.py --armed      # not part of the smoke

times W3 at SF1 resident, with the in-dispatch controller armed, armed by
windows of 16 ticks and on the host plane by the same windows: each wall
with its host seconds, ``ctrl step`` and ``ctrl drain`` apart.  A copy of
this file in another tree's root times that tree's package the same way.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
#: cores (the partition kernels' compares, K4's float32 path, K5's fma
#: kernel but for its bf16 Q K^T) and dense bf16 tensor-core rate (K4's
#: bf16 path, K5's wgmma kernel and the fma kernel's bf16 Q K^T).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
#: The same data sheet's float64 rate outside the tensor cores (the
#: controller step's arithmetic).
FP64_OPS_PER_S = 34e12

#: The real exchange shape of the kernel phase.
REAL_N, REAL_K, REAL_W = 2**24, 65_536, 64
#: Share of dead lanes in K2's real-shape mask.
REAL_DEAD = 0.1
#: Workflow sizes of the main path: W1 at twice the datasets' CI scale
#: (144,592 tweets), W2 at its default 60k sales, W3 at TPC-H SF1's 1.5M
#: orders.
W1_SCALE, W2_TUPLES, W3_TUPLES = 2.0, 60_000, 1_500_000
#: The spill paths' device budget: W3's sort holds every order in its row
#: store, so 375,000 cells are a quarter of it at SF1 (the JAX suite's
#: ratio, 40,000 orders against 10,000 cells).
W3_BUDGET = 375_000
#: W1's budget on its chunked-probe path: far past what its edges hold, so
#: nothing spills and only the probe's emit ceiling bites.
W1_BUDGET = 1 << 26
#: The chaos path's cut interval and retention, and its plan: each of the
#: nine fault kinds once, a hundred ticks past a cut (a rollback replays
#: little), spread over W3's ~18,000 ticks; the dispatch fault heals by
#: two retries in place, the budget shrink hits the sort (target 0 of the
#: runtimes [sort, sink]), the spill corruption comes long after the
#: sort's first row eviction.
CHAOS_EVERY, CHAOS_RETENTION = 1000, 4
CHAOS_PLAN = (("worker-loss", 1100, 0, 0, 1), ("dispatch-fail", 3100, 0, 0, 2),
              ("straggler", 4100, 5, 0, 1), ("corrupt-cut", 6100, 0, 0, 1),
              ("missing-cut", 7100, 0, 0, 1), ("ctrl-drop", 9100, 3, 0, 1),
              ("ctrl-delay", 10100, 3, 0, 1),
              ("mem-pressure", 12100, 4, 0, 1),
              ("spill-corrupt", 13100, 0, 0, 1))

SOURCE = "src/repro_torch/kernels/csrc/partition.cu"

#: The in-dispatch controller's step: its source, the JAX function it
#: replaces (jitted XLA, no Pallas kernel), the (W, K) of its kernel checks
#: (W3's 20 workers and 40 ranges, W1's 48 and 56 keys, and 64 workers:
#: two a lane of the kernel's warp), the shares of the workers mitigating
#: in their states (one in 4, one in 2: every worker busy, as in W3's
#: state mid-run), the (W, K, window) of its wide checks (phi past the
#: launch's parameter block; the rings past shared memory as well), their
#: window widths, the call of the W3 path whose state the replay takes
#: (mid-run), and the window width of the armed path driven by fixed
#: windows.
CTRL_SOURCE = "src/repro_torch/kernels/csrc/ctrl_step.cu"
CTRL_REPLACES = "src/repro/dataflow/device.py:829"
CTRL_SHAPES, CTRL_SHARES, CTRL_WIDE = ((20, 40), (48, 56), (64, 128)), \
    (4, 2), ((150, 60, 64), (200, 70, 160))
CTRL_KS, CTRL_PICK, ARMED_K = (1, 16), 9000, 16

#: The serve: OLMoE-1B-7B at full width, batch 4, 8 requests with prompts
#: of 64-512 tokens drawn from seed 0, 16 new tokens each.
SERVE_BATCH, SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW = 4, 8, (64, 512), 16
#: The slice check: a SLICE_B x SLICE_S prompt and SLICE_STEPS decode
#: steps after it.  Both sides round every matmul output to bf16 after
#: float32 sums in other orders, and a rounding that lands on the other
#: side of a near-tie of router logits moves a token's experts.  So: the
#: largest |logit difference| allowed at a token whose experts stayed in
#: every layer (SLICE_TOL), how many tokens may have moved experts
#: (SLICE_MOVED) and the largest difference allowed at those (SLICE_CAP).
#: Each is set from ``python3 chip_smoke.py --readings`` (``PERF.md``),
#: near the geometric mean of what sound runs at three seeds reached and
#: what the nearest planted kernel fault gave (H100): stayed tokens 0.148
#: against 0.258 (K4 dropping the last of D's terms), 11 moved tokens
#: against 18 (the same fault; K5's faults move 134-136 of 136), moved
#: tokens 0.646 against 4.05 (K5's q scaled twice).
SLICE_B, SLICE_S, SLICE_STEPS = 2, 64, 4
SLICE_TOL, SLICE_MOVED, SLICE_CAP = 0.2, 14, 1.6
#: The RWKV6 slice check (same prompt and steps, no experts to move): the
#: largest |logit difference| allowed at any token, set from
#: ``python3 chip_smoke.py --readings`` like SLICE_TOL (H100): sound runs
#: reached 0.0547 at seeds 0-2 and 0.0625 over seeds 0-9; K6 decaying after
#: the add gave 0.0664-0.0703, inside that reach (the kernel phase's bound
#: catches it), and the nearest fault beyond it, K6 dropping the last of
#: hd's terms, 1.37; their geometric mean is 0.29.
RWKV_SLICE_TOL = 0.29


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


#: Weights whose float32 row-CDF rounds above 1 before the last positive
#: column: [.., 0.9544028, 1.0000001, 1.0].
ROUNDS_ABOVE_ONE = (2.9226431534880243e-01, 9.3378590947111456e-03,
                    1.3774107888430048e-01, 1.0934441588710811e-01,
                    4.0571506790850898e-01, 4.5597261426568905e-02, 1.45e-09)


def counters_for(u_ints):
    """int32 counters whose Weyl threshold is exactly ``u_ints * 2^-24``:
    the threshold's bits are ``(c + 1) * GOLDEN mod 2^32`` and GOLDEN is
    odd, so ``c = (u << 8) * GOLDEN^-1 - 1 mod 2^32``."""
    import numpy as np
    inv = np.uint64(pow(2654435769, -1, 2**32))
    bits = np.asarray(u_ints, dtype=np.uint64) << np.uint64(8)
    return ((bits * inv - np.uint64(1)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32).view(np.int32)


def adversarial_inputs(torch, seed: int, n: int, num_workers: int):
    """Keys, counters and a row-CDF of every kind of row a routing table
    can hold (non-negative weights): the row above (alone and with zero
    columns between its weights), a tiny last weight, zero columns between
    and after live ones, all-zero rows, one live column, dense rows.  Each
    record's threshold sits on the 2^-24 grid beside an entry of its key's
    row (one step below, on, above), or at 0 or 1 - 2^-24."""
    import numpy as np
    from repro_torch.core.ops import saturated_cdf32

    rng = np.random.default_rng(seed)
    W = num_workers
    rows = [np.zeros(W)] + [np.eye(W)[c] for c in sorted({0, W // 2, W - 1})]
    if W >= 7:
        for spread in (1, 2, W // 7):
            row = np.zeros(W)
            row[np.arange(7) * spread] = ROUNDS_ABOVE_ONE
            rows.append(row)
    for _ in range(8):
        row = np.zeros(W)
        live = rng.choice(W, size=min(W, 3), replace=False)
        row[live] = rng.dirichlet(np.ones(live.size))
        tiny = rng.dirichlet(np.ones(W)) * (1 - 1e-9)
        tiny[-1] = 1e-9
        rows += [row, rng.dirichlet(np.ones(W)), tiny]
    cdf = saturated_cdf32(torch.from_numpy(np.array(rows)))
    keys = rng.integers(0, len(rows), n)
    entry = cdf.numpy().astype(np.float64)[keys, rng.integers(0, W, n)]
    u_ints = np.clip(np.floor(entry * 2**24) + rng.integers(-1, 2, n), 0,
                     2**24 - 1)
    u_ints[::5] = 0
    u_ints[1::5] = 2**24 - 1
    return (torch.from_numpy(keys.astype(np.int32)).cuda(),
            torch.from_numpy(counters_for(u_ints.astype(np.int64))).cuda(),
            cdf.cuda())


def widen(torch, seed: int, args, form: str):
    """K2's inputs in the resident plane's wide form: int64 keys that wrap
    to the same int32 (most from outside int32's range), int64 counters
    likewise or none (``form == "no counters"``: all zero), float64 vals
    that round to the same float32 (between two float32 values, or on a
    tie, which goes to the even one)."""
    import numpy as np
    keys, counters, vals, valid, cdf = args
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n = keys.numel()
    turns = torch.randint(-2**30, 2**30, (n,), generator=g, device="cuda")
    keys64 = keys.long() + turns * 2**32
    ctr64 = (None if form == "no counters"
             else counters.long() + turns.flip(0) * 2**32)
    v = vals.double()
    ulp = torch.from_numpy(np.spacing(np.abs(vals.cpu().numpy())).astype(
        np.float64)).cuda()
    off = torch.rand(n, generator=g, device="cuda", dtype=torch.float64) - 0.5
    off[::3] = 0.5                                   # ties
    return keys64, ctr64, v + ulp * off, valid, cdf


def k2_record_bytes(args) -> int:
    """Bytes a lane of K2 moves at least: its keys, counters (none when
    None) and vals as given, the 1-byte mask, dest and rank."""
    keys, counters, vals, _, _ = args
    return (keys.element_size() + vals.element_size() + 1 + 8
            + (0 if counters is None else counters.element_size()))


def check_fold(torch, name: str, got, want, args) -> float:
    """K2's integer outputs bit for bit against the plain version, and both
    versions' fold_sums against a float64 sum of the same float32 values
    (wide columns narrowed as K2 narrows them).  Any order of c additions
    of float32 values is within c * 2^-24 * sum|v| of the exact sum (first
    order); the check allows twice that.  Returns the kernel's max
    |fold_sums - float64 sum|."""
    err = max_abs_err(got[:4], want[:4])
    check(err == 0, f"{name}: integer outputs disagree with the plain "
                    f"version: max |err| {err}")
    keys, _, vals, valid, cdf = args
    keys = keys.to(torch.int32)
    num_keys = cdf.shape[0]
    live = valid & (keys >= 0) & (keys < num_keys)
    slot = torch.where(live, keys.long(), 0)
    v64 = torch.where(live, vals.float().double(), 0.0)
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


def submit_ms(torch, fn, args, reps: int) -> float:
    """The host's time to submit one call (the same loop as ``time_ms``,
    host clock, no wait for the card): where it matches the CUDA-event
    time, the calls are host-paced."""
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    took = (time.perf_counter() - start) / reps * 1e3
    torch.cuda.synchronize()
    return took


#: CUDA runtime calls that put work on a stream.
STREAM_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpy",
                "cudaMemset")


def stream_ops(torch, fn, args):
    """One call under the profiler: (the CUDA runtime calls it made that
    put work on a stream, the device spans the profiler delivered for it),
    by name.  The runtime calls are recorded on the host as they are made;
    the device spans come from CUPTI's activity buffers, which the
    profiler does not deliver for every short profile (the list is then
    empty), so the count is taken from the runtime calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    events = prof.events()
    return ([e.name for e in events if e.name.startswith(STREAM_CALLS)],
            [e.name for e in events
             if str(getattr(e, "device_type", "")).endswith("CUDA")])


def device_ms(torch, fn, args, reps: int) -> str:
    """The card's own time for one call: the device spans of ``reps`` calls
    under the profiler, summed, over ``reps``, as "<ms> ms", or "not
    delivered" where the profiler delivered no span (``stream_ops``)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return f"{sum(spans) / reps / 1e3:.5f} ms" if spans else "not delivered"


def bound_ms(n: int, num_keys: int, num_workers: int, per_record_bytes: int,
             per_key_bytes: int = 0):
    """Least time on the card: bytes (inputs read once, outputs written
    once) over the memory rate vs N*W float32 compares over the fp32 rate."""
    nbytes = (per_record_bytes * n + 4 * num_keys * num_workers
              + 4 * num_workers + per_key_bytes * num_keys)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n * num_workers / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: Phase 3's odd shapes: both sides of a power of two, of K1's and K2's
#: one-tile limit (4096 records) and a chunk of 257 tiles; the main paths'
#: worker counts, one worker and the widest table.
ODD_NS = (1, 1023, 1025, 4095, 4096, 4097, 2**20 + 7)
ODD_WS = (1, 20, 48, 64, 1024)


def kernel_phase(torch, kpart, ref):
    """Bit-exact comparisons and timings; returns the per-kernel records."""
    errs = {"partition_scatter": 0, "partition": 0}
    pairs = (("partition_scatter", kpart.partition_scatter, ref.partition_scatter),
             ("partition", kpart.partition, ref.partition))
    seed = 0
    for n in ODD_NS:
        for num_workers in ODD_WS:
            for table in ("random", "adversarial"):
                seed += 1
                if table == "random":
                    args = make_inputs(torch, seed, n, 4096, num_workers, 0.3)
                else:
                    args = adversarial_inputs(torch, seed, n, num_workers)
                for name, kernel, plain in pairs:
                    err = max_abs_err(kernel(*args), plain(*args))
                    check(err == 0, f"{name} disagrees with its plain "
                                    f"version at N={n} W={num_workers} "
                                    f"({table} table): max |err| {err}")
                    errs[name] = max(errs[name], err)
    torch.cuda.synchronize()
    log(f"kernels: K1/K3 bit-identical to the plain versions at N in "
        f"{set(ODD_NS)} x W in {set(ODD_WS)} x random and adversarial "
        f"tables")

    k2 = "partition_scatter_fold"
    errs[k2] = 0.0
    for n in ODD_NS:
        for num_workers in ODD_WS:
            for mask in ("live", "suffix", "holes", "adversarial",
                         "int64", "no counters"):
                seed += 1
                args = fold_inputs(torch, seed, n, 4096, num_workers,
                                   mask if mask in ("live", "suffix")
                                   else "holes")
                if mask == "adversarial":
                    keys, counters, cdf = adversarial_inputs(
                        torch, seed, n, num_workers)
                    args = (keys, counters, args[2], args[3], cdf)
                elif mask in ("int64", "no counters"):
                    args = widen(torch, seed, args, mask)
                errs[k2] = max(errs[k2], check_fold(
                    torch, f"{k2} N={n} W={num_workers} mask={mask}",
                    kpart.partition_scatter_fold(*args),
                    ref.partition_scatter_fold(*args), args))
    torch.cuda.synchronize()
    log(f"kernels: {k2} integer outputs bit-identical to the plain version, "
        f"fold_sums within c * 2^-23 * sum|v| of float64, at N in "
        f"{set(ODD_NS)} x W in {set(ODD_WS)} x mask in {{live, suffix, "
        f"holes}}, holes on adversarial tables, and holes with int64 keys, "
        f"float64 vals and int64 or no counters")

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
        calls, spans = stream_ops(torch, kernel, args)
        check(len(calls) == 1, f"{name} at the real shape: {len(calls)} "
                               f"stream operations a call: {calls}")
        b_ms, b_by = bound_ms(REAL_N, REAL_K, REAL_W, per_record)
        log(f"kernels: {name} N={REAL_N} K={REAL_K} W={REAL_W}: {ms:.4f} ms "
            f"(plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"{100 * b_ms / ms:.1f}% of bound; library: none, no single "
            f"PyTorch call computes this function); {len(calls)} stream "
            f"operation(s) a call: {calls}, device spans {spans}")
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
    calls, spans = stream_ops(torch, kpart.partition_scatter_fold, args)
    # Compulsory bytes: keys, counters, vals (4 N each) and the 1-byte mask
    # in, dest and rank (4 N each) out, the cdf table, hist and both folds.
    b_ms, b_by = bound_ms(REAL_N, REAL_K, REAL_W, k2_record_bytes(args), 8)
    log(f"kernels: {k2} N={REAL_N} K={REAL_K} W={REAL_W} "
        f"({REAL_DEAD:.0%} dead lanes): {ms:.4f} ms (plain {plain_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms by {b_by}, {100 * b_ms / ms:.1f}% of "
        f"bound; library: none, no single PyTorch call computes this "
        f"function); {len(calls)} stream operation(s) a call: {calls}, "
        f"device spans {spans}")
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
    b_ms, b_by = bound_ms(192, 56, 48, 16)
    log(f"kernels: partition_scatter at the W1 chunk size N=192 K=56 W=48: "
        f"{small_ms:.5f} ms a call (CUDA events, 500 calls; bound "
        f"{b_ms:.6f} ms by {b_by})")
    return records, small_ms


# --------------------------------------------------------------------- #
# 3b. the in-dispatch controller's step                                  #
# --------------------------------------------------------------------- #
def ctrl_spec(tdev, W: int, K: int, window: int = 64):
    """The ``CtrlSpec`` of the default ``ReshapeConfig`` (W3's; its window
    is 64)."""
    from repro_torch.core import ReshapeConfig
    cfg = ReshapeConfig()
    return tdev.CtrlSpec(
        W=W, K=K, window=window, R=tdev.DeviceController.LOG_CAP,
        eta=cfg.eta, metric_period=cfg.metric_period,
        initial_delay=cfg.initial_delay_ticks, adaptive_tau=cfg.adaptive_tau,
        eps_lower=cfg.eps_lower, eps_upper=cfg.eps_upper,
        tau_increase=cfg.tau_increase,
        max_tau_adjustments=cfg.max_tau_adjustments,
        catchup_tolerance=cfg.catchup_tolerance,
        retire_window=window, enable_phase1=cfg.enable_phase1,
        horizon=2000.0)


def ctrl_state(torch, ref, seed: int, W: int, K: int, window: int = 64,
               share: int = 4):
    """A controller state with mitigations live in both phases (one worker
    in ``share`` skewed, each with its own helper), split and one-hot rows,
    rings of every fill, and random workloads and arrivals: (state as
    numpy arrays, arrived [K] int64, phi [W])."""
    import numpy as np
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, W, K)
    weights = np.zeros((K, W))
    weights[np.arange(K), owner] = 1.0
    split = rng.random(K) < 0.3
    other = (owner + 1 + rng.integers(0, W - 1, K)) % W
    frac = rng.random(K)
    weights[split, owner[split]] = 1.0 - frac[split]
    weights[split, other[split]] += frac[split]
    cdf, primary, is_split = ref.routing_consts(torch.from_numpy(weights))
    workers = rng.permutation(W)
    m = max(1, W // share)
    mit = np.zeros((5, W), np.int32)
    for seq, (s, h) in enumerate(zip(workers[:m], workers[m:2 * m])):
        phase = 2 + seq if seq < 2 else rng.integers(2, 4)   # both live
        mit[:, s] = (1, h, phase, rng.integers(0, 5), seq)
    state = dict(
        weights=weights, cdf=cdf.numpy(), primary=primary.numpy(),
        is_split=is_split.numpy(), owner=owner,
        obs=rng.uniform(0.0, 300.0, (W, window)),
        obs_n=rng.integers(0, window + 1, W),
        obs_pos=rng.integers(0, window, W), tau=np.float64(100.0),
        tau_adj=np.int32(rng.integers(0, 3)), mit_active=mit[0].astype(bool),
        mit_helper=mit[1], mit_phase=mit[2], mit_calm=mit[3],
        mit_seq=mit[4], seq_next=np.int32(m), epoch=np.int32(0),
        log_phi=np.zeros((64, W)), log_arr=np.zeros((64, W)),
        log_n=np.int32(rng.integers(0, 60)))
    return (state, rng.integers(0, 60, K).astype(np.int64),
            rng.integers(0, 400, W).astype(np.float64))


def bits(torch, t):
    """A tensor's bits as integers (float fields compare bit for bit)."""
    if t.dtype == torch.float64:
        return t.view(torch.int64)
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def ctrl_case(torch, kctrl, ref, tdev, what: str, spec, state, arrived, phi,
              t0: int, k: int, left: float) -> dict:
    """The kernel on the card against its plain version on the host, from
    the same state: every field bit for bit and ``arrived`` zeroed.
    Returns the state after the step (host tensors)."""
    import numpy as np
    host = tdev.ctrl_state_from_numpy(state, "cpu")
    card = tdev.ctrl_state_from_numpy(state, "cuda")
    arr_h = torch.from_numpy(np.array(arrived))
    arr_d = arr_h.cuda()
    ref.ctrl_step(spec, host, arr_h, phi, t0, k, left, 0.0)
    kctrl.ctrl_step(spec, card, arr_d, phi, t0, k, left, 0.0)
    torch.cuda.synchronize()
    check(not bool(arr_d.any()), f"ctrl_step {what}: arrived not zeroed")
    for name in kctrl.STATE_DTYPES:
        got = card[name].cpu()
        check(got.dtype == host[name].dtype and torch.equal(
            bits(torch, got), bits(torch, host[name])),
            f"ctrl_step {what}: {name} differs from the plain version")
    return host


def ctrl_kernel_phase(torch, kctrl, ref, tdev) -> int:
    """``ctrl_step`` against its plain version from random states with
    mitigations live in both phases: W 20 (W3's), 48 (W1's) and 64, a
    quarter and half of the workers mitigating, window 64, and the wide
    states of ``CTRL_WIDE``; k 1 and 16.  Returns the cases checked."""
    import numpy as np
    cases, moved = 0, 0
    shapes = [(W, K, 64, share, seed) for W, K in CTRL_SHAPES
              for share in CTRL_SHARES for seed in range(4)]
    shapes += [(W, K, window, 2, seed) for W, K, window in CTRL_WIDE
               for seed in range(2)]
    for W, K, window, share, seed in shapes:
        spec = ctrl_spec(tdev, W, K, window)
        state, arrived, phi = ctrl_state(torch, ref, 100 * W + seed, W, K,
                                         window, share)
        for k in CTRL_KS:
            after = ctrl_case(torch, kctrl, ref, tdev,
                              f"W={W} K={K} window {window} one in {share} "
                              f"mitigating k={k} seed {seed}", spec, state,
                              arrived, phi, 3 + seed, k,
                              float(5e4 * (seed + 1)))
            cases += 1
            moved += int(after["epoch"]) != 0
            moved += not np.array_equal(after["mit_phase"].numpy(),
                                        state["mit_phase"])
    check(moved > 0, "ctrl_step: no case rewrote the table or moved a "
                     "mitigation's phase")
    log(f"kernels: ctrl_step bit-identical to its plain version in every "
        f"state field at (W, K) in {CTRL_SHAPES} x one in {CTRL_SHARES} "
        f"workers mitigating x 4 random states, and (W, K, window) in "
        f"{CTRL_WIDE} (phi staged; at 200 x 160 the rings read in place) "
        f"x 2, each at k in {CTRL_KS}, mitigations live in both phases "
        f"({cases} cases; {moved} moved the epoch or a phase)")
    return cases


class CtrlRecorder:
    """Stands in for ``ctrl_step`` in its module and keeps a copy of the
    inputs of one call, the ``pick``-th, for the replay (a W3 state mid-run).
    The wrapper still counts its own launches."""

    def __init__(self, module, pick: int):
        self.module, self.pick = module, pick
        self.kernel = module.ctrl_step
        self.calls = 0
        self.kept = None

    @property
    def launches(self) -> int:
        return self.kernel.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.kernel.launches = n

    def __call__(self, spec, c, arrived, phi, t0, k, left, rate, block=None):
        self.calls += 1
        if self.calls == self.pick:
            self.kept = (spec, {n: t.cpu().numpy().copy() for n, t in c.items()},
                         arrived.cpu().numpy().copy(), phi.copy(), t0, k,
                         left)
        return self.kernel(spec, c, arrived, phi, t0, k, left, rate,
                           block=block)

    def __enter__(self):
        self.module.ctrl_step = self
        return self

    def __exit__(self, *exc):
        self.module.ctrl_step = self.kernel


def ctrl_times(torch, fn, spec, state, arrived, phi, t0, k, left, dev: str,
               reps: int):
    """(ms a call, host ms to submit it) from ``state`` restored before each
    call, the restore outside the timed span: CUDA events on the card, the
    host clock on the CPU.  On the card the calls pass one argument block
    built before the first, as ``DeviceController`` does."""
    import numpy as np
    from repro_torch.dataflow import device as tdev
    from repro_torch.kernels import ctrl_step as kctrl
    c = tdev.ctrl_state_from_numpy(state, dev)
    saved = {n: t.clone() for n, t in c.items()}
    arr = torch.from_numpy(np.array(arrived)).to(dev)
    arr0 = arr.clone()
    card = dev == "cuda"
    kw = dict(block=kctrl.ArgBlock(spec, c)) if card else {}
    spans, host = [], 0.0
    for i in range(reps + 3):
        for n, t in saved.items():
            c[n].copy_(t)
        arr.copy_(arr0)
        if card:
            torch.cuda.synchronize()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        h0 = time.perf_counter()
        fn(spec, c, arr, phi, t0, k, left, 0.0, **kw)
        took = time.perf_counter() - h0
        if card:
            ev[1].record()
        if i >= 3:
            host += took
            spans.append(ev if card else took)
    if card:
        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in spans) / reps
    else:
        ms = sum(spans) / reps * 1e3
    return ms, host / reps * 1e3


def ctrl_chain(torch, ref, tdev, spec, state, arrived, phi, t0: int, k: int,
               left: float) -> int:
    """The longest chain of dependent float64 operations one step needs on
    the kernel's layout, counted from a run of the plain version on this
    state (its ring statistics and sums over workers observed as they are
    taken): the tracker's total (W adds, a divide, a multiply); each
    predicted shares whose means changed (the longest lane's ring means,
    n adds and a divide each, the lanes abreast, then the W-add total and
    a divide); each stderr pair a divergence or the detection (with two
    free workers or more) reads (a stale mean, then the ssq chain of n
    adds and five tail operations, the two lanes abreast); six operations
    a phase-2 fraction.  A mean or stderr taken since the ring last changed
    counts nothing, as the kernel's memo keeps it; the mitigations and
    rounds add up, one after another."""
    import inspect
    import sys
    import numpy as np
    W = spec.W
    lines, first = inspect.getsourcelines(ref.ctrl_step)
    detect = first + next(i for i, line in enumerate(lines)
                          if "eps0 = max(stderr(s0), stderr(h0))" in line)
    memo, sd_memo = {}, {}
    st = dict(path=0, gen=0, shares=False, tracked=False, pair=[], means=[])

    def lanes(costs):       # the lanes run abreast; a lane's workers not
        per = {}
        for w, cost in costs:
            per[w % 32] = per.get(w % 32, 0) + cost
        return max(per.values(), default=0)

    def mean_cost(w, n):
        if memo.get(w) == (st["gen"], n):
            return 0
        memo[w] = (st["gen"], n)
        st["shares"] = False
        return n + 1 if n > 0 else 0

    def sd_cost(w, n):
        cost = mean_cost(w, n)
        if sd_memo.get(w) != (st["gen"], n):
            sd_memo[w] = (st["gen"], n)
            cost += n + 5 if n >= 2 else 0
        return cost

    real_rms, real_sum = ref.ring_mean_stderr, ref.seq_sum_vec

    def rms(row, n, pos):
        caller = sys._getframe(1)
        if caller.f_code.co_name != "stderr":
            st["means"].append(int(n))          # shares(), w in order
        else:
            outer = sys._getframe(2)
            if outer.f_lineno != detect or outer.f_locals["nfree"] >= 2:
                st["pair"].append((caller.f_locals["w"], int(n)))
                if len(st["pair"]) == 2:
                    st["path"] += lanes([(w, sd_cost(w, m))
                                         for w, m in st["pair"]])
                    st["pair"] = []
        return real_rms(row, n, pos)

    def seq_sum(v):
        caller = sys._getframe(1)
        if caller.f_code.co_name == "shares":
            costs = [(w, mean_cost(w, n)) for w, n in enumerate(st["means"])]
            st["means"] = []
            if not st["shares"]:
                st["path"] += lanes(costs) + W + 1
                st["shares"] = True
            if sys._getframe(2).f_code.co_name == "phase2":
                st["path"] += 6
        elif not st["tracked"]:    # the tracker runs in the first round only
            st["tracked"] = True
            st["path"] += W
            if sum(ref._floats(v)) > 0:
                st["path"] += 2
                st["gen"] += 1
        return real_sum(v)

    c = tdev.ctrl_state_from_numpy(state, "cpu")
    ref.ring_mean_stderr, ref.seq_sum_vec = rms, seq_sum
    try:
        ref.ctrl_step(spec, c, torch.from_numpy(np.array(arrived)), phi, t0,
                      k, left, 0.0)
    finally:
        ref.ring_mean_stderr, ref.seq_sum_vec = real_rms, real_sum
    return st["path"]


def ctrl_bound(spec, state, k: int, chain: int, add_ms: float,
               floor_ms: float):
    """The least time of one step on these inputs, the larger of two:
    throughput (the bytes it must move, the state it reads once and what
    it writes once: the rings, the small arrays, one log row, ``arrived``;
    the weights and the consts only where the epoch moved, over the memory
    rate, against the float64 operations its rounds need at least, each
    round's predicted shares: one add a valid observation and a divide a
    worker, over the float64 rate) and the critical path (``chain``
    dependent float64 operations, each at the card's add latency
    ``add_ms``, a divide or square root taking longer, plus the launch
    floor).  Returns (ms, "bytes" or "operations", which binds, the three
    times)."""
    import numpy as np
    W, K = spec.W, spec.K
    rounds = sum(1 for t in range(state["t0"], state["t0"] + k)
                 if t >= spec.initial_delay
                 and (t - spec.initial_delay) % spec.metric_period == 0)
    small = 4 * 7 * W + 4 * 5 + 8
    read = (8 * W * spec.window + small + 8 * K * 2 + 8 * W)
    write = (8 * W + small + 2 * 8 * W + 8 * K)
    if state["moved"]:
        read += 8 * K * W
        write += 8 * K * W + 4 * K * W + 9 * K
    ops = rounds * (int(np.sum(state["obs_n"])) + W)
    t = dict(bytes=(read + write) / HBM_BYTES_PER_S * 1e3,
             operations=ops / FP64_OPS_PER_S * 1e3,
             chain=chain * add_ms + floor_ms)
    binds = max(t, key=t.get)
    return (t[binds], "bytes" if binds == "bytes" else "operations", binds,
            t)


def ctrl_replay(torch, kctrl, ref, tdev, kpart, kept) -> dict:
    """``ctrl_step`` on the state the W3 path held mid-run (k 1 and 16),
    against its plain version, then timed at that state at k 1 and 16: the
    kernel's time a call (CUDA events, phi in the launch's parameters),
    the host's time to submit it (the argument block built once), the
    plain version's time (on the host, where it runs), the restated bound
    (the card's float64 add latency measured by a one-thread chain) and
    the launch floor.  Returns the kernel's record (k 1)."""
    check(kept is not None, "ctrl_step: no W3 state was recorded mid-run")
    spec, state, arrived, phi, t0, _, left = kept
    after = {kk: ctrl_case(torch, kctrl, ref, tdev,
                           f"on W3's state at tick {t0} k={kk}", spec, state,
                           arrived, phi, t0, kk, left) for kk in CTRL_KS}
    live = state["mit_active"]
    phases = sorted({int(p) for p in state["mit_phase"][live]})
    dev = torch.device("cuda", 0)
    floor_ms = time_ms(torch, kpart.launch_floor, (dev,), 200)
    add_ms = kctrl.dadd_latency_ms(dev)
    log(f"replay: the card's float64 add latency {add_ms * 1e6:.3f} ns (a "
        f"one-thread chain of 2^20 and 2^21 dependent adds, CUDA events, "
        f"the difference); launch floor {floor_ms:.5f} ms (the partition "
        f"library's empty kernel through its ctypes path)")
    out = {}
    for kk in CTRL_KS:
        ms, submit = ctrl_times(torch, kctrl.ctrl_step, spec, state, arrived,
                                phi, t0, kk, left, "cuda", 200)
        plain_ms, _ = ctrl_times(torch, ref.ctrl_step, spec, state, arrived,
                                 phi, t0, kk, left, "cpu",
                                 200 if kk == 1 else 50)
        moved = int(after[kk]["epoch"]) != int(state["epoch"])
        chain = ctrl_chain(torch, ref, tdev, spec, state, arrived, phi, t0,
                           kk, left)
        b_ms, b_by, binds, t = ctrl_bound(spec, dict(state, t0=t0,
                                                     moved=moved),
                                          kk, chain, add_ms, floor_ms)
        out[kk] = (ms, plain_ms, b_ms, b_by)
        log(f"replay: ctrl_step on W3's state at tick {t0} k={kk} (W="
            f"{spec.W} K={spec.K}, {int(live.sum())} mitigations live in "
            f"phases {phases}, observation log at {int(state['log_n'])}): "
            f"bit-identical; {ms:.5f} ms a call (CUDA events over 200 "
            f"calls, the state restored outside the timed span), submitted "
            f"by the host in {submit:.5f} ms (the argument block built "
            f"once); plain version {plain_ms:.5f} ms on the host (Python "
            f"floats); bound {b_ms:.7f} ms by {b_by}, binding: {binds} "
            f"(throughput: bytes {t['bytes']:.7f} ms, float64 operations "
            f"{t['operations']:.7f} ms; critical path: {chain} dependent "
            f"float64 operations x {add_ms * 1e6:.3f} ns + the launch "
            f"floor = {t['chain']:.5f} ms); library: none, no PyTorch call "
            f"computes this function")
    ms, plain_ms, b_ms, b_by = out[1]
    return dict(name="ctrl_step", route="cuda", source=CTRL_SOURCE,
                replaces=CTRL_REPLACES, launches=0, max_abs_err=0, ms=ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


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


#: Card paths of the main phase: (label, builder, kwargs, device_executor
#: (None = the builders' default, the per-chunk plane), tweak (see
#: ``path_tweak``)).
PATHS = (
    ("W3 resident", "build_w3", dict(n_tuples=W3_TUPLES), "jit", None),
    ("W3 resident spill", "build_w3",
     dict(n_tuples=W3_TUPLES, device_budget=W3_BUDGET), "jit", "spill"),
    ("W3 resident chaos", "build_w3",
     dict(n_tuples=W3_TUPLES, device_budget=W3_BUDGET), "jit", "chaos"),
    ("W3 resident armed", "build_w3", dict(n_tuples=W3_TUPLES), "jit",
     "armed"),
    ("W3 resident armed k16", "build_w3",
     dict(n_tuples=W3_TUPLES, batch_ticks=ARMED_K), "jit", "armed-k16"),
    ("W1 resident", "build_w1", dict(scale=W1_SCALE), "jit", None),
    ("W1 resident chunked-probe", "build_w1",
     dict(scale=W1_SCALE, device_budget=W1_BUDGET), "jit", "chunked"),
    ("W1 resident unfused", "build_w1", dict(scale=W1_SCALE), "jit",
     "unfused"),
    ("W1 resident-mixed", "build_w1", dict(scale=W1_SCALE), "jit", "mixed"),
    ("W4 resident", "build_w4", dict(), "jit", None),
    ("W1 per-chunk", "build_w1", dict(scale=W1_SCALE), None, None),
    ("W2 per-chunk", "build_w2", dict(n_tuples=W2_TUPLES), None, None),
    ("W3 per-chunk", "build_w3", dict(n_tuples=W3_TUPLES), None, None),
)
KERNELS = ("partition_scatter", "partition_scatter_fold", "partition")
#: Edge planes each card path must show, and the kernels it must (True) or
#: must not (False) launch; ``ctrl_step`` on the armed paths only.
ARMED = dict(partition_scatter=False, partition_scatter_fold=True,
             ctrl_step=True)
EXPECT = {
    "W3 resident armed": (["jit", "jit"], ARMED),
    "W3 resident armed k16": (["jit", "jit"], ARMED),
    "W3 resident": (["jit", "jit"], dict(partition_scatter=False,
                                         partition_scatter_fold=True)),
    "W3 resident spill": (["jit", "jit"],
                          dict(partition_scatter=False,
                               partition_scatter_fold=True)),
    "W3 resident chaos": (["jit", "jit"],
                          dict(partition_scatter=False,
                               partition_scatter_fold=True)),
    "W1 resident chunked-probe": (["jit", "jit", "jit"],
                                  dict(partition_scatter=False,
                                       partition_scatter_fold=True)),
    "W1 resident": (["jit", "jit", "jit"],
                    dict(partition_scatter=False,
                         partition_scatter_fold=True)),
    "W1 resident unfused": (["jit", "jit", "jit"],
                            dict(partition_scatter=False,
                                 partition_scatter_fold=True)),
    # The filter's device chunks cross to the demoted probe edge: compacted
    # on the host (``Edge.send``), then K1.
    "W1 resident-mixed": (["jit", "demoted(probe fanout)", "jit"],
                          dict(partition_scatter=True,
                               partition_scatter_fold=True)),
    "W4 resident": (["jit", "jit"], dict(partition_scatter=False,
                                         partition_scatter_fold=True)),
}
PER_CHUNK = dict(partition_scatter=True, partition_scatter_fold=False)
#: The demotions (their causes, in order) a card path must record; any
#: other path must record none.
DEMOTIONS = {"W1 resident-mixed": ["probe fanout"]}


@contextlib.contextmanager
def path_tweak(tweak):
    """The one setting a card path runs under: ``"unfused"`` builds its
    engine with ``REPRO_DEVICE_CHAIN=0`` (every edge its own dispatch and
    placement, for the cost of fusion on the same path); ``"mixed"`` sets
    the probe's emit ceiling ``MAX_EMIT_CELLS`` to 0, so the probe edge
    demotes (``probe fanout``) on its first tick and the filter's device
    chunks cross to a per-chunk edge; ``"spill"`` and ``"chaos"`` run under
    ``REPRO_SANITIZE=1`` (the mirror, spill and NaN checks at every
    boundary).  ``"chunked"`` lowers ``MAX_EMIT_CELLS`` once the workflow
    is built (``run_workflow``); it is put back here.  ``"armed"`` and
    ``"armed-k16"`` build under ``REPRO_DEVICE_CONTROLLER=1`` (the
    in-dispatch controller; the second is driven by fixed windows in
    ``run_workflow``)."""
    import os
    from repro_torch.dataflow import device

    names = ("REPRO_DEVICE_CHAIN", "REPRO_SANITIZE", "REPRO_DEVICE_CONTROLLER")
    env, cells = {n: os.environ.get(n) for n in names}, device.MAX_EMIT_CELLS
    if tweak == "unfused":
        os.environ["REPRO_DEVICE_CHAIN"] = "0"
    elif tweak == "mixed":
        device.MAX_EMIT_CELLS = 0
    elif tweak in ("spill", "chaos"):
        os.environ["REPRO_SANITIZE"] = "1"
    elif tweak in ("armed", "armed-k16"):
        os.environ["REPRO_DEVICE_CONTROLLER"] = "1"
    try:
        yield
    finally:
        device.MAX_EMIT_CELLS = cells
        for n, v in env.items():
            if v is None:
                os.environ.pop(n, None)
            else:
                os.environ[n] = v


class Recorder:
    """Stands in for a kernel's wrapper in its module and calls it, keeping
    the inputs of the first call at each key (by default the label of the
    path and the inputs' shapes and dtypes), for the replay against the
    plain version.  The wrapped function still counts its own launches."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.kernel = getattr(module, name)
        self.label = ""
        self.first = {}

    # The wrapper counts its launches on the name it has in its module,
    # which is this recorder while it stands in: forward the count.
    @property
    def launches(self) -> int:
        return self.kernel.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.kernel.launches = n

    def key(self, *args):
        return (self.label,) + tuple((tuple(a.shape), str(a.dtype))
                                     for a in args)

    def __call__(self, *args, **kw):
        key = self.key(*args)
        if key not in self.first:
            self.first[key] = (tuple(None if t is None else t.clone()
                                     for t in args), kw)
        return self.kernel(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.kernel)


class PathRecorder(Recorder):
    """A recorder that keeps the first call of each path."""

    def key(self, *args):
        return (self.label,)


class FoldRecorder(Recorder):
    """The recorder of K2 (``partition_scatter_fold``): keyed by (path, N,
    K, W), and it also keeps every sink call's (keys, vals, valid), for the
    bound on the sink's float sums."""

    def __init__(self, kpart):
        super().__init__(kpart, "partition_scatter_fold")
        self.sink_calls = []

    def key(self, keys, counters, vals, valid, cdf):
        return (self.label, keys.numel()) + tuple(cdf.shape)

    def __call__(self, keys, counters, vals, valid, cdf):
        if cdf.shape[1] == 1:
            self.sink_calls.append((keys, vals, valid))
        return super().__call__(keys, counters, vals, valid, cdf)

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


def chaos_plan(resilience):
    """The chaos path's ``FaultPlan`` (``CHAOS_PLAN``)."""
    return resilience.FaultPlan([
        resilience.FaultEvent(kind, tick, duration, target, count)
        for kind, tick, duration, target, count in CHAOS_PLAN])


def run_workflow(dataflow, factory: str, kw, backend: str, executor=None,
                 tweak=None):
    """Run one workflow with the Reshape controller; returns it, its wall
    time, the host-clock seconds and calls of the per-chunk exchange
    backend, of the resident runtime's per-edge dispatches, of its fused
    chain dispatches, of its check whether a dispatch fuses
    (``_chain_for_dispatch``, made every tick of a linked map stage), of
    its boundary materializations (``sync_host`` / ``sync_stats`` /
    ``sync_sink_counts``), of its spill tier (``_spill_refill``,
    ``_spill_admit`` with the evictions, ``_spill_demote_fresh``), of the
    in-dispatch controller (``ctrl step``: ``super_tick``, and ``ctrl
    drain``: ``drain``) and of the checkpoint coordinator's cuts and
    recoveries, and
    the routing-only share.  Times are exclusive: a timed call made inside another (the
    per-chunk exchange of a chunk a resident Filter emits, a boundary's
    flush dispatch, a cut's boundaries) counts for itself only.

    ``tweak`` ``"chunked"`` sets the probe's ``MAX_EMIT_CELLS`` to half its
    first emit block, ``W * B * M`` after ``install_build``, so a tick's
    pop runs as two sub-dispatches (``path_tweak`` puts it back);
    ``"chaos"`` drives the run by a ``ChaosRunner`` under ``CHAOS_PLAN``
    (kept in ``wf.meta["runner"]``); ``"armed-k16"`` and ``"k16"`` (its
    host run) by fixed windows of ``ARMED_K`` ticks."""
    from repro_torch.dataflow import device, resilience
    from repro_torch.dataflow.checkpoint import CheckpointCoordinator
    from repro_torch.dataflow.device import DeviceController, DeviceOpRuntime

    if executor is not None:
        kw = dict(kw, device_executor=executor)
    wf = getattr(dataflow, factory)(strategy="reshape", device="cuda",
                                    partition_backend=backend, **kw)
    if tweak == "chunked":
        probe = wf.monitored[0].device
        block = (probe.W * wf.engine.batch_ticks * probe.op.service_rate
                 * probe._host_fanout())
        device.MAX_EMIT_CELLS = block // 2
    drive = wf.run
    if tweak == "chaos":
        runner = resilience.ChaosRunner(
            wf.engine, chaos_plan(resilience), every_ticks=CHAOS_EVERY,
            retention=CHAOS_RETENTION)
        wf.meta["runner"] = runner
        drive = runner.run
    if tweak in ("armed-k16", "k16"):
        def drive():
            eng = wf.engine
            while not eng.done():
                eng.run_super_tick(ARMED_K)
    exchange = wf.engine.partition_backend
    spent = {"exchange": [0.0, 0], "dispatch": [0.0, 0], "fused": [0.0, 0],
             "chain check": [0.0, 0], "boundary": [0.0, 0],
             "spill": [0.0, 0], "ctrl step": [0.0, 0],
             "ctrl drain": [0.0, 0], "checkpoint": [0.0, 0]}
    stack = []          # [start, seconds of timed calls nested inside]

    def timed(fn, what):
        def wrapper(*args, **kw):
            stack.append([time.perf_counter(), 0.0])
            try:
                return fn(*args, **kw)
            finally:
                start, inner = stack.pop()
                took = time.perf_counter() - start
                spent[what][0] += took - inner
                spent[what][1] += 1
                if stack:
                    stack[-1][1] += took
        return wrapper

    exchange.partition_scatter = timed(exchange.partition_scatter, "exchange")
    methods = {(DeviceOpRuntime, m): what for m, what in (
        ("_dispatch", "dispatch"), ("_dispatch_chain", "fused"),
        ("_chain_for_dispatch", "chain check"), ("sync_host", "boundary"),
        ("sync_stats", "boundary"), ("sync_sink_counts", "boundary"),
        ("_spill_refill", "spill"), ("_spill_admit", "spill"),
        ("_spill_demote_fresh", "spill"))}
    methods[(DeviceController, "super_tick")] = "ctrl step"
    methods[(DeviceController, "drain")] = "ctrl drain"
    methods[(CheckpointCoordinator, "checkpoint")] = "checkpoint"
    methods[(CheckpointCoordinator, "recover")] = "checkpoint"
    saved = {(cls, m): getattr(cls, m) for cls, m in methods}
    for (cls, m), what in methods.items():
        setattr(cls, m, timed(saved[(cls, m)], what))
    try:
        t0 = time.perf_counter()
        drive()
        if backend == "torch":
            import torch
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        for (cls, m), fn in saved.items():
            setattr(cls, m, fn)
    # Routing-only entry point (K3): where the monitored edge's final table
    # sends the whole stream, i.e. the per-worker share after mitigation.
    _, share = wf.engine.partition_backend.partition(
        wf.edges[0].routing.copy(), wf.engine.sources[0].keys)
    return wf, wall, spent, share


def ground_truth_ok(factory, wf, datasets) -> bool:
    import numpy as np
    if factory == "build_w1":
        return np.array_equal(wf.sink.counts, datasets.tweet_counts(W1_SCALE))
    if factory == "build_w4":
        # Each probe record matches every build row of its key.
        n, nk = wf.engine.sources[0].keys.size, wf.meta["num_keys"]
        keys = datasets.synthetic_changing(n, nk, 3)[0]
        build = datasets.synthetic_small_table(nk)[0]
        return np.array_equal(wf.sink.counts,
                              np.bincount(keys, minlength=nk)
                              * np.bincount(build, minlength=nk))
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


def main_path(torch, kpart, kctrl):
    """Drive every card path (launch counts zeroed just before each and read
    just after), then hold each against one host numpy run of the same
    workflow (driven by the same windows).  Returns the launches per
    kernel, summed over the paths, the K2 inputs the recorder kept, the
    first K1 and K3 call of each path, by kernel, and the inputs of the W3
    armed path's ``CTRL_PICK``-th ``ctrl_step`` call."""
    import numpy as np
    from repro_torch import dataflow
    from repro_torch.dataflow import datasets

    kernels = {name: getattr(kpart, name) for name in KERNELS}
    kernels["ctrl_step"] = kctrl.ctrl_step
    cards = {}
    firsts = (PathRecorder(kpart, "partition_scatter"),
              PathRecorder(kpart, "partition"))
    ctrl_rec = CtrlRecorder(kctrl, CTRL_PICK)
    with FoldRecorder(kpart) as rec, firsts[0], firsts[1]:
        for label, factory, kw, executor, tweak in PATHS:
            for fn in kernels.values():
                fn.launches = 0
            for r in (rec,) + firsts:
                r.label = label
            with path_tweak(tweak), (ctrl_rec if label == "W3 resident armed"
                                     else contextlib.nullcontext()):
                run = run_workflow(dataflow, factory, kw, "torch", executor,
                                   tweak)
            torch.cuda.synchronize()
            counts = {name: fn.launches for name, fn in kernels.items()}
            absum = (rec.sink_abs_sums(torch, run[0].sink.counts.size)
                     if executor == "jit" else None)
            cards[label] = run + (counts, absum)
    launches = {name: sum(c[4][name] for c in cards.values())
                for name in kernels}
    for label in EXPECT:
        widths = {k[3] for k in rec.first if k[0] == label}
        check(1 in widths and max(widths) > 1,
              f"{label}: K2 was not called at both the ingest and the sink")

    hosts = {}
    for label, factory, kw, executor, tweak in PATHS:
        drive = "k16" if tweak == "armed-k16" else None
        key = (factory, tuple(sorted((k, v) for k, v in kw.items()
                                     if k != "device_budget")), drive)
        if key not in hosts:
            hosts[key] = run_workflow(dataflow, factory, kw, "numpy",
                                      tweak=drive)
        host, host_wall, host_spent, host_share = hosts[key]
        wf, wall, spent, share, counts, absum = cards[label]
        planes, must = EXPECT.get(label, ([None] * len(wf.engine.edges),
                                          PER_CHUNK))
        check([e.device_plane for e in wf.engine.edges] == planes,
              f"{label}: edge planes {[e.device_plane for e in wf.engine.edges]}"
              f", expected {planes}")
        demoted = [i.cause for i in wf.engine.incidents.query(kind="demotion")]
        check(demoted == DEMOTIONS.get(label, []),
              f"{label}: demotions {demoted}, expected "
              f"{DEMOTIONS.get(label, [])}")
        check(not wf.engine.incidents.query(kind="chain-fallback"),
              f"{label}: a fused chain fell back to per-edge dispatch")
        placed = [e.exchange.placements for e in wf.engine.edges]
        host_placed = [e.exchange.placements for e in host.engine.edges]
        if factory == "build_w1" and executor == "jit" and tweak is None:
            check(0 < placed[1] < host_placed[1],
                  f"{label}: the probe edge paid {placed[1]} placements "
                  f"(host plane {host_placed[1]}): fusion never engaged, "
                  f"or never let go")
        elif factory == "build_w1" and executor == "jit":
            check(placed[:2] == host_placed[:2] and spent["fused"][1] == 0,
                  f"{label}: placements {placed} (host plane {host_placed})"
                  f", {spent['fused'][1]} fused dispatches: an edge fused")
        for name, launched in dict(dict(ctrl_step=False), **must).items():
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
        extra = tweak_checks(label, tweak, wf, spent, host, counts)
        tuples = int(wf.engine.sources[0].keys.size)
        parts = "; ".join(
            f"{what} {sec:.3f} s in {calls} calls"
            + (f", {1e6 * sec / calls:.1f} us each" if calls else "")
            for what, (sec, calls) in spent.items())
        log(f"main: {label}: {tuples} tuples, {wf.engine.tick} ticks, "
            f"{len(events)} controller events, "
            f"{wf.edges[0].routing.version} rewrites of the monitored "
            f"edge, placements per edge {placed} (host plane "
            f"{host_placed}), {spent['fused'][1]} fused dispatches, launches "
            f"K1 {counts['partition_scatter']} / "
            f"K2 {counts['partition_scatter_fold']} / "
            f"K3 {counts['partition']} / ctrl_step {counts['ctrl_step']}: "
            f"{wf.engine.super_ticks} super-ticks; cuda {wall:.3f} s "
            f"({tuples / wall:.0f} tuples/s; {parts}), numpy host plane "
            f"{host_wall:.3f} s ({tuples / host_wall:.0f} tuples/s); "
            f"identical, {sums}{extra}")
    return (launches, rec.first, {r.name: r.first for r in firsts},
            ctrl_rec.kept)


def tweak_checks(label: str, tweak, wf, spent, host, counts) -> str:
    """The conditions of the spill, chunked-probe, chaos and armed paths;
    returns what their log line adds."""
    inc = wf.engine.incidents
    extra = ""
    if tweak in ("armed", "armed-k16"):
        import numpy as np
        rt = wf.monitored[0].device
        ctrl, hctrl = wf.controllers[0], host.controllers[0]
        rounds = hctrl.metric_messages() // hctrl.adapter.num_workers
        check(rt.ctrl is not None and rt.ctrl.reason == "END",
              f"{label}: the controller was not armed to the sort's END "
              f"({None if rt.ctrl is None else rt.ctrl.reason})")
        check(inc.count("ctrl-mismatch") == 0
              and inc.count("ctrl-demotion") == 0,
              f"{label}: {inc.count('ctrl-mismatch')} ctrl-mismatch and "
              f"{inc.count('ctrl-demotion')} ctrl-demotion incidents")
        check(ctrl.rounds_on_device == rounds and hctrl.rounds_on_device == 0,
              f"{label}: {ctrl.rounds_on_device} rounds on the card, the "
              f"host-stepped controller ran {rounds}")
        check(counts["ctrl_step"] == rt.ctrl.steps
              and (tweak != "armed" or rt.ctrl.steps == rounds),
              f"{label}: ctrl_step launched {counts['ctrl_step']} times for "
              f"{rt.ctrl.steps} steps and {rounds} rounds")
        check(ctrl.tau == hctrl.tau
              and ctrl.tau_adjustments == hctrl.tau_adjustments
              and {s: (m.phase, tuple(m.helpers), m.calm_rounds)
                   for s, m in ctrl.mitigations.items()}
              == {s: (m.phase, tuple(m.helpers), m.calm_rounds)
                  for s, m in hctrl.mitigations.items()},
              f"{label}: tau or mitigations differ from the host plane")
        for e1, e2 in zip(wf.engine.edges, host.engine.edges):
            e1.routing.sync_counters()
            e2.routing.sync_counters()
            check(np.array_equal(e1.routing.weights, e2.routing.weights)
                  and np.array_equal(e1.routing._count, e2.routing._count),
                  f"{label}: routing weights or counters differ")
        (step_s, steps), (drain_s, drains) = (spent["ctrl step"],
                                              spent["ctrl drain"])
        extra = (f"; controller: {ctrl.rounds_on_device} metric rounds on "
                 f"the card (the host plane's {rounds}), {rt.ctrl.steps} "
                 f"steps (one ctrl_step launch and one epoch readback "
                 f"each), {rt.ctrl.drains} drains (one readback of the "
                 f"log and the consts each), {ctrl.sync_readbacks} "
                 f"boundary readbacks accounted, ctrl step {step_s:.3f} s "
                 f"in {steps} calls, ctrl drain {drain_s:.3f} s in "
                 f"{drains} calls; tau {ctrl.tau}, "
                 f"{len(ctrl.mitigations)} mitigations at the end; no "
                 f"ctrl-mismatch, no ctrl-demotion")
    if tweak in ("spill", "chaos"):
        rt = wf.monitored[0].device
        sp = rt.spill
        ctrl = wf.controllers[0]
        check(inc.count("mem-pressure") >= 1,
              f"{label}: no mem-pressure incident: the spill tier never "
              f"engaged")
        check(sp is not None and sp.rows_spilled > 0,
              f"{label}: the sort spilled no rows")
        check(ctrl.pressure_consumed >= 1,
              f"{label}: the controller consumed no pressure event")
        extra = (f"; spill: {sp.rows_spilled} row evictions "
                 f"({int(rt.spilled_rows.sum())} rows spilled at the end), "
                 f"{sp.evictions} ring evictions, {sp.refills} refills, "
                 f"prefetch {sp.prefetch_hits} hits / {sp.prefetch_misses} "
                 f"misses, {inc.count('mem-pressure')} mem-pressure "
                 f"incidents, {ctrl.pressure_consumed} consumed")
    if tweak == "chunked":
        probe = wf.monitored[0].device
        check(inc.count("degraded-emit") == 1,
              f"{label}: {inc.count('degraded-emit')} degraded-emit "
              f"incidents, not one")
        extra = (f"; chunked emission at B <= {probe._b_limit} "
                 f"(MAX_EMIT_CELLS {probe.W} x {probe._b_limit} x M "
                 f"{probe.M}), {spent['dispatch'][1]} dispatches")
    if tweak == "chaos":
        from repro_torch.dataflow import resilience as rs
        runner = wf.meta["runner"]
        kinds = [k for k, *_ in CHAOS_PLAN]
        check(dict(runner.injected) == {k: 1 for k in kinds},
              f"{label}: injected {dict(runner.injected)}")
        healed = [k for k in kinds if k != rs.DISPATCH_FAIL]
        rollback = [k for k in healed if k != rs.MEM_PRESSURE]
        check(inc.count("chaos-recover") == len(healed)
              and inc.count("recovery") == len(rollback)
              and runner.recovered == len(healed),
              f"{label}: {inc.count('chaos-recover')} chaos-recover and "
              f"{inc.count('recovery')} recovery incidents for "
              f"{len(healed)} healed and {len(rollback)} rolled-back "
              f"faults")
        check(inc.count("retry") == 2,
              f"{label}: {inc.count('retry')} retries for the two "
              f"injected dispatch faults")
        corrupt = inc.query("fault", cause=rs.SPILL_CORRUPT)
        check(len(corrupt) == 1 and "no spill segments" not in
              corrupt[0].action,
              f"{label}: the spill corruption hit no segment "
              f"({[i.action for i in corrupt]})")
        coord = runner.coord
        extra += (f"; chaos: {sum(runner.injected.values())} faults "
                  f"({', '.join(i.cause + ': ' + i.action for i in inc.query('fault'))}), "
                  f"{coord.checkpoints_taken} cuts, "
                  f"{coord.recoveries} recoveries, {coord.replayed_ticks} "
                  f"replayed ticks, {coord.corrupt_detected} corrupt cut "
                  f"detected")
    return extra


def exchange_copies(torch):
    """One per-chunk exchange call (``TorchPartitionBackend``, W1's chunk:
    192 records, 48 workers, split keys) under the profiler, as
    ``stream_ops`` gives it."""
    import numpy as np
    from repro_torch.core.partitioner import RoutingTable
    from repro_torch.dataflow.exchange import TorchPartitionBackend

    rt = RoutingTable(56, 48)
    rt.split_key(0, [0, 1, 2], [0.5, 0.25, 0.25])
    rt.split_key(5, [7, 9], [0.5, 0.5])
    backend = TorchPartitionBackend("cuda")
    keys = np.random.default_rng(3).integers(0, 56, 192)
    for _ in range(3):
        backend.partition_scatter(rt, keys)
    return stream_ops(torch, backend.partition_scatter, (rt, keys))


def replay_phase(torch, kpart, ref, first, path_calls) -> float:
    """K1 and K3 on the first call of each path that launched them (bit for
    bit) and K2 on the inputs the resident paths gave it (the first call at
    each shape of each path), against their plain versions, timed beside
    the bound at those shapes, the host's time to submit a call, the
    stream operations of one call and the launch floor.  Returns K2's max
    |fold_sums - float64 sum|."""
    dev = torch.device("cuda", 0)
    floor_ms = time_ms(torch, kpart.launch_floor, (dev,), 200)
    floor_submit = submit_ms(torch, kpart.launch_floor, (dev,), 200)
    floor_dev = device_ms(torch, kpart.launch_floor, (dev,), 50)
    floor = (f"launch floor {floor_ms:.5f} ms, submitted in "
             f"{floor_submit:.5f} ms, device {floor_dev}")
    log(f"replay: {floor} (the partition library's empty kernel through "
        f"its ctypes path; CUDA events and host clock over 200 calls, the "
        f"profiler's device spans over 50)")
    calls, spans = exchange_copies(torch)
    copies = [c for c in calls if c.startswith("cudaMemcpy")]
    check(len(copies) == 3 and sum("DtoH" in s for s in spans) <= 1,
          f"a per-chunk exchange call made {len(copies)} copies (want "
          f"three: keys and counters up, K1's packed output down): "
          f"{calls}, device spans {spans}")
    log(f"replay: one per-chunk exchange call (N=192 K=56 W=48): "
        f"{len(calls)} stream operations, {len(copies)} copies (keys and "
        f"counters up, K1's output down in one): {calls}, device spans "
        f"{spans}")
    for name, per_record in (("partition_scatter", 16), ("partition", 12)):
        kernel, plain = getattr(kpart, name), getattr(ref, name)
        for (label,), (args, _) in path_calls[name].items():
            n, (num_keys, num_workers) = args[0].numel(), args[2].shape
            what = (f"{name} on {label}'s first call N={n} K={num_keys} "
                    f"W={num_workers}")
            err = max_abs_err(kernel(*args), plain(*args))
            check(err == 0, f"{what}: max |err| {err} against the plain "
                            f"version")
            ms = time_ms(torch, kernel, args, 200)
            submit = submit_ms(torch, kernel, args, 200)
            dev_time = device_ms(torch, kernel, args, 50)
            calls, spans = stream_ops(torch, kernel, args)
            plain_ms = time_ms(torch, plain, args, 20)
            b_ms, b_by = bound_ms(n, num_keys, num_workers, per_record)
            check(len(calls) == 1, f"{what}: {len(calls)} stream "
                                   f"operations a call: {calls}")
            log(f"replay: {what}: {ms:.5f} ms a call (plain {plain_ms:.5f} "
                f"ms, bound {b_ms:.6f} ms by {b_by}; CUDA events, 200 / 20 "
                f"calls); the host submits a call in {submit:.5f} ms, the "
                f"card runs it in {dev_time} (profiler, 50 calls); "
                f"{len(calls)} stream operation(s) a call {calls}, device "
                f"spans {spans}; {floor}; bit-identical")
    k2 = "partition_scatter_fold"
    err = 0.0
    for (label, n, num_keys, num_workers), (args, _) in first.items():
        what = f"{label} N={n} K={num_keys} W={num_workers}"
        err = max(err, check_fold(torch, f"{k2} on {what}",
                                  kpart.partition_scatter_fold(*args),
                                  ref.partition_scatter_fold(*args), args))
        small = n <= 1 << 16
        reps = 200 if small else 20
        ms = time_ms(torch, kpart.partition_scatter_fold, args, reps)
        submit = submit_ms(torch, kpart.partition_scatter_fold, args, reps)
        dev_time = device_ms(torch, kpart.partition_scatter_fold, args,
                           50 if small else 5)
        calls, spans = stream_ops(torch, kpart.partition_scatter_fold, args)
        if n <= kpart.TILE_RECORDS:
            check(len(calls) == 1, f"{k2} on {what}: {len(calls)} stream "
                                   f"operations a call: {calls}")
        plain_ms = time_ms(torch, ref.partition_scatter_fold, args,
                           50 if small else 5)
        b_ms, b_by = bound_ms(n, num_keys, num_workers,
                              k2_record_bytes(args), 8)
        columns = ", ".join(f"{c} {'none' if t is None else t.dtype}"
                            for c, t in zip(("keys", "counters", "vals"),
                                            args[:3]))
        log(f"replay: {k2} on {what} ({int(args[3].sum())} live lanes; "
            f"{columns}): {ms:.5f} ms a call (plain {plain_ms:.5f} ms, "
            f"bound {b_ms:.6f} ms by {b_by}; CUDA events, {reps} / "
            f"{50 if small else 5} calls); the host submits a call in "
            f"{submit:.5f} ms, the card runs it in {dev_time} (profiler); "
            f"{len(calls)} stream operation(s) a call "
            f"on the resident plane's own columns {calls}, device "
            f"spans {spans}; {floor}; integers bit-identical")
    return err


# --------------------------------------------------------------------- #
# 6. model kernels: K4 segment_matmul, K5 flash_attention                #
# --------------------------------------------------------------------- #
def check_segment_matmul(torch, what: str, got, x, w, rows=None) -> float:
    """K4 against its plain version (float32 sums of bf16 x bf16 products,
    which are exact, or of float32 products): each float32 sum of D terms,
    in any order, is within D * 2^-24 * sum|x w| of the exact one (first
    order), so the two versions within twice that; a bf16 output adds one
    rounding of each, within 2^-8 (bf16's unit roundoff) relative apiece,
    so 2^-7 of the larger for the two.  With ``rows``, every row past
    rows[e] must be exactly zero, whatever x holds there.  Returns
    max |got - plain|."""
    from repro_torch.kernels import ref
    want = ref.segment_matmul(x, w, rows)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    D = x.shape[2]
    absum = torch.bmm(x.float().abs(), w.float().abs())
    tol = 2 * D * 2.0**-24 * absum
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * torch.maximum(got.float().abs(),
                                            want.float().abs())
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < rows.long()[:, None])
        tol = torch.where(live[..., None], tol, 0.0)
    err = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(bool((err <= tol).all()),
          f"{what}: beyond the stated bound of the plain version (max |err| "
          f"{float(err.max()):.3g})")
    return float(err.max()) if err.numel() else 0.0


def check_flash(torch, what: str, got, q, k, v, causal: bool,
                scale: float) -> float:
    """K5 against its plain version: both are float32 arithmetic on the
    same inputs; l and acc are float32 sums of up to T terms, each within
    T * 2^-24 of its exact value relative to the sum of magnitudes, so the
    outputs lie within 2 * T * 2^-24 * max|v| of each other, plus 3e-5 for
    the exponentials (``tests/test_kernels.py``'s absolute tolerance).
    Returns max |got - plain|."""
    from repro_torch.kernels import ref
    want = ref.flash_attention(q, k, v, causal=causal, scale=scale)
    check(got.shape == want.shape and got.dtype == torch.float32,
          f"{what}: {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)}")
    T = k.shape[2]
    tol = 3e-5 + 2 * T * 2.0**-24 * float(v.float().abs().max())
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(err <= tol, f"{what}: max |err| {err:.3g} against the plain "
                      f"version, beyond {tol:.3g}")
    return err


def k4_bound(E: int, C: int, D: int, F: int, dtype_bytes: int, rows=None):
    """Least time: 2 E C D F operations at the bf16 tensor-core rate (the
    float32 CUDA-core rate for float32) vs x, w and out moved once.  With
    ``rows`` (E counts), the live bound: 2 sum(rows) D F operations, and
    the bytes of the live rows of x, the weights of the experts whose
    rows > 0 and all of out (its zeros too)."""
    live, used = E * C, E
    if rows is not None:
        counts = [min(max(int(r), 0), C) for r in rows]
        live, used = sum(counts), sum(1 for r in counts if r > 0)
    ops = 2.0 * live * D * F
    t_ops = ops / (BF16_TC_OPS_PER_S if dtype_bytes == 2
                   else FP32_OPS_PER_S) * 1e3
    t_bytes = (dtype_bytes * (live * D + used * D * F + E * C * F)
               / HBM_BYTES_PER_S * 1e3)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k5_bound(B: int, H: int, KV: int, S: int, T: int, hd: int, causal: bool,
             dtype_bytes: int):
    """Least time: the operations per visible (query, key) pair vs q, k, v
    read once and the float32 output written once.  bf16 at hd 128 (the
    wgmma route): 2 hd for Q K^T and 4 hd for P V (P is float32, split into
    bf16 hi and lo: two products), all at the bf16 tensor-core rate.  Other
    calls (the fma route): 2 hd for Q K^T, at the bf16 tensor-core rate for
    bf16 inputs (their products are exact in float32) and the float32
    CUDA-core rate for float32 ones, and 2 hd for P V at the float32
    rate."""
    pairs = S * (S + 1) // 2 if causal else S * T
    ops = 2.0 * hd * pairs * B * H
    if dtype_bytes == 2 and hd == 128:
        t_ops = 3 * ops / BF16_TC_OPS_PER_S * 1e3
    else:
        qk_rate = BF16_TC_OPS_PER_S if dtype_bytes == 2 else FP32_OPS_PER_S
        t_ops = (ops / qk_rate + ops / FP32_OPS_PER_S) * 1e3
    t_bytes = (dtype_bytes * hd * (B * H * S + 2 * B * KV * T)
               + 4 * B * H * S * hd) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(torch, seed: int, shape, dtype, scale: float = 1.0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def hgmma_counts(source: str):
    """HGMMA (wgmma) instructions in each kernel function of the library of
    ``csrc/<source>.cu``, from ``cuobjdump -sass`` beside nvcc:
    {mangled name: count}."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(_build.library_path(source))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def check_sass() -> None:
    """K4's tiles kernel, each width of its stream kernel and K5's wgmma
    kernel run wgmma."""
    for source, kernels in (("segment_matmul", ("seg_mm_tiles",
                                                "seg_mm_stream")),
                            ("flash_attention", ("flash_wgmma",))):
        counts = hgmma_counts(source)
        for kernel in kernels:
            found = {fn: n for fn, n in counts.items() if kernel in fn}
            check(found and all(n > 0 for n in found.values()),
                  f"build: {kernel} has no wgmma (HGMMA) in its SASS: "
                  f"{found}")
            for fn, n in found.items():
                log(f"build: {source}: {n} HGMMA (wgmma) instructions in "
                    f"{fn}")


def k4_rows_cases(torch, E: int, C: int, seed: int):
    """The ``rows`` K4 is held to at a shape: none (dense), all zero, all
    C, and ragged (drawn in [0, C] from ``seed``, the first expert at 0
    and the last at C)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    ragged = torch.randint(0, C + 1, (E,), generator=gen, device="cuda",
                           dtype=torch.int32)
    if E > 1:
        ragged[0], ragged[-1] = 0, C
    return [("dense", None),
            ("rows 0", torch.zeros(E, dtype=torch.int32, device="cuda")),
            ("rows C", torch.full((E,), C, dtype=torch.int32, device="cuda")),
            ("rows ragged", ragged)]


def k4_route(D: int, F: int, C: int, dtype_bytes: int) -> str:
    """The kernel ``csrc/segment_matmul.cu`` picks for contiguous fresh
    tensors (16-byte aligned)."""
    if dtype_bytes == 4:
        return "fma"
    if D % 8 or F % 8:
        return "wmma"
    return "tiles" if C >= 64 else "stream"


def k4_kernel_phase(torch, k4) -> float:
    """K4 against its plain version at odd shapes and at the serving
    shapes, dense and with rows, each call on the kernel its shape calls
    for.  Returns the largest error."""
    err, seed = 0.0, 0
    # Odd shapes (D and F no multiple of 8, of 64; C on each side of 64 and
    # each token width of the stream kernel), and OLMoE-1B-7B's expert
    # products (E = 64, D = 2048, F = 1024 and back) at a decode batch
    # (C = 4), the serve's longest prefill (4 x 445 = 1780 tokens) and
    # 4 x 512 tokens.  Each with every case of k4_rows_cases; the ragged
    # case has NaN in x past rows[e].
    shapes = [(1, 1, 1, 1), (3, 67, 33, 130), (2, 300, 1000, 96),
              (3, 12, 200, 72), (2, 40, 136, 200), (4, 24, 64, 64),
              (2, 130, 64, 64), (2, 100, 40, 200),
              (64, 4, 2048, 1024), (64, 4, 1024, 2048),
              (64, 1780, 2048, 1024), (64, 1780, 1024, 2048),
              (64, 2048, 2048, 1024), (64, 2048, 1024, 2048)]
    routes = dict.fromkeys(k4.ROUTES, 0)
    for E, C, D, F in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            seed += 1
            x = randn(torch, seed, (E, C, D), dtype, 0.5)
            w = randn(torch, seed + 1000, (E, D, F), dtype, D ** -0.5)
            want_route = k4_route(D, F, C, x.element_size())
            for case, rows in k4_rows_cases(torch, E, C, seed):
                xc = x
                if case == "rows ragged":
                    dead = (torch.arange(C, device="cuda")[None, :]
                            >= rows.long()[:, None])
                    xc = x.masked_fill(dead[..., None], float("nan"))
                what = (f"segment_matmul E={E} C={C} D={D} F={F} {dtype} "
                        f"{case}")
                before = dict(k4.routes)
                got = k4.segment_matmul(xc, w, rows)
                took = [r for r in k4.ROUTES if k4.routes[r] > before[r]]
                check(took == [want_route], f"{what}: ran {took}, not "
                                            f"{want_route}")
                routes[want_route] += 1
                err = max(err, check_segment_matmul(torch, what, got, xc, w,
                                                    rows))
                del xc, got
            del x, w
    torch.cuda.synchronize()
    log(f"model kernels: segment_matmul within the stated bound of its plain "
        f"version at {len(shapes)} shapes x {{bf16, float32}} x {{dense, "
        f"rows 0, rows C, rows ragged with NaN in x past them}} (max |err| "
        f"{err:.3g}; calls by kernel {routes})")
    return err


def k5_call(k5, what: str, route: str, q, k, v, **kw):
    """K5 on (q, k, v), required to launch the kernel of ``route``."""
    before = dict(k5.routes)
    got = k5.flash_attention(q, k, v, **kw)
    took = [r for r in k5.ROUTES if k5.routes[r] > before[r]]
    check(took == [route], f"{what}: ran {took}, not {route}")
    return got


def model_kernel_phase(torch, k4, k5):
    """K4 and K5 against their plain versions at odd shapes and at the
    serving shapes.  Returns the largest error of each."""
    errs = {"segment_matmul": k4_kernel_phase(torch, k4),
            "flash_attention": 0.0}
    seed = 14                    # K5's inputs as drawn before K4 had rows
    for S in (1, 63, 512, 4096):
        for H, KV in ((6, 6), (6, 2)):
            for causal in (True, False):
                for dtype in ((torch.bfloat16, torch.float32) if S == 512
                              else (torch.bfloat16,)):
                    seed += 1
                    q = randn(torch, seed, (2, H, S, 128), dtype)
                    k = randn(torch, seed + 1, (2, KV, S, 128), dtype)
                    v = randn(torch, seed + 2, (2, KV, S, 128), dtype)
                    what = (f"flash_attention S={S} rep={H // KV} "
                            f"causal={causal} {dtype}")
                    route = "wgmma" if dtype == torch.bfloat16 else "fma"
                    got = k5_call(k5, what, route, q, k, v, causal=causal)
                    errs["flash_attention"] = max(
                        errs["flash_attention"],
                        check_flash(torch, what, got, q, k, v, causal,
                                    128 ** -0.5))
                    # The same values in the model's [B, S, H, hd] layout,
                    # read through .transpose(1, 2): the same bits.
                    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
                             for t in (q, k, v)]
                    check(torch.equal(k5_call(k5, what, route, *views,
                                              causal=causal), got),
                          f"{what}: a [B, S, H, hd] view gives other bits "
                          f"than its contiguous copy")
    torch.cuda.synchronize()
    log("model kernels: flash_attention within the stated bound of its plain "
        "version at B=2 hd=128 S in {1, 63, 512, 4096} x rep in {1, 3} x "
        "{causal, full} (bf16 on the wgmma kernel; float32 too at S=512, on "
        "the fma kernel), the same bits from [B, S, H, hd] views (max |err| "
        f"{errs['flash_attention']:.3g})")
    return errs


def time_k4(torch, k4, x, w, reps: int, rows=None):
    """(kernel ms, plain ms, torch.bmm ms, bound ms, bound_by), each with
    ``rows`` where given (``torch.bmm`` is the dense product: the same
    function on inputs whose rows past ``rows`` are zero, as the serve's
    are); the bound is the live one with ``rows``."""
    from repro_torch.kernels import ref
    E, C, D = x.shape
    F = w.shape[2]
    ms = time_ms(torch, k4.segment_matmul, (x, w, rows), reps)
    plain_ms = time_ms(torch, ref.segment_matmul, (x, w, rows),
                       max(reps // 4, 3))
    lib_ms = time_ms(torch, torch.bmm, (x, w), reps)
    return (ms, plain_ms, lib_ms) + k4_bound(
        E, C, D, F, x.element_size(),
        None if rows is None else rows.tolist())


def time_k5(torch, k5, q, k, v, reps: int):
    """(kernel ms, plain ms, scaled_dot_product_attention ms, bound ms,
    bound_by), causal."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    ms = time_ms(torch, lambda *a: k5.flash_attention(*a, causal=True),
                 (q, k, v), reps)
    plain_ms = time_ms(torch, lambda *a: ref.flash_attention(*a, causal=True),
                       (q, k, v), max(reps // 4, 3))
    kw = dict(is_causal=True)
    if KV != H:
        kw["enable_gqa"] = True
    lib_ms = time_ms(torch, lambda *a: F.scaled_dot_product_attention(*a, **kw),
                     (q, k, v), reps)
    return (ms, plain_ms, lib_ms) + k5_bound(B, H, KV, S, T, hd, True,
                                             q.element_size())


# --------------------------------------------------------------------- #
# 6b. model kernel K6 rwkv_scan                                          #
# --------------------------------------------------------------------- #
def rwkv_envelope(torch, args):
    """The recurrence on magnitudes, for ``check_rwkv``: with A_t =
    |w_t| A_{t-1} + |k_t| |v_t|^T (A_0 = |state0|) and D_t = |w_t| D_{t-1}
    + A_t (D_0 = 0), returns O_t = |r_t| (A_{t-1} + |u| |k_t| |v_t|^T) and
    P_t = |r_t| D_{t-1} ([B, H, T, hd] each) and the final A and D."""
    r, k, v, w, u, s0 = (None if a is None else a.float().abs() for a in args)
    B, H, T, hd = r.shape
    A = (torch.zeros((B, H, hd, hd), device=r.device) if s0 is None
         else s0.clone())
    D = torch.zeros_like(A)
    O = torch.empty((B, H, T, hd), device=r.device)
    P = torch.empty_like(O)
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        O[:, :, t] = torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                                  A + u[..., None] * kv)
        P[:, :, t] = torch.einsum("bhk,bhkv->bhv", r[:, :, t], D)
        A = w[:, :, t, :, None] * A + kv
        D = w[:, :, t, :, None] * D + A
    return O, P, A, D


def check_rwkv(torch, what: str, got, args):
    """K6 against its plain version on ``args`` (r, k, v, w, u, state0).

    Both are float32 arithmetic on the same values (bf16 inputs are
    widened exactly, on both sides) in other orders: the kernel fuses
    multiply-adds, adds out_t's hd terms in row-group partial sums, and
    takes the bonus as one dot product, beta_t = sum_k r_k u_k k_k, whose
    product beta_t v_t[c] starts out_t[c]'s sum.  To first order, with eps
    = 2^-24: a step of the state rounds at most three times on values
    bounded by A_t (``rwkv_envelope``: the recurrence on |r|, |k|, |v|,
    |w|, |u|, |state0|), and the errors of the steps before decay with
    |w|, so either version's state is within 3 eps D_t of the exact one,
    D_t the decayed sum of the A_s; out_t reads the state before step t
    (error 3 eps P_t, P_t = |r_t| D_{t-1}) and adds hd products to it,
    within (hd + 3) eps O_t in the plain version.  The bonus stays inside
    the envelope: |beta_t v_t[c]| <= sum_k |r_k| |u_k| |k_k| |v_c|, the
    bonus half of O_t, and each of its terms rounds at most 1 + HDP / 16
    (its product and the dot product's chain, HDP = hd rounded up to 16,
    32 or 64) + 4 (the shuffle tree) + 1 (times v_t[c]) times before it
    starts out_t[c]'s sum, then 4 times in a thread's multiply-adds and
    log2(HDP / 4) in the tree over row groups, which a term of r_t S sees
    too: at most 18 roundings a term at hd 64, 15 at 32 and 13 at 16,
    within hd + 3 for hd >= 16 and within 19 for any hd.  So the kernel's
    out is within (max(hd, 16) + 3) eps O_t + 3 eps P_t of the exact one,
    the two versions' final states lie
    within 2 eps (3 D_T + A_T) of each other and their outputs within
    eps (6 P_t + (hd + 3 + max(hd, 16) + 3) O_t).  A bf16 out is each
    side's float32 out rounded once to nearest, so it may differ by one
    bf16 ulp more, taken at the larger of |out| and |want| (a rounding
    moves a value by at most half an ulp of its own binade).  Returns (the
    largest |kernel - plain| over out and state, the largest allowed |out|
    difference over the largest |out|)."""
    from repro_torch.kernels import ref
    out, state = got
    want, want_state = ref.rwkv_scan(*args)
    check(out.shape == want.shape and out.dtype == want.dtype
          and state.shape == want_state.shape
          and state.dtype == torch.float32,
          f"{what}: {tuple(out.shape)} {out.dtype}, state "
          f"{tuple(state.shape)} {state.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    check(bool(torch.isfinite(out).all() and torch.isfinite(state).all()),
          f"{what}: non-finite output")
    hd = args[0].shape[3]
    eps = 2.0**-24
    O, P, A, D = rwkv_envelope(torch, args)
    tol = eps * (6 * P + (hd + 3 + max(hd, 16) + 3) * O)
    out, want = out.float(), want.float()
    if args[0].dtype == torch.bfloat16:
        # bf16's ulp at |x|: 2^(e - 8) for x = m 2^e, 0.5 <= m < 1.
        big = torch.maximum(out.abs(), want.abs())
        _, e = torch.frexp(big)
        tol = tol + torch.where(big > 0, torch.ldexp(torch.ones_like(tol),
                                                     e - 8), 0.0)
    err = (out - want).abs()
    err_state = (state - want_state).abs()
    check(bool((err <= tol).all()),
          f"{what}: out beyond the stated bound of the plain version (max "
          f"|err| {float(err.max()):.3g})")
    check(bool((err_state <= 2 * eps * (3 * D + A)).all()),
          f"{what}: final state beyond the stated bound of the plain "
          f"version (max |err| {float(err_state.max()):.3g})")
    admitted = (float(tol.max() / want.abs().max().clamp(min=1e-30))
                if want.numel() else 0.0)
    return (max(float(err.max()) if err.numel() else 0.0,
                float(err_state.max()) if err_state.numel() else 0.0),
            admitted)


def k6_bound(B: int, H: int, T: int, hd: int, with_state: bool,
             in_bytes: int = 4, w_bytes: int = 4):
    """Least time: 4 hd^2 float32 operations per (b, h, t) at the float32
    CUDA-core rate (r_t S, a multiply-add per state entry, and the decayed
    update, one multiply-add per entry in a chunked form that rescales the
    state by the chunk's decay; the bonus r_t diag(u) k_t v_t^T is
    (sum_k r_k u_k k_k) v_t, O(hd)), vs r, k, v (``in_bytes`` a value) and
    w (``w_bytes``) read and out (r's width) written once, u, state0 (when
    given) read and the final state written, float32."""
    t_ops = 4.0 * hd * hd * B * H * T / FP32_OPS_PER_S * 1e3
    nbytes = ((4 * in_bytes + w_bytes) * B * H * T * hd + 4 * H * hd
              + 4 * (2 if with_state else 1) * B * H * hd * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_k6(torch, k6, args, reps: int):
    """(kernel ms, plain ms, bound ms, bound_by)."""
    from repro_torch.kernels import ref
    B, H, T, hd = args[0].shape
    ms = time_ms(torch, k6.rwkv_scan, args, reps)
    plain_ms = time_ms(torch, ref.rwkv_scan, args, max(reps // 10, 2))
    return (ms, plain_ms) + k6_bound(B, H, T, hd, args[5] is not None,
                                     args[0].element_size(),
                                     args[3].element_size())


def k6_host_side(torch, k6, args, reps: int) -> str:
    """What a K6 call costs beside its CUDA-event time: the host's time to
    submit one, the card's own time (profiler), the stream operations one
    call makes (which must be 1) and the launch floor, as text."""
    from repro_torch.kernels import partition as kpart
    dev = args[0].device
    submit = submit_ms(torch, k6.rwkv_scan, args, reps)
    card = device_ms(torch, k6.rwkv_scan, args, min(reps, 50))
    calls, spans = stream_ops(torch, k6.rwkv_scan, args)
    check(len(calls) == 1, f"rwkv_scan: {len(calls)} stream operations a "
                           f"call: {calls}")
    floor = time_ms(torch, kpart.launch_floor, (dev,), 200)
    floor_submit = submit_ms(torch, kpart.launch_floor, (dev,), 200)
    return (f"the host submits a call in {submit:.5f} ms, the card runs it "
            f"in {card} (profiler, {min(reps, 50)} calls); {len(calls)} "
            f"stream operation(s) a call {calls}, device spans {spans}; "
            f"launch floor {floor:.5f} ms, submitted in {floor_submit:.5f} "
            f"ms")


#: K6's input types: r, k, v and w float32; the model's bf16 r, k, v with
#: a float32 w; all four bf16.
K6_KINDS = ("float32", "bf16 r, k, v", "bf16")


def rwkv_inputs(torch, seed: int, B: int, H: int, T: int, hd: int,
                with_state: bool, views: bool = False,
                kind: str = "float32"):
    """r, k, v (normal * 0.5), w in (0.45, 0.95), u (normal * 0.1) and
    state0 (normal * 0.5, or None), as ``tests/test_kernels.py`` draws
    them, float32 or rounded to bf16 as ``kind`` (``K6_KINDS``) says; with
    ``views`` r, k, v and w are [B, H, T, hd] views of [B, T, H, hd]
    tensors, as the model passes them."""
    shape = (B, T, H, hd) if views else (B, H, T, hd)
    r, k, v = (randn(torch, seed + i, shape, torch.float32, 0.5)
               for i in range(3))
    w = torch.sigmoid(randn(torch, seed + 3, shape, torch.float32)) * 0.5 \
        + 0.45
    if kind != "float32":
        r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    if kind == "bf16":
        w = w.to(torch.bfloat16)
    if views:
        r, k, v, w = (x.transpose(1, 2) for x in (r, k, v, w))
    u = randn(torch, seed + 4, (H, hd), torch.float32, 0.1)
    s0 = (randn(torch, seed + 5, (B, H, hd, hd), torch.float32, 0.5)
          if with_state else None)
    return r, k, v, w, u, s0


def rwkv_kernel_phase(torch, k6) -> float:
    """K6 against its plain version: hd in {16, 32, 64} x T in {1, 63, 445,
    4096} x with and without state0 (3 x 48 heads: more blocks than SMs),
    float32 and the model's bf16 r, k, v (w float32); then inputs in the
    model's layout and odd head sizes at T = 63, all three kinds; timed at
    the serve's shape (B = SERVE_BATCH, H = 32, hd = 64) at T = 445 and
    4096, float32 and the model's bf16, with the host's and the card's
    side of a call.  Returns the largest error."""
    err, seed, admitted = 0.0, 500, {}
    for kind in K6_KINDS[:2]:
        for hd in (16, 32, 64):
            for T in (1, 63, 445, 4096):
                for with_state in (False, True):
                    seed += 10
                    args = rwkv_inputs(torch, seed, 3, 48, T, hd, with_state,
                                       kind=kind)
                    what = (f"rwkv_scan {kind} hd={hd} T={T} "
                            f"state0={with_state}")
                    e, adm = check_rwkv(torch, what, k6.rwkv_scan(*args),
                                        args)
                    key = (kind, T)
                    err = max(err, e)
                    admitted[key] = max(admitted.get(key, 0.0), adm)
                    del args
    for kind in K6_KINDS:
        for hd, views in ((64, True), (16, True), (5, False), (48, False)):
            seed += 10
            args = rwkv_inputs(torch, seed, 2, 7, 63, hd, True, views, kind)
            what = (f"rwkv_scan {kind} hd={hd} T=63 "
                    f"{'views' if views else 'contiguous'}")
            err = max(err, check_rwkv(torch, what, k6.rwkv_scan(*args),
                                      args)[0])
    torch.cuda.synchronize()
    log(f"model kernels: rwkv_scan within the stated bound of its plain "
        f"version at B=3 H=48 hd in {{16, 32, 64}} x T in {{1, 63, 445, "
        f"4096}} x state0 in {{no, yes}} x {{float32, bf16 r, k, v}}, and "
        f"at T=63 on views in the model's layout (hd 16, 64) and hd 5, 48 "
        f"for {set(K6_KINDS)} (max |err| {err:.3g}); the bound admits an "
        f"out difference of at most "
        + ", ".join(f"{a:.3g} ({kind}, T={T})"
                    for (kind, T), a in admitted.items())
        + " of the largest |out|")
    for kind in K6_KINDS[:2]:
        for T in (445, 4096):
            args = rwkv_inputs(torch, 900 + T, SERVE_BATCH, 32, T, 64, True,
                               views=True, kind=kind)
            reps = 20 if T < 1000 else 5
            t = time_k6(torch, k6, args, reps)
            log(f"model kernels: rwkv_scan B={SERVE_BATCH} H=32 T={T} hd=64 "
                f"{kind} with state0, the model's layout: {t[0]:.5f} ms "
                f"(plain {t[1]:.5f} ms, bound {t[2]:.5f} ms by {t[3]}, "
                f"{100 * t[2] / t[0]:.1f}% of bound; library: none, no "
                f"single PyTorch call computes this recurrence); "
                + k6_host_side(torch, k6, args, reps))
            del args
    torch.cuda.empty_cache()
    return err


# --------------------------------------------------------------------- #
# 7. serve: a model at full width (OLMoE-1B-7B; RWKV6-1.6B in phase 9)    #
# --------------------------------------------------------------------- #
def serve_phase(torch, kernel_mods, arch: str, recs):
    """Serve SERVE_REQUESTS requests through ``arch`` at full width (every
    layer, float32 weights from seed 0, bf16 compute) with ``ServeEngine``
    on the card, every kernel's count set to 0 just before and read just
    after, the recorders ``recs`` standing in for their kernels (each keeps
    the first call at each shape, labelled prefill or decode).  Returns
    (launches per kernel, a summary dict)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serve import Request, ServeEngine

    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    eng = ServeEngine(params, cfg, batch_size=SERVE_BATCH,
                      max_len=SERVE_NEW + 8, eos_id=-1, device="cuda")
    rng = np.random.default_rng(0)
    lengths = rng.integers(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1,
                           SERVE_REQUESTS)
    for i, n in enumerate(lengths):
        eng.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab, n).astype(
            np.int32), max_new_tokens=SERVE_NEW))
    spent = {"prefill": [0.0, 0], "decode": [0.0, 0]}

    def timed(fn, what):
        def wrapper(tokens, *args):
            for r in recs:
                r.label = what
            start = time.perf_counter()
            logits, cache = fn(tokens, *args)
            check(bool(torch.isfinite(logits).all()),
                  f"serve: non-finite logits in a {what} call")
            spent[what][0] += time.perf_counter() - start
            spent[what][1] += 1
            return logits, cache
        return wrapper

    eng._prefill = timed(eng._prefill, "prefill")
    eng._step = timed(eng._step, "decode")
    for mod, name in kernel_mods:
        getattr(mod, name).launches = 0
        if hasattr(mod, "routes"):
            mod.routes.update(dict.fromkeys(mod.routes, 0))
    with contextlib.ExitStack() as stack:
        for rec in recs:
            stack.enter_context(rec)
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: getattr(mod, name).launches for mod, name in kernel_mods}
    routes = {name: dict(mod.routes) for mod, name in kernel_mods
              if hasattr(mod, "routes")}
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    check(len(done) == SERVE_REQUESTS, f"serve: {len(done)} of "
                                       f"{SERVE_REQUESTS} requests completed")
    for r in done:
        check(len(r.out_tokens) == SERVE_NEW and all(
            0 <= t < cfg.vocab for t in r.out_tokens),
            f"serve: request {r.uid} gave {r.out_tokens}")
    generated = sum(len(r.out_tokens) for r in done)
    summary = dict(init_s=init_s, n_params=n_params, wall=wall,
                   generated=generated, prefill=spent["prefill"],
                   decode=spent["decode"], peak_gb=peak_gb,
                   prompts=[int(n) for n in lengths],
                   tokens_decoded=eng.tokens_decoded, n_layers=cfg.n_layers,
                   calls=spent["prefill"][1] + spent["decode"][1],
                   routes=routes)
    # The timing wrappers hold the engine's bound methods: drop them, or
    # the cycle keeps the weights on the card until a garbage collection.
    del eng._prefill, eng._step
    del eng, params
    torch.cuda.empty_cache()
    return launches, summary


def log_serve(name: str, sv, launches, smi: str) -> None:
    pre_s, pre_n = sv["prefill"]
    dec_s, dec_n = sv["decode"]
    log(f"serve: {name}, {sv['n_params']:,} float32 parameters from "
        f"seed 0 in {sv['init_s']:.2f} s; {SERVE_REQUESTS} requests (prompts "
        f"{sv['prompts']}), batch {SERVE_BATCH}, {SERVE_NEW} new tokens each: "
        f"{pre_n} prefills in {pre_s:.4f} s ({pre_s / pre_n:.4f} s each), "
        f"{dec_n} decode steps at {1e3 * dec_s / dec_n:.3f} ms a step; "
        f"launches {launches}; peak memory {sv['peak_gb']:.2f} GiB")
    log(f"serve: {name}: {sv['generated']} tokens in {sv['wall']:.4f} s = "
        f"{sv['generated'] / sv['wall']:.2f} tokens/s "
        f"({sv['tokens_decoded']} decoded) on {smi}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def model_replay_phase(torch, k4, k5, k4_first, k5_first):
    """K4 and K5 against their plain versions on the inputs the serve gave
    them, timed beside the plain versions, one library call each and the
    bound.  Returns (max errors, the JSON records' numbers per kernel)."""
    errs = {"segment_matmul": 0.0, "flash_attention": 0.0}
    main = {}
    for key, ((x, w, rows), _) in k4_first.items():
        label = key[0]
        E, C, D = x.shape
        F = w.shape[2]
        what = (f"segment_matmul on the serve's {label} x {(E, C, D)} w "
                f"{(E, D, F)}")
        for r in (rows, None):
            errs["segment_matmul"] = max(
                errs["segment_matmul"], check_segment_matmul(
                    torch, what, k4.segment_matmul(x, w, r), x, w, r))
        reps = 20 if C > 64 else 200
        t = time_k4(torch, k4, x, w, reps, rows)
        dense = time_k4(torch, k4, x, w, reps)
        # The host's time to submit the calls (no wait for the card): where
        # it matches the CUDA-event time, the calls are host-paced.
        start = time.perf_counter()
        for _ in range(reps):
            k4.segment_matmul(x, w, rows)
        submit_ms = (time.perf_counter() - start) / reps * 1e3
        torch.cuda.synchronize()
        counts = rows.tolist()
        log(f"replay: {what} with the serve's rows (sum {sum(counts)} of "
            f"{E * C}, {sum(1 for n in counts if n > 0)} of {E} experts "
            f"live): {t[0]:.5f} ms (plain {t[1]:.5f} ms, torch.bmm "
            f"{t[2]:.5f} ms, live bound {t[3]:.5f} ms by {t[4]}, "
            f"{100 * t[3] / t[0]:.1f}% of it; the host submits a call in "
            f"{submit_ms:.5f} ms); dense {dense[0]:.5f} ms (plain "
            f"{dense[1]:.5f} ms, bound {dense[3]:.5f} ms by {dense[4]}, "
            f"{100 * dense[3] / dense[0]:.1f}% of it)")
        if label == "prefill" and D > F and "segment_matmul" not in main:
            main["segment_matmul"] = t
    for (label, qs, ks, vs), ((q, k, v), kw) in k5_first.items():
        what = f"flash_attention on the serve's {label} q {qs[0]} k {ks[0]}"
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, what, k5_call(k5, what, "wgmma", q, k, v, **kw), q, k, v,
            kw.get("causal", True), kw.get("scale") or q.shape[-1] ** -0.5))
        t = time_k5(torch, k5, q, k, v, 50)
        start = time.perf_counter()
        for _ in range(50):
            k5.flash_attention(q, k, v, **kw)
        submit_ms = (time.perf_counter() - start) / 50 * 1e3
        torch.cuda.synchronize()
        log(f"replay: {what}: {t[0]:.5f} ms (plain {t[1]:.5f} ms, "
            f"scaled_dot_product_attention {t[2]:.5f} ms, bound {t[3]:.5f} ms "
            f"by {t[4]}, {100 * t[3] / t[0]:.1f}% of bound; the host submits "
            f"a call in {submit_ms:.5f} ms)")
        main.setdefault("flash_attention", t)
    # OLMoE's context, 4096 tokens, at the serve's batch and heads.
    q, k, v = (randn(torch, 70 + i, (SERVE_BATCH, 16, 4096, 128),
                     torch.bfloat16) for i in range(3))
    what = "flash_attention B=4 H=16 S=4096"
    errs["flash_attention"] = max(errs["flash_attention"], check_flash(
        torch, what, k5_call(k5, what, "wgmma", q, k, v), q, k, v, True,
        128 ** -0.5))
    t = time_k5(torch, k5, q, k, v, 10)
    log(f"replay: flash_attention B={SERVE_BATCH} H=16 S=4096 hd=128 causal "
        f"bf16 (OLMoE's context): {t[0]:.5f} ms (plain {t[1]:.5f} ms, "
        f"scaled_dot_product_attention {t[2]:.5f} ms, bound {t[3]:.5f} ms by "
        f"{t[4]}, {100 * t[3] / t[0]:.1f}% of bound)")
    del q, k, v
    torch.cuda.empty_cache()
    return errs, main


# --------------------------------------------------------------------- #
# 8. the slice as a whole: 2 layers at full width, card vs host          #
# --------------------------------------------------------------------- #
class StandIn:
    """Puts ``fn`` in ``module`` under ``name`` for the with-block.  A
    kernel's wrapper counts its launches on that name, so ``fn`` carries
    the count while it stands in for one."""

    def __init__(self, module, name: str, fn):
        self.module, self.name, self.fn = module, name, fn

    def __enter__(self):
        self.kept = getattr(self.module, self.name)
        self.count = hasattr(self.kept, "launches")
        if self.count:
            self.fn.launches = self.kept.launches
        setattr(self.module, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.kept)
        if self.count:
            self.kept.launches = self.fn.launches


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def slice_model(torch, seed: int, arch: str = "olmoe-1b-7b"):
    """``arch`` at full width and 2 layers with weights from ``seed`` on
    the card and a copy on the host, and SLICE_B x (SLICE_S + SLICE_STEPS)
    tokens from ``seed + 1``.  Returns (cfg, card params, host params,
    tokens)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    gpu = init_params(cfg, seed, "cuda")
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (SLICE_B, SLICE_S + SLICE_STEPS)))
    return cfg, gpu, _to_cpu(gpu), toks


def slice_logits(torch, cfg, params, toks, dev: str):
    """The prefill of the first SLICE_S tokens at every position, then
    SLICE_STEPS decode steps fed the next tokens (teacher forcing).
    Returns float32 logits ``[B, SLICE_S + SLICE_STEPS, V]`` and each
    token's experts ``[B, SLICE_S + SLICE_STEPS, layers * k]`` (sorted
    within a layer; None for a model without experts), on the host."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models import moe as moe_lib

    topk, calls = moe_lib.router_topk, []

    def routed(logits, top_k, **kw):
        weights, idx = topk(logits, top_k, **kw)
        calls.append(idx.sort(dim=-1).values.cpu())
        return weights, idx

    def take(logits, n):
        out.append(logits.float().cpu())
        if calls:
            routes.append(torch.cat([c.reshape(SLICE_B, n, -1)
                                     for c in calls], dim=-1))
            calls.clear()

    out, routes = [], []
    with StandIn(moe_lib, "router_topk", routed):
        cache = init_cache(cfg, SLICE_B, SLICE_S + SLICE_STEPS, dev)
        logits, cache = prefill(params, cfg,
                                {"tokens": toks[:, :SLICE_S].to(dev)}, cache,
                                all_positions=True)
        take(logits, SLICE_S)
        for i in range(SLICE_S, SLICE_S + SLICE_STEPS):
            logits, cache = decode_step(params, cfg, toks[:, i:i + 1].to(dev),
                                        cache, i)
            take(logits, 1)
    return torch.cat(out, dim=1), (torch.cat(routes, dim=1) if routes
                                   else None)


def slice_compare(card, host):
    """Card against host, token by token (each position of each row):
    which tokens' experts moved in some layer (a bf16 rounding on the other
    side of a near-tie moves them), the largest |logit difference| at the
    tokens whose experts did not move and at those whose did, and the
    greedy tokens, compared where the experts did not move and the card's
    top-2 margin exceeds SLICE_TOL."""
    (lc, rc), (lh, rh) = card, host
    err = (lc - lh).abs().amax(dim=-1)                  # [B, P]
    moved = (rc != rh).any(dim=-1)
    stayed = ~moved
    top2 = lc.topk(2, dim=-1).values
    sure = stayed & ((top2[..., 0] - top2[..., 1]) > SLICE_TOL)
    same = lc.argmax(-1) == lh.argmax(-1)
    return dict(stayed_err=(float(err[stayed].max()) if bool(stayed.any())
                            else 0.0),
                moved_err=(float(err[moved].max()) if bool(moved.any())
                           else 0.0),
                moved=int(moved.sum()),
                steps=[float(e) for e in err[:, SLICE_S:].amax(dim=0)],
                decided=int(sure.sum()), agree=int((same & sure).sum()),
                equal=int(same.sum()), tokens=int(err.numel()))


def slice_phase(torch):
    """OLMoE-1B-7B at full width and 2 layers, the same weights (seed 0) on
    the card (K4, K5) and on the host (their plain versions), over every
    token of a SLICE_B x SLICE_S prefill and SLICE_STEPS decode steps.
    Where a token's experts are the same on both sides in every layer, its
    logits must agree within SLICE_TOL, and its greedy token must agree
    where the card's top-2 margin exceeds SLICE_TOL; at most SLICE_MOVED
    tokens may have moved experts, and their logits must agree within
    SLICE_CAP.  Returns a summary dict."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    cfg, gpu, cpu, toks = slice_model(torch, 0)
    launches = (ksm.segment_matmul.launches, kfa.flash_attention.launches)
    card = slice_logits(torch, cfg, gpu, toks, "cuda")
    check(ksm.segment_matmul.launches > launches[0]
          and kfa.flash_attention.launches > launches[1],
          "slice: the card side did not launch K4 and K5")
    t0 = time.perf_counter()
    host = slice_logits(torch, cfg, cpu, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(card[0]).all()
               and torch.isfinite(host[0]).all()),
          "slice: non-finite logits")
    r = slice_compare(card, host)
    check(r["stayed_err"] <= SLICE_TOL,
          f"slice: card and host logits differ by {r['stayed_err']:.4g} "
          f"(> {SLICE_TOL}) at a token whose experts did not move")
    check(r["agree"] == r["decided"],
          f"slice: greedy tokens differ at {r['decided'] - r['agree']} of "
          f"the {r['decided']} tokens whose experts did not move and whose "
          f"top-2 margin exceeds {SLICE_TOL}")
    check(r["moved"] <= SLICE_MOVED,
          f"slice: the experts of {r['moved']} of {r['tokens']} tokens "
          f"moved (> {SLICE_MOVED})")
    check(r["moved_err"] <= SLICE_CAP,
          f"slice: card and host logits differ by {r['moved_err']:.4g} "
          f"(> {SLICE_CAP}) at a token whose experts moved")
    del gpu, cpu
    torch.cuda.empty_cache()
    r["cpu_s"] = cpu_s
    return r


# --------------------------------------------------------------------- #
# 9. RWKV6-1.6B: serve, replay and slice                                 #
# --------------------------------------------------------------------- #
def rwkv_replay_phase(torch, k6, first):
    """K6 against its plain version on the inputs the RWKV serve gave it
    (the first call at each shape: each prefill's, the first decode
    step's; the model's bf16 r, k, v and float32 w), timed beside the plain
    version and the bound, with the host's and the card's side of a call.
    Returns (max error, the JSON record's numbers from the first prefill,
    and the first decode's)."""
    err, main = 0.0, {}
    for key, (args, _) in first.items():
        label = key[0]
        B, H, T, hd = args[0].shape
        what = (f"rwkv_scan on the serve's {label} B={B} H={H} T={T} "
                f"hd={hd} (r, k, v {args[0].dtype}, w {args[3].dtype})")
        err = max(err, check_rwkv(torch, what, k6.rwkv_scan(*args),
                                  args)[0])
        reps = 200 if T == 1 else 20
        t = time_k6(torch, k6, args, reps)
        log(f"replay: {what}: {t[0]:.5f} ms (plain {t[1]:.5f} ms, bound "
            f"{t[2]:.6f} ms by {t[3]}, {100 * t[2] / t[0]:.1f}% of bound; "
            f"CUDA events over {reps} calls); "
            + k6_host_side(torch, k6, args, reps))
        main.setdefault(label, t)
    check(set(main) == {"prefill", "decode"},
          f"replay: K6 was recorded at {sorted(main)}, not at both prefill "
          f"and decode")
    return err, main


def rwkv_slice_compare(card, host):
    """Card against host at every token: the largest |logit difference|
    (over the prompt's positions and per decode step), and the greedy
    tokens, compared where the card's top-2 margin exceeds
    RWKV_SLICE_TOL."""
    lc, lh = card[0], host[0]
    err = (lc - lh).abs().amax(dim=-1)                  # [B, P]
    top2 = lc.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > RWKV_SLICE_TOL
    same = lc.argmax(-1) == lh.argmax(-1)
    return dict(err=float(err.max()), prompt_err=float(err[:, :SLICE_S].max()),
                steps=[float(e) for e in err[:, SLICE_S:].amax(dim=0)],
                decided=int(sure.sum()), agree=int((same & sure).sum()),
                equal=int(same.sum()), tokens=int(err.numel()))


def rwkv_slice_phase(torch):
    """RWKV6-1.6B at full width and 2 layers, the same weights (seed 0) on
    the card (K6) and on the host (its plain version), over every token of
    a SLICE_B x SLICE_S prefill and SLICE_STEPS decode steps: logits within
    RWKV_SLICE_TOL everywhere, greedy tokens equal where the card's top-2
    margin exceeds it.  Returns a summary dict."""
    from repro_torch.kernels import rwkv_scan as krw

    cfg, gpu, cpu, toks = slice_model(torch, 0, "rwkv6-1.6b")
    launches = krw.rwkv_scan.launches
    card = slice_logits(torch, cfg, gpu, toks, "cuda")
    check(krw.rwkv_scan.launches - launches
          == cfg.n_layers * (1 + SLICE_STEPS),
          f"slice: the card side launched K6 "
          f"{krw.rwkv_scan.launches - launches} times, not once a layer "
          f"a model call")
    t0 = time.perf_counter()
    host = slice_logits(torch, cfg, cpu, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(card[0]).all() and torch.isfinite(host[0]).all()),
          "slice: non-finite logits")
    r = rwkv_slice_compare(card, host)
    check(r["err"] <= RWKV_SLICE_TOL,
          f"slice: RWKV6 card and host logits differ by {r['err']:.4g} "
          f"(> {RWKV_SLICE_TOL})")
    check(r["agree"] == r["decided"],
          f"slice: RWKV6 greedy tokens differ at {r['decided'] - r['agree']} "
          f"of the {r['decided']} tokens whose top-2 margin exceeds "
          f"{RWKV_SLICE_TOL}")
    del gpu, cpu
    torch.cuda.empty_cache()
    r["cpu_s"] = cpu_s
    return r


def rwkv_phase(torch, k6, kernel_mods, smi: str):
    """Phase 9: the RWKV6-1.6B serve (K6 counted from 0; it must launch
    once a layer a model call, and K4 and K5 never), the replay of its
    K6 calls and the slice check.  Returns (K6's launches in the serve, max
    replay error, the replay's numbers)."""
    rec = Recorder(k6, "rwkv_scan")
    launches, sv = serve_phase(torch, kernel_mods, "rwkv6-1.6b", (rec,))
    log_serve("RWKV6-1.6B", sv, launches, smi)
    check(launches["rwkv_scan"] == sv["n_layers"] * sv["calls"],
          f"serve: K6 launched {launches['rwkv_scan']} times in "
          f"{sv['calls']} model calls, not {sv['n_layers']} a call")
    check(launches["segment_matmul"] == 0 and launches["flash_attention"] == 0,
          f"serve: the RWKV6 serve launched K4 or K5: {launches}")
    err, main = rwkv_replay_phase(torch, k6, rec.first)
    del rec
    torch.cuda.empty_cache()
    sl = rwkv_slice_phase(torch)
    log(f"slice: RWKV6-1.6B at 2 layers, card vs host over {sl['tokens']} "
        f"tokens ({SLICE_B} x {SLICE_S} prompt positions, {SLICE_STEPS} "
        f"decode steps): max |logit diff| {sl['err']:.5f} (allowed "
        f"{RWKV_SLICE_TOL}; prompt {sl['prompt_err']:.5f}, per decode step "
        f"{[round(e, 5) for e in sl['steps']]}); greedy tokens equal at "
        f"{sl['agree']} of the {sl['decided']} whose top-2 margin exceeds "
        f"{RWKV_SLICE_TOL}, and at {sl['equal']} of all {sl['tokens']}; "
        f"host side {sl['cpu_s']:.2f} s")
    return launches["rwkv_scan"], err, main


# --------------------------------------------------------------------- #
# Readings: ``python3 chip_smoke.py --readings``                          #
# --------------------------------------------------------------------- #
def planted_faults(ksm, kfa):
    """Faults planted in the card's side of the slice, each a stand-in for
    a kernel's wrapper that still launches the kernel: (name, module,
    wrapper name, stand-in)."""
    k4, k5 = ksm.segment_matmul, kfa.flash_attention

    def mask_off(q, k, v, causal=True, scale=None):
        return k5(q, k, v, causal=False, scale=scale)

    def scaled_twice(q, k, v, causal=True, scale=None):
        return k5(q, k, v, causal=causal, scale=q.shape[-1] ** -0.5)

    def bf16_accumulator(x, w, rows=None):
        out = None
        for d in range(0, x.shape[2], 64):
            part = k4(x[:, :, d:d + 64].contiguous(),
                      w[:, d:d + 64].contiguous(), rows)
            out = part if out is None else out + part
        return out

    def last_d_dropped(x, w, rows=None):
        # D stays a multiple of 8, so the call takes the kernel it would.
        x = x.clone()
        x[:, :, -1] = 0
        return k4(x, w, rows)

    return [("K5 causal mask off", kfa, "flash_attention", mask_off),
            ("K5 q scaled twice", kfa, "flash_attention", scaled_twice),
            ("K4 sums 64-deep D tiles in bf16", ksm, "segment_matmul",
             bf16_accumulator),
            ("K4 drops the last of D's terms", ksm, "segment_matmul",
             last_d_dropped)]


def slice_readings(torch, seeds=(0, 1, 2)):
    """The readings that SLICE_TOL, SLICE_MOVED and SLICE_CAP are set from:
    at each seed, the card against the host as the check compares them,
    sound and with each planted fault on the card's side.  Returns the
    readings by run name ("sound" or the fault's), a list per seed."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    runs = {}
    for seed in seeds:
        cfg, gpu, cpu, toks = slice_model(torch, seed)
        host = slice_logits(torch, cfg, cpu, toks, "cpu")
        stand_ins = [("sound", None)] + [
            (name, StandIn(mod, attr, fn))
            for name, mod, attr, fn in planted_faults(ksm, kfa)]
        for name, stand_in in stand_ins:
            if stand_in is None:
                card = slice_logits(torch, cfg, gpu, toks, "cuda")
            else:
                with stand_in:
                    card = slice_logits(torch, cfg, gpu, toks, "cuda")
            r = slice_compare(card, host)
            runs.setdefault(name, []).append(r)
            log(f"readings: slice seed {seed}: {name}: max |card - host| "
                f"{r['stayed_err']:.6f} at the tokens whose experts stayed, "
                f"{r['moved_err']:.6f} at the {r['moved']} of {r['tokens']} "
                f"whose experts moved; per decode step "
                f"{[round(e, 6) for e in r['steps']]}; greedy equal at "
                f"{r['equal']} of {r['tokens']}, and at {r['agree']} of the "
                f"{r['decided']} stayed tokens with a top-2 margin above "
                f"{SLICE_TOL}")
        del gpu, cpu, host
        torch.cuda.empty_cache()
    for name, rs in runs.items():
        log(f"readings: slice {name} over seeds {list(seeds)}: stayed-token "
            f"max |diff| {min(r['stayed_err'] for r in rs):.6f} to "
            f"{max(r['stayed_err'] for r in rs):.6f}; tokens moved "
            f"{min(r['moved'] for r in rs)} to {max(r['moved'] for r in rs)}"
            f"; moved-token max |diff| up to "
            f"{max(r['moved_err'] for r in rs):.6f}")
    log(f"readings: slice limits: SLICE_TOL {SLICE_TOL}, SLICE_MOVED "
        f"{SLICE_MOVED}, SLICE_CAP {SLICE_CAP}")
    return runs


def rwkv_planted_faults(torch, krw):
    """Faults planted in K6 on the card's side of the RWKV6 slice, each a
    stand-in for the wrapper that still launches the kernel: (name,
    module, wrapper name, stand-in)."""
    k6 = krw.rwkv_scan

    def no_bonus(r, k, v, w, u, state0=None):
        return k6(r, k, v, w, torch.zeros_like(u), state0)

    def decay_after_add(r, k, v, w, u, state0=None):
        # S <- diag(w) (S + k v^T): the kernel on w * k carries that state;
        # out_t still takes the bonus of the unscaled k, added back here.
        out, state = k6(r, torch.mul(w, k, out=torch.empty_like(k)), v, w,
                        u, state0)
        bonus = (r * u[None, :, None, :] * k * (1 - w)).sum(-1, keepdim=True)
        return out + bonus * v, state

    def state0_ignored(r, k, v, w, u, state0=None):
        return k6(r, k, v, w, u, None)

    def last_term_dropped(r, k, v, w, u, state0=None):
        r = r.clone()
        r[..., -1] = 0.0
        return k6(r, k, v, w, u, state0)

    return [("K6 drops u's bonus", krw, "rwkv_scan", no_bonus),
            ("K6 decays after the add", krw, "rwkv_scan", decay_after_add),
            ("K6 ignores state0", krw, "rwkv_scan", state0_ignored),
            ("K6 drops the last of hd's terms from out", krw, "rwkv_scan",
             last_term_dropped)]


def rwkv_slice_readings(torch, seeds=(0, 1, 2), sound_seeds=range(3, 10)):
    """The readings that RWKV_SLICE_TOL is set from: at each of ``seeds``,
    the RWKV6 slice's card against its host as the check compares them,
    sound and with each planted K6 fault on the card's side; at each of
    ``sound_seeds`` sound only (the spread of sound runs).  Returns the
    readings by run name, a list per seed."""
    from repro_torch.kernels import rwkv_scan as krw

    runs = {}
    for seed in (*seeds, *sound_seeds):
        cfg, gpu, cpu, toks = slice_model(torch, seed, "rwkv6-1.6b")
        host = slice_logits(torch, cfg, cpu, toks, "cpu")
        stand_ins = [("sound", contextlib.nullcontext())] + [
            (name, StandIn(mod, attr, fn))
            for name, mod, attr, fn in rwkv_planted_faults(torch, krw)
            if seed in seeds]
        for name, stand_in in stand_ins:
            with stand_in:
                card = slice_logits(torch, cfg, gpu, toks, "cuda")
            r = rwkv_slice_compare(card, host)
            runs.setdefault(name, []).append(r)
            log(f"readings: rwkv slice seed {seed}: {name}: max |card - "
                f"host| {r['err']:.6f} (prompt {r['prompt_err']:.6f}; per "
                f"decode step {[round(e, 6) for e in r['steps']]}); greedy "
                f"equal at {r['equal']} of {r['tokens']}, and at "
                f"{r['agree']} of the {r['decided']} with a top-2 margin "
                f"above {RWKV_SLICE_TOL}")
        del gpu, cpu, host
        torch.cuda.empty_cache()
    for name, rs in runs.items():
        log(f"readings: rwkv slice {name} over {len(rs)} seeds: max "
            f"|diff| {min(r['err'] for r in rs):.6f} to "
            f"{max(r['err'] for r in rs):.6f}")
    log(f"readings: rwkv slice limit: RWKV_SLICE_TOL {RWKV_SLICE_TOL}")
    # The kernel phase's check against each planted fault, at the serve's
    # prefill shape, with the test's decay and with the model's (w near 1).
    for name, _, _, fn in rwkv_planted_faults(torch, krw):
        for decay in ("test", "model"):
            args = list(rwkv_inputs(torch, 77, SERVE_BATCH, 32, 445, 64,
                                    True))
            if decay == "model":
                args[3] = torch.exp(-torch.exp(randn(
                    torch, 78, args[3].shape, torch.float32, 0.1) - 6.0))
            try:
                check_rwkv(torch, name, fn(*args), args)
                caught = "passes check_rwkv"
            except SmokeFailure as e:
                caught = f"fails check_rwkv: {e}"
            log(f"readings: rwkv kernel check, {name}, {decay} decay: "
                f"{caught}")
    return runs


def profile_busy(torch, fn):
    """Run ``fn`` once under the profiler: (the profile, the device spans
    sorted by start, the µs in which some span ran)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    busy_us, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy_us, end = busy_us + b - a, b
        elif b > end:
            busy_us, end = busy_us + b - end, b
    return prof, spans, busy_us


def device_us(e, own: bool = False) -> float:
    """A profiler event's device time, µs, under either attribute name;
    with ``own``, only the time of the event itself (a kernel's, not that
    of the kernels an operator launched)."""
    for attr in ("device_time_total", "cuda_time_total"):
        attr = "self_" + attr if own else attr
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def decode_readings(torch):
    """One decode step of the full-width serve (batch SERVE_BATCH, a
    257-token context) taken apart on the card: the step (CUDA events over
    10 steps), K4's calls inside it (CUDA events around each call), the
    step's float32 -> bf16 weight casts timed alone (CUDA events), and a
    profiler trace of one step (device busy time, the expert-weight
    casts), where the profiler sees the card.  Returns the times."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import segment_matmul as ksm
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    cfg = get_config("olmoe-1b-7b")
    params = init_params(cfg, 0, "cuda")
    B, S = SERVE_BATCH, 256
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + 1))).cuda()
    cache = init_cache(cfg, B, S + 1, "cuda")
    _, cache = prefill(params, cfg, {"tokens": toks[:, :S]}, cache)

    def step():
        return decode_step(params, cfg, toks[:, S:], cache, S)[0]

    step_ms = time_ms(torch, step, (), 10)

    k4, k4_events = ksm.segment_matmul, []

    def k4_timed(x, w, rows=None):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = k4(x, w, rows)
        ev[1].record()
        k4_events.append(ev)
        return out

    with StandIn(ksm, "segment_matmul", k4_timed):
        step()
        torch.cuda.synchronize()
    k4_ms = sum(a.elapsed_time(b) for a, b in k4_events)

    experts = [bp["moe"][n] for bp in params["blocks"]
               for n in ("w_gate", "w_up", "w_down")]
    others = [t for bp in params["blocks"] for t in _leaves(bp)
              if t.dtype == torch.float32 and all(t is not e for e in experts)]
    others.append(params["embed"].T if cfg.tie_embeddings
                  else params["lm_head"])
    experts_ms = time_ms(
        torch, lambda: [t.to(torch.bfloat16) for t in experts], (), 5)
    others_ms = time_ms(
        torch, lambda: [t.to(torch.bfloat16) for t in others], (), 5)
    log(f"readings: decode step (batch {B}, context {S + 1}): "
        f"{step_ms:.4f} ms (CUDA events, 10 steps); K4's {len(k4_events)} "
        f"calls inside one step {k4_ms:.4f} ms (CUDA events around each); "
        f"the step's float32 -> bf16 weight casts timed alone: the expert "
        f"weights {experts_ms:.4f} ms ({len(experts)} tensors, "
        f"{sum(t.numel() for t in experts) * 6 / 1e9:.2f} GB moved), the "
        f"other weights {others_ms:.4f} ms")

    prof, spans, busy_us = profile_busy(torch, step)
    casts_us, casts_n = 0.0, 0
    for e in prof.key_averages(group_by_input_shape=True):
        shapes = getattr(e, "input_shapes", None) or []
        if (e.key == "aten::_to_copy" and shapes and len(shapes[0]) == 3
                and shapes[0][0] == cfg.n_experts):
            casts_us += device_us(e)
            casts_n += e.count
    if spans:
        wall_us = spans[-1][1] - spans[0][0]
        log(f"readings: decode step under the profiler: {len(spans)} device "
            f"spans, busy {busy_us / 1e3:.4f} ms of the {wall_us / 1e3:.4f} "
            f"ms from the first to the last ({100 * busy_us / wall_us:.1f}%)"
            f"; expert-weight casts {casts_us / 1e3:.4f} ms of device time "
            f"({casts_n} calls)")
    else:
        log("readings: decode step under the profiler: no device spans "
            "(the profiler does not see the card): not measured")

    # A prefill of the same prompt, where the time went.
    def fill():
        fresh = init_cache(cfg, B, S + 1, "cuda")
        return prefill(params, cfg, {"tokens": toks[:, :S]}, fresh)[0]

    fill_ms = time_ms(torch, fill, (), 3)
    prof, spans, busy_us = profile_busy(torch, fill)
    if spans:
        ops = sorted(((device_us(e, own=True), e.count, e.key)
                      for e in prof.key_averages()
                      if device_us(e, own=True) > 0), reverse=True)[:6]
        wall_us = spans[-1][1] - spans[0][0]
        log(f"readings: prefill (batch {B}, {S} tokens): {fill_ms:.4f} ms "
            f"(CUDA events, 3 prefills); under the profiler busy "
            f"{busy_us / 1e3:.4f} ms of {wall_us / 1e3:.4f} ms "
            f"({100 * busy_us / wall_us:.1f}%); most device time: "
            + "; ".join(f"{key[:60]} {us / 1e3:.4f} ms ({n} calls)"
                        for us, n, key in ops))
    del params, cache
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, k4_ms=k4_ms, experts_ms=experts_ms,
                others_ms=others_ms)


def rwkv_decode_readings(torch):
    """One decode step of the full-width RWKV6 serve (batch SERVE_BATCH
    after a 256-token prefill) taken apart on the card: the step (CUDA
    events over 10 steps) and the host's time to submit it, and a prefill
    of the same 256 tokens, as served, with the copies into K6's contiguous
    layout that it does without and with ``F.silu`` in place of the gate's
    ``layers.silu``; K6's calls inside the step (CUDA events around each),
    the step's float32 -> bf16 weight casts timed alone (CUDA events), and
    the device's busy share under the profiler.  Returns the times."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import rwkv_scan as krw
    from repro_torch.models import decode_step, init_cache, init_params, prefill
    from repro_torch.models import ssm as tssm

    cfg = get_config("rwkv6-1.6b")
    params = init_params(cfg, 0, "cuda")
    B, S = SERVE_BATCH, 256
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + 1))).cuda()
    cache = init_cache(cfg, B, S + 1, "cuda")
    _, cache = prefill(params, cfg, {"tokens": toks[:, :S]}, cache)

    def step():
        return decode_step(params, cfg, toks[:, S:], cache, S)[0]

    k6 = krw.rwkv_scan

    def copies(r, k, v, w, u, state0=None):
        # r, k, v and w copied into contiguous [B, H, T, hd], and out (then
        # contiguous) copied back by the model's reshape: no-ops at T = 1.
        return k6(*(x.contiguous() for x in (r, k, v, w)), u, state0)

    def timed():
        pre_ms = time_ms(torch, lambda: prefill(
            params, cfg, {"tokens": toks[:, :S]}, init_cache(cfg, B, S + 1,
                                                             "cuda")), (), 5)
        ms = time_ms(torch, step, (), 10)
        start = time.perf_counter()
        for _ in range(10):
            step()
        sub = (time.perf_counter() - start) / 10 * 1e3
        torch.cuda.synchronize()
        return pre_ms, ms, sub

    variants = {}
    for name, stand_in in (
            ("as served", contextlib.nullcontext()),
            ("with layout copies into and out of K6",
             StandIn(krw, "rwkv_scan", copies)),
            ("with F.silu for the gate", StandIn(tssm, "silu", F.silu)),
            ("as served, again", contextlib.nullcontext())):
        with stand_in:
            variants[name] = timed()
        log(f"readings: rwkv {name}: a {S}-token prefill "
            f"{variants[name][0]:.4f} ms (CUDA events, 5 prefills), a "
            f"decode step {variants[name][1]:.4f} ms (CUDA events, 10 "
            f"steps), submitted by the host in {variants[name][2]:.4f} ms")
    step_ms, submit_ms = variants["as served"][1:]

    k6_events = []

    def k6_timed(*args):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = k6(*args)
        ev[1].record()
        k6_events.append(ev)
        return out

    with StandIn(krw, "rwkv_scan", k6_timed):
        step()
        torch.cuda.synchronize()
    k6_ms = sum(a.elapsed_time(b) for a, b in k6_events)
    weights = [t for bp in params["blocks"] for t in _leaves(bp)]
    weights.append(params["lm_head"])
    casts_ms = time_ms(
        torch, lambda: [t.to(torch.bfloat16) for t in weights], (), 5)
    _, spans, busy_us = profile_busy(torch, step)
    log(f"readings: rwkv decode step (batch {B}, after {S} tokens): "
        f"{step_ms:.4f} ms (CUDA events, 10 steps), submitted by the host in "
        f"{submit_ms:.4f} ms a step; K6's {len(k6_events)} calls inside one "
        f"step {k6_ms:.4f} ms (CUDA events around each); the step's "
        f"float32 -> bf16 weight casts timed alone {casts_ms:.4f} ms "
        f"({len(weights)} tensors, "
        f"{sum(t.numel() for t in weights) * 6 / 1e9:.2f} GB moved)")
    if spans:
        wall_us = spans[-1][1] - spans[0][0]
        log(f"readings: rwkv decode step under the profiler: {len(spans)} "
            f"device spans, busy {busy_us / 1e3:.4f} ms of the "
            f"{wall_us / 1e3:.4f} ms from the first to the last "
            f"({100 * busy_us / wall_us:.1f}%)")
    else:
        log("readings: rwkv decode step under the profiler: no device spans "
            "(the profiler does not see the card): not measured")
    del params, cache
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, submit_ms=submit_ms, k6_ms=k6_ms,
                casts_ms=casts_ms, variants=variants)


def readings() -> int:
    """``--readings``: build, then the slice checks' readings and the
    OLMoE decode step taken apart (``PERF.md``).  Not part of the smoke."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")
    _build.build()
    t0 = time.perf_counter()
    slice_readings(torch)
    decode_readings(torch)
    rwkv_slice_readings(torch)
    rwkv_decode_readings(torch)
    log(f"readings: done in {time.perf_counter() - t0:.1f} s")
    return 0


def armed() -> int:
    """``--armed``: W3 at SF1 resident, armed (``run()``), armed by windows
    of ``ARMED_K`` and the host plane by the same windows, each once: its
    wall and host seconds (``ctrl step`` / ``ctrl drain`` split).  Not part
    of the smoke; a copy beside another tree's ``src`` times that tree the
    same way, so two trees run in turns in one call compare."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import dataflow
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | {ROOT}")
    _build.build()
    k16 = dict(n_tuples=W3_TUPLES, batch_ticks=ARMED_K)
    for label, kw, backend, executor, tweak in (
            ("W3 resident", dict(n_tuples=W3_TUPLES), "torch", "jit", None),
            ("W3 resident armed", dict(n_tuples=W3_TUPLES), "torch", "jit",
             "armed"),
            ("W3 resident armed k16", k16, "torch", "jit", "armed-k16"),
            ("W3 numpy host k16", k16, "numpy", None, "k16")):
        with path_tweak(tweak):
            wf, wall, spent, _ = run_workflow(dataflow, "build_w3", kw,
                                              backend, executor, tweak)
        parts = "; ".join(f"{what} {sec:.3f} s in {calls} calls"
                          for what, (sec, calls) in spent.items() if calls)
        log(f"armed: {label}: {wf.engine.tick} ticks, "
            f"{wf.engine.super_ticks} super-ticks, wall {wall:.3f} s "
            f"({parts or 'no timed calls'})")
    return 0


# --------------------------------------------------------------------- #
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.dataflow import device as tdev
    from repro_torch.kernels import _build
    from repro_torch.kernels import ctrl_step as kctrl
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import partition as kpart
    from repro_torch.kernels import ref
    from repro_torch.kernels import rwkv_scan as krw
    from repro_torch.kernels import segment_matmul as kseg

    # Float32 products in full float32 (the plain versions' bmm too).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    check_sass()
    records, small_ms = kernel_phase(torch, kpart, ref)
    model_errs = model_kernel_phase(torch, kseg, kfa)
    rwkv_err = rwkv_kernel_phase(torch, krw)
    ctrl_kernel_phase(torch, kctrl, ref, tdev)
    t0 = time.perf_counter()
    launches, first, path_calls, ctrl_kept = main_path(torch, kpart, kctrl)
    log(f"main: all workflows in {time.perf_counter() - t0:.1f} s; "
        f"partition_scatter at the W1 chunk size {small_ms:.5f} ms a call")
    replay_err = replay_phase(torch, kpart, ref, first, path_calls)
    ctrl_record = ctrl_replay(torch, kctrl, ref, tdev, kpart, ctrl_kept)
    ctrl_record["launches"] = launches["ctrl_step"]
    for rec in records:
        rec["launches"] = launches[rec["name"]]
        if rec["name"] == "partition_scatter_fold":
            rec["max_abs_err"] = max(rec["max_abs_err"], replay_err)
    del first, path_calls
    torch.cuda.empty_cache()

    kernel_mods = [(kpart, name) for name in KERNELS] + [
        (kseg, "segment_matmul"), (kfa, "flash_attention"),
        (krw, "rwkv_scan")]
    recs = (Recorder(kseg, "segment_matmul"), Recorder(kfa, "flash_attention"))
    serve_launches, sv = serve_phase(torch, kernel_mods, "olmoe-1b-7b", recs)
    log_serve("OLMoE-1B-7B", sv, serve_launches, smi)
    for name in ("segment_matmul", "flash_attention"):
        check(serve_launches[name] > 0, f"serve: {name} never launched")
    # Three expert products a layer a model call: the prefills' (C = the
    # batch's tokens) on the tiles kernel, the decode steps' (C = 4) on
    # the stream kernel.
    per_call = 3 * sv["n_layers"]
    want = {"tiles": per_call * sv["prefill"][1],
            "stream": per_call * sv["decode"][1]}
    got = sv["routes"]["segment_matmul"]
    check(serve_launches["segment_matmul"] == per_call * sv["calls"]
          and {r: n for r, n in got.items() if n} == want,
          f"serve: segment_matmul launched {got} over {sv['calls']} model "
          f"calls, not {per_call} a call as {want}")
    # One K5 call a layer a prefill, every one on the wgmma kernel (bf16,
    # hd 128, the model's layout read in place).
    want = {"fma": 0, "wgmma": sv["n_layers"] * sv["prefill"][1]}
    got = sv["routes"]["flash_attention"]
    check(serve_launches["flash_attention"] == want["wgmma"] and got == want,
          f"serve: flash_attention launched {got} over {sv['prefill'][1]} "
          f"prefills, not {want}")
    errs, main = model_replay_phase(torch, kseg, kfa, recs[0].first,
                                    recs[1].first)
    del recs
    torch.cuda.empty_cache()
    sl = slice_phase(torch)
    log(f"slice: OLMoE-1B-7B at 2 layers, card vs host over {sl['tokens']} "
        f"tokens ({SLICE_B} x {SLICE_S} prompt positions, {SLICE_STEPS} "
        f"decode steps): experts moved at {sl['moved']} (allowed "
        f"{SLICE_MOVED}); max |logit diff| {sl['stayed_err']:.5f} at the "
        f"others (allowed {SLICE_TOL}), {sl['moved_err']:.5f} at the moved "
        f"(allowed {SLICE_CAP}); per decode step "
        f"{[round(e, 5) for e in sl['steps']]}; greedy tokens equal at "
        f"{sl['agree']} of the {sl['decided']} stayed tokens whose top-2 "
        f"margin exceeds {SLICE_TOL}, and at {sl['equal']} of all "
        f"{sl['tokens']}; host side {sl['cpu_s']:.2f} s")
    for name, replaces in (("segment_matmul",
                            "src/repro/kernels/segment_matmul.py:35"),
                           ("flash_attention",
                            "src/repro/kernels/flash_attention.py:72")):
        ms, plain_ms, lib_ms, b_ms, b_by = main[name]
        records.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces=replaces, launches=serve_launches[name],
            max_abs_err=max(model_errs[name], errs[name]), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
    rwkv_launches, replay_k6_err, k6_main = rwkv_phase(torch, krw,
                                                       kernel_mods, smi)
    ms, plain_ms, b_ms, b_by = k6_main["prefill"]
    records.append(dict(
        name="rwkv_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv_scan.cu",
        replaces="src/repro/kernels/rwkv_scan.py:40",
        launches=rwkv_launches, max_abs_err=max(rwkv_err, replay_k6_err),
        ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        library_ms=None))
    records.append(ctrl_record)
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--readings": readings, "--armed": armed}.get(
        " ".join(sys.argv[1:]), main)())
