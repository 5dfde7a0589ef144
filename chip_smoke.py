#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout; needs one card

Phases, in order; any failure exits non-zero before the last line:

1. card    the card's name, count, and ``nvidia-smi`` name and power limit;
2. build   nvcc builds every kernel source (one process each, in parallel)
           and the ``-Xptxas -v`` lines are printed; K4's tiles kernel (in
           its three forms) and stream kernels, K5's wgmma kernel and the
           two wgmma kernels of its backward must hold wgmma (HGMMA) in
           their SASS (``cuobjdump``);
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
9b. vlm    InternVL2-2B at its published 24 layers (~1.89e9 float32
           weights from seed 0, bf16 compute) behind ``ServeEngine`` with
           the serve's constants: the engine puts its 1,024 zero patch
           rows ahead of each prompt, so each prefill is one causal K5
           call a layer at S 1,088-1,536 (GQA, two query heads a KV head);
           every kernel's count set to 0 just before and read just after:
           K5 once a layer a prefill, every call on its wgmma kernel, K4
           and K6 never; K5 replayed on the prefills' inputs; then the
           slice check at 2 layers, card against host, every text position
           of a 2 x 64 prompt behind 1,024 seeded patch rows and 4
           teacher-forced decode steps within ``VLM_SLICE_TOL``, greedy
           tokens equal wherever the card's top-2 margin exceeds it;
10. train  (its kernel checks run after phase 6) K5's backward
           (``flash_attention_bwd``, ``csrc/flash_attention.cu``: the wgmma
           route, a prep pass, ``flash_bwd_dkv_wgmma`` and
           ``flash_bwd_dq_wgmma``, for bf16 at hd 128; the fma route,
           ``flash_bwd_dq`` and ``flash_bwd_dkv``, for the rest) against its
           plain version within the bound ``check_flash_bwd`` states for
           each route, at the training shape (B 4, H 16, S 512, hd 128,
           bf16 through the model's ``[B, S, H, hd]`` views: wgmma; float32:
           fma), at S 445, hd 128 with three query heads a KV head, causal
           and full (wgmma) and at S 445, hd 64 with two (fma), the route
           and its launches by ``bwd_routes``, the same bits from two calls;
           K5's forward with the same output bits with and without its lse
           and (wgmma) the lse within ``check_lse``'s bound; the planted
           faults "drops D" and "mask off" beyond the wgmma route's bound;
           K4's backward (``segment_matmul_backward``: dx and dw, two
           launches, bf16 on the tiles kernel's dx and dw forms with no
           copy, float32 and D or F no multiple of 8 over copies) against
           its plain version within ``check_segment_matmul``'s bound at
           OLMoE's expert products with 8 replica slots (E 72, D 2048, F
           1024 both ways, C 320 and 20), bf16 and float32, ragged rows with
           NaN in x past them (and no rows, rows 0 and rows C at the gate
           product), and at D 40, F 130.  Then the
           training path, every kernel's count set to 0 just before and read
           just after: OLMoE-1B-7B at its published widths cut to
           ``TRAIN_LAYERS`` = 6 layers with ``TRAIN_SLOTS`` = 8 replica slots
           (~3.0e9 float32 params from seed 0, bf16 compute, remat), a hot
           expert planted in every router, ``Trainer`` with the Reshape
           balancer on 4 shards, ``TRAIN_STEPS`` = 8 steps on one 4 x 512
           batch from ``SkewAwarePipeline``: the loss finite and lower at
           the last step than the first, an ``sbr_replicate``, every replica
           slot equal to its primary bit for bit after every step, K4's
           forward 3 launches a layer a forward run (two runs a step under
           remat) on its tiles kernel and its backward 6 a layer a step on
           the tiles kernel's dx and dw forms, K5's forward one a layer a
           run on its wgmma kernel and its backward's wgmma route once a
           layer a step (three launches); step seconds, tokens/s, the
           AdamW update's share and peak GiB printed.  Both backwards are
           replayed on the path's own inputs (K5's also at 1 x 4096) and
           timed beside their plain versions, ``torch.bmm`` (dx and dw) /
           SDPA's backward and their routes' bounds.  Then the train
           slice: a 2-layer full-width OLMoE in
           float32 (K4 and K5 on their fma routes, forward and backward),
           8 replica slots and a split table, one ``loss_fn`` gradient of a
           2 x 64 batch on the card against the host: the loss within
           ``TRAIN_SLICE_LOSS_TOL``, every gradient leaf within
           ``TRAIN_SLICE_TOL`` of its largest entry.  Then the same OLMoE
           path with the DP-local MoE dispatch over ``TRAIN_GROUPS`` = 4
           token groups (512 tokens a group), from a fresh trainer: the
           same checks, its step beside the first path's, K4's forward
           ``rows`` summed against the live rows (kept token-slot pairs;
           the dead rows inside each slot's prefix are the zero sentinel
           row), K4 forward and backward replayed on its inputs (the
           forward also timed with each slot's live count as its rows),
           and its 2-layer float32 slice within the same limits.  RWKV6
           (its kernel checks run after phase 6's K6 checks): K6's backward
           (``rwkv_scan_bwd``, ``csrc/rwkv_scan.cu``) against its plain
           version within the bound ``check_rwkv_bwd`` states, at hd 16,
           32 and 64, float32 and the model's bf16 r, k, v, T = 1, C - 1,
           C, C + 1 and 3C + 5 (C = 8, the forward's checkpoint interval),
           without and with state0 and dstate_T, on the model's views and
           odd hd for all three type kinds; one launch a call, the same
           bits from two calls, K6's forward the same out and state bits
           with and without its checkpoints; the planted faults "G not
           decayed", "dw reads S_t for S_{t-1}" and "du of one batch row"
           beyond the bound.  Then the RWKV6 training path, every
           kernel's count set to 0 just before and read just after:
           RWKV6-1.6B at its published widths and all 24 layers (~1.48e9
           float32 params from seed 0, bf16 compute, remat), ``Trainer``
           without a balancer, ``TRAIN_STEPS`` steps on one 4 x 512 batch
           from ``SkewAwarePipeline``: the loss finite at every step and
           lower at the last than the first, K6's forward twice a layer a
           step and its backward once, K4 and K5 never; step seconds,
           tokens/s, the AdamW update's share and peak GiB printed.  K6
           forward and backward replayed on the path's own inputs, the
           backward also at 1 x ``RWKV_CONTEXT`` (4096), timed beside its
           plain version and ``k6_bwd_bound``.  Then the RWKV6 train slice:
           2 layers at full width in float32, one ``loss_fn`` gradient of
           a 2 x 64 batch, card against host, within
           ``RWKV_TRAIN_SLICE_LOSS_TOL`` and ``RWKV_TRAIN_SLICE_TOL``.
           Then InternVL2-2B at its published 24 layers (~30.2 GB of
           training state), no balancer, ``TRAIN_STEPS`` steps on one
           batch of 4 x (1,024 seeded patch rows + 512 tokens from
           ``SkewAwarePipeline``): the loss finite and falling, K5's
           forward twice a layer a step and its backward once, all on
           their wgmma routes, K4 and K6 never; K5 forward and backward
           replayed on the path's inputs (S 1,536, two query heads a KV
           head); the 2-layer float32 gradient slice, card against host,
           within ``VLM_TRAIN_SLICE_LOSS_TOL`` and
           ``VLM_TRAIN_SLICE_TOL``;
12. whisper  (its kernel checks run after phase 6) K5 at Whisper's (64,
           64), bf16 on its wgmma route through the model's views, forward
           and backward against their plain versions at
           ``WHISPER_K5_CASES`` (the cross attention's S 1, 63 and 512
           against T 1,500; the encoder's S = T = 1,500; the decoder's
           causal S 512; S 445 with two query heads a KV head), the lse,
           views and two calls bit for bit, the planted backward faults
           beyond the bound, and both held to the same bounds and timed at
           ``WHISPER_K5_TIMED`` beside their bounds, plain versions and
           SDPA (the build fails if ptxas serializes or spills a (64, 64)
           wgmma kernel); ``scalar_constants_check``
           (the layers' scalar constants: JAX's rounding, no wait for the
           stream).  Then Whisper-medium at
           its published 24 + 24 layers behind ``ServeEngine`` with the
           serve's constants and the engine's zero frames: K5 72 times a
           prefill (24 encoder, 24 causal, 24 cross) and 24 a decode step
           (the cross attention of one query row), all on wgmma, K4 and K6
           never; K5 replayed on the serve's inputs; the 2 + 2 layer slice
           behind seeded frames within ``WHISPER_SLICE_TOL``; then the
           training path (4 x (1,500 zero frames + 512 tokens), remat, 8
           steps, no balancer; K5 forward 1,152 and backward 1,728
           launches, all wgmma), K5 forward and backward replayed on its
           inputs, and the 2 + 2 layer float32 gradient slice within
           ``WHISPER_TRAIN_SLICE_TOL`` and ``WHISPER_TRAIN_SLICE_LOSS_TOL``;
13. hybrid (its kernel checks run after phase 12's) K5's sliding window
           at Hymba's (64, 64) with 5 query heads a KV head, bf16 on
           wgmma, forward and backward, against the windowed plain
           versions at B 4, H 25, S = T = 2,048, window 1,024 and at the
           edge windows 1, 63, 64, 65, 1,023 and past S, and on fma (hd 16,
           float32); K7 ``mamba_scan`` (csrc/mamba_scan.cu, no Pallas
           counterpart: ``mamba_apply``'s ``lax.scan``) forward and
           backward at B 4, S 2,048, d_inner 1,600, N 16, at a decode
           step's S 1 with a state and at ragged d_inner and N (element
           copies into its ring), within ``check_mamba`` /
           ``check_mamba_bwd``'s error envelopes (the build fails if ptxas
           spills either K7 kernel); planted faults (the
           window one key wider or gone, the state or dh_fin not carried)
           beyond the bounds; each timed beside its bound, its plain
           version and (K5) SDPA with the window as a boolean mask.  Then
           Hymba-1.5B at its published 32 layers behind ``ServeEngine``
           with prompts of 1,100-2,048 tokens: K5 32 times a prefill, all
           wgmma (29 windowed layers), K7 32 times a model call; K5 and K7
           replayed on the serve's inputs; a 4-layer full-width slice
           (layer 1 windowed) at 1,150 prompt positions and 4 decode steps
           within ``HYBRID_SLICE_TOL``; the training path (4 x 2,048
           tokens, remat, 8 steps; K5 forward 512 and backward 768
           launches on wgmma, K7 forward 512 and backward 512), K5 and K7
           replayed on its inputs, and the 4-layer float32 gradient slice
           within ``HYBRID_TRAIN_SLICE_TOL`` and
           ``HYBRID_TRAIN_SLICE_LOSS_TOL``;
14. report one JSON line of kernels (K1-K7, ctrl_step and K4's, K5's,
           K6's and K7's backward, and K5's forward and backward at MLA's
           and Whisper's widths and with Hymba's window; a forward
           kernel's launches are its serves' and training paths' together,
           a backward's its training paths'), the card line, and the
           ``{"ok": ...}`` line last.

Without a card, or run from a directory that holds only this file, it exits
non-zero and prints no result.  It imports nothing of JAX.

    python3 chip_smoke.py --readings   # not part of the smoke

builds the kernels and prints the readings behind ``SLICE_TOL``,
``RWKV_SLICE_TOL``, ``TRAIN_SLICE_TOL``, ``RWKV_TRAIN_SLICE_TOL`` and the
two InternVL2-2B limits
(each slice check at three seeds, sound and with planted kernel faults,
the RWKV6 one sound at seven more; the train slices' faults in the
backward) and one decode step of
each full-width serve taken apart (the kernels' calls, the weight casts,
the device's busy share under the profiler; the RWKV6 step also with the
layout copies K6 does without and with ``F.silu`` for the gate's silu).

    python3 chip_smoke.py --train      # not part of the smoke

builds K4, K5 and K6 and runs phase 10 alone.

    python3 chip_smoke.py --whisper    # not part of the smoke

builds K4 and K5 and runs phase 12 alone, then the readings behind
``WHISPER_SLICE_TOL`` and the two Whisper train slice limits (each slice at
three seeds, sound and with planted K5 faults).

    python3 chip_smoke.py --hybrid     # not part of the smoke

builds K4, K5, K6 and K7 and runs phase 13 alone, then the readings behind
``HYBRID_SLICE_TOL`` and the two Hymba train slice limits (each slice at
three seeds, sound and with planted K5 and K7 faults).

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
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, NamedTuple, Optional

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

#: The training path: OLMoE-1B-7B's published widths cut to TRAIN_LAYERS
#: of its 16 layers (float32 params, grads and AdamW moments, 16 bytes a
#: parameter, for the 16 layers would need ~138 GB), with TRAIN_SLOTS
#: spare replica slots a layer (P = 72) for the balancer; a TRAIN_B x
#: TRAIN_S batch, TRAIN_STEPS steps on it at TRAIN_LR (warmup 1, cosine to
#: a tenth), a hot expert planted as the JAX suite's ``_skewed_moe`` does
#: (TRAIN_BOOST added to router column TRAIN_HOT in every layer).
TRAIN_LAYERS, TRAIN_SLOTS, TRAIN_STEPS = 6, 8, 8
TRAIN_B, TRAIN_S, TRAIN_LR = 4, 512, 1e-3
TRAIN_HOT, TRAIN_BOOST = 0, 3.0
#: The train slice: card against host at TRAIN_SLICE_LAYERS layers, a
#: TRAIN_SLICE_B x TRAIN_SLICE_S batch, float32 compute: the largest
#: |loss difference| (TRAIN_SLICE_LOSS_TOL) and the largest gradient
#: difference relative to its leaf's largest entry (TRAIN_SLICE_TOL)
#: allowed, set from ``python3 chip_smoke.py --readings`` near the
#: geometric mean of what sound runs reached at seeds 0-2 in two calls and
#: the nearest planted fault (H100): gradients 1.33e-4 against 0.351 (K4
#: dropping the last of D's terms; the backward's faults 0.456-2.6), the
#: loss 6.68e-6 against 0.00146 (the same fault; the backward's faults
#: leave the loss as it is).  K4's bf16-tile fault is none in float32.
TRAIN_SLICE_LAYERS, TRAIN_SLICE_B, TRAIN_SLICE_S = 2, 2, 64
TRAIN_SLICE_TOL, TRAIN_SLICE_LOSS_TOL = 0.007, 1e-4
#: The RWKV6 training path trains RWKV6-1.6B at its published widths and
#: all 24 layers (its float32 params, grads and AdamW moments, ~23.7 GB,
#: fit one card) on the OLMoE path's batch shape, steps and rate.  Its
#: train slice (TRAIN_SLICE_LAYERS layers, float32, the same batch shape):
#: the largest gradient difference relative to its leaf's largest entry
#: (RWKV_TRAIN_SLICE_TOL) and |loss difference| (RWKV_TRAIN_SLICE_LOSS_TOL)
#: allowed, set from ``python3 chip_smoke.py --readings`` like
#: TRAIN_SLICE_TOL (H100): gradients, sound runs at seeds 0-2 3.86e-6 to
#: 4.14e-6 against the nearest planted fault's 0.00405 (K6 decaying after
#: the add; the backward's faults 0.0675-1.02), geometric mean 1.3e-4;
#: the loss, sound up to 9.54e-7 (one float32 ulp at ~11.6) against
#: 9.54e-6 (the same fault; the backward's faults leave the loss as it
#: is), and 4e-6 between them.
RWKV_TRAIN_SLICE_TOL, RWKV_TRAIN_SLICE_LOSS_TOL = 1.3e-4, 4e-6
#: The context K6's backward is also replayed at, one sequence.
RWKV_CONTEXT = 4096
#: The OLMoE training path again with the DP-local MoE dispatch: the same
#: model, batch, steps and rate over TRAIN_GROUPS token groups (512 tokens
#: a group), and its train slice at TRAIN_GROUPS (the same limits).
TRAIN_GROUPS = 4
#: InternVL2-2B (the vlm family: InternLM2-1.8B behind a stubbed vision
#: tower).  Its serve takes the serve's requests behind the engine's
#: 1,024 zero patch rows; its training path TRAIN_STEPS steps of TRAIN_B x
#: (1,024 seeded patch rows at VLM_PATCH_STD, the embedding table's scale,
#: + TRAIN_S tokens) at TRAIN_LR, remat, no balancer.  Its serve slice
#: (full width, 2 layers, seeded patches at VLM_PATCH_STD ahead of the
#: SLICE_B x SLICE_S prompt, SLICE_STEPS decode steps): the largest |logit
#: difference| at a text position or decode step (VLM_SLICE_TOL); its
#: train slice (2 layers, float32, the patches ahead of a TRAIN_SLICE_B x
#: TRAIN_SLICE_S batch): the largest gradient difference relative to its
#: leaf's largest entry and |loss difference| (VLM_TRAIN_SLICE_TOL,
#: VLM_TRAIN_SLICE_LOSS_TOL).  Each set from ``python3 chip_smoke.py
#: --readings`` near the geometric mean of what sound runs reached at
#: seeds 0-2 and the nearest planted K5 fault (H100): logits 0.0469 at
#: every seed against 0.861 (K5 fed q with its last of hd's terms zeroed;
#: the mask off 2.76, q scaled twice 5.45); gradients 5.01e-6 against
#: 0.195 (the same fault; the backward's faults 0.32-2.19); the loss
#: 9.54e-7 (one float32 ulp at ~11.9) against 0.00238 (q scaled twice;
#: the backward's faults leave the loss as it is).
VLM_ARCH, VLM_PATCH_STD = "internvl2-2b", 0.02
VLM_SLICE_TOL = 0.2
VLM_TRAIN_SLICE_TOL, VLM_TRAIN_SLICE_LOSS_TOL = 1e-3, 5e-5

#: The MLA models (multi-head latent attention: K5 at (dk, dv) = (96, 64)
#: and (192, 128)): MiniCPM3-4B (dense, a q_lora query path) and
#: DeepSeek-V2-Lite (64 routed experts top 6, 2 shared, a dense first
#: layer).  Each serves the serve's requests at its published depth and
#: trains TRAIN_STEPS steps of a TRAIN_B x TRAIN_S batch at TRAIN_LR with
#: remat, cut in depth to MLA_TRAIN_LAYERS (float32 params, grads and
#: AdamW moments, 16 bytes a parameter: MiniCPM3's 62 layers would need
#: ~68 GB before activations, DeepSeek's 27 ~250 GB); DeepSeek with
#: TRAIN_SLOTS replica slots a MoE layer, a balancer on each and the hot
#: expert planted as on the OLMoE path.  Their train slices (2 layers,
#: float32: DeepSeek's dense first layer and one MoE layer with TRAIN_SLOTS
#: replica slots and the OLMoE slice's split table) are held to
#: TRAIN_SLICE_TOL and TRAIN_SLICE_LOSS_TOL.  Their serve slices (full
#: width, 2 layers, the serve slice's prompt and steps) to MLA_SLICE_TOL
#: (MiniCPM3: the largest |logit difference| at any token) and
#: MLA_MOE_SLICE (DeepSeek: as SLICE_TOL, SLICE_MOVED and SLICE_CAP are
#: for OLMoE), each set from ``python3 chip_smoke.py --mla`` (its
#: readings) near the geometric mean of what sound runs reached at seeds
#: 0-2 and what the nearest planted kernel fault gave (H100): MiniCPM3
#: 0.0469-0.0508 against 0.758 (K5 fed q with its last of dk's terms
#: zeroed; q scaled twice 4.55, the mask off 6.30); DeepSeek's stayed
#: tokens 0.0471-0.0508 against 0.109 (K4 dropping the last of D's terms;
#: K4's bf16-tile fault, 0.0498-0.0547, hides in the sound runs' reach),
#: 3-7 moved tokens against 41 (q's last term zeroed; K5's other faults
#: 131-136), moved tokens 0.486 against 5.23 (q scaled twice).
MLA_ARCHS = ("minicpm3-4b", "deepseek-v2-lite-16b")
MLA_NAMES = {"minicpm3-4b": "MiniCPM3-4B",
             "deepseek-v2-lite-16b": "DeepSeek-V2-Lite"}
MLA_TRAIN_LAYERS = {"minicpm3-4b": 40, "deepseek-v2-lite-16b": 5}
MLA_SLICE_TOL = 0.2
#: ``mla_kernel_phase``'s cases on the edges of K5's backward at (192,
#: 128), whose dkv blocks each walk several 64-key items (the next one's
#: K and V loaded during this one's last tiles): causal, KV < H (rep 3 and
#: 2), T 161 and 200 (the last item ragged), the diagonal inside the
#: first tile of every item: (B, H, KV, S, [B, S, H, d] views), bf16.
MLA_BWD_EDGES = ((1, 6, 2, 161, True), (2, 4, 2, 200, False))
MLA_MOE_SLICE = (0.075, 16, 1.6)
#: Whisper-medium (the encdec family: 24 encoder layers of full attention
#: over 1,500 stubbed frames, 24 decoder layers with causal self and cross
#: attention; K5 at (64, 64)).  Its serve takes the serve's requests behind
#: the engine's zero frames, its training path TRAIN_STEPS steps of TRAIN_B
#: x (1,500 zero frames + TRAIN_S tokens) at TRAIN_LR with remat, both at
#: the published 24 + 24 layers.  Its slices run 2 + 2 layers at full
#: width behind seeded frames at WHISPER_FRAME_STD (zero frames would give
#: every batch row the same encoder output): the serve slice's largest
#: |logit difference| at a prompt position or decode step
#: (WHISPER_SLICE_TOL); the float32 train slice's gradient difference
#: relative to its leaf's largest entry and |loss difference|
#: (WHISPER_TRAIN_SLICE_TOL, WHISPER_TRAIN_SLICE_LOSS_TOL).  Each set from
#: ``python3 chip_smoke.py --whisper`` (its readings) near the geometric
#: mean of what sound runs reached at seeds 0-2 and the nearest planted K5
#: fault (H100): logits 0.03125-0.0352 against 0.344 (K5 fed q with its
#: last of hd's terms zeroed; q scaled twice 2.05, the mask off 4.97);
#: gradients 3.02e-6 to 4.46e-6 against 0.21 (the same fault; the
#: backward's faults 2.28-9.87); the loss up to 9.54e-7 (one float32 ulp
#: at ~11.3) against 2.09e-4 (the same fault; the backward's faults leave
#: the loss as it is).
WHISPER_ARCH, WHISPER_FRAME_STD = "whisper-medium", 1.0
WHISPER_SLICE_TOL = 0.11
WHISPER_TRAIN_SLICE_TOL, WHISPER_TRAIN_SLICE_LOSS_TOL = 1e-3, 1.4e-5
#: K5's checks at (64, 64), bf16 through the model's views: (B, H, KV, S,
#: T, causal): the cross attention (S 1, 63 and 512 against T 1,500), the
#: encoder (S = T = 1,500, a ragged last tile), the decoder (S = T = 512,
#: causal) and two query heads a KV head (S = T = 445); and the shapes it is
#: timed at (B 4, H 16): (name, S, T, causal).
WHISPER_K5_CASES = ((2, 4, 4, 1, 1500, False), (2, 4, 4, 63, 1500, False),
                    (2, 4, 4, 512, 1500, False), (2, 4, 4, 1500, 1500, False),
                    (2, 4, 4, 512, 512, True), (2, 6, 3, 445, 445, True),
                    (2, 6, 3, 445, 445, False))
WHISPER_K5_TIMED = (("encoder", 1500, 1500, False),
                    ("cross attention", 512, 1500, False),
                    ("decoder", 512, 512, True))
#: An H100 SXM's special-function (multi-function unit) rate: 16 results
#: a clock an SM (the CUDA C++ guide's throughput table for compute
#: capability 9.0), 132 SMs, 1.98 GHz: K7's exponentials.
MUFU_OPS_PER_S = 16 * 132 * 1.98e9
#: Hymba-1.5B (the hybrid family: a Mamba head beside GQA attention in
#: each of its 32 layers, 25 query heads on 5 KV heads at hd 64, a sliding
#: window of 1,024 on every layer but 0, 16 and 31; K5 at (64, 64) with the
#: window, K7 on every Mamba head, d_inner 1,600, N 16).  Its serve takes
#: the serve's batch and requests with prompts of HYBRID_PROMPT tokens
#: (past the window, so its windowed layers mask); its training path
#: TRAIN_STEPS steps of TRAIN_B x HYBRID_TRAIN_S packed tokens at TRAIN_LR
#: with remat; both at the published 32 layers (~21 GB of training state).
HYBRID_ARCH = "hymba-1.5b"
HYBRID_PROMPT, HYBRID_TRAIN_S = (1100, 2048), 2048
#: K5's window checks: at Hymba's width, bf16 on wgmma through the model's
#: views, the timed shape (B, H, KV, S, window) and the edges (windows 1,
#: 63, 64, 65, 1,023 and past S; 5, 1 and 5 query heads a KV head); on the
#: fma route (B, H, KV, S, hd, dtype, window): hd 16 and float32.
HYBRID_K5 = (4, 25, 5, 2048, 1024)
HYBRID_K5_EDGES = ((1, 5, 1, 300, 1), (1, 5, 1, 300, 63), (1, 5, 1, 300, 64),
                   (1, 5, 1, 300, 65), (2, 10, 2, 1100, 1023),
                   (1, 5, 5, 700, 5000))
HYBRID_K5_FMA = ((2, 4, 2, 200, 16, "float32", 8),
                 (2, 4, 2, 200, 16, "bfloat16", 5),
                 (2, 5, 1, 300, 64, "float32", 70))
#: K7's checks (B, S, d_inner, N, with a state): Hymba's prefill (timed), a
#: decode step, float32 at N 4 and 16 across the checkpoint interval, and
#: d_inner past a whole block (32 channels) with element copies into the
#: ring: bf16 at N 16 (d_inner not a multiple of 8), float32 at N 3
#: (d_inner odd); S past a whole chunk and checkpoint interval.
HYBRID_K7 = ((4, 2048, 1600, 16, False), (4, 1, 1600, 16, True),
             (2, 130, 40, 4, True), (1, 65, 8, 16, True),
             (2, 77, 36, 16, True), (3, 77, 37, 3, True))
#: The Hymba slices: HYBRID_SLICE_LAYERS layers at full width (layer 1
#: windowed).  The serve slice: SLICE_B x HYBRID_SLICE_S prompt positions
#: (past the 1,024 window) and SLICE_STEPS decode steps: the decode
#: steps' largest |logit difference| HYBRID_SLICE_TOL and the prompt
#: positions' median largest |logit difference| HYBRID_SLICE_PROMPT_TOL
#: (the prompt's largest is no limit: bf16 noise through the Mamba heads
#: reaches 0.71-2.9 at a few positions in sound runs).  The train slice:
#: float32, the window cut to HYBRID_TRAIN_SLICE_WINDOW so that it masks
#: within TRAIN_SLICE_B x HYBRID_TRAIN_SLICE_S tokens; the largest
#: gradient difference relative to its leaf's largest entry and |loss
#: difference| (HYBRID_TRAIN_SLICE_TOL, HYBRID_TRAIN_SLICE_LOSS_TOL).
#: Each set from ``python3 chip_smoke.py --hybrid`` (its readings: seeds
#: 0-2, sound and with K5's window one key wider or K7's state not carried
#: on the card's side) near the geometric mean of the sound runs' reach
#: and the nearest fault's (H100): decode steps 0.206 against 3.42 (the
#: state not carried; the window's fault moves the bf16 slice within its
#: noise, the float32 train slice sees it); gradients 0.00555 against
#: 0.473 (the window one key wider), the loss 9.54e-7 against 0.00171.
HYBRID_SLICE_LAYERS, HYBRID_SLICE_S = 4, 1150
HYBRID_SLICE_TOL, HYBRID_SLICE_PROMPT_TOL = 0.8, 0.3
HYBRID_TRAIN_SLICE_S, HYBRID_TRAIN_SLICE_WINDOW = 128, 48
HYBRID_TRAIN_SLICE_TOL, HYBRID_TRAIN_SLICE_LOSS_TOL = 0.05, 4e-5


class Family(NamedTuple):
    """A model whose decoder reads rows ahead of its text, as the
    ``family_*`` phases run it: InternVL2-2B's patch rows in the decoder's
    own sequence, Whisper-medium's frames through its encoder.  ``extra``
    is the batch's key for the rows and ``rows`` the config's field that
    counts them (``rows_name`` in the logs); the slices seed them at
    ``std``, the training path makes them with ``train_rows(torch,
    shape)`` (``train_rows_name``); ``prefill_k5`` and ``step_k5`` count
    K5's forward calls, from the config, in a model call over a whole
    sequence and in a decode step; then the slice limits."""
    arch: str
    label: str
    extra: str
    rows: str
    rows_name: str
    train_rows_name: str
    std: float
    train_rows: Callable
    prefill_k5: Callable
    step_k5: Callable
    slice_tol: float
    train_slice_tol: float
    train_slice_loss_tol: float


VLM = Family(
    arch=VLM_ARCH, label="InternVL2-2B", extra="patches", rows="n_patches",
    rows_name="patch rows", train_rows_name="seeded patch rows",
    std=VLM_PATCH_STD,
    train_rows=lambda torch, shape: randn(torch, 0, shape, torch.bfloat16,
                                          VLM_PATCH_STD),
    prefill_k5=lambda cfg: cfg.n_layers, step_k5=lambda cfg: 0,
    slice_tol=VLM_SLICE_TOL, train_slice_tol=VLM_TRAIN_SLICE_TOL,
    train_slice_loss_tol=VLM_TRAIN_SLICE_LOSS_TOL)
#: Whisper runs K5 once an encoder layer and twice a decoder layer (its
#: causal self attention and its cross attention), and in a decode step
#: once a decoder layer (the cross attention of one query row).
WHISPER = Family(
    arch=WHISPER_ARCH, label="Whisper-medium", extra="frames",
    rows="enc_seq", rows_name="frames", train_rows_name="zero frames",
    std=WHISPER_FRAME_STD,
    train_rows=lambda torch, shape: torch.zeros(shape, dtype=torch.bfloat16,
                                                device="cuda"),
    prefill_k5=lambda cfg: cfg.n_enc_layers + 2 * cfg.n_layers,
    step_k5=lambda cfg: cfg.n_layers,
    slice_tol=WHISPER_SLICE_TOL, train_slice_tol=WHISPER_TRAIN_SLICE_TOL,
    train_slice_loss_tol=WHISPER_TRAIN_SLICE_LOSS_TOL)


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


def time_ms(torch, fn, args, reps: int, warm: int = 3) -> float:
    """``fn(*args)``'s time a call by CUDA events over ``reps`` calls, after
    ``warm`` calls (a plain version that takes seconds a call needs
    none)."""
    for _ in range(warm):
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
        return (self.label,) + tuple(
            None if a is None else (tuple(a.shape), str(a.dtype))
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


class RowsRecorder(Recorder):
    """The recorder of K4's forward that also adds up the ``rows`` of every
    call, on the card (no readback until it is read)."""

    def __init__(self, module, name: str):
        super().__init__(module, name)
        self.rows = 0

    def __call__(self, *args, **kw):
        rows = args[2] if len(args) > 2 else kw.get("rows")
        if rows is not None:
            self.rows = self.rows + rows.long().sum()
        return super().__call__(*args, **kw)


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
    so 2^-7 of the larger for the two.  The tensor cores flush subnormal
    values to zero where the plain version's float32 keeps them: each of
    the D products and the output may lose up to 2^-126, so (D + 1) 2^-126
    more (gradients hold such values).  With ``rows``, every row past
    rows[e] must be exactly zero, whatever x holds there.  Returns
    max |got - plain|."""
    from repro_torch.kernels import ref
    want = ref.segment_matmul(x, w, rows)
    check(got.shape == want.shape and got.dtype == want.dtype,
          f"{what}: {tuple(got.shape)} {got.dtype} vs plain "
          f"{tuple(want.shape)} {want.dtype}")
    D = x.shape[2]
    absum = torch.bmm(x.float().abs(), w.float().abs())
    tol = 2 * D * 2.0**-24 * absum + (D + 1) * 2.0**-126
    if x.dtype == torch.bfloat16:
        tol = tol + 2.0**-7 * torch.maximum(got.float().abs(),
                                            want.float().abs())
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < rows.long()[:, None])
        tol = torch.where(live[..., None], tol, 0.0)
    err = (got.float() - want.float()).abs()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    if not bool((err <= tol).all()):
        at = tuple(int(i) for i in torch.nonzero(err > tol)[0])
        check(False,
              f"{what}: beyond the stated bound of the plain version (max "
              f"|err| {float(err.max()):.3g}; at {at}: kernel "
              f"{float(got[at]):.6g}, plain {float(want[at]):.6g}, bound "
              f"{float(tol[at]):.3g}, sum of |x w| {float(absum[at]):.3g}"
              f"{'' if rows is None else f', rows {int(rows[at[0]])}'})")
    return float(err.max()) if err.numel() else 0.0


def check_flash(torch, what: str, got, q, k, v, causal: bool,
                scale: float, window=None) -> float:
    """K5 against its plain version: both are float32 arithmetic on the
    same inputs; l and acc are float32 sums of up to T terms, each within
    T * 2^-24 of its exact value relative to the sum of magnitudes, so the
    outputs lie within 2 * T * 2^-24 * max|v| of each other, plus 3e-5 for
    the exponentials (``tests/test_kernels.py``'s absolute tolerance).
    ``window``: a causal call's sliding window, the plain version's too.
    Returns max |got - plain|."""
    from repro_torch.kernels import ref
    want = ref.flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)
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


def visible_pairs(S: int, T: int, causal: bool, window=None) -> int:
    """The (query, key) pairs attention computes on one head: S T full,
    S (S + 1) / 2 causal, and with a sliding window W (causal, S == T)
    W (W + 1) / 2 + (S - W) W, each row its last W keys."""
    if not causal:
        return S * T
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def k5_bound(B: int, H: int, KV: int, S: int, T: int, hd: int, causal: bool,
             dtype_bytes: int, dv: Optional[int] = None, window=None):
    """Least time: the operations per visible (query, key) pair vs q, k, v
    read once (q and k ``hd`` wide, v ``dv``, default ``hd``) and the
    float32 output (``dv`` wide) written once.  bf16 at a pair of the wgmma
    route (``WGMMA_WIDTHS``): 2 hd for Q K^T and 4 dv for P V (P is
    float32, split into bf16 hi and lo: two products), all at the bf16
    tensor-core rate.  Other calls (the fma route): 2 hd for Q K^T, at the
    bf16 tensor-core rate for bf16 inputs (their products are exact in
    float32) and the float32 CUDA-core rate for float32 ones, and 2 dv for
    P V at the float32 rate.  With a sliding ``window`` only its visible
    pairs count (``visible_pairs``)."""
    from repro_torch.kernels.flash_attention import WGMMA_WIDTHS
    dv = hd if dv is None else dv
    pairs = visible_pairs(S, T, causal, window) * B * H
    qk, pv = 2.0 * hd * pairs, 2.0 * dv * pairs
    if dtype_bytes == 2 and (hd, dv) in WGMMA_WIDTHS:
        t_ops = (qk + 2 * pv) / BF16_TC_OPS_PER_S * 1e3
    else:
        qk_rate = BF16_TC_OPS_PER_S if dtype_bytes == 2 else FP32_OPS_PER_S
        t_ops = (qk / qk_rate + pv / FP32_OPS_PER_S) * 1e3
    t_bytes = (dtype_bytes * (hd * (B * H * S + B * KV * T) + dv * B * KV * T)
               + 4 * B * H * S * dv) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def randn(torch, seed: int, shape, dtype, scale: float = 1.0):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def sass_counts(source: str):
    """Per kernel function of the library of ``csrc/<source>.cu``, from
    ``cuobjdump -sass`` beside nvcc: its HGMMA (wgmma) instructions, its
    local-memory loads and stores (LDL / STL: spills), and the highest
    register it names plus one (past the count ptxas reports where
    setmaxnreg raised it): {mangled name: (hgmma, local, registers)}."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(tool), "-sass", str(_build.library_path(source))],
        capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = [0, 0, 0]
        elif fn is not None:
            c = counts[fn]
            c[0] += "HGMMA" in line
            c[1] += bool(re.search(r"\b(LDL|STL)\b", line))
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            c[2] = max([c[2]] + [r + 1 for r in regs])
    return {fn: tuple(c) for fn, c in counts.items()}


#: K5's wgmma kernels and the (dk, dv) instances of each the build holds.
K5_WGMMA_KERNELS = ("flash_wgmma", "flash_bwd_dkv_wgmma",
                    "flash_bwd_dq_wgmma")
#: K7's kernels, whose registers hold a lane's states (and in the backward
#: a chunk's states and decays): the build fails if ptxas spills them.
K7_KERNELS = ("mamba_scan_kernel", "mamba_scan_bwd_kernel")


def check_sass() -> None:
    """K4's tiles kernel (each of its forms: the forward, dx and dw), each
    width of its stream kernel, and K5's wgmma kernel and the two kernels
    of its backward's wgmma route at each pair of ``WGMMA_WIDTHS`` run
    wgmma; each kernel's spills and registers are logged."""
    from repro_torch.kernels.flash_attention import WGMMA_WIDTHS
    for source, kernels in (("segment_matmul", ("seg_mm_tiles",
                                                "seg_mm_stream")),
                            ("flash_attention", K5_WGMMA_KERNELS)):
        counts = sass_counts(source)
        for kernel in kernels:
            found = {fn: c for fn, c in counts.items() if kernel in fn}
            check(found and all(c[0] > 0 for c in found.values()),
                  f"build: {kernel} has no wgmma (HGMMA) in its SASS: "
                  f"{found}")
            if source == "flash_attention":
                for dk, dv in WGMMA_WIDTHS:
                    tag = f"ILi{dk}ELi{dv}E"
                    check(any(tag in fn for fn in found),
                          f"build: no {kernel} at ({dk}, {dv}) in the "
                          f"library: {list(found)}")
            for fn, (n, local, regs) in found.items():
                log(f"build: {source}: {n} HGMMA (wgmma) instructions in "
                    f"{fn}; {local} local loads / stores; registers up to "
                    f"R{regs - 1}")


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


def time_k5(torch, k5, q, k, v, reps: int, causal: bool = True,
            window=None):
    """(kernel ms, plain ms, scaled_dot_product_attention ms, bound ms,
    bound_by), causal or full, at q's scale (``hd ** -0.5``, q and k
    ``hd`` wide, v ``dv``); with a sliding ``window`` SDPA takes it as a
    boolean mask (``window_mask``)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    B, H, S, hd = q.shape
    KV, T, dv = k.shape[1], k.shape[2], v.shape[3]
    ms = time_ms(torch, lambda *a: k5.flash_attention(
        *a, causal=causal, window=window), (q, k, v), reps)
    plain_ms = time_ms(torch, lambda *a: ref.flash_attention(
        *a, causal=causal, window=window), (q, k, v), max(reps // 4, 3))
    kw = dict(is_causal=causal)
    if window is not None:
        kw = dict(attn_mask=window_mask(torch, S, window, q.device))
    if KV != H:
        kw["enable_gqa"] = True
    lib_ms = time_ms(torch, lambda *a: F.scaled_dot_product_attention(*a, **kw),
                     (q, k, v), reps)
    return (ms, plain_ms, lib_ms) + k5_bound(B, H, KV, S, T, hd, causal,
                                             q.element_size(), dv, window)


def window_mask(torch, S: int, window: int, device):
    """[S, S] bool, True where query i sees key j (i - window < j <= i):
    a sliding window as ``scaled_dot_product_attention`` takes it."""
    i = torch.arange(S, device=device)
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


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
def serve_phase(torch, kernel_mods, arch: str, recs, prompt=SERVE_PROMPT):
    """Serve SERVE_REQUESTS requests through ``arch`` at full width (every
    layer, float32 weights from seed 0, bf16 compute) with ``ServeEngine``
    on the card, prompts of ``prompt`` = (least, most) tokens, every
    kernel's count set to 0 just before and read just after, the recorders
    ``recs`` standing in for their kernels (each keeps the first call at
    each shape, labelled prefill or decode).  Returns (launches per kernel,
    a summary dict)."""
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
    lengths = rng.integers(prompt[0], prompt[1] + 1, SERVE_REQUESTS)
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


def model_replay_phase(torch, k4, k5, k4_first, k5_first,
                       long_context: bool = True):
    """K4 and K5 against their plain versions on the inputs the serve gave
    them, timed beside the plain versions, one library call each and the
    bound; with ``long_context`` K5 also at OLMoE's 4096 tokens.  Returns
    (max errors, the JSON records' numbers per kernel)."""
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
        t = time_k5(torch, k5, q, k, v, 50, kw.get("causal", True))
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
    if not long_context:
        return errs, main
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

    cfg = get_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=2,
                              n_enc_layers=min(cfg.n_enc_layers, 2))
    gpu = init_params(cfg, seed, "cuda")
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (SLICE_B, SLICE_S + SLICE_STEPS)))
    return cfg, gpu, _to_cpu(gpu), toks


def slice_logits(torch, cfg, params, toks, dev: str, patches=None,
                 frames=None, steps: int = SLICE_STEPS):
    """The prefill of the first S = len(toks) - ``steps`` tokens (SLICE_S
    by default) at every position (behind ``patches``, the vlm family's
    patch rows, whose positions are not returned; over ``frames``, the
    encdec family's encoder input), then ``steps`` decode steps fed the
    next tokens (teacher forcing).  Returns float32 logits ``[B, S +
    steps, V]`` and each token's experts ``[B, S + steps, layers * k]``
    (sorted within a layer; None for a model without experts), on the
    host."""
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models import moe as moe_lib

    topk, calls = moe_lib.router_topk, []

    def routed(logits, top_k, **kw):
        weights, idx = topk(logits, top_k, **kw)
        calls.append(idx.sort(dim=-1).values.cpu())
        return weights, idx

    B, S = toks.shape[0], toks.shape[1] - steps

    def take(logits, n):
        out.append(logits.float().cpu())
        if calls:
            routes.append(torch.cat([c.reshape(B, n, -1)
                                     for c in calls], dim=-1))
            calls.clear()

    out, routes = [], []
    batch = {"tokens": toks[:, :S].to(dev)}
    n0 = 0
    if patches is not None:
        batch["patches"] = patches.to(dev)
        n0 = patches.shape[1]
    if frames is not None:
        batch["frames"] = frames.to(dev)
    with StandIn(moe_lib, "router_topk", routed):
        cache = init_cache(cfg, B, n0 + S + steps, dev)
        logits, cache = prefill(params, cfg, batch, cache, all_positions=True)
        take(logits[:, n0:], S)
        for i in range(S, S + steps):
            logits, cache = decode_step(params, cfg, toks[:, i:i + 1].to(dev),
                                        cache, n0 + i)
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


def rwkv_slice_compare(card, host, tol: float = RWKV_SLICE_TOL,
                       S: int = SLICE_S):
    """Card against host at every token: the largest |logit difference|
    (over the prompt's S positions and per decode step), and the greedy
    tokens, compared where the card's top-2 margin exceeds ``tol``."""
    lc, lh = card[0], host[0]
    err = (lc - lh).abs().amax(dim=-1)                  # [B, P]
    top2 = lc.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tol
    same = lc.argmax(-1) == lh.argmax(-1)
    return dict(err=float(err.max()), prompt_err=float(err[:, :S].max()),
                steps=[float(e) for e in err[:, S:].amax(dim=0)],
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
# 10. train: K4's and K5's backward, OLMoE-1B-7B trained at full width   #
# --------------------------------------------------------------------- #
def check_flash_bwd(torch, what: str, got, q, k, v, out, dout, causal: bool,
                    scale: float, route: str = "fma", window=None) -> float:
    """K5's backward against its plain version (``ref.flash_attention_bwd``
    on the same inputs), both float32 arithmetic, entry by entry.  A float32
    sum of n terms in any order lies within n 2^-24 of the sum of its terms'
    magnitudes, so two orders within twice that.  P's relative error e_p:
    twice the scores' (hd-term dot products of scale q and k) and the row's
    log-sum-exp's (T terms), plus 2^-21 for expf.  dS = P (dO v - D): e_p
    |dS| plus P times the error of dO v - D (two hd-term sums).  Each
    gradient: its terms' errors times their factors' magnitudes, plus the
    order of its own sum (n = max(S rep, T)).  A bf16 output adds one
    rounding on each side, 2^-7 of the larger.  Returns max |got - plain|.

    ``route="wgmma"`` (bf16 at hd 128: every product on the tensor cores,
    its float32 operands split into bf16 hi + lo) adds four terms to that
    bound, derived so: bf16 keeps 8 significant bits, so |x - hi| <= 2^-8
    |x|, and lo = bf16(x - hi) (x - hi is exact in float32) leaves
    |x - hi - lo| <= 2^-8 |x - hi| <= 2^-16 |x|.
    * dO split: dP = v (hi + lo)^T misses v dO^T by at most 2^-16
      sum_d |dO| |v|, so dS's error gains 2^-16 P times the magnitude of
      dO v - D;
    * dS split before dK = dS^T q and dQ = dS k: 2^-16 |dS| more a term;
    * dV = P_hi dO_hi + P_lo dO_hi + P_hi dO_lo drops P_lo dO_lo (at most
      2^-16 (1 + 2^-8)^2 |P| |dO|) and the two residuals (2^-16 (1 +
      2^-16) |P| |dO| each): under 2^-14 |P| |dO|, so dV's factor gains
      2^-14;
    * P = exp(s - lse) with the forward's lse: its l sums __expf values,
      each within (2 + 1.173 x) units of 2^-23 relative at x = m - s <= 2
      max|s| (the CUDA guide's bound on __expf), so lse lies within
      (2 + 2.35 max|s|) 2^-23 of l's exact log, which e_p gains.
    The fma route's bound is the first paragraph's, unchanged.  A sliding
    ``window`` masks the plain version's scores and the bound's alike."""
    from repro_torch.kernels import ref
    want = ref.flash_attention_bwd(q, k, v, out, dout, causal=causal,
                                   scale=scale, window=window)
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    eps = 2.0**-24
    qs = q.float() * scale
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    do = dout.float()
    s = torch.einsum("bhsd,bhtd->bhst", qs, kf)
    if causal:
        vis = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        if window is not None:
            vis = window_mask(torch, S, window, q.device)
        s = torch.where(vis, s, float("-inf"))
    P = torch.softmax(s, -1)
    del s
    smax = float(torch.einsum("bhsd,bhtd->bhst", qs.abs(), kf.abs()).amax())
    e_p = 2 * (2 * hd * eps * smax + 2 * T * eps) + 2.0**-21
    split = dv_split = 0.0
    if route == "wgmma":
        e_p += (2 + 2.35 * smax) * 2.0**-23
        split, dv_split = 2.0**-16, 2.0**-14
    ds = P * (torch.einsum("bhsd,bhtd->bhst", do, vf)
              - (do * out.float()).sum(-1, keepdim=True))
    mag_dp = (torch.einsum("bhsd,bhtd->bhst", do.abs(), vf.abs())
              + (do * out.float()).abs().sum(-1, keepdim=True))
    n = max(S * rep, T)
    term = ((e_p + split + 2 * n * eps) * ds.abs()
            + (4 * hd * eps + split) * P * mag_dp)
    del ds, mag_dp
    tols = [scale * torch.einsum("bhst,bhtd->bhsd", term, kf.abs()),
            torch.einsum("bhst,bhsd->bhtd", term, qs.abs()),
            (e_p + 2 * n * eps + dv_split)
            * torch.einsum("bhst,bhsd->bhtd", P, do.abs())]
    del term, P
    if rep > 1:
        tols[1:] = [t.reshape(B, KV, rep, T, -1).sum(2) for t in tols[1:]]
    err = 0.0
    for name, g, w, tol in zip(("dq", "dk", "dv"), got, want, tols):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}: {name} {tuple(g.shape)} {g.dtype} vs plain "
              f"{tuple(w.shape)} {w.dtype}")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        if g.dtype == torch.bfloat16:
            tol = tol + 2.0**-7 * torch.maximum(g.float().abs(),
                                                w.float().abs())
        e = (g.float() - w.float()).abs()
        check(bool((e <= tol).all()),
              f"{what}: {name} beyond the stated bound of the plain version "
              f"(max |err| {float(e.max()):.3g})")
        err = max(err, float(e.max()))
    return err


def k5_bwd_bound(B: int, H: int, KV: int, S: int, T: int, hd: int,
                 causal: bool, dtype_bytes: int, route: str = "fma",
                 dv: Optional[int] = None, window=None):
    """Least time of K5's backward, q and k ``hd`` wide and v ``dv``
    (default ``hd``): on the ``fma`` route, per visible (query, key) pair,
    the scores once (2 hd, at the bf16 tensor-core rate for bf16 inputs,
    whose products are exact in float32, else the float32 rate) and dO v
    (2 dv), dS k and dS^T q (2 hd each) and P^T dO (2 dv) on float32
    operands, at the float32 rate; on the ``wgmma`` route the products it
    does, each once, at the bf16 tensor-core rate: S 2 hd, dP 4 dv (dO's hi
    and lo), dV 6 dv (three of P's and dO's four hi / lo pairs), dK 4 hd
    and dQ 4 hd (dS's hi and lo), 10 hd + 10 dv a pair; or q, k, v read and
    dq, dk, dv written in their dtype, out and dout read in float32 (and
    the lse on the wgmma route), once.  With a sliding ``window`` only its
    visible pairs count (``visible_pairs``)."""
    dv = hd if dv is None else dv
    pairs = visible_pairs(S, T, causal, window) * B * H
    if route == "wgmma":
        t_ops = (10.0 * hd + 10.0 * dv) * pairs / BF16_TC_OPS_PER_S * 1e3
    else:
        qk_rate = BF16_TC_OPS_PER_S if dtype_bytes == 2 else FP32_OPS_PER_S
        t_ops = (2.0 * hd * pairs / qk_rate
                 + (4.0 * hd + 4.0 * dv) * pairs / FP32_OPS_PER_S) * 1e3
    t_bytes = (2 * dtype_bytes * (hd * (B * H * S + B * KV * T)
                                  + dv * B * KV * T)
               + 2 * 4 * B * H * S * dv
               + (4 * B * H * S if route == "wgmma" else 0)) \
        / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k4_bwd_bound(E: int, C: int, D: int, F: int, dtype_bytes: int, rows):
    """Least time of K4's backward (dx = dout w^T, dw = x^T dout) with
    ``rows`` (E counts): 2 sum(rows) D F operations each at the bf16
    tensor-core rate (the float32 rate for float32), or the live rows of
    dout and x, the weights of the experts with rows > 0 read and all of
    dx and dw written, once."""
    counts = [min(max(int(r), 0), C) for r in rows]
    live, used = sum(counts), sum(1 for r in counts if r > 0)
    rate = BF16_TC_OPS_PER_S if dtype_bytes == 2 else FP32_OPS_PER_S
    t_ops = 2 * 2.0 * live * D * F / rate * 1e3
    t_bytes = dtype_bytes * (live * (F + D) + used * D * F + E * C * D
                             + E * D * F) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def seg_bwd_products(torch, dout, x, w, rows):
    """The two products of K4's backward as explicit K4 calls: (dout, w^T,
    rows) for dx and (x^T, dout) for dw, x and dout zeroed past ``rows``
    (every row without them)."""
    xz, dz = x, dout
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :, None]
                < rows.long()[:, None, None])
        xz = torch.where(live, x, x.new_zeros(()))
        dz = torch.where(live, dout, dout.new_zeros(()))
    return ((dout, w.transpose(1, 2).contiguous(), rows),
            (xz.transpose(1, 2).contiguous(), dz, None))


def check_seg_bwd(torch, k4, what: str, got, dout, x, w, rows) -> float:
    """K4's backward against its plain version: each of its two products
    within ``check_segment_matmul``'s bound (dw's contraction runs over
    the live rows only: x and dout zeroed past ``rows``)."""
    return max(check_segment_matmul(torch, f"{what} {name}", g, *args)
               for name, g, args in zip(
                   ("dx", "dw"), got,
                   seg_bwd_products(torch, dout, x, w, rows)))


def check_lse(torch, what: str, lse, q, k, v, causal: bool,
              scale: float, window=None) -> float:
    """K5's log-sum-exp against its plain version's: the scores differ by
    at most 2 hd 2^-24 max sum|scale q k| (another order, the scale applied
    after the product), l by (2 + 2.35 max|s|) 2^-23 relative (the
    forward's __expf, ``check_flash_bwd``) and 2 T 2^-24 (the order of its
    sum), the log and the add by 2^-23 of |lse| more.  Returns the largest
    error."""
    from repro_torch.kernels import ref
    _, want = ref.flash_attention(q, k, v, causal=causal, scale=scale,
                                  return_lse=True, window=window)
    rep = q.shape[1] // k.shape[1]
    smax = float(torch.einsum("bhsd,bhtd->bhst", q.float().abs() * scale,
                              k.float().abs().repeat_interleave(rep, 1))
                 .amax())
    T = k.shape[2]
    tol = ((2 * q.shape[-1] * smax + 2 * T) * 2.0**-24
           + (2 + 2.35 * smax) * 2.0**-23 + 2.0**-23 * want.abs())
    err = (lse - want).abs()
    check(lse.shape == want.shape and bool((err <= tol).all()),
          f"{what}: lse beyond the stated bound of the plain version's (max "
          f"|err| {float(err.max()):.3g})")
    return float(err.max())


def train_kernel_phase(torch, k4, k5) -> dict:
    """K5's backward against its plain version on both routes, each within
    its bound (``check_flash_bwd``), its launches counted by route in
    ``bwd_routes`` and the same bits from two calls: ``wgmma`` (bf16 at hd
    128) at the training shape (B 4, H 16, S 512 through the model's
    ``[B, S, H, hd]`` views) and at S 445 with 3 query heads a KV head,
    causal and full, and at S 445, hd 64, 2 query heads a KV head (bf16,
    Whisper's width); ``fma`` at the training shape in float32 and at S
    445, 2 query heads a KV head, hd 32 in bf16 (no wgmma width) and hd 64
    in float32.  The forward fed to
    it is held against K5's plain version, gives the same output bits with
    and without its lse, and (wgmma) its lse is within ``check_lse``'s
    bound; the planted faults "K5 backward drops D" and "K5 backward mask
    off" must exceed the wgmma route's bound at the training shape.  K4's
    backward (dx and dw, two launches) against its plain version at OLMoE's
    expert products with 8 replica slots (E 72, D 2048, F 1024 and back,
    C 320: the training capacity; every case of ``k4_rows_cases`` at the
    first) and C 20 (the 2-layer slice's), ragged rows and NaN in x past
    them, bf16 on the tiles kernel's dx and dw forms and float32 on K4's
    fma kernel over copies, and at D 40, F 130 in bf16 (no multiple of 8:
    the copies and the wmma kernel).  Returns the largest error of each."""
    errs = {"flash_attention_bwd": 0.0, "segment_matmul_backward": 0.0,
            "flash_attention": 0.0}
    seed = 200
    faults = 0
    for B, H, KV, S, hd, dtype, views, causal in (
            (TRAIN_B, 16, 16, TRAIN_S, 128, torch.bfloat16, True, True),
            (TRAIN_B, 16, 16, TRAIN_S, 128, torch.float32, True, True),
            (2, 6, 2, 445, 128, torch.bfloat16, False, True),
            (2, 6, 2, 445, 128, torch.bfloat16, False, False),
            (2, 6, 3, 445, 64, torch.bfloat16, False, True),
            (2, 6, 3, 445, 32, torch.bfloat16, False, True),
            (2, 6, 3, 445, 64, torch.float32, False, True)):
        seed += 3
        shapes = [(B, S, h, hd) if views else (B, h, S, hd)
                  for h in (H, KV, KV)]
        q, k, v = (randn(torch, seed + i, s, dtype) for i, s in
                   enumerate(shapes))
        if views:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        scale = hd ** -0.5
        what = (f"flash_attention_bwd B={B} H={H} KV={KV} S={S} hd={hd} "
                f"{dtype}{' views' if views else ''} causal={causal}")
        route = ("wgmma" if dtype == torch.bfloat16
                 and (hd, hd) in k5.WGMMA_WIDTHS else "fma")
        out, lse = k5_call(k5, what, route, q, k, v, causal=causal,
                           scale=scale, return_lse=True)
        check(torch.equal(k5_call(k5, what, route, q, k, v, causal=causal,
                                  scale=scale), out),
              f"{what}: the forward gives other bits with its lse")
        check((lse is None) == (route == "fma"),
              f"{what}: the {route} forward's lse is {lse}")
        if lse is not None:
            check_lse(torch, what, lse, q, k, v, causal, scale)
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, f"{what} (the forward)", out, q, k, v, causal, scale))
        dout = randn(torch, seed + 9, (B, H, S, hd), torch.float32)
        kw = dict(lse=lse, causal=causal, scale=scale)
        before = (k5.flash_attention_bwd.launches, dict(k5.bwd_routes))
        got = k5.flash_attention_bwd(q, k, v, out, dout, **kw)
        n = k5.BWD_LAUNCHES[route]
        took = {r: c - before[1][r] for r, c in k5.bwd_routes.items()
                if c > before[1][r]}
        check(k5.flash_attention_bwd.launches == before[0] + n
              and took == {route: n},
              f"{what}: launched {took}, not {n} on the {route} route")
        check(all(torch.equal(a, b) for a, b in zip(
            got, k5.flash_attention_bwd(q, k, v, out, dout, **kw))),
              f"{what}: two calls give other bits")
        errs["flash_attention_bwd"] = max(
            errs["flash_attention_bwd"],
            check_flash_bwd(torch, what, got, q, k, v, out, dout, causal,
                            scale, route))
        if route == "wgmma" and views:
            for name, _, _, fault in train_planted_faults(k4, k5)[:2]:
                try:
                    check_flash_bwd(torch, f"{what} ({name})",
                                    fault(q, k, v, out, dout, **kw), q, k, v,
                                    out, dout, causal, scale, route)
                except SmokeFailure:
                    faults += 1
                    continue
                check(False, f"{what}: the planted fault '{name}' stays "
                             f"within the wgmma route's bound")
        del q, k, v, out, lse, dout, got
    seg_routes = dict.fromkeys(k4.BWD_ROUTES, 0)
    for E, C, D, F, dtypes in ((72, 320, 2048, 1024, "both"),
                               (72, 320, 1024, 2048, "both"),
                               (72, 20, 2048, 1024, "both"),
                               (3, 67, 40, 130, "bf16")):
        for dtype in ((torch.bfloat16, torch.float32) if dtypes == "both"
                      else (torch.bfloat16,)):
            seed += 3
            x = randn(torch, seed, (E, C, D), dtype, 0.5)
            w = randn(torch, seed + 1, (E, D, F), dtype, D ** -0.5)
            dout = randn(torch, seed + 2, (E, C, F), dtype)
            cases = k4_rows_cases(torch, E, C, seed)
            tma = dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
            want = ({"dx_tiles": 1, "dw_tiles": 1} if tma else
                    {"fma" if dtype == torch.float32 else "wmma": 2})
            every = (E, C, D, dtype) == (72, 320, 2048, torch.bfloat16)
            for case, rows in (cases if every else cases[3:]):
                xc = x
                if rows is not None:
                    dead = (torch.arange(C, device="cuda")[None, :]
                            >= rows.long()[:, None])
                    xc = x.masked_fill(dead[..., None], float("nan"))
                what = (f"segment_matmul_backward E={E} C={C} D={D} F={F} "
                        f"{dtype} {case}")
                before = (k4.segment_matmul_backward.launches,
                          dict(k4.bwd_routes))
                got = k4.segment_matmul_backward(dout, xc, w, rows)
                took = {r: c - before[1][r] for r, c in k4.bwd_routes.items()
                        if c > before[1][r]}
                check(k4.segment_matmul_backward.launches == before[0] + 2
                      and took == want, f"{what}: launched {took}, not {want}")
                for r, c in took.items():
                    seg_routes[r] += c
                errs["segment_matmul_backward"] = max(
                    errs["segment_matmul_backward"],
                    check_seg_bwd(torch, k4, what, got, dout, xc, w, rows))
                del xc, got
            del x, w, dout
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    seg_routes = {r: c for r, c in seg_routes.items() if c}
    log(f"train kernels: flash_attention_bwd within the stated bound of its "
        f"plain version on the wgmma route at B={TRAIN_B} H=16 S={TRAIN_S} "
        f"hd=128 (bf16 from [B, S, H, hd] views) and S=445 rep 3 (causal "
        f"and full) and S=445 hd=64 rep 2 (bf16), and on the fma route at "
        f"the training shape in float32 and S=445 rep 2 at hd=32 (bf16) and "
        f"hd=64 (float32), the same bits from two "
        f"calls, the forward's bits the same with its lse (max |err| "
        f"{errs['flash_attention_bwd']:.3g}; the forward fed to it "
        f"{errs['flash_attention']:.3g}); {faults} planted faults beyond the "
        f"wgmma route's bound; segment_matmul_backward within "
        f"check_segment_matmul's bound at E=72 D/F 2048/1024 both ways, C "
        f"320 and 20, bf16 and float32, and D=40 F=130 bf16, ragged rows "
        f"with NaN past them (max |err| "
        f"{errs['segment_matmul_backward']:.3g}; launches by route "
        f"{seg_routes})")
    return errs


def mla_kernel_phase(torch, k4, k5) -> dict:
    """K5 forward and backward at MLA's (dk, dv) pairs (MiniCPM3-4B's
    (96, 64), DeepSeek-V2-Lite's (192, 128), the smoke configurations'
    (24, 16)) against their plain versions, each route the pair has:
    bf16 through the model's ``[B, S, H, d]`` views (S 1, 63, 445, 512,
    causal; the forward on ``wgmma`` where ``WGMMA_WIDTHS`` holds the pair,
    with its lse within ``check_lse``'s bound and its output the same bits
    without it), bf16 with 2 query heads a KV head, full (S 300), and
    float32 (S 200, causal; the fma kernels).  The backward on the route
    ``bwd_route`` gives (``wgmma`` for bf16 at (96, 64) and (192, 128),
    ``fma`` otherwise), its launches counted by route and two calls the
    same bits, within ``check_flash_bwd``'s bound; on ``wgmma`` the planted
    faults "drops D" and "mask off" must pass that route's bound (at S 512,
    and at (192, 128) also at ``MLA_BWD_EDGES``).  Returns the largest
    error of each."""
    errs = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    seed, faults, cases, tried = 500, 0, 0, 0
    for dk, dv in k5.MLA_WIDTHS:
        edges = tuple((B, H, KV, S, torch.bfloat16, views, True)
                      for B, H, KV, S, views in MLA_BWD_EDGES
                      if (dk, dv) == (192, 128))
        for B, H, KV, S, dtype, views, causal in (
                (2, 8, 8, 1, torch.bfloat16, True, True),
                (2, 8, 8, 63, torch.bfloat16, True, True),
                (2, 8, 8, 445, torch.bfloat16, True, True),
                (2, 8, 8, 512, torch.bfloat16, True, True),
                (2, 8, 4, 300, torch.bfloat16, False, False),
                (2, 8, 8, 200, torch.float32, False, True)) + edges:
            seed += 4
            shapes = [(B, S, h, d) if views else (B, h, S, d)
                      for h, d in ((H, dk), (KV, dk), (KV, dv))]
            q, k, v = (randn(torch, seed + i, s, dtype) for i, s in
                       enumerate(shapes))
            if views:
                q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            scale = dk ** -0.5
            what = (f"flash_attention (dk, dv) = ({dk}, {dv}) B={B} H={H} "
                    f"KV={KV} S={S} {dtype}{' views' if views else ''} "
                    f"causal={causal}")
            route = ("wgmma" if dtype == torch.bfloat16
                     and (dk, dv) in k5.WGMMA_WIDTHS else "fma")
            out, lse = k5_call(k5, what, route, q, k, v, causal=causal,
                               scale=scale, return_lse=True)
            check(out.shape == (B, H, S, dv), f"{what}: out "
                                              f"{tuple(out.shape)}")
            check(torch.equal(k5_call(k5, what, route, q, k, v,
                                      causal=causal, scale=scale), out),
                  f"{what}: the forward gives other bits with its lse")
            check((lse is None) == (route == "fma"),
                  f"{what}: the {route} forward's lse is {lse}")
            if lse is not None:
                check_lse(torch, what, lse, q, k, v, causal, scale)
            errs["flash_attention"] = max(errs["flash_attention"], check_flash(
                torch, what, out, q, k, v, causal, scale))
            if views:
                copies = [t.contiguous() for t in (q, k, v)]
                check(torch.equal(k5_call(k5, what, route, *copies,
                                          causal=causal, scale=scale), out),
                      f"{what}: a [B, S, H, d] view gives other bits than "
                      f"its contiguous copy")
                del copies
            dout = randn(torch, seed + 3, (B, H, S, dv), torch.float32)
            kw = dict(lse=lse, causal=causal, scale=scale)
            broute = k5.bwd_route(q, k, v)
            want = ("wgmma" if dtype == torch.bfloat16
                    and (dk, dv) in k5.WGMMA_WIDTHS else "fma")
            check(broute == want, f"{what}: the backward takes {broute}, not "
                                  f"{want}")
            before = (k5.flash_attention_bwd.launches, dict(k5.bwd_routes))
            got = k5.flash_attention_bwd(q, k, v, out, dout, **kw)
            n = k5.BWD_LAUNCHES[broute]
            took = {r: c - before[1][r] for r, c in k5.bwd_routes.items()
                    if c > before[1][r]}
            check(k5.flash_attention_bwd.launches == before[0] + n
                  and took == {broute: n},
                  f"{what}: the backward launched {took}, not {n} on the "
                  f"{broute} route")
            check(tuple(got[0].shape) == (B, H, S, dk)
                  and tuple(got[1].shape) == (B, KV, S, dk)
                  and tuple(got[2].shape) == (B, KV, S, dv),
                  f"{what}: gradients {[tuple(g.shape) for g in got]}")
            check(all(torch.equal(a, b) for a, b in zip(
                got, k5.flash_attention_bwd(q, k, v, out, dout, **kw))),
                  f"{what}: two backward calls give other bits")
            errs["flash_attention_bwd"] = max(
                errs["flash_attention_bwd"],
                check_flash_bwd(torch, what, got, q, k, v, out, dout, causal,
                                scale, broute))
            cases += 1
            if broute == "wgmma" and ((views and S == 512) or (
                    (B, H, KV, S, dtype, views, causal) in edges)):
                tried += 2
                for name, _, _, fault in train_planted_faults(k4, k5)[:2]:
                    try:
                        check_flash_bwd(torch, f"{what} ({name})",
                                        fault(q, k, v, out, dout, **kw), q, k,
                                        v, out, dout, causal, scale, broute)
                    except SmokeFailure:
                        faults += 1
                        continue
                    check(False, f"{what}: the planted fault '{name}' stays "
                                 f"within the wgmma route's bound")
            del q, k, v, out, lse, dout, got
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    check(tried == 2 * (sum(p in k5.WGMMA_WIDTHS for p in k5.MLA_WIDTHS)
                        + len(MLA_BWD_EDGES)),
          f"mla kernels: {tried} planted faults tried")
    check(faults == tried, f"mla kernels: {faults} of the {tried} planted "
                           f"faults passed the wgmma backward's bound")
    log(f"mla kernels: flash_attention at (dk, dv) in {k5.MLA_WIDTHS}, "
        f"{cases} cases (bf16 [B, S, H, d] views S 1-512 causal, rep 2 full, "
        f"float32; at (192, 128) also {MLA_BWD_EDGES}), forward within check_flash's bound (max |err| "
        f"{errs['flash_attention']:.3g}; wgmma at {k5.WGMMA_WIDTHS}, its lse "
        f"within check_lse's and the same bits without it), backward within "
        f"check_flash_bwd's (max |err| {errs['flash_attention_bwd']:.3g}; "
        f"wgmma at the same pairs, fma elsewhere), two calls the same "
        f"bits; {faults} planted faults beyond the wgmma backward's bound")
    return errs


def train_config(torch, groups: int = 1):
    """The training path's model, its training config and its batch: the
    published OLMoE-1B-7B widths at TRAIN_LAYERS layers with TRAIN_SLOTS
    spare replica slots and ``groups`` token groups in its MoE dispatch,
    bf16 compute, remat, the balancer on 4 shards; TRAIN_B x TRAIN_S
    tokens from ``SkewAwarePipeline`` fed ``zipf_doc_lengths``, as
    ``launch/train.py`` builds a batch."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.moe_balancer import MoEBalancerConfig
    from repro_torch.data import (PipelineConfig, SkewAwarePipeline,
                                  zipf_doc_lengths)
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                              n_layers=TRAIN_LAYERS,
                              moe_replica_slots=TRAIN_SLOTS,
                              moe_token_groups=groups)
    tc = TrainConfig(
        opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                        total_steps=TRAIN_STEPS),
        remat=True,
        moe_balancer=MoEBalancerConfig(
            n_experts=cfg.n_experts, n_slots=cfg.n_experts + TRAIN_SLOTS,
            n_shards=4, min_steps_between=2))
    pipe = SkewAwarePipeline(PipelineConfig(
        seq_len=TRAIN_S, batch_per_shard=max(TRAIN_B // 8, 1), n_shards=8,
        vocab=cfg.vocab))
    pipe.ingest(zipf_doc_lengths(64, TRAIN_S, seed=0))
    nb = pipe.next_batch()
    batch = {k: torch.from_numpy(np.ascontiguousarray(nb[k][:TRAIN_B]))
             for k in ("tokens", "labels")}
    return cfg, tc, batch


def replicas_equal(torch, tr) -> int:
    """Check that every replica slot holds its primary's weights, bit for
    bit, in every layer; returns the number of replica slots."""
    n = 0
    for li, (bal, block) in enumerate(zip(tr.balancers, tr.params["blocks"])):
        for s, m in enumerate(bal.grad_merge_map()):
            if m == s:
                continue
            n += 1
            for name in ("w_gate", "w_up", "w_down"):
                check(torch.equal(block["moe"][name][s],
                                  block["moe"][name][m]),
                      f"train: layer {li} slot {s}'s {name} differs from "
                      f"its primary's (slot {m})")
    return n


def train_phase(torch, k4, k5, groups: int = 1):
    """TRAIN_STEPS steps of the training path (``groups`` token groups in
    its MoE dispatch) on one repeated batch, a hot expert planted in every
    layer's router (``tests/test_moe_balancer.py``'s ``_skewed_moe``),
    every kernel's count set to 0 just before and read just after.  K4's
    forward ``rows`` (the rows it computes) are summed against the kept
    (token, slot) pairs of the layers' slot tables (the live rows).
    Requires a finite loss, lower at the last step than the first; an
    ``sbr_replicate``; every replica equal to its primary after
    every step; K4's forward launches 3 a layer per forward run (twice a
    step under remat), all on its tiles kernel, and its backward 6 a layer a
    step, on the tiles kernel's dx and dw forms (3 each); K5's forward one a
    layer per forward run on its wgmma kernel and its backward three a layer
    a step on its wgmma route (the prep pass, ``flash_bwd_dkv_wgmma``,
    ``flash_bwd_dq_wgmma``).  Returns (launches, a summary, the recorders,
    whose ``first`` holds the first call of each kernel at each shape)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.train import Trainer
    from repro_torch.train import optimizer as topt

    cfg, tc, batch = train_config(torch, groups)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, seed=0, device="cuda")
    for block in tr.params["blocks"]:
        block["moe"]["router"][:, TRAIN_HOT] += TRAIN_BOOST
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(tr.params))

    update = topt.update
    spent = [0.0, 0]

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - start
        spent[1] += 1
        return out

    names = [(k4, "segment_matmul"), (k4, "segment_matmul_backward"),
             (k5, "flash_attention"), (k5, "flash_attention_bwd")]
    route_tables = {"segment_matmul": k4.routes,
                    "segment_matmul_backward": k4.bwd_routes,
                    "flash_attention": k5.routes,
                    "flash_attention_bwd": k5.bwd_routes}
    recs = {name: Recorder(mod, name) for mod, name in names}
    recs["segment_matmul"] = RowsRecorder(k4, "segment_matmul")
    live = torch.zeros((), dtype=torch.int64, device="cuda")
    tables = moe_lib.slot_tables

    def counted_tables(keep, *args):
        live.add_(keep.sum())
        return tables(keep, *args)

    for mod, name in names:
        getattr(mod, name).launches = 0
    before = {n: dict(t) for n, t in route_tables.items()}
    losses, times, dropped = [], [], []
    with contextlib.ExitStack() as stack:
        for rec in recs.values():
            stack.enter_context(rec)
        stack.enter_context(StandIn(topt, "update", timed_update))
        stack.enter_context(StandIn(moe_lib, "slot_tables", counted_tables))
        for step in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            m = tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            losses.append(m["loss"])
            dropped.append(m["dropped_frac"])
            check(math.isfinite(m["loss"]),
                  f"train: non-finite loss at step {step}")
            n_replicas = replicas_equal(torch, tr)
            log(f"train: G{groups} step {step}: loss {m['loss']:.5f}, dropped "
                f"{m['dropped_frac']:.4f}, representativeness "
                f"{m['representativeness']:.4f}, {times[-1]:.3f} s, "
                f"{n_replicas} replica slots equal to their primaries")
    launches = {name: getattr(mod, name).launches for mod, name in names}
    routes = {n: {r: t[r] - before[n][r] for r in t if t[r] > before[n][r]}
              for n, t in route_tables.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    events = [e for b in tr.balancers for e in b.state.events]
    L, S = cfg.n_layers, TRAIN_STEPS
    want = {"segment_matmul": {"tiles": 3 * L * 2 * S},
            "segment_matmul_backward": {"dx_tiles": 3 * L * S,
                                        "dw_tiles": 3 * L * S},
            "flash_attention": {"wgmma": L * 2 * S},
            "flash_attention_bwd": {
                "wgmma": k5.BWD_LAUNCHES["wgmma"] * L * S}}
    for name, by_route in want.items():
        check(launches[name] == sum(by_route.values())
              and routes[name] == by_route,
              f"train: {name} launched {launches[name]} times by route "
              f"{routes[name]} over {S} steps of {L} layers, not "
              f"{by_route} (remat runs each forward twice a step)")
    check(losses[-1] < losses[0],
          f"train: the loss did not fall ({losses[0]:.5f} -> "
          f"{losses[-1]:.5f})")
    check(any(e.kind == "sbr_replicate" for e in events),
          "train: the balancer never replicated the hot expert")
    bytes_migrated = sum(b.state.bytes_migrated for b in tr.balancers)
    tokens = TRAIN_B * TRAIN_S
    steady = times[1:]
    summary = dict(
        n_params=n_params, init_s=init_s, losses=losses, times=times,
        step_s=sum(steady) / len(steady), tokens=tokens,
        update_s=spent[0] / max(spent[1], 1), peak_gib=peak,
        events=[(e.tick, e.kind) for e in events], routes=routes,
        bytes_migrated=bytes_migrated, n_layers=L, groups=groups,
        dropped=dropped,
        # three K4 forward calls a layer a forward run share one rows
        rows=int(recs["segment_matmul"].rows) // 3, live=int(live))
    check(summary["rows"] >= summary["live"] > 0,
          f"train: K4's rows sum {summary['rows']} does not cover the "
          f"{summary['live']} live rows")
    del tr
    torch.cuda.empty_cache()
    return launches, summary, recs


def train_replay_phase(torch, k4, k5, recs, label: str = "training path",
                       long_context: bool = True, context=(16, 128, 128)):
    """K4 and K5, forward and backward, against their plain versions on
    the inputs the training path gave them (each recorder's first call at
    each shape), each on the route the path took (the backward's: K4's dx
    and dw forms, K5's wgmma route, within its restated bound); the
    backward timed beside the plain version, the library's (``torch.bmm``
    for dx and dw; SDPA's backward through ``torch.autograd.grad``, a
    yardstick never on the path) and the bound of its route, the forward
    logged beside its own.  Then, with ``long_context``, K5's backward at
    1 x 4096 tokens with ``context`` = (heads, dk, dv) (OLMoE's by
    default) through the model's views with the forward's lse, checked and
    timed alike (a shape the path does not run).  K5's backward must take
    the route ``bwd_route`` gives its widths (``wgmma`` at hd 128).
    ``label`` names the path in the log.  Returns (max errors, the JSON
    records' numbers per kernel)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    errs = dict.fromkeys(recs, 0.0)
    main = {}
    for key, ((x, w, rows), _) in recs["segment_matmul"].first.items():
        E, C, D = x.shape
        Fo = w.shape[2]
        what = f"segment_matmul on the {label}'s x {(E, C, D)} w {(E, D, Fo)}"
        before = dict(k4.routes)
        got = k4.segment_matmul(x, w, rows)
        took = [r for r in k4.ROUTES if k4.routes[r] > before[r]]
        check(took == ["tiles"], f"{what}: ran {took}, not the path's tiles")
        errs["segment_matmul"] = max(errs["segment_matmul"],
                                     check_segment_matmul(torch, what, got, x,
                                                          w, rows))
        t = time_k4(torch, k4, x, w, 10, rows)
        log(f"replay: {what} (rows sum {int(rows.sum())} of {E * C}): "
            f"{t[0]:.5f} ms (plain {t[1]:.5f} ms, torch.bmm {t[2]:.5f} ms, "
            f"live bound {t[3]:.5f} ms by {t[4]}, {100 * t[3] / t[0]:.1f}% of "
            f"it)")
    for key, ((q, k, v), kw) in recs["flash_attention"].first.items():
        what = f"flash_attention on the {label}'s q {tuple(q.shape)}"
        kw = {n: a for n, a in kw.items() if n != "return_lse"}
        scale = kw.get("scale")
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, what, k5_call(k5, what, "wgmma", q, k, v, **kw), q, k, v,
            kw.get("causal", True), scale))
        t = time_k5(torch, k5, q, k, v, 20, kw.get("causal", True))
        log(f"replay: {what}: {t[0]:.5f} ms (plain {t[1]:.5f} ms, "
            f"scaled_dot_product_attention {t[2]:.5f} ms, bound {t[3]:.5f} ms "
            f"by {t[4]}, {100 * t[3] / t[0]:.1f}% of bound)")
        main.setdefault("flash_attention", t)
    for key, ((dout, x, w, rows), _) in (
            recs["segment_matmul_backward"].first.items()):
        E, C, D = x.shape
        Fo = w.shape[2]
        what = (f"segment_matmul_backward on the {label}'s x {(E, C, D)} w "
                f"{(E, D, Fo)}")
        before = dict(k4.bwd_routes)
        got = k4.segment_matmul_backward(dout, x, w, rows)
        took = [r for r in k4.BWD_ROUTES if k4.bwd_routes[r] > before[r]]
        check(took == ["dx_tiles", "dw_tiles"],
              f"{what}: ran {took}, not the path's dx and dw forms")
        errs["segment_matmul_backward"] = max(
            errs["segment_matmul_backward"], check_seg_bwd(
                torch, k4, what, got, dout, x, w, rows))
        del got
        ms = time_ms(torch, k4.segment_matmul_backward, (dout, x, w, rows),
                     10)
        plain_ms = time_ms(torch, ref.segment_matmul_backward,
                           (dout, x, w, rows), 3)
        lib_ms = time_ms(torch, lambda d, x, w: (
            torch.bmm(d, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), d)),
            (dout, x, w), 10)
        b_ms, b_by = k4_bwd_bound(E, C, D, Fo, x.element_size(),
                                  rows.tolist())
        log(f"replay: {what} (rows sum {int(rows.sum())} of {E * C}): "
            f"{ms:.5f} ms a call of two launches (plain {plain_ms:.5f} ms, "
            f"torch.bmm for dx and dw {lib_ms:.5f} ms, bound {b_ms:.5f} ms "
            f"by {b_by}, {100 * b_ms / ms:.1f}% of it)")
        if D > Fo and "segment_matmul_backward" not in main:
            main["segment_matmul_backward"] = (ms, plain_ms, lib_ms, b_ms,
                                               b_by)
    firsts = list(recs["flash_attention_bwd"].first.values())
    extra = []
    if long_context:
        # 4096 tokens in the model's [B, S, H, hd] layout, one sequence.
        ch, cdk, cdv = context
        q4, k4_, v4 = (randn(torch, 90 + i, (1, 4096, ch, d),
                             torch.bfloat16).transpose(1, 2)
                       for i, d in enumerate((cdk, cdk, cdv)))
        out4, lse4 = k5.flash_attention(q4, k4_, v4, causal=True,
                                        return_lse=True)
        extra.append(((q4, k4_, v4, out4,
                       randn(torch, 93, (1, ch, 4096, cdv), torch.float32)),
                      {"causal": True, "lse": lse4}))
        del q4, k4_, v4, out4, lse4
    for i, ((q, k, v, out, dout), kw) in enumerate(firsts + extra):
        B, H, S, hd = q.shape
        KV, T, dv = k.shape[1], k.shape[2], v.shape[3]
        what = (f"flash_attention_bwd on the {label}'s q {tuple(q.shape)}"
                if i < len(firsts) else
                f"flash_attention_bwd at 1 x 4096, q {tuple(q.shape)} v "
                f"{tuple(v.shape)}")
        causal, scale = kw.get("causal", True), kw.get("scale")
        scale = hd ** -0.5 if scale is None else scale
        plain_kw = {n: a for n, a in kw.items() if n != "lse"}
        route = k5.bwd_route(q, k, v)
        want = "wgmma" if (hd, dv) in k5.WGMMA_WIDTHS else "fma"
        check(route == want, f"{what}: takes the {route} route, not {want}")
        errs["flash_attention_bwd"] = max(
            errs["flash_attention_bwd"], check_flash_bwd(
                torch, what, k5.flash_attention_bwd(q, k, v, out, dout, **kw),
                q, k, v, out, dout, causal, scale, route))
        ms = time_ms(torch, lambda *a: k5.flash_attention_bwd(*a, **kw),
                     (q, k, v, out, dout), 10)
        plain_ms = time_ms(torch, lambda *a: ref.flash_attention_bwd(
            *a, **plain_kw), (q, k, v, out, dout), 3)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                              scale=scale,
                                              enable_gqa=KV != H)
        g = dout.to(sdpa.dtype)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), g, retain_graph=True), (), 10)
        b_ms, b_by = k5_bwd_bound(B, H, KV, S, T, hd, causal,
                                  q.element_size(), route, dv)
        log(f"replay: {what}: {ms:.5f} ms (plain {plain_ms:.5f} ms, SDPA's "
            f"backward {lib_ms:.5f} ms, bound {b_ms:.5f} ms by {b_by}, "
            f"{100 * b_ms / ms:.1f}% of it)")
        if i < len(firsts):
            main.setdefault("flash_attention_bwd", (ms, plain_ms, lib_ms,
                                                    b_ms, b_by))
        del sdpa, qg, kg, vg
    del extra
    torch.cuda.empty_cache()
    return errs, main


def grouped_replay_phase(torch, k4, recs):
    """K4's forward and backward against their plain versions on the
    inputs the path with TRAIN_GROUPS token groups gave them (the first
    call at each shape: each slot's queues of all groups, ``rows`` reaching
    the last live row of its last live group, dead sentinel rows inside),
    each on the tiles kernel; the forward timed with the path's ``rows``
    beside the same call with each slot's live count as its ``rows`` (the
    rows a form with ``rows`` per (slot, group) would compute).  Returns
    (max errors, [(rows sum, live sum, ms, ms at the live counts)] per
    forward shape)."""
    errs = {"segment_matmul": 0.0, "segment_matmul_backward": 0.0}
    dead = []
    for (x, w, rows), _ in recs["segment_matmul"].first.values():
        E, C, D = x.shape
        Fo = w.shape[2]
        what = (f"segment_matmul on the G{TRAIN_GROUPS} training path's x "
                f"{(E, C, D)} w {(E, D, Fo)}")
        errs["segment_matmul"] = max(errs["segment_matmul"],
                                     check_segment_matmul(
                                         torch, what,
                                         k4.segment_matmul(x, w, rows), x, w,
                                         rows))
        live = (x.abs().amax(dim=-1) > 0).sum(dim=1).to(torch.int32)
        ms = time_ms(torch, k4.segment_matmul, (x, w, rows), 20)
        live_ms = time_ms(torch, k4.segment_matmul, (x, w, live), 20)
        n_rows, n_live = int(rows.sum()), int(live.sum())
        dead.append((n_rows, n_live, ms, live_ms))
        log(f"replay: {what}: rows sum {n_rows} over {n_live} live rows "
            f"({100 * (n_rows / n_live - 1):.2f}% dead inside the "
            f"prefixes): {ms:.5f} ms, {live_ms:.5f} ms with each slot's "
            f"live count as its rows (the dead rows "
            f"{100 * (1 - live_ms / ms):.1f}% of the call)")
    for (dout, x, w, rows), _ in (
            recs["segment_matmul_backward"].first.values()):
        E, C, D = x.shape
        Fo = w.shape[2]
        what = (f"segment_matmul_backward on the G{TRAIN_GROUPS} training "
                f"path's x {(E, C, D)} w {(E, D, Fo)}")
        before = dict(k4.bwd_routes)
        got = k4.segment_matmul_backward(dout, x, w, rows)
        took = [r for r in k4.BWD_ROUTES if k4.bwd_routes[r] > before[r]]
        check(took == ["dx_tiles", "dw_tiles"],
              f"{what}: ran {took}, not the path's dx and dw forms")
        errs["segment_matmul_backward"] = max(
            errs["segment_matmul_backward"], check_seg_bwd(
                torch, k4, what, got, dout, x, w, rows))
        ms = time_ms(torch, k4.segment_matmul_backward, (dout, x, w, rows),
                     10)
        log(f"replay: {what} (rows sum {int(rows.sum())} of {E * C}): "
            f"{ms:.5f} ms a call of two launches")
        del got
    torch.cuda.empty_cache()
    return errs, dead


def train_slice_model(torch, seed: int, groups: int = 1):
    """OLMoE-1B-7B at full width and TRAIN_SLICE_LAYERS layers, float32
    compute (K4 and K5 on their fma routes), TRAIN_SLOTS replica slots,
    ``groups`` token groups and a split routing table (expert 0 over its
    slot and the first spare, at 0.6 / 0.4, every layer), weights from ``seed`` on the card and a copy
    on the host, and a TRAIN_SLICE_B x TRAIN_SLICE_S batch from
    ``seed + 1``.  Returns (cfg, card params, host params, batch,
    routing)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("olmoe-1b-7b"),
                              n_layers=TRAIN_SLICE_LAYERS,
                              moe_replica_slots=TRAIN_SLOTS,
                              moe_token_groups=groups,
                              compute_dtype="float32")
    gpu = init_params(cfg, seed, "cuda")
    rng = np.random.default_rng(seed + 1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_SLICE_B, TRAIN_SLICE_S))) for k in
        ("tokens", "labels")}
    E, P = cfg.n_experts, cfg.n_experts + TRAIN_SLOTS
    routing = torch.zeros((cfg.n_layers, E, P))
    routing[:, torch.arange(E), torch.arange(E)] = 1.0
    routing[:, 0, 0], routing[:, 0, E] = 0.6, 0.4
    return cfg, gpu, _to_cpu(gpu), batch, routing


def train_slice_grads(torch, cfg, params, batch, routing, dev: str):
    """(loss, gradient leaves) of one ``loss_fn`` on ``dev``, on the host
    as float32."""
    from repro_torch.models import model as tm
    from repro_torch.tree import leaves, tree_map
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, _ = tm.loss_fn(live, cfg, {k: v.to(dev) for k, v in batch.items()},
                         remat=True,
                         moe_routing=None if routing is None else routing.to(dev))
    grads = torch.autograd.grad(loss, leaves(live))
    return loss.item(), [g.float().cpu() for g in grads]


def train_slice_compare(card, host):
    """|loss difference| and, over every gradient leaf, the largest
    max |card - host| relative to the leaf's largest host entry."""
    (lc, gc), (lh, gh) = card, host
    rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
              for a, b in zip(gc, gh))
    return dict(loss_err=abs(lc - lh), grad_rel=rel, loss=lh,
                leaves=len(gh))


def train_slice_phase(torch, groups: int = 1):
    """The training path's gradient at 2 layers (``groups`` token groups),
    card against host: one
    ``loss_fn`` gradient of the same weights (seed 0) and batch through
    K4's and K5's forward and backward on the card, and through their
    plain versions on the host.  The loss must agree within
    TRAIN_SLICE_LOSS_TOL and every gradient leaf within TRAIN_SLICE_TOL of
    its largest entry.  Returns a summary dict."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    cfg, gpu, cpu, batch, routing = train_slice_model(torch, 0, groups)
    tables = (ksm.routes, ksm.bwd_routes, kfa.routes, kfa.bwd_routes)
    before = [dict(t) for t in tables]
    bwd = kfa.flash_attention_bwd.launches
    card = train_slice_grads(torch, cfg, gpu, batch, routing, "cuda")
    took = [{r: t[r] - b[r] for r in t if t[r] > b[r]}
            for t, b in zip(tables, before)]
    bwd = kfa.flash_attention_bwd.launches - bwd
    check(all(set(t) == {"fma"} for t in took)
          and bwd == 2 * TRAIN_SLICE_LAYERS,
          f"train slice: the card side ran K4 / K4 backward / K5 / K5 "
          f"backward on {took}, "
          f"not all on their fma routes, or K5's backward launched {bwd} "
          f"kernels, not {2 * TRAIN_SLICE_LAYERS}")
    t0 = time.perf_counter()
    host = train_slice_grads(torch, cfg, cpu, batch, routing, "cpu")
    cpu_s = time.perf_counter() - t0
    check(math.isfinite(card[0]) and all(bool(torch.isfinite(g).all())
                                         for g in card[1]),
          "train slice: non-finite loss or gradient on the card")
    r = train_slice_compare(card, host)
    check(r["loss_err"] <= TRAIN_SLICE_LOSS_TOL,
          f"train slice: card and host losses differ by {r['loss_err']:.3g} "
          f"(> {TRAIN_SLICE_LOSS_TOL})")
    check(r["grad_rel"] <= TRAIN_SLICE_TOL,
          f"train slice: a gradient leaf differs by {r['grad_rel']:.3g} of "
          f"its largest entry (> {TRAIN_SLICE_TOL})")
    del gpu, cpu
    torch.cuda.empty_cache()
    r["cpu_s"] = cpu_s
    return r


def train_planted_faults(ksm, kfa):
    """Faults planted in the backward on the card's side of the train
    slice, each a stand-in that still launches the kernel: (name, module,
    wrapper name, stand-in)."""
    k4b, k5b = ksm.segment_matmul_backward, kfa.flash_attention_bwd

    def d_dropped(q, k, v, out, dout, **kw):
        return k5b(q, k, v, out.new_zeros(()).expand_as(out).contiguous(),
                   dout, **kw)

    def mask_off(q, k, v, out, dout, causal=True, scale=None, **kw):
        return k5b(q, k, v, out, dout, causal=False, scale=scale, **kw)

    def last_f_dropped(dout, x, w, rows=None):
        dout = dout.clone()
        dout[:, :, -1] = 0
        return k4b(dout, x, w, rows)

    def last_row_dropped(dout, x, w, rows=None):
        return k4b(dout, x, w, None if rows is None else (rows - 1).clamp(
            min=0).to(rows.dtype))

    return [("K5 backward drops D", kfa, "flash_attention_bwd", d_dropped),
            ("K5 backward mask off", kfa, "flash_attention_bwd", mask_off),
            ("K4 backward drops the last of F's terms", ksm,
             "segment_matmul_backward", last_f_dropped),
            ("K4 backward drops each expert's last row", ksm,
             "segment_matmul_backward", last_row_dropped)]


def train_slice_readings(torch, seeds=(0, 1, 2)):
    """The readings TRAIN_SLICE_TOL and TRAIN_SLICE_LOSS_TOL are set from:
    at each seed, the card against the host, sound and with each planted
    fault on the card's side (the serve slice's in K4's and K5's forward,
    and the backward's)."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    runs = {}
    for seed in seeds:
        cfg, gpu, cpu, batch, routing = train_slice_model(torch, seed)
        host = train_slice_grads(torch, cfg, cpu, batch, routing, "cpu")
        for name, stand_in in [("sound", None)] + [
                (n, StandIn(m, a, f))
                for n, m, a, f in (planted_faults(ksm, kfa)
                                   + train_planted_faults(ksm, kfa))]:
            with (stand_in or contextlib.nullcontext()):
                card = train_slice_grads(torch, cfg, gpu, batch, routing,
                                         "cuda")
            r = train_slice_compare(card, host)
            runs.setdefault(name, []).append(r)
            log(f"readings: train slice seed {seed}: {name}: |loss diff| "
                f"{r['loss_err']:.3g} (loss {r['loss']:.5f}), gradients "
                f"within {r['grad_rel']:.3g} of each leaf's largest entry "
                f"over {r['leaves']} leaves")
        del gpu, cpu, host
        torch.cuda.empty_cache()
    for name, rs in runs.items():
        log(f"readings: train slice {name} over seeds {list(seeds)}: |loss "
            f"diff| up to {max(r['loss_err'] for r in rs):.3g}, gradients "
            f"{min(r['grad_rel'] for r in rs):.3g} to "
            f"{max(r['grad_rel'] for r in rs):.3g}")
    log(f"readings: train slice limits: TRAIN_SLICE_TOL {TRAIN_SLICE_TOL}, "
        f"TRAIN_SLICE_LOSS_TOL {TRAIN_SLICE_LOSS_TOL}")
    return runs


def log_train(tn, launches, smi: str) -> None:
    log(f"train: OLMoE-1B-7B at full width, {tn['n_layers']} layers, "
        f"{TRAIN_SLOTS} replica slots, {tn['groups']} token group(s) "
        f"({tn['n_params']:,} float32 params "
        f"from seed 0 in {tn['init_s']:.1f} s), batch {TRAIN_B} x {TRAIN_S}, "
        f"{TRAIN_STEPS} steps with remat: loss {tn['losses'][0]:.5f} -> "
        f"{tn['losses'][-1]:.5f}; {tn['step_s']:.4f} s a step after the "
        f"first ({tn['times'][0]:.3f} s), {tn['tokens'] / tn['step_s']:.1f} "
        f"tokens/s, the AdamW update {tn['update_s']:.4f} s a step "
        f"({100 * tn['update_s'] / tn['step_s']:.1f}%), peak "
        f"{tn['peak_gib']:.2f} GiB; balancer events {tn['events']}, "
        f"{tn['bytes_migrated'] / 2**20:.1f} MiB migrated; dropped "
        f"{tn['dropped'][0]:.4f} -> {tn['dropped'][-1]:.4f}; K4's forward "
        f"rows sum {tn['rows']:,} over {tn['live']:,} live rows "
        f"({100 * (tn['rows'] / tn['live'] - 1):.2f}% dead rows inside the "
        f"prefixes); launches {launches} by route {tn['routes']} | {smi}")


# --------------------------------------------------------------------- #
# 10b. train: K6's backward, RWKV6-1.6B trained at full width            #
# --------------------------------------------------------------------- #
def rwkv_bwd_envelope(torch, args, dout, dstate):
    """The magnitudes ``check_rwkv_bwd`` bounds K6's backward by, each
    first-order error of one side of the check over eps = 2^-24: from the
    forward's envelope of the states (A_t = |w_t| A_{t-1} + |k_t| |v_t|^T
    from |state0|, D_t = |w_t| D_{t-1} + A_t from 0, as
    ``rwkv_envelope``) and the backward's (Gh_{t-1} = |w_t| Gh_t + |r_t|
    |dout_t|^T from |dstate_T|, E_{t-1} = |w_t| E_t + Gh_{t-1} from 0),
    with n = hd + 8 roundings a sum and vd_t = |v_t| . |dout_t|:

        dk_t: 3 E_t |v_t| + n Gh_t |v_t| + (n + 3) |u| |r_t| vd_t
        dr_t: 3 D_{t-1} |dout_t| + n A_{t-1} |dout_t| + (n + 3) |u| |k_t| vd_t
        dv_t: 3 E_t^T |k_t| + n Gh_t^T |k_t| + (n + 3) |dout_t| sum |r u k|
        dw_t: rowsum(3 E_t A_{t-1} + 3 Gh_t D_{t-1} + n Gh_t A_{t-1})
        du:   (n + 3 + T + B) sum_{b,t} |r_t| |k_t| vd_t
        dstate0: 3 E_{-1}

    Returns them in that order ([B, H, T, hd] each, du [H, hd], dstate0
    [B, H, hd, hd])."""
    r, k, v, w, u, s0 = (None if a is None else a.float().abs() for a in args)
    do = dout.float().abs()
    B, H, T, hd = r.shape
    n = hd + 8
    A = (torch.zeros((B, H, hd, hd), device=r.device) if s0 is None
         else s0.clone())
    D = torch.zeros_like(A)
    As = torch.empty((T, B, H, hd, hd), device=r.device)
    Ds = torch.empty_like(As)
    for t in range(T):
        As[t], Ds[t] = A, D
        A = w[:, :, t, :, None] * A + k[:, :, t, :, None] * v[:, :, t, None, :]
        D = w[:, :, t, :, None] * D + A
    del A, D
    G = (torch.zeros((B, H, hd, hd), device=r.device) if dstate is None
         else dstate.float().abs())
    E = torch.zeros_like(G)
    bounds = [torch.empty((B, H, T, hd), device=r.device) for _ in range(4)]
    du = torch.zeros((H, hd), device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dt = (x[:, :, t] for x in (r, k, v, w, do))
        vd = (vt * dt).sum(-1, keepdim=True)
        beta = (rt * u * kt).sum(-1, keepdim=True)
        Ap, Dp = As[t], Ds[t]
        bounds[0][:, :, t] = (3 * torch.einsum("bhkc,bhc->bhk", E, vt)
                              + n * torch.einsum("bhkc,bhc->bhk", G, vt)
                              + (n + 3) * u * rt * vd)
        bounds[1][:, :, t] = (3 * torch.einsum("bhkc,bhc->bhk", Dp, dt)
                              + n * torch.einsum("bhkc,bhc->bhk", Ap, dt)
                              + (n + 3) * u * kt * vd)
        bounds[2][:, :, t] = (3 * torch.einsum("bhkc,bhk->bhc", E, kt)
                              + n * torch.einsum("bhkc,bhk->bhc", G, kt)
                              + (n + 3) * dt * beta)
        bounds[3][:, :, t] = (3 * E * Ap + 3 * G * Dp + n * G * Ap).sum(-1)
        du += (rt * kt * vd).sum(0)
        G = wt[..., None] * G + rt[..., None] * dt[..., None, :]
        E = wt[..., None] * E + G
    dk_b, dr_b, dv_b, dw_b = bounds
    return dr_b, dk_b, dv_b, dw_b, (n + 3 + T + B) * du, 3 * E


def check_rwkv_bwd(torch, what: str, got, args, dout, dstate=None) -> float:
    """K6's backward against its plain version (``ref.rwkv_scan_bwd``) on
    ``args`` (r, k, v, w, u, state0), ``dout`` and ``dstate``.

    Both are float32 arithmetic on the same values (bf16 inputs widened
    exactly) in other orders: the kernel recomputes the states from the
    forward's checkpoints with the forward's arithmetic, sums a row over
    its thread's columns by multiply-adds and across the row group by a
    reduce-scatter of shuffles (all in one block of the cluster: a block
    owns 32 rows), a column across the warps' partials (the cluster's
    warps in order, in the block that owns the column), takes
    v . dout and beta by a warp's multiply-adds and shuffles, and G's
    update as one multiply-add on r dout.  To first order, with eps =
    2^-24 and the envelopes of ``rwkv_bwd_envelope``: either version's
    state before step t is within 3 eps D_{t-1} of the exact one (as in
    ``check_rwkv``), its G_t within 3 eps E_t (a step of G rounds at most
    three times on values bounded by Gh_{t-1}, and the errors of the steps
    after decay with |w|), a sum of hd terms plus its bonus rounds at most
    n = hd + 8 times on either side (the plain version's einsum chain and
    add; the kernel's at most 4 multiply-adds, 4 shuffle adds and 7 warp
    partials and the bonus), v . dout and beta at most n + 2 times before
    their products (n + 3 with them), and du's sum over T steps and B rows
    T + B times more.  So each side lies within eps times the envelope of
    the exact gradient, and the two within twice that.  A bf16 dr, dk, dv
    (or dw) is each side's float32 gradient rounded once, so it may differ
    by one bf16 ulp more, taken at the larger of |got| and |want|.
    Returns the largest |kernel - plain| over the six gradients."""
    from repro_torch.kernels import ref
    want = ref.rwkv_scan_bwd(*args, dout, dstate)
    names = ("dr", "dk", "dv", "dw", "du", "dstate0")
    for name, g, wnt in zip(names, got, want):
        check(g.shape == wnt.shape and g.dtype == wnt.dtype,
              f"{what}: {name} {tuple(g.shape)} {g.dtype} vs plain "
              f"{tuple(wnt.shape)} {wnt.dtype}")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
    eps = 2.0**-24
    err = 0.0
    for name, g, wnt, env in zip(names, got, want,
                                 rwkv_bwd_envelope(torch, args, dout,
                                                   dstate)):
        tol = 2 * eps * env
        g, wnt = g.float(), wnt.float()
        if name in ("dr", "dk", "dv", "dw") and (
                (args[3] if name == "dw" else args[0]).dtype
                == torch.bfloat16):
            big = torch.maximum(g.abs(), wnt.abs())
            _, e = torch.frexp(big)
            tol = tol + torch.where(big > 0, torch.ldexp(
                torch.ones_like(tol), e - 8), 0.0)
        diff = (g - wnt).abs()
        if diff.numel():
            check(bool((diff <= tol).all()),
                  f"{what}: {name} beyond the stated bound of the plain "
                  f"version (max |err| {float(diff.max()):.3g}, at most "
                  f"{float((diff / tol.clamp(min=1e-30)).max()):.3g} times "
                  f"its bound)")
            err = max(err, float(diff.max()))
    return err


def rwkv_bwd_faults(torch, krw):
    """Faults planted in K6's backward, each a stand-in for its wrapper
    (the same signature) that still calls it: (name, stand-in)."""
    bwd = krw.rwkv_scan_bwd

    def g_not_decayed(r, k, v, w, u, state0, dout, dstate_T=None, **kw):
        # w read as 1: G is not decayed (nor are the chunk's recomputed
        # states, from the forward's checkpoints of the real w).
        return bwd(r, k, v, torch.ones_like(w), u, state0, dout, dstate_T,
                   **kw)

    def dw_reads_s_t(r, k, v, w, u, state0, dout, dstate_T=None, **kw):
        # sum_c G_t S_t = w_t dw_t + k_t (G_t v_t), and G_t v_t is dk_t
        # less its bonus.
        dr, dk, dv, dw, du, ds0 = bwd(r, k, v, w, u, state0, dout, dstate_T,
                                      **kw)
        rf, kf, wf = (x.float() for x in (r, k, w))
        vd = (v.float() * dout.float()).sum(-1, keepdim=True)
        gv = dk.float() - u[None, :, None, :] * rf * vd
        return (dr, dk, dv, (wf * dw.float() + kf * gv).to(dw.dtype), du,
                ds0)

    def du_one_row(r, k, v, w, u, state0, dout, dstate_T=None, **kw):
        out = bwd(r, k, v, w, u, state0, dout, dstate_T, **kw)
        ck = kw.get("checkpoints")
        one = bwd(*(x[:1] for x in (r, k, v, w)), u,
                  None if state0 is None else state0[:1], dout[:1],
                  None if dstate_T is None else dstate_T[:1],
                  checkpoints=None if ck is None else ck[:1])
        return out[:4] + (one[4], out[5])

    def dv_without_band0(r, k, v, w, u, state0, dout, dstate_T=None, **kw):
        # dv_t = G_t^T k_t + dout_t beta_t, and G does not depend on k: with
        # k's first 32 rows (the cluster's band 0) zeroed, dv less dout_t
        # beta'_t plus dout_t beta_t is G_t^T k_t without band 0's share.
        out = bwd(r, k, v, w, u, state0, dout, dstate_T, **kw)
        k0 = k.clone()
        k0[..., :32] = 0
        dv = bwd(r, k0, v, w, u, state0, dout, dstate_T, **kw)[2]
        rf = r.float()
        beta = (rf * u[None, :, None, :] * k.float()).sum(-1, keepdim=True)
        beta0 = (rf * u[None, :, None, :] * k0.float()).sum(-1, keepdim=True)
        dv = (dv.float() + dout.float() * (beta - beta0)).to(out[2].dtype)
        return out[:2] + (dv,) + out[3:]

    return [("K6 backward: G not decayed", g_not_decayed),
            ("K6 backward: dw reads S_t for S_{t-1}", dw_reads_s_t),
            ("K6 backward: du of one batch row", du_one_row),
            ("K6 backward: dv without one row band's share",
             dv_without_band0)]


def k6_bwd_bound(B: int, H: int, T: int, hd: int, in_bytes: int = 2,
                 w_bytes: int = 4, with_state: bool = False,
                 with_dstate: bool = False):
    """Least time of K6's backward: 12 hd^2 float32 operations per (b, h,
    t) at the float32 CUDA-core rate (a multiply-add per state entry for
    each of G's update, dk, dv, dw, dr and the recomputed state), vs r, k,
    v and dout (``in_bytes`` a value) and w (``w_bytes``) read and dr, dk,
    dv (r's width) and dw (w's) written once, the forward's checkpoints
    (a float32 state every CHECKPOINT_EVERY steps) and u read, du's
    partials, dstate0, and state0 and dstate_T (when given) moved once,
    against the memory rate."""
    from repro_torch.kernels import rwkv_scan as krw
    t_ops = 12.0 * hd * hd * B * H * T / FP32_OPS_PER_S * 1e3
    n_ck = -(-T // krw.CHECKPOINT_EVERY)
    nbytes = ((7 * in_bytes + 2 * w_bytes) * B * H * T * hd
              + 4 * B * H * hd * hd * (n_ck + 1 + with_state + with_dstate)
              + 4 * (H + B * H) * hd)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rwkv_bwd_case(torch, krw, what: str, args, dout, dstate) -> float:
    """One check of K6's backward: the forward gives the same out and
    state bits with and without its checkpoints, the backward launches
    once a call, gives the same bits from two calls and lies within
    ``check_rwkv_bwd``'s bound.  Returns the largest error."""
    out, fin, ck = krw.rwkv_scan(*args, checkpoints=True)
    plain_out, plain_fin = krw.rwkv_scan(*args)
    check(torch.equal(out, plain_out) and torch.equal(fin, plain_fin),
          f"{what}: the forward gives other bits with its checkpoints")
    launches = krw.rwkv_scan_bwd.launches
    got = krw.rwkv_scan_bwd(*args, dout, dstate, checkpoints=ck)
    again = krw.rwkv_scan_bwd(*args, dout, dstate, checkpoints=ck)
    check(krw.rwkv_scan_bwd.launches == launches + 2,
          f"{what}: {krw.rwkv_scan_bwd.launches - launches} launches for "
          f"two calls")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{what}: two calls give other bits")
    B, H, T, hd = args[0].shape
    if args[0].stride() == (T * H * hd, hd, H * hd, 1) and T > 1:
        check(all(g.stride() == args[0].stride() for g in got[:4]),
              f"{what}: the gradients are not in the model's layout")
    return check_rwkv_bwd(torch, what, got, args, dout, dstate)


def rwkv_bwd_kernel_phase(torch, krw) -> float:
    """K6's backward against its plain version within ``check_rwkv_bwd``'s
    bound (``rwkv_bwd_case``): hd 16, 32 and 64, float32 and the model's
    bf16 r, k, v (w float32), T = 1, C - 1, C, C + 1 and 3C + 5 (C the
    checkpoint interval), without and with state0 and dstate_T; then the
    model's [B, T, H, hd] views at hd 64 and 16 and odd hd 5, 40 and 48
    (a row band part padding), all three type kinds, at T = 3C + 5,
    and at B 5, H 7 and B 1, H 32 (grids that are no multiple of the SM
    count); the planted faults (``rwkv_bwd_faults``) beyond the bound at
    B 3, T 3C + 5, hd 64 (a cluster of two blocks of 32 rows a (b, h),
    past two chunks) in float32 and the model's types.  Returns the largest
    error."""
    C = krw.CHECKPOINT_EVERY
    Ts = (1, C - 1, C, C + 1, 3 * C + 5)
    err, seed, faults = 0.0, 700, 0
    for kind in K6_KINDS[:2]:
        for hd in (16, 32, 64):
            for T in Ts:
                for with_state in (False, True):
                    seed += 10
                    args = rwkv_inputs(torch, seed, 3, 12, T, hd, with_state,
                                       kind=kind)
                    dout = randn(torch, seed + 6, (3, 12, T, hd),
                                 args[0].dtype)
                    ds = (randn(torch, seed + 7, (3, 12, hd, hd),
                                torch.float32, 0.5) if with_state else None)
                    err = max(err, rwkv_bwd_case(
                        torch, krw, f"rwkv_scan_bwd {kind} hd={hd} T={T} "
                        f"state0/dstate={with_state}", args, dout, ds))
    # The model's layout, odd hd (ragged row bands: hd 40 and 48 leave the
    # second band part padding) and grids of B H bands blocks that are no
    # multiple of the SM count (B 2, H 7; B 5, H 7; B 1, H 32: 64 blocks).
    T = 3 * C + 5
    cases = [(kind, 2, 7, hd, views) for kind in K6_KINDS
             for hd, views in ((64, True), (16, True), (5, False),
                               (40, False), (48, False))]
    cases += [(K6_KINDS[1], 5, 7, 64, True), (K6_KINDS[1], 1, 32, 64, True)]
    for kind, B, H, hd, views in cases:
        seed += 10
        args = rwkv_inputs(torch, seed, B, H, T, hd, True, views, kind)
        dout = randn(torch, seed + 6, (B, T, H, hd) if views
                     else (B, H, T, hd), args[0].dtype)
        if views:
            dout = dout.transpose(1, 2)
        ds = randn(torch, seed + 7, (B, H, hd, hd), torch.float32, 0.5)
        err = max(err, rwkv_bwd_case(
            torch, krw, f"rwkv_scan_bwd {kind} B={B} H={H} hd={hd} T={T} "
            f"{'views' if views else 'contiguous'}", args, dout, ds))
    for kind in K6_KINDS[:2]:
        seed += 10
        args = rwkv_inputs(torch, seed, 3, 12, 3 * C + 5, 64, True, True,
                           kind)
        dout = randn(torch, seed + 6, (3, 3 * C + 5, 12, 64),
                     args[0].dtype).transpose(1, 2)
        ds = randn(torch, seed + 7, (3, 12, 64, 64), torch.float32, 0.5)
        _, _, ck = krw.rwkv_scan(*args, checkpoints=True)
        for name, fn in rwkv_bwd_faults(torch, krw):
            try:
                check_rwkv_bwd(torch, f"{kind} ({name})",
                               fn(*args, dout, ds, checkpoints=ck), args,
                               dout, ds)
            except SmokeFailure:
                faults += 1
                continue
            check(False, f"rwkv_scan_bwd {kind}: the planted fault '{name}' "
                         f"stays within check_rwkv_bwd's bound")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"train kernels: rwkv_scan_bwd within the stated bound of its plain "
        f"version at B=3 H=12 hd in {{16, 32, 64}} x T in {set(Ts)} x "
        f"state0 and dstate_T in {{no, yes}} x {{float32, bf16 r, k, v}}, "
        f"and at T={3 * C + 5} on views in the model's layout (hd 16, 64) "
        f"and hd 5, 40, 48 for {set(K6_KINDS)}, and at B 5, H 7 and B 1, "
        f"H 32 (hd 64); one launch a call, the same "
        f"bits from two calls, the forward's bits the same with its "
        f"checkpoints (every {C} steps) (max |err| {err:.3g}); {faults} "
        f"planted faults beyond the bound")
    return err


def rwkv_train_config(torch):
    """The RWKV6 training path's model, training config and batch:
    RWKV6-1.6B at its published widths and all its layers, bf16 compute,
    remat, no balancer (no experts); a TRAIN_B x TRAIN_S batch from
    ``SkewAwarePipeline`` fed ``zipf_doc_lengths``, as ``train_config``
    builds OLMoE's."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import (PipelineConfig, SkewAwarePipeline,
                                  zipf_doc_lengths)
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config("rwkv6-1.6b")
    tc = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                     total_steps=TRAIN_STEPS),
                     remat=True, moe_balancer=None)
    pipe = SkewAwarePipeline(PipelineConfig(
        seq_len=TRAIN_S, batch_per_shard=max(TRAIN_B // 8, 1), n_shards=8,
        vocab=cfg.vocab))
    pipe.ingest(zipf_doc_lengths(64, TRAIN_S, seed=0))
    nb = pipe.next_batch()
    batch = {k: torch.from_numpy(np.ascontiguousarray(nb[k][:TRAIN_B]))
             for k in ("tokens", "labels")}
    return cfg, tc, batch


def model_train_phase(torch, label: str, cfg, tc, batch, names, recorded,
                      want, want_routes=None, make=None):
    """TRAIN_STEPS steps of a training path on one repeated batch, every
    count of ``names`` ((module, wrapper name) pairs) set to 0 just before
    and read just after, the wrappers named in ``recorded`` recorded: the
    loss finite at every step and lower at the last than the first, the
    launches equal to ``want`` and, for each wrapper in ``want_routes``,
    by route (its module's ``routes`` or ``bwd_routes`` table); ``make``
    builds each recorder (``Recorder`` by default).  With
    ``tc.moe_balancer`` (a MoE model) a balancer on each MoE layer of
    ``blocks`` and a hot expert planted in their routers as ``train_phase``
    plants it: every replica equal to its primary after every step, and an
    ``sbr_replicate``; else no balancer.  Returns (launches, a summary,
    the recorders)."""
    from repro_torch.train import Trainer
    from repro_torch.train import optimizer as topt

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tr = Trainer(cfg, tc, seed=0, device="cuda")
    balanced = tc.moe_balancer is not None
    if balanced:
        check(tr.use_balancer and len(tr.balancers)
              == cfg.n_layers - cfg.first_k_dense,
              f"train: the {label} trainer has {len(tr.balancers)} "
              f"balancers, not one a MoE layer")
        for block in tr.params["blocks"]:
            block["moe"]["router"][:, TRAIN_HOT] += TRAIN_BOOST
    else:
        check(not tr.use_balancer and not tr.balancers,
              f"train: the {label} trainer armed a balancer")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(tr.params))
    update = topt.update
    spent = [0.0, 0]

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - start
        spent[1] += 1
        return out

    make = Recorder if make is None else make
    recs = {name: make(mod, name) for mod, name in names
            if name in recorded}
    tables = {name: getattr(mod, "bwd_routes" if name.endswith(
                                ("_bwd", "_backward")) else "routes")
              for mod, name in names if name in (want_routes or {})}
    for mod, name in names:
        getattr(mod, name).launches = 0
    before = {n: dict(t) for n, t in tables.items()}
    losses, times = [], []
    with contextlib.ExitStack() as stack:
        for rec in recs.values():
            stack.enter_context(rec)
        stack.enter_context(StandIn(topt, "update", timed_update))
        for step in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            start = time.perf_counter()
            m = tr.train_step(batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - start)
            losses.append(m["loss"])
            check(math.isfinite(m["loss"]),
                  f"train: {label} non-finite loss at step {step}")
            more = ""
            if balanced:
                more = (f", dropped {m['dropped_frac']:.4f}, "
                        f"representativeness {m['representativeness']:.4f}, "
                        f"{replicas_equal(torch, tr)} replica slots equal to "
                        f"their primaries")
            log(f"train: {label} step {step}: loss {m['loss']:.5f}, "
                f"{times[-1]:.3f} s{more}")
    launches = {name: getattr(mod, name).launches for mod, name in names}
    routes = {n: {r: t[r] - before[n][r] for r in t if t[r] > before[n][r]}
              for n, t in tables.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    L, S = cfg.n_layers, TRAIN_STEPS
    check(launches == want and routes == (want_routes or {}),
          f"train: {label} launched {launches} by route {routes} over {S} "
          f"steps of {L} layers, not {want} by route {want_routes} (remat "
          f"runs each forward twice a step)")
    check(losses[-1] < losses[0],
          f"train: the {label} loss did not fall ({losses[0]:.5f} -> "
          f"{losses[-1]:.5f})")
    steady = times[1:]
    B, T = batch["tokens"].shape
    if "patches" in batch:
        T += batch["patches"].shape[1]
    summary = dict(n_params=n_params, init_s=init_s, losses=losses,
                   times=times, step_s=sum(steady) / len(steady),
                   tokens=B * T, update_s=spent[0] / max(spent[1], 1),
                   peak_gib=peak, n_layers=L, routes=routes)
    if balanced:
        events = [e for b in tr.balancers for e in b.state.events]
        check(any(e.kind == "sbr_replicate" for e in events),
              f"train: the {label} balancer never replicated the hot expert")
        summary["events"] = [(e.tick, e.kind) for e in events]
        summary["bytes_migrated"] = sum(b.state.bytes_migrated
                                        for b in tr.balancers)
    del tr
    torch.cuda.empty_cache()
    return launches, summary, recs


def rwkv_train_phase(torch, k4, k5, k6):
    """TRAIN_STEPS steps of RWKV6-1.6B at full width on one repeated
    batch (``model_train_phase``): K6's forward twice a layer a step
    (remat runs each block's forward again in the backward) and its
    backward once a layer a step; K4 and K5 (forward and backward) never.
    Returns (launches, a summary, the recorders of K6's forward and
    backward)."""
    cfg, tc, batch = rwkv_train_config(torch)
    names = [(k4, "segment_matmul"), (k4, "segment_matmul_backward"),
             (k5, "flash_attention"), (k5, "flash_attention_bwd"),
             (k6, "rwkv_scan"), (k6, "rwkv_scan_bwd")]
    L, S = cfg.n_layers, TRAIN_STEPS
    want = {n: 0 for _, n in names[:4]}
    want.update(rwkv_scan=2 * L * S, rwkv_scan_bwd=L * S)
    return model_train_phase(torch, "RWKV6", cfg, tc, batch, names,
                             ("rwkv_scan", "rwkv_scan_bwd"), want)


def rwkv_train_replay_phase(torch, k6, recs):
    """K6's forward and backward against their plain versions on the
    inputs the RWKV6 training path gave them (each recorder's first call):
    the forward the same bits with and without its checkpoints and within
    ``check_rwkv``, the backward within ``check_rwkv_bwd``, timed (CUDA
    events) beside its plain version and ``k6_bwd_bound``; then the
    backward at RWKV6's context, 1 x 4096 tokens in the model's layout and
    types, checked and timed alike (a shape the path does not run).
    Returns (the largest errors of the forward and the backward, the JSON
    record's numbers from the path's call)."""
    from repro_torch.kernels import ref
    errs = {"rwkv_scan": 0.0, "rwkv_scan_bwd": 0.0}
    for (args, kw) in recs["rwkv_scan"].first.values():
        B, H, T, hd = args[0].shape
        what = (f"rwkv_scan on the RWKV6 training path's B={B} H={H} T={T} "
                f"hd={hd}")
        check(kw == {"checkpoints": True},
              f"{what}: called with {kw}, not for checkpoints")
        out, fin, _ = k6.rwkv_scan(*args, checkpoints=True)
        check(all(torch.equal(a, b) for a, b in zip(
            (out, fin), k6.rwkv_scan(*args))),
              f"{what}: other bits with its checkpoints")
        errs["rwkv_scan"] = max(errs["rwkv_scan"], check_rwkv(
            torch, what, (out, fin), args)[0])
        with_ck = time_ms(torch, lambda *a: k6.rwkv_scan(
            *a, checkpoints=True), args, 20)
        b_ms, b_by = k6_bound(B, H, T, hd, args[5] is not None,
                              args[0].element_size(), args[3].element_size())
        log(f"replay: {what}: {with_ck:.5f} ms with its checkpoints, "
            f"{time_ms(torch, k6.rwkv_scan, args, 20):.5f} ms without "
            f"(bound without {b_ms:.5f} ms by {b_by}; the checkpoints add "
            f"{4 * B * H * -(-T // k6.CHECKPOINT_EVERY) * hd * hd / 2**20:.0f}"
            f" MiB of writes)")
    main = None
    C = k6.CHECKPOINT_EVERY
    long_args = rwkv_inputs(torch, 95, 1, 32, RWKV_CONTEXT, 64, False, True,
                            K6_KINDS[1])
    long_dout = randn(torch, 96, (1, RWKV_CONTEXT, 32, 64), torch.bfloat16
                      ).transpose(1, 2)
    _, _, long_ck = k6.rwkv_scan(*long_args, checkpoints=True)
    firsts = [(args, kw) for args, kw in recs["rwkv_scan_bwd"].first.values()]
    cases = [(a[:6], a[6], a[7], kw["checkpoints"], True) for a, kw in firsts]
    cases.append((long_args, long_dout, None, long_ck, False))
    for args, dout, ds, ck, on_path in cases:
        B, H, T, hd = args[0].shape
        what = (f"rwkv_scan_bwd on the RWKV6 training path's B={B} H={H} "
                f"T={T} hd={hd}" if on_path else
                f"rwkv_scan_bwd at RWKV6's context, B={B} H={H} T={T}")
        check(ck is not None and ck.shape[2] == -(-T // C),
              f"{what}: no checkpoints")
        got = k6.rwkv_scan_bwd(*args, dout, ds, checkpoints=ck)
        errs["rwkv_scan_bwd"] = max(errs["rwkv_scan_bwd"], check_rwkv_bwd(
            torch, what, got, args, dout, ds))
        del got
        ms = time_ms(torch, lambda *a: k6.rwkv_scan_bwd(
            *a, checkpoints=ck), (*args, dout, ds), 10)
        plain_ms = time_ms(torch, ref.rwkv_scan_bwd, (*args, dout, ds), 2)
        b_ms, b_by = k6_bwd_bound(B, H, T, hd, args[0].element_size(),
                                  args[3].element_size(),
                                  args[5] is not None, ds is not None)
        log(f"replay: {what} (r, k, v, dout {args[0].dtype}, w "
            f"{args[3].dtype}): {ms:.5f} ms (plain {plain_ms:.5f} ms, "
            f"bound {b_ms:.5f} ms by {b_by}, {100 * b_ms / ms:.1f}% of it; "
            f"library: none, no single PyTorch call computes this "
            f"recurrence's gradients)")
        if on_path and main is None:
            main = (ms, plain_ms, b_ms, b_by)
    check(main is not None, "replay: K6's backward was not recorded on the "
                            "RWKV6 training path")
    del long_args, long_dout, long_ck, cases
    torch.cuda.empty_cache()
    return errs, main


def rwkv_train_slice_model(torch, seed: int):
    """RWKV6-1.6B at full width and TRAIN_SLICE_LAYERS layers, float32
    compute, weights from ``seed`` on the card and a copy on the host, and
    a TRAIN_SLICE_B x TRAIN_SLICE_S batch from ``seed + 1``.  Returns
    (cfg, card params, host params, batch)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config("rwkv6-1.6b"),
                              n_layers=TRAIN_SLICE_LAYERS,
                              compute_dtype="float32")
    gpu = init_params(cfg, seed, "cuda")
    rng = np.random.default_rng(seed + 1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_SLICE_B, TRAIN_SLICE_S))) for k in
        ("tokens", "labels")}
    return cfg, gpu, _to_cpu(gpu), batch


def rwkv_train_slice_phase(torch):
    """The RWKV6 training path's gradient at 2 layers, card against host:
    one ``loss_fn`` gradient (remat) of the same weights (seed 0) and
    batch through K6's forward and backward on the card (float32) and
    their plain versions on the host.  The loss within
    RWKV_TRAIN_SLICE_LOSS_TOL, every gradient leaf within
    RWKV_TRAIN_SLICE_TOL of its largest entry.  Returns a summary dict."""
    from repro_torch.kernels import rwkv_scan as krw

    cfg, gpu, cpu, batch = rwkv_train_slice_model(torch, 0)
    before = (krw.rwkv_scan.launches, krw.rwkv_scan_bwd.launches)
    card = train_slice_grads(torch, cfg, gpu, batch, None, "cuda")
    took = (krw.rwkv_scan.launches - before[0],
            krw.rwkv_scan_bwd.launches - before[1])
    L = TRAIN_SLICE_LAYERS
    check(took == (2 * L, L),
          f"train slice: the RWKV6 card side launched K6's forward and "
          f"backward {took} times, not {(2 * L, L)}")
    t0 = time.perf_counter()
    host = train_slice_grads(torch, cfg, cpu, batch, None, "cpu")
    cpu_s = time.perf_counter() - t0
    check(math.isfinite(card[0]) and all(bool(torch.isfinite(g).all())
                                         for g in card[1]),
          "train slice: RWKV6 non-finite loss or gradient on the card")
    r = train_slice_compare(card, host)
    check(r["loss_err"] <= RWKV_TRAIN_SLICE_LOSS_TOL,
          f"train slice: RWKV6 card and host losses differ by "
          f"{r['loss_err']:.3g} (> {RWKV_TRAIN_SLICE_LOSS_TOL})")
    check(r["grad_rel"] <= RWKV_TRAIN_SLICE_TOL,
          f"train slice: an RWKV6 gradient leaf differs by "
          f"{r['grad_rel']:.3g} of its largest entry (> "
          f"{RWKV_TRAIN_SLICE_TOL})")
    del gpu, cpu
    torch.cuda.empty_cache()
    r["cpu_s"] = cpu_s
    return r


def rwkv_train_slice_readings(torch, seeds=(0, 1, 2)):
    """The readings RWKV_TRAIN_SLICE_TOL and RWKV_TRAIN_SLICE_LOSS_TOL are
    set from: at each seed, the card against the host, sound and with each
    planted fault of K6's backward (``rwkv_bwd_faults``) and forward
    (``rwkv_planted_faults``) on the card's side."""
    from repro_torch.kernels import rwkv_scan as krw

    runs = {}
    for seed in seeds:
        cfg, gpu, cpu, batch = rwkv_train_slice_model(torch, seed)
        host = train_slice_grads(torch, cfg, cpu, batch, None, "cpu")
        stand_ins = [("sound", contextlib.nullcontext())] + [
            (n, StandIn(krw, "rwkv_scan_bwd", f))
            for n, f in rwkv_bwd_faults(torch, krw)] + [
            (n, StandIn(m, a, f))
            for n, m, a, f in rwkv_planted_faults(torch, krw)
            if n != "K6 ignores state0"]      # training passes no state0
        for name, stand_in in stand_ins:
            with stand_in:
                card = train_slice_grads(torch, cfg, gpu, batch, None, "cuda")
            r = train_slice_compare(card, host)
            runs.setdefault(name, []).append(r)
            log(f"readings: rwkv train slice seed {seed}: {name}: |loss "
                f"diff| {r['loss_err']:.3g} (loss {r['loss']:.5f}), "
                f"gradients within {r['grad_rel']:.3g} of each leaf's "
                f"largest entry over {r['leaves']} leaves")
        del gpu, cpu, host
        torch.cuda.empty_cache()
    for name, rs in runs.items():
        log(f"readings: rwkv train slice {name} over seeds {list(seeds)}: "
            f"|loss diff| up to {max(r['loss_err'] for r in rs):.3g}, "
            f"gradients {min(r['grad_rel'] for r in rs):.3g} to "
            f"{max(r['grad_rel'] for r in rs):.3g}")
    log(f"readings: rwkv train slice limits: RWKV_TRAIN_SLICE_TOL "
        f"{RWKV_TRAIN_SLICE_TOL}, RWKV_TRAIN_SLICE_LOSS_TOL "
        f"{RWKV_TRAIN_SLICE_LOSS_TOL}")
    return runs


def log_rwkv_train(tn, launches, smi: str) -> None:
    log(f"train: RWKV6-1.6B at full width, {tn['n_layers']} layers "
        f"({tn['n_params']:,} float32 params from seed 0 in "
        f"{tn['init_s']:.1f} s), no balancer, batch {TRAIN_B} x {TRAIN_S}, "
        f"{TRAIN_STEPS} steps with remat: loss {tn['losses'][0]:.5f} -> "
        f"{tn['losses'][-1]:.5f}; {tn['step_s']:.4f} s a step after the "
        f"first ({tn['times'][0]:.3f} s), {tn['tokens'] / tn['step_s']:.1f} "
        f"tokens/s, the AdamW update {tn['update_s']:.4f} s a step "
        f"({100 * tn['update_s'] / tn['step_s']:.1f}%), peak "
        f"{tn['peak_gib']:.2f} GiB; launches {launches} | {smi}")


def rwkv_train_phases(torch, kseg, kfa, krw, kernel_err: float, smi: str):
    """Phase 10's RWKV6 part after its kernel checks: the training path,
    K6 replayed on its inputs, the 2-layer slice.  Returns (the JSON record
    of K6's backward, the largest error of K6's forward in this phase, K6's
    forward launches on the path)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, tn, recs = rwkv_train_phase(torch, kseg, kfa, krw)
    log_rwkv_train(tn, launches, smi)
    errs, (ms, plain_ms, b_ms, b_by) = rwkv_train_replay_phase(torch, krw,
                                                               recs)
    del recs
    sl = rwkv_train_slice_phase(torch)
    log(f"train slice: RWKV6-1.6B at {TRAIN_SLICE_LAYERS} layers, float32, "
        f"a {TRAIN_SLICE_B} x {TRAIN_SLICE_S} batch, card vs host: |loss "
        f"diff| {sl['loss_err']:.3g} (allowed {RWKV_TRAIN_SLICE_LOSS_TOL}; "
        f"loss {sl['loss']:.5f}), every one of {sl['leaves']} gradient "
        f"leaves within {sl['grad_rel']:.3g} of its largest entry (allowed "
        f"{RWKV_TRAIN_SLICE_TOL}); host side {sl['cpu_s']:.2f} s")
    log(f"train: RWKV6 phase in {time.perf_counter() - t0:.1f} s")
    record = dict(
        name="rwkv_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rwkv_scan.cu",
        replaces="src/repro/kernels/rwkv_scan.py:40 (its autodiff: the "
                 "lax.scan of src/repro/models/ssm.py:99-110)",
        launches=launches["rwkv_scan_bwd"],
        max_abs_err=max(kernel_err, errs["rwkv_scan_bwd"]), ms=ms,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return record, errs["rwkv_scan"], launches["rwkv_scan"]


# --------------------------------------------------------------------- #
# 9b, 10c and 12. Decoders that read rows ahead of their text:            #
# InternVL2-2B (vlm) and Whisper-medium (encdec): serve, train, slices    #
# --------------------------------------------------------------------- #
def depth(cfg) -> str:
    """A model's layers as the logs give them: an encoder's first."""
    return (f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.n_enc_layers
            else str(cfg.n_layers))


def family_rows(torch, fam: Family, cfg, seed: int, batch: int):
    """``batch`` x ``fam.rows`` float32 rows at ``fam.std`` from ``seed``,
    on the host."""
    return randn(torch, seed, (batch, getattr(cfg, fam.rows), cfg.d_model),
                 torch.float32, fam.std).cpu()


def family_slice_model(torch, fam: Family, seed: int):
    """``fam`` at full width and 2 layers (``slice_model``) with weights
    from ``seed`` on the card and a copy on the host, SLICE_B x (SLICE_S +
    SLICE_STEPS) tokens from ``seed + 1`` and SLICE_B seeded rows from
    ``seed + 2``, on the host.  Returns (cfg, card params, host params,
    tokens, the batch's rows as a dict)."""
    cfg, gpu, cpu, toks = slice_model(torch, seed, fam.arch)
    extra = {fam.extra: family_rows(torch, fam, cfg, seed + 2, SLICE_B)}
    return cfg, gpu, cpu, toks, extra


def family_slice_phase(torch, fam: Family):
    """``fam`` at full width and 2 layers, the same weights (seed 0) on the
    card (K5 on its wgmma kernel, ``fam.prefill_k5`` calls for the prefill
    and ``fam.step_k5`` a decode step) and on the host (its plain version),
    behind seeded rows: every text position of a SLICE_B x SLICE_S prefill
    and SLICE_STEPS teacher-forced decode steps within ``fam.slice_tol``,
    greedy tokens equal where the card's top-2 margin exceeds it.  Returns
    a summary dict."""
    from repro_torch.kernels import flash_attention as kfa

    cfg, gpu, cpu, toks, extra = family_slice_model(torch, fam, 0)
    before = dict(kfa.routes)
    card = slice_logits(torch, cfg, gpu, toks, "cuda", **extra)
    took = {r: kfa.routes[r] - before[r] for r in kfa.ROUTES
            if kfa.routes[r] > before[r]}
    want = fam.prefill_k5(cfg) + SLICE_STEPS * fam.step_k5(cfg)
    check(took == {"wgmma": want},
          f"slice: the {fam.label} card side ran K5 {took}, not {want} "
          f"times on its wgmma kernel")
    t0 = time.perf_counter()
    host = slice_logits(torch, cfg, cpu, toks, "cpu", **extra)
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(card[0]).all()
               and torch.isfinite(host[0]).all()),
          f"slice: {fam.label} non-finite logits")
    tol = fam.slice_tol
    r = rwkv_slice_compare(card, host, tol)
    check(r["err"] <= tol, f"slice: {fam.label} card and host logits differ "
                           f"by {r['err']:.4g} (> {tol})")
    check(r["agree"] == r["decided"],
          f"slice: {fam.label} greedy tokens differ at "
          f"{r['decided'] - r['agree']} of the {r['decided']} tokens whose "
          f"top-2 margin exceeds {tol}")
    del gpu, cpu
    torch.cuda.empty_cache()
    r.update(cpu_s=cpu_s, depth=depth(cfg), rows=getattr(cfg, fam.rows))
    return r


def family_serve_phase(torch, fam: Family, kseg, kfa, kernel_mods, smi: str):
    """``fam``'s serve at its published depth behind the engine's zero rows
    (K5 ``fam.prefill_k5`` times a prefill and ``fam.step_k5`` times a
    decode step, every call on its wgmma kernel; K4 and K6 never), K5
    replayed on the serve's inputs and the slice check.  Returns (K5's
    launches in the serve, the largest replay error, the replay's numbers
    of K5)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(fam.arch)
    recs = (Recorder(kseg, "segment_matmul"), Recorder(kfa, "flash_attention"))
    launches, sv = serve_phase(torch, kernel_mods, fam.arch, recs)
    log_serve(fam.label, sv, launches, smi)
    per_prefill, per_step = fam.prefill_k5(cfg), fam.step_k5(cfg)
    n = per_prefill * sv["prefill"][1] + per_step * sv["decode"][1]
    got = sv["routes"]["flash_attention"]
    check(launches["flash_attention"] == n and got == {"fma": 0, "wgmma": n},
          f"serve: {fam.label} ran flash_attention {got} over "
          f"{sv['prefill'][1]} prefills and {sv['decode'][1]} decode steps, "
          f"not {per_prefill} a prefill and {per_step} a step on wgmma")
    check(launches["segment_matmul"] == 0 and launches["rwkv_scan"] == 0,
          f"serve: the {fam.label} serve launched K4 or K6: {launches}")
    errs, main = model_replay_phase(torch, kseg, kfa, {}, recs[1].first,
                                    long_context=False)
    del recs
    torch.cuda.empty_cache()
    sl = family_slice_phase(torch, fam)
    log(f"slice: {fam.label} at {sl['depth']} layers, card vs host over "
        f"{sl['tokens']} tokens ({SLICE_B} x {SLICE_S} prompt positions "
        f"behind {sl['rows']} seeded {fam.rows_name}, {SLICE_STEPS} decode "
        f"steps): max |logit diff| {sl['err']:.5f} (allowed "
        f"{fam.slice_tol}; prompt {sl['prompt_err']:.5f}, per decode step "
        f"{[round(e, 5) for e in sl['steps']]}); greedy tokens equal at "
        f"{sl['agree']} of the {sl['decided']} whose top-2 margin exceeds "
        f"{fam.slice_tol}, and at {sl['equal']} of all {sl['tokens']}; "
        f"host side {sl['cpu_s']:.2f} s")
    log(f"serve: {fam.label} phase in {time.perf_counter() - t0:.1f} s")
    return (launches["flash_attention"], errs["flash_attention"],
            main["flash_attention"])


def family_train_config(torch, fam: Family):
    """``fam``'s training path's model, training config and batch: the
    published config whole, bf16 compute, remat, no balancer (no experts);
    TRAIN_B x TRAIN_S tokens from ``SkewAwarePipeline`` (as
    ``rwkv_train_config`` builds them) behind TRAIN_B rows from
    ``fam.train_rows``, made on the card."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import (PipelineConfig, SkewAwarePipeline,
                                  zipf_doc_lengths)
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config(fam.arch)
    tc = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                     total_steps=TRAIN_STEPS),
                     remat=True, moe_balancer=None)
    pipe = SkewAwarePipeline(PipelineConfig(
        seq_len=TRAIN_S, batch_per_shard=max(TRAIN_B // 8, 1), n_shards=8,
        vocab=cfg.vocab))
    pipe.ingest(zipf_doc_lengths(64, TRAIN_S, seed=0))
    nb = pipe.next_batch()
    batch = {k: torch.from_numpy(np.ascontiguousarray(nb[k][:TRAIN_B]))
             for k in ("tokens", "labels")}
    batch[fam.extra] = fam.train_rows(
        torch, (TRAIN_B, getattr(cfg, fam.rows), cfg.d_model))
    return cfg, tc, batch


def family_train_slice_runs(torch, fam: Family, seed: int, runs):
    """``loss_fn`` gradients (remat) of ``fam`` at full width and
    TRAIN_SLICE_LAYERS layers (an encoder cut to as many) in float32 (K5 on
    its fma routes), weights from ``seed``, a TRAIN_SLICE_B x TRAIN_SLICE_S
    batch from ``seed + 1`` behind seeded rows from ``seed + 2``: on the
    card once for each of ``runs`` ((name, [(module, wrapper name,
    stand-in)]) pairs, the stand-ins in place) and once on the host.
    Returns ({name: (card result, the card's K5 launches by route, its
    backward's launches)}, host result, cfg)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import init_params

    cfg = get_config(fam.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=TRAIN_SLICE_LAYERS,
        n_enc_layers=min(cfg.n_enc_layers, TRAIN_SLICE_LAYERS),
        compute_dtype="float32")
    gpu = init_params(cfg, seed, "cuda")
    rng = np.random.default_rng(seed + 1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_SLICE_B, TRAIN_SLICE_S))) for k in
        ("tokens", "labels")}
    batch[fam.extra] = family_rows(torch, fam, cfg, seed + 2, TRAIN_SLICE_B)
    tables = (kfa.routes, kfa.bwd_routes)
    out = {}
    for name, faults in runs:
        before = [dict(t) for t in tables]
        bwd = kfa.flash_attention_bwd.launches
        with contextlib.ExitStack() as stack:
            for mod, attr, fn in faults:
                stack.enter_context(StandIn(mod, attr, fn))
            card = train_slice_grads(torch, cfg, gpu, batch, None, "cuda")
        out[name] = (card, [{r: t[r] - b[r] for r in t if t[r] > b[r]}
                            for t, b in zip(tables, before)],
                     kfa.flash_attention_bwd.launches - bwd)
    host = train_slice_grads(torch, cfg, _to_cpu(gpu), batch, None, "cpu")
    del gpu
    torch.cuda.empty_cache()
    return out, host, cfg


def family_train_slice_phase(torch, fam: Family):
    """``fam``'s training path's gradient at TRAIN_SLICE_LAYERS layers,
    card against host (``family_train_slice_runs``, seed 0): K5's forward
    twice a call under remat and its backward once, all on the fma routes;
    the loss within ``fam.train_slice_loss_tol`` and every gradient leaf
    (an encoder's and a cross attention's included) within
    ``fam.train_slice_tol`` of its largest entry.  Returns a summary
    dict."""
    from repro_torch.kernels import flash_attention as kfa

    t0 = time.perf_counter()
    runs, host, cfg = family_train_slice_runs(torch, fam, 0, [("sound", [])])
    card, took, bwd = runs["sound"]
    n = fam.prefill_k5(cfg)
    want = [{"fma": 2 * n}, {"fma": kfa.BWD_LAUNCHES["fma"] * n}]
    check(took == want and bwd == want[1]["fma"],
          f"train slice: the {fam.label} card side ran K5 / its backward "
          f"on {took} with {bwd} backward launches, not {want} (forward "
          f"twice a call under remat, backward once)")
    check(math.isfinite(card[0]) and all(bool(torch.isfinite(g).all())
                                         for g in card[1]),
          f"train slice: {fam.label} non-finite loss or gradient on the card")
    r = train_slice_compare(card, host)
    check(r["loss_err"] <= fam.train_slice_loss_tol,
          f"train slice: {fam.label} card and host losses differ by "
          f"{r['loss_err']:.3g} (> {fam.train_slice_loss_tol})")
    check(r["grad_rel"] <= fam.train_slice_tol,
          f"train slice: a {fam.label} gradient leaf differs by "
          f"{r['grad_rel']:.3g} of its largest entry (> "
          f"{fam.train_slice_tol})")
    r.update(s=time.perf_counter() - t0, depth=depth(cfg),
             rows=getattr(cfg, fam.rows))
    return r


def family_train_phases(torch, fam: Family, kseg, kfa, krw, smi: str):
    """``fam`` at its published depth trained TRAIN_STEPS steps (K5's
    forward twice a call a step under remat, its backward once, all on the
    wgmma routes; K4 and K6 never), K5 forward and backward replayed on the
    path's own inputs and the float32 gradient slice.  Returns (the path's
    launches, the replay's largest errors, the replay's numbers of K5's
    backward)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, tc, batch = family_train_config(torch, fam)
    names = [(kseg, "segment_matmul"), (kseg, "segment_matmul_backward"),
             (kfa, "flash_attention"), (kfa, "flash_attention_bwd"),
             (krw, "rwkv_scan"), (krw, "rwkv_scan_bwd")]
    n, S = fam.prefill_k5(cfg), TRAIN_STEPS
    bwd = kfa.BWD_LAUNCHES["wgmma"] * n * S
    want = dict(segment_matmul=0, segment_matmul_backward=0,
                flash_attention=2 * n * S, flash_attention_bwd=bwd,
                rwkv_scan=0, rwkv_scan_bwd=0)
    launches, tn, recs = model_train_phase(
        torch, fam.label, cfg, tc, batch, names,
        [name for _, name in names[:4]], want,
        {"flash_attention": {"wgmma": 2 * n * S},
         "flash_attention_bwd": {"wgmma": bwd}})
    del batch
    log(f"train: {fam.label} at full width, {depth(cfg)} layers "
        f"({tn['n_params']:,} float32 params from seed 0 in "
        f"{tn['init_s']:.1f} s), no balancer, batch {TRAIN_B} x "
        f"({getattr(cfg, fam.rows)} {fam.train_rows_name} + {TRAIN_S} "
        f"tokens), {TRAIN_STEPS} steps with remat: loss "
        f"{tn['losses'][0]:.5f} -> {tn['losses'][-1]:.5f} "
        f"({[round(x, 5) for x in tn['losses']]}); {tn['step_s']:.4f} s a "
        f"step after the first ({tn['times'][0]:.3f} s), "
        f"{tn['tokens'] / tn['step_s']:.1f} decoder positions/s "
        f"({TRAIN_B * TRAIN_S / tn['step_s']:.1f} text tokens/s), the AdamW "
        f"update {tn['update_s']:.4f} s a step "
        f"({100 * tn['update_s'] / tn['step_s']:.1f}%), peak "
        f"{tn['peak_gib']:.2f} GiB; launches {launches} by route "
        f"{tn['routes']} | {smi}")
    errs, main = train_replay_phase(torch, kseg, kfa, recs,
                                    f"{fam.label} training path",
                                    long_context=False)
    del recs
    sl = family_train_slice_phase(torch, fam)
    log(f"train slice: {fam.label} at {sl['depth']} layers, float32, a "
        f"{TRAIN_SLICE_B} x ({sl['rows']} seeded {fam.rows_name} + "
        f"{TRAIN_SLICE_S} tokens) batch, card vs host: |loss diff| "
        f"{sl['loss_err']:.3g} (allowed {fam.train_slice_loss_tol}; loss "
        f"{sl['loss']:.5f}), every one of {sl['leaves']} gradient leaves "
        f"within {sl['grad_rel']:.3g} of its largest entry (allowed "
        f"{fam.train_slice_tol}); {sl['s']:.1f} s")
    log(f"train: {fam.label} phase in {time.perf_counter() - t0:.1f} s")
    return launches, errs, main.get("flash_attention_bwd")


def family_readings(torch, fam: Family, seeds=(0, 1, 2)):
    """The readings ``fam``'s slice limits are set from: at each seed, the
    serve slice's card against its host as the check compares them, sound
    and with each of ``vlm_planted_faults`` on the card's side (K5's mask
    off, q scaled twice, q's last of hd's terms dropped), and the train
    slice's, sound and with those and K5's backward faults of
    ``train_planted_faults``."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    fwd_faults = vlm_planted_faults(ksm, kfa)
    faults = fwd_faults + [f for f in train_planted_faults(ksm, kfa)
                           if f[1] is kfa]
    serve, train = {}, {}
    for seed in seeds:
        cfg, gpu, cpu, toks, extra = family_slice_model(torch, fam, seed)
        host = slice_logits(torch, cfg, cpu, toks, "cpu", **extra)
        for name, stand_in in [("sound", contextlib.nullcontext())] + [
                (n, StandIn(m, a, f)) for n, m, a, f in fwd_faults]:
            with stand_in:
                card = slice_logits(torch, cfg, gpu, toks, "cuda", **extra)
            r = rwkv_slice_compare(card, host, fam.slice_tol)
            serve.setdefault(name, []).append(r["err"])
            log(f"readings: {fam.label} slice seed {seed}: {name}: max "
                f"|card - host| {r['err']:.6f} (prompt "
                f"{r['prompt_err']:.6f}; per decode step "
                f"{[round(e, 6) for e in r['steps']]}); greedy equal at "
                f"{r['equal']} of {r['tokens']}, and at {r['agree']} of the "
                f"{r['decided']} with a top-2 margin above {fam.slice_tol}")
        del gpu, cpu, host
        torch.cuda.empty_cache()
        runs, host, _ = family_train_slice_runs(
            torch, fam, seed, [("sound", [])] + [(n, [(m, a, f)])
                                                 for n, m, a, f in faults])
        for name, (card, _, _) in runs.items():
            r = train_slice_compare(card, host)
            train.setdefault(name, []).append((r["grad_rel"],
                                               r["loss_err"]))
            log(f"readings: {fam.label} train slice seed {seed}: {name}: "
                f"|loss diff| {r['loss_err']:.3g} (loss {r['loss']:.5f}), "
                f"gradients within {r['grad_rel']:.3g} of each leaf's "
                f"largest entry over {r['leaves']} leaves")
    for name, errs in serve.items():
        log(f"readings: {fam.label} slice {name} over seeds {list(seeds)}: "
            f"max |diff| {min(errs):.6f} to {max(errs):.6f}")
    for name, rs in train.items():
        log(f"readings: {fam.label} train slice {name} over seeds "
            f"{list(seeds)}: gradients {min(g for g, _ in rs):.3g} to "
            f"{max(g for g, _ in rs):.3g}, |loss diff| "
            f"{min(e for _, e in rs):.3g} to {max(e for _, e in rs):.3g}")
    log(f"readings: {fam.label} limits: slice {fam.slice_tol}, train slice "
        f"{fam.train_slice_tol}, its loss {fam.train_slice_loss_tol}")
    return serve, train


# --------------------------------------------------------------------- #
# 11. MLA: MiniCPM3-4B and DeepSeek-V2-Lite, serve and train             #
# --------------------------------------------------------------------- #
def mla_slice_compare(arch: str, card, host):
    """The serve slice's comparison of ``arch``: with experts (DeepSeek)
    ``slice_compare``'s (moved experts judged apart), else
    ``rwkv_slice_compare``'s at MLA_SLICE_TOL."""
    if arch == "deepseek-v2-lite-16b":
        return slice_compare(card, host)
    return rwkv_slice_compare(card, host, MLA_SLICE_TOL)


def mla_slice_phase(torch, arch: str):
    """``arch`` at full width and 2 layers, the same weights (seed 0) on
    the card (K5 once a layer on its wgmma kernel at the model's widths;
    DeepSeek's MoE layer through K4) and on the host (their plain
    versions), over every token of a SLICE_B x SLICE_S prefill and
    SLICE_STEPS decode steps (the weight-absorbed path, plain PyTorch on
    both sides).  MiniCPM3: logits within MLA_SLICE_TOL everywhere, greedy
    tokens equal where the card's top-2 margin exceeds it; DeepSeek:
    within MLA_MOE_SLICE as ``slice_phase`` holds OLMoE.  Returns a
    summary dict."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    name = MLA_NAMES[arch]
    cfg, gpu, cpu, toks = slice_model(torch, 0, arch)
    before, k4_before = dict(kfa.routes), ksm.segment_matmul.launches
    card = slice_logits(torch, cfg, gpu, toks, "cuda")
    took = {r: kfa.routes[r] - before[r] for r in kfa.ROUTES
            if kfa.routes[r] > before[r]}
    check(took == {"wgmma": cfg.n_layers},
          f"slice: the {name} card side ran K5 {took}, not once a layer on "
          f"its wgmma kernel")
    check((ksm.segment_matmul.launches > k4_before) == bool(cfg.n_experts),
          f"slice: the {name} card side's K4 launches do not fit its "
          f"experts")
    t0 = time.perf_counter()
    host = slice_logits(torch, cfg, cpu, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    check(bool(torch.isfinite(card[0]).all()
               and torch.isfinite(host[0]).all()),
          f"slice: {name} non-finite logits")
    r = mla_slice_compare(arch, card, host)
    if cfg.n_experts:
        tol, moved, cap = MLA_MOE_SLICE
        check(r["stayed_err"] <= tol,
              f"slice: {name} card and host logits differ by "
              f"{r['stayed_err']:.4g} (> {tol}) at a token whose experts did "
              f"not move")
        check(r["moved"] <= moved and r["moved_err"] <= cap,
              f"slice: {name}: the experts of {r['moved']} tokens moved "
              f"(allowed {moved}), their logits by {r['moved_err']:.4g} "
              f"(allowed {cap})")
    else:
        check(r["err"] <= MLA_SLICE_TOL,
              f"slice: {name} card and host logits differ by "
              f"{r['err']:.4g} (> {MLA_SLICE_TOL})")
    check(r["agree"] == r["decided"],
          f"slice: {name} greedy tokens differ at "
          f"{r['decided'] - r['agree']} of the {r['decided']} tokens whose "
          f"top-2 margin exceeds the limit")
    del gpu, cpu
    torch.cuda.empty_cache()
    r["cpu_s"] = cpu_s
    return r


def log_mla_slice(arch: str, sl) -> None:
    name = MLA_NAMES[arch]
    if "stayed_err" in sl:
        tol, moved, cap = MLA_MOE_SLICE
        log(f"slice: {name} at 2 layers (the dense first layer and a MoE "
            f"layer), card vs host over {sl['tokens']} tokens ({SLICE_B} x "
            f"{SLICE_S} prompt positions, {SLICE_STEPS} decode steps): "
            f"experts moved at {sl['moved']} (allowed {moved}); max |logit "
            f"diff| {sl['stayed_err']:.5f} at the others (allowed {tol}), "
            f"{sl['moved_err']:.5f} at the moved (allowed {cap}); per decode "
            f"step {[round(e, 5) for e in sl['steps']]}; greedy tokens equal "
            f"at {sl['agree']} of the {sl['decided']} decided, {sl['equal']} "
            f"of all {sl['tokens']}; host side {sl['cpu_s']:.2f} s")
    else:
        log(f"slice: {name} at 2 layers, card vs host over {sl['tokens']} "
            f"tokens ({SLICE_B} x {SLICE_S} prompt positions, {SLICE_STEPS} "
            f"decode steps): max |logit diff| {sl['err']:.5f} (allowed "
            f"{MLA_SLICE_TOL}; prompt {sl['prompt_err']:.5f}, per decode "
            f"step {[round(e, 5) for e in sl['steps']]}); greedy tokens "
            f"equal at {sl['agree']} of the {sl['decided']} decided, "
            f"{sl['equal']} of all {sl['tokens']}; host side "
            f"{sl['cpu_s']:.2f} s")


def mla_context_replay(torch, k5, arch: str):
    """K5's forward at 1 x 4096 tokens with ``arch``'s heads and widths
    (bf16, the model's [B, S, H, d] views, causal, the wgmma kernel)
    against its plain version, timed beside SDPA and its bound.  Returns
    (max error, the timing tuple)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    dk, dv = cfg.qk_nope + cfg.qk_rope, cfg.v_head
    q, k, v = (randn(torch, 95 + i, (1, 4096, cfg.n_heads, d),
                     torch.bfloat16).transpose(1, 2)
               for i, d in enumerate((dk, dk, dv)))
    what = (f"flash_attention at 1 x 4096, {MLA_NAMES[arch]}'s q "
            f"{tuple(q.shape)}")
    err = check_flash(torch, what, k5_call(k5, what, "wgmma", q, k, v), q, k,
                      v, True, dk ** -0.5)
    t = time_k5(torch, k5, q, k, v, 10)
    log(f"replay: {what} v {tuple(v.shape)}: {t[0]:.5f} ms (plain "
        f"{t[1]:.5f} ms, scaled_dot_product_attention {t[2]:.5f} ms, bound "
        f"{t[3]:.5f} ms by {t[4]}, {100 * t[3] / t[0]:.1f}% of bound)")
    del q, k, v
    torch.cuda.empty_cache()
    return err, t


def mla_phase(torch, kseg, kfa, kernel_mods, arch: str, smi: str):
    """Phase 11 for ``arch``: the serve at its published depth (K5 once a
    layer a prefill, every call on its wgmma kernel at the model's widths;
    DeepSeek's K4 three a MoE layer a model call, the prefills' on its
    tiles kernel and the decode steps' on its stream kernel; K6 never), K5
    (and K4) replayed on the serve's inputs, K5 at 1 x 4096 and the
    2-layer slice.  Returns (the serve's launches, the largest replay
    errors, the replay's numbers, the serve's summary)."""
    from repro_torch.configs import get_config

    name, cfg = MLA_NAMES[arch], get_config(arch)
    t0 = time.perf_counter()
    recs = (Recorder(kseg, "segment_matmul"), Recorder(kfa, "flash_attention"))
    launches, sv = serve_phase(torch, kernel_mods, arch, recs)
    log_serve(name, sv, launches, smi)
    want = {"fma": 0, "wgmma": sv["n_layers"] * sv["prefill"][1]}
    got = sv["routes"]["flash_attention"]
    check(launches["flash_attention"] == want["wgmma"] and got == want,
          f"serve: {name} ran flash_attention {got} over {sv['prefill'][1]} "
          f"prefills, not {want}")
    per_call = 3 * (cfg.n_layers - cfg.first_k_dense) if cfg.n_experts else 0
    want4 = {"tiles": per_call * sv["prefill"][1],
             "stream": per_call * sv["decode"][1]}
    got4 = sv["routes"]["segment_matmul"]
    check(launches["segment_matmul"] == per_call * sv["calls"]
          and {r: n for r, n in got4.items() if n}
          == {r: n for r, n in want4.items() if n}
          and launches["rwkv_scan"] == 0,
          f"serve: {name} launched K4 {got4} and K6 {launches['rwkv_scan']} "
          f"times over {sv['calls']} model calls, not K4 {want4} and K6 "
          f"never")
    log(f"serve: {name}: K5 launches by route {got}, K4 by route "
        f"{ {r: n for r, n in got4.items() if n} }")
    errs, main = model_replay_phase(
        torch, kseg, kfa, recs[0].first if cfg.n_experts else {},
        recs[1].first, long_context=False)
    del recs
    torch.cuda.empty_cache()
    err, ctx = mla_context_replay(torch, kfa, arch)
    errs["flash_attention"] = max(errs["flash_attention"], err)
    sl = mla_slice_phase(torch, arch)
    log_mla_slice(arch, sl)
    log(f"serve: {name} phase in {time.perf_counter() - t0:.1f} s")
    return launches, errs, main, sv


def mla_train_config(torch, arch: str):
    """``arch``'s training path: its published widths cut to
    MLA_TRAIN_LAYERS layers, bf16 compute, remat; DeepSeek with
    TRAIN_SLOTS replica slots and the balancer on 4 shards (as
    ``train_config``); the OLMoE path's batch (``SkewAwarePipeline``)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.moe_balancer import MoEBalancerConfig
    from repro_torch.data import (PipelineConfig, SkewAwarePipeline,
                                  zipf_doc_lengths)
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = dataclasses.replace(get_config(arch),
                              n_layers=MLA_TRAIN_LAYERS[arch])
    bal = None
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_replica_slots=TRAIN_SLOTS)
        bal = MoEBalancerConfig(
            n_experts=cfg.n_experts, n_slots=cfg.n_experts + TRAIN_SLOTS,
            n_shards=4, min_steps_between=2)
    tc = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                     total_steps=TRAIN_STEPS),
                     remat=True, moe_balancer=bal)
    pipe = SkewAwarePipeline(PipelineConfig(
        seq_len=TRAIN_S, batch_per_shard=max(TRAIN_B // 8, 1), n_shards=8,
        vocab=cfg.vocab))
    pipe.ingest(zipf_doc_lengths(64, TRAIN_S, seed=0))
    nb = pipe.next_batch()
    batch = {k: torch.from_numpy(np.ascontiguousarray(nb[k][:TRAIN_B]))
             for k in ("tokens", "labels")}
    return cfg, tc, batch


def mla_train_slice_model(torch, seed: int, arch: str):
    """``arch`` at full width and TRAIN_SLICE_LAYERS layers, float32
    compute (K5 and K4 on their fma routes), weights from ``seed`` on the
    card and a copy on the host, a TRAIN_SLICE_B x TRAIN_SLICE_S batch
    from ``seed + 1``; DeepSeek with TRAIN_SLOTS replica slots and
    ``train_slice_model``'s split table on its MoE layer.  Returns (cfg,
    card params, host params, batch, routing)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(arch), n_layers=TRAIN_SLICE_LAYERS,
                              compute_dtype="float32")
    routing = None
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, moe_replica_slots=TRAIN_SLOTS)
        E, P = cfg.n_experts, cfg.n_experts + TRAIN_SLOTS
        routing = torch.zeros((cfg.n_layers - cfg.first_k_dense, E, P))
        routing[:, torch.arange(E), torch.arange(E)] = 1.0
        routing[:, 0, 0], routing[:, 0, E] = 0.6, 0.4
    gpu = init_params(cfg, seed, "cuda")
    rng = np.random.default_rng(seed + 1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_SLICE_B, TRAIN_SLICE_S))) for k in
        ("tokens", "labels")}
    return cfg, gpu, _to_cpu(gpu), batch, routing


def mla_train_slice_phase(torch, arch: str):
    """``arch``'s training gradient at 2 layers, card against host: one
    ``loss_fn`` gradient (remat) of the same weights (seed 0) and batch
    through K5's (and DeepSeek's K4's) forward and backward on the card
    (float32: the fma routes) and their plain versions on the host; the
    loss within TRAIN_SLICE_LOSS_TOL, every gradient leaf within
    TRAIN_SLICE_TOL of its largest entry.  Returns a summary dict."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    name = MLA_NAMES[arch]
    cfg, gpu, cpu, batch, routing = mla_train_slice_model(torch, 0, arch)
    tables = (kfa.routes, kfa.bwd_routes, ksm.routes, ksm.bwd_routes)
    before = [dict(t) for t in tables]
    card = train_slice_grads(torch, cfg, gpu, batch, routing, "cuda")
    took = [{r: t[r] - b[r] for r in t if t[r] > b[r]}
            for t, b in zip(tables, before)]
    L = TRAIN_SLICE_LAYERS
    want = [{"fma": 2 * L}, {"fma": 2 * L}]
    if cfg.n_experts:
        moe = L - cfg.first_k_dense
        want += [{"fma": 3 * 2 * moe}, {"fma": 2 * 3 * moe}]
    else:
        want += [{}, {}]
    check(took == want, f"train slice: the {name} card side ran K5 / its "
                        f"backward / K4 / its backward on {took}, not {want}")
    t0 = time.perf_counter()
    host = train_slice_grads(torch, cfg, cpu, batch, routing, "cpu")
    cpu_s = time.perf_counter() - t0
    check(math.isfinite(card[0]) and all(bool(torch.isfinite(g).all())
                                         for g in card[1]),
          f"train slice: {name} non-finite loss or gradient on the card")
    r = train_slice_compare(card, host)
    check(r["loss_err"] <= TRAIN_SLICE_LOSS_TOL,
          f"train slice: {name} card and host losses differ by "
          f"{r['loss_err']:.3g} (> {TRAIN_SLICE_LOSS_TOL})")
    check(r["grad_rel"] <= TRAIN_SLICE_TOL,
          f"train slice: a {name} gradient leaf differs by "
          f"{r['grad_rel']:.3g} of its largest entry (> {TRAIN_SLICE_TOL})")
    del gpu, cpu
    torch.cuda.empty_cache()
    r["cpu_s"] = cpu_s
    return r


def mla_train_phase(torch, kseg, kfa, krw, arch: str, smi: str):
    """Phase 10's part for ``arch``: MLA_TRAIN_LAYERS layers trained
    TRAIN_STEPS steps (``model_train_phase``): K5's forward twice a layer
    a step on its wgmma kernel and its backward once a layer on the route
    of its widths (wgmma at both); DeepSeek's K4
    forward three a MoE layer a forward run on its tiles kernel and its
    backward on the dx and dw forms, the balancer replicating the hot
    expert; K6 never.  Then K5 (and K4) forward and backward replayed on
    the path's inputs, K5's backward at 1 x 4096 with the model's heads
    and widths, and the 2-layer float32 gradient slice.  Returns (the
    path's launches, the replay's largest errors, the replay's numbers,
    the path's summary)."""
    name = MLA_NAMES[arch]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, tc, batch = mla_train_config(torch, arch)
    names = [(kseg, "segment_matmul"), (kseg, "segment_matmul_backward"),
             (kfa, "flash_attention"), (kfa, "flash_attention_bwd"),
             (krw, "rwkv_scan"), (krw, "rwkv_scan_bwd")]
    L, S = cfg.n_layers, TRAIN_STEPS
    dk, dv = cfg.qk_nope + cfg.qk_rope, cfg.v_head
    broute = "wgmma" if (dk, dv) in kfa.WGMMA_WIDTHS else "fma"
    bwd = kfa.BWD_LAUNCHES[broute] * L * S
    moe = (L - cfg.first_k_dense) if cfg.n_experts else 0
    want = dict(segment_matmul=3 * moe * 2 * S,
                segment_matmul_backward=2 * 3 * moe * S,
                flash_attention=2 * L * S, flash_attention_bwd=bwd,
                rwkv_scan=0, rwkv_scan_bwd=0)
    routes = {"flash_attention": {"wgmma": 2 * L * S},
              "flash_attention_bwd": {broute: bwd}}
    if moe:
        routes["segment_matmul"] = {"tiles": 3 * moe * 2 * S}
        routes["segment_matmul_backward"] = {"dx_tiles": 3 * moe * S,
                                             "dw_tiles": 3 * moe * S}
    launches, tn, recs = model_train_phase(
        torch, name, cfg, tc, batch, names, [n for _, n in names[:4]], want,
        routes)
    del batch
    more = ""
    if moe:
        more = (f", {TRAIN_SLOTS} replica slots and a balancer on each of "
                f"the {moe} MoE layers (events {tn['events']}, "
                f"{tn['bytes_migrated']:,} bytes migrated)")
    log(f"train: {name} at full width, {tn['n_layers']} layers "
        f"({tn['n_params']:,} float32 params from seed 0 in "
        f"{tn['init_s']:.1f} s){more}, batch {TRAIN_B} x {TRAIN_S}, "
        f"{TRAIN_STEPS} steps with remat: loss {tn['losses'][0]:.5f} -> "
        f"{tn['losses'][-1]:.5f} ({[round(x, 5) for x in tn['losses']]}); "
        f"{tn['step_s']:.4f} s a step after the first ({tn['times'][0]:.3f} "
        f"s), {tn['tokens'] / tn['step_s']:.1f} tokens/s, the AdamW update "
        f"{tn['update_s']:.4f} s a step "
        f"({100 * tn['update_s'] / tn['step_s']:.1f}%), peak "
        f"{tn['peak_gib']:.2f} GiB; launches {launches} by route "
        f"{tn['routes']} | {smi}")
    errs, main = train_replay_phase(torch, kseg, kfa, recs,
                                    f"{name} training path",
                                    context=(cfg.n_heads, dk, dv))
    del recs
    sl = mla_train_slice_phase(torch, arch)
    log(f"train slice: {name} at {TRAIN_SLICE_LAYERS} layers, float32, a "
        f"{TRAIN_SLICE_B} x {TRAIN_SLICE_S} batch, card vs host: |loss diff| "
        f"{sl['loss_err']:.3g} (allowed {TRAIN_SLICE_LOSS_TOL}; loss "
        f"{sl['loss']:.5f}), every one of {sl['leaves']} gradient leaves "
        f"within {sl['grad_rel']:.3g} of its largest entry (allowed "
        f"{TRAIN_SLICE_TOL}); host side {sl['cpu_s']:.2f} s")
    log(f"train: {name} phase in {time.perf_counter() - t0:.1f} s")
    return launches, errs, main, tn


def mla_slice_readings(torch, seeds=(0, 1, 2)):
    """The readings MLA_SLICE_TOL and MLA_MOE_SLICE are set from: at each
    seed, each MLA model's serve slice, the card against the host as the
    check compares them, sound and with each planted fault on the card's
    side (``vlm_planted_faults``: K5's mask off, q scaled twice, q's last
    of dk's terms dropped; DeepSeek also K4's faults).  Returns the
    readings by (arch, run name), a list per seed."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import segment_matmul as ksm

    runs = {}
    faults = vlm_planted_faults(ksm, kfa) + [
        f for f in planted_faults(ksm, kfa) if f[1] is ksm]
    for arch in MLA_ARCHS:
        for seed in seeds:
            cfg, gpu, cpu, toks = slice_model(torch, seed, arch)
            host = slice_logits(torch, cfg, cpu, toks, "cpu")
            for name, mod, attr, fn in [("sound", None, None, None)] + faults:
                if mod is ksm and not cfg.n_experts:
                    continue
                with (StandIn(mod, attr, fn) if mod is not None
                      else contextlib.nullcontext()):
                    card = slice_logits(torch, cfg, gpu, toks, "cuda")
                r = mla_slice_compare(arch, card, host)
                runs.setdefault((arch, name), []).append(r)
                log(f"readings: {MLA_NAMES[arch]} slice seed {seed}: {name}: "
                    f"{ {k: v for k, v in r.items() if k != 'steps'} }")
            del gpu, cpu, host
            torch.cuda.empty_cache()
    for (arch, name), rs in runs.items():
        key = "stayed_err" if "stayed_err" in rs[0] else "err"
        more = (f"; tokens moved {min(r['moved'] for r in rs)} to "
                f"{max(r['moved'] for r in rs)}, moved-token max |diff| up "
                f"to {max(r['moved_err'] for r in rs):.6f}"
                if key == "stayed_err" else "")
        log(f"readings: {MLA_NAMES[arch]} slice {name} over seeds "
            f"{list(seeds)}: max |diff| {min(r[key] for r in rs):.6f} to "
            f"{max(r[key] for r in rs):.6f}{more}")
    log(f"readings: MLA slice limits: MLA_SLICE_TOL {MLA_SLICE_TOL}, "
        f"MLA_MOE_SLICE {MLA_MOE_SLICE}")
    return runs


def vlm_planted_faults(ksm, kfa):
    """The K5 faults of ``planted_faults`` and one nearer the sound runs:
    K5 fed q with its last of hd's terms zeroed (the call keeps its
    route)."""
    k5 = kfa.flash_attention

    def last_hd_dropped(q, k, v, **kw):
        q = q.clone()
        q[..., -1] = 0
        return k5(q, k, v, **kw)

    return [f for f in planted_faults(ksm, kfa) if f[1] is kfa] + [
        ("K5 drops the last of hd's terms in q", kfa, "flash_attention",
         last_hd_dropped)]


# --------------------------------------------------------------------- #
# Readings: ``python3 chip_smoke.py --readings``                          #
# --------------------------------------------------------------------- #
def planted_faults(ksm, kfa):
    """Faults planted in the card's side of the slice, each a stand-in for
    a kernel's wrapper that still launches the kernel: (name, module,
    wrapper name, stand-in)."""
    k4, k5 = ksm.segment_matmul, kfa.flash_attention

    def mask_off(q, k, v, causal=True, scale=None, **kw):
        return k5(q, k, v, causal=False, scale=scale, **kw)

    def scaled_twice(q, k, v, causal=True, scale=None, **kw):
        return k5(q, k, v, causal=causal, scale=q.shape[-1] ** -0.5, **kw)

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

    def no_bonus(r, k, v, w, u, state0=None, **kw):
        return k6(r, k, v, w, torch.zeros_like(u), state0, **kw)

    def decay_after_add(r, k, v, w, u, state0=None, **kw):
        # S <- diag(w) (S + k v^T): the kernel on w * k carries that state;
        # out_t still takes the bonus of the unscaled k, added back here.
        got = k6(r, torch.mul(w, k, out=torch.empty_like(k)), v, w, u, state0,
                 **kw)
        bonus = (r * u[None, :, None, :] * k * (1 - w)).sum(-1, keepdim=True)
        return (got[0] + bonus * v,) + tuple(got[1:])

    def state0_ignored(r, k, v, w, u, state0=None, **kw):
        return k6(r, k, v, w, u, None, **kw)

    def last_term_dropped(r, k, v, w, u, state0=None, **kw):
        r = r.clone()
        r[..., -1] = 0.0
        return k6(r, k, v, w, u, state0, **kw)

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


def vlm_decode_readings(torch):
    """One decode step of the full-width InternVL2-2B serve (batch
    SERVE_BATCH behind its 1,024 zero patch rows and a 445-token prompt,
    the serve's longest) taken apart: the step (CUDA events over 10
    steps), the host's time to submit one, every weight's float32 -> bf16
    cast timed alone, and a profiler trace of one step (device busy share,
    the ops with the most device time).  Returns the times."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_cache, init_params, prefill

    cfg = get_config(VLM_ARCH)
    params = init_params(cfg, 0, "cuda")
    B, S = SERVE_BATCH, 445
    n = cfg.n_patches + S
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (B, S + 1))).cuda()
    patches = torch.zeros((B, cfg.n_patches, cfg.d_model),
                          dtype=torch.bfloat16, device="cuda")
    cache = init_cache(cfg, B, n + 1, "cuda")
    _, cache = prefill(params, cfg, {"tokens": toks[:, :S],
                                     "patches": patches}, cache)

    def step():
        return decode_step(params, cfg, toks[:, S:], cache, n)[0]

    step_ms = time_ms(torch, step, (), 10)
    submit = submit_ms(torch, step, (), 10)
    weights = [t for t in _leaves(params) if t.dtype == torch.float32]
    casts_ms = time_ms(
        torch, lambda: [t.to(torch.bfloat16) for t in weights], (), 5)
    prof, spans, busy_us = profile_busy(torch, step)
    line = (f"readings: InternVL2-2B decode step (batch {B}, context "
            f"{n + 1}): {step_ms:.4f} ms (CUDA events, 10 steps), the host "
            f"submits one in {submit:.4f} ms; every weight's float32 -> "
            f"bf16 cast timed alone {casts_ms:.4f} ms "
            f"({sum(t.numel() for t in weights) * 6 / 1e9:.2f} GB moved)")
    if spans:
        ops = sorted(((device_us(e, own=True), e.count, e.key)
                      for e in prof.key_averages()
                      if device_us(e, own=True) > 0), reverse=True)[:6]
        wall_us = spans[-1][1] - spans[0][0]
        line += (f"; under the profiler {len(spans)} device spans, busy "
                 f"{busy_us / 1e3:.4f} ms of {wall_us / 1e3:.4f} ms "
                 f"({100 * busy_us / wall_us:.1f}%); most device time: "
                 + "; ".join(f"{key[:60]} {us / 1e3:.4f} ms ({c} calls)"
                             for us, c, key in ops))
    else:
        line += "; the profiler sees no device spans: not measured"
    log(line)
    del params, cache
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, submit_ms=submit, casts_ms=casts_ms)


def grouped_step_readings(torch):
    """One OLMoE training step (the training path's model and batch, the
    hot expert planted, no balancer decisions after two warm steps) at one
    and at TRAIN_GROUPS token groups, each under the profiler: the step's
    wall (host clock, synchronised), the host's time to submit it, the
    device's busy share and its spans, and the CPU operators whose counts
    the groups change most.  Returns the readings by group count."""
    from repro_torch.train import Trainer

    out, counts = {}, {}
    for groups in (1, TRAIN_GROUPS):
        cfg, tc, batch = train_config(torch, groups)
        tr = Trainer(cfg, tc, seed=0, device="cuda")
        for block in tr.params["blocks"]:
            block["moe"]["router"][:, TRAIN_HOT] += TRAIN_BOOST
        for _ in range(2):
            tr.train_step(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train_step(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof, spans, busy_us = profile_busy(torch,
                                            lambda: tr.train_step(batch))
        counts[groups] = {e.key: (e.count, e.self_cpu_time_total,
                                  device_us(e, own=True))
                          for e in prof.key_averages()}
        cpu_ops = sum(c for c, _, _ in counts[groups].values())
        wall_us = spans[-1][1] - spans[0][0] if spans else 0.0
        out[groups] = dict(wall=wall, spans=len(spans), busy_us=busy_us,
                           wall_us=wall_us, cpu_ops=cpu_ops)
        log(f"readings: OLMoE train step at {groups} token group(s): "
            f"{wall:.4f} s (host clock); under the profiler "
            f"{len(spans)} device spans, busy {busy_us / 1e3:.2f} ms of "
            f"{wall_us / 1e3:.2f} ms ({100 * busy_us / max(wall_us, 1):.1f}"
            f"%), {cpu_ops} CPU operator calls")
        del tr
        torch.cuda.empty_cache()
    a, b = counts[1], counts[TRAIN_GROUPS]
    zero = (0, 0.0, 0.0)
    for what, i in (("CPU operators' self", 1), ("device", 2)):
        diff = sorted(((b.get(k, zero)[0] - a.get(k, zero)[0],
                        b.get(k, zero)[i] - a.get(k, zero)[i], k)
                       for k in set(a) | set(b)),
                      key=lambda t: -abs(t[1]))[:8]
        log(f"readings: G{TRAIN_GROUPS} against G1, the {what} time that "
            f"moved most: " + "; ".join(
                f"{k[:70]} {dc:+d} calls, {dt / 1e3:+.2f} ms"
                for dc, dt, k in diff))
    return out


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
    train_slice_readings(torch)
    rwkv_train_slice_readings(torch)
    family_readings(torch, VLM)
    vlm_decode_readings(torch)
    grouped_step_readings(torch)
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
# 12. Whisper-medium: the encdec family, serve and train                 #
# --------------------------------------------------------------------- #
def whisper_k5_case(torch, k5, seed: int, B: int, H: int, KV: int, S: int,
                    T: int, causal: bool):
    """bf16 q ``[B, S, H, 64]``, k and v ``[B, T, KV, 64]`` from ``seed``
    (the model's layout, seen through ``.transpose(1, 2)``), the forward on
    ``wgmma`` with its lse and a float32 dO.  Returns (q, k, v, out, lse,
    dout)."""
    d = 64
    shapes = [(B, S, H, d), (B, T, KV, d), (B, T, KV, d)]
    q, k, v = (randn(torch, seed + i, s, torch.bfloat16).transpose(1, 2)
               for i, s in enumerate(shapes))
    what = (f"flash_attention (64, 64) B={B} H={H} KV={KV} S={S} T={T} "
            f"causal={causal}")
    out, lse = k5_call(k5, what, "wgmma", q, k, v, causal=causal,
                       scale=d ** -0.5, return_lse=True)
    dout = randn(torch, seed + 3, (B, H, S, d), torch.float32)
    return q, k, v, out, lse, dout


def whisper_kernel_phase(torch, k4, k5):
    """K5 at Whisper's (64, 64), forward and backward, bf16 on the wgmma
    route through the model's ``[B, S, H, hd]`` views, against its plain
    versions at ``WHISPER_K5_CASES`` (S 1, 63 and 512 against T 1,500,
    full: the cross attention; S = T = 1,500 full, a ragged last tile:
    the encoder; S = T = 512 causal: the decoder; S = T = 445 with two
    query heads a KV head, causal and full): the forward within
    ``check_flash``'s bound, its lse within ``check_lse``'s and the same
    output bits without it, a view the same bits as its contiguous copy;
    the backward on ``wgmma`` (three launches, counted in ``bwd_routes``)
    within ``check_flash_bwd``'s wgmma bound, two calls the same bits; the
    planted faults "drops D" (and "mask off" where the call is causal)
    beyond that bound at the decoder's and the cross attention's cases.
    Then at ``WHISPER_K5_TIMED`` (B 4, H 16, where a block walks up to
    24 tiles and the grids take several waves) the same bounds and two
    backward calls the same bits, and K5 forward and backward timed by
    CUDA events beside ``k5_bound`` / ``k5_bwd_bound``, the plain versions
    and SDPA's forward and backward.  Returns (the largest errors, the
    timings by shape name: (forward (ms, plain, SDPA, bound, by), backward
    (the same)))."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    errs = {"flash_attention": 0.0, "flash_attention_bwd": 0.0}
    seed, faults, tried = 900, 0, 0
    for B, H, KV, S, T, causal in WHISPER_K5_CASES:
        seed += 4
        q, k, v, out, lse, dout = whisper_k5_case(torch, k5, seed, B, H, KV,
                                                  S, T, causal)
        what = (f"flash_attention (64, 64) B={B} H={H} KV={KV} S={S} T={T} "
                f"causal={causal}")
        scale = 64 ** -0.5
        check(out.shape == (B, H, S, 64), f"{what}: out {tuple(out.shape)}")
        check(torch.equal(k5_call(k5, what, "wgmma", q, k, v, causal=causal,
                                  scale=scale), out),
              f"{what}: the forward gives other bits with its lse")
        copies = [t.contiguous() for t in (q, k, v)]
        check(torch.equal(k5_call(k5, what, "wgmma", *copies, causal=causal,
                                  scale=scale), out),
              f"{what}: a [B, S, H, d] view gives other bits than its "
              f"contiguous copy")
        del copies
        check_lse(torch, what, lse, q, k, v, causal, scale)
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, what, out, q, k, v, causal, scale))
        kw = dict(lse=lse, causal=causal, scale=scale)
        check(k5.bwd_route(q, k, v) == "wgmma",
              f"{what}: the backward takes {k5.bwd_route(q, k, v)}")
        before = (k5.flash_attention_bwd.launches, dict(k5.bwd_routes))
        got = k5.flash_attention_bwd(q, k, v, out, dout, **kw)
        n = k5.BWD_LAUNCHES["wgmma"]
        took = {r: c - before[1][r] for r, c in k5.bwd_routes.items()
                if c > before[1][r]}
        check(k5.flash_attention_bwd.launches == before[0] + n
              and took == {"wgmma": n},
              f"{what}: the backward launched {took}, not {n} on wgmma")
        check(all(torch.equal(a, b) for a, b in zip(
            got, k5.flash_attention_bwd(q, k, v, out, dout, **kw))),
              f"{what}: two backward calls give other bits")
        errs["flash_attention_bwd"] = max(
            errs["flash_attention_bwd"],
            check_flash_bwd(torch, what, got, q, k, v, out, dout, causal,
                            scale, "wgmma"))
        if S == 512:
            planted = train_planted_faults(k4, k5)[:2 if causal else 1]
            for name, _, _, fault in planted:
                tried += 1
                try:
                    check_flash_bwd(torch, f"{what} ({name})",
                                    fault(q, k, v, out, dout, **kw), q, k, v,
                                    out, dout, causal, scale, "wgmma")
                except SmokeFailure:
                    faults += 1
                    continue
                check(False, f"{what}: the planted fault '{name}' stays "
                             f"within the wgmma route's bound")
        del q, k, v, out, lse, dout, got
    torch.cuda.empty_cache()
    check(tried == 3 and faults == tried,
          f"whisper kernels: {faults} of the {tried} planted faults passed "
          f"the wgmma backward's bound")
    log(f"whisper kernels: flash_attention at (64, 64), bf16 on wgmma from "
        f"[B, S, H, d] views, at (B, H, KV, S, T, causal) in "
        f"{WHISPER_K5_CASES}: forward within check_flash's bound (max |err| "
        f"{errs['flash_attention']:.3g}), its lse within check_lse's and the "
        f"same bits without it, views the bits of their copies; backward "
        f"within check_flash_bwd's wgmma bound (max |err| "
        f"{errs['flash_attention_bwd']:.3g}), two calls the same bits; "
        f"{faults} planted faults beyond the bound")
    timed = {}
    for name, S, T, causal in WHISPER_K5_TIMED:
        B, H = SERVE_BATCH, 16
        q, k, v, out, lse, dout = whisper_k5_case(torch, k5, 950, B, H, H, S,
                                                  T, causal)
        # The timed shapes are held too: only there does a block walk up to
        # 24 tiles and a grid take several waves.
        what = (f"flash_attention (64, 64) B={B} H={H} S={S} T={T} "
                f"causal={causal}")
        kw = dict(lse=lse, causal=causal, scale=64 ** -0.5)
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, what, out, q, k, v, causal, 64 ** -0.5))
        check_lse(torch, what, lse, q, k, v, causal, 64 ** -0.5)
        got = k5.flash_attention_bwd(q, k, v, out, dout, **kw)
        check(all(torch.equal(a, b) for a, b in zip(
            got, k5.flash_attention_bwd(q, k, v, out, dout, **kw))),
              f"{what}: two backward calls give other bits")
        errs["flash_attention_bwd"] = max(
            errs["flash_attention_bwd"],
            check_flash_bwd(torch, what, got, q, k, v, out, dout, causal,
                            64 ** -0.5, "wgmma"))
        del got
        fwd = time_k5(torch, k5, q, k, v, 20, causal=causal)
        ms = time_ms(torch, lambda *a: k5.flash_attention_bwd(*a, **kw),
                     (q, k, v, out, dout), 20)
        plain_ms = time_ms(torch, lambda *a: ref.flash_attention_bwd(
            *a, causal=causal, scale=64 ** -0.5), (q, k, v, out, dout), 3)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        g = dout.to(sdpa.dtype)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), g, retain_graph=True), (), 20)
        bwd = (ms, plain_ms, lib_ms) + k5_bwd_bound(B, H, H, S, T, 64, causal,
                                                    2, "wgmma")
        timed[name] = (fwd, bwd)
        log(f"whisper kernels: K5 (64, 64) at the {name}'s B={B} H={H} S={S} "
            f"T={T} causal={causal}: forward {fwd[0]:.5f} ms (plain "
            f"{fwd[1]:.5f} ms, SDPA {fwd[2]:.5f} ms, bound {fwd[3]:.5f} ms by "
            f"{fwd[4]}, {100 * fwd[3] / fwd[0]:.1f}% of it); backward "
            f"{bwd[0]:.5f} ms (plain {bwd[1]:.5f} ms, SDPA's backward "
            f"{bwd[2]:.5f} ms, bound {bwd[3]:.5f} ms by {bwd[4]}, "
            f"{100 * bwd[3] / bwd[0]:.1f}% of it)")
        del q, k, v, out, lse, dout, sdpa, qg, kg, vg, g
        torch.cuda.empty_cache()
    return errs, timed


def scalar_constants_check(torch) -> None:
    """``layers.scalar_mul``, ``gelu`` and ``apply_rope`` on the card, bf16
    and float32: ``scalar_mul`` gives the bits of multiplying by a tensor
    of x's dtype (JAX's rounding of a Python scalar), and once warm none of
    the three waits for the stream.  Under ``set_sync_debug_mode("error")``
    a host-to-device copy of a scalar raises; the check first shows that it
    does."""
    from repro_torch.models import layers

    pos = torch.arange(16, device="cuda")[None]
    for dt in (torch.bfloat16, torch.float32):
        x = randn(torch, 7, (4, 16, 8, 64), dt, 3.0)
        for c in (0.044715, math.sqrt(2 / math.pi), 64 ** -0.5):
            want = x * torch.tensor(c, dtype=dt, device="cuda")
            check(torch.equal(layers.scalar_mul(x, c), want),
                  f"layers: scalar_mul({c}) in {dt} is not x times a {dt} "
                  f"constant")
        layers.gelu(x), layers.apply_rope(x, pos)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            try:
                x * torch.tensor(0.5, dtype=dt, device="cuda")
                seen = False
            except RuntimeError:
                seen = True
            try:
                layers.gelu(x), layers.apply_rope(x, pos)
                layers.scalar_mul(x, 0.125)
                waits = None
            except RuntimeError as e:
                waits = str(e)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        check(seen, "layers: the sync debug mode let a host-to-device copy "
                    "of a scalar pass")
        check(waits is None, f"layers: gelu, apply_rope or scalar_mul in {dt} "
                             f"waits for the stream: {waits}")
    log("layers: scalar_mul, gelu and apply_rope on the card (bf16, "
        "float32): JAX's rounding of the constants, no wait for the stream")


def whisper_records(launches, errs, timed) -> list:
    """The JSON records of K5 at (64, 64), forward and backward: launches
    over Whisper's serve and training paths, the largest errors of its
    checks, the times at the encoder's shape (``whisper_kernel_phase``)."""
    out = []
    for i, name in enumerate(("flash_attention", "flash_attention_bwd")):
        ms, plain_ms, lib_ms, b_ms, b_by = timed["encoder"][i]
        out.append(dict(
            name=f"{name} dk64 dv64 wgmma", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:72",
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
    return out


def whisper_phases(torch, kseg, kfa, krw, kernel_mods, smi: str,
                   kernel_errs, timed) -> list:
    """Phase 12 whole: the serve and its slice, then the training path, its
    replays and its slice.  Returns ``whisper_records``."""
    serve_n, serve_err, _ = family_serve_phase(torch, WHISPER, kseg, kfa,
                                               kernel_mods, smi)
    train, train_errs, _ = family_train_phases(torch, WHISPER, kseg, kfa,
                                               krw, smi)
    launches = {"flash_attention": serve_n + train["flash_attention"],
                "flash_attention_bwd": train["flash_attention_bwd"]}
    errs = {"flash_attention": max(kernel_errs["flash_attention"], serve_err,
                                   train_errs["flash_attention"]),
            "flash_attention_bwd": max(kernel_errs["flash_attention_bwd"],
                                       train_errs["flash_attention_bwd"])}
    return whisper_records(launches, errs, timed)


def whisper_only() -> int:
    """``--whisper``: build K4 and K5 (their ``-Xptxas -v`` lines, the
    serialization check and ``check_sass``), then phase 12 alone: K5 at
    (64, 64), Whisper-medium's serve and training paths, their replays and
    slices, and the readings the Whisper slice limits are set from.  Not
    part of the smoke."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import partition as kpart
    from repro_torch.kernels import rwkv_scan as krw
    from repro_torch.kernels import segment_matmul as kseg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logged(_build, ("segment_matmul", "flash_attention"))
    check_sass()
    errs, timed = whisper_kernel_phase(torch, kseg, kfa)
    scalar_constants_check(torch)
    kernel_mods = [(kpart, name) for name in KERNELS] + [
        (kseg, "segment_matmul"), (kfa, "flash_attention"),
        (krw, "rwkv_scan")]
    records = whisper_phases(torch, kseg, kfa, krw, kernel_mods, smi, errs,
                             timed)
    t1 = time.perf_counter()
    family_readings(torch, WHISPER)
    log(f"readings: whisper in {time.perf_counter() - t1:.1f} s")
    print(json.dumps({"kernels": records}))
    log(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


# --------------------------------------------------------------------- #
# 13. The hybrid family: Hymba-1.5B, serve and train; K5's window, K7    #
# --------------------------------------------------------------------- #
class WindowRecorder(Recorder):
    """A recorder of K5 (forward or backward) that keeps the first call of
    each (path, window, shapes): the hybrid family's full and windowed
    layers call it at one shape."""

    def __call__(self, *args, **kw):
        key = self.key(*args) + (kw.get("window"),)
        if key not in self.first:
            self.first[key] = (tuple(None if t is None else t.clone()
                                     for t in args), kw)
        return self.kernel(*args, **kw)


def k7_bound(B: int, S: int, DI: int, N: int, x_bytes: int,
             with_state: bool):
    """Least time of K7's forward: B S DI N exponentials at the
    multi-function unit's rate and 5 float32 operations an entry at the
    CUDA cores' (the slower of the two units), or x, delta, B, C, a and
    d_skip read and y and the final state written once (h0 read with a
    state)."""
    entries = B * S * DI * N
    t_ops = max(entries / MUFU_OPS_PER_S, 5.0 * entries / FP32_OPS_PER_S) * 1e3
    t_bytes = (x_bytes * 2 * B * S * DI + 4 * B * S * DI + 8 * B * S * N
               + 4 * (DI * N + DI) + 4 * B * DI * N * (2 if with_state else 1)
               ) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k7_bwd_bound(B: int, S: int, DI: int, N: int, x_bytes: int):
    """Least time of K7's backward: the forward's exponentials once and 12
    float32 operations an entry (the slower unit), or x, delta, B, C, dy
    and dh_fin read and dx, ddelta, dB, dC, da, dd_skip and dh0 written
    once."""
    entries = B * S * DI * N
    t_ops = max(entries / MUFU_OPS_PER_S,
                12.0 * entries / FP32_OPS_PER_S) * 1e3
    t_bytes = (x_bytes * 3 * B * S * DI + 8 * B * S * DI + 16 * B * S * N
               + 8 * (DI * N + DI) + 8 * B * DI * N) / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def mamba_inputs(torch, seed: int, B: int, S: int, DI: int, N: int,
                 xdt, state: bool, dev: str = "cuda"):
    """K7's inputs as the model makes them, from ``seed``: x ``[B, S, DI]``
    in ``xdt``, delta = softplus of a standard normal, B and C standard
    normal, a = -exp(log(1 .. N) + 0.2 z) (``mamba_init``'s, moved),
    d_skip near 1, and with ``state`` a standard normal h0."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = n(B, S, DI).to(xdt)
    delta = torch.nn.functional.softplus(n(B, S, DI))
    a = -torch.exp(torch.log(torch.arange(1, N + 1, device=dev,
                                          dtype=torch.float32))
                   + 0.2 * n(DI, N))
    d_skip = 1 + 0.2 * n(DI)
    h0 = n(B, DI, N) if state else None
    return x, delta, n(B, S, N), n(B, S, N), a, d_skip, h0


def mamba_envelope(torch, x, delta, bmat, cmat, a, d_skip, h0):
    """``check_mamba``'s bound, by the recurrence on magnitudes: A_t = da_t
    A_{t-1} + |dbx_t| (A_{-1} = |h0|) bounds |h_t|, and E_t = da_t E_{t-1} +
    8 2^-24 (da_t A_{t-1} + A_t) (E_{-1} = 0) the two versions' distance at
    h_t: their exponentials (ex2 against the plain version's, each within
    2 units in the last place) and each side's rounding of da h and of the
    add, the rest of a step being the same operations on the same values.
    y_t = sum_n h_t C_t + x_t d_skip: E_t through C_t, and each side's 16
    products and their sums in another order (34 2^-24 sum_n A_t |C_t|),
    and the last add (4 2^-24 (sum_n A_t |C_t| + |x d_skip|)).  Returns
    (y's bound [B, S, DI], the final state's [B, DI, N])."""
    eps = 2.0**-24
    B, S, DI = x.shape
    xf, af = x.float().abs(), a.float()
    A = (torch.zeros((B, DI, a.shape[-1]), device=x.device) if h0 is None
         else h0.float().abs())
    E = torch.zeros_like(A)
    tol = torch.empty((B, S, DI), device=x.device)
    xd = xf * d_skip.float().abs()
    for t in range(S):
        da = torch.exp(delta[:, t, :, None] * af)
        An = da * A + (delta[:, t, :, None] * bmat[:, t, None, :].abs()
                       * xf[:, t, :, None])
        E = da * E + 8 * eps * (da * A + An)
        A = An
        c = cmat[:, t, None, :].abs()
        hc = (A * c).sum(-1)
        tol[:, t] = (E * c).sum(-1) + 38 * eps * hc + 4 * eps * xd[:, t]
    return tol + 2.0**-120, E + 2.0**-120


def check_mamba(torch, what: str, got, args) -> float:
    """K7's forward against its plain version on ``args`` (x, delta, B, C,
    a, d_skip, h0): y within ``mamba_envelope``'s bound (a bf16 y adds one
    rounding on each side, 2^-7 of the larger), the final state within
    its own.  Returns max |y - plain|."""
    from repro_torch.kernels import ref
    y, h = got
    want_y, want_h = ref.mamba_scan(*args)
    tol_y, tol_h = mamba_envelope(torch, *args)
    check(y.shape == want_y.shape and y.dtype == want_y.dtype
          and h.shape == want_h.shape and h.dtype == torch.float32,
          f"{what}: y {tuple(y.shape)} {y.dtype}, h {tuple(h.shape)} vs "
          f"plain {tuple(want_y.shape)} {want_y.dtype}")
    check(bool(torch.isfinite(y).all() and torch.isfinite(h).all()),
          f"{what}: non-finite output")
    if y.dtype == torch.bfloat16:
        tol_y = tol_y + 2.0**-7 * torch.maximum(y.float().abs(),
                                                want_y.float().abs())
    ey = (y.float() - want_y.float()).abs()
    eh = (h - want_h).abs()
    check(bool((ey <= tol_y).all()),
          f"{what}: y beyond the stated bound of the plain version (max "
          f"|err| {float(ey.max()):.3g}, bound there "
          f"{float(tol_y.flatten()[ey.argmax()]):.3g})")
    check(bool((eh <= tol_h).all()),
          f"{what}: the final state beyond its bound (max |err| "
          f"{float(eh.max()):.3g})")
    return max(float(ey.max()), float(eh.max()))


def mamba_bwd_magnitudes(torch, args, dy, dh):
    """The backward's recurrence on magnitudes (``ref.mamba_scan_bwd`` with
    every factor made non-negative: |x|, |B|, |C|, |a|, |d_skip|, |h0|,
    |dy|, |dh_fin|, da and delta as they are): each gradient's sum of the
    magnitudes of its terms, in the order (dx, ddelta, dB, dC, da,
    dd_skip, dh0)."""
    x, delta, bmat, cmat, a, d_skip, h0 = args
    B, S, DI = x.shape
    xf, bf, cf = (t.float().abs() for t in (x, bmat, cmat))
    af, aa = a.float(), a.float().abs()
    dyf = dy.float().abs()
    A = (torch.zeros((B, DI, a.shape[-1]), device=x.device) if h0 is None
         else h0.float().abs())
    states = []
    for t in range(S):
        states.append(A)
        A = (torch.exp(delta[:, t, :, None] * af) * A
             + delta[:, t, :, None] * bf[:, t, None, :] * xf[:, t, :, None])
    g = torch.zeros_like(A) if dh is None else dh.float().abs()
    mx, mdl = (torch.empty((B, S, DI), device=x.device) for _ in range(2))
    mb, mc = (torch.empty((B, S, a.shape[-1]), device=x.device)
              for _ in range(2))
    ma = torch.zeros_like(aa)
    for t in reversed(range(S)):
        hp = states[t]
        da = torch.exp(delta[:, t, :, None] * af)
        ht = da * hp + delta[:, t, :, None] * bf[:, t, None, :] \
            * xf[:, t, :, None]
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        mc[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], ht)
        gx = g * xf[:, t, :, None]
        mb[:, t] = torch.einsum("bdn,bd->bn", gx, delta[:, t])
        u = g * hp * da
        ma += (u * delta[:, t, :, None]).sum(0)
        mdl[:, t] = (u * aa).sum(-1) + (gx * bf[:, t, None, :]).sum(-1)
        mx[:, t] = (g * (delta[:, t, :, None] * bf[:, t, None, :])).sum(-1) \
            + dyf[:, t] * d_skip.float().abs()
        g = g * da
    msk = (dyf * xf).sum((0, 1))
    return mx, mdl, mb, mc, ma, msk, g


def check_mamba_bwd(torch, what: str, got, args, dy, dh) -> float:
    """K7's backward against its plain version: both float32 arithmetic on
    the same inputs in other orders (the kernel's sums over N by its
    butterfly, over d and (b, t) by its partials; its exponentials ex2's).
    Along the recurrence each step rounds a few times on each side and
    changes the exponential by 4 units in the last place: with M a
    gradient's magnitude (``mamba_bwd_magnitudes``), within (16 S + 2 n +
    16) 2^-24 M, n the terms of its own sum (N for dx and ddelta, DI for
    dB and dC, B S for da and dd_skip); a bf16 dx adds one rounding on each
    side, 2^-7 of the larger.  Returns max |got - plain|."""
    from repro_torch.kernels import ref
    want = ref.mamba_scan_bwd(*args, dy, dh)
    mags = mamba_bwd_magnitudes(torch, args, dy, dh)
    B, S, DI = args[0].shape
    N = args[4].shape[-1]
    names = ("dx", "ddelta", "dB", "dC", "da", "dd_skip", "dh0")
    terms = (N, N, DI, DI, B * S, B * S, 0)
    err = 0.0
    for name, g, w, m, n in zip(names, got, want, mags, terms):
        check(g.shape == w.shape and g.dtype == w.dtype,
              f"{what}: {name} {tuple(g.shape)} {g.dtype} vs plain "
              f"{tuple(w.shape)} {w.dtype}")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite {name}")
        tol = (16 * S + 2 * n + 16) * 2.0**-24 * m + 2.0**-120
        if g.dtype == torch.bfloat16:
            tol = tol + 2.0**-7 * torch.maximum(g.float().abs(),
                                                w.float().abs())
        e = (g.float() - w.float()).abs()
        check(bool((e <= tol).all()),
              f"{what}: {name} beyond the stated bound of the plain version "
              f"(max |err| {float(e.max()):.3g})")
        err = max(err, float(e.max()))
    return err


def time_k7(torch, k7, args, reps: int):
    """(kernel ms, plain ms, None (no library call), bound ms, bound_by) of
    K7's forward on ``args``."""
    from repro_torch.kernels import ref
    x = args[0]
    B, S, DI = x.shape
    ms = time_ms(torch, k7.mamba_scan, args, reps)
    plain_ms = time_ms(torch, ref.mamba_scan, args, 1, warm=0)
    return (ms, plain_ms, None) + k7_bound(B, S, DI, args[4].shape[-1],
                                           x.element_size(),
                                           args[6] is not None)


def time_k7_bwd(torch, k7, args, dy, dh, ck, reps: int):
    """The same for K7's backward (a call: its two launches)."""
    from repro_torch.kernels import ref
    x = args[0]
    B, S, DI = x.shape
    ms = time_ms(torch, lambda *a: k7.mamba_scan_bwd(*a, checkpoints=ck),
                 args + (dy, dh), reps)
    plain_ms = time_ms(torch, ref.mamba_scan_bwd, args + (dy, dh), 1, warm=0)
    return (ms, plain_ms, None) + k7_bwd_bound(B, S, DI, args[4].shape[-1],
                                               x.element_size())


def hybrid_k5_case(torch, k5, seed: int, B: int, H: int, KV: int, S: int,
                   window, dtype=None, d: int = 64):
    """q ``[B, S, H, d]``, k and v ``[B, S, KV, d]`` from ``seed`` in
    ``dtype`` (bf16 by default; the model's layout seen through
    ``.transpose(1, 2)``), K5's causal windowed forward (on ``wgmma`` for
    bf16 at d 64, else ``fma``) with its lse and a float32 dO.  Returns (q,
    k, v, out, lse, dout, route)."""
    dtype = torch.bfloat16 if dtype is None else dtype
    shapes = [(B, S, H, d), (B, S, KV, d), (B, S, KV, d)]
    q, k, v = (randn(torch, seed + i, s, dtype).transpose(1, 2)
               for i, s in enumerate(shapes))
    route = "wgmma" if (dtype == torch.bfloat16
                        and (d, d) in k5.WGMMA_WIDTHS) else "fma"
    what = (f"flash_attention ({d}, {d}) {dtype} B={B} H={H} KV={KV} S={S} "
            f"window={window}")
    out, lse = k5_call(k5, what, route, q, k, v, causal=True,
                       scale=d ** -0.5, return_lse=True, window=window)
    dout = randn(torch, seed + 3, (B, H, S, d), torch.float32)
    return q, k, v, out, lse, dout, route


def hybrid_window_faults(k5):
    """K5 planted faults for the window checks: the window one key wider
    ("window + 1") and taken away ("no window"), forward and backward,
    each still launching the kernel: (name, forward, backward)."""
    def wider(fn):
        return lambda *a, window=None, **kw: fn(
            *a, window=None if window is None else window + 1, **kw)

    def gone(fn):
        return lambda *a, window=None, **kw: fn(*a, **kw)

    return [("window + 1", wider(k5.flash_attention),
             wider(k5.flash_attention_bwd)),
            ("no window", gone(k5.flash_attention),
             gone(k5.flash_attention_bwd))]


def hybrid_kernel_phase(torch, k5, k7):
    """K5's sliding window and K7 against their plain versions on the card.

    K5, causal with a window: at Hymba's width ((64, 64), bf16 on
    ``wgmma``, 25 query heads on 5 KV heads) at ``HYBRID_K5`` (B 4, S =
    T = 2,048, window 1,024) and at ``HYBRID_K5_EDGES`` (windows 1, 63,
    64, 65, 1,023 and past S; rep 5, 1 and 5 with H 10), the forward
    within ``check_flash``'s bound of the windowed plain version, its lse
    within ``check_lse``'s and the same output bits without it, a view the
    bits of its copy; the backward (three launches on ``wgmma``) within
    ``check_flash_bwd``'s wgmma bound, two calls the same bits; the
    planted "window + 1" and "no window" faults beyond those bounds, both
    directions, at the timed shape and at window 63; the ``fma`` route
    (hd 16 and float32, ``HYBRID_K5_FMA``) alike within its bounds.  At
    the timed shape K5 forward and backward are timed beside ``k5_bound``
    / ``k5_bwd_bound`` (the windowed pairs), the plain versions and SDPA
    with the window as a boolean mask.

    K7 at ``HYBRID_K7`` (Hymba's B 4, S 2,048, d_inner 1,600, N 16 in
    bf16; a decode step's S 1 with a state; float32 at N 4 and 16 across
    the checkpoint interval): the forward within ``check_mamba``'s bound,
    the same bits with checkpoints and without, one launch a call; the
    backward within ``check_mamba_bwd``'s (with and without dh_fin), two
    launches a call, two calls the same bits; the planted "state not
    carried" (h0 dropped) and "dh_fin dropped" beyond them; at the timed
    shape both timed beside ``k7_bound`` / ``k7_bwd_bound`` and their plain
    versions (no library call computes them).  Returns (the largest
    errors by kernel name, the timings by kernel name: (ms, plain ms,
    library ms, bound ms, bound_by))."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    errs = dict.fromkeys(("flash_attention", "flash_attention_bwd",
                          "mamba_scan", "mamba_scan_bwd"), 0.0)
    timed = {}
    faults, tried = 0, 0
    cases = [HYBRID_K5 + (None, 64)] + [c + (None, 64)
                                        for c in HYBRID_K5_EDGES]
    cases += [(B, H, KV, S, w, getattr(torch, dt), d)
              for B, H, KV, S, d, dt, w in HYBRID_K5_FMA]
    for i, (B, H, KV, S, window, dtype, d) in enumerate(cases):
        q, k, v, out, lse, dout, route = hybrid_k5_case(
            torch, k5, 1100 + 4 * i, B, H, KV, S, window, dtype, d)
        what = (f"flash_attention ({d}, {d}) {q.dtype} B={B} H={H} KV={KV} "
                f"S={S} window={window}")
        scale = d ** -0.5
        kw = dict(causal=True, scale=scale, window=window)
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, what, out, q, k, v, True, scale, window))
        if route == "wgmma":
            check(torch.equal(k5_call(k5, what, route, q, k, v, **kw), out),
                  f"{what}: the forward gives other bits with its lse")
            check_lse(torch, what, lse, q, k, v, True, scale, window)
        copies = [t.contiguous() for t in (q, k, v)]
        check(torch.equal(k5_call(k5, what, route, *copies, **kw), out),
              f"{what}: a [B, S, H, d] view gives other bits than its copy")
        del copies
        check(k5.bwd_route(q, k, v) == route,
              f"{what}: the backward takes {k5.bwd_route(q, k, v)}")
        before = dict(k5.bwd_routes)
        got = k5.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw)
        n = k5.BWD_LAUNCHES[route]
        took = {r: c - before[r] for r, c in k5.bwd_routes.items()
                if c > before[r]}
        check(took == {route: n}, f"{what}: the backward launched {took}, "
                                  f"not {n} on {route}")
        check(all(torch.equal(a, b) for a, b in zip(
            got, k5.flash_attention_bwd(q, k, v, out, dout, lse=lse, **kw))),
              f"{what}: two backward calls give other bits")
        errs["flash_attention_bwd"] = max(
            errs["flash_attention_bwd"], check_flash_bwd(
                torch, what, got, q, k, v, out, dout, True, scale, route,
                window))
        del got
        if i == 0 or window == 63:
            for name, fwd, bwd in hybrid_window_faults(k5):
                for direction in ("forward", "backward"):
                    tried += 1
                    try:
                        if direction == "forward":
                            bad, bad_lse = fwd(q, k, v, return_lse=True,
                                               **kw)
                            check_flash(torch, f"{what} ({name})", bad, q,
                                        k, v, True, scale, window)
                        else:
                            check_flash_bwd(
                                torch, f"{what} ({name})",
                                bwd(q, k, v, out, dout, lse=lse, **kw), q, k,
                                v, out, dout, True, scale, route, window)
                    except SmokeFailure:
                        faults += 1
                        continue
                    check(False, f"{what}: the planted {direction} fault "
                                 f"'{name}' stays within the bound")
        if i == 0:
            fwd_t = time_k5(torch, k5, q, k, v, 20, True, window)
            ms = time_ms(torch, lambda *a: k5.flash_attention_bwd(
                *a, lse=lse, **kw), (q, k, v, out, dout), 20)
            plain_ms = time_ms(torch, lambda *a: ref.flash_attention_bwd(
                *a, **kw), (q, k, v, out, dout), 1)
            qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa = F.scaled_dot_product_attention(
                qg, kg, vg, attn_mask=window_mask(torch, S, window, q.device),
                enable_gqa=KV != H)
            g = dout.to(sdpa.dtype)
            lib_ms = time_ms(torch, lambda: torch.autograd.grad(
                sdpa, (qg, kg, vg), g, retain_graph=True), (), 20)
            bwd_t = (ms, plain_ms, lib_ms) + k5_bwd_bound(
                B, H, KV, S, S, d, True, 2, "wgmma", None, window)
            timed["flash_attention"], timed["flash_attention_bwd"] = \
                fwd_t, bwd_t
            for label, t in (("forward", fwd_t), ("backward", bwd_t)):
                log(f"hybrid kernels: K5 {label} at (64, 64), B={B} H={H} "
                    f"KV={KV} S=T={S} window={window}: {t[0]:.5f} ms (plain "
                    f"{t[1]:.5f} ms, SDPA with the window as a mask "
                    f"{t[2]:.5f} ms, bound {t[3]:.5f} ms by {t[4]}, "
                    f"{100 * t[3] / t[0]:.1f}% of it)")
            del sdpa, qg, kg, vg, g
        del q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    check(faults == tried == 8,
          f"hybrid kernels: {faults} of the {tried} planted K5 window "
          f"faults went beyond the bounds")
    log(f"hybrid kernels: flash_attention with a window, causal, at "
        f"{[c[:5] for c in cases]} (B, H, KV, S, window): forward within "
        f"check_flash's bound (max |err| {errs['flash_attention']:.3g}), "
        f"lse within check_lse's, views the bits of their copies; backward "
        f"within check_flash_bwd's (max |err| "
        f"{errs['flash_attention_bwd']:.3g}), two calls the same bits; "
        f"{faults} planted window faults beyond the bounds")

    faults, tried = 0, 0
    for i, (B, S, DI, N, state) in enumerate(HYBRID_K7):
        xdt = (torch.bfloat16 if N == 16 and (DI >= 1600 or DI % 8)
               else torch.float32)
        args = mamba_inputs(torch, 1200 + i, B, S, DI, N, xdt, state)
        what = f"mamba_scan B={B} S={S} d_inner={DI} N={N} {xdt} state={state}"
        before = k7.mamba_scan.launches
        got = k7.mamba_scan(*args)
        y, h, ck = k7.mamba_scan(*args, checkpoints=True)
        check(k7.mamba_scan.launches == before + 2,
              f"{what}: {k7.mamba_scan.launches - before} launches for two "
              f"calls")
        check(torch.equal(y, got[0]) and torch.equal(h, got[1]),
              f"{what}: other bits with checkpoints")
        errs["mamba_scan"] = max(errs["mamba_scan"],
                                 check_mamba(torch, what, got, args))
        dy = randn(torch, 1250 + i, (B, S, DI), xdt)
        dh = randn(torch, 1260 + i, (B, DI, N), torch.float32)
        # Hymba's prefill shape once (its plain backward takes seconds),
        # the small shapes with and without dh_fin.
        for dhf in (dh,) if S > 1000 else (dh, None):
            before = k7.mamba_scan_bwd.launches
            g = k7.mamba_scan_bwd(*args, dy, dhf, checkpoints=ck)
            check(k7.mamba_scan_bwd.launches == before + k7.BWD_LAUNCHES,
                  f"{what}: the backward launched "
                  f"{k7.mamba_scan_bwd.launches - before} kernels")
            check(all(torch.equal(a, b) for a, b in zip(
                g, k7.mamba_scan_bwd(*args, dy, dhf, checkpoints=ck))),
                  f"{what}: two backward calls give other bits")
            errs["mamba_scan_bwd"] = max(errs["mamba_scan_bwd"],
                                         check_mamba_bwd(torch, what, g, args,
                                                         dy, dhf))
            del g
        planted = []
        if state:
            planted.append(("state not carried", "forward",
                            lambda: (check_mamba, (torch, what, k7.mamba_scan(
                                *args[:6], None), args))))
        if S < 1000:
            planted.append(("dh_fin dropped", "backward",
                            lambda: (check_mamba_bwd, (
                                torch, what, k7.mamba_scan_bwd(
                                    *args, dy, None, checkpoints=ck),
                                args, dy, dh))))
        for name, direction, make in planted:
            tried += 1
            fn, fargs = make()
            try:
                fn(*fargs)
            except SmokeFailure:
                faults += 1
                continue
            check(False, f"{what}: the planted {direction} fault '{name}' "
                         f"stays within the bound")
        if i == 0:
            timed["mamba_scan"] = time_k7(torch, k7, args, 20)
            timed["mamba_scan_bwd"] = time_k7_bwd(torch, k7, args, dy, dh,
                                                  ck, 10)
            for name in ("mamba_scan", "mamba_scan_bwd"):
                t = timed[name]
                log(f"hybrid kernels: {name} at B={B} S={S} d_inner={DI} "
                    f"N={N} {xdt}: {t[0]:.5f} ms (plain {t[1]:.5f} ms, bound "
                    f"{t[3]:.5f} ms by {t[4]}, {100 * t[3] / t[0]:.1f}% of "
                    f"it)")
        del args, got, y, h, ck, dy, dh
        torch.cuda.empty_cache()
    check(faults == tried >= 4, f"hybrid kernels: {faults} of the {tried} "
                                f"planted K7 faults went beyond the bounds")
    log(f"hybrid kernels: mamba_scan at {HYBRID_K7} (B, S, d_inner, N, "
        f"state): forward within check_mamba's bound (max |err| "
        f"{errs['mamba_scan']:.3g}), the same bits with checkpoints; backward "
        f"within check_mamba_bwd's (max |err| {errs['mamba_scan_bwd']:.3g}), "
        f"two calls the same bits; {faults} planted faults beyond the bounds")
    return errs, timed


def hybrid_kernel_mods(kpart, kseg, kfa, krw, k7):
    """The kernels whose counts a hybrid path reads."""
    return [(kpart, name) for name in KERNELS] + [
        (kseg, "segment_matmul"), (kfa, "flash_attention"),
        (krw, "rwkv_scan"), (k7, "mamba_scan")]


def hybrid_serve_phase(torch, kseg, kfa, k7, kernel_mods, smi: str):
    """Hymba-1.5B's serve at its published 32 layers (``serve_phase`` with
    prompts of ``HYBRID_PROMPT`` tokens): K5 once a layer a prefill, every
    call on ``wgmma``, none in a decode step (plain attention over the
    cache, as JAX's); K7 once a layer a model call, prefill and decode
    step; K4 and K6 never.  Then K5 (a full layer's call and a windowed
    one) and K7 (a prefill's and a decode step's) replayed on the serve's
    inputs against their plain versions, timed beside their bounds.
    Returns (launches by kernel, the largest replay errors, the prefill's
    windowed K5 and K7 timings)."""
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    cfg = get_config(HYBRID_ARCH)
    recs = (WindowRecorder(kfa, "flash_attention"),
            Recorder(k7, "mamba_scan"))
    launches, sv = serve_phase(torch, kernel_mods, HYBRID_ARCH, recs,
                               HYBRID_PROMPT)
    log_serve("Hymba-1.5B", sv, launches, smi)
    L = cfg.n_layers
    pre, dec = sv["prefill"][1], sv["decode"][1]
    got = sv["routes"]["flash_attention"]
    check(launches["flash_attention"] == L * pre
          and got == {"fma": 0, "wgmma": L * pre},
          f"serve: Hymba-1.5B ran flash_attention {got} over {pre} prefills, "
          f"not {L} a prefill on wgmma")
    check(launches["mamba_scan"] == L * (pre + dec),
          f"serve: Hymba-1.5B ran mamba_scan {launches['mamba_scan']} times "
          f"over {pre} prefills and {dec} decode steps, not {L} a call")
    check(launches["segment_matmul"] == 0 and launches["rwkv_scan"] == 0,
          f"serve: the Hymba-1.5B serve launched K4 or K6: {launches}")
    errs = {"flash_attention": 0.0, "mamba_scan": 0.0}
    main = {}
    windows = set()
    for key, ((q, k, v), kw) in recs[0].first.items():
        window = kw.get("window")
        if window in windows:           # one full and one windowed call
            continue
        windows.add(window)
        what = (f"flash_attention on the Hymba serve's {key[0]} q "
                f"{tuple(q.shape)} window {window}")
        scale = kw.get("scale") or q.shape[-1] ** -0.5
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, what, k5_call(kfa, what, "wgmma", q, k, v, **kw), q, k, v,
            True, scale, window))
        t = time_k5(torch, kfa, q, k, v, 20, True, window)
        log(f"replay: {what}: {t[0]:.5f} ms (plain {t[1]:.5f} ms, SDPA "
            f"{t[2]:.5f} ms, bound {t[3]:.5f} ms by {t[4]}, "
            f"{100 * t[3] / t[0]:.1f}% of it)")
        if window is not None:
            main.setdefault("flash_attention", t)
    check(windows == {None, cfg.swa_window},
          f"serve: the Hymba prefills called K5 with windows {windows}")
    labels = set()
    for key, (args, _) in recs[1].first.items():
        if key[0] in labels:            # a prefill's call and a step's
            continue
        labels.add(key[0])
        B, S, DI = args[0].shape
        what = (f"mamba_scan on the Hymba serve's {key[0]} x {(B, S, DI)} "
                f"state {args[6] is not None}")
        errs["mamba_scan"] = max(errs["mamba_scan"], check_mamba(
            torch, what, k7.mamba_scan(*args), args))
        t = time_k7(torch, k7, args, 20)
        log(f"replay: {what}: {t[0]:.5f} ms (plain {t[1]:.5f} ms, bound "
            f"{t[3]:.5f} ms by {t[4]}, {100 * t[3] / t[0]:.1f}% of it)")
        if key[0] == "prefill":
            main.setdefault("mamba_scan", t)
    del recs
    torch.cuda.empty_cache()
    log(f"serve: Hymba-1.5B phase in {time.perf_counter() - t0:.1f} s")
    return launches, errs, main


def hybrid_slice_model(torch, seed: int):
    """Hymba-1.5B at full width and HYBRID_SLICE_LAYERS layers (layer 1
    windowed at its 1,024) with weights from ``seed`` on the card and a
    copy on the host, SLICE_B x (HYBRID_SLICE_S + SLICE_STEPS) tokens from
    ``seed + 1``.  Returns (cfg, card params, host params, tokens)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              n_layers=HYBRID_SLICE_LAYERS)
    gpu = init_params(cfg, seed, "cuda")
    toks = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (SLICE_B, HYBRID_SLICE_S + SLICE_STEPS)))
    return cfg, gpu, _to_cpu(gpu), toks


def hybrid_planted_faults(kfa, k7):
    """Faults planted on the card's side of the hybrid slices, each still
    launching its kernel: (name, module, wrapper name, stand-in).  K5's
    window one key off ("window + 1") and K7's state not carried (the
    decode steps and the prefill start from zeros)."""
    name, wider, _ = hybrid_window_faults(kfa)[0]
    ms = k7.mamba_scan

    def stateless(x, delta, bmat, cmat, a, d_skip, h0=None, **kw):
        return ms(x, delta, bmat, cmat, a, d_skip, None, **kw)

    return [(name, kfa, "flash_attention", wider),
            ("state not carried", k7, "mamba_scan", stateless)]


def hybrid_slice_runs(torch, seed: int, runs):
    """Hymba-1.5B at full width and HYBRID_SLICE_LAYERS layers, the same
    weights on the card (K5 on wgmma, a windowed layer among them; K7) and
    on the host (their plain versions): every position of a SLICE_B x
    HYBRID_SLICE_S prefill (past the window) and SLICE_STEPS decode steps
    (each K7 from the cache's state), on the card once for each of
    ``runs`` ((name, planted faults as ``hybrid_planted_faults`` gives
    them)) and once on the host.  Returns {name: ``rwkv_slice_compare``'s
    dict with the card's launches}."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_scan as k7

    cfg, gpu, cpu, toks = hybrid_slice_model(torch, seed)
    cards = {}
    for name, faults in runs:
        before, n7 = dict(kfa.routes), k7.mamba_scan.launches
        with contextlib.ExitStack() as stack:
            for _, mod, attr, fn in faults:
                stack.enter_context(StandIn(mod, attr, fn))
            card = slice_logits(torch, cfg, gpu, toks, "cuda")
        took = {r: kfa.routes[r] - before[r] for r in kfa.ROUTES
                if kfa.routes[r] > before[r]}
        cards[name] = (card, took, k7.mamba_scan.launches - n7)
    del gpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = slice_logits(torch, cfg, cpu, toks, "cpu")
    cpu_s = time.perf_counter() - t0
    out = {}
    for name, (card, took, n7) in cards.items():
        r = rwkv_slice_compare(card, host, HYBRID_SLICE_TOL, HYBRID_SLICE_S)
        err = (card[0] - host[0]).abs().amax(dim=-1)         # [B, P]
        lc = card[0][:, HYBRID_SLICE_S:]
        top2 = lc.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > HYBRID_SLICE_TOL
        same = lc.argmax(-1) == host[0][:, HYBRID_SLICE_S:].argmax(-1)
        r.update(took=took, k7=n7, cpu_s=cpu_s,
                 prompt_median=float(err[:, :HYBRID_SLICE_S].median()),
                 steps_max=max(r["steps"]), steps_decided=int(sure.sum()),
                 steps_agree=int((same & sure).sum()),
                 finite=bool(torch.isfinite(card[0]).all()
                             and torch.isfinite(host[0]).all()))
        out[name] = r
    return out


def hybrid_slice_check(torch):
    """``hybrid_slice_runs`` at seed 0 held to its limits: K5 on wgmma
    once a layer in the prefill, K7 once a layer a model call; the decode
    steps' logits within HYBRID_SLICE_TOL and their greedy tokens equal
    where the card's top-2 margin exceeds it; the prompt positions' median
    largest |logit difference| within HYBRID_SLICE_PROMPT_TOL.  (The
    prompt's largest difference is no check: the two sides' bf16
    roundings, one ulp apart at a block's output, reach ~3 at a few of
    its 2,300 positions through the Mamba heads' step sizes, sound runs
    and faulted alike: ``hybrid_readings``.)"""
    r = hybrid_slice_runs(torch, 0, [("sound", ())])["sound"]
    L = HYBRID_SLICE_LAYERS
    check(r["took"] == {"wgmma": L} and r["k7"] == L * (1 + SLICE_STEPS),
          f"slice: the Hymba card side ran K5 {r['took']} and K7 {r['k7']} "
          f"times, not {L} on wgmma and {L * (1 + SLICE_STEPS)}")
    check(r["finite"], "slice: Hymba non-finite logits")
    check(r["steps_max"] <= HYBRID_SLICE_TOL,
          f"slice: Hymba card and host decode steps' logits differ by "
          f"{r['steps_max']:.4g} (> {HYBRID_SLICE_TOL})")
    check(r["steps_agree"] == r["steps_decided"],
          f"slice: Hymba decode steps' greedy tokens differ at "
          f"{r['steps_decided'] - r['steps_agree']} of the "
          f"{r['steps_decided']} whose top-2 margin exceeds "
          f"{HYBRID_SLICE_TOL}")
    check(r["prompt_median"] <= HYBRID_SLICE_PROMPT_TOL,
          f"slice: Hymba prompt positions' median largest logit difference "
          f"{r['prompt_median']:.4g} (> {HYBRID_SLICE_PROMPT_TOL})")
    log(f"slice: Hymba-1.5B at {L} layers (layer 1 windowed), card vs host "
        f"over {r['tokens']} tokens ({SLICE_B} x {HYBRID_SLICE_S} prompt "
        f"positions, {SLICE_STEPS} decode steps): per decode step max "
        f"|logit diff| {[round(e, 5) for e in r['steps']]} (allowed "
        f"{HYBRID_SLICE_TOL}), greedy equal at {r['steps_agree']} of the "
        f"{r['steps_decided']} step tokens whose top-2 margin exceeds it; "
        f"prompt: median of the positions' largest |logit diff| "
        f"{r['prompt_median']:.5f} (allowed {HYBRID_SLICE_PROMPT_TOL}), "
        f"largest {r['prompt_err']:.5f}; greedy tokens equal at "
        f"{r['equal']} of all {r['tokens']}; host side {r['cpu_s']:.2f} s")
    return r


def hybrid_train_config(torch):
    """Hymba-1.5B's training path: the published config whole (32 layers,
    bf16 compute, remat, no balancer), TRAIN_B x HYBRID_TRAIN_S tokens
    from ``SkewAwarePipeline`` (as ``rwkv_train_config`` builds them)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import (PipelineConfig, SkewAwarePipeline,
                                  zipf_doc_lengths)
    from repro_torch.train import TrainConfig
    from repro_torch.train.optimizer import AdamWConfig

    cfg = get_config(HYBRID_ARCH)
    tc = TrainConfig(opt=AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                     total_steps=TRAIN_STEPS),
                     remat=True, moe_balancer=None)
    pipe = SkewAwarePipeline(PipelineConfig(
        seq_len=HYBRID_TRAIN_S, batch_per_shard=max(TRAIN_B // 8, 1),
        n_shards=8, vocab=cfg.vocab))
    pipe.ingest(zipf_doc_lengths(64, HYBRID_TRAIN_S, seed=0))
    nb = pipe.next_batch()
    batch = {k: torch.from_numpy(np.ascontiguousarray(nb[k][:TRAIN_B]))
             for k in ("tokens", "labels")}
    return cfg, tc, batch


def hybrid_train_replay(torch, kfa, k7, recs):
    """K5 (a full layer's and a windowed layer's call) and K7, forward and
    backward, against their plain versions on the inputs the Hymba
    training path gave them, each backward timed beside the plain version,
    its bound and (K5) SDPA's backward with the window as a mask.
    Returns (max errors, the windowed K5's and K7's backward numbers)."""
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    errs = dict.fromkeys(recs, 0.0)
    main = {}
    for key, ((q, k, v), kw) in recs["flash_attention"].first.items():
        window = kw.get("window")
        what = (f"flash_attention on the Hymba training path's q "
                f"{tuple(q.shape)} window {window}")
        kw = {n: a for n, a in kw.items() if n != "return_lse"}
        scale = kw.get("scale") or q.shape[-1] ** -0.5
        errs["flash_attention"] = max(errs["flash_attention"], check_flash(
            torch, what, k5_call(kfa, what, "wgmma", q, k, v, **kw), q, k, v,
            True, scale, window))
    for key, ((q, k, v, out, dout), kw) in (
            recs["flash_attention_bwd"].first.items()):
        window = kw.get("window")
        B, H, S, hd = q.shape
        KV = k.shape[1]
        what = (f"flash_attention_bwd on the Hymba training path's q "
                f"{tuple(q.shape)} window {window}")
        scale = kw.get("scale") or hd ** -0.5
        check(kfa.bwd_route(q, k, v) == "wgmma",
              f"{what}: takes {kfa.bwd_route(q, k, v)}, not wgmma")
        errs["flash_attention_bwd"] = max(
            errs["flash_attention_bwd"], check_flash_bwd(
                torch, what, kfa.flash_attention_bwd(q, k, v, out, dout, **kw),
                q, k, v, out, dout, True, scale, "wgmma", window))
        ms = time_ms(torch, lambda *a: kfa.flash_attention_bwd(*a, **kw),
                     (q, k, v, out, dout), 10)
        plain_kw = {n: a for n, a in kw.items() if n != "lse"}
        plain_ms = time_ms(torch, lambda *a: ref.flash_attention_bwd(
            *a, **plain_kw), (q, k, v, out, dout), 1, warm=0)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        mask = (window_mask(torch, S, window, q.device) if window is not None
                else None)
        sdpa = F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask, is_causal=mask is None, scale=scale,
            enable_gqa=KV != H)
        g = dout.to(sdpa.dtype)
        lib_ms = time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), g, retain_graph=True), (), 10)
        b_ms, b_by = k5_bwd_bound(B, H, KV, S, S, hd, True, 2, "wgmma", None,
                                  window)
        log(f"replay: {what}: {ms:.5f} ms (plain {plain_ms:.5f} ms, SDPA's "
            f"backward {lib_ms:.5f} ms, bound {b_ms:.5f} ms by {b_by}, "
            f"{100 * b_ms / ms:.1f}% of it)")
        if window is not None:
            main.setdefault("flash_attention_bwd",
                            (ms, plain_ms, lib_ms, b_ms, b_by))
        del sdpa, qg, kg, vg
    for key, (args, kw) in recs["mamba_scan"].first.items():
        what = f"mamba_scan on the Hymba training path's x {tuple(args[0].shape)}"
        y, h, ck = k7.mamba_scan(*args, checkpoints=True)
        errs["mamba_scan"] = max(errs["mamba_scan"],
                                 check_mamba(torch, what, (y, h), args))
    for key, (args, kw) in recs["mamba_scan_bwd"].first.items():
        fwd_args, (dy, dh) = args[:7], args[7:9]
        what = (f"mamba_scan_bwd on the Hymba training path's x "
                f"{tuple(args[0].shape)}")
        ck = kw["checkpoints"]
        errs["mamba_scan_bwd"] = max(
            errs["mamba_scan_bwd"], check_mamba_bwd(
                torch, what, k7.mamba_scan_bwd(*args, checkpoints=ck),
                fwd_args, dy, dh))
        t = time_k7_bwd(torch, k7, fwd_args, dy, dh, ck, 10)
        log(f"replay: {what}: {t[0]:.5f} ms (plain {t[1]:.5f} ms, bound "
            f"{t[3]:.5f} ms by {t[4]}, {100 * t[3] / t[0]:.1f}% of it)")
        main.setdefault("mamba_scan_bwd", t)
    torch.cuda.empty_cache()
    return errs, main


def hybrid_train_slice_model(torch, seed: int):
    """Hymba-1.5B at full width, HYBRID_SLICE_LAYERS layers, float32, its
    window cut to HYBRID_TRAIN_SLICE_WINDOW (so layer 1 masks within the
    slice's HYBRID_TRAIN_SLICE_S tokens) with weights from ``seed``, and a
    TRAIN_SLICE_B x HYBRID_TRAIN_SLICE_S batch from ``seed + 1``.  Returns
    (cfg, card params, host params, batch)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    cfg = dataclasses.replace(get_config(HYBRID_ARCH),
                              n_layers=HYBRID_SLICE_LAYERS,
                              swa_window=HYBRID_TRAIN_SLICE_WINDOW,
                              compute_dtype="float32")
    gpu = init_params(cfg, seed, "cuda")
    rng = np.random.default_rng(seed + 1)
    batch = {k: torch.from_numpy(rng.integers(
        0, cfg.vocab, (TRAIN_SLICE_B, HYBRID_TRAIN_SLICE_S))) for k in
        ("tokens", "labels")}
    return cfg, gpu, _to_cpu(gpu), batch


def hybrid_train_slice_runs(torch, seed: int, runs):
    """``loss_fn``'s gradients (remat) of ``hybrid_train_slice_model``, on
    the card (K5 on its fma routes with the window, K7 forward twice a
    layer under remat and backward once) once for each of ``runs`` ((name,
    planted faults)) and once on the host.  Returns {name:
    ``train_slice_compare``'s dict with the card's launches and result}."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_scan as k7

    cfg, gpu, cpu, batch = hybrid_train_slice_model(torch, seed)
    tables = (kfa.routes, kfa.bwd_routes)
    cards = {}
    for name, faults in runs:
        before = [dict(t) for t in tables]
        n7 = (k7.mamba_scan.launches, k7.mamba_scan_bwd.launches)
        with contextlib.ExitStack() as stack:
            for _, mod, attr, fn in faults:
                stack.enter_context(StandIn(mod, attr, fn))
            card = train_slice_grads(torch, cfg, gpu, batch, None, "cuda")
        took = [{r: t[r] - b[r] for r in t if t[r] > b[r]}
                for t, b in zip(tables, before)]
        cards[name] = (card, took, (k7.mamba_scan.launches - n7[0],
                                    k7.mamba_scan_bwd.launches - n7[1]))
    del gpu
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = train_slice_grads(torch, cfg, cpu, batch, None, "cpu")
    cpu_s = time.perf_counter() - t0
    out = {}
    for name, (card, took, n7) in cards.items():
        r = train_slice_compare(card, host)
        r.update(took=took, k7=n7, cpu_s=cpu_s, card=card)
        out[name] = r
    return out


def hybrid_train_phases(torch, kseg, kfa, krw, k7, smi: str):
    """Hymba-1.5B at its published 32 layers trained TRAIN_STEPS steps of
    TRAIN_B x HYBRID_TRAIN_S tokens (``model_train_phase``: K5 forward
    twice a layer a step under remat and its backward once, all on
    ``wgmma``; K7 forward twice a layer a step and its backward once (two
    launches); K4 and K6 never; the loss falls), K5 and K7 replayed on the
    path's inputs, and the float32 gradient slice within
    HYBRID_TRAIN_SLICE_TOL / HYBRID_TRAIN_SLICE_LOSS_TOL.  Returns (the
    path's launches, the replays' largest errors, their backward
    numbers)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg, tc, batch = hybrid_train_config(torch)
    names = [(kseg, "segment_matmul"), (kseg, "segment_matmul_backward"),
             (kfa, "flash_attention"), (kfa, "flash_attention_bwd"),
             (krw, "rwkv_scan"), (krw, "rwkv_scan_bwd"),
             (k7, "mamba_scan"), (k7, "mamba_scan_bwd")]
    L, S = cfg.n_layers, TRAIN_STEPS
    bwd = kfa.BWD_LAUNCHES["wgmma"] * L * S
    want = dict(segment_matmul=0, segment_matmul_backward=0,
                flash_attention=2 * L * S, flash_attention_bwd=bwd,
                rwkv_scan=0, rwkv_scan_bwd=0, mamba_scan=2 * L * S,
                mamba_scan_bwd=k7.BWD_LAUNCHES * L * S)
    launches, tn, recs = model_train_phase(
        torch, "Hymba-1.5B", cfg, tc, batch, names,
        ["flash_attention", "flash_attention_bwd", "mamba_scan",
         "mamba_scan_bwd"], want,
        {"flash_attention": {"wgmma": 2 * L * S},
         "flash_attention_bwd": {"wgmma": bwd}},
        make=lambda mod, name: (WindowRecorder(mod, name)
                                if mod is kfa else Recorder(mod, name)))
    del batch
    log(f"train: Hymba-1.5B at full width, {L} layers ({tn['n_params']:,} "
        f"float32 params from seed 0 in {tn['init_s']:.1f} s), no balancer, "
        f"batch {TRAIN_B} x {HYBRID_TRAIN_S} tokens, {TRAIN_STEPS} steps "
        f"with remat: loss {tn['losses'][0]:.5f} -> {tn['losses'][-1]:.5f} "
        f"({[round(x, 5) for x in tn['losses']]}); {tn['step_s']:.4f} s a "
        f"step after the first ({tn['times'][0]:.3f} s), "
        f"{tn['tokens'] / tn['step_s']:.1f} tokens/s, the AdamW update "
        f"{tn['update_s']:.4f} s a step "
        f"({100 * tn['update_s'] / tn['step_s']:.1f}%), peak "
        f"{tn['peak_gib']:.2f} GiB; launches {launches} by route "
        f"{tn['routes']} | {smi}")
    errs, main = hybrid_train_replay(torch, kfa, k7, recs)
    del recs
    sl = hybrid_train_slice_runs(torch, 0, [("sound", ())])["sound"]
    n = HYBRID_SLICE_LAYERS
    want_took = [{"fma": 2 * n}, {"fma": kfa.BWD_LAUNCHES["fma"] * n}]
    check(sl["took"] == want_took and sl["k7"] == (2 * n,
                                                   k7.BWD_LAUNCHES * n),
          f"train slice: the Hymba card side ran K5 / its backward on "
          f"{sl['took']} and K7 / its backward {sl['k7']} times, not "
          f"{want_took} and {(2 * n, k7.BWD_LAUNCHES * n)}")
    card = sl.pop("card")
    check(math.isfinite(card[0]) and all(bool(torch.isfinite(g).all())
                                         for g in card[1]),
          "train slice: Hymba non-finite loss or gradient on the card")
    check(sl["loss_err"] <= HYBRID_TRAIN_SLICE_LOSS_TOL,
          f"train slice: Hymba card and host losses differ by "
          f"{sl['loss_err']:.3g} (> {HYBRID_TRAIN_SLICE_LOSS_TOL})")
    check(sl["grad_rel"] <= HYBRID_TRAIN_SLICE_TOL,
          f"train slice: a Hymba gradient leaf differs by "
          f"{sl['grad_rel']:.3g} of its largest entry (> "
          f"{HYBRID_TRAIN_SLICE_TOL})")
    log(f"train slice: Hymba-1.5B at {n} layers, float32, window "
        f"{HYBRID_TRAIN_SLICE_WINDOW} (layer 1), a {TRAIN_SLICE_B} x "
        f"{HYBRID_TRAIN_SLICE_S} batch, card vs host: |loss diff| "
        f"{sl['loss_err']:.3g} (allowed {HYBRID_TRAIN_SLICE_LOSS_TOL}; loss "
        f"{sl['loss']:.5f}), every one of {sl['leaves']} gradient leaves "
        f"within {sl['grad_rel']:.3g} of its largest entry (allowed "
        f"{HYBRID_TRAIN_SLICE_TOL}); host side {sl['cpu_s']:.1f} s")
    log(f"train: Hymba-1.5B phase in {time.perf_counter() - t0:.1f} s")
    return launches, errs, main


def hybrid_records(launches, errs, timed) -> list:
    """The JSON records of K5's window (forward and backward, at (64, 64))
    and of K7 (forward and backward): launches over Hymba's serve and
    training paths, the largest errors of their checks, the times at the
    kernel phase's timed shapes (``hybrid_kernel_phase``)."""
    out = []
    for name, source, replaces in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:72"),
            ("flash_attention_bwd", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:72"),
            ("mamba_scan", "mamba_scan.cu", "src/repro/models/ssm.py:193"),
            ("mamba_scan_bwd", "mamba_scan.cu",
             "src/repro/models/ssm.py:193")):
        ms, plain_ms, lib_ms, b_ms, b_by = timed[name]
        label = (f"{name} dk64 dv64 wgmma window"
                 if name.startswith("flash") else name)
        out.append(dict(
            name=label, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=replaces, launches=launches[name],
            max_abs_err=errs[name], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms))
    return out


def hybrid_phases(torch, kseg, kfa, krw, k7, kernel_mods, smi: str,
                  kernel_errs, timed) -> list:
    """Phase 13 after its kernel checks: Hymba-1.5B's serve, its replays
    and slice, then its training path, replays and slice.  Returns
    ``hybrid_records``."""
    t0 = time.perf_counter()
    serve, serve_errs, _ = hybrid_serve_phase(torch, kseg, kfa, k7,
                                              kernel_mods, smi)
    hybrid_slice_check(torch)
    log(f"hybrid: serve and slice in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train, train_errs, _ = hybrid_train_phases(torch, kseg, kfa, krw, k7,
                                               smi)
    log(f"hybrid: train in {time.perf_counter() - t0:.1f} s")
    # K5's launches on Hymba's paths, its full layers' (without a window)
    # and its windowed layers' together: the routes' counts do not tell
    # them apart.
    launches = {"flash_attention": (serve["flash_attention"]
                                    + train["flash_attention"]),
                "flash_attention_bwd": train["flash_attention_bwd"],
                "mamba_scan": serve["mamba_scan"] + train["mamba_scan"],
                "mamba_scan_bwd": train["mamba_scan_bwd"]}
    errs = {name: max(kernel_errs[name], train_errs.get(name, 0.0),
                      serve_errs.get(name, 0.0)) for name in kernel_errs}
    return hybrid_records(launches, errs, timed)


def hybrid_readings(torch, seeds=(0, 1, 2)):
    """The readings HYBRID_SLICE_TOL and the Hymba train slice limits are
    set from: at each seed the serve slice and the train slice, card
    against host as the checks compare them, sound and with each of
    ``hybrid_planted_faults`` on the card's side."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_scan as k7

    runs = [("sound", ())] + [(f[0], (f,))
                              for f in hybrid_planted_faults(kfa, k7)]
    serve, train, steps, medians = {}, {}, {}, {}
    for seed in seeds:
        for name, r in hybrid_slice_runs(torch, seed, runs).items():
            serve.setdefault(name, []).append(r["err"])
            log(f"readings: Hymba slice seed {seed}: {name}: max |card - "
                f"host| {r['err']:.6f} (prompt {r['prompt_err']:.6f}, its "
                f"median position {r['prompt_median']:.6f}; per decode step "
                f"{[round(e, 6) for e in r['steps']]}); greedy equal at "
                f"{r['equal']} of {r['tokens']}")
            steps.setdefault(name, []).append(r["steps_max"])
            medians.setdefault(name, []).append(r["prompt_median"])
        for name, r in hybrid_train_slice_runs(torch, seed, runs).items():
            train.setdefault(name, []).append((r["grad_rel"],
                                               r["loss_err"]))
            log(f"readings: Hymba train slice seed {seed}: {name}: |loss "
                f"diff| {r['loss_err']:.3g} (loss {r['loss']:.5f}), "
                f"gradients within {r['grad_rel']:.3g} of each leaf's "
                f"largest entry over {r['leaves']} leaves")
    for name, errs in serve.items():
        log(f"readings: Hymba slice {name} over seeds {list(seeds)}: max "
            f"|diff| {min(errs):.6f} to {max(errs):.6f}; decode steps "
            f"{min(steps[name]):.6f} to {max(steps[name]):.6f}; the prompt's "
            f"median position {min(medians[name]):.6f} to "
            f"{max(medians[name]):.6f}")
    for name, rs in train.items():
        log(f"readings: Hymba train slice {name} over seeds {list(seeds)}: "
            f"gradients {min(g for g, _ in rs):.3g} to "
            f"{max(g for g, _ in rs):.3g}, |loss diff| "
            f"{min(e for _, e in rs):.3g} to {max(e for _, e in rs):.3g}")
    log(f"readings: Hymba limits: slice decode steps {HYBRID_SLICE_TOL}, "
        f"prompt median {HYBRID_SLICE_PROMPT_TOL}, train slice "
        f"{HYBRID_TRAIN_SLICE_TOL}, its loss {HYBRID_TRAIN_SLICE_LOSS_TOL}")
    return serve, train


def hybrid_only() -> int:
    """``--hybrid``: build the kernels (their ``-Xptxas -v`` lines, the
    serialization and spill checks and ``check_sass``), then phase 13
    alone: K5's window and K7 against their plain versions, timed; the
    readings the Hymba slice limits are set from; Hymba-1.5B's serve and
    training paths, their replays and slices.  Not part of the smoke."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import mamba_scan as k7
    from repro_torch.kernels import partition as kpart
    from repro_torch.kernels import rwkv_scan as krw
    from repro_torch.kernels import segment_matmul as kseg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logged(_build, ("segment_matmul", "flash_attention", "rwkv_scan",
                          "mamba_scan"))
    check_sass()
    errs, timed = hybrid_kernel_phase(torch, kfa, k7)
    log(f"hybrid: kernels in {time.perf_counter() - t0:.1f} s")
    # The readings first: they print what the slices' limits are set from
    # even where a check below then fails.
    t1 = time.perf_counter()
    hybrid_readings(torch)
    log(f"readings: hybrid in {time.perf_counter() - t1:.1f} s")
    mods = hybrid_kernel_mods(kpart, kseg, kfa, krw, k7)
    records = hybrid_phases(torch, kseg, kfa, krw, k7, mods, smi, errs,
                            timed)
    print(json.dumps({"kernels": records}))
    log(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


def build_logged(_build, names=None) -> None:
    """Builds the named sources (every one by default) and prints each
    kernel's ``-Xptxas -v`` lines: registers, shared memory, spills.  Fails
    where ptxas serializes or spills a K5 wgmma kernel at (64, 64) or
    spills a K7 kernel."""
    t0 = time.perf_counter()
    logs = _build.build() if names is None else _build.build(names)
    log(f"build: {len(logs)} source(s) in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill",
                                       "warning", "Performance Loss")):
                log(f"build: {name}: {line.strip()}")
    serial = [line for text in logs.values() for line in text.splitlines()
              if "serialized" in line and (
                  "Li64ELi64E" in line
                  or ("Li192ELi128E" in line and "flash_bwd_d" in line))]
    check(not serial, f"build: ptxas serializes the wgmma of K5 at (64, "
                      f"64) or of its backward at (192, 128): {serial}")
    spills = spilled(logs.get("flash_attention", ""), K5_WGMMA_KERNELS,
                     "Li64ELi64E")
    check(not spills, f"build: ptxas spills in K5's wgmma kernels at (64, "
                      f"64): {spills}")
    spills = spilled(logs.get("mamba_scan", ""), K7_KERNELS, "mamba_scan")
    check(not spills, f"build: ptxas spills in K7's kernels: {spills}")


def spilled(log_text: str, kernels, tag: str) -> list:
    """The kernels of ``kernels`` whose mangled names hold ``tag`` and to
    which ptxas's ``-v`` lines in ``log_text`` give spill stores or loads:
    [(mangled name, the line)]."""
    out, fn = [], ""
    for line in log_text.splitlines():
        found = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)", line)
        if found:
            fn = found.group(1)
        elif (tag in fn and any(k in fn for k in kernels)
              and re.search(r"[1-9]\d* bytes spill (stores|loads)", line)):
            out.append((fn, line.strip()))
    return out


def train_phases(torch, kseg, kfa, kernel_errs, smi: str):
    """Phase 10's OLMoE part after its kernel checks: the training path,
    the kernels replayed on its inputs, the 2-layer slice; then the same
    path with TRAIN_GROUPS token groups in the same call, K4 replayed on
    its inputs and its slice.  Returns (the JSON records of K5's and K4's
    backward, the largest errors of K4's and K5's forward in this phase,
    the forward launches of both paths)."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    launches, tn, recs = train_phase(torch, kseg, kfa)
    log_train(tn, launches, smi)
    errs, tmain = train_replay_phase(torch, kseg, kfa, recs)
    del recs
    sl = train_slice_phase(torch)
    log(f"train slice: OLMoE-1B-7B at {TRAIN_SLICE_LAYERS} layers, float32, "
        f"{TRAIN_SLOTS} replica slots and a split table, a {TRAIN_SLICE_B} x "
        f"{TRAIN_SLICE_S} batch, card vs host: |loss diff| "
        f"{sl['loss_err']:.3g} (allowed {TRAIN_SLICE_LOSS_TOL}; loss "
        f"{sl['loss']:.5f}), every one of {sl['leaves']} gradient leaves "
        f"within {sl['grad_rel']:.3g} of its largest entry (allowed "
        f"{TRAIN_SLICE_TOL}); host side {sl['cpu_s']:.2f} s")
    log(f"train: phase in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    g_launches, gn, grecs = train_phase(torch, kseg, kfa, TRAIN_GROUPS)
    log_train(gn, g_launches, smi)
    g_errs, dead = grouped_replay_phase(torch, kseg, grecs)
    del grecs
    gsl = train_slice_phase(torch, TRAIN_GROUPS)
    log(f"train slice: OLMoE-1B-7B at {TRAIN_SLICE_LAYERS} layers with "
        f"{TRAIN_GROUPS} token groups, float32, card vs host: |loss diff| "
        f"{gsl['loss_err']:.3g} (allowed {TRAIN_SLICE_LOSS_TOL}; loss "
        f"{gsl['loss']:.5f}), every one of {gsl['leaves']} gradient leaves "
        f"within {gsl['grad_rel']:.3g} of its largest entry (allowed "
        f"{TRAIN_SLICE_TOL}); host side {gsl['cpu_s']:.2f} s")
    log(f"train: G{TRAIN_GROUPS} against G1 in one call: "
        f"{gn['step_s']:.4f} s a step against {tn['step_s']:.4f}; K4's "
        f"forward rows {gn['rows']:,} against {tn['rows']:,} over "
        f"{gn['live']:,} / {tn['live']:,} live rows; the dead rows "
        f"{[round(100 * (1 - lm / m), 1) for _, _, m, lm in dead]}% of K4's "
        f"forward calls; phase in {time.perf_counter() - t0:.1f} s")
    records = []
    for name, src, replaces in (
            ("flash_attention_bwd", "flash_attention",
             "src/repro/kernels/flash_attention.py:72"),
            ("segment_matmul_backward", "segment_matmul",
             "src/repro/kernels/segment_matmul.py:35")):
        ms, plain_ms, lib_ms, b_ms, b_by = tmain[name]
        records.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}.cu",
            replaces=replaces, launches=launches[name] + g_launches[name],
            max_abs_err=max(kernel_errs[name], errs[name],
                            g_errs.get(name, 0.0)), ms=ms,
            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            library_ms=lib_ms))
    fwd = {n: launches[n] + g_launches[n]
           for n in ("segment_matmul", "flash_attention")}
    return records, {"segment_matmul": max(errs["segment_matmul"],
                                           g_errs["segment_matmul"]),
                     "flash_attention": max(kernel_errs["flash_attention"],
                                            errs["flash_attention"])}, fwd


def all_train_phases(torch, kseg, kfa, krw, train_errs, rwkv_bwd_err: float,
                     smi: str, mla_errs):
    """Phase 10 after its kernel checks: the OLMoE paths (one and
    TRAIN_GROUPS token groups), RWKV6's, InternVL2-2B's and the two MLA
    models', each with its replays and slice, one after another (each
    trainer freed before the next is built).  Returns (the JSON records of
    the backward kernels, the largest errors of the forward kernels in
    this phase, the forward kernels' launches over the training paths,
    K5's runs at MLA's widths)."""
    records, fwd_errs, fwd = train_phases(torch, kseg, kfa, train_errs, smi)
    rwkv_record, fwd_errs["rwkv_scan"], fwd["rwkv_scan"] = rwkv_train_phases(
        torch, kseg, kfa, krw, rwkv_bwd_err, smi)
    v_launches, v_errs, v_bwd = family_train_phases(torch, VLM, kseg, kfa,
                                                    krw, smi)
    for rec in records:
        if rec["name"] == "flash_attention_bwd":
            rec["launches"] += v_launches["flash_attention_bwd"]
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     v_errs["flash_attention_bwd"])
    fwd["flash_attention"] += v_launches["flash_attention"]
    fwd_errs["flash_attention"] = max(fwd_errs["flash_attention"],
                                      v_errs["flash_attention"])
    check(v_bwd is not None, "replay: K5's backward was not recorded on the "
                             "InternVL2-2B training path")
    log(f"train: K5's backward on the InternVL2-2B path's shape: "
        f"{v_bwd[0]:.5f} ms (plain {v_bwd[1]:.5f} ms, SDPA's backward "
        f"{v_bwd[2]:.5f} ms, bound {v_bwd[3]:.5f} ms by {v_bwd[4]})")
    mla_runs, mla_k4, mla_k4_errs = mla_phases(
        torch, kseg, kfa, krw, None, smi, False, True, mla_errs)
    for rec in records:
        if rec["name"] == "segment_matmul_backward":
            rec["launches"] += mla_k4["segment_matmul_backward"]
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     mla_k4_errs["segment_matmul_backward"])
    fwd["segment_matmul"] += mla_k4["segment_matmul"]
    fwd_errs["segment_matmul"] = max(fwd_errs["segment_matmul"],
                                     mla_k4_errs["segment_matmul"])
    return records + [rwkv_record], fwd_errs, fwd, mla_runs


def train_only() -> int:
    """``--train``: build K4, K5 and K6 (their ``-Xptxas -v`` lines and
    ``check_sass``), then phase 10 alone (the backward kernels' checks, the
    four training paths, their replays and slices).  Not part of the
    smoke."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import rwkv_scan as krw
    from repro_torch.kernels import segment_matmul as kseg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logged(_build, ("segment_matmul", "flash_attention", "rwkv_scan"))
    check_sass()
    errs = train_kernel_phase(torch, kseg, kfa)
    mla_errs = mla_kernel_phase(torch, kseg, kfa)
    rwkv_bwd_err = rwkv_bwd_kernel_phase(torch, krw)
    records, _, _, mla_runs = all_train_phases(
        torch, kseg, kfa, krw, errs, rwkv_bwd_err, smi, mla_errs)
    print(json.dumps({"kernels": records + mla_records(kfa, mla_runs)}))
    log(f"total: {time.perf_counter() - t0:.1f} s")
    return 0


def mla_records(kfa, runs) -> list:
    """The JSON records of K5 at MLA's widths, one a (direction, widths,
    route): ``runs`` maps (name, dk, dv, route) to (launches, max error,
    (ms, plain ms, library ms, bound ms, bound_by))."""
    out = []
    for (name, dk, dv, route), (n, err, t) in runs.items():
        ms, plain_ms, lib_ms, b_ms, b_by = t
        out.append(dict(
            name=f"{name} dk{dk} dv{dv} {route}", route="cuda",
            source="src/repro_torch/kernels/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:72", launches=n,
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=lib_ms))
    return out


def mla_phases(torch, kseg, kfa, krw, kernel_mods, smi: str, serve: bool,
               train: bool, kernel_errs):
    """Phase 11 (``serve``) and phase 10's MLA part (``train``) for both
    MLA models, one after another, each model freed before the next is
    built.  Returns (K5's runs at MLA's widths, as ``mla_records`` takes
    them, the launches of K4's forward and backward over these paths, K4's
    largest errors)."""
    from repro_torch.configs import get_config

    runs, k4 = {}, {"segment_matmul": 0, "segment_matmul_backward": 0}
    k4_errs = {"segment_matmul": 0.0, "segment_matmul_backward": 0.0}
    for arch in MLA_ARCHS:
        cfg = get_config(arch)
        dk, dv = cfg.qk_nope + cfg.qk_rope, cfg.v_head
        if serve:
            launches, errs, main, _ = mla_phase(torch, kseg, kfa,
                                                kernel_mods, arch, smi)
            runs[("flash_attention", dk, dv, "wgmma")] = (
                launches["flash_attention"],
                max(errs["flash_attention"],
                    kernel_errs["flash_attention"]),
                main["flash_attention"])
            k4["segment_matmul"] += launches["segment_matmul"]
            k4_errs["segment_matmul"] = max(k4_errs["segment_matmul"],
                                            errs["segment_matmul"])
        if train:
            launches, errs, main, _ = mla_train_phase(torch, kseg, kfa, krw,
                                                      arch, smi)
            errs["flash_attention"] = max(errs["flash_attention"],
                                          kernel_errs["flash_attention"])
            route = "wgmma" if (dk, dv) in kfa.WGMMA_WIDTHS else "fma"
            key = ("flash_attention_bwd", dk, dv, route)
            runs[key] = (launches["flash_attention_bwd"],
                         max(errs["flash_attention_bwd"],
                             kernel_errs["flash_attention_bwd"]),
                         main["flash_attention_bwd"])
            runs = merge_runs(runs, {("flash_attention", dk, dv, "wgmma"): (
                launches["flash_attention"], errs["flash_attention"],
                main.get("flash_attention"))})
            for name in k4:
                k4[name] += launches[name]
                k4_errs[name] = max(k4_errs[name], errs.get(name, 0.0))
    return runs, k4, k4_errs


def merge_runs(a, b):
    """Two ``mla_phases`` runs as one: launches added, the larger error,
    the first timing that exists (the serve's, where it ran)."""
    out = dict(a)
    for key, (n, e, t) in b.items():
        if key in out:
            n0, e0, t0 = out[key]
            out[key] = (n0 + n, max(e0, e), t0 or t)
        else:
            out[key] = (n, e, t)
    return out


def mla_only() -> int:
    """``--mla``: build K4 and K5 (their ``-Xptxas -v`` lines and
    ``check_sass``), then the MLA phases alone: K5 at MLA's widths, both
    MLA models' serves, training paths, replays and slices, and the
    readings MLA_SLICE_TOL and MLA_MOE_SLICE are set from.  Not part of
    the smoke."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import partition as kpart
    from repro_torch.kernels import rwkv_scan as krw
    from repro_torch.kernels import segment_matmul as kseg

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi} | torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    build_logged(_build, ("segment_matmul", "flash_attention"))
    check_sass()
    errs = mla_kernel_phase(torch, kseg, kfa)
    kernel_mods = [(kpart, name) for name in KERNELS] + [
        (kseg, "segment_matmul"), (kfa, "flash_attention"),
        (krw, "rwkv_scan")]
    runs = mla_phases(torch, kseg, kfa, krw, kernel_mods, smi, True, True,
                      errs)[0]
    mla_slice_readings(torch)
    print(json.dumps({"kernels": mla_records(kfa, runs)}))
    log(f"total: {time.perf_counter() - t0:.1f} s")
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
    from repro_torch.kernels import mamba_scan as k7
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

    build_logged(_build)
    check_sass()
    records, small_ms = kernel_phase(torch, kpart, ref)
    model_errs = model_kernel_phase(torch, kseg, kfa)
    train_errs = train_kernel_phase(torch, kseg, kfa)
    mla_errs = mla_kernel_phase(torch, kseg, kfa)
    whisper_errs, whisper_timed = whisper_kernel_phase(torch, kseg, kfa)
    scalar_constants_check(torch)
    t0 = time.perf_counter()
    hybrid_errs, hybrid_timed = hybrid_kernel_phase(torch, kfa, k7)
    log(f"hybrid: kernels in {time.perf_counter() - t0:.1f} s")
    rwkv_err = rwkv_kernel_phase(torch, krw)
    rwkv_bwd_err = rwkv_bwd_kernel_phase(torch, krw)
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
    vlm_launches, vlm_err, vlm_main = family_serve_phase(
        torch, VLM, kseg, kfa, kernel_mods, smi)
    for rec in records:
        if rec["name"] == "flash_attention":
            rec["launches"] += vlm_launches
            rec["max_abs_err"] = max(rec["max_abs_err"], vlm_err)
    log(f"serve: K5 on the InternVL2-2B prefill's shape: {vlm_main[0]:.5f} "
        f"ms (plain {vlm_main[1]:.5f} ms, scaled_dot_product_attention "
        f"{vlm_main[2]:.5f} ms, bound {vlm_main[3]:.5f} ms by {vlm_main[4]})")
    mla_runs, mla_k4, mla_k4_errs = mla_phases(
        torch, kseg, kfa, krw, kernel_mods, smi, True, False, mla_errs)
    for rec in records:
        if rec["name"] == "segment_matmul":
            rec["launches"] += mla_k4["segment_matmul"]
            rec["max_abs_err"] = max(rec["max_abs_err"],
                                     mla_k4_errs["segment_matmul"])
    records.append(ctrl_record)
    t0 = time.perf_counter()
    whisper_recs = whisper_phases(torch, kseg, kfa, krw, kernel_mods, smi,
                                  whisper_errs, whisper_timed)
    log(f"whisper: serve and train in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    hybrid_recs = hybrid_phases(
        torch, kseg, kfa, krw, k7,
        hybrid_kernel_mods(kpart, kseg, kfa, krw, k7), smi, hybrid_errs,
        hybrid_timed)
    log(f"hybrid: serve and train in {time.perf_counter() - t0:.1f} s")
    train_records, fwd_errs, fwd, mla_train_runs = all_train_phases(
        torch, kseg, kfa, krw, train_errs, rwkv_bwd_err, smi, mla_errs)
    for rec in records:
        if rec["name"] in fwd_errs:
            rec["max_abs_err"] = max(rec["max_abs_err"], fwd_errs[rec["name"]])
        rec["launches"] += fwd.get(rec["name"], 0)
    records += train_records + mla_records(
        kfa, merge_runs(mla_runs, mla_train_runs)) + whisper_recs \
        + hybrid_recs
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit({"--readings": readings, "--armed": armed,
              "--train": train_only, "--mla": mla_only,
              "--whisper": whisper_only, "--hybrid": hybrid_only}.get(
        " ".join(sys.argv[1:]), main)())
