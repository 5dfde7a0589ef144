#!/usr/bin/env python3
"""Times variants of a kernel's source side by side on one NVIDIA GPU.

    python3 kernel_variants.py k4    # K4's ring depths
    python3 kernel_variants.py k5    # K5's wgmma kernel: exp, stages, registers
    python3 kernel_variants.py k1k2  # K1/K2: route by search or count,
                                     # one tile or the multi-tile pass
    python3 kernel_variants.py k6    # K6: the first (scalar) step kernel
                                     # against today's and its constants
    python3 kernel_variants.py ctrl  # ctrl_step: the first (one-thread)
                                     # design against today's

From the root of a checkout; needs one card.  Builds the kernel's source
(``src/repro_torch/kernels/csrc/<name>.cu``) as it is and with each edit of
the variant table, one library each, compiled side by side into the
gitignored ``build/repro_torch/variants/``; checks each against its plain
version (``chip_smoke.check_segment_matmul`` / ``check_flash``) and times
each with CUDA events, in turns (every variant, then every variant in
reverse order).  K4 at OLMoE-1B-7B's expert products: the serve's longest
prefill (C = 1780) and a decode batch (C = 4), dense and with serve-like
``rows``.  K5 at the serve's prefill shapes (B 4, H 16, hd 128, bf16,
causal; S = 202, 445) and OLMoE's 4096-token context, from the model's
``[B, S, H, hd]`` layout.  K1 and K2 at the smoke's real shape (N = 2^24,
1% of keys split, K2 with 10% dead lanes) at W = 20, 48, 64 and 1024 (K =
65,536; 4,096 at W = 1024), where each variant's integers must equal the
source as it is and K2's sums pass ``check_fold``; and at the main paths'
own sizes (K1 at W1's chunk, N = 192, K = 56, W = 48; K2 at a resident
ingest, N = 256, K = 40, W = 20), where the calls are host-paced, so the
kernels' device time under the profiler is printed beside the CUDA-event
time.  K6 at the serve's shape (B 4, H 32, hd 64, with state0, the model's
``[B, T, H, hd]`` views) at T = 1, 202, 445 and 4096, float32 and with the
model's bf16 r, k, v (w float32): the source as it is and with other
constants, against the first design (``csrc/variants/rwkv_scan_scalar.cu``:
scalar broadcast loads, register staging, the bonus on every state entry,
float32 only, so its bf16 calls cast r, k, v, w to float32 and out back to
bf16 around it, as the model did), each within ``check_rwkv``; device time
under the profiler beside the CUDA-event time.  ``ctrl_step`` (the
in-dispatch controller's step) from ``chip_smoke.ctrl_state``'s random
states at (W, K) = (20, 40), (48, 56) and (64, 128), a quarter and half
of the workers mitigating, and from the state W3 at SF1 armed holds at its
9,000th step (the smoke's replay state; the run stops there), k 1 and 16:
the source as it is (warp 0 runs
the rounds, a lane a worker's ring; called through ``ctrl_step`` with one
argument block a state, phi in the launch's parameters) against the first
design (``csrc/variants/ctrl_step_serial.cu``: every round on one thread;
its structure built once too and phi already on the card, so its calls
cost the host less than its wrapper's did), each bit for bit against the
plain version, the state restored outside the timed span; CUDA-event time
and the host's submit time of a call.  Prints one line a timing.
Not part of the smoke: it chose the constants in the sources.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Edits of K4's source that make each variant.
K4_VARIANTS = {
    "as is (tiles 3 stages x 2 blocks, stream 6)": {},
    "tiles 4 stages x 1 block": {
        "kPStages = 3": "kPStages = 4",
        "__launch_bounds__(kPThreads, 2)": "__launch_bounds__(kPThreads, 1)"},
    "tiles 2 stages x 2 blocks": {"kPStages = 3": "kPStages = 2"},
    "stream 4 stages": {"kSStages = 6": "kSStages = 4"},
    "stream 8 stages": {"kSStages = 6": "kSStages = 8"},
    "stream 10 stages": {"kSStages = 6": "kSStages = 10"},
}

#: Edits of K5's source that make each variant of its wgmma kernel.
K5_VARIANTS = {
    "as is (__expf, 2 stages, 288 threads)": {},
    "expf": {"sc[i] = __expf(": "sc[i] = expf(",
             "corr[r] = __expf(": "corr[r] = expf("},
    "3 stages": {"kStages = 2;": "kStages = 3;"},
    # A whole producer warpgroup that gives its registers to the consumers.
    "setmaxnreg 24 / 240 (384 threads)": {
        "kWThreads = 288;": "kWThreads = 384;",
        "  if (warp == 8) {                        // the producer\n"
        "    if (threadIdx.x % 32 == 0) {":
        "  if (warp >= 8) {\n"
        "    asm volatile(\"setmaxnreg.dec.sync.aligned.u32 24;\\n\");\n"
        "    if (threadIdx.x == 256) {",
        "  // The consumers: warpgroup wg owns":
        "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n"
        "  // The consumers: warpgroup wg owns"},
}


def build(_build, source: str, variants):
    """One library a variant of ``csrc/<source>.cu``, all nvcc processes at
    once: {name: CDLL}.  Prints each variant's ``-Xptxas -v`` lines."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = src
        for old, new in edits.items():
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not once in the "
                                   f"source")
            text = text.replace(old, new)
        tag = re.sub(r"\W+", "_", f"{source}_{name}").strip("_")
        cu, so = out / f"{tag}.cu", out / f"lib{tag}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        fn = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                fn = line.split("'")[1]
            elif "Used" in line or "spill" in line:
                print(f"{name}: {fn}: {line.strip()}", flush=True)
        libs[name] = ctypes.CDLL(str(so))
    return libs


def k4(torch, cs, _build) -> None:
    libs = build(_build, "segment_matmul", K4_VARIANTS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.repro_segment_matmul.argtypes = ([ptr] * 4 + [i32] * 6
                                             + [ptr, ctypes.POINTER(i32)])
        lib.repro_segment_matmul.restype = i32

    def call(lib, x, w, rows):
        E, C, D = x.shape
        F = w.shape[2]
        out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
        route = ctypes.c_int(-1)
        code = lib.repro_segment_matmul(
            x.data_ptr(), w.data_ptr(), out.data_ptr(),
            None if rows is None else rows.data_ptr(), E, C, D, F, 1,
            *_build.device_and_stream(x.device), ctypes.byref(route))
        cs.check(code == 0, f"launch failed: CUDA error {code}")
        return out

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    for E, C, D, F in ((64, 1780, 2048, 1024), (64, 1780, 1024, 2048),
                       (64, 4, 2048, 1024), (64, 4, 1024, 2048)):
        x = cs.randn(torch, 1, (E, C, D), torch.bfloat16, 0.5)
        w = cs.randn(torch, 2, (E, D, F), torch.bfloat16, D ** -0.5)
        # Serve-like rows: top-8 of 64 experts, at the prefill every
        # expert at its mean load, at decode 18 experts with 2 tokens.
        if C > 64:
            rows = torch.full((E,), C * 8 // E, dtype=torch.int32,
                              device="cuda")
        else:
            rows = torch.zeros(E, dtype=torch.int32, device="cuda")
            rows[torch.randperm(E, generator=gen, device="cuda")[:18]] = 2
        reps = 20 if C > 64 else 200
        for r in (None, rows):
            for turn, names in enumerate((list(libs), list(libs)[::-1])):
                for name in names:
                    lib = libs[name]
                    cs.check_segment_matmul(torch, name, call(lib, x, w, r),
                                            x, w, r)
                    ms = cs.time_ms(torch, lambda *a: call(lib, *a),
                                    (x, w, r), reps)
                    print(f"{name}: {(E, C, D, F)} "
                          f"{'dense' if r is None else 'rows'} turn {turn}: "
                          f"{ms:.5f} ms", flush=True)


def k5(torch, cs, _build) -> None:
    from repro_torch.kernels import flash_attention as kfa
    libs = build(_build, "flash_attention", K5_VARIANTS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.repro_flash_attention.argtypes = (
            [ptr] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 2
            + [ctypes.POINTER(ctypes.c_longlong), i32, ptr,
               ctypes.POINTER(i32)])
        lib.repro_flash_attention.restype = i32

    def call(lib, q, k, v):
        B, H, S, hd = q.shape
        out = torch.empty((B, H, S, hd), dtype=torch.float32, device="cuda")
        strides = kfa._strides(q) + kfa._strides(k) + kfa._strides(v)
        route = ctypes.c_int(-1)
        code = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            k.shape[1], S, S, hd, hd ** -0.5, 1, 1,
            (ctypes.c_longlong * 9)(*strides),
            *_build.device_and_stream(q.device), ctypes.byref(route))
        cs.check(code == 0 and route.value == 1,
                 f"launch failed: CUDA error {code}, route {route.value}")
        return out

    for S in (202, 445, 4096):
        q, k, v = (cs.randn(torch, 70 + i, (4, S, 16, 128),
                            torch.bfloat16).transpose(1, 2)
                   for i in range(3))
        reps = 10 if S == 4096 else 50
        for turn, names in enumerate((list(libs), list(libs)[::-1])):
            for name in names:
                lib = libs[name]
                err = cs.check_flash(torch, name, call(lib, q, k, v), q, k,
                                     v, True, 128 ** -0.5)
                ms = cs.time_ms(torch, lambda *a: call(lib, *a), (q, k, v),
                                reps)
                print(f"{name}: B=4 H=16 S={S} hd=128 causal turn {turn}: "
                      f"{ms:.5f} ms (max |err| {err:.3g})", flush=True)


#: Edits of K1 and K2's source (csrc/partition.cu) that make each variant.
K1K2_VARIANTS = {
    "as is (route by search, one tile up to 4096 records)": {},
    # The count of all W compares that the search replaced, with 16-byte
    # loads where the row allows them.
    "route by count": {
        "  // Binary lifting: d is the longest prefix known to satisfy cdf <= u.\n"
        "  for (int step = top; step > 0; step >>= 1) {\n"
        "    const int probe = d + step;\n"
        "    if (probe <= num_workers && __ldg(row + probe - 1) <= u) d = probe;\n"
        "  }\n":
        "  if (num_workers % 4 == 0 && reinterpret_cast<uintptr_t>(row) % 16 == 0) {\n"
        "    const float4* row4 = reinterpret_cast<const float4*>(row);\n"
        "    for (int w = 0; w < num_workers / 4; ++w) {\n"
        "      const float4 c = __ldg(row4 + w);\n"
        "      d += (u >= c.x) + (u >= c.y) + (u >= c.z) + (u >= c.w);\n"
        "    }\n"
        "  } else {\n"
        "    for (int w = 0; w < num_workers; ++w) d += (u >= __ldg(row + w));\n"
        "  }\n"},
    "multi-tile pass always": {"kOneTileRecords = kTile;":
                               "kOneTileRecords = 0;"},
}


def k1k2(torch, cs, _build) -> None:
    from repro_torch.kernels import partition as kpart
    libs = build(_build, "partition", K1K2_VARIANTS)
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.repro_partition_scatter.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.repro_partition_scatter.restype = i32
        lib.repro_partition_scatter_fold.argtypes = (
            [ptr, i32] * 3 + [ptr] * 4 + [i32] * 4 + [ptr])
        lib.repro_partition_scatter_fold.restype = i32
        lib.repro_partition_one_tile_records.restype = i32

    def k1(lib, keys, counters, cdf):
        n = keys.numel()
        K, W = cdf.shape
        index, stream = _build.device_and_stream(keys.device)
        buf = torch.empty(2 * n + W, dtype=torch.int32, device="cuda")
        code = lib.repro_partition_scatter(
            keys.data_ptr(), counters.data_ptr(), cdf.data_ptr(),
            buf.data_ptr(), kpart.workspace(
                n, W, index, stream, lib.repro_partition_one_tile_records()),
            n, K, W, index, stream)
        cs.check(code == 0, f"launch failed: CUDA error {code}")
        return buf.split((n, n, W))

    def k2(lib, keys, counters, vals, valid, cdf):
        n = keys.numel()
        K, W = cdf.shape
        index, stream = _build.device_and_stream(keys.device)
        buf = torch.empty(2 * n + W + 2 * K, dtype=torch.int32,
                          device="cuda")
        code = lib.repro_partition_scatter_fold(
            keys.data_ptr(), 4, counters.data_ptr(), 4, vals.data_ptr(), 4,
            valid.data_ptr(), cdf.data_ptr(), buf.data_ptr(),
            kpart.workspace(n, W, index, stream,
                            lib.repro_partition_one_tile_records()),
            n, K, W, index, stream)
        cs.check(code == 0, f"launch failed: CUDA error {code}")
        *ints, sums = buf.split((n, n, W, K, K))
        return (*ints, sums.view(torch.float32))

    real = [(cs.REAL_N, 4096 if W == 1024 else cs.REAL_K, W, 50)
            for W in (20, 48, 64, 1024)]
    # K2 also at W3's sink call: 2^21 lanes, 40 keys, one worker.
    for kernel, cases in (("K1", real + [(192, 56, 48, 500)]),
                          ("K2", real + [(2**21, 40, 1, 50),
                                         (256, 40, 20, 500)])):
        for n, K, W, reps in cases:
            if kernel == "K1":
                fn = k1
                args = cs.make_inputs(torch, 99, n, K, W, 0.01)
            else:
                fn = k2
                args = cs.fold_inputs(torch, 98, n, K, W, "real", 0.01)
            want = fn(libs[next(iter(libs))], *args)
            for turn, names in enumerate((list(libs), list(libs)[::-1])):
                for name in names:
                    lib = libs[name]
                    got = fn(lib, *args)
                    if kernel == "K1":
                        err = cs.max_abs_err(got, want)
                        cs.check(err == 0, f"{name}: K1 differs from the "
                                           f"source as it is: {err}")
                    else:
                        cs.check_fold(torch, name, got, want, args)
                    ms = cs.time_ms(torch, lambda *a: fn(lib, *a), args,
                                    reps)
                    dev_time = cs.device_ms(torch, lambda *a: fn(lib, *a),
                                          args, min(reps, 50))
                    print(f"{name}: {kernel} N={n} K={K} W={W} turn {turn}:"
                          f" {ms:.5f} ms a call (CUDA events, {reps} calls);"
                          f" device {dev_time} a call (profiler)",
                          flush=True)
            del args, want
            torch.cuda.empty_cache()


#: Edits of K6's source (csrc/rwkv_scan.cu) that make each variant.
K6_VARIANTS = {
    "as is (4 x 4 state entries a thread, 16-step chunks, 4 stages)": {},
    "4 x 8 a thread (128 compute threads at hd 64)": {
        "kCols = 4;": "kCols = 8;"},
    "4 x 2 a thread (512 compute threads at hd 64)": {
        "kCols = 4;": "kCols = 2;"},
    "3 stages": {"kStages = 4;": "kStages = 3;"},
    "8-step chunks": {"kTC = 16;": "kTC = 8;"},
    "one helper warp": {"kHelpers = 128;": "kHelpers = 32;"},
    "step loop unrolled by 4": {
        "#pragma unroll 2\n    for (int tt = 0; tt < steps; ++tt) {":
        "#pragma unroll 4\n    for (int tt = 0; tt < steps; ++tt) {"},
    # Each step's loads issued at its start, after the previous step's
    # arithmetic.
    "step loads not pipelined": {
        "      load(tt + 1 < steps ? tt + 1 : tt);\n": "",
        "    load(0);\n#pragma unroll 2\n"
        "    for (int tt = 0; tt < steps; ++tt) {\n":
        "#pragma unroll 2\n"
        "    for (int tt = 0; tt < steps; ++tt) {\n      load(tt);\n"},
}


def k6(torch, cs, _build) -> None:
    libs = build(_build, "rwkv_scan", K6_VARIANTS)
    first = build(_build, "variants/rwkv_scan_scalar",
                  {"first design (scalar loads, float32 only)": {}})
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.repro_rwkv_scan.argtypes = ([ptr] * 8 + [i32] * 5 + [i64] * 6
                                        + [i32, ptr])
        lib.repro_rwkv_scan.restype = i32
    for lib in first.values():
        lib.repro_rwkv_scan.argtypes = ([ptr] * 8 + [i32] * 4 + [i64] * 6
                                        + [i32, ptr])
        lib.repro_rwkv_scan.restype = i32
    kinds = {(torch.float32, torch.float32): 0,
             (torch.bfloat16, torch.float32): 1,
             (torch.bfloat16, torch.bfloat16): 2}

    def call(lib, r, k, v, w, u, s0):
        B, H, T, hd = r.shape
        out = torch.empty_like(r)
        state = torch.empty((B, H, hd, hd), device="cuda")
        code = lib.repro_rwkv_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), state.data_ptr(),
            B, H, T, hd, kinds[(r.dtype, w.dtype)], *r.stride()[:3],
            *out.stride()[:3], *_build.device_and_stream(r.device))
        cs.check(code == 0, f"launch failed: CUDA error {code}")
        return out, state

    def call_first(lib, r, k, v, w, u, s0):
        # The model's casts around the float32-only kernel.
        rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
        B, H, T, hd = r.shape
        out = torch.empty_like(rf)
        state = torch.empty((B, H, hd, hd), device="cuda")
        code = lib.repro_rwkv_scan(
            rf.data_ptr(), kf.data_ptr(), vf.data_ptr(), wf.data_ptr(),
            u.data_ptr(), s0.data_ptr(), out.data_ptr(), state.data_ptr(),
            B, H, T, hd, *rf.stride()[:3], *out.stride()[:3],
            *_build.device_and_stream(r.device))
        cs.check(code == 0, f"launch failed: CUDA error {code}")
        return out.to(r.dtype), state

    runs = {name: (lib, call) for name, lib in libs.items()}
    runs.update({name: (lib, call_first) for name, lib in first.items()})
    for T in (1, 202, 445, 4096):
        for kind in cs.K6_KINDS[:2]:
            args = cs.rwkv_inputs(torch, 40 + T, cs.SERVE_BATCH, 32, T, 64,
                                  True, views=True, kind=kind)
            reps = 200 if T == 1 else 5 if T == 4096 else 20
            bound, by = cs.k6_bound(cs.SERVE_BATCH, 32, T, 64, True,
                                    args[0].element_size(),
                                    args[3].element_size())
            for turn, names in enumerate((list(runs), list(runs)[::-1])):
                for name in names:
                    lib, fn = runs[name]
                    err = cs.check_rwkv(torch, name, fn(lib, *args), args)[0]
                    ms = cs.time_ms(torch, lambda *a: fn(lib, *a), args,
                                    reps)
                    dev_time = cs.device_ms(torch, lambda *a: fn(lib, *a),
                                            args, min(reps, 50))
                    print(f"{name}: K6 B={cs.SERVE_BATCH} H=32 T={T} hd=64 "
                          f"{kind} turn {turn}: {ms:.5f} ms a call (CUDA "
                          f"events, {reps} calls; bound {bound:.5f} ms by "
                          f"{by}); device {dev_time} a call (profiler); max "
                          f"|err| {err:.3g}", flush=True)
            del args
            torch.cuda.empty_cache()


def w3_state(torch, cs, kctrl):
    """The inputs of the ``CTRL_PICK``-th ``ctrl_step`` call of W3 at SF1
    armed (``run()``, the smoke's "W3 resident armed" path), the run
    stopped there: (spec, state, arrived, phi, t0, k, tuples_left)."""
    from repro_torch import dataflow

    class Stop(Exception):
        pass

    class Pick(cs.CtrlRecorder):
        def __call__(self, *args, **kw):
            out = super().__call__(*args, **kw)
            if self.kept is not None:
                raise Stop
            return out

    with cs.path_tweak("armed"):
        wf = dataflow.build_w3(strategy="reshape", device="cuda",
                               device_executor="jit", n_tuples=cs.W3_TUPLES)
    with Pick(kctrl, cs.CTRL_PICK) as rec:
        try:
            wf.run()
        except Stop:
            pass
    cs.check(rec.kept is not None,
             f"W3 ended before its ctrl_step call {cs.CTRL_PICK}")
    return rec.kept


def ctrl(torch, cs, _build) -> None:
    import time

    from repro_torch.dataflow import device as tdev
    from repro_torch.kernels import ctrl_step as kctrl
    from repro_torch.kernels import ref

    first = build(_build, "variants/ctrl_step_serial",
                  {"first design (one thread)": {}})
    serial = first["first design (one thread)"]

    class SerialArgs(ctypes.Structure):
        """The first design's ``CtrlArgs``: phi by device pointer only."""
        _fields_ = [f for f in kctrl._Args._fields_ if f[0] != "phi_param"]

    serial.repro_ctrl_step.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                       ctypes.c_void_p]
    serial.repro_ctrl_step.restype = ctypes.c_int
    cs.check(serial.repro_ctrl_step_args_size() == ctypes.sizeof(SerialArgs),
             "the first design's CtrlArgs disagrees with SerialArgs")

    def as_is(spec, c, arr, phi):
        block = kctrl.ArgBlock(spec, c)
        return lambda t0, k, left: kctrl.ctrl_step(
            spec, c, arr, phi, t0, k, left, 0.0, block=block)

    def first_design(spec, c, arr, phi):
        phi_dev = torch.tensor(phi, dtype=torch.float64, device="cuda")
        args = SerialArgs(**{n: c[n].data_ptr() for n in kctrl.STATE_DTYPES})
        args.arrived, args.phi = arr.data_ptr(), phi_dev.data_ptr()
        for name in kctrl._SPEC_DOUBLES:
            setattr(args, name, float(getattr(spec, name)))
        for name in kctrl._SPEC_INTS:
            setattr(args, name, int(getattr(spec, name)))
        where = _build.device_and_stream(c["weights"].device)

        def call(t0, k, left):
            args.t0, args.k, args.tuples_left = t0, k, left
            code = serial.repro_ctrl_step(ctypes.addressof(args), *where)
            cs.check(code == 0, f"launch failed: CUDA error {code}")
        call.phi = phi_dev       # the kernel reads it by address
        return call

    designs = {"as is (warp 0, a lane a ring)": as_is,
               "first design (one thread)": first_design}
    cases = []
    for W, K in ((20, 40), (48, 56), (64, 128)):
        spec = cs.ctrl_spec(tdev, W, K)
        for share in (4, 2):
            state, arrived, phi = cs.ctrl_state(torch, ref, 100 * W, W, K,
                                                64, share)
            cases.append((f"W={W} K={K} one in {share} mitigating", spec,
                          state, arrived, phi, 3, 5e4))
    spec, state, arrived, phi, t0, _, left = w3_state(torch, cs, kctrl)
    cases.append((f"W3's state at tick {t0} (W={spec.W} K={spec.K}, "
                  f"{int(state['mit_active'].sum())} mitigations live)",
                  spec, state, arrived, phi, t0, left))
    for what, spec, state, arrived, phi, t0, left in cases:
        for k in (1, 16):
            want = tdev.ctrl_state_from_numpy(state, "cpu")
            ref.ctrl_step(spec, want, torch.from_numpy(arrived.copy()), phi,
                          t0, k, left, 0.0)
            runs = {}
            for name, make in designs.items():
                c = tdev.ctrl_state_from_numpy(state, "cuda")
                saved = {n: t.clone() for n, t in c.items()}
                arr = torch.from_numpy(arrived.copy()).cuda()
                runs[name] = (c, saved, arr, arr.clone(),
                              make(spec, c, arr, phi))
                runs[name][4](t0, k, left)
                torch.cuda.synchronize()
                for n in kctrl.STATE_DTYPES:
                    cs.check(torch.equal(cs.bits(torch, c[n].cpu()),
                                         cs.bits(torch, want[n])),
                             f"{name}: {n} differs from the plain version "
                             f"at {what} k={k}")
            for turn, names in enumerate((list(runs), list(runs)[::-1])):
                for name in names:
                    c, saved, arr, arr0, call = runs[name]
                    reps, spans, host = 200, [], 0.0
                    for i in range(reps + 3):
                        for n, t in saved.items():
                            c[n].copy_(t)
                        arr.copy_(arr0)
                        torch.cuda.synchronize()
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                        h0 = time.perf_counter()
                        call(t0, k, left)
                        took = time.perf_counter() - h0
                        ev[1].record()
                        if i >= 3:
                            host += took
                            spans.append(ev)
                    torch.cuda.synchronize()
                    ms = sum(a.elapsed_time(b) for a, b in spans) / reps
                    print(f"{name}: ctrl_step at {what} k={k} turn {turn}: "
                          f"{ms:.5f} ms a call (CUDA events, {reps} calls), "
                          f"submitted in {host / reps * 1e3:.5f} ms; "
                          f"bit-identical to the plain version", flush=True)
            del runs


def main() -> int:
    import torch

    if sys.argv[1:] not in (["k4"], ["k5"], ["k1k2"], ["k6"], ["ctrl"]):
        print("usage: python3 kernel_variants.py k4|k5|k1k2|k6|ctrl",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    {"k4": k4, "k5": k5, "k1k2": k1k2, "k6": k6,
     "ctrl": ctrl}[sys.argv[1]](torch, cs, _build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
