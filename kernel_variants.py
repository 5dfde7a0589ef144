#!/usr/bin/env python3
"""Times variants of a kernel's source side by side on one NVIDIA GPU.

    python3 kernel_variants.py k4    # K4's ring depths
    python3 kernel_variants.py k5    # K5's wgmma kernel: exp, stages, registers

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
``[B, S, H, hd]`` layout.  Prints one line a timing.  Not part of the
smoke: it chose the constants in the sources.
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
        tag = source + "_" + re.sub(r"\W+", "_", name).strip("_")
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


def main() -> int:
    import torch

    if sys.argv[1:] not in (["k4"], ["k5"]):
        print("usage: python3 kernel_variants.py k4|k5", file=sys.stderr)
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
    {"k4": k4, "k5": k5}[sys.argv[1]](torch, cs, _build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
