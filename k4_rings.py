#!/usr/bin/env python3
"""Times K4's ring depths side by side on one NVIDIA GPU.

    python3 k4_rings.py        # from the root of a checkout; needs one card

Builds ``src/repro_torch/kernels/csrc/segment_matmul.cu`` as it is and with
other ring depths (the tiles kernel's stages and blocks an SM, the stream
kernel's stages), one library each, compiled side by side into the
gitignored ``build/repro_torch/variants/``; checks each against the plain
version (``chip_smoke.check_segment_matmul``) and times each with CUDA
events, in turns (every variant, then every variant in reverse order), at
OLMoE-1B-7B's expert products: the serve's longest prefill (C = 1780) and
a decode batch (C = 4), dense and with serve-like ``rows``.  Prints one
line a timing.  Not part of the smoke: it chose the depths in the source.
"""
from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: Edits of the source that make each variant.
VARIANTS = {
    "as is (tiles 3 stages x 2 blocks, stream 6)": {},
    "tiles 4 stages x 1 block": {
        "kPStages = 3": "kPStages = 4",
        "__launch_bounds__(kPThreads, 2)": "__launch_bounds__(kPThreads, 1)"},
    "tiles 2 stages x 2 blocks": {"kPStages = 3": "kPStages = 2"},
    "stream 4 stages": {"kSStages = 6": "kSStages = 4"},
    "stream 8 stages": {"kSStages = 6": "kSStages = 8"},
    "stream 10 stages": {"kSStages = 6": "kSStages = 10"},
}


def build(_build):
    """One library a variant, all nvcc processes at once: {name: CDLL}."""
    src = (_build.CSRC / "segment_matmul.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits.items():
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        tag = re.sub(r"\W+", "_", name).strip("_")
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
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_segment_matmul.argtypes = ([ptr] * 4 + [i32] * 6
                                             + [ptr, ctypes.POINTER(i32)])
        lib.repro_segment_matmul.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k4_rings: no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build

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

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    libs = build(_build)
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
