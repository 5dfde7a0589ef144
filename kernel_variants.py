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
    python3 kernel_variants.py k5bwd # K5's backward: the fma pair forced
                                     # at bf16 hd 128 against the wgmma
                                     # route
    python3 kernel_variants.py k4bwd # K4's backward: the copies and K4
                                     # against the dx and dw forms
    python3 kernel_variants.py k6bwd # K6's backward: the step split of its
                                     # first design and of today's, the
                                     # two held bit for bit
    python3 kernel_variants.py k7    # K7 (the Mamba scan): the first
                                     # design against the redesign, its
                                     # levers undone one at a time
    python3 kernel_variants.py k5 window  # K5's sliding window: bits
                                     # without one against the source
                                     # before it, tile skipping's share

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
``[B, S, H, hd]`` layout; and at MLA's widths, MiniCPM3-4B's (96, 64, H
40) and DeepSeek-V2-Lite's (192, 128, H 16) at the serve's B 4, S 445 and
at 1 x 4096: the source as it is against its first design there
(``csrc/variants/flash_attention_mla_first.cu``), old, new, new, old,
each also with its exponentials replaced by a copy (wrong numbers, timed
only), out and lse held bit for bit between the two designs at those
shapes and at ``chip_smoke.mla_kernel_phase``'s, with the card's own
time (profiler) and the host's submit time beside the CUDA-event time.  K1 and K2 at the smoke's real shape (N = 2^24,
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
and the host's submit time of a call.  K5's backward (``k5bwd``) at the
training shape (B 4, H 16, S 512, hd 128, bf16 from the model's views,
causal) and at OLMoE's context (1 x 4096): the fma pair forced at bf16 hd
128 (its first design, the route those calls took before the wgmma
route) against the wgmma route, each within its route's
``check_flash_bwd`` bound, beside SDPA's backward and each route's bound;
and at MLA's widths, (96, 64) (MiniCPM3-4B's B 4, H 40, S 512 and 1 x
4096) and (192, 128) (DeepSeek-V2-Lite's B 4, H 16, S 512 and 1 x 4096),
with hd 128 (OLMoE-1B-7B's, the same shapes) in the same call, the first
MLA design against the source as it is, in turns, each whole and stopped
after its prep pass or after dkv (the split of a call by CUDA events),
and the source with one lever of a redesign undone (``K5BWD_NOW``), with
the profiler's time of each of the three kernels, SDPA's backward and
``k5_bwd_bound``; dq, dk and dv held bit for bit between the designs (at
every ``mla_bit_cases`` case of the three widths) and across two calls.
K4's backward (``k4bwd``) at the training path's expert products (E 72,
C 320, D / F 2048 / 1024 both ways, rows drawn in [0, C]): its first
design (``torch.where``, contiguous transposes and two K4 launches)
against the tiles kernel's dx and dw forms, each within
``check_seg_bwd``, beside ``torch.bmm`` and the bound, with the device
memory each call allocates at its peak.  K6's backward (``k6bwd``) at the
RWKV6 training shape (B 4, H 32, T 512, hd 64) and at RWKV6's context (1 x
4096), from ``chip_smoke.rwkv_inputs`` in the model's ``[B, T, H, hd]``
views: its first design (``csrc/variants/rwkv_scan_bwd_first.cu``, one
block a (b, h)) and the source as it is, each with edits that take one
phase of a chunk away or change one constant (the split of a step:
recompute, gradient writes, the row-sum exchange, the walk, the helpers'
work, the staging; bands of 16 rows, four partial buffers); both designs
fed the
checkpoints of one forward call and held bit for bit in all six outputs
(three type kinds, without and with state0 and dstate_T), the variants
that keep the arithmetic too; timed in turns beside ``k6_bwd_bound``.
Prints one line a timing.
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
        "  // The consumers: warpgroup wg owns rows":
        "  asm volatile(\"setmaxnreg.inc.sync.aligned.u32 240;\\n\");\n"
        "  // The consumers: warpgroup wg owns rows"},
}


def apply_edits(src: str, edits, name: str = "") -> str:
    """``src`` with each ``old: new`` of ``edits`` made in turn; raises
    unless every ``old`` is in the text exactly once when its turn comes."""
    for old, new in edits.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not once in the source")
        src = src.replace(old, new)
    return src


def build(_build, source: str, variants, only: str = ""):
    """One library a variant of ``csrc/<source>.cu``, all nvcc processes at
    once: {name: CDLL}.  Prints each variant's ``-Xptxas -v`` lines and
    ptxas's warnings that it serialized wgmma (of the kernels whose
    mangled names hold ``only``)."""
    src = (_build.CSRC / f"{source}.cu").read_text()
    out = _build.BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in variants.items():
        text = apply_edits(src, edits, name)
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
            elif ("Used" in line or "spill" in line) and only in fn:
                print(f"{name}: {fn}: {line.strip()}", flush=True)
            elif "Performance Loss" in line and only in line:
                print(f"{name}: {line.strip()}", flush=True)
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


#: Edits of K5's source, and of its first design at MLA's widths
#: (``csrc/variants/flash_attention_mla_first.cu``), that replace the
#: forward's exponentials by a copy of their argument: wrong numbers,
#: timed only, for the share of a tile the serialized softmax costs.
K5_EXP_COPY = {"sc[i] = __expf(sc[i] - mx[(i >> 1) & 1]);":
               "sc[i] = sc[i] - mx[(i >> 1) & 1];",
               "corr[r] = __expf(m[r] - mx[r]);": "corr[r] = m[r] - mx[r];"}
K5_MLA_FIRST = {"first MLA design": {},
                "first MLA design, exponentials a copy": K5_EXP_COPY}
K5_MLA_NOW = {"as is, exponentials a copy": K5_EXP_COPY}
#: The MLA variants whose numbers are wrong by design (timed only).
K5_WRONG = ("first MLA design, exponentials a copy",
            "as is, exponentials a copy")
#: K5 as it was first built at Whisper's (64, 64)
#: (``csrc/variants/flash_attention_whisper_first.cu``), whole.
K5_WHISPER_FIRST = {"first Whisper design": {}}
#: Edits of K5's source that undo one lever of the (64, 64) forward's
#: redesign: two or three consumer warpgroups a block at every shape (not
#: three, or two where that leaves fewer waves of blocks; dq's too), a
#: ring of 2 64-key tiles instead of 4.
K5_WHISPER_NOW = {
    "as is, two consumer warpgroups always": {
        "return 100 * w2 < 122 * w3 ? 2 : 3;": "return 2;"},
    "as is, three consumer warpgroups always": {
        "return 100 * w2 < 122 * w3 ? 2 : 3;": "return 3;"},
    "as is, a 2-stage ring": {
        "constexpr int kOStages = 4;": "constexpr int kOStages = 2;"},
}
#: ptxas lines and the variants' builds of the (64, 64) kernels.
WHISPER_ONLY = "Li64ELi64E"


def whisper_shapes(cs, forward: bool):
    """Whisper-medium's K5 calls at (64, 64) that are timed, B 4, H 16:
    ``chip_smoke.WHISPER_K5_TIMED`` (the encoder, the cross attention, the
    causal decoder) and, for the forward, a decode step's one query against
    the 1,500 frames: [(name, S, T, causal)]."""
    shapes = list(cs.WHISPER_K5_TIMED)
    if forward and all(S != 1 for _, S, _, _ in shapes):
        shapes.append(("decode step", 1, 1500, False))
    return shapes


def whisper_qkv(torch, cs, seed: int, B: int, H: int, S: int, T: int):
    """bf16 q, k, v at (64, 64) through the model's ``[B, S, H, hd]``
    views."""
    return tuple(cs.randn(torch, seed + i, (B, n, H, 64),
                          torch.bfloat16).transpose(1, 2)
                 for i, n in enumerate((S, T, T)))


def bits_word(torch, got, want) -> str:
    return "the same bits as" if same_bits(torch, got, want) else \
        "OTHER bits than"


def k5_lib(lib, window: bool = True):
    """``lib``'s two entries typed as ``flash_attention._library`` types
    them; returns ``lib``.  ``window``: the source takes K5's window
    argument after ``causal`` (the sources since the hybrid family's
    window; the designs kept under ``csrc/variants/`` are older and do
    not)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    n = 3 if window else 2
    lib.repro_flash_attention.argtypes = (
        [ptr] * 5 + [i32] * 7 + [ctypes.c_float] + [i32] * n
        + [ctypes.POINTER(ctypes.c_longlong), i32, ptr, ctypes.POINTER(i32)])
    lib.repro_flash_attention.restype = i32
    lib.repro_flash_attention_bwd.argtypes = (
        [ptr] * 10 + [i32] * 7 + [ctypes.c_float] + [i32] * n
        + [ctypes.POINTER(ctypes.c_longlong), i32, i32, ptr])
    lib.repro_flash_attention_bwd.restype = i32
    lib.k5_window = window
    return lib


def mask_args(lib, causal: bool, window=None):
    """The mask arguments ``lib`` takes: (causal, window, dtype) or, from a
    source without the window, (causal, dtype) (bf16, and no window)."""
    if not lib.k5_window:
        if window is not None:
            raise ValueError("this source takes no window")
        return int(causal), 1
    return int(causal), window or 0, 1


def k5_fwd(torch, cs, _build, lib, q, k, v, causal=True, lse=False,
           window=None):
    """One forward on ``lib`` as ``flash_attention`` makes it (bf16, the
    wgmma route): out, or (out, lse)."""
    from repro_torch.kernels import flash_attention as kfa
    B, H, S, dk = q.shape
    KV, T, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((B, H, S, dv), dtype=torch.float32, device="cuda")
    lse_t = (torch.empty((B, H, S), dtype=torch.float32, device="cuda")
             if lse else None)
    route = ctypes.c_int(-1)
    code = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse_t is None else lse_t.data_ptr(), B, H, KV, S, T, dk, dv,
        dk ** -0.5, *mask_args(lib, causal, window),
        (ctypes.c_longlong * 9)(*(kfa._strides(q) + kfa._strides(k)
                                  + kfa._strides(v))),
        *_build.device_and_stream(q.device), ctypes.byref(route))
    cs.check(code == 0 and route.value == 1,
             f"launch failed: CUDA error {code}, route {route.value}")
    return (out, lse_t) if lse else out


def k5_bwd(torch, cs, _build, lib, route, q, k, v, out, dout, lse,
           causal=True, window=None):
    """One backward on ``lib`` and ``route`` as ``flash_attention_bwd``
    makes it: (dq, dk, dv)."""
    from repro_torch.kernels import flash_attention as kfa
    B, H, S, dk_w = q.shape
    KV, T, dv_w = k.shape[1], k.shape[2], v.shape[3]
    dq = torch.empty((B, H, S, dk_w), dtype=q.dtype, device="cuda")
    dk = torch.empty((B, KV, T, dk_w), dtype=k.dtype, device="cuda")
    dv = torch.empty((B, KV, T, dv_w), dtype=v.dtype, device="cuda")
    n = (2 * B * H * -(-S // 128) * 128 + B * H * S * dv_w
         if route == "wgmma" else 2 * B * H * S)
    ws = torch.empty(n, dtype=torch.float32, device="cuda")
    code = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr(), B, H, KV, S, T, dk_w, dv_w,
        dk_w ** -0.5, *mask_args(lib, causal, window),
        (ctypes.c_longlong * 9)(*(kfa._strides(q) + kfa._strides(k)
                                  + kfa._strides(v))),
        kfa.ROUTES.index(route), *_build.device_and_stream(q.device))
    cs.check(code == 0, f"{route}: launch failed: CUDA error {code}")
    return dq, dk, dv


def same_bits(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def mla_bit_cases(torch, cs, dk: int, dv: int):
    """The bf16 calls ``chip_smoke.mla_kernel_phase`` makes at (dk, dv)
    (also made at hd 128 here; at (192, 128) with ``MLA_BWD_EDGES``):
    [(what, q, k, v, causal)], from the model's views where it uses
    them."""
    cases, seed = [], 700
    edges = tuple((B, H, KV, S, views, True)
                  for B, H, KV, S, views in cs.MLA_BWD_EDGES
                  if (dk, dv) == (192, 128))
    for B, H, KV, S, views, causal in ((2, 8, 8, 1, True, True),
                                       (2, 8, 8, 63, True, True),
                                       (2, 8, 8, 445, True, True),
                                       (2, 8, 8, 512, True, True),
                                       (2, 8, 4, 300, False, False)) + edges:
        seed += 4
        shapes = [(B, S, h, d) if views else (B, h, S, d)
                  for h, d in ((H, dk), (KV, dk), (KV, dv))]
        q, k, v = (cs.randn(torch, seed + i, s, torch.bfloat16)
                   for i, s in enumerate(shapes))
        if views:
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        cases.append((f"({dk}, {dv}) B={B} H={H} KV={KV} S={S} "
                      f"causal={causal}", q, k, v, causal))
    return cases


def k5(torch, cs, _build) -> None:
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    libs = build(_build, "flash_attention", K5_VARIANTS)
    for lib in libs.values():
        k5_lib(lib)

    def call(lib, q, k, v):
        return k5_fwd(torch, cs, _build, lib, q, k, v)

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

    # MLA's widths: the first design against the source as it is.
    mla = {n: k5_lib(lib, False) for n, lib in build(
        _build, "variants/flash_attention_mla_first", K5_MLA_FIRST,
        "flash_wgmma").items()}
    mla["as is"] = libs[next(iter(K5_VARIANTS))]
    mla.update({n: k5_lib(lib) for n, lib in build(
        _build, "flash_attention", K5_MLA_NOW, "flash_wgmma").items()})
    first, now = mla["first MLA design"], mla["as is"]
    for dk, dv in ((96, 64), (192, 128), (128, 128)):
        for what, q, k, v, causal in mla_bit_cases(torch, cs, dk, dv):
            got, want = (k5_fwd(torch, cs, _build, lib, q, k, v, causal,
                                True) for lib in (now, first))
            ok = same_bits(torch, got, want)
            print(f"K5 forward {what}: out and lse "
                  f"{'the same bits as' if ok else 'DIFFER from'} the first "
                  f"MLA design (max |out diff| "
                  f"{float((got[0] - want[0]).abs().max()):.3g})", flush=True)
    for arch in cs.MLA_ARCHS:
        cfg = get_config(arch)
        dk, dv, H = cfg.qk_nope + cfg.qk_rope, cfg.v_head, cfg.n_heads
        for B, S in ((cs.SERVE_BATCH, 445), (1, 4096)):
            q, k, v = (cs.randn(torch, 90 + i, (B, S, H, d),
                                torch.bfloat16).transpose(1, 2)
                       for i, d in enumerate((dk, dk, dv)))
            reps = 10 if S == 4096 else 50
            want = k5_fwd(torch, cs, _build, first, q, k, v, lse=True)
            sdpa_ms = cs.time_ms(torch, lambda *a: F.scaled_dot_product_attention(
                *a, is_causal=True), (q, k, v), reps)
            bound, by = cs.k5_bound(B, H, H, S, S, dk, True, 2, dv)
            shape = f"{cs.MLA_NAMES[arch]} ({dk}, {dv}) B={B} H={H} S={S}"
            for turn, names in enumerate((list(mla), list(mla)[::-1])):
                for name in names:
                    lib = mla[name]
                    got = k5_fwd(torch, cs, _build, lib, q, k, v, lse=True)
                    tail = ""
                    if name not in K5_WRONG:
                        err = cs.check_flash(torch, name, got[0], q, k, v,
                                             True, dk ** -0.5)
                        tail = (f"; max |err| {err:.3g}; out and lse "
                                f"{'the same bits as' if same_bits(torch, got, want) else 'OTHER bits than'}"
                                f" the first MLA design")
                    ms = cs.time_ms(torch, lambda *a: k5_fwd(
                        torch, cs, _build, lib, *a), (q, k, v), reps)
                    dev = cs.device_ms(torch, lambda *a: k5_fwd(
                        torch, cs, _build, lib, *a), (q, k, v), min(reps, 20))
                    sub = cs.submit_ms(torch, lambda *a: k5_fwd(
                        torch, cs, _build, lib, *a), (q, k, v), reps)
                    print(f"{name}: K5 forward {shape} causal turn {turn}: "
                          f"{ms:.5f} ms a call (CUDA events, {reps} calls; "
                          f"bound {bound:.5f} ms by {by}, "
                          f"{100 * bound / ms:.1f}%; SDPA {sdpa_ms:.5f} ms); "
                          f"device {dev} a call (profiler); submitted in "
                          f"{sub:.5f} ms{tail}", flush=True)
            del q, k, v, want
            torch.cuda.empty_cache()
    k5_whisper(torch, cs, _build)


def k5_whisper(torch, cs, _build) -> None:
    """K5's forward at Whisper's (64, 64): the source as it is (and with
    one lever of its redesign undone, ``K5_WHISPER_NOW``) against the first
    design there, PR 31's source.  Out and lse at every other wgmma width
    compared bit for bit with the first design at ``mla_bit_cases``, and at
    (64, 64) held to ``check_flash`` / ``check_lse`` there; then each design
    timed in turns at ``whisper_shapes`` beside SDPA and ``k5_bound``."""
    import torch.nn.functional as F
    designs = {n: k5_lib(lib, False) for n, lib in build(
        _build, "variants/flash_attention_whisper_first", K5_WHISPER_FIRST,
        WHISPER_ONLY).items()}
    designs.update({n: k5_lib(lib) for n, lib in build(
        _build, "flash_attention", {"as is": {}, **K5_WHISPER_NOW},
        WHISPER_ONLY).items()})
    first, now = designs["first Whisper design"], designs["as is"]
    for dk, dv in ((128, 128), (96, 64), (192, 128), (64, 64)):
        for what, q, k, v, causal in mla_bit_cases(torch, cs, dk, dv):
            got, want = (k5_fwd(torch, cs, _build, lib, q, k, v, causal,
                                True) for lib in (now, first))
            err = cs.check_flash(torch, what, got[0], q, k, v, causal,
                                 dk ** -0.5)
            cs.check_lse(torch, what, got[1], q, k, v, causal, dk ** -0.5)
            print(f"K5 forward {what}: out and lse "
                  f"{bits_word(torch, got, want)} the first Whisper design "
                  f"(max |err| {err:.3g}, within check_flash and "
                  f"check_lse)", flush=True)
    for name, S, T, causal in whisper_shapes(cs, True):
        B, H = cs.SERVE_BATCH, 16
        q, k, v = whisper_qkv(torch, cs, 950, B, H, S, T)
        want = k5_fwd(torch, cs, _build, first, q, k, v, causal, True)
        sdpa_ms = cs.time_ms(torch, lambda *a: F.scaled_dot_product_attention(
            *a, is_causal=causal), (q, k, v), 50)
        bound, by = cs.k5_bound(B, H, H, S, T, 64, causal, 2)
        shape = f"(64, 64) {name} B={B} H={H} S={S} T={T} causal={causal}"
        for turn, names in enumerate((list(designs), list(designs)[::-1])):
            for n in names:
                lib = designs[n]

                def fn(*a):
                    return k5_fwd(torch, cs, _build, lib, *a, causal)

                got = k5_fwd(torch, cs, _build, lib, q, k, v, causal, True)
                err = cs.check_flash(torch, n, got[0], q, k, v, causal,
                                     64 ** -0.5)
                ms = cs.time_ms(torch, fn, (q, k, v), 50)
                dev = cs.device_ms(torch, fn, (q, k, v), 20)
                print(f"{n}: K5 forward {shape} turn {turn}: {ms:.5f} ms a "
                      f"call (CUDA events, 50 calls; bound {bound:.5f} ms by "
                      f"{by}, {100 * bound / ms:.1f}%; SDPA {sdpa_ms:.5f} "
                      f"ms); device {dev} a call (profiler); max |err| "
                      f"{err:.3g}; out and lse {bits_word(torch, got, want)} "
                      f"the first Whisper design", flush=True)
        del q, k, v, want
        torch.cuda.empty_cache()


#: K5 as it stood before the sliding window
#: (``csrc/variants/flash_attention_window_first.cu``), whole.
K5_WINDOW_FIRST = {"before the window": {}}
#: K5's sliding window as PR 33 built it
#: (``csrc/variants/flash_attention_window_pr33.cu``: the forward's and dq's
#: blocks own 192 consecutive rows of one head on a 4- and a 2-stage ring,
#: edge tiles masked score by score, the forward twice), whole and with one
#: edit each: what paces it.  Its overlap ring at 8 stages (every (64, 64)
#: forward; only windowed calls are timed on it), dq's ring at 4, and its
#: window's mask kept with no tile skipped (every walk from tile 0, dkv's
#: query walks to S).
K5_WINDOW_PR33 = {
    "PR 33's window": {},
    "PR 33's window, an 8-stage forward ring": {
        "constexpr int kOStages = 4;": "constexpr int kOStages = 8;"},
    "PR 33's window, a 4-stage dq ring": {
        "constexpr int kBStages = 2;": "constexpr int kBStages = 4;"},
    "PR 33's window, no tile skipped": {
        "const int j_lo = kWin ? max(0, q0 - window + 1) / 64 : 0;":
        "const int j_lo = 0;",
        "  const int j_own = kWin && row_lo < S\n"
        "                        ? max(j_lo, max(0, row_lo - window + 1) / 64)\n"
        "                        : j_lo;":
        "  const int j_own = j_lo;",
        "    if constexpr (kWin)\n      it.n_q = (min(":
        "    if constexpr (false)\n      it.n_q = (min(",
        "  const int j_lo = kWin ? max(0, q0 - window + 1) / kRows : 0;":
        "  const int j_lo = 0;",
        "    if constexpr (kWin) live = live && k0 + kRows - 1 > row_lo - window;":
        "    if constexpr (kWin) live = live && true;",
        "      if constexpr (kWin) live = live && q0 < kw0 + kRows - 1 + window;":
        "      if constexpr (kWin) live = live && true;"},
}
#: Edits of PR 33's window that take one cost away (wrong numbers, timed
#: only): the forward's second masking pass; every consumer warpgroup of
#: the forward's and dq's blocks on the block's first rows (their walks
#: coincide: no skew, no idle steps).
K5_WINDOW_PR33_SPLIT = {
    "PR 33's window, one masking pass": {
        "  if (edge) {\n#pragma unroll\n    for (int i = 0; i < 32; ++i)\n"
        "      if (masked(i)) sc[i] = 0.0f;\n  }\n": ""},
    "PR 33's window, warpgroups on one walk": {
        "  const int row_lo = q0 + 64 * wg;\n"
        "  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;\n"
        "  const int n_own":
        "  const int row_lo = q0;\n"
        "  const int r0 = row_lo + 16 * (warp % 4) + lane / 4;\n"
        "  const int n_own",
        "  const int row_lo = q0 + kRows * wg;": "  const int row_lo = q0;"},
}
#: Edits of K5's source that undo one lever of the window's redesign, or
#: try another constant: the window's mask kept with no tile skipped
#: (every unit's walk from tile 0, dkv's query walks to S); the forward's
#: second masking pass kept; the forward's and dq's grids a block a block
#: of units (not one block an SM taking them in turn); the forward's and
#: dq's rings at 6 and 4 stages (not 4 and 2; every (64, 64) call, only
#: windowed ones timed); dkv's at 4 (not 3).
K5_WINDOW_NOW = {
    "as is, no tile skipped": {
        "    return max(0, 64 * t - window + 1) / 64;": "    return 0;",
        "    if constexpr (kWin)\n      it.n_q = (min(":
        "    if constexpr (false)\n      it.n_q = (min(",
        "      if constexpr (kWin) live = live && q0 < kw0 + kRows - 1 + window;":
        "      if constexpr (kWin) live = live && true;"},
    "as is, two masking passes": {"  if (edge && !exact) {": "  if (edge) {"},
    "as is, a block a block of units": {
        "  return min(blocks, static_cast<long long>(sm_count(device)));":
        "  return blocks;"},
    "as is, deeper rings": {
        "constexpr int kOStages = 4;": "constexpr int kOStages = 6;",
        "constexpr int kBStages = 2;": "constexpr int kBStages = 4;"},
    "as is, dkv on a 4-stage ring": {
        "static constexpr int kKVStages = kOwnKeys ? 3 : kBStages;":
        "static constexpr int kKVStages = kOwnKeys ? 4 : kBStages;"},
}
#: The window's kernels by the names the profiler gives them.
K5_WINDOW_KERNELS = ("flash_wgmma", "flash_bwd_prep", "flash_bwd_dkv_wgmma",
                     "flash_bwd_dq_wgmma")
#: ptxas's lines of the window's instantiations only.
WINDOW_ONLY = "Li64ELi64ELb1E"


def hybrid_qkv(torch, cs, seed: int, S=None):
    """bf16 q, k, v at Hymba's (64, 64), ``chip_smoke.HYBRID_K5``'s B, H
    and KV (and S unless given), through the model's ``[B, S, H, hd]``
    views."""
    B, H, KV, S0, _ = cs.HYBRID_K5
    return tuple(cs.randn(torch, seed + i, (B, S or S0, n, 64),
                          torch.bfloat16).transpose(1, 2)
                 for i, n in enumerate((H, KV, KV)))


def k5_window(torch, cs, _build) -> None:
    """K5's sliding window at Hymba's (64, 64): the source as it is
    against PR 33's window (``csrc/variants/flash_attention_window_pr33.cu``,
    the same source without a window as PR 34's).  Calls without a window
    held bit for bit to PR 33's source and to the source before the window
    at every wgmma width (``mla_bit_cases``) and at Whisper's shapes,
    forward out and lse and backward dq, dk, dv, and timed against PR 33's
    in turns at Whisper's encoder and at Hymba's shape (full causal).  Then
    windowed, at the train shape (``chip_smoke.HYBRID_K5``: B 4, H 25, KV
    5, S 2,048, window 1,024), the serve's S 1,907 and windows 63 and 65 at
    S 2,048: each source whole, with one lever undone (``K5_WINDOW_NOW``)
    or one edit (``K5_WINDOW_PR33``), and PR 33's with one cost taken away
    (``K5_WINDOW_PR33_SPLIT``, wrong numbers: timed only), forward and
    backward in turns (every variant, then every variant in reverse
    order), each held to ``check_flash`` / ``check_lse`` /
    ``check_flash_bwd`` with the window (the timed-only ones not), beside
    ``k5_bound`` / ``k5_bwd_bound`` of the windowed pairs, SDPA with the
    window as a boolean mask and, for the two sources whole, the card's
    own time of each kernel (profiler)."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    first = k5_lib(build(_build, "variants/flash_attention_window_first",
                         K5_WINDOW_FIRST, WINDOW_ONLY)[
        "before the window"], False)
    libs = {n: k5_lib(lib) for n, lib in build(
        _build, "variants/flash_attention_window_pr33",
        {**K5_WINDOW_PR33, **K5_WINDOW_PR33_SPLIT}, WINDOW_ONLY).items()}
    libs.update({n: k5_lib(lib) for n, lib in build(
        _build, "flash_attention", {"as is": {}, **K5_WINDOW_NOW},
        WINDOW_ONLY).items()})
    now, pr33 = libs["as is"], libs["PR 33's window"]
    timed_only = set(K5_WINDOW_PR33_SPLIT)
    for dk, dv in ((128, 128), (96, 64), (192, 128), (64, 64)):
        cases = mla_bit_cases(torch, cs, dk, dv)
        if (dk, dv) == (64, 64):
            for name, S, T, causal in whisper_shapes(cs, False):
                q, k, v = whisper_qkv(torch, cs, 1340, 2, 16, S, T)
                cases.append((f"(64, 64) Whisper's {name}", q, k, v, causal))
        for what, q, k, v, causal in cases:
            got = k5_fwd(torch, cs, _build, now, q, k, v, causal, True)
            dout = cs.randn(torch, 9, got[0].shape, torch.float32)
            gb = k5_bwd(torch, cs, _build, now, "wgmma", q, k, v, got[0],
                        dout, got[1], causal)
            words = []
            for name, lib in (("PR 33's", pr33), ("before the window", first)):
                want = k5_fwd(torch, cs, _build, lib, q, k, v, causal, True)
                wb = k5_bwd(torch, cs, _build, lib, "wgmma", q, k, v, got[0],
                            dout, got[1], causal)
                words.append(f"forward {bits_word(torch, got, want)}, "
                             f"backward {bits_word(torch, gb, wb)} {name}")
            print(f"K5 {what} without a window: {'; '.join(words)}",
                  flush=True)
    # Calls without a window, PR 33's source against as is, in turns.
    for name, B, H, KV, S, causal in (("Whisper's encoder", 4, 16, 16, 1500,
                                       False),
                                      ("Hymba's shape", *cs.HYBRID_K5[:4],
                                       True)):
        q, k, v = (cs.randn(torch, 1320 + i, (B, S, n, 64),
                            torch.bfloat16).transpose(1, 2)
                   for i, n in enumerate((H, KV, KV)))
        out, lse = kfa.flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
        dout = cs.randn(torch, 1323, out.shape, torch.float32)
        pair = (("PR 33's window", pr33), ("as is", now))
        for turn, order in enumerate((pair, pair[::-1], pair, pair[::-1])):
            for n, lib in order:
                ms = cs.time_ms(torch, lambda *a: k5_fwd(
                    torch, cs, _build, lib, *a, causal), (q, k, v), 20)
                bms = cs.time_ms(torch, lambda *a: k5_bwd(
                    torch, cs, _build, lib, "wgmma", *a, causal),
                    (q, k, v, out, dout, lse), 10)
                print(f"{n}: K5 (64, 64) without a window at {name} (B={B} "
                      f"H={H} KV={KV} S=T={S} causal={causal}) turn {turn}: "
                      f"forward {ms:.5f} ms, backward {bms:.5f} ms",
                      flush=True)
        del q, k, v, out, lse, dout
    B, H, KV, S0, W0 = cs.HYBRID_K5
    scale = 64 ** -0.5
    for shape_name, S, W in (("train", S0, W0), ("serve", 1907, W0),
                             ("window 63", S0, 63), ("window 65", S0, 65)):
        q, k, v = hybrid_qkv(torch, cs, 1300, S)
        mask = cs.window_mask(torch, S, W, q.device)
        sdpa_ms = cs.time_ms(torch, lambda *a: F.scaled_dot_product_attention(
            *a, attn_mask=mask, enable_gqa=True), (q, k, v), 20)
        out, lse = kfa.flash_attention(q, k, v, scale=scale,
                                       return_lse=True, window=W)
        dout = cs.randn(torch, 1303, out.shape, torch.float32)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=mask,
                                              enable_gqa=True)
        sdpa_bwd_ms = cs.time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), dout.to(sdpa.dtype), retain_graph=True), (),
            10)
        fb, fby = cs.k5_bound(B, H, KV, S, S, 64, True, 2, None, W)
        bb, bby = cs.k5_bwd_bound(B, H, KV, S, S, 64, True, 2, "wgmma",
                                  None, W)
        names = [n for n in libs if n != "as is"] + ["as is"]
        if shape_name != "train":     # the levers at the train shape only
            names = ["PR 33's window", "as is"]
        shape = f"(64, 64) {shape_name} B={B} H={H} KV={KV} S=T={S} causal"
        for turn, order in enumerate((names, names[::-1])):
            for n in order:
                lib = libs[n]
                o, l_ = k5_fwd(torch, cs, _build, lib, q, k, v, True, True, W)
                g = k5_bwd(torch, cs, _build, lib, "wgmma", q, k, v, o, dout,
                           l_, True, W)
                tail = ""
                if n not in timed_only:
                    err = cs.check_flash(torch, n, o, q, k, v, True, scale, W)
                    cs.check_lse(torch, n, l_, q, k, v, True, scale, W)
                    berr = cs.check_flash_bwd(torch, n, g, q, k, v, o, dout,
                                              True, scale, "wgmma", W)
                    tail = f"; max |err| {err:.3g} / {berr:.3g}"
                ms = cs.time_ms(torch, lambda *a: k5_fwd(
                    torch, cs, _build, lib, *a, True, False, W), (q, k, v),
                    20)
                bms = cs.time_ms(torch, lambda *a: k5_bwd(
                    torch, cs, _build, lib, "wgmma", *a, True, W),
                    (q, k, v, o, dout, l_), 10)
                if n in ("as is", "PR 33's window"):
                    dev = kernel_ms(torch, lambda *a: (
                        k5_fwd(torch, cs, _build, lib, *a[:3], True, False,
                               W),
                        k5_bwd(torch, cs, _build, lib, "wgmma", *a, True,
                               W)), (q, k, v, o, dout, l_), 10,
                        K5_WINDOW_KERNELS)
                    tail += "; device " + ", ".join(
                        f"{k_} {t:.5f}" for k_, t in dev.items())
                print(f"{n}: K5 {shape} window {W} turn {turn}: forward "
                      f"{ms:.5f} ms (bound {fb:.5f} by {fby}, "
                      f"{100 * fb / ms:.1f}%), backward {bms:.5f} ms (bound "
                      f"{bb:.5f} by {bby}, {100 * bb / bms:.1f}%); SDPA with "
                      f"the window as a mask {sdpa_ms:.5f} ms, its backward "
                      f"{sdpa_bwd_ms:.5f} ms{tail}", flush=True)
                del o, l_, g
        del q, k, v, out, lse, dout, qg, kg, vg, sdpa, mask
        torch.cuda.empty_cache()


#: Edits of K7's first design (csrc/variants/mamba_scan_first.cu) that
#: make each variant: its blocks held to a third as many registers (six
#: blocks an SM: the grid in one wave), or the exponential by ``__expf``
#: (ex2.approx of x log2 e).
K7_VARIANTS = {
    "first (expf, 128 threads, registers free)": {},
    "six blocks an SM": {
        "__global__ void __launch_bounds__(kThreads)\n"
        "mamba_scan_kernel(":
        "__global__ void __launch_bounds__(kThreads, 6)\n"
        "mamba_scan_kernel("},
    "__expf": {"  da = expf(__fmul_rn(dl, an));":
               "  da = __expf(__fmul_rn(dl, an));"},
}

#: Edits of K7's first design that take one cost away (wrong numbers,
#: timed only): what paces it.  Its walk with the global loads replaced
#: by values already in registers, with the exponential replaced by a
#: multiply, and its backward without the per-block partial writes and
#: without the second launch.
K7_FIRST_SPLIT = {
    "first, loads from registers": {
        "    dl[i] = in && w.chan ? delta[at] : 0.0f;\n"
        "    xv[i] = in && w.chan ? widen(x[at]) : 0.0f;\n"
        "    bv[i] = in && w.live ? bm[an] : 0.0f;\n"
        "    cv[i] = in && w.live ? cm[an] : 0.0f;\n":
        "    dl[i] = in && w.chan ? 0.5f + 0.001f * (t & 63) : 0.0f;\n"
        "    xv[i] = in && w.chan ? 1.0f - 0.002f * (t & 31) : 0.0f;\n"
        "    bv[i] = in && w.live ? 0.25f * (w.lane - 7) : 0.0f;\n"
        "    cv[i] = in && w.live ? 0.125f * (i - 7) : 0.0f;\n"},
    "first, exp by a multiply": {
        "  da = expf(__fmul_rn(dl, an));":
        "  da = __fmul_rn(__fmul_rn(dl, an), 0.01f);"},
    "first, no partial writes or second launch": {
        "          pb[at] = sb;\n          pc[at] = sc;\n":
        "          if (sb == 1e-30f && sc == 1e-30f) pb[at] = sb;\n",
        "  mamba_scan_bwd_sum<<<": "  if (total < 0) mamba_scan_bwd_sum<<<"},
}

#: Edits of K7's source as it is (csrc/mamba_scan.cu), each undoing one
#: lever of its redesign or trying another constant: the forward's
#: exponential by exp2f (no longer one instruction); the backward's by
#: expf, or by ex2 without its correction (faster, but at S 1 beyond
#: ``check_mamba_bwd``'s dh0 bound); the forward's state update without
#: contraction; the ring two chunks ahead; the forward's chunks of 16 or
#: 64 steps; other lanes a channel (8: two states a lane, 16 channels a
#: block; 16: one state a lane, 8 channels a block); checkpoints every 8
#: steps; the backward's partials a block (no cluster); the cluster
#: barrier released by the last warp, or by every warp; and a second
#: exponential in the backward's walk down (the same bits).
K7_NOW = {
    "now (ex2, fma, ring 1 ahead, 4 lanes a channel, clusters)": {},
    "forward exp2f": {
        '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(r) : "f"(v));':
        "  r = exp2f(v);"},
    "backward expf": {"  da = exp_of(__fmul_rn(dl, an));":
                      "  da = expf(__fmul_rn(dl, an));"},
    "backward ex2 uncorrected": {
        "  da = exp_of(__fmul_rn(dl, an));":
        "  da = ex2(__fmul_rn(dl, __fmul_rn(an, kLog2e)));"},
    "forward no contraction": {
        "        h[s] = __fmaf_rn(ex2(__fmul_rn(dl, a2[s])), h[s],\n"
        "                         __fmul_rn(__fmul_rn(dl, bv[s]), xv));":
        "        h[s] = __fadd_rn(__fmul_rn(ex2(__fmul_rn(dl, a2[s])), h[s]),\n"
        "                         __fmul_rn(__fmul_rn(dl, bv[s]), xv));"},
    "ring 2 ahead": {"constexpr int kAhead = 1;": "constexpr int kAhead = 2;"},
    "forward chunks of 16": {"constexpr int kChunk = 32;":
                             "constexpr int kChunk = 16;"},
    "forward chunks of 64": {"constexpr int kChunk = 32;":
                             "constexpr int kChunk = 64;"},
    "forward 8 lanes a channel": {"using FwdMap = Map<4>;":
                                  "using FwdMap = Map<8>;"},
    "forward 16 lanes a channel": {"using FwdMap = Map<4>;":
                                   "using FwdMap = Map<16>;"},
    "backward 8 lanes a channel": {"using BwdMap = Map<4>;":
                                   "using BwdMap = Map<8>;"},
    "checkpoints every 8": {"constexpr int kCk = 16;": "constexpr int kCk = 8;"},
    "no cluster": {"  for (int k = kMaxCluster; k > 1; --k)":
                   "  for (int k = 1; k > 1; --k)"},
    "the last warp releases": {
        "    if (tid < 32)\n      sm90::cluster_arrive();":
        "    if (tid >= kThreads - 32)\n      sm90::cluster_arrive();"},
    "every warp releases": {"    if (tid < 32)\n      sm90::cluster_arrive();":
                            "    if (tid < kThreads)\n"
                            "      sm90::cluster_arrive();"},
    "exp again in the walk": {
        "          const float ht = i + 1 < kCk ?":
        "          da[i][s] = exp_of(__fmul_rn(dl, an[s]));\n"
        "          const float ht = i + 1 < kCk ?"},
}

#: Edits of K7's source as it is that take one cost away (wrong numbers,
#: timed only): the forward's or the backward's exponential replaced by a
#: multiply-add; the forward's ring reads (values from registers); its
#: butterfly; the backward's sums of dB and dC over the block's channels;
#: the release of its cluster barrier a chunk (relaxed: the partial sums
#: may be read stale); its stores of dx and ddelta.
K7_NOW_SPLIT = {
    "now, forward exp by a multiply": {
        "        h[s] = __fmaf_rn(ex2(__fmul_rn(dl, a2[s])), h[s],":
        "        h[s] = __fmaf_rn(__fmaf_rn(__fmul_rn(dl, a2[s]), 0.001f, "
        "0.99f), h[s],"},
    "now, backward exp by a multiply": {
        "  da = exp_of(__fmul_rn(dl, an));":
        "  da = __fmaf_rn(__fmul_rn(dl, an), 0.001f, 0.99f);"},
    "now, forward without ring reads": {
        "      const float dl = sdl[i * kDPB + w.c];\n"
        "      const float xv = widen(sx[i * kDPB + w.c]);\n"
        "      float bv[kSPL], cv[kSPL];\n"
        "      load_states(sb + i * kMaxN + w.n0, bv);\n"
        "      load_states(sc + i * kMaxN + w.n0, cv);\n":
        "      const float dl = 0.5f + 0.001f * (i + w.c);\n"
        "      const float xv = 1.0f - 0.002f * (i + w.q);\n"
        "      float bv[kSPL], cv[kSPL];\n"
        "      for (int s = 0; s < kSPL; ++s) {\n"
        "        bv[s] = 0.25f * (s + w.q - 1.5f);\n"
        "        cv[s] = 0.125f * (i - s - w.c);\n"
        "      }\n"},
    "now, forward without its butterfly": {
        "    fold<M::kLPC / 2, kChunk>(yp, w.q);\n": ""},
    "now, no sums over the block's channels": {
        "    for (int gi = tid; gi < kGroups; gi += kThreads) {":
        "    for (int gi = tid; gi < 0; gi += kThreads) {"},
    "now, relaxed cluster arrivals": {
        "    if (tid < 32)\n      sm90::cluster_arrive();":
        "    if (tid < 0)\n      sm90::cluster_arrive();"},
    "now, no dx or ddelta stores": {
        "        if (w.chan && i < steps) {":
        "        if (w.chan && i < steps && s1[j] + s2[j] == 1e-30f) {"},
}

#: K7's variants whose numbers are wrong by design: timed, not checked.
K7_TIMED_ONLY = set(K7_FIRST_SPLIT) | set(K7_NOW_SPLIT)


def k7_libs(_build):
    """Every K7 library of ``k7``, typed: the first design and its edits,
    then the source as it is and its edits, {name: CDLL} in that order."""
    libs = build(_build, "variants/mamba_scan_first",
                 {**K7_VARIANTS, **K7_FIRST_SPLIT}, "mamba")
    libs.update(build(_build, "mamba_scan", {**K7_NOW, **K7_NOW_SPLIT},
                      "mamba"))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for lib in libs.values():
        lib.repro_mamba_scan.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        lib.repro_mamba_scan.restype = i32
        lib.repro_mamba_scan_bwd.argtypes = [ptr] * 17 + [i32] * 6 + [ptr]
        lib.repro_mamba_scan_bwd.restype = i32
        lib.repro_mamba_bwd_workspace.argtypes = [i32] * 4
        lib.repro_mamba_bwd_workspace.restype = ctypes.c_longlong
    return libs


def k7(torch, cs, _build) -> None:
    """K7 at three of Hymba's shapes (bf16 x, d_inner 1,600, N 16): the
    train path's B 4 x S 2,048 (``chip_smoke.HYBRID_K7``'s first case,
    forward and backward), the serve's prefill S 1,907 and a decode step
    (S 1 with a state; forward only).  Its first design
    (``csrc/variants/mamba_scan_first.cu``) with ``K7_VARIANTS`` and the
    step-0 split ``K7_FIRST_SPLIT``, then the source as it is with
    ``K7_NOW`` and ``K7_NOW_SPLIT``, timed in turns (CUDA events; every
    library, then every library in reverse order) beside ``k7_bound`` / ``k7_bwd_bound``; in
    the first turn each checked library's forward within ``check_mamba``
    and backward within ``check_mamba_bwd`` at the train shape, and two
    backward calls the same bits.  Each library's checkpoints are as
    often as its ``repro_mamba_checkpoint_every()``."""
    libs = k7_libs(_build)
    B, S, DI, N, _ = cs.HYBRID_K7[0]
    shapes = (("train", B, S, False), ("serve", B, 1907, False),
              ("decode", B, 1, True))
    inputs = {tag: cs.mamba_inputs(torch, 1400 + i, b, s, DI, N,
                                   torch.bfloat16, state)
              for i, (tag, b, s, state) in enumerate(shapes)}
    dev = _build.device_and_stream(torch.device("cuda"))

    def fwd(lib, args, ck=None):
        x = args[0]
        b, s, _ = x.shape
        y = torch.empty_like(x)
        h = torch.empty((b, DI, N), dtype=torch.float32, device="cuda")
        code = lib.repro_mamba_scan(
            *(t.data_ptr() for t in args[:6]),
            None if args[6] is None else args[6].data_ptr(), y.data_ptr(),
            h.data_ptr(), None if ck is None else ck.data_ptr(), b, s, DI, N,
            1, *dev)
        cs.check(code == 0, f"mamba_scan failed: CUDA error {code}")
        return y, h

    args = inputs["train"]
    dy = cs.randn(torch, 1410, args[0].shape, torch.bfloat16)

    def bwd(lib, ck):
        outs = [torch.empty_like(args[0])] + [
            torch.empty(s, dtype=torch.float32, device="cuda")
            for s in ((B, S, DI), (B, S, N), (B, S, N), (DI, N), (DI,),
                      (B, DI, N))]
        ws = torch.empty(lib.repro_mamba_bwd_workspace(B, S, DI, N),
                         dtype=torch.float32, device="cuda")
        code = lib.repro_mamba_scan_bwd(
            *(t.data_ptr() for t in args[:6]), ck.data_ptr(), dy.data_ptr(),
            None, *(t.data_ptr() for t in outs), ws.data_ptr(), B, S, DI, N,
            1, *dev)
        cs.check(code == 0, f"mamba_scan_bwd failed: CUDA error {code}")
        return outs

    bounds = {tag: cs.k7_bound(b, s, DI, N, 2, state)
              for tag, b, s, state in shapes}
    bb, bby = cs.k7_bwd_bound(B, S, DI, N, 2)
    cks = {}
    for name, lib in libs.items():
        every = lib.repro_mamba_checkpoint_every()
        cks[name] = torch.empty((B, -(-S // every), DI, N),
                                dtype=torch.float32, device="cuda")
        print(f"{name}: checkpoints every {every} steps", flush=True)
    for turn, names in enumerate((list(libs), list(libs)[::-1])):
        for name in names:
            lib, ck = libs[name], cks[name]
            err = berr = float("nan")
            got = fwd(lib, args, ck)
            g = bwd(lib, ck)
            if turn == 0 and name not in K7_TIMED_ONLY:
                cs.check(all(torch.equal(u, v) for u, v in zip(
                    fwd(lib, args), got)),
                    f"{name}: other bits with checkpoints")
                err = cs.check_mamba(torch, name, got, args)
                cs.check(all(torch.equal(u, v) for u, v in zip(
                    g, bwd(lib, ck))),
                    f"{name}: two backward calls give other bits")
                berr = cs.check_mamba_bwd(torch, name, g, args, dy, None)
            del got, g
            times = {tag: cs.time_ms(torch, lambda a=inputs[tag]: fwd(lib, a),
                                     (), 20 if tag != "decode" else 200)
                     for tag, _, _, _ in shapes}
            bms = cs.time_ms(torch, lambda: bwd(lib, ck), (), 10)
            parts = [f"{tag} forward {times[tag]:.5f} ms "
                     f"({100 * bounds[tag][0] / times[tag]:.1f}% of "
                     f"{bounds[tag][0]:.5f} by {bounds[tag][1]})"
                     for tag, _, _, _ in shapes]
            print(f"{name}: K7 d_inner={DI} N={N} bf16 turn {turn}: "
                  f"{'; '.join(parts)}; train backward {bms:.5f} ms "
                  f"({100 * bb / bms:.1f}% of {bb:.5f} by {bby}); max |err| "
                  f"{err:.3g} / {berr:.3g}", flush=True)
    torch.cuda.empty_cache()


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
        lib.repro_rwkv_scan.argtypes = ([ptr] * 9 + [i32] * 5 + [i64] * 6
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
            None, B, H, T, hd, kinds[(r.dtype, w.dtype)], *r.stride()[:3],
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


#: Edits of K6's backward as first designed
#: (csrc/variants/rwkv_scan_bwd_first.cu) that each take one phase of a
#: chunk away, or fetch the checkpoint a chunk ahead: the split of its step.
K6BWD_FIRST_SPLIT = {
    "first design": {},
    "first design, no recompute (states read as the checkpoint)": {
        "        if (tt + 1 < n) {\n          const float4 k4":
        "        if (false) {\n          const float4 k4"},
    "first design, no gradient writes": {
        "    for (int i = tid; i < n * HDP; i += NT) {":
        "    for (int i = tid; i < 0; i += NT) {"},
    "first design, no du walk": {
        "      for (int tt = n - 1; tt >= 0; --tt)\n        du = fmaf":
        "      for (int tt = n - 1; tt >= n; --tt)\n        du = fmaf"},
    # The lane adds its own 16 sums: the sums stay live, the shuffles go.
    "first design, reduce-scatter without shuffles": {
        "      reduce_scatter16<CG>(x, cg);\n":
        "#pragma unroll\n      for (int i = 1; i < 16; ++i) x[0] += x[i];\n"},
    "first design, no steps": {
        "    for (int tt = n - 1; tt >= 0; --tt) {\n      const float4 r4":
        "    for (int tt = n - 1; tt >= n; --tt) {\n      const float4 r4"},
    "first design, no beta and v . dout": {
        "    for (int tt = warp; tt < n; tt += NW) {":
        "    for (int tt = warp; tt < 0; tt += NW) {"},
    "first design, no fetch of the next chunk's rows": {
        "    if (ch > 0) fetch(ch - 1);\n": ""},
    # The same bits: the checkpoint read into registers a chunk ahead.
    "first design, checkpoint fetched a chunk ahead": {
        "  if (n_ck > 0) fetch(n_ck - 1);\n":
        "  if (n_ck > 0) fetch(n_ck - 1);\n"
        "  float ckn[kRows][NC];\n"
        "  auto fetch_ck = [&](int c) {\n"
        "    const float* ck = a.ck + (static_cast<size_t>(bh) * n_ck + c)"
        " * hd * hd;\n"
        "#pragma unroll\n"
        "    for (int j = 0; j < kRows; ++j)\n"
        "#pragma unroll\n"
        "      for (int m = 0; m < NC; ++m)\n"
        "        ckn[j][m] = (r0 + j < hd && c0 + m < hd)\n"
        "                        ? ck[static_cast<size_t>(r0 + j) * hd + c0"
        " + m]\n"
        "                        : 0.0f;\n"
        "  };\n"
        "  if (n_ck > 0) fetch_ck(n_ck - 1);\n",
        "      const float* ck = a.ck + (static_cast<size_t>(bh) * n_ck + ch)"
        " * hd * hd;\n"
        "#pragma unroll\n"
        "      for (int j = 0; j < kRows; ++j)\n"
        "#pragma unroll\n"
        "        for (int m = 0; m < NC; ++m) {\n"
        "          const int row = r0 + j, col = c0 + m;\n"
        "          S[j][m] = (row < hd && col < hd)\n"
        "                        ? ck[static_cast<size_t>(row) * hd + col]\n"
        "                        : 0.0f;\n"
        "        }\n":
        "#pragma unroll\n"
        "      for (int j = 0; j < kRows; ++j)\n"
        "#pragma unroll\n"
        "        for (int m = 0; m < NC; ++m) S[j][m] = ckn[j][m];\n"
        "      if (ch > 0) fetch_ck(ch - 1);\n"},
}

#: Edits of K6's backward (csrc/rwkv_scan.cu) that each take one phase of a
#: chunk away or change one constant: the split of its step.
K6BWD_EXCHANGE = """#pragma unroll
      for (int e = 0; e < kSums; e += 4)
        *reinterpret_cast<float4*>(xme + e) =
            make_float4(x[e], x[e + 1], x[e + 2], x[e + 3]);
      __syncwarp();
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int idx = p + PER * cg;
        if (idx < kSums) {
          float v[CG];
#pragma unroll
          for (int Lg = 0; Lg < CG; ++Lg) v[Lg] = xrg[Lg * kSums + idx];
          sm90::st_async(
              rs_i + (((idx >> 2) * kCk + tt) * KB + (idx & 3)) * 4u,
              tree_sum<CG>(v), rs_bar_i);
        }
      }
      __syncwarp();
"""
K6BWD_ZEROS = """        if (lane < CG) {
          if constexpr (NC == 4)
            sm90::st_async(push_i + tt * kPushStep, 0.f, 0.f, 0.f, 0.f, bar_i);
          else
            sm90::st_async(push_i + tt * kPushStep, 0.f, 0.f, bar_i);
        }
#pragma unroll
        for (int p = 0; p < PER; ++p) {
          const int idx = p + PER * cg;
          if (idx < kSums)
            sm90::st_async(
                rs_i + (((idx >> 2) * kCk + tt) * KB + (idx & 3)) * 4u, 0.f,
                rs_bar_i);
        }
"""
K6BWD_SPLIT = {
    "as is": {},
    # The same bits: the first design's reduce-scatter of 15 shuffles.
    "row sums by shuffles": {K6BWD_EXCHANGE: """      float y[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) y[e] = e < kSums ? x[e] : 0.0f;
#pragma unroll
      for (int r = 0; (1 << r) < CG; ++r) {
        const int o = CG >> (r + 1), m = 8 >> r;
        const bool up = (cg & o) != 0;
#pragma unroll
        for (int e = 0; e < m; ++e) {
          const float send = up ? y[e] : y[e + m];
          const float keep = up ? y[e + m] : y[e];
          y[e] = keep + __shfl_xor_sync(~0u, send, o);
        }
      }
#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int idx = p + PER * cg;
        if (idx < kSums)
          sm90::st_async(
              rs_i + (((idx >> 2) * kCk + tt) * KB + (idx & 3)) * 4u, y[p],
              rs_bar_i);
      }
"""},
    # Each lane leaves its own partial as the row group's sum (the same
    # stores, no exchange).
    "row sums not exchanged": {K6BWD_EXCHANGE: """#pragma unroll
      for (int p = 0; p < PER; ++p) {
        const int idx = p + PER * cg;
        if (idx < kSums)
          sm90::st_async(
              rs_i + (((idx >> 2) * kCk + tt) * KB + (idx & 3)) * 4u, x[idx],
              rs_bar_i);
      }
"""},
    # The same bits: bands of 16 rows, four blocks a (b, h) at hd 64.
    "bands of 16 rows": {
        "  return HDP < 32 ? HDP : 32;": "  return 16;"},
    "partials in 4 buffers": {"kBwdParts = 2;": "kBwdParts = 4;"},
    "no recompute (states read as the checkpoint)": {
        "        if (tt + 1 < n) {\n          const float4 k4":
        "        if (false) {\n          const float4 k4"},
    # The gradients are taken but not stored (the compiler cannot tell).
    "no gradient writes": {
        "        const long long off = g_off + (t0 + tt) * a.gs[2] + x;\n":
        "        const long long off = g_off + (t0 + tt) * a.gs[2] + x;\n"
        "        if (off >= 0) continue;\n"},
    # Each step only leaves zeros for the owners and its row sums (the
    # barriers count the bytes).
    "no steps": {
        "      for (int tt = kCk - 1; tt >= 0; --tt) step(tt);\n":
        "      for (int tt = kCk - 1; tt >= 0; --tt) {\n" + K6BWD_ZEROS
        + "      }\n",
        "      for (int tt = n - 1; tt >= 0; --tt) step(tt);\n":
        "      for (int tt = n - 1; tt >= 0; --tt) {\n" + K6BWD_ZEROS
        + "      }\n"},
    "no beta and v . dout": {
        "        for (int q = 0; q < (HDP + 31) / 32; ++q) {":
        "        for (int q = 0; q < 0; ++q) {",
        "      for (int o = 16; o > 0; o >>= 1)":
        "      for (int o = 16; o > 16; o >>= 1)"},
    # The helpers only stage the rows and pass the barriers.
    "helpers only stage": {
        "        for (int q = 0; q < (HDP + 31) / 32; ++q) {":
        "        for (int q = 0; q < 0; ++q) {",
        "      for (int o = 16; o > 0; o >>= 1)":
        "      for (int o = 16; o > 16; o >>= 1)",
        "        if (tt >= n || x >= hd) continue;\n        float dv = 0.0f;":
        "        if (true) continue;\n        float dv = 0.0f;",
        "        if (tt >= n || x >= hd) continue;\n        const long long off":
        "        if (true) continue;\n        const long long off",
        "      if (hw == 0 && lane < KB && lo + lane < hd)\n        for (int tt":
        "      if (false)\n        for (int tt"},
}

#: The split variants whose outputs must equal the first design's bit for
#: bit (the others leave a phase out).
K6BWD_SAME_BITS = ("first design", "first design, checkpoint fetched a "
                   "chunk ahead", "as is", "row sums by shuffles",
                   "bands of 16 rows", "partials in 4 buffers")


def k6bwd(torch, cs, _build) -> None:
    from repro_torch.kernels import rwkv_scan as krw
    model = "rwkv_scan_bwd_kernelILi64E"   # hd 64
    libs = dict(build(_build, "variants/rwkv_scan_bwd_first",
                      K6BWD_FIRST_SPLIT, model))
    libs.update(build(_build, "rwkv_scan", K6BWD_SPLIT, model))
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in libs.values():
        lib.repro_rwkv_scan_bwd.argtypes = ([ptr] * 14 + [i32] * 5
                                            + [i64] * 9 + [i32, ptr])
        lib.repro_rwkv_scan_bwd.restype = i32
    kinds = {(torch.float32, torch.float32): 0,
             (torch.bfloat16, torch.float32): 1,
             (torch.bfloat16, torch.bfloat16): 2}

    def call(lib, r, k, v, w, u, s0, dout, ds, ck):
        """One backward as ``rwkv_scan_bwd`` makes it, on ``lib``."""
        B, H, T, hd = r.shape
        gs = krw._out_stride(r)
        grads = [torch.empty_strided(r.shape, gs, dtype=x.dtype,
                                     device="cuda") for x in (r, r, r, w)]
        du = torch.empty((B, H, hd), device="cuda")
        ds0 = torch.empty((B, H, hd, hd), device="cuda")
        code = lib.repro_rwkv_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), ck.data_ptr(), dout.data_ptr(),
            None if ds is None else ds.data_ptr(),
            *(g.data_ptr() for g in grads), du.data_ptr(), ds0.data_ptr(),
            B, H, T, hd, kinds[(r.dtype, w.dtype)], *r.stride()[:3],
            *dout.stride()[:3], *gs[:3], *_build.device_and_stream(r.device))
        cs.check(code == 0, f"launch failed: CUDA error {code}")
        return (*grads, du.sum(0), ds0)

    def inputs(seed, B, T, with_state, kind):
        args = cs.rwkv_inputs(torch, seed, B, 32, T, 64, with_state, True,
                              kind)
        dout = cs.randn(torch, seed + 6, (B, T, 32, 64),
                        args[0].dtype).transpose(1, 2)
        ds = (cs.randn(torch, seed + 7, (B, 32, 64, 64), torch.float32, 0.5)
              if with_state else None)
        _, _, ck = krw.rwkv_scan(*args, checkpoints=True)
        return args, dout, ds, ck

    def bits(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else cs.bits(torch, x))

    first = libs["first design"]
    same = [n for n in K6BWD_SAME_BITS if n in libs and n != "first design"]
    for B, T in ((cs.TRAIN_B, cs.TRAIN_S), (1, cs.RWKV_CONTEXT)):
        # Each design fed the checkpoints of one forward call; the same
        # bits as the first design in all six outputs.
        for kind in cs.K6_KINDS:
            for with_state in (False, True):
                args, dout, ds, ck = inputs(600 + T + B, B, T, with_state,
                                            kind)
                want = call(first, *args, dout, ds, ck)
                for name in same:
                    got = call(libs[name], *args, dout, ds, ck)
                    cs.check(all(torch.equal(bits(a), bits(b))
                                 for a, b in zip(got, want)),
                             f"{name}: other bits than the first design at "
                             f"B={B} T={T} {kind} state0/dstate_T="
                             f"{with_state}")
                del args, dout, ds, ck, want
        print(f"B={B} H=32 T={T} hd=64: {', '.join(same)} the same bits as "
              f"the first design in dr, dk, dv, dw, du and dstate0 (three "
              f"type kinds, without and with state0 and dstate_T)",
              flush=True)
        # The step split: the model's types (bf16 r, k, v and dout as
        # views, float32 w), no state0 or dstate_T, as the training path.
        args, dout, ds, ck = inputs(650 + T, B, T, False, cs.K6_KINDS[1])
        bound, by = cs.k6_bwd_bound(B, 32, T, 64, 2, 4)
        reps = 20 if T <= 512 else 5
        for turn, names in enumerate((list(libs), list(libs)[::-1])):
            for name in names:
                lib = libs[name]
                ms = cs.time_ms(torch, lambda *a: call(lib, *a),
                                (*args, dout, ds, ck), reps)
                print(f"{name}: K6 backward B={B} H=32 T={T} hd=64 bf16 r, "
                      f"k, v, dout turn {turn}: {ms:.5f} ms a call, "
                      f"{ms / T * 1e3:.4f} us a step (CUDA events, {reps} "
                      f"calls; bound {bound:.5f} ms by {by}, "
                      f"{100 * bound / ms:.1f}%)", flush=True)
        del args, dout, ds, ck
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


#: Edits of K5's backward (its first design at MLA's widths, and the
#: source as it is) that stop a wgmma-route call after its first launch or
#: its first two: the split of a call's time (prep, dkv, dq) by CUDA
#: events, beside the profiler's time of each kernel.
K5BWD_PREP_ONLY = {
    "      o, dout, lse, dhi, dlo, lse_p, d_p, S, Sp, rows);\n":
    "      o, dout, lse, dhi, dlo, lse_p, d_p, S, Sp, rows);\n"
    "  return cudaGetLastError();\n"}
K5BWD_SPLIT_FIRST = {
    "whole": {},
    "prep only": K5BWD_PREP_ONLY,
    "prep and dkv": {
        "              KV, scale, causal);\n  err = cudaGetLastError();\n"
        "  if (err != cudaSuccess) return err;\n  kdq<<<":
        "              KV, scale, causal);\n  return cudaGetLastError();\n"
        "  kdq<<<"},
}
K5BWD_SPLIT = {
    "whole": {},
    "prep only": K5BWD_PREP_ONLY,
    "prep and dkv": {
        "  if (err != cudaSuccess) return err;\n  return launch_early(kdq":
        "  return err;\n  return launch_early(kdq"},
}
#: Edits of K5's source that try or undo one lever of a backward's
#: redesign.
K5BWD_NOW = {
    # (96, 64): no producer warpgroup, no setmaxnreg (ptxas caps a thread
    # of either block at 168 registers).
    "as is, dkv at 288 threads, whole": {
        "static constexpr bool kKVRegs = kRegs || (kOwnKeys && DK == 96);":
        "static constexpr bool kKVRegs = kRegs;"},
    # (192, 128): dkv a block an item, not persistent.
    "as is, dkv a block an item, whole": {
        "static constexpr bool kPersist = DK == 192;":
        "static constexpr bool kPersist = false;"},
    # Every width: dkv and dq launched to start only when the kernel ahead
    # of each has finished.
    "as is, launched in order, whole": {
        "  attr[0].val.programmaticStreamSerializationAllowed = 1;":
        "  attr[0].val.programmaticStreamSerializationAllowed = 0;"},
    # (192, 128): dq's S and dP in one commit, P in registers.
    "as is, dq with P in registers, whole": {
        "static constexpr bool kPSmem = NQ > 128;":
        "static constexpr bool kPSmem = false;"},
}
#: Edits of K5's source that undo one lever of the (64, 64) backward's
#: redesign: dkv at 384 threads under setmaxnreg (not 288), its two
#: warpgroups split by product (PR 31's form), lse and D read from L2 (not
#: staged in shared memory); dq on two consumer warpgroups (128 queries a
#: block) instead of three, or two where that leaves fewer waves; P by expf
#: (PR 31's arithmetic and bits) instead of ex2.
K5BWD_WHISPER = {
    "as is, dkv at 384 threads, whole": {
        "static constexpr bool kKVRegs = kRegs || (kOwnKeys && DK == 96);":
        "static constexpr bool kKVRegs = kRegs || kOwnKeys;"},
    "as is, dkv split by product, whole": {
        "static constexpr bool kOwnKeys = DV == 64 && (DK == 96 || DK == 64);":
        "static constexpr bool kOwnKeys = DK == 96 && DV == 64;"},
    "as is, dkv reading lse and D from L2, whole": {
        "static constexpr bool kStageLD = DK == 64 && DV == 64;":
        "static constexpr bool kStageLD = false;"},
    "as is, dq on two warpgroups, whole": {
        "static constexpr int kQWGs = DK == 64 && DV == 64 ? 3 : 2;":
        "static constexpr int kQWGs = 2;"},
    "as is, P by expf (PR 31's bits), whole": {
        "static constexpr bool kEx2 = DK == 64 && DV == 64;":
        "static constexpr bool kEx2 = false;"},
}
#: The wgmma backward's kernels, by the name the profiler gives them.
K5BWD_KERNELS = ("flash_bwd_prep", "flash_bwd_dkv_wgmma",
                 "flash_bwd_dq_wgmma")


def kernel_ms(torch, fn, args, reps: int, names):
    """The card's own time a call of each kernel in ``names`` (profiler
    spans whose name holds it, summed over ``reps`` calls, over reps)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    spans = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            for name in names:
                if name in e.name:
                    spans[name] += e.time_range.end - e.time_range.start
    return {n: t / reps / 1e3 for n, t in spans.items()}


def k5bwd(torch, cs, _build) -> None:
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as kfa
    lib = kfa._library()

    def call(route, q, k, v, out, dout, lse):
        """K5's backward on ``route`` (the fma pair may be forced at bf16
        hd 128), as ``flash_attention_bwd`` calls it."""
        return k5_bwd(torch, cs, _build, lib, route, q, k, v, out, dout, lse)

    for B, S in ((cs.TRAIN_B, cs.TRAIN_S), (1, 4096)):
        q, k, v = (cs.randn(torch, 80 + i, (B, S, 16, 128),
                            torch.bfloat16).transpose(1, 2)
                   for i in range(3))
        out, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
        dout = cs.randn(torch, 89, (B, 16, S, 128), torch.float32)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        sdpa_ms = cs.time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), dout.to(sdpa.dtype), retain_graph=True), (),
            10)
        for turn, names in enumerate((["fma", "wgmma"], ["wgmma", "fma"])):
            for route in names:
                err = cs.check_flash_bwd(
                    torch, route, call(route, q, k, v, out, dout, lse), q, k,
                    v, out, dout, True, 128 ** -0.5, route)
                ms = cs.time_ms(torch, lambda *a: call(route, *a),
                                (q, k, v, out, dout, lse), 10)
                bound, by = cs.k5_bwd_bound(B, 16, 16, S, S, 128, True, 2,
                                            route)
                print(f"{route}: K5 backward B={B} H=16 S={S} hd=128 bf16 "
                      f"causal turn {turn}: {ms:.5f} ms (bound {bound:.5f} "
                      f"ms by {by}, {100 * bound / ms:.1f}%; SDPA's "
                      f"backward {sdpa_ms:.5f} ms; max |err| {err:.3g})",
                      flush=True)
        del q, k, v, out, lse, dout, qg, kg, vg, sdpa
        torch.cuda.empty_cache()

    # MLA's widths: the first design against the source as it is, each
    # whole and stopped after its first launch or two.
    designs = {}
    for label, source, split in (("first MLA design",
                                  "variants/flash_attention_mla_first",
                                  K5BWD_SPLIT_FIRST),
                                 ("as is", "flash_attention", K5BWD_SPLIT)):
        table = {f"{label}, {n}": e for n, e in split.items()}
        if source == "flash_attention":
            table.update(K5BWD_NOW)
        designs.update({n: k5_lib(lib, source == "flash_attention")
                        for n, lib in build(_build, source, table,
                                            "wgmma").items()})
    first, now = designs["first MLA design, whole"], designs["as is, whole"]
    for dk, dv in ((96, 64), (192, 128), (128, 128)):
        for what, q, k, v, causal in mla_bit_cases(torch, cs, dk, dv):
            out, lse = kfa.flash_attention(q, k, v, causal=causal,
                                           scale=dk ** -0.5, return_lse=True)
            dout = cs.randn(torch, 9, out.shape, torch.float32)
            got, want = (k5_bwd(torch, cs, _build, lib, "wgmma", q, k, v,
                                out, dout, lse, causal) for lib in (now, first))
            again = k5_bwd(torch, cs, _build, now, "wgmma", q, k, v, out,
                           dout, lse, causal)
            err = cs.check_flash_bwd(torch, what, got, q, k, v, out, dout,
                                     causal, dk ** -0.5, "wgmma")
            print(f"K5 backward {what}: dq, dk, dv "
                  f"{'the same bits as' if same_bits(torch, got, want) else 'OTHER bits than'}"
                  f" the first MLA design; two calls "
                  f"{'the same bits' if same_bits(torch, got, again) else 'OTHER bits'}"
                  f"; max |err| {err:.3g} (within check_flash_bwd)",
                  flush=True)
    for arch, B, S in ((arch, B, S) for arch in (
            "minicpm3-4b", "deepseek-v2-lite-16b", "olmoe-1b-7b")
            for B, S in ((cs.TRAIN_B, cs.TRAIN_S), (1, 4096))):
        cfg = get_config(arch)
        H = cfg.n_heads
        dk, dv = ((cfg.qk_nope + cfg.qk_rope, cfg.v_head) if cfg.v_head
                  else (cfg.hd, cfg.hd))
        q, k, v = (cs.randn(torch, 85 + i, (B, S, H, d),
                            torch.bfloat16).transpose(1, 2)
                   for i, d in enumerate((dk, dk, dv)))
        out, lse = kfa.flash_attention(q, k, v, causal=True, return_lse=True)
        dout = cs.randn(torch, 88, (B, H, S, dv), torch.float32)
        args = (q, k, v, out, dout, lse)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                              scale=dk ** -0.5)
        sdpa_ms = cs.time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), dout.to(sdpa.dtype), retain_graph=True), (),
            10)
        bound, by = cs.k5_bwd_bound(B, H, H, S, S, dk, True, 2, "wgmma", dv)
        want = k5_bwd(torch, cs, _build, first, "wgmma", *args)
        shape = (f"{cs.MLA_NAMES.get(arch, 'OLMoE-1B-7B')} ({dk}, {dv}) "
                 f"B={B} H={H} S={S}")
        reps = 20 if S <= 512 else 5
        for turn, names in enumerate((list(designs), list(designs)[::-1])):
            for name in names:
                lib = designs[name]

                def fn(*a):
                    return k5_bwd(torch, cs, _build, lib, "wgmma", *a)

                tail = ""
                if name.endswith("whole"):
                    got = fn(*args)
                    err = cs.check_flash_bwd(torch, name, got, q, k, v, out,
                                             dout, True, dk ** -0.5, "wgmma")
                    split = kernel_ms(torch, fn, args, reps, K5BWD_KERNELS)
                    tail = (f"; profiler: " + ", ".join(
                        f"{n} {t:.5f} ms" for n, t in split.items())
                        + f"; max |err| {err:.3g}; "
                        + ("the same bits as" if same_bits(torch, got, want)
                           else "OTHER bits than") + " the first MLA design")
                ms = cs.time_ms(torch, fn, args, reps)
                print(f"{name}: K5 backward {shape} causal turn {turn}: "
                      f"{ms:.5f} ms a call (CUDA events, {reps} calls; bound "
                      f"{bound:.5f} ms by {by}, {100 * bound / ms:.1f}%; "
                      f"SDPA's backward {sdpa_ms:.5f} ms){tail}", flush=True)
        del q, k, v, out, lse, dout, qg, kg, vg, sdpa, args, want
        torch.cuda.empty_cache()
    k5bwd_whisper(torch, cs, _build)


def k5bwd_whisper(torch, cs, _build) -> None:
    """K5's backward at Whisper's (64, 64): the first design there (PR
    31's source) against the source as it is, each whole and stopped after
    its prep pass or after dkv (``K5BWD_SPLIT``), and the source with one
    lever of its redesign undone (``K5BWD_WHISPER``).  dq, dk, dv at every
    other wgmma width compared bit for bit with the first design at
    ``mla_bit_cases`` and held to ``check_flash_bwd`` (two calls the same
    bits); then each timed in turns at ``whisper_shapes`` beside SDPA's
    backward and ``k5_bwd_bound``, the whole calls with the profiler's time
    of each of the three kernels."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as kfa
    designs = {}
    for label, source in (("first Whisper design",
                           "variants/flash_attention_whisper_first"),
                          ("as is", "flash_attention")):
        table = {f"{label}, {n}": e for n, e in K5BWD_SPLIT.items()}
        if source == "flash_attention":
            table.update(K5BWD_WHISPER)
        designs.update({n: k5_lib(lib, source == "flash_attention")
                        for n, lib in build(_build, source, table,
                                            WHISPER_ONLY).items()})
    first = designs["first Whisper design, whole"]
    now = designs["as is, whole"]
    for dk, dv in ((128, 128), (96, 64), (192, 128), (64, 64)):
        for what, q, k, v, causal in mla_bit_cases(torch, cs, dk, dv):
            out, lse = kfa.flash_attention(q, k, v, causal=causal,
                                           scale=dk ** -0.5, return_lse=True)
            dout = cs.randn(torch, 9, out.shape, torch.float32)
            got, want, again = (k5_bwd(torch, cs, _build, lib, "wgmma", q, k,
                                       v, out, dout, lse, causal)
                                for lib in (now, first, now))
            err = cs.check_flash_bwd(torch, what, got, q, k, v, out, dout,
                                     causal, dk ** -0.5, "wgmma")
            print(f"K5 backward {what}: dq, dk, dv "
                  f"{bits_word(torch, got, want)} the first Whisper design; "
                  f"two calls {bits_word(torch, got, again)} each other; max "
                  f"|err| {err:.3g} (within check_flash_bwd)", flush=True)
    for name, S, T, causal in whisper_shapes(cs, False):
        B, H = cs.SERVE_BATCH, 16
        q, k, v = whisper_qkv(torch, cs, 960, B, H, S, T)
        out, lse = kfa.flash_attention(q, k, v, causal=causal,
                                       return_lse=True)
        dout = cs.randn(torch, 963, (B, H, S, 64), torch.float32)
        args = (q, k, v, out, dout, lse)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        sdpa_ms = cs.time_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), dout.to(sdpa.dtype), retain_graph=True), (),
            20)
        bound, by = cs.k5_bwd_bound(B, H, H, S, T, 64, causal, 2, "wgmma")
        want = k5_bwd(torch, cs, _build, first, "wgmma", *args, causal)
        shape = f"(64, 64) {name} B={B} H={H} S={S} T={T} causal={causal}"
        for turn, names in enumerate((list(designs), list(designs)[::-1])):
            for n in names:
                lib = designs[n]

                def fn(*a):
                    return k5_bwd(torch, cs, _build, lib, "wgmma", *a, causal)

                tail = ""
                if n.endswith("whole"):
                    got, again = fn(*args), fn(*args)
                    err = cs.check_flash_bwd(torch, n, got, q, k, v, out,
                                             dout, causal, 64 ** -0.5,
                                             "wgmma")
                    split = kernel_ms(torch, fn, args, 20, K5BWD_KERNELS)
                    tail = ("; profiler: " + ", ".join(
                        f"{k_} {t:.5f} ms" for k_, t in split.items())
                        + f"; max |err| {err:.3g}; "
                        + bits_word(torch, got, want)
                        + " the first Whisper design; two calls "
                        + bits_word(torch, got, again) + " each other")
                ms = cs.time_ms(torch, fn, args, 20)
                print(f"{n}: K5 backward {shape} turn {turn}: {ms:.5f} ms a "
                      f"call (CUDA events, 20 calls; bound {bound:.5f} ms by "
                      f"{by}, {100 * bound / ms:.1f}%; SDPA's backward "
                      f"{sdpa_ms:.5f} ms){tail}", flush=True)
        del q, k, v, out, lse, dout, qg, kg, vg, sdpa, args, want
        torch.cuda.empty_cache()


def k4bwd(torch, cs, _build) -> None:
    from repro_torch.kernels import segment_matmul as kseg
    forms = {
        "copies and K4 (first design)": lambda *a: tuple(
            out for out, _ in kseg._copies_bwd(*a)),
        "dx and dw forms": kseg.segment_matmul_backward}
    for E, C, D, F in ((72, 320, 2048, 1024), (72, 320, 1024, 2048)):
        x = cs.randn(torch, 1, (E, C, D), torch.bfloat16, 0.5)
        w = cs.randn(torch, 2, (E, D, F), torch.bfloat16, D ** -0.5)
        dout = cs.randn(torch, 3, (E, C, F), torch.bfloat16)
        rows = cs.k4_rows_cases(torch, E, C, 4)[3][1]
        dead = (torch.arange(C, device="cuda")[None, :]
                >= rows.long()[:, None])
        x = x.masked_fill(dead[..., None], float("nan"))
        lib_ms = cs.time_ms(torch, lambda d, x, w: (
            torch.bmm(d, w.transpose(1, 2)), torch.bmm(x.transpose(1, 2), d)),
            (dout, x, w), 10)
        bound, by = cs.k4_bwd_bound(E, C, D, F, 2, rows.tolist())
        for turn, names in enumerate((list(forms), list(forms)[::-1])):
            for name in names:
                fn = forms[name]
                err = cs.check_seg_bwd(torch, kseg, name,
                                       fn(dout, x, w, rows), dout, x, w,
                                       rows)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                fn(dout, x, w, rows)
                torch.cuda.synchronize()
                extra = (torch.cuda.max_memory_allocated() - base) / 2**20
                ms = cs.time_ms(torch, fn, (dout, x, w, rows), 10)
                print(f"{name}: K4 backward E={E} C={C} D={D} F={F} bf16 "
                      f"(rows sum {int(rows.sum())} of {E * C}) turn {turn}: "
                      f"{ms:.5f} ms a call (bound {bound:.5f} ms by {by}, "
                      f"{100 * bound / ms:.1f}%; torch.bmm for dx and dw "
                      f"{lib_ms:.5f} ms; {extra:.1f} MiB allocated at its "
                      f"peak; max |err| {err:.3g})", flush=True)
        del x, w, dout
        torch.cuda.empty_cache()


#: Every table of edits above and the source under ``csrc/`` whose text
#: it edits (``tests/test_torch_kernel_variants.py`` applies each to the
#: sources as they are, so a table cannot go stale unseen).
TABLES = (("segment_matmul", K4_VARIANTS),
          ("flash_attention", K5_VARIANTS),
          ("variants/flash_attention_mla_first", K5_MLA_FIRST),
          ("flash_attention", K5_MLA_NOW),
          ("partition", K1K2_VARIANTS),
          ("rwkv_scan", K6_VARIANTS),
          ("variants/rwkv_scan_bwd_first", K6BWD_FIRST_SPLIT),
          ("rwkv_scan", K6BWD_SPLIT),
          ("flash_attention", K5BWD_SPLIT),
          ("flash_attention", K5BWD_NOW),
          ("variants/flash_attention_mla_first", K5BWD_SPLIT_FIRST),
          ("variants/flash_attention_whisper_first", K5_WHISPER_FIRST),
          ("flash_attention", K5_WHISPER_NOW),
          ("variants/flash_attention_whisper_first", K5BWD_SPLIT),
          ("flash_attention", K5BWD_WHISPER),
          ("variants/flash_attention_window_first", K5_WINDOW_FIRST),
          ("variants/flash_attention_window_pr33", K5_WINDOW_PR33),
          ("variants/flash_attention_window_pr33", K5_WINDOW_PR33_SPLIT),
          ("flash_attention", K5_WINDOW_NOW),
          ("variants/mamba_scan_first", K7_VARIANTS),
          ("variants/mamba_scan_first", K7_FIRST_SPLIT),
          ("mamba_scan", K7_NOW),
          ("mamba_scan", K7_NOW_SPLIT))


def main() -> int:
    import torch

    if sys.argv[1:] not in (["k4"], ["k5"], ["k1k2"], ["k6"], ["ctrl"],
                            ["k5bwd"], ["k4bwd"], ["k6bwd"], ["k7"],
                            ["k5", "whisper"], ["k5bwd", "whisper"],
                            ["k5", "window"]):
        print("usage: python3 kernel_variants.py "
              "k4|k5|k1k2|k6|k7|ctrl|k5bwd|k4bwd|k6bwd, k5|k5bwd whisper, "
              "or k5 window", file=sys.stderr)
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
    {"k4": k4, "k5": k5, "k1k2": k1k2, "k6": k6, "ctrl": ctrl,
     "k5bwd": k5bwd, "k4bwd": k4bwd, "k6bwd": k6bwd, "k7": k7,
     "k5 whisper": k5_whisper, "k5bwd whisper": k5bwd_whisper,
     "k5 window": k5_window}[
         " ".join(sys.argv[1:])](torch, cs, _build)
    return 0


if __name__ == "__main__":
    sys.exit(main())
