"""Flash attention K5: wrapper over the hand-written CUDA kernels.

Counterpart of the Pallas kernel ``repro.kernels.flash_attention``
(``flash_attention.py:72``) and of the prefill attention of
``repro.models.attention`` (``flash_attention_ref``, called at
``attention.py:174``, ``:180`` and in MLA's expanded path, ``:296``).  The
JAX layout is kept: q ``[B, H, S, dk]``, k ``[B, KV, T, dk]`` and v
``[B, KV, T, dv]`` with ``H`` a multiple of ``KV``; query head ``h`` reads
KV head ``h // (H // KV)``, so the KV heads are never repeated in memory.
``(dk, dv)`` is one of ``WIDTHS``: equal widths of 16, 32, 64 or 128, or
MLA's pairs (``MLA_WIDTHS``: q and k ``qk_nope + qk_rope`` wide, v
``v_head``).  Each may be a view whose last dimension has stride 1, such
as the model's ``[B, S, H, d]`` seen through ``.transpose(1, 2)``: the
kernels read it in place.  The output is float32 ``[B, H, S, dv]``; the
model casts it, as the JAX model does.

Causal attention needs ``S == T`` (query ``i`` sees keys ``j <= i``): the
JAX package's two forms align a causal mask with ``S != T`` differently
(``repro.kernels.ref`` bottom-right, the Pallas kernel top-left), and the
model only ever calls it with ``S == T``, so the wrapper refuses it.  Full
attention takes any S and T: Whisper's cross attention runs 1 to 512
queries against the encoder's 1,500 keys.  A causal call may take a
sliding ``window`` (the hybrid family's windowed layers: query ``i`` also
stops seeing keys ``j <= i - window``, the mask of
``repro.models.attention``, ``attention.py:95-96``), on the ``fma`` route
and on ``wgmma`` at (64, 64), Hymba-1.5B's width; the kernels skip the
tiles wholly outside every row's window, so a window costs about ``S
window`` pairs, not ``S^2 / 2``.  A window at the other ``wgmma`` widths,
or without ``causal``, raises ``ValueError``.

For CUDA tensors the wrapper launches a kernel of
``csrc/flash_attention.cu`` (built at first use) on the current stream, or
raises; for CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.ref` on contiguous copies, so a view and its copy
give the same bits.  ``.launches`` counts the calls that launched a kernel
and the module's ``routes`` which one: ``wgmma`` (bf16 at a pair of
``WGMMA_WIDTHS``: (128, 128), (64, 64), MiniCPM3's (96, 64) and
DeepSeek-V2's (192, 128), the models' prefills and training forwards and
Whisper's encoder, causal and cross attention: Q K^T and a
split-bf16 P V on the tensor cores, K and V on a TMA ring, at MLA's
widths the two consumer warpgroups taking turns on the tensor cores, at
(64, 64) three consumer warpgroups on 64-key tiles, each with Q K^T of
the next tile and P V of the last in flight beside its softmax, the
scale folded into the exponent (other bits than the other widths' form,
within the same bound); its strides must be multiples of 8 elements) and
``fma`` (float32, and bf16 at the other widths: float32 on the CUDA
cores).

Bound on an H100, per visible (query, key) pair: ``wgmma`` ``2 dk``
operations for ``Q K^T`` and ``4 dv`` for ``P V`` (P split into bf16 hi
and lo, two products) at the bf16 tensor-core rate; ``fma`` ``2 dk`` for
``Q K^T`` (at the bf16 tensor-core rate for bf16 inputs, whose products
are exact in float32, else the float32 rate) and ``2 dv`` for ``P V`` at
the float32 rate; or q, k, v and the output moved once, each at its own
width, against the memory rate.  The source note in the ``.cu`` file has
the design.

``flash_attention(..., return_lse=True)`` also returns each row's
log-sum-exp of the scaled scores, float32 ``[B, H, S]``: the ``wgmma``
kernel writes it from its final max and sum (the output's bits do not
change), the plain version computes it; the ``fma`` route returns None in
its place (its backward recomputes it).

The backward, :func:`flash_attention_bwd`: dq, dk and dv from q, k, v, the
forward's output, the gradient at it and (``wgmma``) the forward's lse, by
kernels of the same source, none with atomics (recomputing a step gives
the same bits); ``.launches`` counts its launches and the module's
``bwd_routes`` them by route (``BWD_LAUNCHES`` a call):

* ``wgmma`` (bf16 at a pair of ``WGMMA_WIDTHS``, as the forward, whose
  strides TMA can map, the models' training
  calls; at (192, 128), and in the dk / dv kernel at (96, 64), blocks of
  384 threads whose producer warpgroup gives its registers to the
  consumers; at (96, 64) dK and dQ are ``m64n96`` products; at (96, 64)
  and (64, 64) the dk / dv kernel's block owns 128 keys, each consumer
  warpgroup all five products for its 64; at (64, 64) each ring tile
  brings its rows' lse and D into shared memory, dq's block has three
  consumer warpgroups (or two where that leaves fewer waves) and P is
  2^(s scale log2 e - lse log2 e), one FFMA and one ex2 (other bits
  than the other widths' form, within the same bound)): three
  launches, a prep pass (D_i and dO split into bf16 hi + lo, once a call),
  ``flash_bwd_dkv_wgmma`` and ``flash_bwd_dq_wgmma`` (every product on the
  tensor cores, P and dS split into hi + lo in registers; the source note
  has the design).  Bound: 10 dk + 10 dv operations a visible pair at the
  bf16 tensor-core rate (S 2 dk, dP 4 dv, dV 6 dv, dK 4 dk, dQ 4 dk), or
  q, k, v, out, dout and lse read and dq, dk, dv written once;
* ``fma`` (every other call: float32, the other widths, strides TMA
  cannot map): two CUDA-core kernels
  (``flash_bwd_dq`` recomputes the row's log-sum-exp, then
  ``flash_bwd_dkv``), 10 dk + 6 dv float32 operations a pair.  Bound: the
  least work (the scores' 2 dk at the bf16 tensor-core rate for bf16
  inputs, else the float32 rate, and 4 dk + 4 dv at the float32 rate), or
  the bytes as above, whichever is longer.

For CPU tensors its plain version (which recomputes P and reads no lse).
:func:`flash_attention_ad` is K5 as a ``torch.autograd.Function`` whose
forward keeps the lse and whose backward is :func:`flash_attention_bwd`
(the model's call); with no gradient to take (the serve) it is a plain
:func:`flash_attention` call, which writes no lse.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Head widths the kernels are compiled for with q, k and v alike.
HEAD_DIMS = (16, 32, 64, 128)
#: The (dk, dv) pairs of MLA: q and k ``dk`` wide, v and the output ``dv``
#: (``qk_nope + qk_rope`` and ``v_head``): the smoke configurations'
#: (24, 16), MiniCPM3-4B's (96, 64) and DeepSeek-V2-Lite's (192, 128).
MLA_WIDTHS = ((24, 16), (96, 64), (192, 128))
#: Every (dk, dv) pair the kernels take.
WIDTHS = tuple((d, d) for d in HEAD_DIMS) + MLA_WIDTHS
#: The pairs of the ``wgmma`` kernels (bf16), forward and backward: hd 128,
#: hd 64 (Whisper) and MLA's two published pairs.
WGMMA_WIDTHS = ((128, 128), (64, 64), (96, 64), (192, 128))
#: The one wgmma pair that takes a sliding window (Hymba-1.5B's heads).
WINDOW_WGMMA = (64, 64)
ROUTES = ("fma", "wgmma")
#: Launches by kernel, in the order of ``ROUTES`` (the C side's codes).
routes = dict.fromkeys(ROUTES, 0)
#: The backward's launches a call on each route, and its launches by route.
BWD_LAUNCHES = {"fma": 2, "wgmma": 3}
bwd_routes = dict.fromkeys(ROUTES, 0)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = (
            [ptr] * 5 + [i32] * 7 + [ctypes.c_float] + [i32] * 3
            + [ctypes.POINTER(ctypes.c_longlong), i32, ptr,
               ctypes.POINTER(i32)])
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_attention_bwd.argtypes = (
            [ptr] * 10 + [i32] * 7 + [ctypes.c_float] + [i32] * 3
            + [ctypes.POINTER(ctypes.c_longlong), i32, i32, ptr])
        lib.repro_flash_attention_bwd.restype = i32
        _lib = lib
    return _lib


def _strides(t: torch.Tensor):
    """t's element strides over (batch, head, row); a dimension of size 1
    is never stepped over, so it takes a row's width (valid for TMA)."""
    return [t.stride(d) if t.shape[d] > 1 else t.shape[-1] for d in range(3)]


def _tma_ready(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Strides that are multiples of 8 elements and 16-byte-aligned data:
    what the ``wgmma`` kernels' TMA maps need."""
    strides = _strides(q) + _strides(k) + _strides(v)
    return not (any(s % 8 for s in strides)
                or any(t.data_ptr() % 16 for t in (q, k, v)))


def _window(window: Optional[int], causal: bool, q: torch.Tensor,
            v: torch.Tensor) -> int:
    """The kernels' window argument (0: none); raises on a window they do
    not take."""
    if window is None:
        return 0
    window = int(window)
    if window < 1 or not causal:
        raise ValueError(f"a sliding window needs causal attention and a "
                         f"width of at least 1, got window={window}, "
                         f"causal={causal}")
    pair = (q.shape[-1], v.shape[-1])
    if (q.device.type == "cuda" and q.dtype == torch.bfloat16
            and pair in WGMMA_WIDTHS and pair != WINDOW_WGMMA):
        raise ValueError(f"a sliding window at (dk, dv) = {pair} on the "
                         f"wgmma route: only {WINDOW_WGMMA} takes one")
    return window


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool):
    """Raise on what the kernels do not take; (B, H, S, dk, KV, T, dv)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be bfloat16 or all float32, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"need q [B, H, S, dk], k [B, KV, T, dk] and v "
                         f"[B, KV, T, dv], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV, T, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if (hd, dv) not in WIDTHS:
        raise ValueError(f"(dk, dv) = ({hd}, {dv}) is not a pair the kernels "
                         f"take: {WIDTHS}")
    if causal and S != T:
        raise ValueError(f"causal attention needs S == T, got S={S} T={T}")
    if not (q.device == k.device == v.device) or q.device.type not in (
            "cpu", "cuda"):
        raise ValueError("q, k and v must share one cpu or cuda device")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must have hd innermost (stride 1)")
    return B, H, S, hd, KV, T, dv


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    return_lse: bool = False, window: Optional[int] = None):
    """Softmax attention, float32 ``[B, H, S, dv]``; ``scale`` multiplies
    the float32 scores (default ``dk ** -0.5``); ``window``: a causal
    call's sliding window (None: none).  With ``return_lse``, ``(out,
    lse)``: lse the float32 ``[B, H, S]`` log-sum-exp of each row's scaled
    scores, or None on the ``fma`` route."""
    B, H, S, hd, KV, T, dv = _check(q, k, v, causal)
    win = _window(window, causal, q, v)
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal, scale=scale,
                                   return_lse=return_lse, window=window)
    wgmma = q.dtype == torch.bfloat16 and (hd, dv) in WGMMA_WIDTHS
    out = torch.empty((B, H, S, dv), dtype=torch.float32, device=q.device)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse and wgmma else None)
    if out.numel() == 0 or T == 0:
        out.zero_()
        if lse is not None:
            lse.fill_(ref.NEG_INF)
        return (out, lse) if return_lse else out
    strides = _strides(q) + _strides(k) + _strides(v)
    if wgmma:
        if not _tma_ready(q, k, v):
            raise ValueError(f"bf16 q, k and v at (dk, dv) = ({hd}, {dv}) "
                             "need strides that are multiples of 8 elements "
                             "and 16-byte aligned data (the kernel reads "
                             "them by TMA)")
        if S > 65535 * 128:
            raise ValueError(f"S = {S} is past the kernel's grid")
    elif B * H > 65535:
        raise ValueError(f"B * H = {B * H} is past the kernel's grid")
    lib = _library()
    route = ctypes.c_int(-1)
    code = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, H, KV, S, T, hd, dv,
        scale, int(causal), win, _DTYPES[q.dtype],
        (ctypes.c_longlong * 9)(*strides),
        *_build.device_and_stream(q.device), ctypes.byref(route))
    _build.raise_on(lib, code, "flash_attention")
    flash_attention.launches += 1
    routes[ROUTES[route.value]] += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The backward's route for CUDA tensors: ``wgmma`` for bf16 at a pair
    of ``WGMMA_WIDTHS`` whose strides TMA can map, else ``fma``."""
    return ("wgmma" if q.dtype == torch.bfloat16
            and (q.shape[-1], v.shape[-1]) in WGMMA_WIDTHS
            and _tma_ready(q, k, v) else "fma")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        lse: Optional[torch.Tensor] = None,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None):
    """(dq, dk, dv) of ``out = flash_attention(q, k, v, causal=causal,
    scale=scale, window=window)`` at ``dout``: q, k and v as the forward takes them (views
    too), ``out`` its float32 ``[B, H, S, dv]``, ``dout`` the gradient at
    it (made float32 and contiguous here) and ``lse`` the forward's
    log-sum-exp (``return_lse=True``), which the ``wgmma`` route needs and
    the others do not read.  dq ``[B, H, S, dk]`` in q's dtype, dk
    ``[B, KV, T, dk]`` and dv ``[B, KV, T, dv]`` in k's, contiguous; float32
    sums, dk and dv over the query heads of each KV head."""
    B, H, S, hd, KV, T, dv_w = _check(q, k, v, causal)
    win = _window(window, causal, q, v)
    want = (B, H, S, dv_w)
    if out.shape != want or dout.shape != want:
        raise ValueError(f"out and dout must be {list(want)}, got "
                         f"{list(out.shape)} and {list(dout.shape)}")
    if out.device != q.device or dout.device != q.device:
        raise ValueError(f"out and dout must lie on {q.device}")
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(
            q.contiguous(), k.contiguous(), v.contiguous(), out, dout,
            causal=causal, scale=scale, window=window)
    out = out.float().contiguous()
    dout = dout.float().contiguous()
    dq = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KV, T, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, KV, T, dv_w), dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if B * H > 65535 or B * H * S > 1 << 30:
        raise ValueError(f"B * H = {B * H}, S = {S} are past the backward's "
                         f"grid")
    route = bwd_route(q, k, v)
    if route == "wgmma":
        if (lse is None or lse.shape != (B, H, S) or lse.dtype != torch.float32
                or lse.device != q.device or not lse.is_contiguous()):
            raise ValueError("the wgmma backward needs the forward's lse, "
                             "float32 [B, H, S] contiguous on q's device "
                             "(flash_attention(..., return_lse=True))")
        # The prep pass reads out and dout by 16-byte vectors.
        out, dout = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (out, dout))
        sp = -(-S // 128) * 128
        ws = torch.empty(2 * B * H * sp + B * H * S * dv_w,
                         dtype=torch.float32, device=q.device)
    else:
        ws = torch.empty(2 * B * H * S, dtype=torch.float32, device=q.device)
    lib = _library()
    code = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), None if route == "fma" else lse.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), ws.data_ptr(), B, H, KV,
        S, T, hd, dv_w, scale, int(causal), win, _DTYPES[q.dtype],
        (ctypes.c_longlong * 9)(*(_strides(q) + _strides(k) + _strides(v))),
        ROUTES.index(route), *_build.device_and_stream(q.device))
    _build.raise_on(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += BWD_LAUNCHES[route]
    bwd_routes[route] += BWD_LAUNCHES[route]
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K5 with :func:`flash_attention_bwd` as its backward, the forward's
    lse saved for it (recomputed with the forward under remat)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window):
        out, lse = flash_attention(q, k, v, causal=causal, scale=scale,
                                   return_lse=True, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.window = causal, scale, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                         causal=ctx.causal, scale=ctx.scale,
                                         window=ctx.window)
        return dq, dk, dv, None, None, None


def flash_attention_ad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True, scale: Optional[float] = None,
                       window: Optional[int] = None) -> torch.Tensor:
    """:func:`flash_attention` as an autograd function (the model's call),
    differentiable in q, k and v.  With no gradient to take (grad mode
    off, or no input that requires one: the serve) it is
    :func:`flash_attention` itself, which then writes no lse."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale, window)
    return flash_attention(q, k, v, causal=causal, scale=scale,
                           window=window)
