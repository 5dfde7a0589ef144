"""Flash attention K5: wrapper over the hand-written CUDA kernels.

Counterpart of the Pallas kernel ``repro.kernels.flash_attention``
(``flash_attention.py:72``) and of the prefill attention of
``repro.models.attention`` (``flash_attention_ref``, called at
``attention.py:174`` and ``:180``).  The JAX layout is kept: q
``[B, H, S, hd]``, k and v ``[B, KV, T, hd]`` with ``H`` a multiple of
``KV``; query head ``h`` reads KV head ``h // (H // KV)``, so the KV heads
are never repeated in memory.  Each may be a view whose last dimension has
stride 1, such as the model's ``[B, S, H, hd]`` seen through
``.transpose(1, 2)``: the kernels read it in place.  The output is float32
``[B, H, S, hd]``; the model casts it, as the JAX model does.

Causal attention needs ``S == T`` (query ``i`` sees keys ``j <= i``): the
JAX package's two forms align a causal mask with ``S != T`` differently
(``repro.kernels.ref`` bottom-right, the Pallas kernel top-left), and the
model only ever calls it with ``S == T``, so the wrapper refuses it.

For CUDA tensors the wrapper launches a kernel of
``csrc/flash_attention.cu`` (built at first use) on the current stream, or
raises; for CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.ref` on contiguous copies, so a view and its copy
give the same bits.  ``.launches`` counts the calls that launched a kernel
and the module's ``routes`` which one: ``wgmma`` (bf16 at hd 128, the
model's prefill: Q K^T and a split-bf16 P V on the tensor cores, K and V
on a TMA ring; its strides must be multiples of 8 elements) and ``fma``
(float32, and bf16 at the other head widths: float32 on the CUDA cores).

Bound on an H100, per visible (query, key) pair: ``wgmma`` ``2 hd``
operations for ``Q K^T`` and ``4 hd`` for ``P V`` (P split into bf16 hi
and lo, two products) at the bf16 tensor-core rate; ``fma`` ``2 hd`` for
``Q K^T`` (at the bf16 tensor-core rate for bf16 inputs, whose products
are exact in float32, else the float32 rate) and ``2 hd`` for ``P V`` at
the float32 rate; or q, k, v and the output moved once against the
memory rate.  The source note in the ``.cu`` file has the design.

The backward, :func:`flash_attention_bwd`: dq, dk and dv from q, k, v, the
forward's output and the gradient at it, by two CUDA-core kernels of the
same source (``flash_bwd_dq``, then ``flash_bwd_dkv``; no atomics, so
recomputing a step gives the same bits), counted on its own ``.launches``
(two a call, one a kernel); for CPU tensors its plain version.
:func:`flash_attention_ad` is K5 as a ``torch.autograd.Function`` whose
backward that is (the model's call).  The kernels do 16 hd float32
operations per visible (query, key) pair on the CUDA cores (the source note
counts them).  Bound of the backward: the least work, 10 hd a pair (the
scores' 2 hd at the bf16 tensor-core rate for bf16 inputs, else the float32
rate, and 8 hd at the float32 rate), or q, k, v, out and dout read and dq,
dk, dv written once against the memory rate, whichever is longer.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: Head widths the kernels are compiled for.
HEAD_DIMS = (16, 32, 64, 128)
ROUTES = ("fma", "wgmma")
#: Launches by kernel, in the order of ``ROUTES`` (the C side's codes).
routes = dict.fromkeys(ROUTES, 0)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_flash_attention.argtypes = (
            [ptr] * 4 + [i32] * 6 + [ctypes.c_float] + [i32] * 2
            + [ctypes.POINTER(ctypes.c_longlong), i32, ptr,
               ctypes.POINTER(i32)])
        lib.repro_flash_attention.restype = i32
        lib.repro_flash_attention_bwd.argtypes = (
            [ptr] * 9 + [i32] * 6 + [ctypes.c_float] + [i32] * 2
            + [ctypes.POINTER(ctypes.c_longlong), i32, ptr])
        lib.repro_flash_attention_bwd.restype = i32
        _lib = lib
    return _lib


def _strides(t: torch.Tensor):
    """t's element strides over (batch, head, row); a dimension of size 1
    is never stepped over, so it takes a row's width (valid for TMA)."""
    return [t.stride(d) if t.shape[d] > 1 else t.shape[-1] for d in range(3)]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool):
    """Raise on what the kernels do not take; (B, H, S, hd, KV, T)."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be bfloat16 or all float32, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"need q [B, H, S, hd] and k, v [B, KV, T, hd], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KV < 1 or H % KV:
        raise ValueError(f"k, v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H must be a multiple of KV)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} not in {HEAD_DIMS}")
    if causal and S != T:
        raise ValueError(f"causal attention needs S == T, got S={S} T={T}")
    if not (q.device == k.device == v.device) or q.device.type not in (
            "cpu", "cuda"):
        raise ValueError("q, k and v must share one cpu or cuda device")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v must have hd innermost (stride 1)")
    return B, H, S, hd, KV, T


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention, float32 ``[B, H, S, hd]``; ``scale`` multiplies
    the float32 scores (default ``hd ** -0.5``)."""
    B, H, S, hd, KV, T = _check(q, k, v, causal)
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention(q.contiguous(), k.contiguous(),
                                   v.contiguous(), causal=causal, scale=scale)
    out = torch.empty((B, H, S, hd), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out
    if T == 0:
        return out.zero_()
    strides = _strides(q) + _strides(k) + _strides(v)
    if q.dtype == torch.bfloat16 and hd == 128:
        if any(s % 8 for s in strides) or any(t.data_ptr() % 16
                                              for t in (q, k, v)):
            raise ValueError("bf16 q, k and v at hd 128 need strides that "
                             "are multiples of 8 elements and 16-byte "
                             "aligned data (the kernel reads them by TMA)")
        if S > 65535 * 128:
            raise ValueError(f"S = {S} is past the kernel's grid")
    elif B * H > 65535:
        raise ValueError(f"B * H = {B * H} is past the kernel's grid")
    lib = _library()
    route = ctypes.c_int(-1)
    code = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, KV,
        S, T, hd, scale, int(causal), _DTYPES[q.dtype],
        (ctypes.c_longlong * 9)(*strides),
        *_build.device_and_stream(q.device), ctypes.byref(route))
    _build.raise_on(lib, code, "flash_attention")
    flash_attention.launches += 1
    routes[ROUTES[route.value]] += 1
    return out


flash_attention.launches = 0


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True, scale: Optional[float] = None):
    """(dq, dk, dv) of ``out = flash_attention(q, k, v, causal=causal,
    scale=scale)`` at ``dout``: q, k and v as the forward takes them (views
    too), ``out`` its float32 ``[B, H, S, hd]`` and ``dout`` the gradient
    at it (made float32 and contiguous here).  dq ``[B, H, S, hd]`` in q's
    dtype, dk and dv ``[B, KV, T, hd]`` in k's, contiguous; float32 sums,
    dk and dv over the query heads of each KV head."""
    B, H, S, hd, KV, T = _check(q, k, v, causal)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {list(q.shape)}, got "
                         f"{list(out.shape)} and {list(dout.shape)}")
    if out.device != q.device or dout.device != q.device:
        raise ValueError(f"out and dout must lie on {q.device}")
    scale = float(scale) if scale is not None else hd ** -0.5
    if q.device.type == "cpu":
        return ref.flash_attention_bwd(
            q.contiguous(), k.contiguous(), v.contiguous(), out, dout,
            causal=causal, scale=scale)
    out = out.float().contiguous()
    dout = dout.float().contiguous()
    dq = torch.empty((B, H, S, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, KV, T, hd), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, KV, T, hd), dtype=v.dtype, device=q.device)
    if dq.numel() == 0 or T == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if B * H > 65535 or B * H * S > 1 << 30:
        raise ValueError(f"B * H = {B * H}, S = {S} are past the backward's "
                         f"grid")
    ws = torch.empty(2 * B * H * S, dtype=torch.float32, device=q.device)
    lib = _library()
    code = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        ws.data_ptr(), B, H, KV, S, T, hd, scale, int(causal),
        _DTYPES[q.dtype],
        (ctypes.c_longlong * 9)(*(_strides(q) + _strides(k) + _strides(v))),
        *_build.device_and_stream(q.device))
    _build.raise_on(lib, code, "flash_attention_bwd")
    flash_attention_bwd.launches += 2    # flash_bwd_dq, flash_bwd_dkv
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """K5 with :func:`flash_attention_bwd` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out = flash_attention(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_ad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool = True,
                       scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention` as an autograd function (the model's call),
    differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, scale)
