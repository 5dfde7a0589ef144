"""RWKV6 recurrence K6: wrapper over the hand-written CUDA kernel.

Counterpart of the Pallas kernel ``repro.kernels.rwkv_scan``
(``rwkv_scan.py:40``) and of the ``lax.scan`` of
``repro.models.ssm.rwkv6_apply`` (``ssm.py:99-110``).  The JAX layout is
kept: r, k, v and w ``[B, H, T, hd]``, the bonus u ``[H, hd]``, the state
``[B, H, hd, hd]``.  Per (b, h), in float32:

    out_t = r_t (S + diag(u) k_t v_t^T)
    S     = diag(w_t) S + k_t v_t^T

The types are the Pallas kernel's: r, k and v float32 or bf16, all three
alike; w float32 or r's type; u and state0 float32.  Each value is widened
to float32 as it is read, ``out`` comes back in r's type (rounded once) and
the final state in float32.  r, k, v and w may be strided views (hd's
stride 1, the four alike): the model passes its bf16 r, k and v and its
float32 w as views of its ``[B, T, H * hd]`` activations and gets ``out``
back in r's layout and type, so no cast and no copy goes in or out.  It
returns the final state, so two chained halves equal one scan.

For CUDA tensors the wrapper launches the kernel of ``csrc/rwkv_scan.cu``
(built at first use) on the current stream, or raises; for CPU tensors it
runs the plain version in :mod:`repro_torch.kernels.ref`.  ``.launches``
counts the calls that launched the kernel.  A call makes two allocations
(``out`` and the final state) and one stream operation.

Bound on an H100: about ``4 hd^2`` float32 operations per (b, h, t) at the
CUDA-core rate (``r_t S`` and the decayed update; the bonus is a dot
product, O(hd)), or r, k, v, w and out moved once (at their own widths) and
the two states, against the memory rate, whichever is longer: the bytes, at
the serve's shapes.  Design: one block per (b, h), its state in the
registers of 256 compute threads (a 4 x 4 tile each) for the whole T loop,
the bonus as one dot product a step, and four helper warps that stage
16-step chunks into a ring of four buffers by asynchronous copies and add
the partial sums while the recurrence runs; the source note in the ``.cu``
file has the details.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref

#: The largest head size the kernel takes (its state lives in registers).
MAX_HEAD_DIM = 64

#: The kernel's type codes: (r's dtype, w's dtype) -> ``kinds``.
_KINDS = {(torch.float32, torch.float32): 0,
          (torch.bfloat16, torch.float32): 1,
          (torch.bfloat16, torch.bfloat16): 2}

_call = None


def _entry():
    """The kernel's entry point, its argument types set (once)."""
    global _call
    if _call is None:
        lib = _build.load("rwkv_scan")
        fn = lib.repro_rwkv_scan
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 8 + [i32] * 5 + [i64] * 6 + [i32, ptr]
        fn.restype = i32
        _call = (lib, fn)
    return _call


def _refuse(r, k, v, w, u, state0):
    """Raises the error that a call with these inputs deserves (the slow
    half of the checks: run only when the fast one fails)."""
    tensors = [r, k, v, w, u] + ([] if state0 is None else [state0])
    if (r.dtype not in (torch.float32, torch.bfloat16)
            or k.dtype != r.dtype or v.dtype != r.dtype
            or w.dtype not in (torch.float32, r.dtype)
            or any(x.dtype != torch.float32 for x in tensors[4:])):
        raise TypeError(f"need r, k, v float32 or bf16 alike, w float32 or "
                        f"r's type, u and state0 float32; got "
                        f"{[x.dtype for x in tensors]}")
    if r.dim() != 4 or any(x.shape != r.shape for x in (k, v, w)):
        raise ValueError(f"need r, k, v, w of one shape [B, H, T, hd], got "
                         f"{[tuple(x.shape) for x in (r, k, v, w)]}")
    B, H, T, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"u {tuple(u.shape)} is not [H, hd] = {(H, hd)}")
    if state0 is not None and tuple(state0.shape) != (B, H, hd, hd):
        raise ValueError(f"state0 {tuple(state0.shape)} is not "
                         f"[B, H, hd, hd] = {(B, H, hd, hd)}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head size {hd} is past the kernel's "
                         f"{MAX_HEAD_DIM}: its state lives in registers")
    if (any(x.device != r.device for x in tensors)
            or r.device.type not in ("cpu", "cuda")):
        raise ValueError("r, k, v, w, u and state0 must share one cpu or "
                         "cuda device")
    if not all(x.is_contiguous() for x in tensors[4:]):
        raise ValueError("u and state0 must be contiguous")
    raise ValueError(f"r, k, v and w must share one layout with hd's "
                     f"stride 1, got strides "
                     f"{[x.stride() for x in (r, k, v, w)]}")


def _same_layout(r, k, v, w) -> bool:
    """r, k, v and w share their strides on every dim longer than 1 and
    hd's is 1 (or they are empty)."""
    if r.numel() == 0:
        return True
    live = [d for d in range(4) if r.shape[d] > 1]
    return ((r.shape[3] == 1 or r.stride(3) == 1)
            and all(x.stride(d) == r.stride(d) for x in (k, v, w)
                    for d in live))


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out ``[B, H, T, hd]`` in r's type, on the card in r's layout, and
    the final state ``[B, H, hd, hd]`` float32).  r, k, v and w of one
    shape and one layout with hd's stride 1; u and state0 (zeros when None)
    contiguous; everything on one device; hd <= 64."""
    # One pass of the checks a call needs; any failure goes to _refuse,
    # which finds and names it.
    shape, stride, dev = r.shape, r.stride(), r.device
    kinds = _KINDS.get((r.dtype, w.dtype))
    ok = (kinds is not None and k.dtype is r.dtype and v.dtype is r.dtype
          and u.dtype is torch.float32 and len(shape) == 4
          and k.shape == shape and v.shape == shape and w.shape == shape)
    if ok:
        B, H, T, hd = shape
        ok = (hd <= MAX_HEAD_DIM and u.shape == (H, hd)
              and u.is_contiguous() and u.device == dev
              and k.device == dev and v.device == dev and w.device == dev
              and (state0 is None
                   or (state0.dtype is torch.float32
                       and state0.shape == (B, H, hd, hd)
                       and state0.is_contiguous() and state0.device == dev))
              and ((k.stride() == stride and v.stride() == stride
                    and w.stride() == stride
                    and (stride[3] == 1 or hd == 1))
                   or _same_layout(r, k, v, w)))
    if not ok or not r.is_cuda:
        if not ok or not r.is_cpu:
            _refuse(r, k, v, w, u, state0)
        return ref.rwkv_scan(r, k, v, w, u, state0)
    # out in r's layout where that is the model's ([B, T, H, hd] read as
    # [B, H, T, hd]), else contiguous.  Two allocations: carving out and the
    # state from one buffer costs the host more (two view ops) than a
    # second allocation from PyTorch's cache.
    out_stride = (H * T * hd, T * hd, hd, 1)
    if stride == (T * H * hd, hd, H * hd, 1):
        out_stride = stride
    out = torch.empty_strided(shape, out_stride, dtype=r.dtype, device=dev)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    if state.numel() == 0:
        return out, state
    lib, fn = _entry()
    code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
              u.data_ptr(), None if state0 is None else state0.data_ptr(),
              out.data_ptr(), state.data_ptr(), B, H, T, hd, kinds,
              *stride[:3], *out_stride[:3], *_build.device_and_stream(dev))
    if code:
        _build.raise_on(lib, code, "rwkv_scan")
    rwkv_scan.launches += 1
    return out, state


rwkv_scan.launches = 0
