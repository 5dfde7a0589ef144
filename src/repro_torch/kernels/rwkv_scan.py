"""RWKV6 recurrence K6: wrapper over the hand-written CUDA kernel.

Counterpart of the Pallas kernel ``repro.kernels.rwkv_scan``
(``rwkv_scan.py:40``) and of the ``lax.scan`` of
``repro.models.ssm.rwkv6_apply`` (``ssm.py:99-110``).  The JAX layout is
kept: r, k, v and w ``[B, H, T, hd]``, the bonus u ``[H, hd]``, the state
``[B, H, hd, hd]``.  Per (b, h), in float32:

    out_t = r_t (S + diag(u) k_t v_t^T)
    S     = diag(w_t) S + k_t v_t^T

Everything is float32, as the model casts r, k and v (``ssm.py:95-97``).
r, k, v and w may be strided views (hd's stride 1, the four alike): the
model passes views of its ``[B, T, H * hd]`` activations and gets ``out``
back in r's layout, so no copy goes in or out.  It returns the final state,
so two chained halves equal one scan.

For CUDA tensors the wrapper launches the kernel of ``csrc/rwkv_scan.cu``
(built at first use) on the current stream, or raises; for CPU tensors it
runs the plain version in :mod:`repro_torch.kernels.ref`.  ``.launches``
counts the calls that launched the kernel.

Bound on an H100: about ``4 hd^2`` float32 operations per (b, h, t) at the
CUDA-core rate (``r_t S`` and the decayed update; the bonus is a dot
product, O(hd)), or r, k, v, w and out moved once and the two states,
against the memory rate, whichever is longer: the bytes, at the serve's
shapes.  Design: one block per
(b, h) with the state in registers for the whole T loop, inputs staged in
shared memory 16 steps at a time, two buffers; the source note in the
``.cu`` file has the details.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref

#: The largest head size the kernel takes (its state lives in registers).
MAX_HEAD_DIM = 64

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("rwkv_scan")
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_rwkv_scan.argtypes = ([ptr] * 8 + [i32] * 4 + [i64] * 6
                                        + [i32, ptr])
        lib.repro_rwkv_scan.restype = i32
        _lib = lib
    return _lib


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out ``[B, H, T, hd]``, on the card in r's layout, and the final
    state ``[B, H, hd, hd]``), all float32.  r, k, v and w of one shape and
    one layout with hd's stride 1; u and state0 (zeros when None)
    contiguous; everything on one device; hd <= 64."""
    tensors = [r, k, v, w, u] + ([] if state0 is None else [state0])
    if any(x.dtype != torch.float32 for x in tensors):
        raise TypeError(f"r, k, v, w, u and state0 must be float32, got "
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
    # The strides of dims longer than 1 (the kernel reads r's for all four).
    live = [d for d in range(4) if r.shape[d] > 1]
    if r.numel() and ((hd > 1 and r.stride(3) != 1) or any(
            x.stride(d) != r.stride(d) for x in (k, v, w) for d in live)):
        raise ValueError(f"r, k, v and w must share one layout with hd's "
                         f"stride 1, got strides "
                         f"{[x.stride() for x in (r, k, v, w)]}")
    if not all(x.is_contiguous() for x in tensors[4:]):
        raise ValueError("u and state0 must be contiguous")
    if r.device.type == "cpu":
        return ref.rwkv_scan(r, k, v, w, u, state0)
    out = torch.empty_like(r)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    if state.numel() == 0:
        return out, state
    lib = _library()
    code = lib.repro_rwkv_scan(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state0 is None else state0.data_ptr(), out.data_ptr(),
        state.data_ptr(), B, H, T, hd, *r.stride()[:3], *out.stride()[:3],
        *_build.device_and_stream(r.device))
    _build.raise_on(lib, code, "rwkv_scan")
    rwkv_scan.launches += 1
    return out, state


rwkv_scan.launches = 0
