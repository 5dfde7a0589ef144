"""Grouped (per-expert) matmul K4: wrapper over the hand-written CUDA kernel.

Counterpart of the Pallas kernel ``repro.kernels.segment_matmul``
(``segment_matmul.py:35``): ``x [E, C, D] @ w [E, D, F] -> [E, C, F]``,
accumulated in float32 and returned in ``x.dtype``.  It is the expert
compute of :func:`repro_torch.models.moe.moe_apply`.

For CUDA tensors the wrapper launches the kernel of
``csrc/segment_matmul.cu`` (built at first use, see
:mod:`repro_torch.kernels._build`) on the current stream, or raises; for
CPU tensors it runs the plain version in :mod:`repro_torch.kernels.ref`.
``.launches`` counts the calls that launched the kernel.

Bound on an H100: ``2 E C D F`` operations against the bf16 tensor-core
rate (float32: the CUDA-core rate), or the elements of x, w and out moved
once against the memory rate, whichever is longer.  The kernel is one
64 x 64 output tile of one expert a block, with a shared-memory D loop:
WMMA (``mma.sync``) for bf16, FMA for float32; ragged C, D and F are
masked, where the TPU kernel asserts that its tiles divide them.  The
source note in ``csrc/segment_matmul.cu`` has the details.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("segment_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_segment_matmul.argtypes = [ptr] * 3 + [i32] * 6 + [ptr]
        lib.repro_segment_matmul.restype = i32
        _lib = lib
    return _lib


def segment_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]``: x ``[E, C, D]``, w ``[E, D, F]``, both
    bf16 or both float32, contiguous, on one device."""
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be bfloat16 or both float32, got "
                        f"{x.dtype} and {w.dtype}")
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != x.shape[2]):
        raise ValueError(f"need x [E, C, D] and w [E, D, F], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"x and w must share one cpu or cuda device, got "
                         f"{x.device} and {w.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if x.device.type == "cpu":
        return ref.segment_matmul(x, w)
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    if D == 0:
        return out.zero_()
    if E > 65535 or C > 65535 * 64:
        raise ValueError(f"shape {tuple(x.shape)} is past the kernel's grid")
    lib = _library()
    code = lib.repro_segment_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F,
        _DTYPES[x.dtype], *_build.device_and_stream(x.device))
    _build.raise_on(lib, code, "segment_matmul")
    segment_matmul.launches += 1
    return out


segment_matmul.launches = 0
