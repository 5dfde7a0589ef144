"""Grouped (per-expert) matmul K4: wrapper over the hand-written CUDA kernel.

Counterpart of the Pallas kernel ``repro.kernels.segment_matmul``
(``segment_matmul.py:35``): ``x [E, C, D] @ w [E, D, F] -> [E, C, F]``,
accumulated in float32 and returned in ``x.dtype``.  It is the expert
compute of :func:`repro_torch.models.moe.moe_apply`, which passes each
expert's count of live rows as ``rows``: ``out[e, r] = x[e, r] @ w[e]`` for
``r < rows[e]`` and 0 past it, whatever x holds there.

For CUDA tensors the wrapper launches a kernel of ``csrc/segment_matmul.cu``
(built at first use, see :mod:`repro_torch.kernels._build`) on the current
stream, or raises; for CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.ref`.  ``.launches`` counts the calls that
launched a kernel and the module's ``routes`` which one: ``tiles``
(bf16, C >= 64: TMA-fed wgmma on 128 x 128 tiles), ``stream`` (bf16,
C < 64: the weights streamed once, wgmma on ``w^T x^T``), ``wmma`` (bf16
whose D or F is no multiple of 8, which TMA cannot map) and ``fma``
(float32).

Bound on an H100: ``2 E C D F`` operations against the bf16 tensor-core
rate (float32: the CUDA-core rate), or the elements of x, w and out moved
once against the memory rate, whichever is longer; with ``rows``, ``E C``
becomes ``sum(rows)`` in the operations and in the rows of x read, and
only the weights of experts with ``rows > 0`` count.  The source note in
``csrc/segment_matmul.cu`` has the design.

:func:`segment_matmul_ad` is the same product as a
``torch.autograd.Function`` (the model calls it): its backward is K4 too,
``dx = dout w^T`` with its rows past ``rows`` zero and ``dw = x^T dout``
over the live rows only (x may hold anything past them, NaN included, and
those rows take no part in ``out``), through
:func:`segment_matmul_backward`, which counts its launches on its own
``.launches`` (two a call) and ``bwd_routes``.  Where TMA can map the
tensors (bf16, D and F multiples of 8) the two launches are the tiles
kernel's transposed forms, ``dx_tiles`` and ``dw_tiles``: w, x and dout
are read in place, with no copy and no zeroing pass (the kernel zeroes
the rows past ``rows`` in shared memory).  Other calls (float32, or D or
F no multiple of 8) copy: x and dout zeroed past ``rows`` by
``torch.where``, then K4 on contiguous ``w^T`` and ``x^T``.  No
``torch.bmm`` computes an expert product on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("fma", "wmma", "tiles", "stream")
#: Launches by kernel, in the order of ``ROUTES`` (the C side's codes).
routes = dict.fromkeys(ROUTES, 0)
#: The backward's kernels: K4's, and the tiles kernel's dx and dw forms.
BWD_ROUTES = ROUTES + ("dx_tiles", "dw_tiles")
#: The backward's launches by kernel (two a call: dx, then dw).
bwd_routes = dict.fromkeys(BWD_ROUTES, 0)

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("segment_matmul")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_segment_matmul.argtypes = ([ptr] * 4 + [i32] * 6
                                             + [ptr, ctypes.POINTER(i32)])
        lib.repro_segment_matmul.restype = i32
        lib.repro_segment_matmul_bwd.argtypes = ([i32] + [ptr] * 4
                                                 + [i32] * 5 + [ptr])
        lib.repro_segment_matmul_bwd.restype = i32
        _lib = lib
    return _lib


def _check(x: torch.Tensor, w: torch.Tensor,
           rows: Optional[torch.Tensor]) -> None:
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
    if rows is not None:
        if rows.dtype != torch.int32:
            raise TypeError(f"rows must be int32, got {rows.dtype}")
        if rows.shape != x.shape[:1] or not rows.is_contiguous():
            raise ValueError(f"rows must be a contiguous [E] = "
                             f"[{x.shape[0]}], got {tuple(rows.shape)}")
        if rows.device != x.device:
            raise ValueError(f"rows must lie on {x.device}, got "
                             f"{rows.device}")


def _launch(x: torch.Tensor, w: torch.Tensor,
            rows: Optional[torch.Tensor]):
    """One K4 launch on checked CUDA tensors: (out, the route's name, or
    None where nothing was launched)."""
    E, C, D = x.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out, None
    if D == 0:
        return out.zero_(), None
    if E > 65535 or C > 65535 * 64:
        raise ValueError(f"shape {tuple(x.shape)} is past the kernel's grid")
    lib = _library()
    route = ctypes.c_int(-1)
    code = lib.repro_segment_matmul(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if rows is None else rows.data_ptr(), E, C, D, F,
        _DTYPES[x.dtype], *_build.device_and_stream(x.device),
        ctypes.byref(route))
    _build.raise_on(lib, code, "segment_matmul")
    return out, ROUTES[route.value]


def _launch_bwd(form: str, a: torch.Tensor, b: torch.Tensor,
                rows: Optional[torch.Tensor], E: int, C: int, D: int,
                F: int):
    """One launch of the tiles kernel's ``dx`` (a = dout, b = w: out
    ``[E, C, D]``) or ``dw`` (a = x, b = dout: out ``[E, D, F]``) form on
    checked bf16 CUDA tensors: (out, the route's name, or None where
    nothing was launched)."""
    shape, depth = ((E, C, D), F) if form == "dx" else ((E, D, F), C)
    out = torch.empty(shape, dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out, None
    if depth == 0:
        return out.zero_(), None
    if E > 65535 or shape[1] > 65535 * 128:
        raise ValueError(f"shape {shape} is past the kernel's grid")
    lib = _library()
    code = lib.repro_segment_matmul_bwd(
        1 if form == "dx" else 2, a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if rows is None else rows.data_ptr(), E, C, D, F,
        *_build.device_and_stream(a.device))
    _build.raise_on(lib, code, "segment_matmul_backward")
    return out, f"{form}_tiles"


def segment_matmul(x: torch.Tensor, w: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out[e] = x[e] @ w[e]``: x ``[E, C, D]``, w ``[E, D, F]``, both
    bf16 or both float32, contiguous, on one device.  ``rows``: int32
    ``[E]`` on that device (read by the kernel, never by the host), or None
    for every row."""
    _check(x, w, rows)
    if x.device.type == "cpu":
        return ref.segment_matmul(x, w, rows)
    out, route = _launch(x, w, rows)
    if route is not None:
        segment_matmul.launches += 1
        routes[route] += 1
    return out


segment_matmul.launches = 0


def _copies_bwd(dout: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                rows: Optional[torch.Tensor]):
    """The backward's two K4 launches on copies (the calls TMA cannot
    map): [(dx, route), (dw, route)]."""
    dout_live = dout
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :, None]
                < rows.to(torch.int64)[:, None, None])
        x = torch.where(live, x, x.new_zeros(()))
        dout_live = torch.where(live, dout, dout.new_zeros(()))
    wt = w.transpose(1, 2).contiguous()
    xt = x.transpose(1, 2).contiguous()
    return [_launch(dout, wt, rows), _launch(xt, dout_live, None)]


def segment_matmul_backward(dout: torch.Tensor, x: torch.Tensor,
                            w: torch.Tensor,
                            rows: Optional[torch.Tensor] = None):
    """(dx, dw) of ``out = segment_matmul(x, w, rows)`` at ``dout``
    (``[E, C, F]``, x's dtype): ``dx = dout @ w^T`` with its rows past
    ``rows`` zero, and ``dw = x^T @ dout`` over the live rows only (NaN in
    x past them stays out).  Two launches for CUDA tensors: where TMA can
    map them (bf16, D and F multiples of 8, 16-byte-aligned data) the
    tiles kernel's ``dx`` and ``dw`` forms on the tensors as they are;
    else x and dout zeroed past ``rows`` by ``torch.where`` and K4 on
    contiguous copies of ``w^T`` and ``x^T`` (dw contracts over C, so a C
    that is no multiple of 8 takes K4's ``wmma`` kernel in bf16).  For CPU
    tensors the plain version, ``ref.segment_matmul_backward``."""
    _check(x, w, rows)
    dout = dout.contiguous()
    if dout.shape != (*x.shape[:2], w.shape[2]) or dout.dtype != x.dtype:
        raise ValueError(f"dout must be {x.dtype} [E, C, F] = "
                         f"{[*x.shape[:2], w.shape[2]]}, got {dout.dtype} "
                         f"{list(dout.shape)}")
    if x.device.type == "cpu":
        return ref.segment_matmul_backward(dout, x, w, rows)
    E, C, D = x.shape
    F = w.shape[2]
    if (x.dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0
            and not any(t.data_ptr() % 16 for t in (x, w, dout))):
        calls = [_launch_bwd("dx", dout, w, rows, E, C, D, F),
                 _launch_bwd("dw", x, dout, rows, E, C, D, F)]
    else:
        calls = _copies_bwd(dout, x, w, rows)
    for _, route in calls:
        if route is not None:
            segment_matmul_backward.launches += 1
            bwd_routes[route] += 1
    return tuple(out for out, _ in calls)


segment_matmul_backward.launches = 0


class _SegmentMatmul(torch.autograd.Function):
    """K4 with K4 as its backward."""

    @staticmethod
    def forward(ctx, x, w, rows):
        ctx.save_for_backward(x, w, rows)
        return segment_matmul(x, w, rows)

    @staticmethod
    def backward(ctx, dout):
        x, w, rows = ctx.saved_tensors
        dx, dw = segment_matmul_backward(dout, x, w, rows)
        return dx, dw, None


def segment_matmul_ad(x: torch.Tensor, w: torch.Tensor,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`segment_matmul` as an autograd function (the model's call):
    differentiable in x and w, its backward through
    :func:`segment_matmul_backward`."""
    return _SegmentMatmul.apply(x, w, rows)
