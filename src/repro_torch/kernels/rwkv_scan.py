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

The backward, :func:`rwkv_scan_bwd` (a kernel of the same source; the JAX
package differentiates its ``lax.scan``, and the Pallas kernel has no
vjp): dr, dk, dv, dw, du and dstate0 from the inputs, the gradient at out
and at the final state, and the forward's checkpoints (its state before
every ``CHECKPOINT_EVERY``-th step, which ``rwkv_scan(...,
checkpoints=True)`` writes; without them the forward's call is the one it
was, the same bits).  A thread-block cluster shares each (b, h), a block
owning a band of 32 rows of the state's gradient (hd 16: one band of
16) in registers, two blocks an SM: its compute warps recompute
each 8-step chunk's states from the checkpoint into shared memory and
walk t down, and two helper warps stage the chunks by bulk copies and
write the gradients.  Row sums stay in a block; the column sums of dv
cross the cluster through distributed shared memory and are added in the
first design's order, so the gradients are its bits.  No atomics (du
leaves each (b, h)'s share, summed over B here), so two calls give the
same bits.  Bound: about 12
hd^2 float32 operations a step of each (b, h), or r, k, v, w, dout, the
gradients and the checkpoints moved once.  ``.launches`` counts its
launches.  :func:`rwkv_scan_ad` is the autograd function the model calls.
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

#: Steps between the forward's checkpoints of the state for the backward
#: (``kCk`` in the source; the backward's chunk).
CHECKPOINT_EVERY = 8

_calls = {}


def _library():
    """The library, checked once against CHECKPOINT_EVERY."""
    lib = _build.load("rwkv_scan")
    if "lib" not in _calls:
        every = lib.repro_rwkv_checkpoint_every()
        if every != CHECKPOINT_EVERY:
            raise RuntimeError(f"csrc/rwkv_scan.cu checkpoints every {every} "
                               f"steps, the wrapper every {CHECKPOINT_EVERY}")
        _calls["lib"] = lib
    return lib


def _entry():
    """The forward's entry point, its argument types set (once)."""
    if "fwd" not in _calls:
        lib = _library()
        fn = lib.repro_rwkv_scan
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 9 + [i32] * 5 + [i64] * 6 + [i32, ptr]
        fn.restype = i32
        _calls["fwd"] = (lib, fn)
    return _calls["fwd"]


def _bwd_entry():
    """The backward's entry point, its argument types set (once)."""
    if "bwd" not in _calls:
        lib = _library()
        fn = lib.repro_rwkv_scan_bwd
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [ptr] * 14 + [i32] * 5 + [i64] * 9 + [i32, ptr]
        fn.restype = i32
        _calls["bwd"] = (lib, fn)
    return _calls["bwd"]


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


def _kinds(r, k, v, w, u, state0) -> Optional[int]:
    """The kernel's type code when the inputs are ones it takes (one pass
    of the checks a call needs), else None (:func:`_refuse` then finds and
    names the fault)."""
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
    return kinds if ok else None


def _out_stride(r: torch.Tensor):
    """r's strides where they are the model's layout ([B, T, H, hd] read as
    [B, H, T, hd]), else contiguous: the layout out and the gradients are
    written in."""
    B, H, T, hd = r.shape
    if r.stride() == (T * H * hd, hd, H * hd, 1):
        return r.stride()
    return (H * T * hd, T * hd, hd, 1)


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None, *,
              checkpoints: bool = False):
    """(out ``[B, H, T, hd]`` in r's type, on the card in r's layout, and
    the final state ``[B, H, hd, hd]`` float32).  r, k, v and w of one
    shape and one layout with hd's stride 1; u and state0 (zeros when None)
    contiguous; everything on one device; hd <= 64.

    With ``checkpoints`` it also returns the buffer the backward reads, the
    state before every ``CHECKPOINT_EVERY``-th step, float32
    ``[B, H, ceil(T / CHECKPOINT_EVERY), hd, hd]`` (None on the CPU, whose
    plain backward recomputes from state0); out and the state are the same
    bits either way."""
    kinds = _kinds(r, k, v, w, u, state0)
    if kinds is None or not r.is_cuda:
        if kinds is None or not r.is_cpu:
            _refuse(r, k, v, w, u, state0)
        out, state = ref.rwkv_scan(r, k, v, w, u, state0)
        return (out, state, None) if checkpoints else (out, state)
    B, H, T, hd = r.shape
    dev = r.device
    # Two allocations (three with checkpoints): carving out and the state
    # from one buffer costs the host more (two view ops) than a second
    # allocation from PyTorch's cache.
    out_stride = _out_stride(r)
    out = torch.empty_strided(r.shape, out_stride, dtype=r.dtype, device=dev)
    state = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    ck = (torch.empty((B, H, -(-T // CHECKPOINT_EVERY), hd, hd),
                      dtype=torch.float32, device=dev)
          if checkpoints else None)
    if state.numel() == 0:
        return (out, state, ck) if checkpoints else (out, state)
    lib, fn = _entry()
    code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
              u.data_ptr(), None if state0 is None else state0.data_ptr(),
              out.data_ptr(), state.data_ptr(),
              None if ck is None else ck.data_ptr(), B, H, T, hd, kinds,
              *r.stride()[:3], *out_stride[:3],
              *_build.device_and_stream(dev))
    if code:
        _build.raise_on(lib, code, "rwkv_scan")
    rwkv_scan.launches += 1
    return (out, state, ck) if checkpoints else (out, state)


rwkv_scan.launches = 0


def rwkv_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state0: Optional[torch.Tensor], dout: torch.Tensor,
                  dstate_T: Optional[torch.Tensor] = None, *,
                  checkpoints: Optional[torch.Tensor] = None):
    """K6's backward: (dr, dk, dv in r's type, dw in w's, du ``[H, hd]``
    and dstate0 ``[B, H, hd, hd]`` float32) from the forward's inputs,
    ``dout`` (r's type and shape; hd's stride 1 is read in place, any
    other layout is copied first) and ``dstate_T`` (float32 ``[B, H, hd,
    hd]``, zeros when None).  On the card it needs the forward's
    ``checkpoints`` (``rwkv_scan(..., checkpoints=True)``) and writes dr,
    dk, dv and dw in r's layout where that is the model's; on the CPU it
    runs the plain version, which recomputes the states from state0."""
    kinds = _kinds(r, k, v, w, u, state0)
    if kinds is None or not (r.is_cuda or r.is_cpu):
        _refuse(r, k, v, w, u, state0)
    B, H, T, hd = r.shape
    if (dout.shape != r.shape or dout.dtype != r.dtype
            or dout.device != r.device):
        raise ValueError(f"dout must be like out ({tuple(r.shape)} "
                         f"{r.dtype} on {r.device}), got {tuple(dout.shape)} "
                         f"{dout.dtype} on {dout.device}")
    if dstate_T is not None and (
            dstate_T.dtype != torch.float32 or not dstate_T.is_contiguous()
            or dstate_T.shape != (B, H, hd, hd)
            or dstate_T.device != r.device):
        raise ValueError(f"dstate_T must be float32 [B, H, hd, hd] "
                         f"contiguous on r's device, got "
                         f"{tuple(dstate_T.shape)} {dstate_T.dtype}")
    if r.is_cpu:
        return ref.rwkv_scan_bwd(r, k, v, w, u, state0, dout, dstate_T)
    n_ck = -(-T // CHECKPOINT_EVERY)
    if (checkpoints is None or checkpoints.dtype != torch.float32
            or checkpoints.shape != (B, H, n_ck, hd, hd)
            or not checkpoints.is_contiguous()
            or checkpoints.device != r.device):
        raise ValueError(f"the backward on the card needs the forward's "
                         f"checkpoints, float32 {(B, H, n_ck, hd, hd)} "
                         f"contiguous (rwkv_scan(..., checkpoints=True))")
    if dout.stride(3) != 1 and hd > 1:
        dout = dout.contiguous()
    dev = r.device
    g_stride = _out_stride(r)
    dr, dk, dv = (torch.empty_strided(r.shape, g_stride, dtype=r.dtype,
                                      device=dev) for _ in range(3))
    dw = torch.empty_strided(r.shape, g_stride, dtype=w.dtype, device=dev)
    du_part = torch.empty((B, H, hd), dtype=torch.float32, device=dev)
    dstate0 = torch.empty((B, H, hd, hd), dtype=torch.float32, device=dev)
    if dstate0.numel() == 0:
        return dr, dk, dv, dw, du_part.sum(0), dstate0
    lib, fn = _bwd_entry()
    code = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
              u.data_ptr(), checkpoints.data_ptr(), dout.data_ptr(),
              None if dstate_T is None else dstate_T.data_ptr(),
              dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
              du_part.data_ptr(), dstate0.data_ptr(), B, H, T, hd, kinds,
              *r.stride()[:3], *dout.stride()[:3], *g_stride[:3],
              *_build.device_and_stream(dev))
    if code:
        _build.raise_on(lib, code, "rwkv_scan_bwd")
    rwkv_scan_bwd.launches += 1
    # Each (b, h)'s share of du, summed over B by PyTorch's reduction (no
    # atomics: the same order, and bits, every call).
    return dr, dk, dv, dw, du_part.sum(0), dstate0


rwkv_scan_bwd.launches = 0


class _RwkvScan(torch.autograd.Function):
    """K6 with :func:`rwkv_scan_bwd` as its backward, the forward's
    checkpoints saved for it (recomputed with the forward under remat)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state0):
        out, state, ck = rwkv_scan(r, k, v, w, u, state0, checkpoints=True)
        ctx.save_for_backward(r, k, v, w, u, state0, ck)
        ctx.set_materialize_grads(False)
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, state0, ck = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(r)
        dr, dk, dv, dw, du, ds0 = rwkv_scan_bwd(
            r, k, v, w, u, state0, dout,
            None if dstate is None else dstate.contiguous(), checkpoints=ck)
        return dr, dk, dv, dw, du, None if state0 is None else ds0


def rwkv_scan_ad(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 state0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`rwkv_scan` as an autograd function (the model's call),
    differentiable in r, k, v, w, u and state0.  With no gradient to take
    (grad mode off, or no input that requires one: the serve) it is
    :func:`rwkv_scan` itself, which then writes no checkpoints."""
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad
            for x in (r, k, v, w, u, state0)):
        return _RwkvScan.apply(r, k, v, w, u, state0)
    return rwkv_scan(r, k, v, w, u, state0)
