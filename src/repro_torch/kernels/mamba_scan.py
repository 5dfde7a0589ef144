"""Mamba selective scan K7: wrapper over the hand-written CUDA kernel.

No Pallas kernel of the JAX package computes this: ``repro.models.ssm.
mamba_apply`` (``ssm.py:176-207``) runs its recurrence with ``lax.scan``
(``:193-206``).  The port makes it a kernel because it is a scan on the
hybrid family's hot path (one call a layer a model call), which as eager
ops would be several launches a step.  The JAX layout is kept: x ``[B, S,
DI]`` (the head's input in the compute dtype), delta ``[B, S, DI]``, B and
C ``[B, S, N]`` float32 (JAX casts them, ``ssm.py:183-187``), ``a = -exp(
a_log)`` ``[DI, N]`` and d_skip ``[DI]`` float32, the state ``[B, DI, N]``
float32.  Per (b, d, n), in float32:

    h_t = exp(delta_t a) h_{t-1} + (delta_t B_t) x_t
    y_t = sum_n h_t C_t + x_t d_skip

``y`` comes back in x's dtype (rounded once, as JAX's ``.astype``) with
the final state, so a prompt and the decode steps after it chain.

For CUDA tensors the wrapper launches the kernel of ``csrc/mamba_scan.cu``
(built at first use) on the current stream, or raises; for CPU tensors it
runs the plain version, :func:`repro_torch.kernels.ref.mamba_scan`.
``.launches`` counts the calls that launched the kernel.

Bound on an H100: ``B S DI N`` exponentials at the multi-function unit's
rate (16 a clock an SM) and about 5 float32 operations an entry, or x,
delta, B and C read and y written once, whichever is longer: the
exponentials, at Hymba-1.5B's shapes.  Design: a block of 32 channels of
one batch row, 4 lanes a channel and 4 states a lane, the state in
registers for the whole walk; each chunk's inputs read once a block into a
shared-memory ring by cp.async, a chunk ahead; ``da = ex2(delta a log2
e)`` (one instruction of that unit) and ``h = fma(da, h, (delta B) x)``;
the sums over n by one transposed butterfly a chunk.  The bits differ from
the plain version within ``chip_smoke.check_mamba``'s envelope; the source
note in the ``.cu`` file has the details.

The backward, :func:`mamba_scan_bwd` (two launches of the same source:
the recurrence walked backwards chunk by chunk from the forward's
checkpoints, every ``CHECKPOINT_EVERY`` steps, each chunk's states and
decays recomputed into registers once, its decays by one ex2 with a
correction so their error does not grow with ``|delta a|``; dB and dC
summed over d in a block, then in a cluster of blocks through distributed
shared memory, then a pass that adds the clusters' partials, and those
over b, in a fixed order; no atomics, so two calls give the same bits):
dx in x's dtype, ddelta, dB, dC, da, dd_skip and dh0 in float32.
:func:`mamba_scan_ad` is the autograd function the model calls.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build, ref

#: The largest state width the kernel takes (16 lanes a channel).
MAX_STATE = 16

#: Steps between the forward's checkpoints (``kCk`` in the source).
CHECKPOINT_EVERY = 16

#: Launches of the backward a call.
BWD_LAUNCHES = 2

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_calls = {}


def _library():
    """The library, its entry points typed and checked once against
    CHECKPOINT_EVERY."""
    if "lib" not in _calls:
        lib = _build.load("mamba_scan")
        every = lib.repro_mamba_checkpoint_every()
        if every != CHECKPOINT_EVERY:
            raise RuntimeError(f"csrc/mamba_scan.cu checkpoints every {every} "
                               f"steps, the wrapper every {CHECKPOINT_EVERY}")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_mamba_scan.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        lib.repro_mamba_scan.restype = i32
        lib.repro_mamba_scan_bwd.argtypes = [ptr] * 17 + [i32] * 6 + [ptr]
        lib.repro_mamba_scan_bwd.restype = i32
        lib.repro_mamba_bwd_workspace.argtypes = [i32] * 4
        lib.repro_mamba_bwd_workspace.restype = ctypes.c_longlong
        _calls["lib"] = lib
    return _calls["lib"]


def _check(x, delta, bmat, cmat, a, d_skip, h0):
    """Raise on what the kernel does not take; (B, S, DI, N)."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    floats = [delta, bmat, cmat, a, d_skip] + ([] if h0 is None else [h0])
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError(f"delta, B, C, a, d_skip and h0 must be float32, "
                        f"got {[t.dtype for t in floats]}")
    if x.dim() != 3 or delta.shape != x.shape:
        raise ValueError(f"need x and delta [B, S, DI], got {tuple(x.shape)} "
                         f"and {tuple(delta.shape)}")
    B, S, DI = x.shape
    N = a.shape[-1] if a.dim() == 2 else -1
    if (a.shape != (DI, N) or bmat.shape != (B, S, N)
            or cmat.shape != (B, S, N) or d_skip.shape != (DI,)
            or (h0 is not None and h0.shape != (B, DI, N))):
        raise ValueError(f"need B, C [B, S, N], a [DI, N], d_skip [DI] and "
                         f"h0 [B, DI, N] beside x {tuple(x.shape)}, got "
                         f"{tuple(bmat.shape)}, {tuple(cmat.shape)}, "
                         f"{tuple(a.shape)}, {tuple(d_skip.shape)}, "
                         f"{None if h0 is None else tuple(h0.shape)}")
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"state width N = {N} is past the kernel's "
                         f"{MAX_STATE} (16 lanes a channel)")
    tensors = [x] + floats
    if (any(t.device != x.device for t in tensors)
            or x.device.type not in ("cpu", "cuda")):
        raise ValueError("x, delta, B, C, a, d_skip and h0 must share one "
                         "cpu or cuda device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, delta, B, C, a, d_skip and h0 must be "
                         "contiguous")
    return B, S, DI, N


def mamba_scan(x: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *,
               checkpoints: bool = False):
    """(y ``[B, S, DI]`` in x's dtype, the final state ``[B, DI, N]``
    float32).  With ``checkpoints`` it also returns what the backward
    reads: the state before every ``CHECKPOINT_EVERY``-th step, float32
    ``[B, ceil(S / CHECKPOINT_EVERY), DI, N]`` (None on the CPU, whose
    plain backward recomputes from h0); y and the state are the same bits
    either way."""
    B, S, DI, N = _check(x, delta, bmat, cmat, a, d_skip, h0)
    if x.device.type == "cpu":
        y, h = ref.mamba_scan(x, delta, bmat, cmat, a, d_skip, h0)
        return (y, h, None) if checkpoints else (y, h)
    dev = x.device
    y = torch.empty((B, S, DI), dtype=x.dtype, device=dev)
    h = torch.empty((B, DI, N), dtype=torch.float32, device=dev)
    ck = (torch.empty((B, -(-S // CHECKPOINT_EVERY), DI, N),
                      dtype=torch.float32, device=dev)
          if checkpoints else None)
    if S == 0:
        if h0 is None:
            h.zero_()
        else:
            h.copy_(h0)
        return (y, h, ck) if checkpoints else (y, h)
    lib = _library()
    code = lib.repro_mamba_scan(
        x.data_ptr(), delta.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h.data_ptr(),
        None if ck is None else ck.data_ptr(), B, S, DI, N, _DTYPES[x.dtype],
        *_build.device_and_stream(dev))
    _build.raise_on(lib, code, "mamba_scan")
    mamba_scan.launches += 1
    return (y, h, ck) if checkpoints else (y, h)


mamba_scan.launches = 0


def mamba_scan_bwd(x: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: Optional[torch.Tensor], dy: torch.Tensor,
                   dh_fin: Optional[torch.Tensor] = None, *,
                   checkpoints: Optional[torch.Tensor] = None):
    """K7's backward: (dx in x's dtype, ddelta ``[B, S, DI]``, dB and dC
    ``[B, S, N]``, da ``[DI, N]``, dd_skip ``[DI]`` and dh0 ``[B, DI, N]``,
    float32) from the forward's inputs, ``dy`` (x's dtype and shape, made
    contiguous here) and ``dh_fin`` (float32 ``[B, DI, N]``, zeros when
    None).  On the card it needs the forward's ``checkpoints``
    (``mamba_scan(..., checkpoints=True)``; they start from h0); on the CPU
    it runs the plain version, which recomputes the states from h0."""
    B, S, DI, N = _check(x, delta, bmat, cmat, a, d_skip, h0)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be like y ({tuple(x.shape)} {x.dtype} on "
                         f"{x.device}), got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    if dh_fin is not None and (dh_fin.dtype != torch.float32
                               or dh_fin.shape != (B, DI, N)
                               or dh_fin.device != x.device):
        raise ValueError(f"dh_fin must be float32 [B, DI, N] on x's device, "
                         f"got {tuple(dh_fin.shape)} {dh_fin.dtype}")
    if x.device.type == "cpu":
        return ref.mamba_scan_bwd(x, delta, bmat, cmat, a, d_skip, h0, dy,
                                  dh_fin)
    n_ck = -(-S // CHECKPOINT_EVERY)
    if (checkpoints is None or checkpoints.dtype != torch.float32
            or checkpoints.shape != (B, n_ck, DI, N)
            or not checkpoints.is_contiguous()
            or checkpoints.device != x.device):
        raise ValueError(f"the backward on the card needs the forward's "
                         f"checkpoints, float32 {(B, n_ck, DI, N)} "
                         f"contiguous (mamba_scan(..., checkpoints=True))")
    dev = x.device
    dy = dy.contiguous()
    dh_fin = None if dh_fin is None else dh_fin.contiguous()
    dx = torch.empty_like(x)
    ddelta = torch.empty((B, S, DI), dtype=torch.float32, device=dev)
    db, dc = (torch.empty((B, S, N), dtype=torch.float32, device=dev)
              for _ in range(2))
    da = torch.empty((DI, N), dtype=torch.float32, device=dev)
    dskip = torch.empty((DI,), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, DI, N), dtype=torch.float32, device=dev)
    if S == 0:
        return (dx, ddelta, db, dc, da.zero_(), dskip.zero_(),
                dh0.copy_(dh_fin) if dh_fin is not None else dh0.zero_())
    lib = _library()
    ws = torch.empty(lib.repro_mamba_bwd_workspace(B, S, DI, N),
                     dtype=torch.float32, device=dev)
    code = lib.repro_mamba_scan_bwd(
        x.data_ptr(), delta.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
        a.data_ptr(), d_skip.data_ptr(), checkpoints.data_ptr(),
        dy.data_ptr(), None if dh_fin is None else dh_fin.data_ptr(),
        dx.data_ptr(), ddelta.data_ptr(), db.data_ptr(), dc.data_ptr(),
        da.data_ptr(), dskip.data_ptr(), dh0.data_ptr(), ws.data_ptr(),
        B, S, DI, N, _DTYPES[x.dtype], *_build.device_and_stream(dev))
    _build.raise_on(lib, code, "mamba_scan_bwd")
    mamba_scan_bwd.launches += BWD_LAUNCHES
    return dx, ddelta, db, dc, da, dskip, dh0


mamba_scan_bwd.launches = 0


class _MambaScan(torch.autograd.Function):
    """K7 with :func:`mamba_scan_bwd` as its backward, the forward's
    checkpoints saved for it (recomputed with the forward under remat)."""

    @staticmethod
    def forward(ctx, x, delta, bmat, cmat, a, d_skip, h0):
        y, h, ck = mamba_scan(x, delta, bmat, cmat, a, d_skip, h0,
                              checkpoints=True)
        ctx.save_for_backward(x, delta, bmat, cmat, a, d_skip, h0, ck)
        ctx.set_materialize_grads(False)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, delta, bmat, cmat, a, d_skip, h0, ck = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddl, db, dc, da, dsk, dh0 = mamba_scan_bwd(
            x, delta, bmat, cmat, a, d_skip, h0, dy, dh, checkpoints=ck)
        return dx, ddl, db, dc, da, dsk, None if h0 is None else dh0


def mamba_scan_ad(x: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
                  cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`mamba_scan` as an autograd function (the model's call),
    differentiable in every input.  With no gradient to take (grad mode
    off, or no input that requires one: the serve) it is
    :func:`mamba_scan` itself, which then writes no checkpoints."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, delta, bmat, cmat, a, d_skip, h0)):
        return _MambaScan.apply(x, delta, bmat, cmat, a, d_skip, h0)
    return mamba_scan(x, delta, bmat, cmat, a, d_skip, h0)
