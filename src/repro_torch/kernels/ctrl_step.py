"""The in-dispatch skew controller's step: a wrapper over a hand-written CUDA
kernel.

Not the counterpart of a Pallas kernel: the JAX package runs this step as
one jitted XLA program a super-tick (``_make_ctrl_step`` in
``repro/dataflow/device.py``).  Its arithmetic is a strictly sequential
float64 chain that must equal the host ``ReshapeController`` bit for bit;
as eager torch ops it would be tens of thousands of launches a round, so on
the card it is one launch of ``csrc/ctrl_step.cu`` (one block).

The device of ``cstate["weights"]`` decides the path: on the card the
wrapper launches the kernel on the current stream or raises; on the CPU it
runs the plain version, :func:`repro_torch.kernels.ref.ctrl_step`.
:func:`ctrl_step` counts the calls that launched the kernel in
``.launches``.  ``phi`` (the host mirror of the workloads) reaches the card
through one pinned staging buffer a (device, W): one host-to-device copy a
call, and nothing else crosses.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import _build, ref

#: the state tensors the kernel reads and writes, with their dtypes.
STATE_DTYPES = dict(
    weights=torch.float64, cdf=torch.float32, primary=torch.int64,
    is_split=torch.bool, owner=torch.int64, obs=torch.float64,
    obs_n=torch.int32, obs_pos=torch.int32, tau=torch.float64,
    tau_adj=torch.int32, mit_active=torch.bool, mit_helper=torch.int32,
    mit_phase=torch.int32, mit_calm=torch.int32, mit_seq=torch.int32,
    seq_next=torch.int32, epoch=torch.int32, log_phi=torch.float64,
    log_arr=torch.float64, log_n=torch.int32)

_SPEC_DOUBLES = ("eta", "eps_lower", "eps_upper", "tau_increase",
                 "catchup_tolerance", "horizon")
_SPEC_INTS = ("K", "W", "window", "R", "metric_period", "initial_delay",
              "max_tau_adjustments", "retire_window", "adaptive_tau",
              "enable_phase1")


class _Args(ctypes.Structure):
    """Field for field ``CtrlArgs`` in ``csrc/ctrl_step.cu``."""

    _fields_ = ([(name, ctypes.c_void_p) for name in STATE_DTYPES]
                + [("arrived", ctypes.c_void_p), ("phi", ctypes.c_void_p),
                   ("t0", ctypes.c_int64), ("k", ctypes.c_int64),
                   ("tuples_left", ctypes.c_double)]
                + [(name, ctypes.c_double) for name in _SPEC_DOUBLES]
                + [(name, ctypes.c_int32) for name in _SPEC_INTS])


_lib = None
#: (pinned host buffer, device buffer, copy-done event) per (device, W).
_STAGING: Dict[Tuple[int, int], tuple] = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ctrl_step")
        lib.repro_ctrl_step.argtypes = [ctypes.POINTER(_Args), ctypes.c_int,
                                        ctypes.c_void_p]
        lib.repro_ctrl_step.restype = ctypes.c_int
        lib.repro_ctrl_step_args_size.argtypes = []
        lib.repro_ctrl_step_args_size.restype = ctypes.c_int
        if lib.repro_ctrl_step_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("csrc/ctrl_step.cu disagrees with the CtrlArgs "
                               "layout of kernels/ctrl_step.py")
        _lib = lib
    return _lib


def _stage_phi(phi, index: int, num_workers: int) -> torch.Tensor:
    """``phi`` on the card through its pinned staging buffer (one
    host-to-device copy on the current stream).  The buffer is rewritten
    only once the previous copy out of it has finished."""
    st = _STAGING.get((index, num_workers))
    if st is None:
        st = _STAGING[(index, num_workers)] = (
            torch.empty(num_workers, dtype=torch.float64).pin_memory(),
            torch.empty(num_workers, dtype=torch.float64,
                        device=torch.device("cuda", index)),
            torch.cuda.Event())
    pinned, dev, done = st
    done.synchronize()
    if isinstance(phi, torch.Tensor):
        phi = phi.detach().cpu().numpy()
    pinned.numpy()[:] = phi             # cast to the buffer's float64
    dev.copy_(pinned, non_blocking=True)
    done.record()
    return dev


def _check(spec, cstate: Dict[str, torch.Tensor], arrived: torch.Tensor
           ) -> torch.device:
    dev = cstate["weights"].device
    for name, dtype in STATE_DTYPES.items():
        t = cstate[name]
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"cstate[{name!r}] must be a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if cstate["weights"].shape != (spec.K, spec.W):
        raise ValueError(f"weights must be [K, W] = [{spec.K}, {spec.W}], "
                         f"got {tuple(cstate['weights'].shape)}")
    if (arrived.dtype != torch.int64 or arrived.shape != (spec.K,)
            or arrived.device != dev or not arrived.is_contiguous()):
        raise ValueError("arrived must be a contiguous int64 [K] tensor on "
                         "the state's device")
    return dev


def ctrl_step(spec, cstate: Dict[str, torch.Tensor], arrived: torch.Tensor,
              phi, t0: int, k: int, tuples_left: float, rate: float) -> None:
    """Run the metric rounds of the window ``[t0, t0 + k)`` on ``cstate``
    (in place) and zero ``arrived``; see
    :func:`repro_torch.kernels.ref.ctrl_step` for the arithmetic.

    ``spec`` is a :class:`~repro_torch.dataflow.device.CtrlSpec`;
    ``cstate`` holds the tensors of :data:`STATE_DTYPES` on one device, the
    0-d ``tau``, ``tau_adj``, ``seq_next``, ``epoch`` and ``log_n``
    included; ``phi`` is the ``[W]`` float64 workloads on the host.  The
    observation log must have a free row (``log_n < R``): the kernel traps
    on a full one, the plain version raises."""
    dev = _check(spec, cstate, arrived)
    if dev.type == "cpu":
        ref.ctrl_step(spec, cstate, arrived, phi, t0, k, tuples_left, rate)
        return
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    lib = _library()
    index, stream = _build.device_and_stream(dev)
    args = _Args(**{name: cstate[name].data_ptr() for name in STATE_DTYPES})
    args.arrived = arrived.data_ptr()
    args.phi = _stage_phi(phi, index, spec.W).data_ptr()
    args.t0, args.k, args.tuples_left = int(t0), int(k), float(tuples_left)
    for name in _SPEC_DOUBLES:
        setattr(args, name, float(getattr(spec, name)))
    for name in _SPEC_INTS:
        setattr(args, name, int(getattr(spec, name)))
    _build.raise_on(lib, lib.repro_ctrl_step(ctypes.byref(args), index,
                                             stream), "ctrl_step")
    ctrl_step.launches += 1


ctrl_step.launches = 0
