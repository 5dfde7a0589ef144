"""The in-dispatch skew controller's step: a wrapper over a hand-written CUDA
kernel.

Not the counterpart of a Pallas kernel: the JAX package runs this step as
one jitted XLA program a super-tick (``_make_ctrl_step`` in
``repro/dataflow/device.py``).  Its arithmetic is a float64 chain that must
equal the host ``ReshapeController`` bit for bit; as eager torch ops it
would be tens of thousands of launches a round, so on the card it is one
launch of ``csrc/ctrl_step.cu`` (one block; warp 0 runs the rounds, a lane
a worker's ring).

The device of ``cstate["weights"]`` decides the path: on the card the
wrapper launches the kernel on the current stream or raises; on the CPU it
runs the plain version, :func:`repro_torch.kernels.ref.ctrl_step`.
:func:`ctrl_step` counts the calls that launched the kernel in
``.launches``.

The kernel's argument block (:class:`ArgBlock`: the state's pointers, the
spec, the checks of the state tensors) is built once per controller state
and reused: ``DeviceController`` builds it with each ``cstate`` and passes
it to every call, which then sets only ``t0``, ``k``, ``tuples_left`` and
``phi``.  ``phi`` (the host mirror of the workloads) travels by shape: up
to :data:`PHI_PARAM` workers inside the launch's own parameter block,
which the launch copies, so nothing else crosses; a wider state through
one pinned staging buffer and one host-to-device copy a call.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
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

#: ``phi`` rides in the kernel's parameter block up to this many workers
#: (``kPhiParam`` in ``csrc/ctrl_step.cu``).
PHI_PARAM = 128

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
                + [(name, ctypes.c_int32) for name in _SPEC_INTS]
                + [("phi_param", ctypes.c_double * PHI_PARAM)])


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("ctrl_step")
        lib.repro_ctrl_step.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                        ctypes.c_void_p]
        lib.repro_ctrl_step.restype = ctypes.c_int
        for name in ("repro_ctrl_step_args_size", "repro_ctrl_step_phi_param"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        if (lib.repro_ctrl_step_args_size() != ctypes.sizeof(_Args)
                or lib.repro_ctrl_step_phi_param() != PHI_PARAM):
            raise RuntimeError("csrc/ctrl_step.cu disagrees with the CtrlArgs "
                               "layout of kernels/ctrl_step.py")
        lib.repro_dadd_chain.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_void_p]
        lib.repro_dadd_chain.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(spec, cstate: Dict[str, torch.Tensor]) -> torch.device:
    dev = cstate["weights"].device
    for name, dtype in STATE_DTYPES.items():
        t = cstate[name]
        if t.dtype != dtype or t.device != dev or not t.is_contiguous():
            raise ValueError(f"cstate[{name!r}] must be a contiguous {dtype} "
                             f"tensor on {dev}, got {t.dtype} on {t.device}")
    if cstate["weights"].shape != (spec.K, spec.W):
        raise ValueError(f"weights must be [K, W] = [{spec.K}, {spec.W}], "
                         f"got {tuple(cstate['weights'].shape)}")
    return dev


class ArgBlock:
    """The kernel's arguments for one controller state, built once.

    Holds the checked state tensors (so their storage, which the block
    names by address, lives as long as it does), the ``_Args`` structure
    with their pointers and the spec, and ``phi``'s route.  It stays valid
    while ``cstate`` keeps its tensors: writes into them in place (the
    kernel's, a drain's host-wins overwrite, ``log_n.zero_()``) keep their
    storage; a new ``cstate`` needs a new block."""

    def __init__(self, spec, cstate: Dict[str, torch.Tensor]):
        self.device = _check(spec, cstate)
        self.spec = spec
        self.cstate = cstate
        self.tensors = {name: cstate[name] for name in STATE_DTYPES}
        args = self.args = _Args(**{name: t.data_ptr()
                                    for name, t in self.tensors.items()})
        for name in _SPEC_DOUBLES:
            setattr(args, name, float(getattr(spec, name)))
        for name in _SPEC_INTS:
            setattr(args, name, int(getattr(spec, name)))
        self.arrived: Optional[torch.Tensor] = None
        #: phi inside the parameter block (a view of ``args.phi_param``)
        #: or, wider, (pinned host buffer, device buffer, copy-done event).
        self.phi_param = self.staging = None
        if spec.W <= PHI_PARAM:
            self.phi_param = np.ctypeslib.as_array(args.phi_param)[:spec.W]
        elif self.device.type == "cuda":
            self.staging = (
                torch.empty(spec.W, dtype=torch.float64).pin_memory(),
                torch.empty(spec.W, dtype=torch.float64, device=self.device),
                torch.cuda.Event())
            args.phi = self.staging[1].data_ptr()
        self.index = (None if self.device.type != "cuda" else
                      _build.device_and_stream(self.device)[0])

    def set_arrived(self, arrived: torch.Tensor) -> None:
        """Name ``arrived`` (checked the first time it is seen)."""
        if arrived is self.arrived:
            return
        if (arrived.dtype != torch.int64 or arrived.shape != (self.spec.K,)
                or arrived.device != self.device
                or not arrived.is_contiguous()):
            raise ValueError("arrived must be a contiguous int64 [K] tensor "
                             "on the state's device")
        self.args.arrived = arrived.data_ptr()
        self.arrived = arrived

    def set_phi(self, phi) -> None:
        """``phi`` into the parameter block, or through the staging buffer
        (rewritten only once the previous copy out of it has finished)."""
        if isinstance(phi, torch.Tensor):
            phi = phi.detach().cpu().numpy()
        if self.phi_param is not None:
            self.phi_param[:] = phi          # cast to float64
            return
        pinned, dev, done = self.staging
        done.synchronize()
        pinned.numpy()[:] = phi
        dev.copy_(pinned, non_blocking=True)
        done.record()

    def launch(self, arrived, phi, t0: int, k: int,
               tuples_left: float) -> None:
        """Set the call's fields and launch on the current stream."""
        self.set_arrived(arrived)
        self.set_phi(phi)
        args = self.args
        args.t0, args.k, args.tuples_left = t0, k, tuples_left
        lib = _library()
        _build.raise_on(lib, lib.repro_ctrl_step(
            ctypes.addressof(args), self.index,
            torch._C._cuda_getCurrentRawStream(self.index)), "ctrl_step")


def ctrl_step(spec, cstate: Dict[str, torch.Tensor], arrived: torch.Tensor,
              phi, t0: int, k: int, tuples_left: float, rate: float,
              block: Optional[ArgBlock] = None) -> None:
    """Run the metric rounds of the window ``[t0, t0 + k)`` on ``cstate``
    (in place) and zero ``arrived``; see
    :func:`repro_torch.kernels.ref.ctrl_step` for the arithmetic.

    ``spec`` is a :class:`~repro_torch.dataflow.device.CtrlSpec`;
    ``cstate`` holds the tensors of :data:`STATE_DTYPES` on one device, the
    0-d ``tau``, ``tau_adj``, ``seq_next``, ``epoch`` and ``log_n``
    included; ``phi`` is the ``[W]`` float64 workloads on the host.
    ``block`` is the state's :class:`ArgBlock` (one is built, and the
    state checked, when it is None or belongs to another state or spec).
    The observation log must have a free row (``log_n < R``): the kernel
    traps on a full one, the plain version raises."""
    if block is None or block.cstate is not cstate or block.spec is not spec:
        block = ArgBlock(spec, cstate)
    if block.device.type == "cpu":
        block.set_arrived(arrived)
        ref.ctrl_step(spec, cstate, arrived, phi, t0, k, tuples_left, rate)
        return
    if block.device.type != "cuda":
        raise ValueError(f"unsupported device {block.device}")
    block.launch(arrived, phi, int(t0), int(k), float(tuples_left))
    ctrl_step.launches += 1


ctrl_step.launches = 0


def dadd_latency_ms(device: torch.device, n: int = 1 << 20) -> float:
    """The card's float64 add latency in ms: one thread's chains of ``n``
    and ``2 n`` dependent adds, CUDA events, the difference over ``n``
    (the launch cancels).  For the bound of :func:`ctrl_step`."""
    lib = _library()
    out = torch.empty((), dtype=torch.float64, device=device)
    index = _build.device_and_stream(device)[0]

    def run(length: int) -> float:
        best = float("inf")
        for _ in range(3):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            _build.raise_on(lib, lib.repro_dadd_chain(
                out.data_ptr(), length, index,
                torch._C._cuda_getCurrentRawStream(index)), "dadd_chain")
            ev[1].record()
            ev[1].synchronize()
            best = min(best, ev[0].elapsed_time(ev[1]))
        return best

    run(n)                                   # warm
    return (run(2 * n) - run(n)) / n
