"""Build the CUDA sources under ``csrc/`` with nvcc and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (every one exports
``repro_cuda_error_string``) and is compiled at first
use into ``build/repro_torch/lib<name>-<digest>.so`` at the root of the
checkout (listed in ``.gitignore``); the digest covers the source, the
shared headers ``csrc/*.cuh`` it may include and the flags, so an edited
source or header is rebuilt.  :func:`build` starts one nvcc per
missing source, all at once, and keeps each compiler log (``-Xptxas -v``:
registers, shared memory and spills per kernel) beside its library.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("partition", "segment_matmul", "flash_attention", "rwkv_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are built "
        "on the machine with the card")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by the source, every
    shared header ``csrc/*.cuh`` (by name and bytes) and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every named source that is not built yet, in parallel.

    Returns each source's compiler log (empty for a library built
    earlier whose log is gone).  Raises if any nvcc fails; the other
    compilers are stopped first.
    """
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    try:
        for name in names:
            lib = library_path(name)
            if lib.exists():
                continue
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            running[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, lib)
        for name, (proc, tmp, lib) in running.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
    finally:
        for proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    logs = {}
    for name in names:
        log = library_path(name).with_suffix(".log")
        logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def device_and_stream(dev: torch.device) -> Tuple[int, int]:
    """The last two arguments of every entry point: the card's index and
    the address of PyTorch's current stream on it (read without making a
    ``torch.cuda.Stream`` object each call)."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


def raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if an entry point returned a CUDA error (a refused launch)."""
    if code != 0:
        msg = lib.repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} failed to launch: CUDA error {code} "
                           f"({msg})")
