"""Hand-written CUDA kernels for the hot spots (+ plain PyTorch versions).

  csrc/partition.cu   routing-table exchange kernels (sm_90a, C interface)
  _build.py           nvcc build at first use, ctypes loading
  partition.py        wrappers: a CUDA tensor launches the kernel, a CPU
                      tensor runs the plain version; launch counters
  ref.py              plain PyTorch versions (the comparison targets)

Still to port from ``repro.kernels``: ``segment_matmul``,
``flash_attention`` and ``rwkv_scan``.
"""
from . import partition, ref

__all__ = ["partition", "ref"]
