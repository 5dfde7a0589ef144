"""Hand-written CUDA kernels for the hot spots (+ plain PyTorch versions).

  csrc/partition.cu        routing-table exchange kernels K1-K3
  csrc/segment_matmul.cu   grouped expert matmul K4
  csrc/flash_attention.cu  prefill attention K5
  csrc/rwkv_scan.cu        RWKV6 recurrence K6
  csrc/mamba_scan.cu       Mamba selective scan K7 (no Pallas counterpart:
                           the JAX package scans it with lax.scan)
  csrc/ctrl_step.cu        the in-dispatch skew controller's step (no
                           Pallas counterpart: the JAX package jits it)
  _build.py                nvcc build at first use (sm_90a, plain C
                           interface), ctypes loading, launch helpers
  partition.py, segment_matmul.py, flash_attention.py, rwkv_scan.py,
  mamba_scan.py, ctrl_step.py
                           wrappers: a CUDA tensor launches the kernel, a
                           CPU tensor runs the plain version; launch counters
  ref.py                   plain PyTorch versions (the comparison targets)

Every Pallas kernel of ``repro.kernels`` has its counterpart here.
"""
from . import (ctrl_step, flash_attention, mamba_scan, partition, ref,
               rwkv_scan, segment_matmul)

__all__ = ["ctrl_step", "flash_attention", "mamba_scan", "partition", "ref",
           "rwkv_scan", "segment_matmul"]
