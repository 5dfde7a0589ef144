"""Routing-table partition: wrappers over the hand-written CUDA kernels.

Counterparts of the Pallas kernels in ``repro.kernels.partition``:

* :func:`partition_scatter` (K1): destination, within-destination rank and
  per-worker histogram of a chunk, so the exchange places record ``i`` at
  ``exclusive_cumsum(hist)[dest[i]] + rank[i]`` with no sort;
* :func:`partition_scatter_fold` (K2): K1 over the live lanes of a masked
  chunk plus its per-key count and sum (the device-resident plane's ingest
  and sink fold);
* :func:`partition` (K3): destination and histogram.

The device of the tensors decides the path.  For CUDA tensors a wrapper
launches its kernel from ``csrc/partition.cu`` (built at first use, see
:mod:`repro_torch.kernels._build`) on the current stream, or raises; for
CPU tensors it runs the plain version in :mod:`repro_torch.kernels.ref`.
Each wrapper counts the calls that launched its kernel in ``.launches``.

Inputs: ``keys`` and ``counters`` are int32 ``[N]``; ``cdf`` is the float32
``[K, W]`` row-CDF (``RoutingTable.cdf32`` or
:func:`repro_torch.core.ops.saturated_cdf32`), all contiguous and on one
device.  ``W`` is at most :data:`MAX_WORKERS`.  The Pallas wrappers take
``weights`` and derive the CDF; here the caller passes the CDF so it is
uploaded once per table version and not once per chunk.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build, ref

#: Largest worker count the kernels take (shared-memory layout of pass A).
MAX_WORKERS = 1024
#: Records per block of pass A (256 threads x 16).
TILE_RECORDS = 4096

_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("partition")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_partition_scatter.argtypes = [ptr] * 7 + [i32] * 4 + [ptr]
        lib.repro_partition_scatter.restype = i32
        lib.repro_partition_scatter_fold.argtypes = ([ptr] * 11 + [i32] * 4
                                                     + [ptr])
        lib.repro_partition_scatter_fold.restype = i32
        lib.repro_partition.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.repro_partition.restype = i32
        for fn in ("repro_partition_max_workers",
                   "repro_partition_tile_records"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        if (lib.repro_partition_max_workers() != MAX_WORKERS
                or lib.repro_partition_tile_records() != TILE_RECORDS):
            raise RuntimeError("csrc/partition.cu disagrees with "
                               "MAX_WORKERS / TILE_RECORDS")
        _lib = lib
    return _lib


def _check(keys: torch.Tensor, counters: torch.Tensor,
           cdf: torch.Tensor) -> None:
    if keys.dtype != torch.int32 or counters.dtype != torch.int32:
        raise TypeError(f"keys and counters must be int32, got "
                        f"{keys.dtype} and {counters.dtype}")
    if cdf.dtype != torch.float32:
        raise TypeError(f"cdf must be float32, got {cdf.dtype}")
    if keys.dim() != 1 or counters.shape != keys.shape:
        raise ValueError(f"keys and counters must be [N], got "
                         f"{tuple(keys.shape)} and {tuple(counters.shape)}")
    if cdf.dim() != 2 or cdf.shape[0] < 1 or cdf.shape[1] < 1:
        raise ValueError(f"cdf must be [K, W] with K, W >= 1, got "
                         f"{tuple(cdf.shape)}")
    if cdf.shape[1] > MAX_WORKERS:
        raise ValueError(f"{cdf.shape[1]} workers exceed the kernels' "
                         f"limit of {MAX_WORKERS}")
    if keys.numel() >= 2**31:
        raise ValueError("a chunk must hold fewer than 2^31 records")
    if not (keys.device == counters.device == cdf.device):
        raise ValueError("keys, counters and cdf must share one device")
    if keys.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {keys.device}")
    if not (keys.is_contiguous() and counters.is_contiguous()
            and cdf.is_contiguous()):
        raise ValueError("keys, counters and cdf must be contiguous")


def partition_scatter(keys: torch.Tensor, counters: torch.Tensor,
                      cdf: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dest [N] int32, rank [N] int32, hist [W] int32) of one chunk.

    ``rank[i] = #{j < i : dest[j] == dest[i]}``.
    """
    _check(keys, counters, cdf)
    if keys.device.type == "cpu":
        return ref.partition_scatter(keys, counters, cdf)
    n = keys.numel()
    num_keys, num_workers = cdf.shape
    dev = keys.device
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty.clone(), torch.zeros(num_workers,
                                                 dtype=torch.int32, device=dev)
    lib = _library()
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty(num_workers, dtype=torch.int32, device=dev)
    num_tiles = -(-n // TILE_RECORDS)
    scratch = torch.empty(num_workers * num_tiles, dtype=torch.int32,
                          device=dev)
    code = lib.repro_partition_scatter(
        keys.data_ptr(), counters.data_ptr(), cdf.data_ptr(),
        dest.data_ptr(), rank.data_ptr(), hist.data_ptr(), scratch.data_ptr(),
        n, num_keys, num_workers, *_build.device_and_stream(dev))
    _build.raise_on(lib, code, "partition_scatter")
    partition_scatter.launches += 1
    return dest, rank, hist


def partition_scatter_fold(keys: torch.Tensor, counters: torch.Tensor,
                           vals: torch.Tensor, valid: torch.Tensor,
                           cdf: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """(dest [N] i32, rank [N] i32, hist [W] i32, fold_counts [K] i32,
    fold_sums [K] f32) of one masked chunk.

    ``vals`` is float32 ``[N]``; ``valid`` is the lane mask, ``[N]`` bool or
    uint8 (one byte a lane, nonzero = live).  ``dest`` is computed for every
    lane; ``rank`` and ``hist`` count live lanes only (a dead lane's rank is
    0); the folds sum the live lanes whose key lies in ``[0, K)``.  The
    kernel adds the sums with float32 atomics, so their last bits vary from
    run to run; the counts are exact.
    """
    _check(keys, counters, cdf)
    if vals.dtype != torch.float32:
        raise TypeError(f"vals must be float32, got {vals.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if vals.shape != keys.shape or valid.shape != keys.shape:
        raise ValueError(f"vals and valid must be [N] like keys, got "
                         f"{tuple(vals.shape)} and {tuple(valid.shape)}")
    if not (vals.device == valid.device == keys.device):
        raise ValueError("vals and valid must share the keys' device")
    if not (vals.is_contiguous() and valid.is_contiguous()):
        raise ValueError("vals and valid must be contiguous")
    if keys.device.type == "cpu":
        return ref.partition_scatter_fold(keys, counters, vals, valid, cdf)
    n = keys.numel()
    num_keys, num_workers = cdf.shape
    dev = keys.device
    fold_counts = torch.empty(num_keys, dtype=torch.int32, device=dev)
    fold_sums = torch.empty(num_keys, dtype=torch.float32, device=dev)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return (empty, empty.clone(),
                torch.zeros(num_workers, dtype=torch.int32, device=dev),
                fold_counts.zero_(), fold_sums.zero_())
    lib = _library()
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty(num_workers, dtype=torch.int32, device=dev)
    scratch = torch.empty(num_workers * -(-n // TILE_RECORDS),
                          dtype=torch.int32, device=dev)
    code = lib.repro_partition_scatter_fold(
        keys.data_ptr(), counters.data_ptr(), vals.data_ptr(),
        valid.view(torch.uint8).data_ptr(), cdf.data_ptr(), dest.data_ptr(),
        rank.data_ptr(), hist.data_ptr(), fold_counts.data_ptr(),
        fold_sums.data_ptr(), scratch.data_ptr(), n, num_keys, num_workers,
        *_build.device_and_stream(dev))
    _build.raise_on(lib, code, "partition_scatter_fold")
    partition_scatter_fold.launches += 1
    return dest, rank, hist, fold_counts, fold_sums


def partition(keys: torch.Tensor, counters: torch.Tensor,
              cdf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dest [N] int32, hist [W] int32) of one chunk."""
    _check(keys, counters, cdf)
    if keys.device.type == "cpu":
        return ref.partition(keys, counters, cdf)
    n = keys.numel()
    num_keys, num_workers = cdf.shape
    dev = keys.device
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(num_workers, dtype=torch.int32, device=dev))
    lib = _library()
    dest = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty(num_workers, dtype=torch.int32, device=dev)
    code = lib.repro_partition(
        keys.data_ptr(), counters.data_ptr(), cdf.data_ptr(),
        dest.data_ptr(), hist.data_ptr(), n, num_keys, num_workers,
        *_build.device_and_stream(dev))
    _build.raise_on(lib, code, "partition")
    partition.launches += 1
    return dest, hist


partition_scatter.launches = 0
partition_scatter_fold.launches = 0
partition.launches = 0
