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
All three are one launch a call: a chunk of at most :data:`TILE_RECORDS`
records on one block, a longer one in one pass over a workspace that is
allocated once per device and stream (and grown when a call needs more).
Each call's outputs are views of one int32 buffer.

Inputs: ``keys`` and ``counters`` are int32 ``[N]`` (K2 also takes int64,
wrapped mod 2^32 as ``.to(torch.int32)`` does, and ``counters=None`` for
all zero); ``cdf`` is the float32 ``[K, W]`` row-CDF
(``RoutingTable.cdf32`` or :func:`repro_torch.core.ops.saturated_cdf32`),
all contiguous and on one device.  ``W`` is at most :data:`MAX_WORKERS`.
The Pallas wrappers take ``weights`` and derive the CDF; here the caller
passes the CDF so it is uploaded once per table version and not once per
chunk.

The kernels find ``dest = #{w : u >= cdf[key, w]}`` by binary search over
the row, which needs ``{w : cdf[w] <= u}`` to be a prefix of every row.
That holds for the tables above: made from non-negative weights, their
unsaturated entries are sequential float32 sums that never decrease, the
entries from a row's last positive column on are 1.0, and ``u < 1``.  A row
need not be non-decreasing (a partial sum may round above 1 before the
last positive column, then 1.0 follows), and that is fine.  For a table of
any other kind the kernels and the plain versions may disagree.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import _build, ref

#: Largest worker count the kernels take (shared-memory layout).
MAX_WORKERS = 1024
#: Records a tile of the kernels (256 threads x 16); a chunk of at most
#: this many runs on one block.
TILE_RECORDS = 4096

_lib = None
#: The multi-tile workspace of the kernels per (device, stream): int64
#: words, zeroed once (the kernels leave it ready for the next call).
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("partition")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.repro_partition_scatter.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.repro_partition_scatter.restype = i32
        lib.repro_partition_scatter_fold.argtypes = (
            [ptr, i32] * 3 + [ptr] * 4 + [i32] * 4 + [ptr])
        lib.repro_partition_scatter_fold.restype = i32
        lib.repro_partition.argtypes = [ptr] * 5 + [i32] * 4 + [ptr]
        lib.repro_partition.restype = i32
        lib.repro_partition_empty.argtypes = [i32, ptr]
        lib.repro_partition_empty.restype = i32
        for fn in ("repro_partition_max_workers",
                   "repro_partition_tile_records",
                   "repro_partition_one_tile_records"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        if (lib.repro_partition_max_workers() != MAX_WORKERS
                or lib.repro_partition_tile_records() != TILE_RECORDS
                or lib.repro_partition_one_tile_records() != TILE_RECORDS):
            raise RuntimeError("csrc/partition.cu disagrees with "
                               "MAX_WORKERS / TILE_RECORDS")
        _lib = lib
    return _lib


def workspace(n: int, num_workers: int, index: int, stream: int,
              one_tile: int = TILE_RECORDS) -> Optional[int]:
    """Address of the multi-tile workspace for a call of ``n`` records on
    (device ``index``, ``stream``), or None when the call runs on one block
    (``n <= one_tile``)."""
    if n <= one_tile:
        return None
    # The header (four uint32), K3's [MAX_WORKERS] uint32 accumulator, and
    # K1's and K2's status words, one a worker a tile.
    words = 2 + MAX_WORKERS // 2 + num_workers * -(-n // TILE_RECORDS)
    ws = _WORKSPACE.get((index, stream))
    if ws is None or ws.numel() < words:
        ws = _WORKSPACE[(index, stream)] = torch.zeros(
            words, dtype=torch.int64, device=torch.device("cuda", index))
    return ws.data_ptr()


def _check(keys: torch.Tensor, counters: Optional[torch.Tensor],
           cdf: torch.Tensor, ints=(torch.int32,)) -> torch.device:
    """The checks the three wrappers share; returns the call's device.
    ``ints`` are the key and counter dtypes taken; ``counters`` may be None
    only when int64 is among them (K2)."""
    if keys.dtype not in ints or (
            counters.dtype not in ints if counters is not None
            else torch.int64 not in ints):
        raise TypeError(f"keys and counters must be {ints}, got "
                        f"{keys.dtype} and "
                        f"{None if counters is None else counters.dtype}")
    if cdf.dtype != torch.float32:
        raise TypeError(f"cdf must be float32, got {cdf.dtype}")
    shape = keys.shape
    if len(shape) != 1 or (counters is not None and counters.shape != shape):
        raise ValueError(f"keys and counters must be [N], got {tuple(shape)}"
                         f" and {None if counters is None else tuple(counters.shape)}")
    if cdf.dim() != 2 or cdf.shape[0] < 1 or cdf.shape[1] < 1:
        raise ValueError(f"cdf must be [K, W] with K, W >= 1, got "
                         f"{tuple(cdf.shape)}")
    if cdf.shape[1] > MAX_WORKERS:
        raise ValueError(f"{cdf.shape[1]} workers exceed the kernels' "
                         f"limit of {MAX_WORKERS}")
    if shape[0] >= 2**31:
        raise ValueError("a chunk must hold fewer than 2^31 records")
    dev = keys.device
    if cdf.device != dev or (counters is not None and counters.device != dev):
        raise ValueError("keys, counters and cdf must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if not (keys.is_contiguous() and cdf.is_contiguous()
            and (counters is None or counters.is_contiguous())):
        raise ValueError("keys, counters and cdf must be contiguous")
    return dev


def partition_scatter(keys: torch.Tensor, counters: torch.Tensor,
                      cdf: torch.Tensor, *, packed: bool = False):
    """(dest [N] int32, rank [N] int32, hist [W] int32) of one chunk, or,
    with ``packed``, the one int32 ``[2 N + W]`` tensor that holds them in
    that order (one copy to the host reads all three).

    ``rank[i] = #{j < i : dest[j] == dest[i]}``.
    """
    dev = _check(keys, counters, cdf)
    n = keys.numel()
    num_keys, num_workers = cdf.shape
    if dev.type == "cpu" or n == 0:
        if n == 0:
            hist = torch.zeros(num_workers, dtype=torch.int32, device=dev)
            out = (hist[:0], hist[:0], hist)
        else:
            out = ref.partition_scatter(keys, counters, cdf)
        return torch.cat(out) if packed else out
    lib = _library()
    index, stream = _build.device_and_stream(dev)
    buf = torch.empty(2 * n + num_workers, dtype=torch.int32, device=dev)
    code = lib.repro_partition_scatter(
        keys.data_ptr(), counters.data_ptr(), cdf.data_ptr(), buf.data_ptr(),
        workspace(n, num_workers, index, stream), n, num_keys, num_workers,
        index, stream)
    _build.raise_on(lib, code, "partition_scatter")
    partition_scatter.launches += 1
    return buf if packed else buf.split_with_sizes((n, n, num_workers))


def partition_scatter_fold(keys: torch.Tensor,
                           counters: Optional[torch.Tensor],
                           vals: torch.Tensor, valid: torch.Tensor,
                           cdf: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """(dest [N] i32, rank [N] i32, hist [W] i32, fold_counts [K] i32,
    fold_sums [K] f32) of one masked chunk.

    ``keys`` and ``counters`` are int32 or int64 (``counters`` None: all
    zero), ``vals`` float32 or float64, each taken as ``.to(torch.int32)``
    / ``.to(torch.float32)`` would make it; ``valid`` is the lane mask,
    ``[N]`` bool or uint8 (one byte a lane, nonzero = live).  ``dest`` is
    computed for every lane; ``rank`` and ``hist`` count live lanes only
    (a dead lane's rank is 0); the folds sum the live lanes whose key lies
    in ``[0, K)``.  The kernel adds the sums with float32 atomics, so their
    last bits vary from run to run; the counts are exact.
    """
    dev = _check(keys, counters, cdf, (torch.int32, torch.int64))
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"vals must be float32 or float64, got {vals.dtype}")
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    if vals.shape != keys.shape or valid.shape != keys.shape:
        raise ValueError(f"vals and valid must be [N] like keys, got "
                         f"{tuple(vals.shape)} and {tuple(valid.shape)}")
    if vals.device != dev or valid.device != dev:
        raise ValueError("vals and valid must share the keys' device")
    if not (vals.is_contiguous() and valid.is_contiguous()):
        raise ValueError("vals and valid must be contiguous")
    n = keys.numel()
    num_keys, num_workers = cdf.shape
    if dev.type == "cpu":
        return ref.partition_scatter_fold(keys, counters, vals, valid, cdf)
    if n == 0:
        z = torch.zeros(num_workers + 2 * num_keys, dtype=torch.int32,
                        device=dev)
        hist, cnt, sums = z.split_with_sizes((num_workers, num_keys,
                                              num_keys))
        return z[:0], z[:0], hist, cnt, sums.view(torch.float32)
    lib = _library()
    index, stream = _build.device_and_stream(dev)
    buf = torch.empty(2 * n + num_workers + 2 * num_keys, dtype=torch.int32,
                      device=dev)
    code = lib.repro_partition_scatter_fold(
        keys.data_ptr(), keys.element_size(),
        None if counters is None else counters.data_ptr(),
        0 if counters is None else counters.element_size(),
        vals.data_ptr(), vals.element_size(), valid.data_ptr(),
        cdf.data_ptr(), buf.data_ptr(),
        workspace(n, num_workers, index, stream), n, num_keys, num_workers,
        index, stream)
    _build.raise_on(lib, code, "partition_scatter_fold")
    partition_scatter_fold.launches += 1
    dest, rank, hist, cnt, sums = buf.split_with_sizes(
        (n, n, num_workers, num_keys, num_keys))
    return dest, rank, hist, cnt, sums.view(torch.float32)


def partition(keys: torch.Tensor, counters: torch.Tensor,
              cdf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dest [N] int32, hist [W] int32) of one chunk."""
    dev = _check(keys, counters, cdf)
    if dev.type == "cpu":
        return ref.partition(keys, counters, cdf)
    n = keys.numel()
    num_keys, num_workers = cdf.shape
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(num_workers, dtype=torch.int32, device=dev))
    lib = _library()
    index, stream = _build.device_and_stream(dev)
    buf = torch.empty(n + num_workers, dtype=torch.int32, device=dev)
    code = lib.repro_partition(
        keys.data_ptr(), counters.data_ptr(), cdf.data_ptr(), buf.data_ptr(),
        workspace(n, num_workers, index, stream), n, num_keys, num_workers,
        index, stream)
    _build.raise_on(lib, code, "partition")
    partition.launches += 1
    return buf.split_with_sizes((n, num_workers))


def launch_floor(dev: torch.device) -> None:
    """Launches the library's empty kernel on ``dev``'s current stream,
    through the same ctypes path as the kernels (their launch floor)."""
    lib = _library()
    _build.raise_on(lib, lib.repro_partition_empty(
        *_build.device_and_stream(dev)), "partition_empty")


partition_scatter.launches = 0
partition_scatter_fold.launches = 0
partition.launches = 0
