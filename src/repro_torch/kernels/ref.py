"""Plain PyTorch versions of the hand-written kernels.

The counterpart of ``repro.kernels.ref`` for the kernels ported so far.
:mod:`repro_torch.kernels.partition` runs these for CPU tensors (the tests)
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They repeat the kernels' arithmetic and are no yardstick of speed: the
row gather materializes ``[N, W]``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.ops import ld_thresholds, within_dest_ranks


def partition(keys: torch.Tensor, counters: torch.Tensor,
              cdf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing-table partition: (dest [N] int32, histogram [W] int32).

    ``dest = #{w : u(counter) >= cdf[key, w]}`` clipped to ``W - 1``; keys
    outside ``[0, K)`` are clamped into range, as the kernel does.
    """
    num_keys, num_workers = cdf.shape
    u = ld_thresholds(counters)
    rows = cdf[keys.to(torch.int64).clamp(0, num_keys - 1)]
    dest = (u[:, None] >= rows).sum(dim=1).clamp_(max=num_workers - 1)
    hist = torch.bincount(dest, minlength=num_workers)
    return dest.to(torch.int32), hist.to(torch.int32)


def partition_scatter(keys: torch.Tensor, counters: torch.Tensor,
                      cdf: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused exchange: (dest [N], within-destination rank [N], hist [W]).

    ``rank[i] = #{j < i : dest[j] == dest[i]}`` from a stable sort, so
    ``exclusive_cumsum(hist)[dest] + rank`` groups the chunk by
    destination in arrival order.
    """
    dest, hist = partition(keys, counters, cdf)
    return dest, within_dest_ranks(dest, cdf.shape[1]), hist


def partition_scatter_fold(keys: torch.Tensor, counters: torch.Tensor,
                           vals: torch.Tensor, valid: torch.Tensor,
                           cdf: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Fused exchange + per-key fold over the live lanes of a masked chunk:
    (dest [N], rank [N], hist [W], fold_counts [K] int32, fold_sums [K]
    float32).

    ``dest`` by :func:`partition` for every lane; ``rank`` and ``hist``
    count live lanes only (dead lanes get rank 0); the folds count and sum
    (in float32, with ``index_add_``) the live lanes whose key lies in
    ``[0, K)``.
    """
    num_keys, num_workers = cdf.shape
    dest, _ = partition(keys, counters, cdf)
    live = valid.to(torch.bool)
    lanes = live.to(torch.int32)
    hist = torch.zeros(num_workers, dtype=torch.int32, device=keys.device)
    hist.index_add_(0, dest.to(torch.int64), lanes)
    rank = within_dest_ranks(dest, num_workers, valid=lanes) * lanes
    k64 = keys.to(torch.int64)
    inr = live & (k64 >= 0) & (k64 < num_keys)
    slot = torch.where(inr, k64, 0)
    cnt = torch.zeros(num_keys, dtype=torch.int32, device=keys.device)
    cnt.index_add_(0, slot, inr.to(torch.int32))
    sums = torch.zeros(num_keys, dtype=torch.float32, device=keys.device)
    sums.index_add_(0, slot, torch.where(inr, vals, 0.0))
    return dest, rank, hist, cnt, sums
