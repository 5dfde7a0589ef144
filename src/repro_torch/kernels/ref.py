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
