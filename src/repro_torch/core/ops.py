"""Tensor twins of the routing-table operations (plain PyTorch).

Counterpart of ``repro.core.ops`` (jnp).  Each function runs on the device
of its input tensors and gives bit-identical results to the host rule of
:mod:`repro_torch.core.partitioner` on either device:

* the Weyl threshold is exact 32-bit wrapping arithmetic, carried out in
  int64 without relying on overflow;
* the row-CDF is a sequential float32 sum over columns (``torch.cumsum``
  may accumulate in double on the CPU or in another order on the card);
* within-group ranks come from a stable sort, O(n log n) time and O(n)
  memory (a one-hot cumsum would need ``[n, W]``).
"""
from __future__ import annotations

from typing import Optional

import torch

from .partitioner import GOLDEN_FIX

_GOLDEN = int(GOLDEN_FIX)          # frac(phi) * 2^32 as an unsigned value
_MASK32 = 0xFFFFFFFF
_U24_SCALE = float(1.0 / (1 << 24))


def ld_thresholds(counters: torch.Tensor) -> torch.Tensor:
    """Fixed-point Weyl threshold u in [0, 1) per record, exact in float32.

    Bit-identical to :func:`repro_torch.core.partitioner.ld_thresholds`:
    ``((c + 1) * GOLDEN_FIX mod 2^32) >> 8`` scaled by 2^-24.  The product
    is split into 16-bit halves so no int64 intermediate overflows.
    """
    c = (counters.to(torch.int64) + 1) & _MASK32
    lo = c & 0xFFFF
    hi = c >> 16
    bits = (lo * _GOLDEN + ((hi * _GOLDEN) & 0xFFFF) * 65536) & _MASK32
    return (bits >> 8).to(torch.float32) * _U24_SCALE


def saturated_cdf32(weights: torch.Tensor) -> torch.Tensor:
    """Twin of :func:`repro_torch.core.partitioner.routing_cdf32`.

    Float32 row-CDF, summed column by column in float32 (the order numpy
    uses), with entries saturated to 1.0 from each row's last
    positive-weight column onward.
    """
    w = weights.to(torch.float32)
    num_workers = w.shape[1]
    cdf = torch.empty_like(w)
    acc = w[:, 0].clone()
    cdf[:, 0] = acc
    for j in range(1, num_workers):
        acc = acc + w[:, j]
        cdf[:, j] = acc
    positive = (weights > 0).flip(1).to(torch.uint8)
    last = num_workers - 1 - torch.argmax(positive, dim=1)
    cols = torch.arange(num_workers, device=w.device)
    return torch.where(cols[None, :] >= last[:, None],
                       torch.ones((), dtype=torch.float32, device=w.device),
                       cdf)


def route_records(
    weights: torch.Tensor, keys: torch.Tensor, counters: torch.Tensor,
    cdf: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Destination worker per record (int32) by the canonical rule.

    ``dest = #{w : u(counter) >= cdf[key, w]}`` clipped to the last
    worker; ``cdf`` defaults to :func:`saturated_cdf32` of ``weights``.
    """
    u = ld_thresholds(counters)
    if cdf is None:
        cdf = saturated_cdf32(weights)
    rows = cdf.to(torch.float32)[keys.to(torch.int64)]
    dest = (u[:, None] >= rows).sum(dim=1)
    return dest.clamp_(max=weights.shape[1] - 1).to(torch.int32)


def _segment_ranks(groups: torch.Tensor,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``#{j < i : groups[j] == groups[i] and live[j]}`` per record (int32)."""
    n = groups.numel()
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=groups.device)
    order = torch.sort(groups.to(torch.int64), stable=True).indices
    g = groups.to(torch.int64)[order]
    starts = torch.ones(n, dtype=torch.bool, device=groups.device)
    starts[1:] = g[1:] != g[:-1]
    pos = torch.arange(n, device=groups.device)
    seg_start = torch.cummax(torch.where(starts, pos, 0), dim=0).values
    if live is None:
        sorted_ranks = pos - seg_start
    else:
        lv = live[order].to(torch.int64)
        before = torch.cumsum(lv, dim=0) - lv
        sorted_ranks = before - before[seg_start]
    ranks = torch.empty_like(sorted_ranks)
    ranks[order] = sorted_ranks
    return ranks.to(torch.int32)


def within_dest_ranks(dest: torch.Tensor, num_workers: int,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Within-destination arrival rank per record (the counting scatter).

    ``ranks[i] = #{j < i : dest[j] == dest[i]}`` (live ``j`` only when
    ``valid`` is given), so ``exclusive_cumsum(hist)[dest] + ranks`` is the
    stable destination-grouped position of every record.  ``num_workers``
    is kept for signature parity with the jnp twin; the sort does not need
    it.
    """
    del num_workers
    return _segment_ranks(dest, None if valid is None else valid != 0)


def per_key_counters(keys: torch.Tensor, num_keys: int) -> torch.Tensor:
    """Running per-key occurrence index: ``#{j < i : keys[j] == keys[i]}``."""
    del num_keys
    return _segment_ranks(keys)


def worker_load_from_routing(
    weights: torch.Tensor, key_counts: torch.Tensor
) -> torch.Tensor:
    """Expected tuples per worker given per-key counts (workload metric)."""
    return key_counts.to(weights.dtype) @ weights


def queue_sizes(received: torch.Tensor, processed: torch.Tensor) -> torch.Tensor:
    """phi_w = unprocessed-queue size (paper's workload metric, §2.1)."""
    return torch.clamp(received - processed, min=0)
