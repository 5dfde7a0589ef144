"""Plain PyTorch versions of the hand-written kernels.

The counterpart of ``repro.kernels.ref`` for the kernels ported so far.
:mod:`repro_torch.kernels.partition` runs these for CPU tensors (the tests)
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They repeat the kernels' arithmetic and are no yardstick of speed: the
row gather materializes ``[N, W]``, the grouped matmul upcasts its inputs
to float32, attention materializes a ``[S, block]`` score tile per
head, and the RWKV6 scan walks T in Python with a few ops a step.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def partition_scatter_fold(keys: torch.Tensor,
                           counters: Optional[torch.Tensor],
                           vals: torch.Tensor, valid: torch.Tensor,
                           cdf: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Fused exchange + per-key fold over the live lanes of a masked chunk:
    (dest [N], rank [N], hist [W], fold_counts [K] int32, fold_sums [K]
    float32).

    Wide columns are cast first: int64 keys and counters wrap to int32,
    float64 vals round to float32, and ``counters=None`` is all zero.
    ``dest`` by :func:`partition` for every lane; ``rank`` and ``hist``
    count live lanes only (dead lanes get rank 0); the folds count and sum
    (in float32, with ``index_add_``) the live lanes whose key lies in
    ``[0, K)``.
    """
    keys = keys.to(torch.int32)
    counters = (torch.zeros_like(keys) if counters is None
                else counters.to(torch.int32))
    vals = vals.to(torch.float32)
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


def segment_matmul(x: torch.Tensor, w: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped expert matmul ``x [E, C, D] @ w [E, D, F] -> [E, C, F]``,
    accumulated in float32 and rounded once to ``x.dtype``.  With ``rows``
    (``[E]``), rows ``r >= rows[e]`` of ``out[e]`` are zero, whatever x
    holds there."""
    out = torch.bmm(x.float(), w.float())
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < rows.to(x.device, torch.int64)[:, None])
        out = torch.where(live[..., None], out, 0.0)
    return out.to(x.dtype)


#: The mask value of the reference's attention (not -inf).
NEG_INF = -2.0 ** 30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV blocks, float32 ``[B, H, S, dv]``.

    q ``[B, H, S, hd]``; k ``[B, KV, T, hd]`` and v ``[B, KV, T, dv]`` with
    ``H`` a multiple of ``KV`` (query head ``h`` reads KV head
    ``h // (H // KV)``).  q is cast to float32 and then scaled (``scale``
    defaults to ``hd ** -0.5``); when causal, query ``i`` sees keys
    ``j <= i``.
    Masked scores take :data:`NEG_INF`; the output is
    ``acc / max(l, 1e-20)``, as in ``repro.models.attention`` and the
    Pallas kernel.  Blocks wholly above the diagonal change nothing and
    are skipped.
    """
    B, H, S, hd = q.shape
    KV, T, dv = k.shape[1], k.shape[2], v.shape[-1]
    rep = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    q_pos = torch.arange(S, device=q.device)
    acc = torch.zeros((B, H, S, dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    for start in range(0, T, block):
        if causal and start > S - 1:
            break
        kb, vb = kf[:, :, start:start + block], vf[:, :, start:start + block]
        s = torch.einsum("bhsd,bhtd->bhst", qf, kb)
        if causal:
            kv_pos = torch.arange(start, start + kb.shape[2], device=q.device)
            s = torch.where(kv_pos[None, :] <= q_pos[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bhtd->bhsd", p, vb)
        m = m_new
    return acc / torch.clamp(l, min=1e-20)[..., None]


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 recurrence, ``repro.kernels.ref.rwkv_scan``: r, k, v, w
    ``[B, H, T, hd]``, u ``[H, hd]``, state0 ``[B, H, hd, hd]`` (zeros when
    None).  In float32, one step at a time:

        out_t = r_t (S + diag(u) k_t v_t^T)
        S     = diag(w_t) S + k_t v_t^T

    Returns (out ``[B, H, T, hd]`` in ``r.dtype``, the final state
    ``[B, H, hd, hd]`` float32).
    """
    B, H, T, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[..., None]                                  # [H, hd, 1]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float().clone())
    out = torch.empty((B, H, T, hd), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]       # [B, H, hd, hd]
        out[:, :, t] = torch.einsum("bhk,bhkv->bhv", rf[:, :, t], s + uf * kv)
        s = wf[:, :, t, :, None] * s + kv
    return out.to(r.dtype), s
