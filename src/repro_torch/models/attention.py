"""GQA attention (llama family) with a KV cache, in PyTorch.

The port of the GQA half of ``repro.models.attention``.  Prefill and training
attention goes through K5
(:func:`repro_torch.kernels.flash_attention.flash_attention_ad`)
exactly where the JAX model calls its chunked-flash reference
(``attention.py:174`` and ``:180``): a CUDA tensor launches the kernel, a
CPU tensor runs its plain version.  Decode (one new token against the
cache) is plain PyTorch, as in JAX, where no Pallas kernel covers it.
MLA and sliding windows are not ported yet.

Shapes: x ``[B, S, D]``; q ``[B, S, H, hd]`` and k, v ``[B, S, KV, hd]``
inside, as in JAX; K5 takes heads before the sequence.

The cache is a dict of ``k`` and ``v`` ``[B, Tmax, KV, hd]``.  JAX updates
it functionally (``dynamic_update_slice``); here :func:`gqa_apply` writes
the new segment in place and returns the same dict, which saves a copy of
the whole cache a step.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import flash_attention as k5
from ..kernels import ref as kref
from .layers import Params, apply_rope, dense_init, scalar_mul

NEG_INF = kref.NEG_INF


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, block: int = 1024,
                        scale: Optional[float] = None) -> torch.Tensor:
    """The plain form of the model's attention: q ``[B, S, H, hd]``, k, v
    ``[B, T, KV, hd]`` -> float32 ``[B, S, H, dv]``.

    As ``repro.models.attention.flash_attention_ref`` with ``q_offset = 0``
    (the only offset the port's model uses): q is scaled in its own dtype
    and then cast to float32, and an online softmax runs over KV blocks of
    ``block`` keys.
    """
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    qs = scalar_mul(q, scale).float()
    out = kref.flash_attention(
        qs.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, scale=1.0, block=block)
    return out.transpose(1, 2)


def gqa_init(gen: torch.Generator, d_model: int, n_heads: int, n_kv: int,
             head_dim: int, dtype=torch.float32) -> Params:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype),
        "wk": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wv": dense_init(gen, d_model, n_kv * head_dim, dtype),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype,
                         scale=(n_heads * head_dim) ** -0.5),
    }


def _prefill_attention(q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor) -> torch.Tensor:
    """Causal attention of a segment within itself through K5: q
    ``[B, S, H, hd]``, k, v ``[B, S, KV, hd]`` -> float32 ``[B, S, H, hd]``.

    q is scaled in its own dtype first (``attention.py:70``: with
    hd = 128 the scale is no power of two, so where it is applied changes
    the bits), and K5 runs with ``scale = 1``.  K5 reads the
    ``[B, H, S, hd]`` views of the model's tensors in place, through its
    autograd form (its backward is K5's backward kernel), so a forward
    without a cache is differentiable."""
    qs = scalar_mul(q, q.shape[-1] ** -0.5)
    out = k5.flash_attention_ad(qs.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True, scale=1.0)
    return out.transpose(1, 2)


def gqa_apply(
    p: Params,
    x: torch.Tensor,                      # [B, S, D]
    *,
    n_heads: int,
    n_kv: int,
    head_dim: int,
    rope_theta: float = 10_000.0,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out ``[B, S, D]``, the cache).  With a cache, the segment
    is written at ``cache_len``: a prompt (``cache_len == 0``) attends
    within itself through K5, one token (S = 1) attends to the cache."""
    B, S, _ = x.shape
    dt = x.dtype
    q = (x @ p["wq"].to(dt)).reshape(B, S, n_heads, head_dim)
    k = (x @ p["wk"].to(dt)).reshape(B, S, n_kv, head_dim)
    v = (x @ p["wv"].to(dt)).reshape(B, S, n_kv, head_dim)

    offset = 0 if cache is None else int(cache_len)
    positions = (torch.arange(S, device=x.device) + offset)[None, :]
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)

    if cache is not None:
        if offset + S > cache["k"].shape[1]:
            raise ValueError(f"segment [{offset}, {offset + S}) does not fit "
                             f"a cache of {cache['k'].shape[1]}")
        cache["k"][:, offset:offset + S] = k.to(cache["k"].dtype)
        cache["v"][:, offset:offset + S] = v.to(cache["v"].dtype)
        if S > 1:
            if offset:
                # JAX's gqa_apply attends such a segment within itself
                # only (q_offset = offset), which its two-segment vlm
                # prefill meets; the port's vlm prefill is one segment at
                # 0, so no path of the port writes one.
                raise NotImplementedError(
                    "a multi-token segment after a filled cache: the port "
                    "prefills the vlm family's patches and text as one "
                    "segment at 0, so nothing takes this path")
            out = _prefill_attention(q, k, v)
        else:
            out = decode_attention(q, cache["k"], cache["v"], offset + S)
    else:
        out = _prefill_attention(q, k, v)
    out = out.reshape(B, S, n_heads * head_dim).to(dt)
    return out @ p["wo"].to(dt), cache


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: int) -> torch.Tensor:
    """Attention of a short segment over a (padded) cache buffer.

    q ``[B, S, H, hd]`` (S small), caches ``[B, Tmax, KV, hd]``; positions
    ``>= valid_len`` are masked.  Float32 ``[B, S, H, hd]``."""
    B, S, H, hd = q.shape
    KV = k_cache.shape[2]
    rep = H // KV
    k = k_cache.repeat_interleave(rep, dim=2) if rep > 1 else k_cache
    v = v_cache.repeat_interleave(rep, dim=2) if rep > 1 else v_cache
    s = torch.einsum("bshd,bthd->bhst", scalar_mul(q, hd ** -0.5).float(),
                     k.float())
    t_pos = torch.arange(k.shape[1], device=q.device)
    q_pos = valid_len - S + torch.arange(S, device=q.device)
    mask = t_pos[None, :] <= q_pos[:, None]
    s = torch.where(mask[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhst,bthd->bhsd", w, v.float())
    return out.transpose(1, 2)


def gqa_cache_init(batch: int, max_len: int, n_kv: int, head_dim: int,
                   dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    return {
        "k": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, max_len, n_kv, head_dim), dtype=dtype,
                         device=device),
    }
