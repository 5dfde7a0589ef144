"""GQA attention (llama family) and MLA (DeepSeek-V2, MiniCPM3) with a KV
cache, in PyTorch.

The port of ``repro.models.attention``, its sliding windows included (the
hybrid family's: query ``i`` sees keys ``i - window < j <= i``,
``attention.py:95-96`` and ``:203-204``; ``window=None`` is JAX's full
layer, its 2^30).  Prefill and training attention goes through K5
(:func:`repro_torch.kernels.flash_attention.flash_attention_ad`)
exactly where the JAX model calls its chunked-flash reference
(``attention.py:174``, ``:180``, MLA's expanded path, ``:296``, and the
encdec family's cross attention, ``model.py:238``: :func:`cross_attention`,
full with S != T): a CUDA tensor launches the kernel, a CPU tensor runs its
plain version.  Decode
(one new token against the cache) is plain PyTorch, as in JAX, where no
Pallas kernel covers it: GQA's :func:`decode_attention` and MLA's
weight-absorbed scores against the compressed cache.

Shapes: x ``[B, S, D]``; q ``[B, S, H, hd]`` and k, v ``[B, S, KV, hd]``
inside, as in JAX; K5 takes heads before the sequence.

The GQA cache is a dict of ``k`` and ``v`` ``[B, Tmax, KV, hd]``, MLA's
the compressed ``c_kv`` ``[B, Tmax, kv_lora]`` and ``k_pe`` ``[B, Tmax,
qk_rope]``.  JAX updates a cache functionally (``dynamic_update_slice``);
here :func:`gqa_apply` and :func:`mla_apply` write the new segment in place
and return the same dict, which saves a copy of the whole cache a step.
JAX's ``seq_shard`` is a mesh hint and means nothing on one card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels import flash_attention as k5
from ..kernels import ref as kref
from .layers import (Params, apply_rope, dense_init, scalar_mul,
                     truncated_normal)

NEG_INF = kref.NEG_INF


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, block: int = 1024,
                        scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
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
        causal=causal, scale=1.0, block=block, window=window)
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


def _prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True,
                       window: Optional[int] = None) -> torch.Tensor:
    """Attention through K5 of q ``[B, S, H, hd]`` over k ``[B, T, KV,
    hd]`` and v ``[B, T, KV, dv]`` -> float32 ``[B, S, H, dv]``: a segment
    within itself (causal, or full: the encoder), or with ``causal=False``
    queries against other keys (T != S, :func:`cross_attention`).

    q is scaled by ``hd ** -0.5`` in its own dtype first
    (``attention.py:70``: with hd = 128 the scale is no power of two, so
    where it is applied changes the bits; MLA's scale is ``(qk_nope +
    qk_rope) ** -0.5``, q's width too), and K5 runs with ``scale = 1``.
    K5 reads the ``[B, H, S, hd]`` views of the model's tensors in place,
    through its autograd form (its backward is K5's backward kernel), so
    a forward without a cache is differentiable.  ``window``: a causal
    segment's sliding window (None: full)."""
    qs = scalar_mul(q, q.shape[-1] ** -0.5)
    out = k5.flash_attention_ad(qs.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal, scale=1.0,
                                window=window)
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
    causal: bool = True,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out ``[B, S, D]``, the cache).  With a cache, the segment
    is written at ``cache_len``: a prompt (``cache_len == 0``) attends
    within itself through K5, one token (S = 1) attends to the cache.
    ``causal=False`` (the encoder, which has no cache) lets every position
    see the whole segment; RoPE is applied all the same, as JAX's
    ``gqa_apply`` does.  ``window``: a sliding window (the hybrid family's
    windowed layers), in K5 and in the decode alike."""
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
            out = _prefill_attention(q, k, v, causal=causal, window=window)
        else:
            out = decode_attention(q, cache["k"], cache["v"], offset + S,
                                   window=window)
    else:
        out = _prefill_attention(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, n_heads * head_dim).to(dt)
    return out @ p["wo"].to(dt), cache


def cross_attention(p: Params, x: torch.Tensor, enc_out: torch.Tensor, *,
                    n_heads: int, head_dim: int) -> torch.Tensor:
    """Decoder -> encoder attention (Whisper, JAX's ``_cross_attention``):
    x ``[B, S, D]`` against ``enc_out`` ``[B, enc_seq, D]``, no RoPE, no
    mask; K and V projected from ``enc_out`` on every call, as JAX does, and
    one K5 call, full, S != T (one query row in a decode step)."""
    B, S, _ = x.shape
    dt = x.dtype
    e = enc_out.to(dt)
    q = (x @ p["wq"].to(dt)).reshape(B, S, n_heads, head_dim)
    k = (e @ p["wk"].to(dt)).reshape(B, -1, n_heads, head_dim)
    v = (e @ p["wv"].to(dt)).reshape(B, -1, n_heads, head_dim)
    out = _prefill_attention(q, k, v, causal=False)
    return out.reshape(B, S, n_heads * head_dim).to(dt) @ p["wo"].to(dt)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid_len: int, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attention of a short segment over a (padded) cache buffer.

    q ``[B, S, H, hd]`` (S small), caches ``[B, Tmax, KV, hd]``; positions
    ``>= valid_len`` are masked, and with a ``window`` those at or below a
    query's position less the window.  Float32 ``[B, S, H, hd]``."""
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
    if window is not None:
        mask = mask & (t_pos[None, :] > q_pos[:, None] - window)
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


# --------------------------------------------------------------------- #
# MLA: multi-head latent attention (DeepSeek-V2 / MiniCPM3)              #
# --------------------------------------------------------------------- #
def mla_init(gen: torch.Generator, d_model: int, n_heads: int, *,
             kv_lora: int, qk_nope: int, qk_rope: int, v_head: int,
             q_lora: Optional[int] = None, dtype=torch.float32) -> Params:
    """JAX's ``mla_init`` tree: the latent down-projections ``w_dkv``
    ``[D, kv_lora]`` and ``w_kpe`` ``[D, qk_rope]``, the per-head
    up-projections ``w_uk`` ``[kv_lora, H, qk_nope]`` and ``w_uv``
    ``[kv_lora, H, v_head]``, ``wo``, and ``wq`` or (with ``q_lora``)
    ``w_dq`` and ``w_uq``."""
    q_dim = n_heads * (qk_nope + qk_rope)
    p: Params = {
        "w_dkv": dense_init(gen, d_model, kv_lora, dtype),
        "w_kpe": dense_init(gen, d_model, qk_rope, dtype),
        "w_uk": truncated_normal((kv_lora, n_heads, qk_nope), gen,
                                 std=kv_lora ** -0.5, dtype=dtype),
        "w_uv": truncated_normal((kv_lora, n_heads, v_head), gen,
                                 std=kv_lora ** -0.5, dtype=dtype),
        "wo": dense_init(gen, n_heads * v_head, d_model, dtype,
                         scale=(n_heads * v_head) ** -0.5),
    }
    if q_lora is None:
        p["wq"] = dense_init(gen, d_model, q_dim, dtype)
    else:
        p["w_dq"] = dense_init(gen, d_model, q_lora, dtype)
        p["w_uq"] = dense_init(gen, q_lora, q_dim, dtype)
    return p


def mla_apply(
    p: Params,
    x: torch.Tensor,                      # [B, S, D]
    *,
    n_heads: int,
    kv_lora: int,
    qk_nope: int,
    qk_rope: int,
    v_head: int,
    rope_theta: float = 10_000.0,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_len: int = 0,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """MLA (``repro.models.attention.mla_apply``): returns (out ``[B, S,
    D]``, the cache).  The cache holds the compressed ``c_kv`` and the
    rotated ``k_pe`` only, the segment written at ``cache_len``.

    Without a cache, or for a prompt (``cache_len == 0``), the expanded
    path: per-head ``k_nope`` and ``v`` from the latent, ``k = cat(k_nope,
    k_pe)`` (``k_pe`` shared by the heads), causal attention through K5 at
    ``(dk, dv) = (qk_nope + qk_rope, v_head)``.  One token against a cache
    takes the weight-absorbed path: q mapped into the latent space, float32
    scores against the whole cache buffer, masked past ``cache_len``."""
    B, S, _ = x.shape
    dt = x.dtype
    if "wq" in p:
        q = x @ p["wq"].to(dt)
    else:
        q = (x @ p["w_dq"].to(dt)) @ p["w_uq"].to(dt)
    q = q.reshape(B, S, n_heads, qk_nope + qk_rope)
    q_nope, q_pe = q[..., :qk_nope], q[..., qk_nope:]

    c_kv = x @ p["w_dkv"].to(dt)                              # [B, S, r]
    k_pe = (x @ p["w_kpe"].to(dt)).reshape(B, S, 1, qk_rope)

    offset = 0 if cache is None else int(cache_len)
    positions = (torch.arange(S, device=x.device) + offset)[None, :]
    q_pe = apply_rope(q_pe, positions, rope_theta)
    k_pe = apply_rope(k_pe, positions, rope_theta)[:, :, 0]  # [B, S, rope]
    scale = (qk_nope + qk_rope) ** -0.5

    if cache is not None:
        if offset + S > cache["c_kv"].shape[1]:
            raise ValueError(f"segment [{offset}, {offset + S}) does not fit "
                             f"a cache of {cache['c_kv'].shape[1]}")
        cache["c_kv"][:, offset:offset + S] = c_kv.to(cache["c_kv"].dtype)
        cache["k_pe"][:, offset:offset + S] = k_pe.to(cache["k_pe"].dtype)
        if S > 1 and offset:
            # JAX's expanded path attends such a segment within itself
            # only, as its gqa_apply does; no path of the port writes one.
            raise NotImplementedError(
                "a multi-token segment after a filled cache: the port "
                "prefills a prompt as one segment at 0, so nothing takes "
                "this path")

    if cache is None or S > 1:
        # Expanded path: k_nope and v of the segment from the latent (a
        # product over kv_lora, laid out [B, S, H, d]), then K5.
        k_nope = (c_kv @ p["w_uk"].to(dt).reshape(kv_lora, -1)).reshape(
            B, S, n_heads, qk_nope)
        v = (c_kv @ p["w_uv"].to(dt).reshape(kv_lora, -1)).reshape(
            B, S, n_heads, v_head)
        k_full = torch.cat(
            [k_nope, k_pe[:, :, None].expand(B, S, n_heads, qk_rope)], dim=-1)
        q_full = torch.cat([q_nope, q_pe], dim=-1)
        out = _prefill_attention(q_full, k_full, v)          # [B, S, H, dv]
    else:
        # Absorbed path: q_lat = q_nope W_uk, scored against c_kv directly.
        c_up, pe_up = cache["c_kv"].float(), cache["k_pe"].float()
        q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p["w_uk"].to(dt))
        s = torch.einsum("bshr,btr->bhst", q_lat.float(), c_up)
        s = s + torch.einsum("bshd,btd->bhst", q_pe.float(), pe_up)
        s = s * scale
        t_pos = torch.arange(c_up.shape[1], device=x.device)
        q_pos = offset + torch.arange(S, device=x.device)
        mask = t_pos[None, :] <= q_pos[:, None]
        s = torch.where(mask[None, None], s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", w, c_up)
        out = torch.einsum("bshr,rhd->bshd", o_lat, p["w_uv"].float())
    out = out.reshape(B, S, n_heads * v_head).to(dt)
    return out @ p["wo"].to(dt), cache


def mla_cache_init(batch: int, max_len: int, kv_lora: int, qk_rope: int,
                   dtype=torch.bfloat16,
                   device=None) -> Dict[str, torch.Tensor]:
    return {
        "c_kv": torch.zeros((batch, max_len, kv_lora), dtype=dtype,
                            device=device),
        "k_pe": torch.zeros((batch, max_len, qk_rope), dtype=dtype,
                            device=device),
    }
