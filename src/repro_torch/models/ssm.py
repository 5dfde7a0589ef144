"""RWKV6 ("Finch") time-mix and channel-mix, and the Mamba head of the
hybrid family, in PyTorch.

The port of ``repro.models.ssm``.  Its RWKV6 half (arXiv:2404.05892,
simplified but recurrence-faithful): per head, with a data-dependent decay
``w_t = exp(-exp(w0 + tanh(x W_a) W_b))``,

    state_t = diag(w_t) state_{t-1} + k_t^T v_t
    o_t     = r_t (state_{t-1} + diag(u) k_t^T v_t)

Where the JAX layer runs the recurrence with ``lax.scan`` (``ssm.py:99-110``)
the port makes one call of K6
(:func:`repro_torch.kernels.rwkv_scan.rwkv_scan_ad`, through its module; it
calls the module's ``rwkv_scan``, so a recorder can stand in for it, and
takes K6's backward, ``rwkv_scan_bwd``, where JAX differentiates the scan)
on r, k and v in the compute dtype and the float32 w, passed as
``[B, H, S, hd]`` views of the ``[B, S, D]`` activations.  K6 widens each value to float32 as it reads it, which gives
exactly JAX's casts (``ssm.py:95-97``), and writes ``out`` in r's dtype
(one rounding of the float32 sum, as JAX's ``.astype``) and in that
layout, so no cast and no copy goes in or out.
Every bf16 rounding of the JAX layer is kept: the decay's ``w0 + tanh(.)
W_b`` in the compute dtype and its ``exp(-exp(.))`` in float32, the RMS
``ln_x`` over all of D cast back before the ``ln_x`` product.  Decode
carries ``{"wkv", "shift"}`` (O(1) state per token).

The Mamba half (``ssm.py:162-207``, Hymba's selective-SSM head):
:func:`mamba_init` (``a_log = log(1 .. N)`` on every channel, as JAX's) and
:func:`mamba_apply`, whose three projections (the step size ``delta =
softplus(x W_dt + dt_bias)`` through :func:`repro_torch.models.layers.
softplus`, JAX's bf16 bits, and B and C) stay plain products cast to
float32, as JAX computes them outside any kernel, and whose ``lax.scan``
(``:193-206``) is one call of K7
(:func:`repro_torch.kernels.mamba_scan.mamba_scan_ad`, through its module,
so a recorder can stand in for it; its backward is K7's backward kernel).
With a state (the serve's cache, float32 ``[B, d_inner, N]``) it returns
the state after the segment.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import mamba_scan as k7
from ..kernels import rwkv_scan as k6
from .layers import Params, dense_init, silu, softplus


# --------------------------------------------------------------------- #
# RWKV6 time-mix                                                         #
# --------------------------------------------------------------------- #
def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    out = torch.empty(shape, dtype=torch.float32, device=gen.device)
    return out.normal_(0.0, 1.0, generator=gen)


def rwkv6_init(gen: torch.Generator, d_model: int, n_heads: int,
               dtype=torch.float32) -> Params:
    hd = d_model // n_heads
    dev = gen.device

    def half():
        return torch.full((d_model,), 0.5, dtype=dtype, device=dev)

    return {
        # token-shift mixing coefficients (per channel)
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "wr": dense_init(gen, d_model, d_model, dtype),
        "wk": dense_init(gen, d_model, d_model, dtype),
        "wv": dense_init(gen, d_model, d_model, dtype),
        "wg": dense_init(gen, d_model, d_model, dtype),
        # data-dependent decay: low-rank  w_t = w0 + tanh(x W_a) W_b
        "w0": (_normal(gen, (d_model,)) * 0.1 - 6.0).to(dtype),
        "w_a": dense_init(gen, d_model, 64, dtype),
        "w_b": dense_init(gen, 64, d_model, dtype, scale=0.01),
        "u": (_normal(gen, (n_heads, hd)) * 0.1).to(dtype),
        "wo": dense_init(gen, d_model, d_model, dtype),
        "ln_x": torch.ones((d_model,), dtype=dtype, device=dev),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """x_{t-1} per position; ``last`` is the carry for decode ([B,1,D])."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([last.to(x.dtype), x[:, :-1]], dim=1)


def _heads(x: torch.Tensor, B: int, S: int, H: int, hd: int) -> torch.Tensor:
    """``[B, S, H * hd]`` -> ``[B, H, S, hd]``, a view (K6 reads its
    strides)."""
    return x.view(B, S, H, hd).transpose(1, 2)


def rwkv6_apply(
    p: Params,
    x: torch.Tensor,                          # [B, S, D]
    *,
    n_heads: int,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Returns (out, new_state).  ``state`` = {"wkv": [B,H,hd,hd],
    "shift": [B,1,D]} enables O(1) decode."""
    B, S, D = x.shape
    H = n_heads
    hd = D // H
    dt = x.dtype

    last = None if state is None else state["shift"]
    xprev = _token_shift(x, last)

    def mix(mu):
        return x + (xprev - x) * mu.to(dt)

    r = mix(p["mu_r"]) @ p["wr"].to(dt)
    k = mix(p["mu_k"]) @ p["wk"].to(dt)
    v = mix(p["mu_v"]) @ p["wv"].to(dt)
    g = silu(mix(p["mu_g"]) @ p["wg"].to(dt))

    # data-dependent decay (Finch): w_t in (0,1), per channel
    wlin = p["w0"].to(dt) + torch.tanh(mix(p["mu_w"]) @ p["w_a"].to(dt)) \
        @ p["w_b"].to(dt)
    w = torch.exp(-torch.exp(wlin.float()))                    # [B,S,D]

    wkv0 = None if state is None else state["wkv"].float()
    # r, k and v in the compute dtype and w in float32, as they come: K6
    # widens each value as it reads it and writes out in r's dtype; its
    # backward writes the gradients in the views' layout.
    out, wkv_fin = k6.rwkv_scan_ad(
        *(_heads(t, B, S, H, hd) for t in (r, k, v, w)),
        p["u"].float().contiguous(), wkv0)
    out = out.transpose(1, 2).reshape(B, S, D)

    # per-head groupnorm (ln_x simplified to RMS over channel)
    o32 = out.float()
    out = (o32 * torch.rsqrt((o32 * o32).mean(dim=-1, keepdim=True) + 1e-6)
           ).to(dt) * p["ln_x"].to(dt)
    out = (out * g) @ p["wo"].to(dt)

    new_state = None
    if state is not None:
        new_state = {"wkv": wkv_fin.to(state["wkv"].dtype),
                     "shift": x[:, -1:, :].to(state["shift"].dtype)}
    return out, new_state


def rwkv6_state_init(batch: int, d_model: int, n_heads: int,
                     dtype=torch.float32, device=None
                     ) -> Dict[str, torch.Tensor]:
    hd = d_model // n_heads
    return {
        "wkv": torch.zeros((batch, n_heads, hd, hd), dtype=dtype,
                           device=device),
        "shift": torch.zeros((batch, 1, d_model), dtype=dtype, device=device),
    }


# --------------------------------------------------------------------- #
# RWKV6 channel-mix (the FFN half of an RWKV block)                      #
# --------------------------------------------------------------------- #
def rwkv6_cmix_init(gen: torch.Generator, d_model: int, d_ff: int,
                    dtype=torch.float32) -> Params:
    return {
        "mu_k": torch.full((d_model,), 0.5, dtype=dtype, device=gen.device),
        "wk": dense_init(gen, d_model, d_ff, dtype),
        "wv": dense_init(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5),
    }


def rwkv6_cmix_apply(p: Params, x: torch.Tensor,
                     last: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    dt = x.dtype
    xprev = _token_shift(x, last)
    xk = x + (xprev - x) * p["mu_k"].to(dt)
    h = torch.square(F.relu(xk @ p["wk"].to(dt)))
    out = h @ p["wv"].to(dt)
    new_last = None if last is None else x[:, -1:, :].to(last.dtype)
    return out, new_last


# --------------------------------------------------------------------- #
# Mamba-style selective SSM head (for Hymba)                             #
# --------------------------------------------------------------------- #
def mamba_init(gen: torch.Generator, d_inner: int, d_state: int,
               dtype=torch.float32) -> Params:
    dev = gen.device
    a_log = torch.log(torch.arange(1, d_state + 1, dtype=torch.float32,
                                   device=dev))
    return {
        # diagonal A (negative for stability), learned in log space
        "a_log": a_log[None, :].repeat(d_inner, 1).to(dtype),
        "w_dt": dense_init(gen, d_inner, d_inner, dtype, scale=0.01),
        "dt_bias": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_b": dense_init(gen, d_inner, d_state, dtype),
        "w_c": dense_init(gen, d_inner, d_state, dtype),
        "d_skip": torch.ones((d_inner,), dtype=dtype, device=dev),
    }


def mamba_apply(
    p: Params,
    x: torch.Tensor,                          # [B, S, d_inner]
    *,
    state: Optional[torch.Tensor] = None,     # [B, d_inner, d_state]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (y ``[B, S, d_inner]`` in x's dtype, the new state or None
    without one).  ``a = -exp(a_log)``, ``delta``, B and C in float32 as
    JAX makes them; the recurrence and ``y = h . C + x d_skip`` in K7."""
    dt = x.dtype
    a = -torch.exp(p["a_log"].float())
    delta = softplus(x @ p["w_dt"].to(dt) + p["dt_bias"].to(dt)).float()
    bmat = (x @ p["w_b"].to(dt)).float()
    cmat = (x @ p["w_c"].to(dt)).float()
    h0 = None if state is None else state.float().contiguous()
    y, h_fin = k7.mamba_scan_ad(x.contiguous(), delta, bmat, cmat, a,
                                p["d_skip"].float().contiguous(), h0)
    new_state = None if state is None else h_fin.to(state.dtype)
    return y, new_state
