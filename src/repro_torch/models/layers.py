"""Core neural layers in PyTorch (params = nested dicts of tensors).

The port of ``repro.models.layers`` (the serving and training paths).  The same
conventions: parameters are stored in ``param_dtype`` (float32 by default)
and cast to ``compute_dtype`` (bf16) inside the forward pass; every
``apply``-style function is pure and shape-polymorphic over batch and
sequence.  Layers are not stacked for a scan: the model keeps a list of
per-layer dicts and loops over it.

Initializers draw from an explicit ``torch.Generator`` with the JAX
package's distributions.  The two frameworks give different numbers from
the same seed; tests carry weights across with
:func:`repro_torch.models.convert.params_from_jax`.

A Python float times a tensor is computed by PyTorch in float32 and then
rounded, where JAX first rounds the float to the tensor's dtype;
:func:`scalar_mul` does the JAX thing, so bf16 results match.  It keeps
the rounded constant a Python float: a tensor built from it on the card
would be a host-to-device copy, which waits for the stream, on every call.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_SQRT2 = math.sqrt(2.0)


def truncated_normal(shape, gen: torch.Generator, *, std: float = 1.0,
                     dtype=torch.float32) -> torch.Tensor:
    """``std`` times a standard normal truncated to [-3, 3]
    (``jax.random.truncated_normal(key, -3, 3, shape) * std``), by inverse
    CDF sampling on the generator's device."""
    lo, hi = math.erf(-3.0 / _SQRT2), math.erf(3.0 / _SQRT2)
    u = torch.empty(shape, dtype=torch.float32, device=gen.device)
    u.uniform_(lo, hi, generator=gen)
    return (u.erfinv_().mul_(_SQRT2).clamp_(-3.0, 3.0)
            .mul_(std).to(dtype))


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal fan-in init (llama-style), ``[d_in, d_out]``."""
    std = scale if scale is not None else d_in ** -0.5
    return truncated_normal((d_in, d_out), gen, std=std, dtype=dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype=torch.float32) -> torch.Tensor:
    out = torch.empty((vocab, d), dtype=torch.float32, device=gen.device)
    return out.normal_(0.0, 1.0, generator=gen).mul_(0.02).to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.ones((d,), dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _rounded(c: float, dtype: torch.dtype) -> float:
    """``c`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(c, dtype=dtype).item()


def scalar_mul(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x * c`` with ``c`` first rounded to ``x.dtype``, as JAX does with a
    Python scalar.  PyTorch multiplies in float32 (float64 for a float64
    x), where the product of two values of x's dtype is exact, and then
    rounds once, so the bits are those of ``x * c`` in x's dtype."""
    return x * _rounded(float(c), x.dtype)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"g": torch.ones((d,), dtype=dtype, device=device),
            "b": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(x: torch.Tensor, p: Params, eps: float = 1e-5) -> torch.Tensor:
    """JAX's ``layernorm``: the mean and the population variance
    (``jnp.var``; ``torch.var`` defaults to the unbiased one) in float32,
    ``rsqrt(var + eps)``, then cast to x's dtype before ``* g + b`` in it."""
    dt = x.dtype
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * p["g"].to(dt) + p["b"].to(dt)


# --------------------------------------------------------------------- #
# Rotary position embeddings                                             #
# --------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(theta, expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)          # [hd/2]
    angles = positions[..., :, None].float() * freqs             # [..., seq, hd/2]
    cos = torch.cos(angles)[..., None, :]                        # [..., seq, 1, hd/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------- #
# Feed-forward block                                                     #
# --------------------------------------------------------------------- #
def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the JAX package computes it here: ``x * (1 / (1 +
    exp(-x)))``, each op rounded to x's dtype.  ``F.silu`` rounds once,
    which in bf16 differs in the last bit at about a third of the values.
    RWKV6's gate uses it: its bf16 forward drifts past the tests' tolerance
    with ``F.silu``.  SwiGLU and the MoE experts keep the fused ``F.silu``
    (four eager ops fewer a call), within tolerance either way."""
    return x * torch.reciprocal(1 + torch.exp(-x))


class _Softplus(torch.autograd.Function):
    """JAX's ``logaddexp(x, 0)`` op by op, with JAX's derivative
    (``_logaddexp_jvp``: ``exp(x - softplus(x))``, each op in x's dtype)."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` as JAX computes it: ``logaddexp(x, 0)`` =
    ``max(x, 0) + log1p(exp(-|x|))``, each op rounded to x's dtype (its
    bf16 bits; below about -87.5 XLA's CPU flushes the subnormal ``exp``
    to zero where PyTorch keeps it).  ``F.softplus`` rounds once and
    differs at about 1.3% of the finite bf16 values (0.6953125 against
    JAX's 0.69140625 near 4.3e-4).  Its gradient is JAX's, ``exp(x -
    softplus(x))``.  The Mamba head's step size (``ssm.mamba_apply``)
    uses it."""
    return _Softplus.apply(x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) as JAX computes it: ``x *
    (0.5 * (1 + tanh(c * (x + 0.044715 * x^3))))`` with ``c = sqrt(2 /
    pi)`` and the constants rounded to x's dtype, each op rounded to it.
    ``F.gelu(x, approximate="tanh")`` rounds once, which in bf16 differs
    at over 40% of the values; this form gives JAX's bf16 bits (float32:
    within an ulp of ``tanh``, XLA's being its own approximation)."""
    inner = x + scalar_mul(x * (x * x), 0.044715)
    return x * (0.5 * (1 + torch.tanh(scalar_mul(inner,
                                                 math.sqrt(2.0 / math.pi)))))


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int,
                dtype=torch.float32) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5),
    }


def swiglu(x: torch.Tensor, p: Params) -> torch.Tensor:
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    return (F.silu(g) * u) @ p["w_down"].to(dt)


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
                  dtype=torch.float32) -> Params:
    dev = gen.device
    return {
        "w_in": dense_init(gen, d_model, d_ff, dtype),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=dev),
        "w_out": dense_init(gen, d_ff, d_model, dtype, scale=d_ff ** -0.5),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=dev),
    }


def gelu_mlp(x: torch.Tensor, p: Params) -> torch.Tensor:
    dt = x.dtype
    h = gelu(x @ p["w_in"].to(dt) + p["b_in"].to(dt))
    return h @ p["w_out"].to(dt) + p["b_out"].to(dt)


# --------------------------------------------------------------------- #
# Losses                                                                 #
# --------------------------------------------------------------------- #
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in float32; logits ``[..., V]``, labels
    ``[...]`` integers (``mask``: weights of the tokens, 1 or 0)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
