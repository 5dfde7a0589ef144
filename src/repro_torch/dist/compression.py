"""Error-feedback gradient compression (int8 uniform quantization).

Each leaf is quantized to 255 levels (symmetric int8) of a per-tensor
scale, and the quantization residual is carried to the next step
(``err``), so the *cumulative* dequantized gradient telescopes to the
cumulative true gradient within one quantization step — the standard
error-feedback guarantee that keeps SGD/AdamW convergence intact.

The port of ``repro.dist.compression``: the same float32 arithmetic on
torch tensors (``torch.round`` rounds half to even, as ``jnp.round``),
over the port's nested dicts and lists.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from ..tree import tree_map

#: quantization half-range: values map to integers in [-LEVELS, LEVELS].
LEVELS = 127.0


def init_error(params: Any) -> Any:
    """Zero residual tree matching ``params`` (float32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _compress_leaf(g: torch.Tensor, e: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = g.float() + e
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / LEVELS, torch.ones_like(amax))
    deq = torch.round(x / scale) * scale
    return deq.to(g.dtype), x - deq


def compress_tree(grads: Any, err: Any) -> Tuple[Any, Any]:
    """Quantize a gradient tree with error feedback.

    Returns ``(dequantized_grads, new_err)``; ``new_err`` must be fed back
    on the next call so the residual telescopes (unbiased over time).
    """
    if isinstance(grads, dict):
        pairs = {k: compress_tree(grads[k], err[k]) for k in grads}
        return ({k: p[0] for k, p in pairs.items()},
                {k: p[1] for k, p in pairs.items()})
    if isinstance(grads, (list, tuple)):
        pairs = [compress_tree(g, e) for g, e in zip(grads, err)]
        return (type(grads)(p[0] for p in pairs),
                type(grads)(p[1] for p in pairs))
    return _compress_leaf(grads, err)
