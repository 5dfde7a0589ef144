"""AdamW + cosine schedule + global-norm clipping (no external deps).

The port of ``repro.train.optimizer``.  The arithmetic is float32 tensors
throughout, as JAX's is: each Python constant is rounded to float32 first
(JAX's weak-typed scalars), ``b1 ** step`` and the cosine are float32
ops, and the order of every product and sum is the reference's.  The
libraries' ``pow`` and ``cos`` may still differ in a last bit.

:func:`update` works in place where JAX rebuilds the trees: the params and
the moments are the caller's tensors, updated leaf by leaf (at a
full-width MoE the moments alone are 8 bytes a parameter).  The gradients
are not written to.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple, Tuple

import torch

from ..tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor              # int32, 0-d, on the params' device
    m: Any
    v: Any


def _f32(x: float, dev) -> torch.Tensor:
    """A Python float rounded to float32, as JAX rounds a weak scalar."""
    return torch.tensor(x, dtype=torch.float32, device=dev)


def init(params: Any) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine down to ``min_lr_frac``: float32."""
    dev = step.device
    warm = torch.clamp(step.float() / float(max(cfg.warmup_steps, 1)),
                       max=1.0)
    t = torch.clamp((step - cfg.warmup_steps).float()
                    / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                    0.0, 1.0)
    cos = _f32(cfg.min_lr_frac, dev) + _f32(
        (1 - cfg.min_lr_frac) * 0.5, dev) * (
            1 + torch.cos(_f32(math.pi, dev) * t))
    return _f32(cfg.lr, dev) * warm * cos


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale every leaf by ``min(1, max_norm / |grads|)``; the norm sums
    one float32 sum of squares per leaf, leaves in sorted-key order."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in leaves(grads)))
    scale = torch.clamp(_f32(max_norm, gn.device)
                        / torch.clamp(gn, min=_f32(1e-9, gn.device)),
                        max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


def update(cfg: AdamWConfig, params: Any, grads: Any, state: AdamWState
           ) -> Tuple[Any, AdamWState]:
    """One AdamW step: ``(params, state)`` updated in place and returned."""
    grads = tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, _ = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(cfg, step)
    dev = step.device
    b1, b2 = _f32(cfg.beta1, dev), _f32(cfg.beta2, dev)
    omb1, omb2 = _f32(1 - cfg.beta1, dev), _f32(1 - cfg.beta2, dev)
    c1 = 1 - b1 ** step.float()
    c2 = 1 - b2 ** step.float()
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads),
                              leaves(state.m), leaves(state.v)):
            m.mul_(b1).add_(omb1 * g)
            v.mul_(b2).add_(omb2 * g * g)
            u = (m / c1).div_(torch.sqrt(v / c2).add_(eps))
            p32 = p.float()
            u.add_(wd * p32)
            p.copy_((p32 - lr * u).to(p.dtype))
            del u
    return params, AdamWState(step=step, m=state.m, v=state.v)
