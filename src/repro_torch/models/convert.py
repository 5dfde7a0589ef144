"""Carry the JAX model's weights into the port.

:func:`params_from_jax` takes the JAX params pytree as nested dicts (and
lists) of numpy arrays, e.g. ``jax.tree.map(np.asarray, params)``, and
returns the port's params: the scan-stacked ``blocks`` (a leading layer
axis on every leaf, ``repro/models/model.py:109``, ``n_layers -
first_k_dense`` layers) and the encdec family's ``enc_blocks``
(``n_enc_layers``) become lists of per-layer dicts, the unstacked
``dense_blocks`` stay a list, and every array becomes a tensor on
``device``; a MoE layer's expert stacks keep their physical slot axis
(``P = E + R``) and its ``shared`` experts their dict, and a hybrid
layer's Mamba head (``ssm_in``, the ``ssm`` dict, ``ln_attn_out`` and
``ln_ssm_out``) its leaves.
:func:`adamw_state_from_jax` carries an AdamW state across the same way
(``step``, and ``m`` and ``v`` shaped as the params), so both packages
can take a step from one state.  It imports no JAX; the tests use it to
feed both packages one set of weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..devices import DeviceSpec, resolve_device
from .model import check_supported, stacked_depths


def _tensor(a: Any, dev: torch.device) -> torch.Tensor:
    a = np.array(a)                         # a writable copy
    if a.dtype.name == "bfloat16":          # ml_dtypes' bfloat16
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def _convert(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dev) for v in tree]
    return _tensor(tree, dev)


def _layer(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def params_from_jax(tree: Any, cfg: ModelConfig,
                    device: DeviceSpec = "cuda") -> Any:
    """The port's params holding the JAX params' values."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = stacked_depths(cfg)
    out = {}
    for k, v in tree.items():
        out[k] = ([_convert(_layer(v, i), dev) for i in range(layers[k])]
                  if k in layers else _convert(v, dev))
    return out


def adamw_state_from_jax(state: Any, cfg: ModelConfig,
                         device: DeviceSpec = "cuda"):
    """The port's :class:`repro_torch.train.optimizer.AdamWState` holding
    a JAX ``AdamWState``'s values (its fields as numpy arrays: ``step``,
    and ``m`` and ``v`` shaped as the JAX params)."""
    from ..train.optimizer import AdamWState
    dev = resolve_device(device)
    step, m, v = state
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=params_from_jax(m, cfg, dev), v=params_from_jax(v, cfg, dev))
