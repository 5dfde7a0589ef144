"""Fault-tolerant training checkpoints: atomic, one npz a host.

The port of ``repro.train.checkpoint``:
  * flatten the state tree to ``path -> np.ndarray`` and write one npz via
    write-to-temp + atomic rename (a torn write can never be loaded);
  * metadata (step, arch, balancer tables) rides along as JSON;
  * recovery picks the newest checkpoint whose marker file exists (the
    paper's §2.2 "restore from the most recent checkpoint").

The npz layout is the JAX package's, so either package restores the
other's checkpoints: the keys are the JAX tree's paths (``/``-joined dict
keys, list indices and the ``AdamWState`` field names ``step``, ``m``,
``v``), and the port's per-layer ``blocks`` and ``enc_blocks`` lists (the
JAX package's scanned stacks) are stacked on a leading layer axis on save
(``blocks/attn/wq`` is ``[L, ...]``, the hybrid family's
``blocks/ssm/a_log`` ``[L, d_model, ssm_state]``) and unstacked on
restore.  A bf16 leaf is written as float32 (numpy has no bf16) and cast
back on restore, as the JAX module's restore casts to the leaf's dtype.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.model import STACKED


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if k in STACKED and isinstance(v, list):
                stacked: Dict[str, list] = {}
                for layer in v:
                    flat: Dict[str, np.ndarray] = {}
                    _flatten(layer, f"{key}/", flat)
                    for lk, arr in flat.items():
                        stacked.setdefault(lk, []).append(arr)
                out.update({lk: np.stack(arrs)
                            for lk, arrs in stacked.items()})
            else:
                _flatten(v, f"{key}/", out)
    elif hasattr(tree, "_fields"):              # a NamedTuple (AdamWState)
        for name in tree._fields:
            _flatten(getattr(tree, name), f"{prefix}{name}/", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}/", out)
    else:
        out[prefix[:-1]] = _array(tree)


def save(ckpt_dir: str, step: int, tree: Any,
         meta: Optional[Dict] = None) -> str:
    """Atomic checkpoint write; returns the checkpoint path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat: Dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    final = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, final)       # atomic on POSIX
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    meta = dict(meta or {}, step=step)
    meta_tmp = final + ".meta.tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f)
    os.replace(meta_tmp, final + ".meta.json")
    return final


def latest(ckpt_dir: str) -> Optional[Tuple[str, Dict]]:
    """Newest checkpoint with a complete metadata marker."""
    if not os.path.isdir(ckpt_dir):
        return None
    cands = sorted(
        f for f in os.listdir(ckpt_dir)
        if f.startswith("step_") and f.endswith(".npz")
        and os.path.exists(os.path.join(ckpt_dir, f + ".meta.json"))
    )
    if not cands:
        return None
    path = os.path.join(ckpt_dir, cands[-1])
    with open(path + ".meta.json") as f:
        meta = json.load(f)
    return path, meta


def _restore(tree: Any, data, key: str, layer: Optional[int]) -> Any:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in STACKED and isinstance(v, list):
                out[k] = [_restore(b, data, f"{key}{k}/", i)
                          for i, b in enumerate(v)]
            else:
                out[k] = _restore(v, data, f"{key}{k}/", layer)
        return out
    if hasattr(tree, "_fields"):
        return type(tree)(*(_restore(getattr(tree, n), data, f"{key}{n}/",
                                     layer) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_restore(v, data, f"{key}{i}/", layer)
                          for i, v in enumerate(tree))
    arr = data[key[:-1]]
    if layer is not None:
        arr = arr[layer]
    return torch.from_numpy(np.array(arr)).to(tree.device, tree.dtype)


def restore(path: str, tree_like: Any) -> Any:
    """Load into the structure of ``tree_like`` (each leaf a tensor whose
    dtype and device the restored one takes)."""
    with np.load(path) as npz:
        data = {k: npz[k] for k in npz.files}   # each array read once
    return _restore(tree_like, data, "", None)


def prune(ckpt_dir: str, keep: int = 3) -> None:
    if not os.path.isdir(ckpt_dir):
        return
    cands = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("step_") and f.endswith(".npz"))
    for f in cands[:-keep]:
        for suffix in ("", ".meta.json"):
            p = os.path.join(ckpt_dir, f + suffix)
            if os.path.exists(p):
                os.unlink(p)
