"""Device selection for the port's entry points.

Every public entry point takes ``device`` (default ``"cuda"``) and resolves
it here: a CUDA request without a card raises instead of running on the
host, so a run never lands on the CPU unless the caller asked for it.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceSpec = Union[str, torch.device]


def resolve_device(device: DeviceSpec = "cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it cannot be served."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and none is available; "
            "pass device='cpu' to run on the host")
    return dev
