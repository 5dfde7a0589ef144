"""Architecture registry: ``get_config(arch)`` / ``get_smoke(arch)``.

The port's counterpart of ``repro.configs``.  Each ``<arch>.py`` exports
the published configuration (``config()``) and a reduced same-family
configuration for the CPU tests (``smoke_config()``).  Only the
architectures whose model path is ported have a file here: every
architecture of the JAX package, each family included; an architecture
without one raises ``NotImplementedError``.
"""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from .base import ModelConfig, dtype_of

#: Every architecture of the JAX package, ported or not.
ARCH_IDS: List[str] = [
    "olmoe-1b-7b",
    "deepseek-v2-lite-16b",
    "minicpm3-4b",
    "granite-8b",
    "llama3.2-3b",
    "yi-6b",
    "whisper-medium",
    "internvl2-2b",
    "rwkv6-1.6b",
    "hymba-1.5b",
]

_MODULES: Dict[str, str] = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama3.2-3b": "llama3_2_3b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "yi-6b": "yi_6b",
    "granite-8b": "granite_8b",
    "internvl2-2b": "internvl2_2b",
    "minicpm3-4b": "minicpm3_4b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-medium": "whisper_medium",
    "hymba-1.5b": "hymba_1_5b",
}

#: The architectures the port serves.
PORTED: List[str] = list(_MODULES)


def _module(arch: str):
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCH_IDS)}")
    if arch not in _MODULES:
        raise NotImplementedError(
            f"{arch!r} is not ported to PyTorch yet (ported: {PORTED}); "
            "ROADMAP.md lists the order of the remaining slices")
    return import_module(f".{_MODULES[arch]}", __name__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()


__all__ = ["ARCH_IDS", "PORTED", "ModelConfig", "dtype_of", "get_config",
           "get_smoke"]
