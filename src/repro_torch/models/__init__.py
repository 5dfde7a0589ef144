"""The model side of the port, in PyTorch (params = nested dicts).

  layers.py     norms, rope, SwiGLU, initializers from a torch.Generator
  attention.py  GQA with a KV cache; prefill attention through K5
  moe.py        capacity-bounded top-k MoE; expert products through K4
  ssm.py        RWKV6 time-mix and channel-mix; the recurrence through K6
  model.py      init / forward / loss / prefill / decode for the GQA
                families and the RWKV6 (ssm) family
  convert.py    the JAX model's weights as the port's params
"""
from . import attention, convert, layers, model, moe, ssm
from .model import (decode_step, forward, init_cache, init_params,
                    loss_fn, prefill)

__all__ = [
    "attention",
    "convert",
    "layers",
    "model",
    "moe",
    "ssm",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "loss_fn",
    "prefill",
]
