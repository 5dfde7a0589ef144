"""The model side of the port, in PyTorch (params = nested dicts).

  layers.py     norms, rope, SwiGLU, initializers from a torch.Generator
  attention.py  GQA with a KV cache; prefill attention through K5
  moe.py        capacity-bounded top-k MoE; expert products through K4
  model.py      init / forward / prefill / decode for the GQA families
  convert.py    the JAX model's weights as the port's params
"""
from . import attention, convert, layers, model, moe
from .model import decode_step, forward, init_cache, init_params, prefill

__all__ = [
    "attention",
    "convert",
    "layers",
    "model",
    "moe",
    "decode_step",
    "forward",
    "init_cache",
    "init_params",
    "prefill",
]
