"""Batched serving: prefill + step-decode with a KV cache, in PyTorch.

The port of ``repro.serve.engine``: a fixed batch of slots, greedy or
temperature sampling, per-slot retirement at EOS or at the request's token
budget, and refill of a retired slot from the waiting queue by prefilling
the whole batch again (continuous-batching-lite).  Prompts are padded on
the left with token 0, with no mask, exactly as the JAX engine does.
Temperature sampling draws from an explicit ``torch.Generator`` seeded
from ``seed``; its numbers differ from ``jax.random``'s.

The vlm family gets JAX's stub, zero patch embeddings ``[B, n_patches,
d_model]`` in the compute dtype ahead of the padded prompts, and departs
from JAX's engine where that cannot serve (``ROADMAP.md`` §3): the cache
holds ``n_patches + S + max_len`` positions (JAX's ``S + max_len`` cannot
take the patches once ``n_patches`` passes ``max_len``) and decoding
starts at ``n_patches + S`` (JAX's starts at ``S``, over the prompt's
rows).  The encdec family gets JAX's stub too, zero frame embeddings
``[B, enc_seq, d_model]`` in the compute dtype, which the prefill runs the
encoder over; its cache holds ``S + max_len`` decoder positions, as JAX's.
The hybrid family's left padding runs through its Mamba heads too: the
pads' steps feed each layer's recurrent state before the prompt's, as in
JAX's engine.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig, dtype_of
from ..devices import DeviceSpec, resolve_device
from ..models import model as model_lib


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # [S] int32
    max_new_tokens: int = 32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Fixed-batch decode loop with slot retirement + refill.

    ``params`` must lie on ``device`` (``init_params(cfg, seed, device)``
    or ``params_from_jax(tree, cfg, device)``)."""

    def __init__(self, params: Any, cfg: ModelConfig, *, batch_size: int = 4,
                 max_len: int = 256, eos_id: int = 0,
                 temperature: float = 0.0, seed: int = 0,
                 device: DeviceSpec = "cuda"):
        model_lib.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"engine serves on {self.device}")
        self.params = params
        self.cfg = cfg
        self.B = batch_size
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.waiting: List[Request] = []
        self.active: List[Optional[Request]] = [None] * batch_size
        self.completed: List[Request] = []
        self.tokens_decoded = 0

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _prefill(self, batch: Dict[str, torch.Tensor], cache: Any):
        return model_lib.prefill(self.params, self.cfg, batch, cache)

    def _step(self, tokens: torch.Tensor, cache: Any, pos: int):
        return model_lib.decode_step(self.params, self.cfg, tokens, cache, pos)

    # ------------------------------------------------------------------ #
    def _fill_batch(self) -> Tuple[torch.Tensor, Any, int]:
        """Right-align all active prompts into one padded prefill batch;
        returns (its logits, the cache, the next position)."""
        prompts = []
        for i in range(self.B):
            if self.active[i] is None and self.waiting:
                self.active[i] = self.waiting.pop(0)
            r = self.active[i]
            prompts.append(r.prompt if r is not None else np.zeros(1, np.int32))
        S = max(len(p) for p in prompts)
        toks = np.zeros((self.B, S), dtype=np.int64)
        for i, p in enumerate(prompts):
            toks[i, S - len(p):] = p      # right-aligned: last pos = last tok
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        n_prefix = 0
        cdt = dtype_of(self.cfg.compute_dtype)
        if self.cfg.family == "encdec":
            batch["frames"] = torch.zeros(
                (self.B, self.cfg.enc_seq, self.cfg.d_model), dtype=cdt,
                device=self.device)
        if self.cfg.family == "vlm":
            n_prefix = self.cfg.n_patches
            batch["patches"] = torch.zeros(
                (self.B, n_prefix, self.cfg.d_model), dtype=cdt,
                device=self.device)
        cache = model_lib.init_cache(self.cfg, self.B,
                                     n_prefix + S + self.max_len, self.device)
        logits, cache = self._prefill(batch, cache)
        return logits, cache, n_prefix + S

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        last = logits[:, -1]
        if self.temperature <= 0:
            tok = torch.argmax(last, dim=-1)
        else:
            probs = torch.softmax(last.float() / self.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=self.gen)[:, 0]
        return tok.cpu().numpy().astype(np.int32)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Decode until all submitted requests complete."""
        while (self.waiting or any(r is not None for r in self.active)) \
                and max_steps > 0:
            logits0, cache, pos = self._fill_batch()
            step_tok = self._sample(logits0)
            for i, r in enumerate(self.active):
                if r is not None:
                    r.out_tokens.append(int(step_tok[i]))
            steps_left = min(self.max_len,
                             max((r.max_new_tokens for r in self.active
                                  if r is not None), default=0))
            for _ in range(steps_left):
                max_steps -= 1
                tokens = torch.from_numpy(step_tok[:, None].astype(np.int64))
                logits, cache = self._step(tokens.to(self.device), cache, pos)
                pos = pos + 1
                step_tok = self._sample(logits)
                self.tokens_decoded += int(sum(r is not None for r in self.active))
                for i, r in enumerate(self.active):
                    if r is None:
                        continue
                    t = int(step_tok[i])
                    r.out_tokens.append(t)
                    if t == self.eos_id or len(r.out_tokens) >= r.max_new_tokens:
                        r.done = True
                        self.completed.append(r)
                        self.active[i] = None
                if all(r is None for r in self.active) and not self.waiting:
                    break
                if any(r is None for r in self.active) and self.waiting:
                    break                   # refill: re-prefill the batch
        return self.completed
