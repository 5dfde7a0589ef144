"""Serving launcher: batched prefill + decode with slot retirement.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --smoke --requests 8 --max-new 16 --device cpu

Without ``--device`` it serves on ``cuda`` and raises without a card.
Weights are random, drawn from seed 0 on the serving device.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..models import init_params
from ..serve import Request, ServeEngine


def main(argv: Optional[List[str]] = None) -> List[Request]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    params = init_params(cfg, 0, args.device)
    eng = ServeEngine(params, cfg, batch_size=args.batch,
                      max_len=args.max_new + 8, eos_id=-1,
                      temperature=args.temperature, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=4 + i % 5).astype(np.int32)
        eng.submit(Request(uid=i, prompt=prompt, max_new_tokens=args.max_new))
    t0 = time.perf_counter()
    done = eng.run()
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"completed {len(done)} requests, {eng.tokens_decoded} tokens "
          f"in {dt:.1f}s ({eng.tokens_decoded / max(dt, 1e-9):.1f} tok/s) "
          f"on {eng.device}")
    for r in done[:4]:
        print(f"  req {r.uid}: {r.out_tokens[:8]}...")
    return done


if __name__ == "__main__":
    main()
