"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \
        --smoke --device cpu --steps 50 --balancer --ckpt-dir /tmp/ckpt

The port of ``repro.launch.train`` with its flags, plus ``--device``
(default ``cuda``; without a card it raises).  ``--smoke`` runs the
reduced same-family config; without it the published config is used,
which for OLMoE-1B-7B does not fit one card (its 16 layers need about
138 GB of float32 params, grads and AdamW moments; ``chip_smoke.py``
trains it at 6 layers) and for RWKV6-1.6B does (~23.7 GB: ``--arch
rwkv6-1.6b`` trains all 24 layers, the recurrence's backward on K6's
backward kernel; the ssm family has no experts, so ``--balancer`` is a
no-op there), as for InternVL2-2B (~30.2 GB; the vlm family's stubbed
vision tower gets zero bf16 patches ``[batch, n_patches, d_model]`` ahead
of each batch's tokens, as the JAX launcher gives it), and for
Whisper-medium (~13 GB; the encdec family's stubbed audio frontend gets
zero bf16 frames ``[batch, enc_seq, d_model]``, as the JAX launcher gives
it; no experts, so no balancer), and for Hymba-1.5B (~21 GB; its Mamba
heads' backward on K7's backward kernel, its windowed attention on K5's;
no experts).  Weights are
random, drawn from seed 0 on the device.  Checkpoints are written
atomically every ``--ckpt-every`` steps (the JAX package's layout) and
training resumes from the newest one.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import torch

from ..configs import get_config, get_smoke
from ..core.moe_balancer import MoEBalancerConfig
from ..data import PipelineConfig, SkewAwarePipeline, zipf_doc_lengths
from ..train import TrainConfig, Trainer, checkpoint as ckpt
from ..train.optimizer import AdamWConfig


def main(argv: Optional[List[str]] = None) -> List[Dict[str, float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmoe-1b-7b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--balancer", action="store_true",
                    help="enable the Reshape MoE expert balancer")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    bal = None
    if args.balancer and cfg.n_experts:
        bal = MoEBalancerConfig(n_experts=cfg.n_experts,
                                n_slots=cfg.n_experts, n_shards=4,
                                min_steps_between=4)
    tc = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps),
        remat=not args.smoke,
        grad_compression=args.compress_grads,
        moe_balancer=bal,
    )
    tr = Trainer(cfg, tc, device=args.device)

    start_step = 0
    if args.ckpt_dir:
        found = ckpt.latest(args.ckpt_dir)
        if found:
            path, meta = found
            tree = ckpt.restore(path, {"params": tr.params,
                                       "opt": tr.opt_state})
            tr.params, tr.opt_state = tree["params"], tree["opt"]
            start_step = meta["step"]
            tr.step_num = start_step
            print(f"resumed from {path} @ step {start_step}")

    pipe = SkewAwarePipeline(PipelineConfig(
        seq_len=args.seq, batch_per_shard=max(args.batch // 8, 1),
        n_shards=8, vocab=cfg.vocab))

    log: List[Dict[str, float]] = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        pipe.ingest(zipf_doc_lengths(64, args.seq, seed=step))
        nb = pipe.next_batch()
        batch = {"tokens": torch.from_numpy(nb["tokens"][:args.batch]),
                 "labels": torch.from_numpy(nb["labels"][:args.batch])}
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((args.batch, cfg.enc_seq,
                                           cfg.d_model), dtype=torch.bfloat16)
        if cfg.family == "vlm":
            batch["patches"] = torch.zeros((args.batch, cfg.n_patches,
                                            cfg.d_model), dtype=torch.bfloat16)
        metrics = tr.train_step(batch)
        log.append(metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            extra = ""
            if "representativeness" in metrics:
                extra = f" repr={metrics['representativeness']:.3f}"
            print(f"step {step:5d} loss={metrics['loss']:.4f} "
                  f"drop={metrics['dropped_frac']:.4f}{extra} "
                  f"({time.time() - t0:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1,
                      {"params": tr.params, "opt": tr.opt_state},
                      {"arch": cfg.name})
            ckpt.prune(args.ckpt_dir, keep=3)
    print(f"done on {tr.device}.")
    return log


if __name__ == "__main__":
    main()
