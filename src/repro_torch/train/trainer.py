"""Training loop: the train step, MoE-balancer integration (routing table
as a step argument + replica grad merge), gradient compression.

The Reshape control loop during training:

  1. the train step returns per-layer router demand & slot loads,
  2. the host-side MoEReshapeBalancer runs the skew test / two-phase plan,
  3. its routing-table rewrite is an argument of the next step (no
     rebuild) — the control message of the paper,
  4. pending expert-weight copies (state migration) execute between steps,
  5. replica gradients (scattered state, §5.4) are merged inside the step
     by a slot->primary map, and the updated primary weights are
     re-broadcast to replicas — the END-marker merge every step.

The port of ``repro.train.trainer`` for one device: :class:`Trainer` runs
the step eagerly on ``device`` (default ``"cuda"``), with no mesh
(``jit_train_step`` and its shardings wait for the port's ``dist``
slice).  The port keeps per-layer param dicts, so the merge and the
broadcast act on each layer's ``w_gate``, ``w_up`` and ``w_down`` by name,
and work in place: the step owns its gradients, and the params, the
moments and the replicas are updated where they lie.  On replication the
trainer copies params only, as the reference does (``trainer.py:268-285``
promises m and v in a comment and copies neither).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.moe_balancer import MoEBalancerConfig, MoEReshapeBalancer
from ..devices import DeviceSpec, resolve_device
from ..dist import compression
from ..models import model as model_lib
from ..tree import leaves, tree_map
from . import optimizer

EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


@dataclasses.dataclass
class TrainConfig:
    opt: optimizer.AdamWConfig = dataclasses.field(
        default_factory=optimizer.AdamWConfig)
    remat: bool = True
    grad_compression: bool = False
    moe_balancer: Optional[MoEBalancerConfig] = None
    aux_weight: float = 0.01
    checkpoint_every: int = 200
    checkpoint_dir: Optional[str] = None


def _moe_layers(tree: Any, merge_map: torch.Tensor):
    """The per-layer ``moe`` dicts of a params or gradient tree: those of
    ``blocks`` (the scanned layers; the first_k_dense layers of
    ``dense_blocks`` have none), one a row of ``merge_map``."""
    moes = [b["moe"] for b in tree.get("blocks", []) if "moe" in b]
    if len(moes) != merge_map.shape[0]:
        raise ValueError(f"a merge map of {merge_map.shape[0]} layers for "
                         f"{len(moes)} MoE layers")
    return moes


def merge_replica_grads(grads: Any, merge_map: torch.Tensor) -> Any:
    """Sum replica-slot MoE grads into their primary slot, in place.

    ``merge_map``: ``[L, P]`` -> primary slot per MoE layer of ``blocks``
    (identity when unreplicated).  Each primary's gradient becomes the sum
    of its slots' in ascending slot order and a replica's becomes 0, as
    JAX's ``zeros_like(g).at[m].add(g)``.  Returns ``grads``."""
    mm = merge_map.cpu().tolist()
    with torch.no_grad():
        for li, moe in enumerate(_moe_layers(grads, merge_map)):
            moved = [(s, m) for s, m in enumerate(mm[li]) if m != s]
            for name in EXPERT_LEAVES:
                g = moe[name]
                for s, m in moved:
                    g[m] += g[s]
                for s, _ in moved:
                    g[s].zero_()
    return grads


def broadcast_replicas(params: Any, merge_map: torch.Tensor) -> Any:
    """After the optimizer step, refresh every replica slot from its
    primary so replicas never drift (in place).  Returns ``params``."""
    mm = merge_map.cpu().tolist()
    with torch.no_grad():
        for li, moe in enumerate(_moe_layers(params, merge_map)):
            for s, m in enumerate(mm[li]):
                if m != s:
                    for name in EXPERT_LEAVES:
                        moe[name][s] = moe[name][m]
    return params


def _value_and_grad(fn, params: Any, batch: Dict[str, torch.Tensor]):
    """((loss, stats), grads) of ``fn(params, batch)`` over every leaf of
    ``params`` (taken as leaves of the graph: the params themselves are
    never marked)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), params)
    loss, stats = fn(live, batch)
    grads = torch.autograd.grad(loss, leaves(live))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), live)
    return (loss.detach(), tree_map(lambda t: t.detach(), stats)), grads


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                    use_balancer: bool = False):
    """Returns ``train_step(state_tree, batch, moe_routing, merge_map)``:
    the tree ``{"params", "opt"[, "err"]}`` updated in place and returned,
    and the step's metrics (tensors)."""

    def step(tree, batch, moe_routing, merge_map):
        params = tree["params"]

        def lf(p, b):
            return model_lib.loss_fn(
                p, cfg, b, aux_weight=tc.aux_weight, remat=tc.remat,
                moe_routing=moe_routing if use_balancer else None)

        mb = max(getattr(cfg, "train_microbatch", 1), 1)
        if mb > 1:
            # Gradient accumulation over microbatches; grads in float32.
            split = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])
                     for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, stats_all = [], []
            for i in range(mb):
                (l, st), g = _value_and_grad(
                    lf, params, {k: v[i] for k, v in split.items()})
                for a, x in zip(leaves(grads), leaves(g)):
                    a += x.float()
                losses.append(l)
                stats_all.append(st)
            grads = tree_map(lambda g: g / mb, grads)
            loss = torch.stack(losses).mean()
            stats = {k: torch.stack([s[k] for s in stats_all]).mean(0)
                     for k in stats_all[0]}
        else:
            (loss, stats), grads = _value_and_grad(lf, params, batch)
        if use_balancer and merge_map is not None:
            grads = merge_replica_grads(grads, merge_map)
        if tc.grad_compression and "err" in tree:
            grads, new_err = compression.compress_tree(grads, tree["err"])
        else:
            new_err = tree.get("err")
        new_params, new_opt = optimizer.update(tc.opt, params, grads,
                                               tree["opt"])
        del grads
        if use_balancer and merge_map is not None:
            new_params = broadcast_replicas(new_params, merge_map)
        out = {"params": new_params, "opt": new_opt}
        if new_err is not None:
            out["err"] = new_err
        metrics = {
            "loss": loss,
            "dropped_frac": stats["dropped_frac"],
            "tokens_per_expert_layers": stats["tokens_per_expert_layers"],
            "tokens_per_slot_layers": stats["tokens_per_slot_layers"],
        }
        return out, metrics

    return step


# --------------------------------------------------------------------- #
# The host-side training loop, with the Reshape balancer in it          #
# --------------------------------------------------------------------- #
class Trainer:
    """One device's training loop: params from ``seed`` on ``device``,
    AdamW, and with ``tc.moe_balancer`` a balancer a MoE layer (each of
    the ``n_layers - first_k_dense`` layers of ``blocks``, as JAX keeps
    one a scanned layer)."""

    def __init__(self, cfg: ModelConfig, tc: TrainConfig, *, seed: int = 0,
                 device: DeviceSpec = "cuda"):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.params = model_lib.init_params(cfg, seed, self.device)
        self.opt_state = optimizer.init(self.params)
        self.err = (compression.init_error(self.params)
                    if tc.grad_compression else None)
        self.step_num = 0
        self.metrics_log: List[Dict[str, float]] = []

        self.balancers: List[MoEReshapeBalancer] = []
        self.use_balancer = tc.moe_balancer is not None and cfg.n_experts > 0
        if self.use_balancer:
            self.balancers = [MoEReshapeBalancer(tc.moe_balancer)
                              for _ in range(cfg.n_layers
                                             - cfg.first_k_dense)]
        self._step_fn = make_train_step(cfg, tc,
                                        use_balancer=self.use_balancer)

    # -- balancer arrays ------------------------------------------------ #
    def moe_routing(self) -> Optional[torch.Tensor]:
        if not self.use_balancer:
            return None
        return torch.from_numpy(np.stack(
            [b.state.expert_routing for b in self.balancers]).astype(
                np.float32)).to(self.device)

    def merge_map(self) -> Optional[torch.Tensor]:
        if not self.use_balancer:
            return None
        return torch.from_numpy(np.stack(
            [b.grad_merge_map() for b in self.balancers]))

    def train_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, float]:
        tree = {"params": self.params, "opt": self.opt_state}
        if self.err is not None:
            tree["err"] = self.err
        batch = {k: torch.as_tensor(v).to(self.device)
                 for k, v in batch.items()}
        tree, metrics = self._step_fn(tree, batch, self.moe_routing(),
                                      self.merge_map())
        self.params = tree["params"]
        self.opt_state = tree["opt"]
        self.err = tree.get("err")

        out = {"loss": float(metrics["loss"]),
               "dropped_frac": float(metrics["dropped_frac"])}
        if self.use_balancer:
            tpe = metrics["tokens_per_expert_layers"].cpu().numpy()
            tps = metrics["tokens_per_slot_layers"].cpu().numpy()
            for li, bal in enumerate(self.balancers):
                bal.observe(self.step_num, tps[li], tpe[li])
                if bal.pending_copies:
                    self._apply_copies(li, bal)
            out["representativeness"] = float(np.mean([
                b.representativeness(tps[i], tpe[i])
                for i, b in enumerate(self.balancers)]))
        self.step_num += 1
        self.metrics_log.append(out)
        return out

    def _apply_copies(self, layer: int, bal: MoEReshapeBalancer) -> None:
        """Execute expert-weight state migration for one layer (between
        steps — the synchronized point; cost = bytes_migrated), in place
        on the layer's expert stacks."""
        bal.apply_pending(self.params["blocks"][layer]["moe"])
