"""Reshape applied to MoE expert-parallel routing skew.

The mapping (DESIGN.md §3, "MoE expert routing is partitioning skew"):

  tuples -> keys            tokens -> logical experts (router top-k)
  worker                    expert-parallel shard (a contiguous block of
                            physical expert slots on one device group)
  phi (queue size)          EMA of tokens routed to a shard per step
  partition function        expert_routing [E, P] row-stochastic table
                            (traced argument of the jitted train step — a
                            swap is a control message, no recompilation)
  SBK (split by keys)       expert migration: move a whole expert's slot
                            to the helper shard (swap two slots' weights +
                            optimizer state — the synchronized mutable-state
                            migration of §5.3)
  SBR (split by records)    expert replication: install a COPY of the hot
                            expert into a spare slot on the helper shard and
                            split its tokens by a fraction (the capability
                            Flux lacks). Gradients then accumulate on BOTH
                            slots — scattered state (§5.4) — merged every
                            optimizer step by summing replica grads into the
                            primary (the END-marker/watermark merge).
  two phases                the backlog-free synchronous step collapses
                            phase 1 (catch-up) into the migration itself;
                            the phase-2 split-fraction refit and the §4.3.1
                            iterations (router drift!) carry over verbatim.
  result-awareness          an overloaded expert shard overflows capacity
                            and DROPS tokens, biasing the visible training
                            metrics exactly like the skewed bar chart; the
                            balancer tracks a representativeness metric
                            (processed-token distribution vs router truth).

Everything here is host-side control logic; the data plane consumes
``state.expert_routing`` (and the trainer consumes ``slot_src`` for the
replica grad-merge) as tensors.

The port's copy of ``repro.core.moe_balancer``: numpy as there, but for
:meth:`MoEReshapeBalancer.apply_pending`, whose ``.at[]`` updates become
index copies and swaps on torch tensors, in place, with the same order of
copies and the same ``bytes_migrated``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .skew_test import assign_helpers
from .types import MitigationEvent, ReshapeConfig, TransferMode


@dataclasses.dataclass
class MoEBalancerConfig:
    n_experts: int
    n_slots: int                    # physical slots = experts + spares
    n_shards: int                   # expert-parallel degree
    mode: TransferMode = TransferMode.SBR
    # Skew test, in token-share units (fraction of tokens per step).
    eta_share: float = 1.0          # shard load >= eta * fair share
    tau_share: float = 0.5          # gap >= tau * fair share
    ema: float = 0.8                # workload metric smoothing
    max_replicas_per_expert: int = 4
    # Adaptive tau (Algorithm 1) on the share-estimator stderr.
    adaptive_tau: bool = True
    eps_lower: float = 0.02
    eps_upper: float = 0.10
    tau_increase: float = 0.25
    max_tau_adjustments: int = 3
    min_steps_between: int = 4      # control-message cadence


@dataclasses.dataclass
class MoEBalancerState:
    expert_routing: np.ndarray      # [E, P] row-stochastic (traced by step)
    slot_src: np.ndarray            # [P] logical expert whose weights each
                                    # physical slot holds (-1 = empty spare)
    ema_load: np.ndarray            # [P] smoothed tokens/step per slot
    tau: float
    tau_adjustments: int = 0
    iterations: int = 0
    last_action_step: int = -10**9
    events: List[MitigationEvent] = dataclasses.field(default_factory=list)
    history: List[np.ndarray] = dataclasses.field(default_factory=list)
    bytes_migrated: float = 0.0


def init_state(cfg: MoEBalancerConfig) -> MoEBalancerState:
    E, P = cfg.n_experts, cfg.n_slots
    routing = np.zeros((E, P))
    routing[np.arange(E), np.arange(E)] = 1.0
    slot_src = np.concatenate([np.arange(E), -np.ones(P - E, dtype=np.int64)])
    return MoEBalancerState(
        expert_routing=routing,
        slot_src=slot_src.astype(np.int64),
        ema_load=np.zeros(P),
        tau=cfg.tau_share,
    )


def shard_of(slot: int, cfg: MoEBalancerConfig) -> int:
    """Physical slot -> expert-parallel shard (contiguous blocks)."""
    per = cfg.n_slots // cfg.n_shards
    return min(slot // per, cfg.n_shards - 1)


def shard_loads(state: MoEBalancerState, cfg: MoEBalancerConfig) -> np.ndarray:
    loads = np.zeros(cfg.n_shards)
    per = cfg.n_slots // cfg.n_shards
    for s in range(cfg.n_shards):
        loads[s] = state.ema_load[s * per: (s + 1) * per].sum()
    return loads


def _share_stderr(history: List[np.ndarray], shard: int, cfg: MoEBalancerConfig) -> float:
    """Stderr of the mean-model share estimator for a shard (Algorithm 1)."""
    if len(history) < 2:
        return float("inf")
    per = cfg.n_slots // cfg.n_shards
    shares = []
    for h in history:
        tot = max(h.sum(), 1e-9)
        shares.append(h[shard * per: (shard + 1) * per].sum() / tot)
    d = float(np.std(shares, ddof=1))
    n = len(shares)
    return d * np.sqrt(1.0 + 1.0 / n)


class MoEReshapeBalancer:
    """Host-side controller run once per train step (per MoE layer)."""

    def __init__(self, cfg: MoEBalancerConfig):
        self.cfg = cfg
        self.state = init_state(cfg)
        #: pending weight copies for the trainer to execute between steps:
        #: list of (dst_slot, src_slot, replicate: bool)
        self.pending_copies: List[Tuple[int, int, bool]] = []

    # ------------------------------------------------------------------ #
    def observe(self, step: int, tokens_per_slot: np.ndarray,
                tokens_per_expert_router: np.ndarray) -> None:
        """Feed one step's routing statistics; maybe mitigate."""
        st, cfg = self.state, self.cfg
        st.ema_load = cfg.ema * st.ema_load + (1 - cfg.ema) * tokens_per_slot
        st.history.append(tokens_per_slot.copy())
        if len(st.history) > 64:
            st.history.pop(0)
        if step - st.last_action_step < cfg.min_steps_between:
            return
        self._detect_and_mitigate(step, tokens_per_expert_router)

    # ------------------------------------------------------------------ #
    def _detect_and_mitigate(self, step: int, router_demand: np.ndarray) -> None:
        st, cfg = self.state, self.cfg
        loads = shard_loads(st, cfg)
        total = loads.sum()
        if total <= 0:
            return
        fair = total / cfg.n_shards
        eta = cfg.eta_share * fair
        tau = st.tau * fair

        assignment = assign_helpers(loads, eta, tau, max_helpers=1)
        if not assignment:
            # Algorithm 1 decrease branch: good estimate + sub-tau gap.
            if cfg.adaptive_tau and st.tau_adjustments < cfg.max_tau_adjustments:
                s = int(np.argmax(loads))
                h = int(np.argmin(loads))
                gap_share = (loads[s] - loads[h]) / max(total, 1e-9) * cfg.n_shards
                eps = _share_stderr(st.history, s, cfg)
                if (np.isfinite(eps) and eps < cfg.eps_lower
                        and loads[s] >= eta and gap_share > 0.05):
                    st.events.append(MitigationEvent(
                        step, "tau_decrease", s, (h,),
                        {"old": st.tau, "new": gap_share}))
                    st.tau = gap_share
                    st.tau_adjustments += 1
                    self._mitigate(step, s, h, router_demand)
            return

        for s, helpers in assignment.items():
            h = helpers[0]
            eps = _share_stderr(st.history, int(s), cfg)
            if (cfg.adaptive_tau and np.isfinite(eps) and eps > cfg.eps_upper
                    and st.tau_adjustments < cfg.max_tau_adjustments):
                st.events.append(MitigationEvent(
                    step, "tau_increase", int(s), (int(h),),
                    {"old": st.tau, "new": st.tau + cfg.tau_increase}))
                st.tau += cfg.tau_increase
                st.tau_adjustments += 1
            self._mitigate(step, int(s), int(h), router_demand)

    # ------------------------------------------------------------------ #
    def _mitigate(self, step: int, skewed: int, helper: int,
                  router_demand: np.ndarray) -> None:
        st, cfg = self.state, self.cfg
        per = cfg.n_slots // cfg.n_shards
        s_slots = range(skewed * per, (skewed + 1) * per)
        # Hottest expert on the skewed shard (by primary-slot EMA load).
        hot_slot = max(s_slots, key=lambda i: st.ema_load[i])
        hot_expert = int(st.slot_src[hot_slot])
        if hot_expert < 0:
            return
        loads = shard_loads(st, cfg)

        if cfg.mode is TransferMode.SBR:
            ok = self._replicate(step, hot_expert, hot_slot, skewed, helper, loads)
        else:
            ok = self._migrate(step, hot_expert, hot_slot, skewed, helper, loads)
        if ok:
            st.iterations += 1
            st.last_action_step = step

    def _helper_spare_slot(self, helper: int) -> Optional[int]:
        st, cfg = self.state, self.cfg
        per = cfg.n_slots // cfg.n_shards
        for i in range(helper * per, (helper + 1) * per):
            if st.slot_src[i] < 0:
                return i
        return None

    def _replicate(self, step, expert, hot_slot, skewed, helper, loads) -> bool:
        """SBR: copy the hot expert into a spare slot on the helper shard
        and split its future tokens to equalize shard loads (phase 2 math:
        r = (f_s - f_h) / (2 f_s), capped by the expert's own share)."""
        st, cfg = self.state, self.cfg
        replicas = int((st.slot_src == expert).sum())
        if replicas >= cfg.max_replicas_per_expert:
            return False
        spare = self._helper_spare_slot(helper)
        if spare is None:
            return False
        total = max(loads.sum(), 1e-9)
        f_s, f_h = loads[skewed] / total, loads[helper] / total
        hot_share = st.ema_load[hot_slot] / total
        r = float(np.clip((f_s - f_h) / 2.0, 0.0, hot_share)) / max(hot_share, 1e-9)
        if r <= 0.01:
            return False
        row = st.expert_routing[expert].copy()
        moved = row[hot_slot] * r
        row[hot_slot] -= moved
        row[spare] += moved
        st.expert_routing[expert] = row
        st.slot_src[spare] = expert
        self.pending_copies.append((spare, hot_slot, True))
        st.events.append(MitigationEvent(
            step, "sbr_replicate", skewed, (helper,),
            {"expert": expert, "slot": spare, "frac": round(moved, 4)}))
        return True

    def _migrate(self, step, expert, hot_slot, skewed, helper, loads) -> bool:
        """SBK: swap the hot expert's slot with the coldest slot on the
        helper shard (whole-key move; cannot split the hot expert)."""
        st, cfg = self.state, self.cfg
        per = cfg.n_slots // cfg.n_shards
        h_slots = [i for i in range(helper * per, (helper + 1) * per)
                   if st.slot_src[i] >= 0]
        if not h_slots:
            return False
        cold_slot = min(h_slots, key=lambda i: st.ema_load[i])
        cold_expert = int(st.slot_src[cold_slot])
        # Moving only helps if the hot expert outweighs the cold one.
        if st.ema_load[hot_slot] <= st.ema_load[cold_slot]:
            return False
        # Swap routing columns and slot sources.
        for e in (expert, cold_expert):
            row = st.expert_routing[e].copy()
            row[hot_slot], row[cold_slot] = row[cold_slot], row[hot_slot]
            st.expert_routing[e] = row
        st.slot_src[hot_slot], st.slot_src[cold_slot] = cold_expert, expert
        ema = st.ema_load.copy()
        ema[hot_slot], ema[cold_slot] = ema[cold_slot], ema[hot_slot]
        st.ema_load = ema
        self.pending_copies.append((hot_slot, cold_slot, False))  # swap marker
        st.events.append(MitigationEvent(
            step, "sbk_migrate", skewed, (helper,),
            {"expert": expert, "with": cold_expert}))
        return True

    # ------------------------------------------------------------------ #
    def apply_pending(self, moe_params: Dict[str, "torch.Tensor"],
                      bytes_per_slot: float = 0.0
                      ) -> Dict[str, "torch.Tensor"]:
        """Execute queued weight copies/swaps on a params dict of tensors
        with leading slot axis, in place (index copies on the tensors'
        device: the port updates where JAX rebuilds, which saves a copy of
        each expert stack).  Returns the dict; accounts migration bytes
        (the paper's state-migration cost M)."""
        st = self.state
        out = dict(moe_params)
        for dst, src, replicate in self.pending_copies:
            for name in ("w_gate", "w_up", "w_down"):
                w = out[name]
                with torch.no_grad():
                    if replicate:
                        w[dst] = w[src]
                    else:                      # swap (SBK migration)
                        tmp = w[dst].clone()
                        w[dst] = w[src]
                        w[src] = tmp
                st.bytes_migrated += float(np.prod(w.shape[1:])) * (
                    w.element_size()) * (1 if replicate else 2)
        self.pending_copies = []
        return out

    # ------------------------------------------------------------------ #
    def grad_merge_map(self) -> np.ndarray:
        """[P] -> primary slot of each slot's logical expert.

        Replica gradients are scattered state (§5.4); the trainer merges
        them into the primary every step (segment-sum) and re-broadcasts
        the updated weights — the watermark-triggered merge of §6.3."""
        st = self.state
        primary: Dict[int, int] = {}
        for slot, e in enumerate(st.slot_src):
            if e >= 0 and int(e) not in primary:
                primary[int(e)] = slot
        return np.array([
            primary.get(int(e), slot) if e >= 0 else slot
            for slot, e in enumerate(st.slot_src)
        ], dtype=np.int64)

    def representativeness(self, tokens_per_slot: np.ndarray,
                           router_demand: np.ndarray) -> float:
        """TV distance between processed-token and router-demand expert
        distributions (lower = the visible metrics are representative)."""
        st = self.state
        E = self.cfg.n_experts
        processed = np.zeros(E)
        for slot, e in enumerate(st.slot_src):
            if e >= 0:
                processed[int(e)] += tokens_per_slot[slot]
        p = processed / max(processed.sum(), 1e-9)
        q = router_demand / max(router_demand.sum(), 1e-9)
        return 0.5 * float(np.abs(p - q).sum())
