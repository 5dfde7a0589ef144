"""Mixture-of-Experts layer with capacity-bounded gather dispatch, in PyTorch.

The port of ``repro.models.moe``.  Token->expert routing is the paper's
partitioning skew (tuples->keys): a hot expert is a heavy-hitter key.  The
three expert products go through K4
(:func:`repro_torch.kernels.segment_matmul.segment_matmul_ad`, K4 with K4
as its backward), exactly where the JAX layer computes them
(``moe.py:161-164``).

The Reshape balancer's ``expert_routing`` table (``[E, P]``,
row-stochastic) maps the logical experts onto ``P = E + R`` physical
slots, ``R`` of them spare slots for replicas (``moe_init(...,
n_replica_slots=R)``); a token of a split expert goes to the slot its
float32 Weyl number ``u = mod((n + 1) * 0.618033988749895, 1)`` picks
against the row's CDF, as in JAX.  Not ported yet (it raises): the
DP-local dispatch (``token_groups > 1``).  Shared experts are not ported
either (no ported configuration has them).

Three choices keep the bits of the JAX layer:

* top-k ties: ``lax.top_k`` keeps the lower expert index among equal
  gates, ``torch.topk`` promises no order; :func:`router_topk` takes the
  first k of a stable descending sort;
* the routing CDF: JAX's ``jnp.cumsum`` over a row of P slots is XLA's
  blocked sum (sequential within blocks of 16 columns, the blocks' totals
  summed the same way, recursively), not a sequential one;
  :func:`slot_cdf` repeats it with elementwise float32 adds, so the card
  and the host pick the same slots as JAX;
* the combine: JAX scatter-adds each token's expert outputs in the working
  dtype in slot order, i.e. by ascending slot.  A scatter-add on the card
  adds with atomics in no fixed order, so each token gathers its kept slots
  in ascending order and adds them one by one.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import segment_matmul as k4
from .layers import Params, dense_init, truncated_normal


def moe_init(gen: torch.Generator, d_model: int, d_expert: int,
             n_experts: int, *, n_replica_slots: int = 0,
             dtype=torch.float32) -> Params:
    """The router ``[D, E]`` (logical experts) and the expert weights
    stacked on a leading physical slot axis of ``P = E + n_replica_slots``
    (the spare slots the balancer installs replicas into)."""
    P = n_experts + n_replica_slots
    return {
        "router": dense_init(gen, d_model, n_experts, dtype, scale=0.02),
        "w_gate": truncated_normal((P, d_model, d_expert), gen,
                                   std=d_model ** -0.5, dtype=dtype),
        "w_up": truncated_normal((P, d_model, d_expert), gen,
                                 std=d_model ** -0.5, dtype=dtype),
        "w_down": truncated_normal((P, d_expert, d_model), gen,
                                   std=d_expert ** -0.5, dtype=dtype),
    }


def router_topk(logits: torch.Tensor, top_k: int, *,
                renormalize: bool = True):
    """Top-k gating: (weights ``[N, k]`` float32, indices ``[N, k]``).

    Among equal gates the lower expert index comes first, as with
    ``lax.top_k``."""
    gates = torch.softmax(logits.float(), dim=-1)
    weights, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    weights, idx = weights[:, :top_k], idx[:, :top_k]
    if renormalize:
        weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                        min=1e-9)
    return weights, idx


def moe_apply(
    p: Params,
    x: torch.Tensor,                        # [B, S, D] or [N, D]
    *,
    top_k: int,
    capacity_factor: float = 1.25,
    expert_routing: Optional[torch.Tensor] = None,
    return_stats: bool = False,
    token_groups: int = 1,
):
    """Capacity-bounded top-k MoE (``repro.models.moe.moe_apply`` with
    ``token_groups = 1``).

    ``expert_routing``: optional row-stochastic ``[E, P]`` table from the
    Reshape balancer remapping logical experts to physical slots (SBK: a
    row's 1 moved; SBR: a row split between a primary and a replica slot,
    the hot expert's tokens divided by a low-discrepancy record split).
    Without it the logical experts are slots ``0 .. E-1`` of ``P``."""
    if token_groups != 1:
        raise NotImplementedError(
            "the DP-local dispatch (token_groups > 1) is not ported "
            "(ROADMAP.md)")
    orig_shape = x.shape
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    P = p["w_gate"].shape[0]                           # physical slots
    E = p["router"].shape[1]                           # logical experts
    dt = x.dtype
    dev = x.device

    logits = xf @ p["router"].to(dt)                   # [N, E]
    weights, idx = router_topk(logits, top_k)          # [N, k]
    gates_full = torch.zeros((N, E), dtype=torch.float32, device=dev)
    gates_full = gates_full.scatter(1, idx, weights)   # [N, E]
    if expert_routing is not None:
        # Each token's expert e lands in slot pick[n, e] (a split expert's
        # tokens spread over its slots); a slot holds one expert.
        pick = slot_pick(expert_routing, N)            # [N, E] slot of e
        combine = torch.zeros((N, P), dtype=torch.float32, device=dev)
        combine = combine.scatter_add(1, pick, gates_full)
        chosen = torch.gather(pick, 1, idx)            # [N, k] slots
    else:
        combine = F.pad(gates_full, (0, P - E))
        chosen = idx

    # Capacity per physical slot; each token's position in its slot queue
    # by arrival order.
    cap = int(max(1, round(capacity_factor * N * top_k / E)))
    dispatch = (combine > 0).to(torch.int32)
    pos = torch.cumsum(dispatch, dim=0, dtype=torch.int32) - dispatch
    keep = dispatch.bool() & (pos < cap)
    combine_c = combine * keep
    dropped = (combine > 0) & ~keep

    token_for_slot, gate_for_slot = slot_tables(keep, pos, combine_c, cap)
    # The kept tokens of slot e fill its rows 0 .. rows[e] - 1 (pos counts
    # them in arrival order); every later row is the zero sentinel row, and
    # stays zero through silu(gate) * up, so K4 computes only the first
    # rows[e] rows and zeroes the rest.
    rows = keep.sum(0).to(torch.int32)                 # [P], on the device

    xf_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    h_in = xf_pad[token_for_slot].to(dt)               # [P, cap, D]
    gate = k4.segment_matmul_ad(h_in, p["w_gate"].to(dt), rows)
    up = k4.segment_matmul_ad(h_in, p["w_up"].to(dt), rows)
    act = F.silu(gate) * up                            # [P, cap, F]
    out_e = k4.segment_matmul_ad(act, p["w_down"].to(dt), rows)
    out_e = out_e * gate_for_slot[..., None].to(dt)

    # Combine: each token adds its kept slots by ascending slot, in dt.
    chosen = torch.sort(chosen, dim=1).values
    kept = torch.gather(keep, 1, chosen)
    slots = torch.where(kept, chosen * cap + torch.gather(pos, 1, chosen),
                        P * cap)
    out_rows = torch.cat([out_e.reshape(P * cap, D),
                          out_e.new_zeros((1, D))])
    out = torch.zeros((N, D), dtype=dt, device=dev)
    for j in range(slots.shape[1]):
        out = out + out_rows[slots[:, j]]

    out = out.reshape(orig_shape)
    if not return_stats:
        return out
    stats = {
        "tokens_per_expert": combine_c.sum(0),                 # post-mitigation
        "tokens_per_expert_router": gates_full.sum(0),         # router's truth
        "dropped_frac": dropped.float().mean(),
        "load_std": combine.sum(0).std(unbiased=False),
        "aux_loss": load_balance_aux_loss(logits, idx, E),
    }
    return out, stats


#: The Weyl step of the SBR record split (``moe.py:118``), and the column
#: block of XLA's cumulative sum on the CPU.
WEYL = 0.618033988749895
_CUMSUM_BLOCK = 16


def slot_cdf(route: torch.Tensor) -> torch.Tensor:
    """``jnp.cumsum(route, axis=1)`` of a float32 ``[E, P]`` table, bit for
    bit as XLA computes it on the CPU: a sequential sum within each block
    of 16 columns, and the blocks' running totals (the same rule,
    recursively) added to every later block.  Elementwise adds only, so
    the card gives the same bits."""
    E, P = route.shape
    if P <= _CUMSUM_BLOCK:
        cols = [route[:, 0]]
        for j in range(1, P):
            cols.append(cols[-1] + route[:, j])
        return torch.stack(cols, dim=1)
    nb = -(-P // _CUMSUM_BLOCK)
    padded = torch.zeros((E, nb * _CUMSUM_BLOCK), dtype=route.dtype,
                         device=route.device)
    padded[:, :P] = route
    within = slot_cdf(padded.reshape(E * nb, _CUMSUM_BLOCK)).reshape(
        E, nb, _CUMSUM_BLOCK)
    before = slot_cdf(within[:, :, -1])                # [E, nb]
    out = torch.cat([within[:, :1],
                     within[:, 1:] + before[:, :-1, None]], dim=1)
    return out.reshape(E, -1)[:, :P]


def slot_pick(expert_routing: torch.Tensor, n: int) -> torch.Tensor:
    """``[n, E]``: the physical slot of token i's expert e, the number of
    CDF entries of row e at or below ``u_i = mod((i + 1) * WEYL, 1)`` in
    float32 (``WEYL`` rounded to float32 first, as JAX's weak-typed
    constant), at most ``P - 1``."""
    route = expert_routing.to(torch.float32)
    P = route.shape[1]
    dev = route.device
    u = torch.remainder(
        (torch.arange(n, dtype=torch.float32, device=dev) + 1.0)
        * torch.tensor(WEYL, dtype=torch.float32, device=dev), 1.0)
    cdf = slot_cdf(route)
    pick = (u[:, None, None] >= cdf[None]).sum(-1)
    return torch.clamp(pick, max=P - 1)


def slot_tables(keep: torch.Tensor, pos: torch.Tensor,
                combine_c: torch.Tensor, cap: int):
    """``[P, cap]`` token of each slot (``N`` = empty) and its gate, from
    the kept (token, slot) pairs ``keep [N, P]`` at queue positions ``pos``;
    the sentinel cell ``P * cap`` takes the writes of dropped pairs, as
    JAX's ``mode="drop"``."""
    N, P = keep.shape
    dev = keep.device
    arange_p = torch.arange(P, device=dev, dtype=torch.int64)
    flat_slot = torch.where(keep, arange_p[None, :] * cap + pos, P * cap)
    token_ids = torch.arange(N, device=dev, dtype=torch.int64)[:, None]
    token_for_slot = torch.full((P * cap + 1,), N, dtype=torch.int64,
                                device=dev)
    token_for_slot[flat_slot.reshape(-1)] = token_ids.expand(N, P).reshape(-1)
    gate_for_slot = torch.zeros((P * cap + 1,), dtype=torch.float32,
                                device=dev)
    gate_for_slot[flat_slot.reshape(-1)] = combine_c.reshape(-1)
    return (token_for_slot[:P * cap].reshape(P, cap),
            gate_for_slot[:P * cap].reshape(P, cap))


def load_balance_aux_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e."""
    gates = torch.softmax(logits.float(), dim=-1)
    pe = gates.mean(0)
    fe = F.one_hot(idx[:, 0], n_experts).float().mean(0)
    return n_experts * torch.sum(fe * pe)
