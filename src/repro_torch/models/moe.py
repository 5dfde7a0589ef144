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
against the row's CDF, as in JAX.  ``token_groups = G > 1`` is JAX's
DP-local dispatch (``moe.py:191-286``): capacity, queue positions and
slot tables per group of ``N / G`` tokens, each expert product one K4 call
over the groups' queues laid slot by slot (the weights are not repeated
per group).  Shared experts (``moe_init(..., n_shared=...)``, DeepSeek-V2's)
are a SwiGLU on every token added after the combine in both dispatches, as
JAX adds them (``moe.py:172-176``, ``:269-273``): plain matmuls outside any
kernel, as in JAX.

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
from .layers import Params, dense_init, swiglu, truncated_normal


def moe_init(gen: torch.Generator, d_model: int, d_expert: int,
             n_experts: int, *, n_shared: int = 0,
             d_shared: Optional[int] = None, n_replica_slots: int = 0,
             dtype=torch.float32) -> Params:
    """The router ``[D, E]`` (logical experts) and the expert weights
    stacked on a leading physical slot axis of ``P = E + n_replica_slots``
    (the spare slots the balancer installs replicas into); with
    ``n_shared``, ``shared``: one SwiGLU of width ``d_shared`` (default
    ``d_expert * n_shared``) that every token passes."""
    P = n_experts + n_replica_slots
    p: Params = {
        "router": dense_init(gen, d_model, n_experts, dtype, scale=0.02),
        "w_gate": truncated_normal((P, d_model, d_expert), gen,
                                   std=d_model ** -0.5, dtype=dtype),
        "w_up": truncated_normal((P, d_model, d_expert), gen,
                                 std=d_model ** -0.5, dtype=dtype),
        "w_down": truncated_normal((P, d_expert, d_model), gen,
                                   std=d_expert ** -0.5, dtype=dtype),
    }
    if n_shared > 0:
        ds = d_shared or d_expert * n_shared
        p["shared"] = {
            "w_gate": dense_init(gen, d_model, ds, dtype),
            "w_up": dense_init(gen, d_model, ds, dtype),
            "w_down": dense_init(gen, ds, d_model, dtype, scale=ds ** -0.5),
        }
    return p


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
    """Capacity-bounded top-k MoE (``repro.models.moe.moe_apply``).

    ``expert_routing``: optional row-stochastic ``[E, P]`` table from the
    Reshape balancer remapping logical experts to physical slots (SBK: a
    row's 1 moved; SBR: a row split between a primary and a replica slot,
    the hot expert's tokens divided by a low-discrepancy record split).
    Without it the logical experts are slots ``0 .. E-1`` of ``P``.

    ``token_groups``: G > 1 is JAX's DP-local dispatch
    (``_moe_apply_grouped``; its ``maybe_shard`` layout hints mean nothing
    on one card and are dropped): the ``N`` tokens split into G groups of
    ``N / G`` (``ValueError`` where G does not divide N), each with its
    own capacity ``round(cf * N / G * k / E)``, queue positions and slot
    tables.  Router, top-k and the slot pick's Weyl numbers run over all
    N tokens.  G = 1 is the global dispatch."""
    orig_shape = x.shape
    D = x.shape[-1]
    xf = x.reshape(-1, D)
    N = xf.shape[0]
    G = int(token_groups)
    if G < 1 or N % G:
        raise ValueError(f"{N} tokens do not split into {G} token groups")
    Nl = N // G
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
        # tokens spread over its slots, by the token's number among all
        # N); a slot holds one expert.
        pick = slot_pick(expert_routing, N)            # [N, E] slot of e
        combine = torch.zeros((N, P), dtype=torch.float32, device=dev)
        combine = combine.scatter_add(1, pick, gates_full)
        chosen = torch.gather(pick, 1, idx)            # [N, k] slots
    else:
        combine = F.pad(gates_full, (0, P - E))
        chosen = idx

    # Capacity per physical slot and group; each token's position in its
    # group's slot queue by arrival order.
    cap = int(max(1, round(capacity_factor * Nl * top_k / E)))
    cg = combine.reshape(G, Nl, P)
    dispatch = (cg > 0).to(torch.int32)
    pos = torch.cumsum(dispatch, dim=1, dtype=torch.int32) - dispatch
    keep = dispatch.bool() & (pos < cap)               # [G, Nl, P]
    cg_c = cg * keep
    dropped = (cg > 0) & ~keep

    live = keep.sum(1, dtype=torch.int32)              # [G, P]
    keep, pos, cg_c = (t.reshape(N, P) for t in (keep, pos, cg_c))

    # The groups' slot tables in one call: token n queues in column
    # g * P + p of its own group g = n // Nl, so the tables lie side by side
    # ([G * P, cap], global token numbers, N the zero sentinel row).  K4
    # takes them slot by slot, [P, G * cap]: slot p's rows g * cap ..
    # g * cap + cap - 1 are group g's queue, its kept tokens first.  K4
    # computes each slot's rows up to the last live one of its last live
    # group (``rows``); the dead rows before it are the sentinel, zero
    # through silu(gate) * up and the down product, so only their compute
    # is spent.
    group = torch.arange(N, device=dev)[:, None] // Nl
    tables_in = (keep, pos, cg_c)
    if G > 1:
        own = group == torch.arange(G, device=dev)     # [N, G]
        tables_in = ((own[:, :, None] & keep[:, None]).reshape(N, G * P),
                     pos.repeat(1, G), cg_c.repeat(1, G))
    token_for_slot, gate_for_slot = slot_tables(*tables_in, cap)
    token_for_slot, gate_for_slot = (
        t.reshape(G, P, cap).transpose(0, 1).reshape(P, G * cap)
        for t in (token_for_slot, gate_for_slot))
    ends = torch.arange(G, device=dev, dtype=torch.int32)[:, None] * cap
    rows = torch.where(live > 0, ends + live, 0).amax(0).to(torch.int32)

    # The gathers here are embedding lookups with the sentinel as their
    # padding row: the backward adds each token's k rows and skips the
    # sentinel's, where an indexing backward adds the (tens of thousands
    # of) dead or dropped rows into the sentinel one after another.
    xf_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    h_in = F.embedding(token_for_slot, xf_pad,
                       padding_idx=N).to(dt)           # [P, G * cap, D]
    gate = k4.segment_matmul_ad(h_in, p["w_gate"].to(dt), rows)
    up = k4.segment_matmul_ad(h_in, p["w_up"].to(dt), rows)
    act = F.silu(gate) * up                            # [P, G * cap, F]
    out_e = k4.segment_matmul_ad(act, p["w_down"].to(dt), rows)
    out_e = out_e * gate_for_slot[..., None].to(dt)

    # Combine: each token adds its kept slots by ascending slot, in dt.
    chosen = torch.sort(chosen, dim=1).values
    kept = torch.gather(keep, 1, chosen)
    slots = torch.where(
        kept, chosen * (G * cap) + group * cap + torch.gather(pos, 1, chosen),
        P * G * cap)
    out_rows = torch.cat([out_e.reshape(P * G * cap, D),
                          out_e.new_zeros((1, D))])
    picked = F.embedding(slots, out_rows, padding_idx=P * G * cap)
    out = torch.zeros((N, D), dtype=dt, device=dev)
    for j in range(slots.shape[1]):
        out = out + picked[:, j]
    if "shared" in p:
        out = out + swiglu(xf, p["shared"])

    out = out.reshape(orig_shape)
    if not return_stats:
        return out
    stats = {
        "tokens_per_expert": cg_c.sum(0),                      # post-mitigation
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
    the kept (token, slot) pairs ``keep [N, P]`` at queue positions ``pos``.
    The other pairs' writes go past the tables, each to a cell of its own,
    and are dropped, as JAX's ``mode="drop"`` drops them: one shared
    sentinel cell would take them all, one after another."""
    N, P = keep.shape
    dev = keep.device
    arange_p = torch.arange(P, device=dev, dtype=torch.int64)
    spare = P * cap + torch.arange(N * P, device=dev).reshape(N, P)
    flat_slot = torch.where(keep, arange_p[None, :] * cap + pos,
                            spare).reshape(-1)
    token_ids = torch.arange(N, device=dev, dtype=torch.int64)[:, None]
    token_for_slot = torch.full((P * cap + N * P,), N, dtype=torch.int64,
                                device=dev)
    token_for_slot[flat_slot] = token_ids.expand(N, P).reshape(-1)
    gate_for_slot = torch.zeros((P * cap + N * P,), dtype=torch.float32,
                                device=dev)
    gate_for_slot[flat_slot] = combine_c.reshape(-1)
    return (token_for_slot[:P * cap].reshape(P, cap),
            gate_for_slot[:P * cap].reshape(P, cap))


def load_balance_aux_loss(logits: torch.Tensor, idx: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * P_e."""
    gates = torch.softmax(logits.float(), dim=-1)
    pe = gates.mean(0)
    fe = F.one_hot(idx[:, 0], n_experts).float().mean(0)
    return n_experts * torch.sum(fe * pe)
