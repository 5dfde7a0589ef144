"""Reshape-on-MoE in the port: balancer invariants, the routed MoE layer
and the trainer's replica merge, each against the JAX package.

The JAX package's ``tests/test_moe_balancer.py`` runs its balancer over a
skewed MoE layer (one expert's router column boosted) for 24 steps; here
both packages run that loop on the same weights (``moe_init`` in JAX,
carried over) and the same numpy inputs, each with its own layer and its
own balancer, and every decision must be the same: events (kind, step,
shards, details), ``slot_src``, the merge map, ``bytes_migrated``, tau and
the expert weights after every copy, bit for bit.  The layers' float32
sums run in other orders (XLA's reduction order is neither sequential nor
torch's), so the per-step loads agree within ``1e-5`` relative, and the
routing table, whose split fractions are float64 arithmetic on those
loads, within ``1e-6`` relative (an event's fraction is rounded to 4
places and equal); the decisions sit far from their thresholds on these
inputs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moe_balancer as jbal
from repro.core.types import TransferMode as JMode
from repro.models import moe as jmoe
from repro_torch.core import moe_balancer as tbal
from repro_torch.core.types import TransferMode
from repro_torch.models import moe as tmoe
from repro_torch.train import trainer as ttrainer

EXPERT = ("w_gate", "w_up", "w_down")


def _skewed_moe(E=8, R=4, D=32, F=64, hot=0, boost=3.0):
    """The JAX suite's skewed layer (``tests/test_moe_balancer.py``), as
    numpy arrays."""
    p = jmoe.moe_init(jax.random.PRNGKey(0), D, F, E, n_replica_slots=R)
    p["router"] = p["router"].at[:, hot].add(boost)
    return {k: np.array(v) for k, v in p.items()}


def _x(step, n=256, d=32):
    return np.random.default_rng(step).standard_normal((n, d)).astype(
        np.float32)


def _bal_cfg(pkg, mode, R):
    return pkg.MoEBalancerConfig(n_experts=8, n_slots=8 + R, n_shards=4,
                                 mode=mode, min_steps_between=1)


def _run_port(mode, steps=24, R=4):
    cfg = _bal_cfg(tbal, mode, R)
    bal = tbal.MoEReshapeBalancer(cfg)
    p = {k: torch.from_numpy(v.copy()) for k, v in _skewed_moe(R=R).items()}
    spreads, loads, reprs = [], [], []
    for step in range(steps):
        _, stats = tmoe.moe_apply(
            p, torch.from_numpy(_x(step)), top_k=2, capacity_factor=1.0,
            expert_routing=torch.from_numpy(bal.state.expert_routing),
            return_stats=True)
        tps = stats["tokens_per_expert"].numpy()
        dem = stats["tokens_per_expert_router"].numpy()
        loads.append(tps)
        reprs.append(bal.representativeness(tps, dem))
        bal.observe(step, tps, dem)
        if bal.pending_copies:
            bal.apply_pending(p)
        sl = tbal.shard_loads(bal.state, cfg)
        spreads.append(sl.max() / max(sl.mean(), 1e-9))
    return bal, spreads, loads, reprs, p


def _run_jax(mode, steps=24, R=4):
    cfg = _bal_cfg(jbal, mode, R)
    bal = jbal.MoEReshapeBalancer(cfg)
    p = {k: jnp.asarray(v) for k, v in _skewed_moe(R=R).items()}
    loads = []
    for step in range(steps):
        _, stats = jmoe.moe_apply(
            p, jnp.asarray(_x(step)), top_k=2, capacity_factor=1.0,
            expert_routing=jnp.asarray(bal.state.expert_routing),
            return_stats=True)
        tps = np.asarray(stats["tokens_per_expert"])
        dem = np.asarray(stats["tokens_per_expert_router"])
        loads.append(tps)
        bal.observe(step, tps, dem)
        if bal.pending_copies:
            p.update(bal.apply_pending({k: p[k] for k in EXPERT}))
    return bal, loads, p


def _events(bal):
    return [dataclasses.astuple(e) for e in bal.state.events]


# --------------------------------------------------------------------- #
# The balancer against the JAX package's                                 #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode,R", [("SBR", 4), ("SBK", 0)])
def test_balancer_decisions_equal_jax(mode, R):
    tb, _, tloads, _, tp = _run_port(TransferMode[mode], R=R)
    jb, jloads, jp = _run_jax(JMode[mode], R=R)
    for a, b in zip(tloads, jloads):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert _events(tb) == _events(jb)
    assert tb.state.events, "the skew was never mitigated"
    np.testing.assert_allclose(tb.state.expert_routing,
                               jb.state.expert_routing, rtol=1e-6, atol=0)
    assert ((tb.state.expert_routing > 0)
            == (jb.state.expert_routing > 0)).all()
    np.testing.assert_array_equal(tb.state.slot_src, jb.state.slot_src)
    np.testing.assert_array_equal(tb.grad_merge_map(), jb.grad_merge_map())
    assert tb.state.bytes_migrated == jb.state.bytes_migrated
    assert (tb.state.tau, tb.state.iterations) == (jb.state.tau,
                                                   jb.state.iterations)
    for k in EXPERT:                   # the same copies, in the same order
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(jp[k]))


# --------------------------------------------------------------------- #
# The JAX suite's mechanics, on the port                                 #
# --------------------------------------------------------------------- #
class TestBalancerMechanics:
    def test_sbr_replication_balances_shards(self):
        bal, spreads, *_ = _run_port(TransferMode.SBR)
        assert np.mean(spreads[-5:]) < 0.8 * spreads[0]
        assert any(e.kind == "sbr_replicate" for e in bal.state.events)
        np.testing.assert_allclose(bal.state.expert_routing.sum(1), 1.0)

    def test_sbk_migration_balances_shards(self):
        bal, *_ = _run_port(TransferMode.SBK, R=0)
        assert any(e.kind == "sbk_migrate" for e in bal.state.events)
        np.testing.assert_allclose(bal.state.expert_routing.sum(1), 1.0)
        assert set(np.unique(bal.state.expert_routing)) <= {0.0, 1.0}

    def test_replica_slots_tracked_and_merge_map(self):
        bal, *_, p = _run_port(TransferMode.SBR)
        st = bal.state
        mm = bal.grad_merge_map()
        for slot, e in enumerate(st.slot_src):
            if e >= 0:
                assert st.slot_src[mm[slot]] == e
                # a replica holds its primary's weights, bit for bit
                for k in EXPERT:
                    assert torch.equal(p[k][slot], p[k][mm[slot]])
        counts = np.bincount(st.slot_src[st.slot_src >= 0], minlength=8)
        assert counts.max() >= 2

    def test_migration_bytes_accounted(self):
        bal, *_ = _run_port(TransferMode.SBR)
        copies = sum(1 for e in bal.state.events if e.kind == "sbr_replicate")
        # three float32 stacks of 32 x 64 a replicated slot
        assert bal.state.bytes_migrated == copies * 3 * 32 * 64 * 4

    def test_representativeness_improves(self):
        _, _, _, reprs, _ = _run_port(TransferMode.SBR)
        assert np.mean(reprs[-5:]) < np.mean(reprs[:3])

    def test_apply_pending_swaps_in_place(self):
        bal = tbal.MoEReshapeBalancer(_bal_cfg(tbal, TransferMode.SBK, 0))
        p = {k: torch.arange(8.0).reshape(8, 1, 1).repeat(1, 2, 3)
             for k in EXPERT}
        ids = {k: id(v) for k, v in p.items()}
        bal.pending_copies = [(1, 6, False), (3, 0, True)]
        out = bal.apply_pending(p)
        for k in EXPERT:
            assert id(out[k]) == ids[k]
            assert out[k][:, 0, 0].tolist() == [0, 6, 2, 0, 4, 5, 1, 7]
        assert bal.state.bytes_migrated == 3 * 6 * 4 * (2 + 1)
        assert bal.pending_copies == []


# --------------------------------------------------------------------- #
# The routed MoE layer                                                   #
# --------------------------------------------------------------------- #
def _routing_rows(E, P, seed):
    """Row-stochastic [E, P] tables as the balancer builds them: identity,
    then some rows split over a primary and up to 4 other slots by
    fractions that are no dyadic numbers (their float32 CDF rounds)."""
    rng = np.random.default_rng(seed)
    r = np.zeros((E, P))
    r[np.arange(E), np.arange(E)] = 1.0
    spare = list(range(E, P))
    for e in rng.permutation(E)[:min(E, max(1, (P - E) // 2))]:
        k = int(rng.integers(1, 5))
        slots = [spare.pop() for _ in range(min(k, len(spare)))]
        if not slots:
            break
        w = rng.dirichlet(np.ones(len(slots) + 1) * 0.7)
        r[e, e] = w[0]
        r[e, slots] = w[1:]
    return r


@pytest.mark.parametrize("E,P", [(8, 12), (8, 40), (64, 72)])
def test_slot_cdf_and_pick_equal_jax_bit_for_bit(E, P):
    """The pick's CDF is XLA's blocked cumsum (16-column blocks), not a
    sequential one; where they differ in a last bit a Weyl number on the
    boundary could pick another slot.  The port's CDF and pick equal JAX's
    (``moe.py:119-123``) bit for bit, also at u exactly on CDF entries."""
    for seed in range(6):
        route = _routing_rows(E, P, seed).astype(np.float32)
        want = np.asarray(jnp.cumsum(jnp.asarray(route), axis=1))
        got = tmoe.slot_cdf(torch.from_numpy(route)).numpy()
        np.testing.assert_array_equal(got, want)
        n = 4096
        u = jnp.mod((jnp.arange(n, dtype=jnp.float32) + 1.0)
                    * 0.618033988749895, 1.0)
        jpick = np.minimum(
            np.asarray((u[:, None, None] >= jnp.asarray(want)[None]).sum(-1)),
            P - 1)
        np.testing.assert_array_equal(
            tmoe.slot_pick(torch.from_numpy(route), n).numpy(), jpick)
    # a table whose entries are the Weyl numbers themselves
    u = np.asarray(jnp.mod((jnp.arange(8, dtype=jnp.float32) + 1.0)
                           * 0.618033988749895, 1.0))
    route = np.zeros((E, P), np.float32)
    route[:, 0] = u[1]
    route[:, 1] = 1.0 - u[1]
    jcdf = jnp.cumsum(jnp.asarray(route), axis=1)
    jpick = np.minimum(np.asarray((jnp.asarray(u)[:, None, None]
                                   >= jcdf[None]).sum(-1)), P - 1)
    np.testing.assert_array_equal(
        tmoe.slot_pick(torch.from_numpy(route), 8).numpy(), jpick)


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
def test_routed_moe_apply_matches_jax(capacity_factor):
    """Output and stats of the layer with a split table, float32: equal
    picks, sums in other orders (``1e-5``)."""
    E, R = 8, 4
    p = _skewed_moe(E=E, R=R)
    route = _routing_rows(E, E + R, 3).astype(np.float32)
    x = _x(7, 200)
    jout, jst = jmoe.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), top_k=2,
                               capacity_factor=capacity_factor,
                               expert_routing=jnp.asarray(route),
                               return_stats=True)
    tout, tst = tmoe.moe_apply({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), top_k=2,
                               capacity_factor=capacity_factor,
                               expert_routing=torch.from_numpy(route),
                               return_stats=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    for k in ("tokens_per_expert", "tokens_per_expert_router",
              "dropped_frac", "load_std", "aux_loss"):
        np.testing.assert_allclose(tst[k].detach().numpy(),
                                   np.asarray(jst[k]), rtol=1e-5, atol=1e-5)


class TestMoEDataPlane:
    def test_identity_routing_matches_no_routing(self):
        p = {k: torch.from_numpy(v) for k, v in _skewed_moe(R=0).items()}
        x = torch.from_numpy(_x(0, 64))
        a = tmoe.moe_apply(p, x, top_k=2, capacity_factor=2.0)
        b = tmoe.moe_apply(p, x, top_k=2, capacity_factor=2.0,
                           expert_routing=torch.eye(8))
        assert torch.equal(a, b)

    def test_replica_split_preserves_output(self):
        """Splitting a hot expert between two slots holding identical
        weights does not change the layer's output."""
        E, R = 4, 1
        p = {k: torch.from_numpy(v) for k, v in
             _skewed_moe(E=E, R=R, boost=0.0).items()}
        for n in EXPERT:
            p[n][4] = p[n][0]
        routing = torch.eye(E, E + R)
        routing[0, 0] = routing[0, 4] = 0.5
        x = torch.from_numpy(_x(0, 64))
        base = tmoe.moe_apply(p, x, top_k=2, capacity_factor=4.0)
        split = tmoe.moe_apply(p, x, top_k=2, capacity_factor=4.0,
                               expert_routing=routing)
        torch.testing.assert_close(split, base, atol=1e-5, rtol=0)

    def test_capacity_drops_tokens_on_hot_expert(self):
        p = {k: torch.from_numpy(v) for k, v in
             _skewed_moe(R=0, boost=5.0).items()}
        _, stats = tmoe.moe_apply(p, torch.from_numpy(_x(0)), top_k=2,
                                  capacity_factor=0.5, return_stats=True)
        assert float(stats["dropped_frac"]) > 0.05


# --------------------------------------------------------------------- #
# The trainer's replica merge                                            #
# --------------------------------------------------------------------- #
def test_replica_grad_merge_equals_jax():
    """Merging replica grads into their primary and re-broadcasting the
    primaries equal the JAX package's functions (the port's per-layer
    dicts against JAX's stacked leaves)."""
    from repro.train.trainer import broadcast_replicas, merge_replica_grads
    L, P = 2, 6
    mm = np.stack([[0, 1, 2, 3, 0, 0], [0, 1, 2, 1, 4, 5]])
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (L, P, 4, 4)))
    jmerged = merge_replica_grads(
        {"blocks": {"moe": {n: jnp.asarray(g) for n in EXPERT}}},
        jnp.asarray(mm), L)["blocks"]["moe"]
    tg = {"blocks": [{"moe": {n: torch.from_numpy(g[i].copy())
                              for n in EXPERT}} for i in range(L)]}
    ttrainer.merge_replica_grads(tg, torch.from_numpy(mm))
    for i in range(L):
        for n in EXPERT:
            np.testing.assert_array_equal(tg["blocks"][i]["moe"][n].numpy(),
                                          np.asarray(jmerged[n][i]))
    jb = broadcast_replicas(
        {"blocks": {"moe": {n: jnp.asarray(g) for n in EXPERT}}},
        jnp.asarray(mm))["blocks"]["moe"]
    tp = {"blocks": [{"moe": {n: torch.from_numpy(g[i].copy())
                              for n in EXPERT}} for i in range(L)]}
    ttrainer.broadcast_replicas(tp, torch.from_numpy(mm))
    for i in range(L):
        for n in EXPERT:
            np.testing.assert_array_equal(tp["blocks"][i]["moe"][n].numpy(),
                                          np.asarray(jb[n][i]))


def test_balancer_in_training_loop():
    from repro_torch.configs import get_smoke
    from repro_torch.train import TrainConfig, Trainer
    from repro_torch.train.optimizer import AdamWConfig
    cfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), moe_replica_slots=4)
    tc = TrainConfig(
        opt=AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=40),
        remat=False,
        moe_balancer=tbal.MoEBalancerConfig(n_experts=8, n_slots=12,
                                            n_shards=4, min_steps_between=2))
    tr = Trainer(cfg, tc, device="cpu")
    for b in tr.params["blocks"]:            # a hot expert, as above
        b["moe"]["router"][:, 0] += 3.0
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (4, 32))
    batch = {"tokens": toks, "labels": toks}
    losses = []
    for _ in range(6):
        losses.append(tr.train_step(batch)["loss"])
        for bal, b in zip(tr.balancers, tr.params["blocks"]):
            mm = bal.grad_merge_map()
            for s, m in enumerate(mm):
                for n in EXPERT:
                    assert torch.equal(b["moe"][n][s], b["moe"][n][m])
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()
    assert any(e.kind == "sbr_replicate" for b in tr.balancers
               for e in b.state.events)
