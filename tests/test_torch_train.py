"""The training slice of the port against the JAX package, on the CPU.

The JAX model's weights (``repro.models.init_params``, seed 0) are carried
into the port with ``params_from_jax`` (and an AdamW state with
``adamw_state_from_jax``); tokens come from numpy seeds and go to both.
Smoke configurations of ``olmoe-1b-7b`` (K4 on its path, forward and
backward; with and without 4 replica slots and an SBR routing table, and
with the DP-local dispatch over 4 token groups), ``llama3.2-3b`` (K5's GQA
grouping, forward and backward), ``rwkv6-1.6b`` (K6, forward and
backward; no balancer), ``internvl2-2b`` (the vlm family: seeded patch
embeddings ahead of the tokens, the loss on the text positions),
``minicpm3-4b`` (MLA: K5 at unequal widths) and ``deepseek-v2-lite-16b``
(MLA, a dense first layer, shared experts; with 4 replica slots and an SBR
table on its scanned layers), on the port's CPU path, where K4, K5 and K6
run their plain versions.

Tolerances, stated from the arithmetic:

* ``compute_dtype="float32"``: the two frameworks sum in other orders, so
  the loss agrees within ``1e-5`` relative and each gradient leaf within
  ``1e-5`` of its largest entry (measured: ~1.3e-6);
* ``compute_dtype="bfloat16"`` (llama): one rounding of a matmul output
  may land on the other side (2^-8 relative) and the backward carries it
  through every layer, so the loss agrees within ``1e-3`` and each
  gradient leaf within ``0.05`` of its largest entry (measured: 0.025).
  The MoE is left out in bf16: a near-tie of router logits that rounds the
  other way moves a token's experts, and then its gradients are others.
  RWKV6's loss in bf16 agrees within ``1e-3`` relative (``6e-3`` at its
  loss of ~6.1): XLA fuses the jitted model's bf16 elementwise ops and
  rounds at the fusions' outputs, the port (and JAX run op by op) rounds
  each op, and the recurrence carries a flipped rounding over every later
  step; JAX's own jitted and op-by-op losses differ by ``2.0e-3`` on this
  case, the port's lies ``1.4e-3`` from the jitted one (its layers equal
  JAX's op by op bit for bit, ``tests/test_torch_rwkv.py``).  MiniCPM3's
  (MLA) loss in bf16 agrees within ``1e-3`` relative too: its SwiGLU's
  fused ``F.silu`` rounds once where ``jax.nn.silu`` rounds each op, and
  in its two layers (d_ff 128) that moves its loss of ~6.2 by ``2.2e-3``
  from JAX's jitted loss (``1.6e-3`` from JAX op by op, against which the port
  is bit for bit the same with ``layers.silu`` in its SwiGLU: measured;
  JAX's own jitted and op-by-op losses differ by ``6.4e-4``);
* the optimizer: ``schedule`` within one float32 ulp (the libraries'
  ``cos`` and ``pow``), an update within ``1e-6`` (XLA fuses the moments'
  multiply-adds, the port rounds each op), compression bit for bit;
* three trainer steps: AdamW's first step moves each parameter by
  ``lr * m / sqrt(v) = lr * sign(g)``, so a gradient that is rounding
  noise may flip and move it by ``2 lr``: every parameter lies within
  ``2 sum(lr)`` of JAX's, and 99% of each leaf within ``1e-5``.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core import moe_balancer as jbal
from repro.data import pipeline as jpipe
from repro.dist import compression as jcomp
from repro.models import model as jm
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_smoke
from repro_torch.core import moe_balancer as tbal
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import compression as tcomp
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tm
from repro_torch.models.convert import adamw_state_from_jax, params_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import leaves, tree_map

KEY = jax.random.PRNGKey(0)


def _cfgs(arch, compute_dtype="float32", **kw):
    return (dataclasses.replace(jget_smoke(arch), compute_dtype=compute_dtype,
                                **kw),
            dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype,
                                **kw))


def _batch(vocab, seed=0, shape=(2, 16), patches=None):
    """Tokens and labels; for the vlm family (``patches = (n_patches,
    d_model)``) also float32 patch embeddings at the embedding table's
    scale (std 0.02), drawn after them."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
           "labels": rng.integers(0, vocab, shape).astype(np.int32)}
    if patches:
        out["patches"] = (0.02 * rng.standard_normal(
            (shape[0],) + tuple(patches))).astype(np.float32)
    return out


def _patches(cfg):
    return (cfg.n_patches, cfg.d_model) if cfg.family == "vlm" else None


def _sbr_tables(L, E, R):
    """Tables as the balancer writes them: expert 0 split over its slot
    and the first spare, expert 1 over its slot and the second."""
    r = np.zeros((L, E, E + R), np.float32)
    r[:, np.arange(E), np.arange(E)] = 1.0
    r[:, 0, 0], r[:, 0, E] = 0.6, 0.4
    r[:, 1, 1], r[:, 1, E + 1] = 0.3, 0.7
    return r


def _jax_layer_leaves(jtree, i):
    """(path, array) of layer i of a JAX tree's stacked blocks."""
    return [("/".join(p.key for p in path), np.asarray(v)[i]) for path, v in
            jax.tree_util.tree_flatten_with_path(jtree["blocks"])[0]]


def _port_leaf(ttree, i, path):
    node = ttree["blocks"][i]
    for k in path.split("/"):
        node = node[k]
    return node


def _compare_trees(jtree, ttree, n_layers, rel=None, check=None):
    """Every leaf of the port's tree against JAX's: ``check(got, want)``
    or within ``rel`` of the leaf's largest entry; ``n_layers`` is the
    count of the stacked ``blocks`` (the unstacked ``dense_blocks`` are
    leaves by their paths)."""
    pairs = []
    for path, want in jax.tree_util.tree_flatten_with_path(
            {k: v for k, v in jtree.items() if k != "blocks"})[0]:
        node = ttree
        for p in path:
            node = node[getattr(p, "key", getattr(p, "idx", None))]
        pairs.append(("/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                               for p in path), np.asarray(want), node))
    for i in range(n_layers):
        pairs += [(f"blocks/{i}/{path}", want, _port_leaf(ttree, i, path))
                  for path, want in _jax_layer_leaves(jtree, i)]
    for name, want, got in pairs:
        got = got.detach().float().numpy()
        want = np.asarray(want, np.float32)
        if check is not None:
            check(name, got, want)
        else:
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=rel * max(float(np.abs(want).max()), 1e-30),
                err_msg=name)
    return len(pairs)


# --------------------------------------------------------------------- #
# loss_fn and its gradients                                              #
# --------------------------------------------------------------------- #
_JAX_GRADS = {}


def _jax_value_and_grad(case):
    """JAX's loss and gradients for a case, computed once a module."""
    if case not in _JAX_GRADS:
        arch, dtype, R, routed, G = case
        jcfg, _ = _cfgs(arch, dtype, moe_replica_slots=R, moe_token_groups=G)
        jp = jm.init_params(jcfg, KEY)
        batch = {k: jnp.asarray(v) for k, v in
                 _batch(jcfg.vocab, patches=_patches(jcfg)).items()}
        routing = (jnp.asarray(_sbr_tables(jcfg.n_layers - jcfg.first_k_dense,
                                           jcfg.n_experts, R))
                   if routed else None)
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p: jm.loss_fn(p, jcfg, batch, remat=False,
                                 moe_routing=routing), has_aux=True))(jp)
        _JAX_GRADS[case] = (jax.tree.map(np.asarray, jp), float(loss),
                            jax.tree.map(np.asarray, grads))
    return _JAX_GRADS[case]


#: (arch, compute dtype, replica slots, an SBR table, token groups)
CASES = {"olmoe": ("olmoe-1b-7b", "float32", 0, False, 1),
         "olmoe-sbr-replicas": ("olmoe-1b-7b", "float32", 4, True, 1),
         "olmoe-g4": ("olmoe-1b-7b", "float32", 0, False, 4),
         "olmoe-g4-sbr-replicas": ("olmoe-1b-7b", "float32", 4, True, 4),
         "llama": ("llama3.2-3b", "float32", 0, False, 1),
         "llama-bf16": ("llama3.2-3b", "bfloat16", 0, False, 1),
         "rwkv": ("rwkv6-1.6b", "float32", 0, False, 1),
         "rwkv-bf16": ("rwkv6-1.6b", "bfloat16", 0, False, 1),
         "internvl": ("internvl2-2b", "float32", 0, False, 1),
         "internvl-bf16": ("internvl2-2b", "bfloat16", 0, False, 1),
         "minicpm3": ("minicpm3-4b", "float32", 0, False, 1),
         "minicpm3-bf16": ("minicpm3-4b", "bfloat16", 0, False, 1),
         "deepseek": ("deepseek-v2-lite-16b", "float32", 0, False, 1),
         "deepseek-sbr-replicas": ("deepseek-v2-lite-16b", "float32", 4, True,
                                   1)}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case, remat):
    arch, dtype, R, routed, G = CASES[case]
    jp, jloss, jgrads = _jax_value_and_grad(CASES[case])
    _, tcfg = _cfgs(arch, dtype, moe_replica_slots=R, moe_token_groups=G)
    tp = params_from_jax(jp, tcfg, "cpu")
    live = tree_map(lambda t: t.requires_grad_(True), tp)
    batch = {k: torch.from_numpy(v) for k, v in
             _batch(tcfg.vocab, patches=_patches(tcfg)).items()}
    routing = (torch.from_numpy(_sbr_tables(
        tcfg.n_layers - tcfg.first_k_dense, tcfg.n_experts, R))
        if routed else None)
    loss, stats = tm.loss_fn(live, tcfg, batch, remat=remat,
                             moe_routing=routing)
    grads = torch.autograd.grad(loss, leaves(live))
    it = iter(grads)
    tgrads = tree_map(lambda _: next(it), live)
    bf16 = dtype == "bfloat16"
    loss_tol = (1e-5 * jloss if not bf16 else
                1e-3 * jloss if tcfg.family == "ssm" or tcfg.attn == "mla"
                else 1e-3)
    assert abs(loss.item() - jloss) <= loss_tol
    assert _compare_trees(jgrads, tgrads, tcfg.n_layers - tcfg.first_k_dense,
                          rel=0.05 if bf16 else 1e-5) == len(leaves(tgrads))
    if routed:                 # the split tables reached the replica slots
        assert stats["tokens_per_slot_layers"][:, 8:10].sum().item() > 0


def _remat_grads(tcfg, routing):
    """``loss_fn``'s gradients without and with remat, the same weights
    (seed 3) and batch (seed 5)."""
    tp = tm.init_params(tcfg, 3, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg.vocab, 5).items()}
    out = []
    for remat in (False, True):
        live = tree_map(lambda t: t.detach().clone().requires_grad_(True),
                        tp)
        loss, _ = tm.loss_fn(live, tcfg, batch, remat=remat,
                             moe_routing=routing)
        out.append(torch.autograd.grad(loss, leaves(live)))
    return out


def test_remat_recomputes_the_same_gradients():
    """Recomputing each block in the backward changes no bit."""
    _, tcfg = _cfgs("olmoe-1b-7b", "bfloat16", moe_replica_slots=4)
    routing = torch.from_numpy(_sbr_tables(tcfg.n_layers, tcfg.n_experts, 4))
    for a, b in zip(*_remat_grads(tcfg, routing)):
        assert torch.equal(a, b)


def test_remat_recomputes_the_same_gradients_rwkv():
    """The same for RWKV6 (K6's forward runs again in the backward)."""
    _, tcfg = _cfgs("rwkv6-1.6b", "bfloat16")
    for a, b in zip(*_remat_grads(tcfg, None)):
        assert torch.equal(a, b)


def test_loss_fn_accepts_replica_slots():
    cfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), moe_replica_slots=3)
    p = tm.init_params(cfg, 0, "cpu")
    assert p["blocks"][0]["moe"]["w_up"].shape[0] == 11
    assert p["blocks"][0]["moe"]["router"].shape[1] == 8


# --------------------------------------------------------------------- #
# Optimizer and compression                                              #
# --------------------------------------------------------------------- #
def test_schedule_matches_jax():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1),
               dict(lr=3e-3, warmup_steps=1, total_steps=7)):
        jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
        for s in range(0, 120, 3):
            want = float(jopt.schedule(jc, jnp.asarray(s, jnp.int32)))
            got = float(topt.schedule(tc, torch.tensor(s, dtype=torch.int32)))
            assert got == pytest.approx(want, rel=2.0 ** -23, abs=0)


@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_jax(grad_clip):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20, grad_clip=grad_clip)
    jc, tc = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    p = {"a": rng.standard_normal((5, 7)).astype(np.float32),
         "b": [rng.standard_normal(3).astype(np.float32)]}
    jp = jax.tree.map(jnp.asarray, p)
    tp = tree_map(lambda a: torch.from_numpy(a.copy()), p)
    js, ts = jopt.init(jp), topt.init(tp)
    step = jax.jit(lambda p, g, s: jopt.update(jc, p, g, s))
    for _ in range(6):
        g = {"a": rng.standard_normal((5, 7)).astype(np.float32) * 3,
             "b": [rng.standard_normal(3).astype(np.float32)]}
        jp, js = step(jp, jax.tree.map(jnp.asarray, g), js)
        tg = tree_map(torch.from_numpy, g)
        kept = tree_map(torch.clone, tg)
        tp, ts = topt.update(tc, tp, tg, ts)
        for a, b in zip(leaves(tg), leaves(kept)):
            assert torch.equal(a, b)            # the grads are not written
    assert int(ts.step) == int(js.step) == 6
    for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(leaves(tree_t), jax.tree.leaves(tree_j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)


def test_clip_by_global_norm_matches_jax():
    g = {"a": np.ones((100,), np.float32) * 10,
         "b": {"c": np.arange(12, dtype=np.float32).reshape(3, 4)}}
    jclipped, jgn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g),
                                             1.0)
    tclipped, tgn = topt.clip_by_global_norm(tree_map(torch.from_numpy, g),
                                             1.0)
    assert float(tgn) == pytest.approx(float(jgn), rel=1e-6)
    for a, b in zip(leaves(tclipped), jax.tree.leaves(jclipped)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert float(torch.linalg.norm(tclipped["a"])) < 1.0


class TestOptimizer:
    def test_adamw_decreases_quadratic(self):
        cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                               total_steps=100)
        params = {"w": torch.ones(4) * 5.0}
        state = topt.init(params)
        for _ in range(50):
            params, state = topt.update(cfg, params, {"w": 2 * params["w"]},
                                        state)
        assert float(params["w"].abs().max()) < 1.0

    def test_schedule_warmup_and_cosine(self):
        cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                               min_lr_frac=0.1)
        at = lambda s: float(topt.schedule(cfg, torch.tensor(s)))  # noqa: E731
        assert at(5) == pytest.approx(0.5)
        assert at(10) == pytest.approx(1.0)
        assert at(100) == pytest.approx(0.1)


def test_compression_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    g = {"w": rng.standard_normal(256).astype(np.float32) * 1e-3,
         "z": [np.zeros(5, np.float32)]}
    je = jcomp.init_error(jax.tree.map(jnp.asarray, g))
    te = tcomp.init_error(tree_map(torch.from_numpy, g))
    for _ in range(5):
        jd, je = jcomp.compress_tree(jax.tree.map(jnp.asarray, g), je)
        td, te = tcomp.compress_tree(tree_map(torch.from_numpy, g), te)
        for a, b in zip(leaves(td) + leaves(te),
                        jax.tree.leaves(jd) + jax.tree.leaves(je)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_compression_unbiased_over_time():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32) * 1e-3)}
    err = tcomp.init_error(g)
    total = torch.zeros(256)
    for _ in range(40):
        deq, err = tcomp.compress_tree(g, err)
        total += deq["w"]
    np.testing.assert_allclose((total / 40).numpy(), g["w"].numpy(),
                               atol=2e-5)


# --------------------------------------------------------------------- #
# The trainer                                                            #
# --------------------------------------------------------------------- #
def test_three_trainer_steps_match_jax():
    """Both trainers from one state (JAX's init, a hot expert planted in
    every router), olmoe-smoke with 4 replica slots and the balancer on:
    the same losses, the same balancer events, and params within the
    stated tolerance after each step."""
    R, lr = 4, 1e-3
    opt = dict(lr=lr, warmup_steps=1, total_steps=40)
    bal = dict(n_experts=8, n_slots=8 + R, n_shards=4, min_steps_between=1)
    jcfg, tcfg = _cfgs("olmoe-1b-7b", moe_replica_slots=R)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(
        opt=jopt.AdamWConfig(**opt), remat=False,
        moe_balancer=jbal.MoEBalancerConfig(**bal)))
    jt.params["blocks"]["moe"]["router"] = (
        jt.params["blocks"]["moe"]["router"].at[:, :, 0].add(3.0))
    tt = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(
        opt=topt.AdamWConfig(**opt), remat=True,
        moe_balancer=tbal.MoEBalancerConfig(**bal)), device="cpu")
    tt.params = params_from_jax(jax.tree.map(np.asarray, jt.params), tcfg,
                                "cpu")
    tt.opt_state = adamw_state_from_jax(
        jax.tree.map(np.asarray, tuple(jt.opt_state)), tcfg, "cpu")
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (4, 32)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    lr_sum = 0.0
    for step in range(3):
        a = jt.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        b = tt.train_step(batch)
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        lr_sum += float(jopt.schedule(jt.tc.opt, jnp.asarray(step + 1)))

        def check(name, got, want):
            err = np.abs(got - want)
            assert err.max() <= 2 * lr_sum * (1 + 1e-3), name
            assert np.mean(err <= 1e-5) >= 0.99, name

        _compare_trees(jax.tree.map(np.asarray, jt.params), tt.params,
                       tcfg.n_layers, check=check)
    def events(tr):
        return [(e.tick, e.kind, e.skewed, e.helpers, e.detail)
                for b_ in tr.balancers for e in b_.state.events]

    assert events(tt) == events(jt)
    assert any(e[1] == "sbr_replicate" for e in events(tt))


def test_three_trainer_steps_match_jax_rwkv():
    """Both trainers from one state (JAX's init), rwkv6-smoke with no
    balancer (no experts): the same losses, and params within the stated
    tolerance after each step."""
    lr = 1e-3
    opt = dict(lr=lr, warmup_steps=1, total_steps=40)
    jcfg, tcfg = _cfgs("rwkv6-1.6b")
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(
        opt=jopt.AdamWConfig(**opt), remat=False))
    tt = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(
        opt=topt.AdamWConfig(**opt), remat=True), device="cpu")
    assert not tt.use_balancer and tt.moe_routing() is None
    tt.params = params_from_jax(jax.tree.map(np.asarray, jt.params), tcfg,
                                "cpu")
    tt.opt_state = adamw_state_from_jax(
        jax.tree.map(np.asarray, tuple(jt.opt_state)), tcfg, "cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (4, 32)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": toks}
    lr_sum = 0.0
    for step in range(3):
        a = jt.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        b = tt.train_step(batch)
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        lr_sum += float(jopt.schedule(jt.tc.opt, jnp.asarray(step + 1)))

        def check(name, got, want):
            err = np.abs(got - want)
            assert err.max() <= 2 * lr_sum * (1 + 1e-3), name
            assert np.mean(err <= 1e-5) >= 0.99, name

        _compare_trees(jax.tree.map(np.asarray, jt.params), tt.params,
                       tcfg.n_layers, check=check)


def test_three_trainer_steps_match_jax_internvl():
    """Both trainers from one state (JAX's init), internvl2-smoke (the vlm
    family, no balancer) with seeded patches ahead of the tokens: the same
    losses, and params within the stated tolerance after each step."""
    lr = 1e-3
    opt = dict(lr=lr, warmup_steps=1, total_steps=40)
    jcfg, tcfg = _cfgs("internvl2-2b")
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(
        opt=jopt.AdamWConfig(**opt), remat=False))
    tt = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(
        opt=topt.AdamWConfig(**opt), remat=True), device="cpu")
    assert not tt.use_balancer
    tt.params = params_from_jax(jax.tree.map(np.asarray, jt.params), tcfg,
                                "cpu")
    tt.opt_state = adamw_state_from_jax(
        jax.tree.map(np.asarray, tuple(jt.opt_state)), tcfg, "cpu")
    batch = _batch(jcfg.vocab, 3, (4, 24), _patches(jcfg))
    lr_sum = 0.0
    for step in range(3):
        a = jt.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        b = tt.train_step(batch)
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        lr_sum += float(jopt.schedule(jt.tc.opt, jnp.asarray(step + 1)))

        def check(name, got, want):
            err = np.abs(got - want)
            assert err.max() <= 2 * lr_sum * (1 + 1e-3), name
            assert np.mean(err <= 1e-5) >= 0.99, name

        _compare_trees(jax.tree.map(np.asarray, jt.params), tt.params,
                       tcfg.n_layers, check=check)


def test_microbatches_accumulate_the_full_batch_gradient():
    """``train_microbatch = 2`` takes the mean of two halves' float32
    gradients: for a dense model (a mean loss) one step lands where the
    whole batch's step does (AdamW with ``eps = 1``, so an update is
    smooth in its gradient and a sum order's last bits move it by
    ``lr`` times that, not by ``lr sign(g)``)."""
    cfg = dataclasses.replace(get_smoke("llama3.2-3b"),
                              compute_dtype="float32")
    tc = ttrainer.TrainConfig(opt=topt.AdamWConfig(lr=1e-2, warmup_steps=1,
                                                   total_steps=10, eps=1.0),
                              remat=False)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (4, 16))
    batch = {"tokens": toks, "labels": toks}
    out = []
    for mb in (1, 2):
        tr = ttrainer.Trainer(dataclasses.replace(cfg, train_microbatch=mb),
                              tc, device="cpu")
        out.append((tr.train_step(batch)["loss"], tr.params))
    assert out[1][0] == pytest.approx(out[0][0], rel=1e-5)
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


class TestTrainerLoop:
    def test_loss_decreases_dense(self):
        cfg = get_smoke("llama3.2-3b")
        tr = ttrainer.Trainer(cfg, ttrainer.TrainConfig(
            opt=topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50),
            remat=False), device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
        batch = {"tokens": toks, "labels": toks}
        losses = [tr.train_step(batch)["loss"] for _ in range(10)]
        assert losses[-1] < losses[0] - 0.5

    def test_grad_compression_error_feedback(self):
        cfg = get_smoke("yi-6b")
        tr = ttrainer.Trainer(cfg, ttrainer.TrainConfig(
            opt=topt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=50),
            remat=False, grad_compression=True), device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32))
        batch = {"tokens": toks, "labels": toks}
        losses = [tr.train_step(batch)["loss"] for _ in range(10)]
        assert losses[-1] < losses[0] - 0.3
        assert tr.err is not None

    def test_trainer_refuses_cuda_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ttrainer.Trainer(get_smoke("llama3.2-3b"),
                             ttrainer.TrainConfig())


def test_train_cli_on_the_cpu(capsys):
    log = tlaunch.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                        "--steps", "4", "--balancer", "--log-every", "1"])
    assert len(log) == 4 and log[-1]["loss"] < log[0]["loss"]
    assert "done on cpu" in capsys.readouterr().out


def test_train_cli_trains_rwkv_on_the_cpu(capsys):
    log = tlaunch.main(["--arch", "rwkv6-1.6b", "--smoke", "--device", "cpu",
                        "--steps", "4", "--log-every", "1"])
    assert len(log) == 4 and log[-1]["loss"] < log[0]["loss"]
    assert all(np.isfinite(m["loss"]) for m in log)
    assert "done on cpu" in capsys.readouterr().out


# --------------------------------------------------------------------- #
# Checkpoints                                                            #
# --------------------------------------------------------------------- #
def _granite_state():
    jcfg, tcfg = _cfgs("granite-8b")
    jp = jm.init_params(jcfg, KEY)
    js = jopt.init(jp)
    js = js._replace(step=jnp.asarray(7, jnp.int32),
                     m=jax.tree.map(lambda x: x * 0.5, js.m),
                     v=jax.tree.map(lambda x: x + 0.25, js.v))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ts = adamw_state_from_jax(jax.tree.map(np.asarray, tuple(js)), tcfg,
                              "cpu")
    return jcfg, tcfg, {"params": jp, "opt": js}, {"params": tp, "opt": ts}


def test_checkpoints_cross_between_the_packages():
    """A checkpoint written by either package restores in the other: the
    same keys (JAX's tree paths, blocks stacked on a layer axis) and
    values."""
    jcfg, tcfg, jtree, ttree = _granite_state()
    with tempfile.TemporaryDirectory() as d:
        jpath = jckpt.save(os.path.join(d, "j"), 3, jtree, {"arch": "g"})
        tpath = tckpt.save(os.path.join(d, "t"), 3, ttree, {"arch": "g"})
        with np.load(jpath) as a, np.load(tpath) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        from_jax = tckpt.restore(jpath, ttree)
        from_port = jckpt.restore(tpath, jtree)
    assert int(from_jax["opt"].step) == 7
    for a, b in zip(leaves(from_jax["params"]) + leaves(from_jax["opt"].v),
                    leaves(ttree["params"]) + leaves(ttree["opt"].v)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestCheckpoint:
    def test_roundtrip_and_latest(self):
        _, _, _, tree = _granite_state()
        with tempfile.TemporaryDirectory() as d:
            tckpt.save(d, 3, tree, {"arch": "g"})
            tckpt.save(d, 7, tree, {"arch": "g"})
            path, meta = tckpt.latest(d)
            assert meta["step"] == 7
            restored = tckpt.restore(path, tree)
        for a, b in zip(leaves(tree["params"]), leaves(restored["params"])):
            assert torch.equal(a, b)

    def test_atomicity_no_partial_files(self):
        with tempfile.TemporaryDirectory() as d:
            tckpt.save(d, 1, {"x": torch.ones(3)})
            assert not [f for f in os.listdir(d) if f.endswith(".tmp")]

    def test_prune_keeps_newest(self):
        with tempfile.TemporaryDirectory() as d:
            for s in range(6):
                tckpt.save(d, s, {"x": torch.ones(2)})
            tckpt.prune(d, keep=2)
            path, meta = tckpt.latest(d)
            assert meta["step"] == 5
            assert len([f for f in os.listdir(d) if f.endswith(".npz")]) == 2

    def test_trainer_resume_equivalence(self):
        """train 6 steps == train 3, checkpoint, restore, train 3."""
        cfg = get_smoke("llama3.2-3b")

        def make():
            return ttrainer.Trainer(cfg, ttrainer.TrainConfig(
                opt=topt.AdamWConfig(lr=1e-3, warmup_steps=2,
                                     total_steps=50), remat=False),
                device="cpu")
        toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 16))
        batch = {"tokens": toks, "labels": toks}
        a = make()
        for _ in range(6):
            la = a.train_step(batch)["loss"]
        b = make()
        for _ in range(3):
            b.train_step(batch)
        with tempfile.TemporaryDirectory() as d:
            tckpt.save(d, 3, {"params": b.params, "opt": b.opt_state})
            path, _ = tckpt.latest(d)
            c = make()
            tree = tckpt.restore(path, {"params": c.params,
                                        "opt": c.opt_state})
        c.params, c.opt_state = tree["params"], tree["opt"]
        for _ in range(3):
            lc = c.train_step(batch)["loss"]
        assert lc == pytest.approx(la, rel=1e-4)


# --------------------------------------------------------------------- #
# The data pipeline                                                      #
# --------------------------------------------------------------------- #
def test_pipeline_batches_equal_jax_bit_for_bit():
    kw = dict(n_shards=4, seq_len=128, batch_per_shard=2, eta_tokens=512.0,
              tau_tokens=256.0, seed=5)
    jp_, tp_ = (jpipe.SkewAwarePipeline(jpipe.PipelineConfig(**kw)),
                tpipe.SkewAwarePipeline(tpipe.PipelineConfig(**kw)))
    for i in range(4):
        lens = jpipe.zipf_doc_lengths(40, 128, seed=i)
        np.testing.assert_array_equal(tpipe.zipf_doc_lengths(40, 128, seed=i),
                                      lens)
        jp_.ingest(lens)
        tp_.ingest(lens)
        a, b = jp_.next_batch(), tp_.next_batch()
        for k in ("tokens", "labels", "mask"):
            np.testing.assert_array_equal(b[k], a[k])
    assert tp_.rebalances == jp_.rebalances > 0
    np.testing.assert_array_equal(tp_.routing.weights, jp_.routing.weights)


class TestDataPipeline:
    def test_skew_aware_beats_static(self):
        lengths = tpipe.zipf_doc_lengths(800, 512, seed=3)

        def run(eta):
            pl = tpipe.SkewAwarePipeline(tpipe.PipelineConfig(
                n_shards=8, seq_len=512, eta_tokens=eta, tau_tokens=1024))
            for i in range(0, 800, 80):
                pl.ingest(lengths[i:i + 80])
            return pl
        balanced, static = run(2048.0), run(1e18)
        assert balanced.rebalances > 0 and static.rebalances == 0
        assert balanced.padding_skew() <= static.padding_skew()

    def test_batches_cover_all_tokens(self):
        pl = tpipe.SkewAwarePipeline(tpipe.PipelineConfig(
            n_shards=4, seq_len=128, batch_per_shard=2))
        lens = tpipe.zipf_doc_lengths(100, 128, seed=1)
        pl.ingest(lens)
        total = 0
        while (b := pl.next_batch()) is not None:
            total += int(b["mask"].sum())
        assert total == int(lens.sum())
