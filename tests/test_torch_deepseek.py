"""DeepSeek-V2-Lite's MoE side in the port against the JAX package, on the
CPU: the shared experts (in both dispatches), the dense first layer
(``dense_blocks``, unstacked in JAX's tree), the npz checkpoint across the
packages with ``dense_blocks`` in it, and the trainer with the Reshape
balancer on the scanned layers only.  MLA itself, the forward, the serve
and the gradients of both MLA models: ``tests/test_torch_mla.py`` and
``tests/test_torch_train.py``.

Weights come from JAX's init (seed 0) through ``params_from_jax``;
activations and tokens from numpy seeds.  Tolerances:

* the MoE layer in float32: outputs and stats within ``1e-5`` (the two
  frameworks sum in other orders; ``tests/test_torch_serve.py``'s MoE
  tolerance); in bf16 within ``atol = 0.0625, rtol = 0.02`` (one rounding
  may land on the other side, 2^-8 relative; the same test file's logits
  tolerance), with routing decided in float32 (the router's gates are
  float32 in both packages);
* checkpoints: bit for bit;
* three trainer steps: ``tests/test_torch_train.py``'s rule (every
  parameter within ``2 sum(lr)`` of JAX's, 99% of each leaf within
  ``1e-5``), the same losses (``1e-4`` relative) and the same balancer
  events.
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
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_smoke
from repro_torch.core import moe_balancer as tbal
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import adamw_state_from_jax, params_from_jax
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import leaves

ARCH = "deepseek-v2-lite-16b"
KEY = jax.random.PRNGKey(0)


def _f32(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _cfgs(**kw):
    return (dataclasses.replace(jget_smoke(ARCH), **kw),
            dataclasses.replace(get_smoke(ARCH), **kw))


# --------------------------------------------------------------------- #
# Shared experts                                                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("groups", [1, 4])
def test_shared_experts_match_jax(groups, compute_dtype):
    """``moe_apply`` of a layer with 2 shared experts (DeepSeek-V2-Lite's
    smoke widths: 8 routed experts, top 2, a shared SwiGLU of 64) at 1 and
    4 token groups against JAX's: outputs and stats.  The shared experts
    are what tells the two apart from a layer without them."""
    jp = jmoe.moe_init(jax.random.PRNGKey(2), 64, 32, 8, n_shared=2,
                       d_shared=64)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    assert set(tp["shared"]) == {"w_gate", "w_up", "w_down"}
    x = np.random.default_rng(7).standard_normal((2, 16, 64)).astype(
        np.float32)
    jx = jnp.asarray(x, getattr(jnp, compute_dtype))
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, compute_dtype))
    kw = dict(top_k=2, capacity_factor=1.25, return_stats=True,
              token_groups=groups)
    jout, jst = jmoe.moe_apply(jp, jx, **kw)
    tout, tst = tmoe.moe_apply(tp, tx, **kw)
    tol = (dict(atol=1e-5, rtol=1e-5) if compute_dtype == "float32"
           else dict(atol=0.0625, rtol=0.02))
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)
    for k in ("tokens_per_expert", "tokens_per_expert_router",
              "dropped_frac", "aux_loss"):
        np.testing.assert_allclose(_f32(tst[k]), _f32(jst[k]), atol=1e-5,
                                   rtol=1e-5, err_msg=k)
    without = {k: v for k, v in tp.items() if k != "shared"}
    assert float((tmoe.moe_apply(without, tx, **kw)[0] - tout).abs().max()
                 ) > 1e-3


def test_moe_init_draws_the_shared_experts():
    gen = torch.Generator().manual_seed(0)
    p = tmoe.moe_init(gen, 64, 32, 8, n_shared=2, n_replica_slots=4)
    assert p["w_gate"].shape == (12, 64, 32)
    assert {k: tuple(v.shape) for k, v in p["shared"].items()} == {
        "w_gate": (64, 64), "w_up": (64, 64), "w_down": (64, 64)}
    assert "shared" not in tmoe.moe_init(gen, 64, 32, 8)


# --------------------------------------------------------------------- #
# The dense first layer                                                  #
# --------------------------------------------------------------------- #
def test_dense_blocks_through_params_from_jax():
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jm.init_params(jcfg, KEY))
    tp = params_from_jax(jp, tcfg, "cpu")
    assert len(tp["blocks"]) == tcfg.n_layers - tcfg.first_k_dense == 2
    assert len(tp["dense_blocks"]) == tcfg.first_k_dense == 1
    dense = tp["dense_blocks"][0]
    assert "moe" not in dense and dense["mlp"]["w_gate"].shape == (
        tcfg.d_model, tcfg.d_ff)
    np.testing.assert_array_equal(dense["mlp"]["w_down"].numpy(),
                                  jp["dense_blocks"][0]["mlp"]["w_down"])
    np.testing.assert_array_equal(dense["attn"]["w_uk"].numpy(),
                                  jp["dense_blocks"][0]["attn"]["w_uk"])
    np.testing.assert_array_equal(
        tp["blocks"][1]["moe"]["shared"]["w_up"].numpy(),
        jp["blocks"]["moe"]["shared"]["w_up"][1])
    own = tm.init_params(tcfg, 0, "cpu")
    assert [a.shape for a in leaves(own)] == [a.shape for a in leaves(tp)]
    cache = tm.init_cache(tcfg, 2, 8, "cpu")
    assert len(cache["dense_blocks"]) == 1 and len(cache["blocks"]) == 2
    assert cache["blocks"][0]["attn"]["c_kv"].shape == (2, 8, tcfg.kv_lora)


def test_forward_without_the_dense_layer_differs():
    """The dense first layer runs: dropping it moves the logits."""
    _, tcfg = _cfgs(compute_dtype="float32")
    tp = tm.init_params(tcfg, 0, "cpu")
    toks = {"tokens": torch.randint(0, tcfg.vocab, (2, 8))}
    full, stats = tm.forward(tp, tcfg, toks)
    assert stats["tokens_per_expert_layers"].shape == (
        tcfg.n_layers - tcfg.first_k_dense, tcfg.n_experts)
    cut = dict(tp, dense_blocks=[])
    assert float((tm.forward(tp | cut, tcfg, toks)[0] - full).abs().max()
                 ) > 1e-3


# --------------------------------------------------------------------- #
# Checkpoints                                                            #
# --------------------------------------------------------------------- #
def test_checkpoints_with_dense_blocks_cross_between_the_packages():
    """params and AdamW state of deepseek-smoke written by either package
    restore in the other: the same keys (``dense_blocks/0/...`` beside the
    stacked ``blocks/...``) and values, bit for bit."""
    jcfg, tcfg = _cfgs()
    jp = jm.init_params(jcfg, KEY)
    js = jopt.init(jp)
    js = js._replace(step=jnp.asarray(5, jnp.int32),
                     m=jax.tree.map(lambda x: x * 0.5, js.m),
                     v=jax.tree.map(lambda x: x + 0.25, js.v))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    ts = adamw_state_from_jax(jax.tree.map(np.asarray, tuple(js)), tcfg,
                              "cpu")
    jtree, ttree = {"params": jp, "opt": js}, {"params": tp, "opt": ts}
    with tempfile.TemporaryDirectory() as d:
        jpath = jckpt.save(os.path.join(d, "j"), 2, jtree, {"arch": ARCH})
        tpath = tckpt.save(os.path.join(d, "t"), 2, ttree, {"arch": ARCH})
        with np.load(jpath) as a, np.load(tpath) as b:
            assert sorted(a.files) == sorted(b.files)
            assert "params/dense_blocks/0/mlp/w_gate" in a.files
            assert "opt/m/dense_blocks/0/attn/w_dkv" in a.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        from_jax = tckpt.restore(jpath, ttree)
        from_port = jckpt.restore(tpath, jtree)
    assert int(from_jax["opt"].step) == 5
    for a, b in zip(leaves(from_jax), leaves(ttree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------- #
# The trainer with the balancer                                          #
# --------------------------------------------------------------------- #
def test_three_trainer_steps_match_jax_with_the_balancer():
    """Both trainers from one state (JAX's init, a hot expert planted in
    every scanned layer's router), deepseek-smoke in float32 (as
    ``tests/test_torch_train.py`` runs olmoe-smoke) with 4 replica slots and
    a balancer on each of its 2 scanned layers (none on the dense one):
    the same losses and balancer events, params within the stated
    tolerance after each step."""
    R, lr = 4, 1e-3
    opt = dict(lr=lr, warmup_steps=1, total_steps=40)
    bal = dict(n_experts=8, n_slots=8 + R, n_shards=4, min_steps_between=1)
    jcfg, tcfg = _cfgs(moe_replica_slots=R, compute_dtype="float32")
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(
        opt=jopt.AdamWConfig(**opt), remat=False,
        moe_balancer=jbal.MoEBalancerConfig(**bal)))
    jt.params["blocks"]["moe"]["router"] = (
        jt.params["blocks"]["moe"]["router"].at[:, :, 0].add(3.0))
    tt = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(
        opt=topt.AdamWConfig(**opt), remat=True,
        moe_balancer=tbal.MoEBalancerConfig(**bal)), device="cpu")
    assert len(tt.balancers) == len(jt.balancers) == 2
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
        flat_j = jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, jt.params))[0]
        for path, want in flat_j:
            names = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
            if names[0] == "blocks":          # stacked on a layer axis
                port = []
                for layer in tt.params["blocks"]:
                    node = layer
                    for n in names[1:]:
                        node = node[n]
                    port.append(node.detach().numpy())
                port = np.stack(port)
            else:
                node = tt.params
                for n in names:
                    node = node[n]
                port = node.detach().numpy()
            err = np.abs(port - np.asarray(want, np.float32))
            assert err.max() <= 2 * lr_sum * (1 + 1e-3), names
            assert np.mean(err <= 1e-5) >= 0.99, names

    def events(tr):
        return [(e.tick, e.kind, e.skewed, e.helpers, e.detail)
                for b_ in tr.balancers for e in b_.state.events]

    assert events(tt) == events(jt)
    assert any(e[1] == "sbr_replicate" for e in events(tt))
