"""The hybrid family (Hymba-1.5B: a Mamba head beside GQA attention in every
block, sliding-window attention on all but the first, middle and last
layers) of the port against the JAX package, on the CPU.

The JAX model's weights (``repro.models.init_params``, seed 0) are carried
into the port with ``params_from_jax``; tokens are made with numpy from a
seed and fed to both.  Two configurations: the smoke config (3 layers,
every one full-attention by ``_layer_flags``, window 8) and a 5-layer
variant with a window of 4, whose layers 1 and 3 attend through the
window at every sequence here (S > 4), so a K5 that ignored the window
would fail it.  Tolerances are those of ``tests/test_torch_whisper.py``,
stated from the arithmetic there: float32 logits within ``atol = 2e-5,
rtol = 1e-5`` (the frameworks sum in other orders) and gradients within
``1e-5`` of each leaf's largest entry; bf16 logits within ``atol =
0.0625, rtol = 0.02`` (one bf16 rounding of a matmul output may land on
the other side, 2^-8 relative, and spreads through the layers) and
gradients within ``0.05``; greedy tokens identical in float32.  The
port's K5 and K7 calls run their plain versions here.
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import model as jm
from repro.models import ssm as jssm
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import PORTED, get_config, get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import adamw_state_from_jax, params_from_jax
from repro_torch.serve import engine as teng
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import leaves, tree_map

ARCH = "hymba-1.5b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=0.0625, rtol=0.02)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.05}
#: The smoke config, and 5 layers with a window of 4 (layers 1 and 3
#: windowed).
VARIANTS = {"smoke": {}, "5-layer window-4": dict(n_layers=5, swa_window=4)}


def _models(compute_dtype, **kw):
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype=compute_dtype,
                               **kw)
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype,
                               **kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _tokens(cfg, seed, B, S):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


def _f32(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        _f32(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _at(node, path):
    for part in path:
        node = node[part.key]
    return node


def _pairs(jtree, ttree, cfg):
    """(name, JAX leaf, port leaf) over every leaf, ``blocks`` layer by
    layer."""
    out = []
    for k in jtree:
        if k == "blocks":
            continue
        for path, want in jax.tree_util.tree_flatten_with_path(jtree[k])[0]:
            out.append((f"{k}/{path}", want, _at(ttree[k], path)))
    for i in range(cfg.n_layers):
        for path, want in jax.tree_util.tree_flatten_with_path(
                jtree["blocks"])[0]:
            out.append((f"blocks/{i}/{path}", want[i],
                        _at(ttree["blocks"][i], path)))
    return out


# --------------------------------------------------------------------- #
# Config, layer flags, the Mamba head                                    #
# --------------------------------------------------------------------- #
def test_configs_are_the_jax_packages():
    for j, t in ((jget_config(ARCH), get_config(ARCH)),
                 (jget_smoke(ARCH), get_smoke(ARCH))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    cfg = get_config(ARCH)
    assert ARCH in PORTED
    assert (cfg.family, cfg.attn, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.hd, cfg.ssm_state, cfg.swa_window) == (
                "hybrid", "gqa", 32, 25, 5, 64, 16, 1024)
    tm.check_supported(cfg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_layer_flags_and_windows_are_jaxs(variant):
    """The full layers are JAX's (first, middle, last); the others take
    ``max(swa_window, 1)``, where JAX's full layers take 2^30."""
    cfg = dataclasses.replace(get_smoke(ARCH), **VARIANTS[variant])
    jcfg = dataclasses.replace(jget_smoke(ARCH), **VARIANTS[variant])
    flags = tm._layer_flags(cfg)
    assert flags == [bool(f) for f in np.asarray(jm._layer_flags(jcfg))]
    want = [None if f else max(cfg.swa_window, 1) for f in flags]
    assert tm._windows(cfg) == want
    if variant != "smoke":
        assert want == [None, 4, None, 4, None]
    else:
        assert want == [None] * 3
    assert tm._windows(get_config("olmoe-1b-7b")) == [None] * 16


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_apply_matches_jax(dtype, state):
    """``ssm.mamba_apply`` on JAX's ``mamba_init`` weights (``dt_bias``
    and ``d_skip`` moved off their init, so both terms count), with and
    without a state: y within the logit tolerance, the new state within
    float32's 2e-5 (bf16: 0.0625 + 2%, its inputs being bf16 products)."""
    key = jax.random.PRNGKey(5)
    jp = jssm.mamba_init(key, 24, 8)
    rng = np.random.default_rng(2)
    jp = dict(jp, dt_bias=jnp.asarray(rng.standard_normal(24) * 0.5,
                                      jnp.float32),
              d_skip=jnp.asarray(rng.uniform(0.5, 1.5, 24), jnp.float32))
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    cdt = getattr(jnp, dtype)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    jx = jnp.asarray(x, cdt)
    tx = torch.from_numpy(np.array(_f32(jx))).to(getattr(torch, dtype))
    h0 = (rng.standard_normal((2, 24, 8)).astype(np.float32)
          if state else None)
    jy, jh = jssm.mamba_apply(jp, jx, state=None if h0 is None
                              else jnp.asarray(h0))
    ty, th = tssm.mamba_apply(tp, tx, state=None if h0 is None
                              else torch.from_numpy(h0))
    assert ty.dtype == getattr(torch, dtype) and ty.shape == (2, 11, 24)
    np.testing.assert_allclose(_f32(ty), _f32(jy), **TOL[dtype])
    if state:
        assert th.dtype == torch.float32 and th.shape == (2, 24, 8)
        np.testing.assert_allclose(_f32(th), _f32(jh), **(
            TOL["float32"] if dtype == "float32" else TOL["bfloat16"]))
    else:
        assert th is None and jh is None
    gen = torch.Generator().manual_seed(0)
    init = tssm.mamba_init(gen, 24, 8)
    assert {n: tuple(t.shape) for n, t in init.items()} == {
        n: tuple(a.shape) for n, a in jp.items()}
    # log(1 .. N): XLA's float32 log and PyTorch's differ by an ulp.
    np.testing.assert_allclose(init["a_log"].numpy(),
                               np.asarray(jssm.mamba_init(key, 24, 8)[
                                   "a_log"]), rtol=2.0**-22, atol=0)


# --------------------------------------------------------------------- #
# Forward, loss and gradients                                            #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_forward_matches_jax(compute_dtype, variant):
    """Logits within ``TOL``, but the 5-layer variant in bf16: there one
    bf16 ulp in a hidden state (each block agrees with JAX's to one ulp on
    one input, ``test_block_grads_match_jax_in_bf16``) grows through five
    Mamba heads past 0.0625 + 2% at a few percent of the logits, so at
    seeds 3, 4 and 5 the port's bf16 logits are held to JAX's float32
    logits as JAX's own bf16 logits are: their largest distance within 2x
    JAX's and their mean distance within 1.5x."""
    jcfg, tcfg, jp, tp = _models(compute_dtype, **VARIANTS[variant])
    envelope = compute_dtype == "bfloat16" and variant != "smoke"
    if envelope:
        jcfg32, _, jp32, _ = _models("float32", **VARIANTS[variant])
    for seed in (3, 4, 5) if envelope else (3,):
        toks = _tokens(jcfg, seed, 2, 12)
        jl, _ = jm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                           remat=False)
        tl, _ = tm.forward(tp, tcfg,
                           {"tokens": torch.from_numpy(toks).long()},
                           remat=False)
        assert tl.shape == (2, 12, jcfg.vocab)
        assert tl.dtype == getattr(torch, compute_dtype)
        if not envelope:
            np.testing.assert_allclose(_f32(tl), _f32(jl),
                                       **TOL[compute_dtype])
            continue
        j32, _ = jm.forward(jp32, jcfg32, {"tokens": jnp.asarray(toks)},
                            remat=False)
        ours = np.abs(_f32(tl) - _f32(j32))
        theirs = np.abs(_f32(jl) - _f32(j32))
        assert ours.max() <= 2 * theirs.max(), (seed, ours.max(),
                                                theirs.max())
        assert ours.mean() <= 1.5 * theirs.mean(), (seed, ours.mean(),
                                                    theirs.mean())


def test_the_window_moves_the_logits():
    """In the 5-layer variant the window changes the logits well past the
    float32 tolerance (so the parity above holds the window itself): the
    port with every window taken away differs from JAX's."""
    jcfg, tcfg, jp, tp = _models("float32", **VARIANTS["5-layer window-4"])
    toks = _tokens(jcfg, 3, 2, 12)
    jl, _ = jm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    wide = dataclasses.replace(tcfg, swa_window=64)
    tl, _ = tm.forward(tp, wide, {"tokens": torch.from_numpy(toks).long()},
                       remat=False)
    assert np.abs(_f32(tl) - _f32(jl)).max() > 100 * TOL["float32"]["atol"]


#: Each float32 gradient leaf's bound, of its largest entry: 1e-5 (the
#: other families' bound) for the smoke config; the 5-layer variant's
#: backward runs through five Mamba recurrences and two windowed
#: attentions, where float32 sums in other orders reach 1.6e-5 at blocks/1's
#: SwiGLU weights, so 2e-5 there.
F32_GRAD_TOL = {"smoke": 1e-5, "5-layer window-4": 2e-5}


def _grads(cfg_kw, compute_dtype, seed=4):
    """(JAX's loss and gradient tree, the port's loss and gradient tree,
    the JAX config) of ``loss_fn`` on 2 x 12 seeded tokens (remat on the
    port's side)."""
    jcfg, tcfg, jp, tp = _models(compute_dtype, **cfg_kw)
    toks = _tokens(jcfg, seed, 2, 12)
    labels = np.roll(toks, -1, axis=1)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jcfg, jb, remat=False), has_aux=True)(jp)
    live = tree_map(lambda t: t.requires_grad_(True), tp)
    tb = {"tokens": torch.from_numpy(toks).long(),
          "labels": torch.from_numpy(labels).long()}
    loss, _ = tm.loss_fn(live, tcfg, tb, remat=True)
    grads = torch.autograd.grad(loss, leaves(live))
    it = iter(grads)
    return (float(jloss), jax.tree.map(np.asarray, jgrads), loss.item(),
            tree_map(lambda _: next(it), live), jcfg)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_loss_and_grads_match_jax(variant):
    """float32: ``loss_fn`` (remat on the port's side) within 1e-5
    relative and its gradient at every leaf, the Mamba head's (``ssm_in``,
    ``a_log``, ``w_dt``, ``dt_bias``, ``w_b``, ``w_c``, ``d_skip``) and
    the two output norms included, within ``F32_GRAD_TOL`` of the leaf's
    largest entry, against ``jax.value_and_grad`` (JAX's autodiff of its
    ``lax.scan``; the port's through K7's backward and K5's windowed
    one)."""
    jloss, jgrads, loss, tgrads, jcfg = _grads(VARIANTS[variant], "float32")
    assert abs(loss - jloss) <= 1e-5 * jloss
    pairs = _pairs(jgrads, tgrads, jcfg)
    assert len(pairs) == len(leaves(tgrads))
    names = " ".join(n for n, _, _ in pairs)
    for part in ("ssm_in", "a_log", "w_dt", "dt_bias", "w_b", "w_c",
                 "d_skip", "ln_attn_out", "ln_ssm_out"):
        assert part in names, part
    for name, want, got in pairs:
        _close(got, want, F32_GRAD_TOL[variant], name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_loss_matches_jax(variant):
    """bf16: the loss within 1e-3 relative (as RWKV6's, ROADMAP.md §3: XLA
    rounds at the outputs of its fusions, the port at every op) and every
    gradient leaf finite, of JAX's shape.  The whole model's bf16
    gradients are not compared leaf by leaf: a one-ulp difference in a
    hidden state moves the Mamba heads' step sizes and the leaves that
    sum over (b, t) with cancellation (``dt_bias``, ``d_skip``) by up to
    half their largest entry between two bf16 evaluations; each block's
    bf16 gradients are compared on one input in
    ``test_block_grads_match_jax_in_bf16``."""
    jloss, jgrads, loss, tgrads, jcfg = _grads(VARIANTS[variant], "bfloat16")
    assert abs(loss - jloss) <= 1e-3 * jloss
    for name, want, got in _pairs(jgrads, tgrads, jcfg):
        assert tuple(got.shape) == np.shape(want), name
        assert bool(torch.isfinite(got).all()), name


@pytest.mark.parametrize("layer", [0, 1])
def test_block_grads_match_jax_in_bf16(layer):
    """bf16, a full block and a windowed one of the 5-layer window-4
    variant (layers 0 and 1) on one input, JAX's bf16 hidden state at that
    layer: the
    gradient of ``sum(block(x) r)`` (r seeded) at x and at every leaf of the
    block within 0.05 of its largest entry (the other families' bf16
    bound), against ``jax.grad`` of JAX's ``_block_apply``."""
    jcfg, tcfg, jp, tp = _models("bfloat16", **VARIANTS["5-layer window-4"])
    toks = _tokens(jcfg, 4, 2, 12)
    windows = tm._windows(tcfg)
    jwin = [jnp.asarray(2 ** 30 if w is None else w, jnp.int32)
            for w in windows]
    x = jp["embed"][jnp.asarray(toks)].astype(jnp.bfloat16)
    for i in range(layer):
        x, _, _ = jm._block_apply(
            jcfg, jax.tree.map(lambda a: a[i], jp["blocks"]), x,
            window=jwin[i])
    r = np.random.default_rng(layer).standard_normal(x.shape).astype(
        np.float32)

    def jfn(bp, x):
        y, _, _ = jm._block_apply(jcfg, bp, x, window=jwin[layer])
        return (y.astype(jnp.float32) * r).sum()

    jg, jgx = jax.grad(jfn, argnums=(0, 1))(
        jax.tree.map(lambda a: a[layer], jp["blocks"]), x)
    bp = tree_map(lambda t: t.clone().requires_grad_(True),
                  tp["blocks"][layer])
    tx = torch.from_numpy(np.array(_f32(x))).to(torch.bfloat16)
    tx.requires_grad_(True)
    y, _, _ = tm._block_apply(tcfg, bp, tx, window=windows[layer])
    (y.float() * torch.from_numpy(r)).sum().backward()
    _close(tx.grad, _f32(jgx), GRAD_TOL["bfloat16"], "x")
    flat = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jg))
    assert len(flat[0]) == len(leaves(bp))
    for path, want in flat[0]:
        _close(_at(bp, path).grad, want, GRAD_TOL["bfloat16"], str(path))


# --------------------------------------------------------------------- #
# Prefill and decode                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_then_decode_is_teacher_forcing(variant):
    """float32: a prefill of S tokens at every position and then four
    decode steps (the windowed decode attention, the Mamba state carried
    in the cache) equal the port's own ``forward`` over S + 4 tokens,
    within the float32 logit tolerance."""
    _, tcfg, _, tp = _models("float32", **VARIANTS[variant])
    B, S = 2, 8
    toks = _tokens(tcfg, 5, B, S + 4)
    want, _ = tm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                         remat=False)
    cache = tm.init_cache(tcfg, B, S + 4, "cpu")
    assert cache["blocks"][0]["ssm"].shape == (B, tcfg.d_model,
                                               tcfg.ssm_state)
    assert cache["blocks"][0]["ssm"].dtype == torch.float32
    got, cache = tm.prefill(tp, tcfg,
                            {"tokens": torch.from_numpy(toks[:, :S]).long()},
                            cache, all_positions=True)
    np.testing.assert_allclose(_f32(got), _f32(want[:, :S]),
                               **TOL["float32"])
    for i in range(S, S + 4):
        got, cache = tm.decode_step(
            tp, tcfg, torch.from_numpy(toks[:, i:i + 1]).long(), cache, i)
        np.testing.assert_allclose(_f32(got), _f32(want[:, i:i + 1]),
                                   **TOL["float32"])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_prefill_and_decode_step_match_jax(compute_dtype):
    """The 5-layer window-4 variant: ``prefill`` (the Mamba states in the
    cache) and three decode steps against JAX's."""
    jcfg, tcfg, jp, tp = _models(compute_dtype,
                                 **VARIANTS["5-layer window-4"])
    B, S = 2, 9
    toks = _tokens(jcfg, 6, B, S + 3)
    jl, jcache = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                            jm.init_cache(jcfg, B, S + 3))
    tl, tcache = tm.prefill(tp, tcfg,
                            {"tokens": torch.from_numpy(toks[:, :S]).long()},
                            tm.init_cache(tcfg, B, S + 3, "cpu"))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    for i in range(jcfg.n_layers):
        np.testing.assert_allclose(
            _f32(tcache["blocks"][i]["ssm"]),
            _f32(jcache["blocks"]["ssm"][i]), **TOL[compute_dtype])
    for i in range(S, S + 3):
        jl, jcache = jm.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                    jcache, jnp.asarray(i))
        tl, tcache = tm.decode_step(
            tp, tcfg, torch.from_numpy(toks[:, i:i + 1]).long(), tcache, i)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])


def _jax_greedy(jp, jcfg, prompts, max_new, max_len):
    """What the port's engine must produce: prompts left-padded with 0 (the
    pads feed the Mamba state, as in JAX's engine), JAX's prefill, then one
    token at a time from S, greedy."""
    B = len(prompts)
    S = max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    cache = jm.init_cache(jcfg, B, S + max_len)
    logits, cache = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, cache)
    out = [np.asarray(jnp.argmax(logits[:, -1], -1))]
    for pos in range(S, S + max_new - 1):
        logits, cache = jm.decode_step(jp, jcfg, jnp.asarray(out[-1][:, None]),
                                       cache, jnp.asarray(pos))
        out.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
    return np.stack(out, axis=1)


def test_engine_greedy_equals_a_jax_decode_loop():
    """float32, the 5-layer window-4 variant with prompts past the window:
    the engine's greedy tokens are JAX's."""
    kw = VARIANTS["5-layer window-4"]
    jcfg, tcfg, jp, tp = _models("float32", **kw)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab, n).astype(np.int32)
               for n in (9, 5, 2, 7)]
    max_new = max_len = 6
    eng = teng.ServeEngine(tp, tcfg, batch_size=4, max_len=max_len,
                           eos_id=-1, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(teng.Request(uid=i, prompt=p, max_new_tokens=max_new))
    done = sorted(eng.run(), key=lambda r: r.uid)
    got = np.array([r.out_tokens for r in done])
    np.testing.assert_array_equal(
        got, _jax_greedy(jp, jcfg, prompts, max_new, max_len))


# --------------------------------------------------------------------- #
# Conversion, checkpoints, the trainer, the launchers                    #
# --------------------------------------------------------------------- #
def test_params_from_jax_carries_the_mamba_head():
    jcfg, tcfg, jp, tp = _models("float32")
    assert len(tp["blocks"]) == jcfg.n_layers
    for name in ("ssm_in", "ln_attn_out", "ln_ssm_out"):
        np.testing.assert_array_equal(tp["blocks"][2][name].numpy(),
                                      np.asarray(jp["blocks"][name][2]))
    for name in ("a_log", "w_dt", "dt_bias", "w_b", "w_c", "d_skip"):
        np.testing.assert_array_equal(
            tp["blocks"][1]["ssm"][name].numpy(),
            np.asarray(jp["blocks"]["ssm"][name][1]))
    # The port's own init has JAX's tree: every leaf, of JAX's shape.
    ref = tm.init_params(tcfg, 0, "cpu")
    pairs = _pairs(jax.tree.map(np.asarray, jp), ref, jcfg)
    assert len(pairs) == len(leaves(ref))
    for name, want, got in pairs:
        assert tuple(got.shape) == np.shape(want), name


def test_checkpoints_cross_between_the_packages():
    """A Hymba checkpoint written by either package restores in the other:
    the same keys (the Mamba head's stacked on the layer axis) and
    values."""
    jcfg, tcfg, jp, tp = _models("float32")
    js = jopt.init(jp)
    js = js._replace(step=jnp.asarray(5, jnp.int32),
                     m=jax.tree.map(lambda x: x * 0.5, js.m))
    ts = adamw_state_from_jax(jax.tree.map(np.asarray, tuple(js)), tcfg,
                              "cpu")
    jtree, ttree = {"params": jp, "opt": js}, {"params": tp, "opt": ts}
    with tempfile.TemporaryDirectory() as d:
        jpath = jckpt.save(os.path.join(d, "j"), 3, jtree, {"arch": "h"})
        tpath = tckpt.save(os.path.join(d, "t"), 3, ttree, {"arch": "h"})
        with np.load(jpath) as a, np.load(tpath) as b:
            assert sorted(a.files) == sorted(b.files)
            assert b["params/blocks/ssm/a_log"].shape == (
                jcfg.n_layers, jcfg.d_model, jcfg.ssm_state)
            assert "opt/m/blocks/ln_ssm_out" in b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        from_jax = tckpt.restore(jpath, ttree)
        from_port = jckpt.restore(tpath, jtree)
    assert int(from_jax["opt"].step) == 5
    for a, b in zip(leaves(from_jax["params"]) + leaves(from_jax["opt"].m),
                    leaves(ttree["params"]) + leaves(ttree["opt"].m)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(jax.tree.leaves(from_port), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_three_trainer_steps_match_jax():
    """Both trainers from one state (JAX's init), the 5-layer window-4
    variant in float32 (no experts, no balancer): the same losses, and
    params within the bound ``tests/test_torch_train.py`` states (each step
    moves a param by at most its learning rate)."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=40)
    kw = VARIANTS["5-layer window-4"]
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype="float32",
                               **kw)
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32", **kw)
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(
        opt=jopt.AdamWConfig(**opt), remat=False))
    tt = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(
        opt=topt.AdamWConfig(**opt), remat=True), device="cpu")
    assert not tt.use_balancer
    tt.params = params_from_jax(jax.tree.map(np.asarray, jt.params), tcfg,
                                "cpu")
    tt.opt_state = adamw_state_from_jax(
        jax.tree.map(np.asarray, tuple(jt.opt_state)), tcfg, "cpu")
    toks = _tokens(jcfg, 8, 4, 16)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    lr_sum = 0.0
    for step in range(3):
        a = jt.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        b = tt.train_step(batch)
        assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
        lr_sum += float(jopt.schedule(jt.tc.opt, jnp.asarray(step + 1)))
        for name, want, got in _pairs(jax.tree.map(np.asarray, jt.params),
                                      tt.params, jcfg):
            err = np.abs(_f32(got) - np.asarray(want, np.float32))
            assert err.max() <= 2 * lr_sum * (1 + 1e-3), name
            assert np.mean(err <= 1e-5) >= 0.99, name


def test_serve_cli_on_the_cpu(capsys):
    done = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "5", "--max-new", "3"])
    assert len(done) == 5 and all(len(r.out_tokens) == 3 for r in done)
    assert "on cpu" in capsys.readouterr().out


def test_train_cli_on_the_cpu(capsys):
    log = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--log-every", "1"])
    assert len(log) == 4 and log[-1]["loss"] < log[0]["loss"]
    assert "done on cpu" in capsys.readouterr().out
