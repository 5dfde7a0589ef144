"""The vlm family (InternVL2-2B: InternLM2-1.8B behind stubbed patch
embeddings) of the port against the JAX package, on the CPU.

The JAX model's weights (``repro.models.init_params``, seed 0) are carried
into the port with ``params_from_jax``; tokens and patch embeddings are
made with numpy from a seed and fed to both.  Tolerances are those of
``tests/test_torch_serve.py`` and ``tests/test_torch_train.py``, stated
from the arithmetic there: float32 logits within ``atol = 2e-5, rtol =
1e-5`` and gradients within ``1e-5`` of each leaf's largest entry; bf16
logits within ``atol = 0.0625, rtol = 0.02`` and gradients within
``0.05``; greedy tokens identical in float32.

JAX's own vlm ``prefill`` and ``ServeEngine`` are not the reference here:
the first ingests the patches and the text as two segments and its text
never attends to the image, the second sizes its cache without the
patches (``ROADMAP.md`` §3, "Departures from the reference";
:func:`test_the_reference_faults_the_port_departs_from` pins both).  The
port's prefill is held to JAX's ``decode_step`` on the joined segment and
to JAX's ``forward``, its engine to a greedy loop over JAX's
``decode_step``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_smoke as jget_smoke
from repro.models import model as jm
from repro.serve import engine as jeng
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as teng
from repro_torch.tree import leaves, tree_map

ARCH = "internvl2-2b"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=0.0625, rtol=0.02)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.05}


def _models(compute_dtype, **kw):
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype=compute_dtype,
                               **kw)
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype,
                               **kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed, B, S):
    """Tokens ``[B, S]`` and float32 patches ``[B, n_patches, d_model]``
    (standard normal: the stub's rows carry as much as a token's)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model)).astype(
        np.float32)
    return toks, patches


def _jbatch(toks, patches):
    return {"tokens": jnp.asarray(toks), "patches": jnp.asarray(patches)}


def _tbatch(toks, patches):
    return {"tokens": torch.from_numpy(toks).long(),
            "patches": torch.from_numpy(patches)}


def _f32(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _joined(jp, jcfg, toks, patches):
    cdt = getattr(jnp, jcfg.compute_dtype)
    return jnp.concatenate([jnp.asarray(patches).astype(cdt),
                            jp["embed"][jnp.asarray(toks)].astype(cdt)],
                           axis=1)


# --------------------------------------------------------------------- #
# Config and forward                                                     #
# --------------------------------------------------------------------- #
def test_configs_are_the_jax_packages():
    for j, t in ((jget_config(ARCH), get_config(ARCH)),
                 (jget_smoke(ARCH), get_smoke(ARCH))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.attn, cfg.n_layers, cfg.n_kv_heads, cfg.hd,
            cfg.n_patches) == ("vlm", "gqa", 24, 8, 128, 1024)


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_forward_matches_jax(compute_dtype):
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    toks, patches = _inputs(jcfg, 1, 2, 12)
    jl, _ = jm.forward(jp, jcfg, _jbatch(toks, patches), remat=False)
    tl, _ = tm.forward(tp, tcfg, _tbatch(toks, patches), remat=False)
    assert tl.shape == (2, jcfg.n_patches + 12, jcfg.vocab)
    assert tl.dtype == getattr(torch, compute_dtype)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_loss_and_grads_match_jax(compute_dtype):
    """``loss_fn`` scores the text positions; its gradients (every leaf)
    against ``jax.value_and_grad``."""
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    toks, patches = _inputs(jcfg, 2, 2, 16)
    labels = np.roll(toks, -1, axis=1)
    jb = dict(_jbatch(toks, patches), labels=jnp.asarray(labels))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jcfg, jb, remat=False), has_aux=True)(jp)
    live = tree_map(lambda t: t.requires_grad_(True), tp)
    tb = dict(_tbatch(toks, patches), labels=torch.from_numpy(labels).long())
    loss, _ = tm.loss_fn(live, tcfg, tb, remat=True)
    grads = torch.autograd.grad(loss, leaves(live))
    assert abs(loss.item() - float(jloss)) <= (
        1e-5 * float(jloss) if compute_dtype == "float32" else 1e-3)
    it = iter(grads)
    tgrads = tree_map(lambda _: next(it), live)
    jflat = jax.tree.map(np.asarray, jgrads)
    pairs = [(k, jflat[k], tgrads[k]) for k in jflat if k != "blocks"]
    for i in range(jcfg.n_layers):
        for path, want in jax.tree_util.tree_flatten_with_path(
                jflat["blocks"])[0]:
            node = tgrads["blocks"][i]
            for part in path:
                node = node[part.key]
            pairs.append((f"blocks/{i}/{path}", want[i], node))
    assert len(pairs) == len(grads)
    for name, want, got in pairs:
        _close(got, want, GRAD_TOL[compute_dtype], name)


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        _f32(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


# --------------------------------------------------------------------- #
# Prefill and decode                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_decode_step_with_embeds_matches_jax(compute_dtype):
    """``decode_step(..., embeds=)`` at 0 over the joined segment, then a
    token at ``n_patches + S``, against JAX's."""
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    B, S = 2, 9
    toks, patches = _inputs(jcfg, 3, B, S + 1)
    n = jcfg.n_patches + S + 1
    joined = _joined(jp, jcfg, toks[:, :S], patches)
    jcache = jm.init_cache(jcfg, B, n)
    jl, jcache = jm.decode_step(jp, jcfg, None, jcache, jnp.asarray(0),
                                embeds=joined)
    tcache = tm.init_cache(tcfg, B, n, "cpu")
    tl, tcache = tm.decode_step(tp, tcfg, None, tcache, 0,
                                embeds=torch.from_numpy(np.array(_f32(joined))))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    pos = jcfg.n_patches + S
    jl, _ = jm.decode_step(jp, jcfg, jnp.asarray(toks[:, S:]), jcache,
                           jnp.asarray(pos))
    tl, _ = tm.decode_step(tp, tcfg, torch.from_numpy(toks[:, S:]).long(),
                           tcache, pos)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_prefill_is_jax_decode_step_on_the_joined_segment(compute_dtype):
    """The port's prefill equals JAX's ``decode_step`` on ``cat(patches,
    embed[tokens])`` at 0, at every position, and JAX's ``forward`` at the
    last one."""
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    B, S = 2, 12
    toks, patches = _inputs(jcfg, 4, B, S)
    n = jcfg.n_patches + S
    tl, _ = tm.prefill(tp, tcfg, _tbatch(toks, patches),
                       tm.init_cache(tcfg, B, n + 4, "cpu"),
                       all_positions=True)
    assert tl.shape == (B, n, jcfg.vocab)
    jcache = jm.init_cache(jcfg, B, n + 4)
    jl, _ = jm.decode_step(jp, jcfg, None, jcache, jnp.asarray(0),
                           embeds=_joined(jp, jcfg, toks, patches))
    np.testing.assert_allclose(_f32(tl[:, -1:]), _f32(jl),
                               **TOL[compute_dtype])
    jf, _ = jm.forward(jp, jcfg, _jbatch(toks, patches), remat=False)
    np.testing.assert_allclose(_f32(tl), _f32(jf), **TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_prefill_then_decode_is_teacher_forcing(compute_dtype):
    """The check JAX's ``test_decode_matches_teacher_forcing`` leaves out
    for the vlm family: prefill of S tokens and one decode step give
    JAX's ``forward`` over S + 1 tokens at its last position."""
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    B, S = 2, 10
    toks, patches = _inputs(jcfg, 5, B, S + 1)
    cache = tm.init_cache(tcfg, B, jcfg.n_patches + S + 1, "cpu")
    _, cache = tm.prefill(tp, tcfg, _tbatch(toks[:, :S], patches), cache)
    tl, _ = tm.decode_step(tp, tcfg, torch.from_numpy(toks[:, S:]).long(),
                           cache, jcfg.n_patches + S)
    jf, _ = jm.forward(jp, jcfg, _jbatch(toks, patches), remat=False)
    np.testing.assert_allclose(_f32(tl), _f32(jf[:, -1:]),
                               **TOL[compute_dtype])


# --------------------------------------------------------------------- #
# The engine                                                             #
# --------------------------------------------------------------------- #
def _jax_greedy(jp, jcfg, prompts, max_new, max_len):
    """What the port's engine must produce: prompts left-padded with 0
    behind zero patches, the joined segment at 0, then one token at a
    time from ``n_patches + S``, greedy."""
    B = len(prompts)
    S = max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    patches = np.zeros((B, jcfg.n_patches, jcfg.d_model), np.float32)
    cache = jm.init_cache(jcfg, B, jcfg.n_patches + S + max_len)
    logits, cache = jm.decode_step(jp, jcfg, None, cache, jnp.asarray(0),
                                   embeds=_joined(jp, jcfg, toks, patches))
    out = [np.asarray(jnp.argmax(logits[:, -1], -1))]
    pos = jcfg.n_patches + S
    for _ in range(max_new - 1):
        logits, cache = jm.decode_step(jp, jcfg, jnp.asarray(out[-1][:, None]),
                                       cache, jnp.asarray(pos))
        pos += 1
        out.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
    return np.stack(out, axis=1)


@pytest.mark.parametrize("n_patches,max_len", [(4, 8), (16, 4)],
                         ids=["patches-below-max_len", "patches-above"])
def test_engine_greedy_equals_a_jax_decode_loop(n_patches, max_len):
    """float32: the engine's greedy tokens are JAX's, with the patches
    shorter than ``max_len`` and longer (where JAX's engine cannot
    serve)."""
    jcfg, tcfg, jp, tp = _models("float32", n_patches=n_patches)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, jcfg.vocab, n).astype(np.int32)
               for n in (3, 5, 2, 4)]
    max_new = max_len
    eng = teng.ServeEngine(tp, tcfg, batch_size=4, max_len=max_len,
                           eos_id=-1, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit(teng.Request(uid=i, prompt=p, max_new_tokens=max_new))
    done = sorted(eng.run(), key=lambda r: r.uid)
    got = np.array([r.out_tokens for r in done])
    want = _jax_greedy(jp, jcfg, prompts, max_new, max_len)
    np.testing.assert_array_equal(got, want)


def test_the_reference_faults_the_port_departs_from():
    """Pinned, so that the departures stay justified: JAX's vlm
    ``prefill`` (two segments) departs from its ``forward`` at the last
    position, where the dense family's agree; JAX's engine raises once
    the patches pass its cache of ``S + max_len``."""
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype="float32")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    toks, patches = _inputs(jcfg, 7, 2, 12)
    batch = _jbatch(toks, patches)
    jl, _ = jm.prefill(jp, jcfg, batch, jm.init_cache(jcfg, 2, 40))
    jf, _ = jm.forward(jp, jcfg, batch, remat=False)
    vlm_gap = float(jnp.abs(jl[:, -1] - jf[:, -1]).max())
    dcfg = dataclasses.replace(jcfg, family="dense", n_patches=0)
    dl, _ = jm.prefill(jp, dcfg, {"tokens": batch["tokens"]},
                       jm.init_cache(dcfg, 2, 40))
    df, _ = jm.forward(jp, dcfg, {"tokens": batch["tokens"]}, remat=False)
    dense_gap = float(jnp.abs(dl[:, -1] - df[:, -1]).max())
    assert vlm_gap > 0.5 and dense_gap < 1e-4, (vlm_gap, dense_gap)

    wide = dataclasses.replace(jcfg, n_patches=16)
    eng = jeng.ServeEngine(jm.init_params(wide, jax.random.PRNGKey(0)), wide,
                           batch_size=2, max_len=4, eos_id=-1)
    for i, n in enumerate((2, 3)):
        eng.submit(jeng.Request(uid=i, prompt=np.arange(1, n + 1,
                                                        dtype=np.int32),
                                max_new_tokens=4))
    with pytest.raises(TypeError, match="update shape"):
        eng.run()


# --------------------------------------------------------------------- #
# The launchers                                                          #
# --------------------------------------------------------------------- #
def test_serve_cli_on_the_cpu(capsys):
    done = tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                        "--requests", "5", "--max-new", "3"])
    assert len(done) == 5 and all(len(r.out_tokens) == 3 for r in done)
    assert "on cpu" in capsys.readouterr().out


def test_train_cli_on_the_cpu(capsys):
    """The launcher gives the vlm family zero patches, as JAX's does."""
    log = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--log-every", "1"])
    assert len(log) == 4 and log[-1]["loss"] < log[0]["loss"]
    assert "done on cpu" in capsys.readouterr().out
