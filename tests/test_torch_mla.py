"""MLA (multi-head latent attention) of the port against the JAX package,
on the CPU, and the two configurations that use it: ``minicpm3-4b`` (dense,
a ``q_lora`` query path) and ``deepseek-v2-lite-16b`` (MoE with shared
experts and a dense first layer), at their smoke configurations.

The JAX layer's and model's weights (seed 0) are carried into the port
with ``params_from_jax``; activations and tokens are made with numpy from
a seed and fed to both.  On the CPU, K5 runs its plain version, at MLA's
unequal widths (q and k ``qk_nope + qk_rope`` wide, v ``v_head``).

Tolerances, stated from the arithmetic:

* ``float32``: the two frameworks sum in other orders, so an MLA output
  (magnitude ~1) agrees within ``atol = 2e-5, rtol = 1e-5``, logits too
  (about 40 float32 ulps at their magnitude of a few units, as
  ``tests/test_torch_serve.py`` states), and greedy tokens are identical;
  gradients of ``mla_apply``, and K5's plain backward against ``jax.vjp``
  of ``flash_attention_ref``, within ``1e-5`` of each leaf's largest entry
  (``tests/test_torch_train.py``'s rule);
* ``bfloat16``: one rounding of a matmul output may land on the other
  side (2^-8 relative) and spreads, so outputs and logits agree within
  ``atol = 0.0625, rtol = 0.02`` (four bf16 ulps at magnitude 2-4);
* K5's plain version against JAX's ``flash_attention_ref`` at unequal
  widths: ``atol = 3e-5, rtol = 1e-4`` (``tests/test_kernels.py``'s);
* teacher forcing (prefill then one decode step against the forward at
  the last position, the port alone): ``5e-2``, the MLA tolerance of
  ``tests/test_models.py`` (the decode reads the bf16 latent cache through
  the weight-absorbed path, the forward expands the latent).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import attention as jattn
from repro.models import model as jm
from repro.serve import engine as jeng
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import flash_attention as k5
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as teng
from repro_torch.tree import leaves, tree_map

ARCHS = ["minicpm3-4b", "deepseek-v2-lite-16b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=0.0625, rtol=0.02)}
#: The MLA widths of minicpm3-smoke (q_lora 48, as the published model).
MLA = dict(n_heads=4, kv_lora=32, qk_nope=16, qk_rope=8, v_head=16)


def _f32(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _models(arch, compute_dtype):
    jcfg = dataclasses.replace(jget_smoke(arch), compute_dtype=compute_dtype)
    tcfg = dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _mla(q_lora, compute_dtype):
    """JAX's mla_init weights (float32) in both packages, and x [2, 10, 64]
    in the compute dtype from a numpy seed."""
    jp = jattn.mla_init(jax.random.PRNGKey(3), 64, q_lora=q_lora, **MLA)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 10, 64)).astype(
        np.float32)
    jx = jnp.asarray(x, getattr(jnp, compute_dtype))
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, compute_dtype))
    return jp, tp, jx, tx


# --------------------------------------------------------------------- #
# K5 at MLA's widths                                                     #
# --------------------------------------------------------------------- #
def _plain_flash_against_jax(dk, dv, causal, B, S, H, KV, seed):
    """K5's plain forward and backward at (dk, dv) against JAX's
    ``flash_attention_ref`` (which takes ``dv != hd``) and ``jax.vjp`` of
    it, in the model's ``[B, S, H, d]`` layout read through
    ``.transpose(1, 2)``, a block of 16 (smaller than S), float32, the
    inputs drawn from numpy's ``seed``."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, dk)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, dk)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, dv)).astype(np.float32)
    dout = rng.standard_normal((B, S, H, dv)).astype(np.float32)
    scale = dk ** -0.5
    want, vjp = jax.vjp(
        lambda q, k, v: jattn.flash_attention_ref(
            q, k, v, causal=causal, block=16, scale=scale),
        *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = k5.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    assert got.shape == (B, H, S, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(want),
                               atol=3e-5, rtol=1e-4)
    grads = k5.flash_attention_bwd(
        tq, tk, tv, got, torch.from_numpy(dout).transpose(1, 2).contiguous(),
        causal=causal, scale=scale)
    assert tuple(g.shape for g in grads) == (
        (B, H, S, dk), (B, KV, S, dk), (B, KV, S, dv))
    for g, jg in zip(grads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), jg, rtol=0,
                                   atol=1e-5 * float(np.abs(jg).max()))


@pytest.mark.parametrize("dk,dv", [(24, 16), (96, 64), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_with_dv_apart_matches_jax(dk, dv, causal):
    """K5's plain forward and backward with v narrower than q and k against
    JAX (``_plain_flash_against_jax``): S 37, 2 query heads a KV head."""
    _plain_flash_against_jax(dk, dv, causal, B=2, S=37, H=4, KV=2, seed=dk)


@pytest.mark.parametrize("dk,dv", [(96, 64), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_bwd_at_mla_widths_matches_jax_vjp(dk, dv, causal):
    """The same at the published MLA widths with one query head a KV head
    (the models' own layout) and S 70, past four of JAX's blocks."""
    _plain_flash_against_jax(dk, dv, causal, B=1, S=70, H=3, KV=3,
                             seed=dk + 1)


@pytest.mark.parametrize("dk,dv", [(96, 64), (192, 128), (24, 16),
                                   (128, 128)])
def test_k5_takes_mla_widths(dk, dv):
    q = torch.zeros(1, 2, 8, dk)
    k = torch.zeros(1, 2, 8, dk)
    v = torch.zeros(1, 2, 8, dv)
    assert k5._check(q, k, v, True) == (1, 2, 8, dk, 2, 8, dv)
    assert (dk, dv) in k5.WIDTHS


@pytest.mark.parametrize("dk,dv", [(96, 128), (64, 96), (192, 64),
                                   (128, 96), (16, 24), (96, 96)])
def test_k5_refuses_other_width_pairs(dk, dv):
    q, k, v = torch.zeros(1, 2, 8, dk), torch.zeros(1, 2, 8, dk), \
        torch.zeros(1, 2, 8, dv)
    with pytest.raises(ValueError, match=r"\(dk, dv\)"):
        k5._check(q, k, v, True)
    with pytest.raises(ValueError, match="not a pair the kernels take"):
        k5.flash_attention(q, k, v)


def test_k5_wgmma_pairs_are_mla_and_hd_128():
    """MLA's two published pairs, hd 128 and (since the encdec slice)
    Whisper's hd 64."""
    assert set(k5.WGMMA_WIDTHS) == {(128, 128), (64, 64), (96, 64),
                                    (192, 128)}
    assert set(k5.WGMMA_WIDTHS) <= set(k5.WIDTHS)


# --------------------------------------------------------------------- #
# The MLA layer                                                          #
# --------------------------------------------------------------------- #
def _mla_paths(apply, p, x, path, cache_init, np_):
    """(out, cache) of one path of ``apply``: ``train`` (no cache),
    ``prefill`` (the segment at 0 into a cache of 14) or ``decode`` (the
    first 9 positions prefilled, then the 10th alone, the absorbed
    path)."""
    kw = dict(MLA)
    if path == "train":
        return apply(p, x, **kw)[0], None
    cache = cache_init(2, 14, MLA["kv_lora"], MLA["qk_rope"], x.dtype)
    if path == "prefill":
        return apply(p, x, cache=cache, cache_len=np_(0), **kw)
    _, cache = apply(p, x[:, :9], cache=cache, cache_len=np_(0), **kw)
    return apply(p, x[:, 9:], cache=cache, cache_len=np_(9), **kw)


@pytest.mark.parametrize("path", ["train", "prefill", "decode"])
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("q_lora", [48, None], ids=["q_lora", "wq"])
def test_mla_apply_matches_jax(q_lora, compute_dtype, path):
    jp, tp, jx, tx = _mla(q_lora, compute_dtype)
    assert ("wq" in tp) == (q_lora is None)
    jout, jcache = _mla_paths(jattn.mla_apply, jp, jx, path,
                              jattn.mla_cache_init,
                              lambda n: jnp.asarray(n, jnp.int32))
    tout, tcache = _mla_paths(
        tattn.mla_apply, tp, tx, path,
        lambda *a: tattn.mla_cache_init(*a, device="cpu"), int)
    assert tout.shape == jout.shape and tout.dtype == tx.dtype
    np.testing.assert_allclose(_f32(tout), _f32(jout), **TOL[compute_dtype])
    if jcache is not None:
        for name in ("c_kv", "k_pe"):
            assert tcache[name].shape == jcache[name].shape
            np.testing.assert_allclose(_f32(tcache[name]), _f32(jcache[name]),
                                       **TOL[compute_dtype], err_msg=name)


@pytest.mark.parametrize("q_lora", [48, None], ids=["q_lora", "wq"])
def test_mla_gradients_match_jax_vjp(q_lora):
    """The expanded path's gradients in every weight and in x (K5's plain
    backward at (24, 16)) against ``jax.vjp`` of JAX's ``mla_apply`` at
    the same cotangent, float32."""
    jp, tp, jx, tx = _mla(q_lora, "float32")
    g = np.random.default_rng(5).standard_normal((2, 10, 64)).astype(
        np.float32)
    out, vjp = jax.vjp(lambda p, x: jattn.mla_apply(p, x, **MLA)[0], jp, jx)
    jgp, jgx = vjp(jnp.asarray(g))
    live = tree_map(lambda t: t.requires_grad_(True), tp)
    tx.requires_grad_(True)
    tout, _ = tattn.mla_apply(live, tx, **MLA)
    np.testing.assert_allclose(_f32(tout), np.asarray(out), **TOL["float32"])
    grads = torch.autograd.grad(tout, leaves(live) + [tx],
                                torch.from_numpy(g))
    names = sorted(live)
    for name, got in zip(names + ["x"], grads):
        want = np.asarray(jgx if name == "x" else jgp[name])
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=1e-5 * max(float(np.abs(want).max()), 1e-30), err_msg=name)


def test_mla_refuses_a_segment_after_a_filled_cache():
    _, tp, _, tx = _mla(48, "float32")
    cache = tattn.mla_cache_init(2, 14, MLA["kv_lora"], MLA["qk_rope"],
                                 torch.float32, "cpu")
    tattn.mla_apply(tp, tx[:, :4], cache=cache, cache_len=0, **MLA)
    with pytest.raises(NotImplementedError):
        tattn.mla_apply(tp, tx[:, 4:8], cache=cache, cache_len=4, **MLA)


# --------------------------------------------------------------------- #
# The two models                                                         #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_jax_packages(arch):
    from repro.configs import get_config as jget_config
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_smoke(arch), get_smoke(arch))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    tm.check_supported(get_config(arch))
    tm.check_supported(get_smoke(arch))


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(arch, compute_dtype):
    jcfg, tcfg, jp, tp = _models(arch, compute_dtype)
    toks = _tokens(1, jcfg.vocab, (2, 16))
    jl, js = jm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    tl, ts = tm.forward(tp, tcfg, {"tokens": torch.from_numpy(toks).long()})
    assert tl.shape == (2, 16, jcfg.vocab)
    assert tl.dtype == getattr(torch, compute_dtype)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    assert set(ts) == set(js)
    if compute_dtype == "float32":
        for k in js:
            assert ts[k].shape == js[k].shape, k
            np.testing.assert_allclose(_f32(ts[k]), _f32(js[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, compute_dtype):
    """Prefill (the expanded path through K5) and three decode steps (the
    absorbed path against the compressed cache): logits at each, and the
    latent cache of a scanned layer (and of the dense first layer)."""
    jcfg, tcfg, jp, tp = _models(arch, compute_dtype)
    B, S = 2, 13
    toks = _tokens(2, jcfg.vocab, (B, S))
    jcache = jm.init_cache(jcfg, B, S + 4)
    tcache = tm.init_cache(tcfg, B, S + 4, "cpu")
    jl, jcache = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = tm.prefill(tp, tcfg,
                            {"tokens": torch.from_numpy(toks).long()}, tcache)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    for step in range(3):
        nxt = _tokens(10 + step, jcfg.vocab, (B, 1))
        jl, jcache = jm.decode_step(jp, jcfg, jnp.asarray(nxt), jcache,
                                    jnp.asarray(S + step, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcfg, torch.from_numpy(nxt).long(),
                                    tcache, S + step)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(
            _f32(tcache["blocks"][1]["attn"][name]),
            _f32(jcache["blocks"]["attn"][name][1]), **TOL[compute_dtype])
        if tcfg.first_k_dense:
            np.testing.assert_allclose(
                _f32(tcache["dense_blocks"][0]["attn"][name]),
                _f32(jcache["dense_blocks"][0]["attn"][name]),
                **TOL[compute_dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_equals_jax(arch):
    """Float32: prefill then 6 greedy decode steps, each package feeding
    back its own argmax: the same tokens as a greedy loop over JAX's
    ``decode_step``."""
    jcfg, tcfg, jp, tp = _models(arch, "float32")
    B, S, steps = 2, 9, 6
    toks = _tokens(6, jcfg.vocab, (B, S))
    jcache = jm.init_cache(jcfg, B, S + steps)
    jl, jcache = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jcache)
    tcache = tm.init_cache(tcfg, B, S + steps, "cpu")
    tl, tcache = tm.prefill(tp, tcfg,
                            {"tokens": torch.from_numpy(toks).long()}, tcache)
    jtok, ttok = [], []
    for i in range(steps):
        jt = jnp.argmax(jl[:, -1:], -1).astype(jnp.int32)
        tt = tl[:, -1:].argmax(-1)
        jtok.append(np.asarray(jt))
        ttok.append(tt.numpy())
        jl, jcache = jm.decode_step(jp, jcfg, jt, jcache,
                                    jnp.asarray(S + i, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcfg, tt, tcache, S + i)
    np.testing.assert_array_equal(np.concatenate(ttok, 1),
                                  np.concatenate(jtok, 1))


def _serve(engine_mod, params, cfg, **kw):
    eng = engine_mod.ServeEngine(params, cfg, batch_size=3, max_len=8,
                                 eos_id=-1, **kw)
    rng = np.random.default_rng(5)
    for i in range(5):
        eng.submit(engine_mod.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, 2 + 3 * i).astype(
                np.int32), max_new_tokens=4 + i % 3))
    return [(r.uid, r.out_tokens) for r in eng.run()]


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_tokens_equal_jax(arch):
    """Float32 compute: the same requests (ragged prompts, left-padded;
    slots retire and refill) give the same greedy tokens in the same
    completion order through both packages' engines."""
    jcfg, tcfg, jp, tp = _models(arch, "float32")
    got = _serve(teng, tp, tcfg, device="cpu")
    assert got == _serve(jeng, jp, jcfg)
    assert len(got) == 5


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(S-1) + decode(1 token) == forward(S) at the last position,
    in the port alone (``tests/test_models.py``'s check and its MLA
    tolerance; MoE with the drop-free capacity factor so both paths see
    every token)."""
    cfg = get_smoke(arch)
    if cfg.n_experts:
        cfg = dataclasses.replace(
            cfg, capacity_factor=float(cfg.n_experts) / cfg.top_k)
    params = tm.init_params(cfg, 0, "cpu")
    B, S = 2, 12
    toks = torch.from_numpy(_tokens(3, cfg.vocab, (B, S))).long()
    full, _ = tm.forward(params, cfg, {"tokens": toks})
    cache = tm.init_cache(cfg, B, S + 4, "cpu")
    _, cache = tm.prefill(params, cfg, {"tokens": toks[:, :S - 1]}, cache)
    last, _ = tm.decode_step(params, cfg, toks[:, S - 1:S], cache, S - 1)
    err = (full[:, -1].float() - last[:, 0].float()).abs().max()
    assert float(err) <= 5e-2, float(err)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keep_the_jax_tree(arch):
    """The port's own init draws the JAX package's tree: the same leaves,
    shapes and dtypes (other numbers: another generator)."""
    jcfg, tcfg = jget_smoke(arch), get_smoke(arch)
    jshapes = jax.tree.map(lambda a: a.shape, jm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    tp = tm.init_params(tcfg, 0, "cpu")
    conv = params_from_jax(jax.tree.map(np.asarray, jm.init_params(
        jcfg, jax.random.PRNGKey(0))), tcfg, "cpu")
    assert len(leaves(tp)) == len(leaves(conv))
    for a, b in zip(leaves(tp), leaves(conv)):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert len(tp["blocks"]) == jshapes["blocks"]["ln1"][0]
