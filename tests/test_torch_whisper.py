"""The encdec family (Whisper-medium: a bidirectional encoder over stubbed
frame embeddings and a decoder with cross attention) of the port against
the JAX package, on the CPU.

The JAX model's weights (``repro.models.init_params``, seed 0) are carried
into the port with ``params_from_jax``; tokens and frame embeddings are
made with numpy from a seed and fed to both.  The frames are seeded
standard normals, not the engine's zeros: with zero frames every batch row
gets the same encoder output and the cross attention could not tell
inputs apart.  Tolerances are those of ``tests/test_torch_serve.py`` and
``tests/test_torch_vlm.py``, stated from the arithmetic there: float32
logits within ``atol = 2e-5, rtol = 1e-5`` (the frameworks sum in other
orders) and gradients within ``1e-5`` of each leaf's largest entry; bf16
logits within ``atol = 0.0625, rtol = 0.02`` (one bf16 rounding of a
matmul output may land on the other side, 2^-8 relative, and spreads
through the layers) and gradients within ``0.05``; greedy tokens identical
in float32.  The port's K5 calls run its plain version here.
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
from repro.models import layers as jlayers
from repro.models import model as jm
from repro.train import checkpoint as jckpt
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tm
from repro_torch.models.convert import adamw_state_from_jax, params_from_jax
from repro_torch.serve import engine as teng
from repro_torch.train import checkpoint as tckpt
from repro_torch.train import optimizer as topt
from repro_torch.train import trainer as ttrainer
from repro_torch.tree import leaves, tree_map

ARCH = "whisper-medium"
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=0.0625, rtol=0.02)}
GRAD_TOL = {"float32": 1e-5, "bfloat16": 0.05}
#: The layer lists JAX stacks for its scan.
STACKS = ("blocks", "enc_blocks")


def _models(compute_dtype, **kw):
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype=compute_dtype,
                               **kw)
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype=compute_dtype,
                               **kw)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _inputs(cfg, seed, B, S):
    """Tokens ``[B, S]`` and float32 frames ``[B, enc_seq, d_model]``
    (standard normal, so that each row's encoder output differs)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    return toks, frames


def _jbatch(toks, frames):
    return {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}


def _tbatch(toks, frames):
    return {"tokens": torch.from_numpy(toks).long(),
            "frames": torch.from_numpy(frames)}


def _f32(a):
    return (a.detach().float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _close(got, want, rel, what):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        _f32(got), want, rtol=0,
        atol=rel * max(float(np.abs(want).max()), 1e-30), err_msg=what)


def _pairs(jtree, ttree, cfg):
    """(name, JAX leaf, port leaf) over every leaf, the stacked layer
    lists taken layer by layer."""
    counts = {"blocks": cfg.n_layers, "enc_blocks": cfg.n_enc_layers}
    out = [(k, jtree[k], ttree[k]) for k in jtree if k not in STACKS
           and not isinstance(jtree[k], dict)]
    out += [(f"{k}/{path}", want, _at(ttree[k], path))
            for k in jtree if k not in STACKS and isinstance(jtree[k], dict)
            for path, want in jax.tree_util.tree_flatten_with_path(
                jtree[k])[0]]
    for name in STACKS:
        for i in range(counts[name]):
            for path, want in jax.tree_util.tree_flatten_with_path(
                    jtree[name])[0]:
                out.append((f"{name}/{i}/{path}", want[i],
                            _at(ttree[name][i], path)))
    return out


def _at(node, path):
    for part in path:
        node = node[part.key]
    return node


# --------------------------------------------------------------------- #
# Config and layers                                                      #
# --------------------------------------------------------------------- #
def test_configs_are_the_jax_packages():
    for j, t in ((jget_config(ARCH), get_config(ARCH)),
                 (jget_smoke(ARCH), get_smoke(ARCH))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.attn, cfg.n_layers, cfg.n_enc_layers,
            cfg.enc_seq, cfg.n_kv_heads, cfg.hd, cfg.norm,
            cfg.act) == ("encdec", "gqa", 24, 24, 1500, 16, 64, "ln", "gelu")
    assert cfg.param_count() == 810_862_592


@pytest.mark.parametrize("dtype", DTYPES)
def test_layernorm_matches_jax(dtype):
    """The population variance in float32 (``torch.var``'s default is the
    unbiased one, off by D / (D - 1)), cast, then ``* g + b`` in x's
    dtype: float32 within 2e-6 (sums in other orders at magnitudes of a
    few units), bf16 within one bf16 ulp (2^-8 relative) of JAX's."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 7, 64)) * 3 + 1).astype(np.float32)
    g = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = _f32(jlayers.layernorm(jx, {"g": jnp.asarray(g),
                                       "b": jnp.asarray(b)}))
    got = _f32(tlayers.layernorm(
        torch.from_numpy(np.array(_f32(jx))).to(getattr(torch, dtype)),
        {"g": torch.from_numpy(g), "b": torch.from_numpy(b)}))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=2e-6)
    else:
        np.testing.assert_allclose(got, want, atol=0, rtol=2.0**-8)
    p = tlayers.layernorm_init(64)
    assert torch.equal(p["g"], torch.ones(64)) and not bool(p["b"].any())


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_rounds_as_jax_does(dtype):
    """``layers.gelu`` against ``jax.nn.gelu`` (the tanh form) over 65,536
    values at scales 0.5 to 8.  bf16: within one bf16 ulp, and in fact bit
    for bit here (the share of differing values is asserted under 1%,
    where ``F.gelu(approximate="tanh")``, rounding once, differs at over
    a third).  float32: XLA computes tanh by its own rational approximation,
    so a third of the values differ in their last bit or two: within
    1e-6 absolute (outputs of a few units) and 2^-21 relative."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(65536)
         * rng.choice([0.5, 1.0, 2.0, 4.0, 8.0], 65536)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(_f32(jx))).to(getattr(torch, dtype))
    want = _f32(jax.nn.gelu(jx))
    got = _f32(tlayers.gelu(tx))
    if dtype == "bfloat16":
        np.testing.assert_allclose(got, want, atol=0, rtol=2.0**-8)
        assert np.mean(got != want) < 0.01
        fused = _f32(torch.nn.functional.gelu(tx, approximate="tanh"))
        assert np.mean(fused != want) > 0.3
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0**-21)


@pytest.mark.parametrize("dtype", DTYPES)
def test_scalar_constants_round_as_jax_and_build_no_tensor(dtype, monkeypatch):
    """``scalar_mul`` (the constant rounded to x's dtype, kept a Python
    float) gives the bits of JAX's ``x * c`` and of multiplying by a tensor
    of x's dtype, and once warm, ``scalar_mul``, ``gelu`` and
    ``apply_rope`` build no tensor from a Python scalar (on the card each
    would be a host-to-device copy that waits for the stream)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.array(_f32(jx))).to(getattr(torch, dtype))
    for c in (0.044715, float(2 / np.pi) ** 0.5, 64 ** -0.5, 128 ** -0.5):
        got = tlayers.scalar_mul(tx, c)
        assert torch.equal(got, tx * torch.tensor(c, dtype=tx.dtype))
        np.testing.assert_array_equal(_f32(got), _f32(jx * c))
    rope_x = tx[:4 * 2 * 64].reshape(1, 4, 2, 64)
    pos = torch.arange(4)[None]
    warm = (tlayers.gelu(tx), tlayers.apply_rope(rope_x, pos))

    def no_tensor(*args, **kw):
        raise AssertionError("a tensor built from a Python scalar")

    monkeypatch.setattr(torch, "tensor", no_tensor)
    assert torch.equal(tlayers.gelu(tx), warm[0])
    assert torch.equal(tlayers.apply_rope(rope_x, pos), warm[1])


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_jax(dtype):
    """``gelu_mlp`` (``w_in``, ``b_in``, ``w_out``, ``b_out``) on JAX's
    weights: float32 within 2e-5, bf16 within 0.0625 + 2% (the models'
    logit tolerances: products summed in other orders)."""
    k = jax.random.PRNGKey(3)
    jp = jlayers.gelu_mlp_init(k, 64, 128)
    jp = dict(jp, b_in=jnp.full((128,), 0.1), b_out=jnp.full((64,), -0.2))
    tp = {n: torch.from_numpy(np.array(a)) for n, a in jp.items()}
    x = np.random.default_rng(1).standard_normal((2, 9, 64)).astype(
        np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = _f32(jlayers.gelu_mlp(jx, jp))
    got = _f32(tlayers.gelu_mlp(
        torch.from_numpy(np.array(_f32(jx))).to(getattr(torch, dtype)), tp))
    np.testing.assert_allclose(got, want, **TOL[dtype])
    gen = torch.Generator().manual_seed(0)
    init = tlayers.gelu_mlp_init(gen, 64, 128)
    assert {n: tuple(t.shape) for n, t in init.items()} == {
        n: tuple(a.shape) for n, a in jp.items()}


# --------------------------------------------------------------------- #
# Encoder, cross attention, forward, loss                                #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_encoder_and_cross_attention_match_jax(compute_dtype):
    """``_run_encoder`` (frames + learned positions, the bidirectional
    blocks, ``ln_enc``) and one decoder block's cross attention
    (``attention.cross_attention``, JAX's ``_cross_attention``) over its
    output (S 5 queries against enc_seq 12 keys, no mask)."""
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    toks, frames = _inputs(jcfg, 1, 2, 5)
    je = jm._run_encoder(jp, jcfg, jnp.asarray(frames))
    te = tm._run_encoder(tp, tcfg, torch.from_numpy(frames))
    assert te.shape == (2, jcfg.enc_seq, jcfg.d_model)
    assert te.dtype == getattr(torch, compute_dtype)
    np.testing.assert_allclose(_f32(te), _f32(je), **TOL[compute_dtype])
    cdt = getattr(jnp, compute_dtype)
    x = np.random.default_rng(2).standard_normal((2, 5, jcfg.d_model))
    jx = jnp.asarray(x, cdt)
    jc, _ = jm._cross_attention(
        jcfg, jax.tree.map(lambda a: a[1], jp["blocks"])["cross"], jx, je)
    tdt = getattr(torch, compute_dtype)
    tc = tattn.cross_attention(
        tp["blocks"][1]["cross"],
        torch.from_numpy(np.array(_f32(jx))).to(tdt),
        torch.from_numpy(np.array(_f32(je))).to(tdt),
        n_heads=tcfg.n_heads, head_dim=tcfg.hd)
    np.testing.assert_allclose(_f32(tc), _f32(jc), **TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_forward_matches_jax(compute_dtype):
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    toks, frames = _inputs(jcfg, 3, 2, 10)
    jl, _ = jm.forward(jp, jcfg, _jbatch(toks, frames), remat=False)
    tl, _ = tm.forward(tp, tcfg, _tbatch(toks, frames), remat=False)
    assert tl.shape == (2, 10, jcfg.vocab)
    assert tl.dtype == getattr(torch, compute_dtype)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_loss_and_grads_match_jax(compute_dtype):
    """``loss_fn`` (remat on the port's side, the encoder's blocks too)
    and its gradient at every leaf, ``enc_blocks``, ``enc_pos``,
    ``ln_enc`` and each decoder block's ``cross`` and ``ln_cross``
    included, against ``jax.value_and_grad``."""
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    toks, frames = _inputs(jcfg, 4, 2, 12)
    labels = np.roll(toks, -1, axis=1)
    jb = dict(_jbatch(toks, frames), labels=jnp.asarray(labels))
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jm.loss_fn(p, jcfg, jb, remat=False), has_aux=True)(jp)
    live = tree_map(lambda t: t.requires_grad_(True), tp)
    tb = dict(_tbatch(toks, frames), labels=torch.from_numpy(labels).long())
    loss, _ = tm.loss_fn(live, tcfg, tb, remat=True)
    grads = torch.autograd.grad(loss, leaves(live))
    assert abs(loss.item() - float(jloss)) <= (
        1e-5 * float(jloss) if compute_dtype == "float32" else 1e-3)
    it = iter(grads)
    tgrads = tree_map(lambda _: next(it), live)
    pairs = _pairs(jax.tree.map(np.asarray, jgrads), tgrads, jcfg)
    assert len(pairs) == len(grads)
    names = " ".join(n for n, _, _ in pairs)
    for part in ("enc_blocks/1/", "enc_pos", "ln_enc", "cross", "ln_cross"):
        assert part in names, part
    for name, want, got in pairs:
        _close(got, want, GRAD_TOL[compute_dtype], name)


# --------------------------------------------------------------------- #
# Prefill and decode                                                     #
# --------------------------------------------------------------------- #
def test_prefill_then_decode_is_teacher_forcing():
    """The check JAX's ``test_decode_matches_teacher_forcing`` leaves out
    for whisper: float32, prefill of S tokens (the encoder into
    ``cache["enc_out"]``) at every position and then three decode steps
    (each a cross attention of one query row) equal the port's own
    ``forward`` over S + 3 tokens, within the float32 logit tolerance."""
    _, tcfg, _, tp = _models("float32")
    B, S = 2, 8
    toks, frames = _inputs(tcfg, 5, B, S + 3)
    want, _ = tm.forward(tp, tcfg, _tbatch(toks, frames), remat=False)
    cache = tm.init_cache(tcfg, B, S + 3, "cpu")
    assert cache["enc_out"].shape == (B, tcfg.enc_seq, tcfg.d_model)
    got, cache = tm.prefill(tp, tcfg, _tbatch(toks[:, :S], frames), cache,
                            all_positions=True)
    np.testing.assert_allclose(_f32(got), _f32(want[:, :S]),
                               **TOL["float32"])
    for i in range(S, S + 3):
        got, cache = tm.decode_step(tp, tcfg,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    cache, i)
        np.testing.assert_allclose(_f32(got), _f32(want[:, i:i + 1]),
                                   **TOL["float32"])


@pytest.mark.parametrize("compute_dtype", DTYPES)
def test_prefill_and_decode_step_match_jax(compute_dtype):
    """``prefill`` (the encoder's output in the cache) and two decode
    steps against JAX's."""
    jcfg, tcfg, jp, tp = _models(compute_dtype)
    B, S = 2, 9
    toks, frames = _inputs(jcfg, 6, B, S + 2)
    jl, jcache = jm.prefill(jp, jcfg, _jbatch(toks[:, :S], frames),
                            jm.init_cache(jcfg, B, S + 2))
    tl, tcache = tm.prefill(tp, tcfg, _tbatch(toks[:, :S], frames),
                            tm.init_cache(tcfg, B, S + 2, "cpu"))
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    np.testing.assert_allclose(_f32(tcache["enc_out"]),
                               _f32(jcache["enc_out"]), **TOL[compute_dtype])
    for i in range(S, S + 2):
        jl, jcache = jm.decode_step(jp, jcfg, jnp.asarray(toks[:, i:i + 1]),
                                    jcache, jnp.asarray(i))
        tl, tcache = tm.decode_step(tp, tcfg,
                                    torch.from_numpy(toks[:, i:i + 1]).long(),
                                    tcache, i)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])


def _jax_greedy(jp, jcfg, prompts, max_new, max_len):
    """What the port's engine must produce: prompts left-padded with 0,
    zero frames, JAX's prefill, then one token at a time from S, greedy
    (JAX's engine's loop, with its host-side argmax)."""
    B = len(prompts)
    S = max(len(p) for p in prompts)
    toks = np.zeros((B, S), np.int32)
    for i, p in enumerate(prompts):
        toks[i, S - len(p):] = p
    frames = jnp.zeros((B, jcfg.enc_seq, jcfg.d_model), jnp.float32)
    cache = jm.init_cache(jcfg, B, S + max_len)
    logits, cache = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                          "frames": frames}, cache)
    out = [np.asarray(jnp.argmax(logits[:, -1], -1))]
    for pos in range(S, S + max_new - 1):
        logits, cache = jm.decode_step(jp, jcfg, jnp.asarray(out[-1][:, None]),
                                       cache, jnp.asarray(pos))
        out.append(np.asarray(jnp.argmax(logits[:, -1], -1)))
    return np.stack(out, axis=1)


def test_engine_greedy_equals_a_jax_decode_loop():
    """float32: the engine's greedy tokens (zero frames, JAX's stub) are
    JAX's."""
    jcfg, tcfg, jp, tp = _models("float32")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, jcfg.vocab, n).astype(np.int32)
               for n in (3, 5, 2, 4)]
    max_new = max_len = 5
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
def test_params_from_jax_unstacks_the_encoder():
    jcfg, tcfg, jp, tp = _models("float32")
    assert len(tp["enc_blocks"]) == jcfg.n_enc_layers
    assert len(tp["blocks"]) == jcfg.n_layers
    np.testing.assert_array_equal(
        tp["enc_blocks"][1]["attn"]["wq"].numpy(),
        np.asarray(jp["enc_blocks"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        tp["blocks"][1]["cross"]["wk"].numpy(),
        np.asarray(jp["blocks"]["cross"]["wk"][1]))
    assert "cross" not in tp["enc_blocks"][0]
    assert tuple(tp["enc_pos"].shape) == (jcfg.enc_seq, jcfg.d_model)
    # The port's own init has JAX's tree: every leaf, of JAX's shape.
    ref = tm.init_params(tcfg, 0, "cpu")
    pairs = _pairs(jax.tree.map(np.asarray, jp), ref, jcfg)
    assert len(pairs) == len(leaves(ref))
    for name, want, got in pairs:
        assert tuple(got.shape) == np.shape(want), name


def test_checkpoints_cross_between_the_packages():
    """A Whisper checkpoint written by either package restores in the
    other: the same keys (``enc_blocks`` stacked on a layer axis beside
    ``blocks``) and values."""
    jcfg, tcfg, jp, tp = _models("float32")
    js = jopt.init(jp)
    js = js._replace(step=jnp.asarray(5, jnp.int32),
                     m=jax.tree.map(lambda x: x * 0.5, js.m))
    ts = adamw_state_from_jax(jax.tree.map(np.asarray, tuple(js)), tcfg,
                              "cpu")
    jtree, ttree = {"params": jp, "opt": js}, {"params": tp, "opt": ts}
    with tempfile.TemporaryDirectory() as d:
        jpath = jckpt.save(os.path.join(d, "j"), 3, jtree, {"arch": "w"})
        tpath = tckpt.save(os.path.join(d, "t"), 3, ttree, {"arch": "w"})
        with np.load(jpath) as a, np.load(tpath) as b:
            assert sorted(a.files) == sorted(b.files)
            assert b["params/enc_blocks/attn/wq"].shape[0] == jcfg.n_enc_layers
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
    """Both trainers from one state (JAX's init), whisper-smoke (no
    balancer) on seeded frames: the same losses, and params within the
    bound ``tests/test_torch_train.py`` states (each step moves a param by
    at most its learning rate)."""
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=40)
    jcfg = dataclasses.replace(jget_smoke(ARCH), compute_dtype="float32")
    tcfg = dataclasses.replace(get_smoke(ARCH), compute_dtype="float32")
    jt = jtrainer.Trainer(jcfg, jtrainer.TrainConfig(
        opt=jopt.AdamWConfig(**opt), remat=False))
    tt = ttrainer.Trainer(tcfg, ttrainer.TrainConfig(
        opt=topt.AdamWConfig(**opt), remat=True), device="cpu")
    assert not tt.use_balancer
    tt.params = params_from_jax(jax.tree.map(np.asarray, jt.params), tcfg,
                                "cpu")
    tt.opt_state = adamw_state_from_jax(
        jax.tree.map(np.asarray, tuple(jt.opt_state)), tcfg, "cpu")
    toks, frames = _inputs(jcfg, 8, 4, 16)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1),
             "frames": frames}
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
    """The launcher gives the encdec family zero frames, as JAX's does."""
    log = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--steps", "4", "--log-every", "1"])
    assert len(log) == 4 and log[-1]["loss"] < log[0]["loss"]
    assert "done on cpu" in capsys.readouterr().out
