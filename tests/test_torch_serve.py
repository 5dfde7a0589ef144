"""The serving slice of the port against the JAX package, on the CPU.

The JAX model's weights (``repro.models.init_params``, seed 0) are carried
into the port with ``params_from_jax``; tokens and activations are made
with numpy from a seed and fed to both.  Smoke configurations of
``olmoe-1b-7b`` (MoE, K4 on its path), ``llama3.2-3b`` (dense GQA with two
query heads per KV head, K5's grouping) and ``rwkv6-1.6b`` (RWKV6, K6, a
recurrent cache), on the port's CPU path, where K4, K5 and K6 run their
plain versions.

Tolerances, stated from the arithmetic:

* ``compute_dtype="float32"``: the two frameworks sum in other orders, so
  logits agree to ``atol = 2e-5, rtol = 1e-5`` (about 40 float32 ulps at
  the logits' magnitude of a few units), MoE outputs and stats to
  ``1e-5``, and greedy tokens are identical;
* ``compute_dtype="bfloat16"`` (the default): one rounding of a matmul
  output may land on the other side, one bf16 ulp is 2^-8 relative, and it
  spreads through the layers, so logits agree to ``atol = 0.0625,
  rtol = 0.02`` (four bf16 ulps at magnitude 2-4).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.models import layers as jlayers
from repro.models import model as jm
from repro.models import moe as jmoe
from repro.serve import engine as jeng
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve as tlaunch
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import engine as teng

ARCHS = ["olmoe-1b-7b", "llama3.2-3b", "rwkv6-1.6b", "yi-6b", "granite-8b"]
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=0.0625, rtol=0.02)}


def _cfgs(arch, compute_dtype):
    return (dataclasses.replace(jget_smoke(arch), compute_dtype=compute_dtype),
            dataclasses.replace(get_smoke(arch), compute_dtype=compute_dtype))


def _models(arch, compute_dtype):
    jcfg, tcfg = _cfgs(arch, compute_dtype)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _f32(a):
    return (a.float().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


# --------------------------------------------------------------------- #
# Layers, configs, conversion                                            #
# --------------------------------------------------------------------- #
def test_rmsnorm_and_rope_match_jax():
    x = np.random.default_rng(0).standard_normal((2, 5, 3, 16)).astype(
        np.float32)
    w = np.random.default_rng(1).uniform(0.5, 1.5, 16).astype(np.float32)
    pos = np.arange(5)[None, :] + 7
    np.testing.assert_allclose(
        tlayers.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))),
        atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(
        tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           500_000.0).numpy(),
        np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      500_000.0)), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_silu_rounds_as_jax_does(dtype):
    """``layers.silu`` (SwiGLU, the MoE experts, RWKV6's gate) rounds where
    ``jax.nn.silu`` does: bit for bit in bf16, where ``F.silu``, rounding
    once, differs in the last bit at about a third of the values; float32
    within one ulp."""
    x = (np.random.default_rng(0).standard_normal(50_000) * 4).astype(
        np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(getattr(torch, dtype))
    got, want = _f32(tlayers.silu(tx)), _f32(jax.nn.silu(jx))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0**-23)


def test_initializers_draw_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 256, 512)
    std = 256 ** -0.5
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 3 * std
    # A standard normal truncated to [-3, 3] has std 0.98654.
    assert abs(float(w.std()) / std - 0.98654) < 0.01
    assert abs(float(w.mean())) < 0.01 * std
    e = tlayers.embed_init(gen, 1000, 64)
    assert abs(float(e.std()) - 0.02) < 0.0005


def test_registry_ports_two_archs_and_refuses_the_rest():
    """Every architecture of the JAX package resolves (``whisper-medium``
    since the encdec family was ported, ``hymba-1.5b`` since the hybrid
    one was) and passes ``check_supported``; an unknown name raises
    ``KeyError`` and a family the JAX package does not build
    ``NotImplementedError``."""
    from repro_torch.configs import ARCH_IDS, PORTED
    assert get_config("olmoe-1b-7b").n_experts == 64
    assert get_config("llama3.2-3b").n_kv_heads == 8
    rwkv = get_config("rwkv6-1.6b")
    assert (rwkv.family, rwkv.attn, rwkv.hd) == ("ssm", "none", 64)
    whisper = get_config("whisper-medium")
    assert (whisper.family, whisper.n_enc_layers) == ("encdec", 24)
    hymba = get_config("hymba-1.5b")
    assert (hymba.family, hymba.ssm_state, hymba.swa_window) == (
        "hybrid", 16, 1024)
    assert sorted(PORTED) == sorted(ARCH_IDS)
    for arch in ARCH_IDS:
        tm.check_supported(get_config(arch))
    with pytest.raises(KeyError):
        get_config("gpt-2")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tm.check_supported(dataclasses.replace(get_smoke("llama3.2-3b"),
                                               family="retnet"))


@pytest.mark.parametrize("arch", ARCHS + ["whisper-medium", "hymba-1.5b"])
def test_configs_are_the_jax_packages(arch):
    from repro.configs import get_config as jget_config
    for j, t in ((jget_config(arch), get_config(arch)),
                 (jget_smoke(arch), get_smoke(arch))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("change", [
    dict(family="hybrid", ssm_state=4, swa_window=4),
    dict(family="encdec", n_enc_layers=2, enc_seq=12), dict(norm="ln")])
def test_unported_families_raise(change):
    """The families once unported now resolve and run: the hybrid family
    (a Mamba head of 4 states beside the attention of every block, window
    4), the encdec family and LayerNorm are taken on the OLMoE smoke
    configuration (MoE blocks; an encoder of MoE blocks over seeded
    frames; LayerNorm in place of RMS): float32 logits within the float32
    tolerance of JAX's ``forward``, and the hybrid one served by
    ``ServeEngine``."""
    tcfg = dataclasses.replace(get_smoke("olmoe-1b-7b"),
                               compute_dtype="float32", **change)
    tm.check_supported(tcfg)
    jcfg = dataclasses.replace(jget_smoke("olmoe-1b-7b"),
                               compute_dtype="float32", **change)
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    toks = _tokens(5, jcfg.vocab, (2, 8))
    jb, tb = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.from_numpy(toks).long()}
    if tcfg.family == "encdec":
        frames = np.random.default_rng(6).standard_normal(
            (2, tcfg.enc_seq, tcfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = (jnp.asarray(frames),
                                      torch.from_numpy(frames))
    jl, _ = jm.forward(jp, jcfg, jb, remat=False)
    tl, _ = tm.forward(tp, tcfg, tb, remat=False)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL["float32"])
    if tcfg.family == "hybrid":
        eng = teng.ServeEngine(tp, tcfg, batch_size=2, max_len=4,
                               device="cpu")
        for i in range(3):
            eng.submit(teng.Request(uid=i, prompt=toks[i % 2, :5 + i],
                                    max_new_tokens=3))
        done = eng.run()
        assert len(done) == 3 and all(len(r.out_tokens) >= 1 for r in done)


def test_params_from_jax_unstacks_the_layers():
    jcfg, tcfg, jp, tp = _models("llama3.2-3b", "bfloat16")
    assert len(tp["blocks"]) == tcfg.n_layers
    np.testing.assert_array_equal(
        tp["blocks"][1]["attn"]["wq"].numpy(),
        np.asarray(jp["blocks"]["attn"]["wq"][1]))
    assert "lm_head" not in tp          # tied embeddings


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_smoke("olmoe-1b-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        teng.ServeEngine({"embed": torch.zeros(1)}, cfg)


# --------------------------------------------------------------------- #
# MoE                                                                    #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("capacity_factor", [1.25, 4.0])
def test_moe_apply_and_stats_match_jax(compute_dtype, capacity_factor):
    """At 1.25 the capacity drops tokens (the training forward); at
    E / k = 4 it is drop-free (serving)."""
    jp = jmoe.moe_init(jax.random.PRNGKey(3), 64, 32, 8)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(4).standard_normal((2, 24, 64)).astype(
        np.float32)
    jdt = jnp.float32 if compute_dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(
        getattr(torch, compute_dtype))
    jout, jst = jmoe.moe_apply(jp, jx, top_k=2,
                               capacity_factor=capacity_factor,
                               return_stats=True)
    tout, tst = tmoe.moe_apply(tp, tx, top_k=2,
                               capacity_factor=capacity_factor,
                               return_stats=True)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    tol = TOL[compute_dtype]
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)
    if capacity_factor == 1.25:
        assert float(jst["dropped_frac"]) > 0
    for k in jst:
        np.testing.assert_allclose(
            _f32(tst[k]), _f32(jst[k]),
            **(dict(atol=1e-5, rtol=1e-5) if compute_dtype == "float32"
               else dict(atol=0.05, rtol=0.02)), err_msg=k)


def test_router_ties_keep_the_lower_expert():
    """Equal gates: ``lax.top_k`` keeps the lower index; so must the port."""
    logits = np.zeros((4, 8), np.float32)
    logits[0, [1, 5, 6]] = 2.0            # a three-way tie for two places
    logits[1, [7, 2]] = 1.0
    logits[2] = 3.0                       # all eight equal
    logits[3, [6, 3]] = -1.0              # ties below the rest
    jw, ji = jmoe.router_topk(jnp.asarray(logits, jnp.bfloat16), 2)
    tw, ti = tmoe.router_topk(torch.from_numpy(logits).to(torch.bfloat16), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ti.numpy()[:3], [[1, 5], [2, 7], [0, 1]])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-7)


def test_moe_rows_count_each_slots_tokens(monkeypatch):
    """``moe_apply`` hands K4 each slot's live rows: at the smoke OLMoE's
    prefill and decode, ``rows`` of each of the three expert products
    equals the non-sentinel entries of the slot's ``token_for_slot``, and
    serving being drop-free, they add up to every token's top-k."""
    cfg = get_smoke("olmoe-1b-7b")
    params = tm.init_params(cfg, 0, "cpu")
    tables, calls = [], []
    slot_tables, k4_call = tmoe.slot_tables, tmoe.k4.segment_matmul

    def tables_spy(keep, pos, combine_c, cap):
        out = slot_tables(keep, pos, combine_c, cap)
        tables.append((out[0], keep.shape[0]))
        return out

    def k4_spy(x, w, rows=None):
        calls.append(rows)
        return k4_call(x, w, rows)

    monkeypatch.setattr(tmoe, "slot_tables", tables_spy)
    monkeypatch.setattr(tmoe.k4, "segment_matmul", k4_spy)
    B, S = 2, 9
    cache = tm.init_cache(cfg, B, S + 1, "cpu")
    toks = torch.from_numpy(_tokens(5, cfg.vocab, (B, S + 1))).long()
    _, cache = tm.prefill(params, cfg, {"tokens": toks[:, :S]}, cache)
    per_call = len(tables)
    tm.decode_step(params, cfg, toks[:, S:], cache, S)
    assert per_call > 0 and len(tables) == 2 * per_call
    assert len(calls) == 3 * len(tables)
    for i, (token_for_slot, n) in enumerate(tables):
        want = (token_for_slot != n).sum(1).to(torch.int32)
        assert int(want.sum()) == n * cfg.top_k
        for rows in calls[3 * i:3 * i + 3]:
            assert rows.dtype == torch.int32 and torch.equal(rows, want)


def test_moe_refuses_what_the_training_slice_brings():
    """The training slice brought the balancer's routing table (an
    identity table changes nothing); the DP-local dispatch is ported too
    (``tests/test_torch_moe_grouped.py`` holds it against JAX): drop-free,
    two token groups give the global dispatch's output, and a group count
    that does not divide the tokens is refused."""
    p = tmoe.moe_init(torch.Generator().manual_seed(0), 16, 8, 4)
    x = torch.randn(4, 16, generator=torch.Generator().manual_seed(1))
    assert torch.equal(
        tmoe.moe_apply(p, x, top_k=2, expert_routing=torch.eye(4)),
        tmoe.moe_apply(p, x, top_k=2))
    torch.testing.assert_close(
        tmoe.moe_apply(p, x, top_k=2, capacity_factor=2.0, token_groups=2),
        tmoe.moe_apply(p, x, top_k=2, capacity_factor=2.0), rtol=0,
        atol=1e-6)
    with pytest.raises(ValueError):
        tmoe.moe_apply(p, x[:3], top_k=2, token_groups=2)


# --------------------------------------------------------------------- #
# The model                                                              #
# --------------------------------------------------------------------- #
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
            np.testing.assert_allclose(_f32(ts[k]), _f32(js[k]), atol=1e-5,
                                       rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("compute_dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, compute_dtype):
    jcfg, tcfg, jp, tp = _models(arch, compute_dtype)
    B, S = 2, 13
    toks = _tokens(2, jcfg.vocab, (B, S))
    jcache = jm.init_cache(jcfg, B, S + 4)
    tcache = tm.init_cache(tcfg, B, S + 4, "cpu")
    jl, jcache = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, jcache)
    tl, tcache = tm.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks).long()},
                            tcache)
    assert tl.shape == (B, 1, jcfg.vocab)
    np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    for step in range(3):
        nxt = _tokens(10 + step, jcfg.vocab, (B, 1))
        jl, jcache = jm.decode_step(jp, jcfg, jnp.asarray(nxt), jcache,
                                    jnp.asarray(S + step, jnp.int32))
        tl, tcache = tm.decode_step(tp, tcfg, torch.from_numpy(nxt).long(),
                                    tcache, S + step)
        np.testing.assert_allclose(_f32(tl), _f32(jl), **TOL[compute_dtype])
    if tcfg.family == "ssm":
        # The recurrent cache: the two shift carries, and the float32 state.
        # In bf16 the state is a decayed sum over the S + 3 tokens of k v^T
        # with k and v rounded to bf16; where one rounding lands on the
        # other side in an earlier layer, every term moves by about 2^-8 of
        # |k v|, and terms of both signs cancel in an entry while their
        # errors do not: the error scales with the state's largest entries,
        # so it is bounded by 2^-6 max|state| (measured: 0.7% of it).
        for n in ("shift", "cshift"):
            np.testing.assert_allclose(_f32(tcache["blocks"][1][n]),
                                       _f32(jcache["blocks"][n][1]),
                                       **TOL[compute_dtype])
        want = _f32(jcache["blocks"]["wkv"][1])
        tol = (TOL["float32"] if compute_dtype == "float32"
               else dict(atol=2.0**-6 * float(np.abs(want).max()), rtol=0))
        np.testing.assert_allclose(_f32(tcache["blocks"][1]["wkv"]), want,
                                   **tol)
    else:
        np.testing.assert_allclose(
            _f32(tcache["blocks"][1]["attn"]["k"]),
            _f32(jcache["blocks"]["attn"]["k"][1]), **TOL[compute_dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_all_positions_match_jax_forward(arch):
    """``prefill(all_positions=True)`` gives every prompt position's logits:
    the last is the default prefill's (up to the order of the head
    product's sums, which the BLAS picks by shape), and all equal the JAX
    forward's (float32 compute, the drop-free capacity factor that serving
    uses, so both paths see every token)."""
    jcfg, tcfg, jp, tp = _models(arch, "float32")
    if tcfg.n_experts:
        cf = float(tcfg.n_experts) / tcfg.top_k
        jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    B, S = 2, 11
    toks = _tokens(4, jcfg.vocab, (B, S))
    jl, _ = jm.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    batch = {"tokens": torch.from_numpy(toks).long()}
    every, _ = tm.prefill(tp, tcfg, batch, tm.init_cache(tcfg, B, S, "cpu"),
                          all_positions=True)
    last, _ = tm.prefill(tp, tcfg, batch, tm.init_cache(tcfg, B, S, "cpu"))
    assert every.shape == (B, S, jcfg.vocab)
    np.testing.assert_allclose(_f32(every[:, -1:]), _f32(last),
                               **TOL["float32"])
    np.testing.assert_allclose(_f32(every), _f32(jl), **TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """prefill(S-1) + decode(1 token) == forward(S) at the last position,
    in the port alone (``tests/test_models.py``'s check and tolerance; MoE
    with the drop-free capacity factor so both paths see every token)."""
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
    assert float(err) <= 2e-3, float(err)


# --------------------------------------------------------------------- #
# The serve engine                                                       #
# --------------------------------------------------------------------- #
def _serve(engine_mod, params, cfg, **kw):
    eng = engine_mod.ServeEngine(params, cfg, batch_size=3, max_len=8,
                                 eos_id=-1, **kw)
    rng = np.random.default_rng(5)
    for i in range(7):
        eng.submit(engine_mod.Request(
            uid=i, prompt=rng.integers(0, cfg.vocab, 2 + 3 * i).astype(
                np.int32), max_new_tokens=4 + i % 3))
    done = eng.run()
    return [(r.uid, r.out_tokens) for r in done], eng.tokens_decoded


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_engine_greedy_tokens_equal_jax(arch):
    """Float32 compute: the same requests (ragged prompts, left-padded;
    different budgets, so slots retire and refill) give the same greedy
    tokens in the same completion order."""
    jcfg, tcfg, jp, tp = _models(arch, "float32")
    want = _serve(jeng, jp, jcfg)
    got = _serve(teng, tp, tcfg, device="cpu")
    assert got == want
    assert len(got[0]) == 7


def test_temperature_sampling_is_seeded():
    cfg = get_smoke("llama3.2-3b")
    params = tm.init_params(cfg, 0, "cpu")
    a = _serve(teng, params, cfg, temperature=1.0, seed=7, device="cpu")
    b = _serve(teng, params, cfg, temperature=1.0, seed=7, device="cpu")
    assert a == b
    assert all(0 <= t < cfg.vocab for _, toks in a[0] for t in toks)


def test_serve_cli_on_the_cpu(capsys):
    done = tlaunch.main(["--arch", "olmoe-1b-7b", "--smoke", "--requests", "5",
                         "--max-new", "3", "--device", "cpu"])
    assert len(done) == 5 and all(len(r.out_tokens) == 3 for r in done)
    assert "completed 5 requests" in capsys.readouterr().out
