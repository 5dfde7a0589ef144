"""K5's log-sum-exp and the arithmetic of the backward's two new forms.

On the CPU, where the port's wrappers run their plain versions:

* the plain forward's lse (``flash_attention(..., return_lse=True)``)
  against ``jax.nn.logsumexp`` of ``repro.kernels.ref``'s masked float32
  scores.  Both sides are float32: the scores differ by at most
  ``2 hd 2^-24 max sum|scale q k|`` (another order; JAX scales after the
  product, the port before), the sums of T exponentials by ``2 T 2^-24``
  relative, and the log and the final add by ``2^-23 |lse|``;
* ``flash_attention_ad``'s gradients with the lse saved against ``jax.vjp``
  (the same ``1e-5`` of each tensor's largest entry as
  ``tests/test_torch_flash_bwd.py``);
* a float32 emulation of the ``wgmma`` backward route's split arithmetic
  (dO, P and dS split into bf16 hi + lo, each product summed in float32,
  P from the forward's lse) against the plain backward within the bound
  ``chip_smoke.py::check_flash_bwd`` states for that route, run here on CPU
  tensors; and the two faults the smoke plants (D dropped, the causal mask
  off) beyond it, so the bound is shown sound and tight before the card;
* K4's backward: bit-equal to the explicit transposed copies it no longer
  makes, NaN in x past ``rows`` reaching neither dx nor dw.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_matmul as k4

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke.py`` as a module (it imports nothing at the top but the
    standard library)."""
    mod = sys.modules.get("chip_smoke")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return mod


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _qkv(seed, B, H, KV, S, hd, dtype=torch.float32):
    return tuple(torch.from_numpy(_normal(seed + i, (B, h, S, hd))).to(dtype)
                 for i, h in enumerate((H, KV, KV)))


# --------------------------------------------------------------------- #
# The forward's log-sum-exp                                              #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,hd", [(1, 2, 2, 9, 16), (2, 4, 2, 33, 32),
                                          (1, 6, 2, 70, 128)])
def test_plain_lse_matches_jax_logsumexp(B, H, KV, S, hd, causal):
    q, k, v = _qkv(40, B, H, KV, S, hd)
    scale = hd ** -0.5
    out, lse = k5.flash_attention(q, k, v, causal=causal, scale=scale,
                                  return_lse=True)
    assert torch.equal(out, k5.flash_attention(q, k, v, causal=causal,
                                               scale=scale))
    rep = H // KV
    kr = jnp.repeat(jnp.asarray(k.numpy()), rep, axis=1)
    s = jnp.einsum("bhsd,bhtd->bhst", jnp.asarray(q.numpy()), kr) * scale
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((S, S), bool))[None, None], s,
                      -jnp.inf)
    want = np.asarray(jax.nn.logsumexp(s, axis=-1), np.float64)
    smax = float(np.einsum("bhsd,bhtd->bhst", np.abs(q.numpy()),
                           np.abs(np.asarray(kr))).max()) * scale
    tol = 2 * hd * 2.0**-24 * smax + 2 * S * 2.0**-24 \
        + 2.0**-23 * np.abs(want)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    assert np.all(np.abs(lse.numpy() - want) <= tol)


def test_ad_gradients_with_lse_saved_match_jax_vjp():
    """The autograd form saves the forward's lse beside out; its CPU
    gradients equal ``jax.vjp``'s as before."""
    B, H, KV, S, hd = 1, 4, 2, 21, 32
    q, k, v = _qkv(50, B, H, KV, S, hd)
    dout = torch.from_numpy(_normal(59, (B, H, S, hd)))
    scale = hd ** -0.5
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = k5.flash_attention_ad(*leaves, causal=True, scale=scale)
    got = torch.autograd.grad(out, leaves, dout)

    def f(q, k, v):
        kr, vr = (jnp.repeat(t, H // KV, axis=1) for t in (k, v))
        return jref.flash_attention(q, kr, vr, causal=True, scale=scale)

    _, vjp = jax.vjp(f, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    for g, jg in zip(got, vjp(jnp.asarray(dout.numpy()))):
        jg = np.asarray(jg, np.float64)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=1e-5 * float(np.abs(jg).max()))


def test_ad_asks_for_the_lse_only_with_a_gradient_to_take(monkeypatch):
    """The serve calls ``flash_attention_ad`` with no gradient to take: its
    forward is then a plain ``flash_attention`` call that asks for no lse
    (on the card the wgmma kernel writes none); a training call asks."""
    calls = []
    plain = k5.flash_attention

    def spy(*args, **kw):
        calls.append(kw.get("return_lse", False))
        return plain(*args, **kw)

    monkeypatch.setattr(k5, "flash_attention", spy)
    q, k, v = _qkv(80, 1, 2, 2, 8, 16)
    k5.flash_attention_ad(q, k, v)
    with torch.no_grad():
        k5.flash_attention_ad(q.requires_grad_(), k, v)
    k5.flash_attention_ad(q, k, v)
    assert calls == [False, False, True]


# --------------------------------------------------------------------- #
# The wgmma backward's arithmetic                                        #
# --------------------------------------------------------------------- #
def _split(x):
    """x = hi + lo + r in bf16, |r| <= 2^-16 |x|: (hi, lo) as float32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _wgmma_bwd(q, k, v, out, dout, lse, causal, scale, drop_d=False,
               mask=True):
    """The wgmma route's arithmetic in float32: S scaled after the
    product; P = exp(S - lse) (the -2^30 mask where causal and ``mask``);
    dP from dO's hi and lo; dS = P (dP - D); dV = P_hi dO_hi + P_lo dO_hi
    + P_hi dO_lo; dK and dQ from dS's hi and lo, times scale; each rounded
    once to the inputs' dtype.  ``drop_d`` and ``mask=False`` are the
    smoke's planted faults."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    do = dout.float()
    d = torch.zeros_like(lse) if drop_d else (do * out).sum(-1)
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf) * scale
    if causal and mask:
        vis = torch.ones(S, T, dtype=torch.bool).tril()
        s = torch.where(vis, s, tref.NEG_INF)
    p = torch.exp(s - lse[..., None])
    dh, dl = _split(do)
    dp = (torch.einsum("bhsd,bhtd->bhst", dh, vf)
          + torch.einsum("bhsd,bhtd->bhst", dl, vf))
    ds = p * (dp - d[..., None])
    ph, pl = _split(p)
    sh, sl = _split(ds)
    dv = sum(torch.einsum("bhst,bhsd->bhtd", a, b)
             for a, b in ((ph, dh), (pl, dh), (ph, dl)))
    dk = scale * (torch.einsum("bhst,bhsd->bhtd", sh, qf)
                  + torch.einsum("bhst,bhsd->bhtd", sl, qf))
    dq = scale * (torch.einsum("bhst,bhtd->bhsd", sh, kf)
                  + torch.einsum("bhst,bhtd->bhsd", sl, kf))
    if rep > 1:
        dk = dk.reshape(B, KV, rep, T, hd).sum(2)
        dv = dv.reshape(B, KV, rep, T, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _case(B, H, KV, S, causal, seed=60):
    q, k, v = _qkv(seed, B, H, KV, S, 128, torch.bfloat16)
    scale = 128 ** -0.5
    out, lse = tref.flash_attention(q, k, v, causal=causal, scale=scale,
                                    return_lse=True)
    dout = torch.from_numpy(_normal(seed + 9, (B, H, S, 128)))
    return q, k, v, out, lse, dout, scale


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S", [(1, 2, 2, 64), (1, 6, 2, 130),
                                      (2, 4, 4, 97)])
def test_wgmma_bwd_arithmetic_within_the_restated_bound(B, H, KV, S, causal):
    cs = _smoke()
    q, k, v, out, lse, dout, scale = _case(B, H, KV, S, causal)
    got = _wgmma_bwd(q, k, v, out, dout, lse, causal, scale)
    err = cs.check_flash_bwd(torch, "wgmma emulation", got, q, k, v, out,
                             dout, causal, scale, route="wgmma")
    assert err > 0


@pytest.mark.parametrize("fault", ["drop_d", "mask_off"])
def test_planted_bwd_faults_exceed_the_restated_bound(fault):
    """The smoke's "K5 backward drops D" and "K5 backward mask off" at the
    wgmma route's arithmetic lie beyond its bound."""
    cs = _smoke()
    q, k, v, out, lse, dout, scale = _case(1, 4, 2, 130, True)
    got = _wgmma_bwd(q, k, v, out, dout, lse, True, scale,
                     drop_d=fault == "drop_d", mask=fault != "mask_off")
    with pytest.raises(cs.SmokeFailure, match="beyond the stated bound"):
        cs.check_flash_bwd(torch, fault, got, q, k, v, out, dout, True,
                           scale, route="wgmma")


def test_plain_backward_within_both_routes_bounds():
    """The plain backward itself lies within either route's bound (no
    error at all): the bound is a limit on the distance from it."""
    cs = _smoke()
    q, k, v, out, lse, dout, scale = _case(1, 2, 2, 64, True)
    want = tref.flash_attention_bwd(q, k, v, out, dout, causal=True,
                                    scale=scale)
    for route in ("fma", "wgmma"):
        assert cs.check_flash_bwd(torch, route, want, q, k, v, out, dout,
                                  True, scale, route=route) == 0.0


def test_wgmma_bound_prices_twenty_hd_a_pair():
    cs = _smoke()
    pairs = 512 * 513 // 2 * 4 * 16
    assert pairs == 8_404_992
    ms, by = cs.k5_bwd_bound(4, 16, 16, 512, 512, 128, True, 2, "wgmma")
    t_ops = 20.0 * 128 * pairs / cs.BF16_TC_OPS_PER_S * 1e3
    assert by == "bytes" and ms > t_ops
    assert abs(t_ops - 0.0218) < 1e-3 and abs(ms - 0.0251) < 1e-3
    fma = cs.k5_bwd_bound(4, 16, 16, 512, 512, 128, True, 2)
    assert fma[1] == "operations" and fma[0] > 5 * ms


# --------------------------------------------------------------------- #
# K4's backward without the copies                                       #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,D,F", [(4, 13, 24, 40), (3, 70, 64, 136)])
def test_segment_matmul_bwd_equals_the_explicit_copies(E, C, D, F, dtype):
    x = torch.from_numpy(_normal(70, (E, C, D))).to(dtype)
    w = torch.from_numpy(_normal(71, (E, D, F), D ** -0.5)).to(dtype)
    dout = torch.from_numpy(_normal(72, (E, C, F))).to(dtype)
    rows = torch.tensor(np.r_[0, np.random.default_rng(C).integers(
        1, C, E - 2), C], dtype=torch.int32)
    dead = torch.arange(C)[None, :] >= rows.long()[:, None]
    x[dead] = float("nan")
    dx, dw = k4.segment_matmul_backward(dout, x, w, rows)
    live = ~dead[..., None]
    xz = torch.where(live, x, x.new_zeros(()))
    dz = torch.where(live, dout, dout.new_zeros(()))
    assert torch.equal(dx, tref.segment_matmul(
        dout, w.transpose(1, 2).contiguous(), rows))
    assert torch.equal(dw, tref.segment_matmul(
        xz.transpose(1, 2).contiguous(), dz))
    assert bool(torch.isfinite(dx).all()) and bool(torch.isfinite(dw).all())
    assert not bool(dx[dead].any())


def test_segment_matmul_bwd_routes_name_the_forms():
    assert k4.BWD_ROUTES == ("fma", "wmma", "tiles", "stream", "dx_tiles",
                             "dw_tiles")
    assert set(k4.bwd_routes) == set(k4.BWD_ROUTES)
    assert k5.BWD_LAUNCHES == {"fma": 2, "wgmma": 3}
    assert set(k5.bwd_routes) == set(k5.ROUTES)
