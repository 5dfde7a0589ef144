"""K7, the Mamba selective scan, on the CPU: its plain versions against the
JAX package's ``mamba_apply`` (``repro/models/ssm.py:176-207``), the step
size's softplus against ``jax.nn.softplus``, and the wrapper's refusals.

Inputs are made with numpy from a seed and fed to both packages.  The
forward: y within float32's 2e-6 + 1e-5 relative of JAX's and the final
state within 1e-5 relative (sums over N in another order); the backward
against ``jax.vjp`` of the same recurrence written as JAX writes it (its
``lax.scan``, ``ssm.py:193-206``): each gradient within 1e-5 of its
largest entry (float32 sums in other orders through the recurrence).
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.kernels import mamba_scan as k7
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers


def _jax_scan(x, delta, bmat, cmat, a, d_skip, h0):
    """``mamba_apply``'s recurrence, as JAX writes it (``ssm.py:188-206``),
    from its float32 inputs: (y float32, h_fin)."""
    da = jnp.exp(delta[..., None] * a[None, None])
    dbx = delta[..., None] * bmat[:, :, None, :] * x[..., None]

    def step(h, inp):
        da_t, dbx_t, c_t = inp
        h = da_t * h + dbx_t
        return h, jnp.einsum("bdn,bn->bd", h, c_t)

    xs = (jnp.moveaxis(da, 1, 0), jnp.moveaxis(dbx, 1, 0),
          jnp.moveaxis(cmat, 1, 0))
    h_fin, ys = jax.lax.scan(step, h0, xs)
    return jnp.moveaxis(ys, 0, 1) + x * d_skip, h_fin


def _inputs(seed, B, S, DI, N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, DI)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((B, S, DI)))).astype(
        np.float32)
    bmat = rng.standard_normal((B, S, N)).astype(np.float32)
    cmat = rng.standard_normal((B, S, N)).astype(np.float32)
    a = -np.exp(rng.standard_normal((DI, N)) * 0.5 + np.log(
        np.arange(1, N + 1))).astype(np.float32)
    d_skip = rng.uniform(0.5, 1.5, DI).astype(np.float32)
    h0 = rng.standard_normal((B, DI, N)).astype(np.float32)
    return x, delta, bmat, cmat, a, d_skip, h0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("shape", [(2, 1, 8, 16), (2, 37, 24, 16),
                                   (1, 130, 16, 4), (3, 65, 5, 3)])
def test_plain_scan_matches_jax(shape, state):
    x, delta, bmat, cmat, a, d_skip, h0 = _inputs(sum(shape), *shape)
    if not state:
        h0 = np.zeros_like(h0)
    jy, jh = _jax_scan(*(jnp.asarray(v) for v in
                         (x, delta, bmat, cmat, a, d_skip, h0)))
    y, h = tref.mamba_scan(*_t(x, delta, bmat, cmat, a, d_skip),
                           torch.from_numpy(h0) if state else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-6,
                               rtol=1e-5)
    # The wrapper's CPU path is the plain version, and launches nothing.
    before = k7.mamba_scan.launches
    wy, wh, ck = k7.mamba_scan(*_t(x, delta, bmat, cmat, a, d_skip),
                               torch.from_numpy(h0) if state else None,
                               checkpoints=True)
    assert torch.equal(wy, y) and torch.equal(wh, h) and ck is None
    assert k7.mamba_scan.launches == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_scan_is_mamba_applys(dtype):
    """Through ``mamba_apply`` itself: delta, B and C made by JAX's code
    from JAX's ``mamba_init`` weights, the scan by the plain version, y
    (and the state) against ``mamba_apply``'s; in bf16 y within one bf16
    ulp (2^-8 relative, plus 2^-8 absolute near zero)."""
    p = jssm.mamba_init(jax.random.PRNGKey(3), 24, 16)
    x = np.random.default_rng(0).standard_normal((2, 19, 24)).astype(
        np.float32)
    h0 = np.random.default_rng(1).standard_normal((2, 24, 16)).astype(
        np.float32)
    cdt = getattr(jnp, dtype)
    jx = jnp.asarray(x, cdt)
    jy, jh = jssm.mamba_apply(p, jx, state=jnp.asarray(h0))
    delta = jax.nn.softplus(jx @ p["w_dt"].astype(cdt)
                            + p["dt_bias"].astype(cdt)).astype(jnp.float32)
    bmat = (jx @ p["w_b"].astype(cdt)).astype(jnp.float32)
    cmat = (jx @ p["w_c"].astype(cdt)).astype(jnp.float32)
    a = -jnp.exp(p["a_log"].astype(jnp.float32))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    y, h = tref.mamba_scan(tx, *(torch.from_numpy(np.array(v)) for v in
                                 (delta, bmat, cmat, a, p["d_skip"])),
                           torch.from_numpy(h0))
    assert y.dtype == getattr(torch, dtype)
    tol = (dict(atol=2e-6, rtol=1e-5) if dtype == "float32"
           else dict(atol=2.0**-8, rtol=2.0**-8))
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=2e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("shape", [(2, 1, 8, 16), (2, 29, 12, 16),
                                   (1, 70, 6, 4)])
def test_plain_backward_matches_jax_vjp(shape, dh):
    x, delta, bmat, cmat, a, d_skip, h0 = _inputs(7 + sum(shape), *shape)
    rng = np.random.default_rng(1)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    dhf = rng.standard_normal(h0.shape).astype(np.float32)
    (jy, jh), vjp = jax.vjp(_jax_scan, *(jnp.asarray(v) for v in (
        x, delta, bmat, cmat, a, d_skip, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dhf if dh else
                                             np.zeros_like(dhf))))
    got = tref.mamba_scan_bwd(*_t(x, delta, bmat, cmat, a, d_skip, h0),
                              torch.from_numpy(dy),
                              torch.from_numpy(dhf) if dh else None)
    names = ("dx", "ddelta", "dB", "dC", "da", "dd_skip", "dh0")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-30),
                                   err_msg=name)


def test_autograd_function_is_the_plain_backward():
    """``mamba_scan_ad`` on CPU tensors: its gradients are
    ``ref.mamba_scan_bwd``'s at the same cotangents, and without a state
    it returns none for h0."""
    x, delta, bmat, cmat, a, d_skip, h0 = _inputs(3, 2, 21, 8, 16)
    args = [t.requires_grad_() for t in _t(x, delta, bmat, cmat, a, d_skip,
                                            h0)]
    y, h = k7.mamba_scan_ad(*args)
    rng = np.random.default_rng(2)
    dy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32))
    grads = torch.autograd.grad((y, h), args, (dy, dh))
    want = tref.mamba_scan_bwd(*_t(x, delta, bmat, cmat, a, d_skip, h0),
                               dy, dh)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    args = [t.detach().requires_grad_() for t in _t(x, delta, bmat, cmat,
                                                     a, d_skip)]
    y, h = k7.mamba_scan_ad(*args, None)
    assert len(torch.autograd.grad(y.sum(), args)) == 6


def test_softplus_is_jaxs_bit_for_bit():
    """``layers.softplus`` against ``jax.nn.softplus`` on every finite bf16
    value above -87 (below about -87.5 XLA's CPU flushes the subnormal
    ``exp`` to zero): the same bits; ``F.softplus``, rounding once, differs
    at some.  float32: within 2 ulps on a spread of values."""
    u = np.arange(1 << 16, dtype=np.uint16)
    xb = u.view(ml_dtypes.bfloat16)
    f = xb.astype(np.float32)
    xb = xb[np.isfinite(f) & (f > -87)]
    want = np.asarray(jax.nn.softplus(jnp.asarray(xb))).view(np.uint16)
    tx = torch.from_numpy(xb.view(np.uint16).astype(np.int16)).view(
        torch.bfloat16)
    got = tlayers.softplus(tx).view(torch.int16).numpy().view(np.uint16)
    assert len(xb) > 49_000
    np.testing.assert_array_equal(got, want)
    fused = torch.nn.functional.softplus(tx).view(torch.int16).numpy().view(
        np.uint16)
    assert (fused != want).sum() > 100
    x = np.random.default_rng(0).standard_normal(4096).astype(
        np.float32) * 8
    np.testing.assert_allclose(
        tlayers.softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(x))), rtol=2.0**-22, atol=0)


def test_softplus_gradient_is_jaxs():
    """``exp(x - softplus(x))``, JAX's derivative of ``logaddexp``."""
    x = np.linspace(-30, 30, 241).astype(np.float32)
    t = torch.from_numpy(x).requires_grad_()
    (g,) = torch.autograd.grad(tlayers.softplus(t).sum(), t)
    want = np.asarray(jax.grad(lambda v: jax.nn.softplus(v).sum())(
        jnp.asarray(x)))
    np.testing.assert_allclose(g.numpy(), want, rtol=2.0**-21, atol=1e-30)


def test_wrapper_refusals():
    x, delta, bmat, cmat, a, d_skip, h0 = _t(*_inputs(0, 2, 5, 8, 16))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k7.mamba_scan(x.double(), delta, bmat, cmat, a, d_skip)
    with pytest.raises(TypeError, match="must be float32"):
        k7.mamba_scan(x, delta.to(torch.bfloat16), bmat, cmat, a, d_skip)
    with pytest.raises(ValueError, match="x and delta"):
        k7.mamba_scan(x, delta[:, :3], bmat, cmat, a, d_skip)
    with pytest.raises(ValueError, match=r"\[B, S, N\]"):
        k7.mamba_scan(x, delta, bmat[:, :, :4], cmat, a, d_skip)
    with pytest.raises(ValueError, match=r"\[B, S, N\]"):
        k7.mamba_scan(x, delta, bmat, cmat, a, d_skip, h0[:1])
    wide = [torch.zeros(2, 5, 17), torch.zeros(8, 17)]
    with pytest.raises(ValueError, match="past the kernel's 16"):
        k7.mamba_scan(x, delta, wide[0], wide[0], wide[1], d_skip)
    with pytest.raises(ValueError, match="contiguous"):
        k7.mamba_scan(x.transpose(0, 1).contiguous().transpose(0, 1), delta,
                      bmat, cmat, a, d_skip)
    y, _ = k7.mamba_scan(x, delta, bmat, cmat, a, d_skip)
    with pytest.raises(ValueError, match="dy must be like y"):
        k7.mamba_scan_bwd(x, delta, bmat, cmat, a, d_skip, None,
                          y.to(torch.bfloat16))
    with pytest.raises(ValueError, match="dh_fin"):
        k7.mamba_scan_bwd(x, delta, bmat, cmat, a, d_skip, None, y,
                          h0.double())
