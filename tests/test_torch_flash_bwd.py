"""The backward of the model's two kernels, K4 and K5, against JAX.

The JAX package has no backward of its own for either kernel: its model
differentiates jnp code.  So the port's backward is held against
``jax.vjp`` of ``repro.kernels.ref``'s plain functions on the same numpy
inputs (on the CPU, where the port's wrappers run their plain versions),
and on the card (``gpu`` tests) each CUDA backward against its plain
version.

Tolerances, stated from the arithmetic:

* float32 on the CPU: both sides sum the same float32 products in other
  orders, and the softmax is recomputed on each side (JAX's ``-inf`` mask
  against the port's ``-2^30``, which gives the same zeros), so every
  gradient agrees within ``1e-5`` relative to the largest entry of its
  tensor (about 100 float32 ulps of sums of up to 64 terms);
* K4's backward in bf16: each side rounds a float32 sum to bf16 once, so
  within one bf16 ulp (``2^-7`` relative to the larger, for the two);
* on the card, :func:`_bwd_bound`: each float32 sum of n terms within
  ``n 2^-24`` of the sum of its magnitudes on either side, and P's
  relative error from the scores' hd-term dot products and the row's
  log-sum-exp, times the magnitude of each gradient term; for the
  ``wgmma`` route (bf16 at a pair of ``WGMMA_WIDTHS``) the terms
  ``chip_smoke.py``'s ``check_flash_bwd`` adds for its split operands
  (dO, P and dS in bf16 hi + lo, each within ``2^-16`` of its value; the
  forward's lse).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_matmul as k4


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _rel_close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


# --------------------------------------------------------------------- #
# K5: attention                                                          #
# --------------------------------------------------------------------- #
def _jax_attention_vjp(q, k, v, dout, causal, scale):
    """dq, dk, dv by jax.vjp of repro.kernels.ref.flash_attention, its
    KV heads repeated for GQA and the repeats' gradients summed."""
    rep = q.shape[1] // k.shape[1]

    def f(q, k, v):
        kr, vr = (jnp.repeat(t, rep, axis=1) for t in (k, v))
        return jref.flash_attention(q, kr, vr, causal=causal, scale=scale)

    out, vjp = jax.vjp(f, *(jnp.asarray(t) for t in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,hd", [(1, 2, 2, 9, 16), (2, 4, 2, 33, 32),
                                          (1, 3, 1, 64, 64)])
def test_flash_attention_bwd_matches_jax_vjp(B, H, KV, S, hd, causal):
    q = _normal(1, (B, H, S, hd))
    k = _normal(2, (B, KV, S, hd))
    v = _normal(3, (B, KV, S, hd))
    dout = _normal(4, (B, H, S, hd))
    scale = hd ** -0.5
    jout, jgrads = _jax_attention_vjp(q, k, v, dout, causal, scale)
    tq, tk, tv, tdo = (torch.from_numpy(t) for t in (q, k, v, dout))
    out = k5.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    _rel_close(out.numpy(), jout, 1e-5)
    grads = k5.flash_attention_bwd(tq, tk, tv, out, tdo, causal=causal,
                                   scale=scale)
    for g, jg in zip(grads, jgrads):
        assert g.dtype == torch.float32
        _rel_close(g.numpy(), jg, 1e-5)


def test_flash_attention_ad_is_differentiable_through_views():
    """The autograd form reads the model's [B, S, H, hd] tensors through
    .transpose(1, 2) and gives the plain backward's gradients."""
    B, S, H, KV, hd = 2, 17, 4, 2, 16
    q, k, v = (torch.from_numpy(_normal(10 + i, (B, S, h, hd)))
               .requires_grad_() for i, h in enumerate((H, KV, KV)))
    dout = torch.from_numpy(_normal(20, (B, H, S, hd)))
    out = k5.flash_attention_ad(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True, scale=0.5)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = tref.flash_attention_bwd(
        *(t.detach().transpose(1, 2).contiguous() for t in (q, k, v)),
        out.detach(), dout, causal=True, scale=0.5)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.transpose(1, 2), atol=0, rtol=0)


def test_flash_attention_bwd_bf16_returns_the_inputs_dtype():
    q, k, v = (torch.from_numpy(_normal(i, (1, 2, 8, 16))).bfloat16()
               for i in range(3))
    out = k5.flash_attention(q, k, v)
    grads = k5.flash_attention_bwd(q, k, v, out, torch.ones_like(out))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    assert [tuple(g.shape) for g in grads] == [(1, 2, 8, 16)] * 3


# --------------------------------------------------------------------- #
# K4: the grouped expert product                                         #
# --------------------------------------------------------------------- #
def _jax_segment_vjp(x, w, dout, rows):
    live = (np.ones(x.shape[:2], bool) if rows is None else
            np.arange(x.shape[1])[None, :] < rows[:, None])

    def f(x, w):
        xz = jnp.where(live[..., None], x, 0)
        return jnp.where(live[..., None], jref.segment_matmul(xz, w), 0)

    _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    return [np.asarray(g, np.float32) for g in vjp(jnp.asarray(dout))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_rows", [False, True])
def test_segment_matmul_bwd_matches_jax_vjp(dtype, with_rows):
    E, C, D, F = 4, 13, 24, 40
    x = _normal(1, (E, C, D))
    w = _normal(2, (E, D, F), D ** -0.5)
    dout = _normal(3, (E, C, F))
    rows = np.array([0, 5, 13, 9], np.int32) if with_rows else None
    tdt = getattr(torch, dtype)
    tx, tw, tdo = (torch.from_numpy(t).to(tdt) for t in (x, w, dout))
    jx, jw, jdo = (np.asarray(t.float().numpy()) for t in (tx, tw, tdo))
    trows = None if rows is None else torch.from_numpy(rows)
    if rows is not None:            # rows past the count take no part
        dead = np.arange(C)[None, :] >= rows[:, None]
        tx[torch.from_numpy(dead)] = float("nan")
    xg = tx.clone().requires_grad_()
    wg = tw.clone().requires_grad_()
    out = k4.segment_matmul_ad(xg, wg, trows)
    dx, dw = torch.autograd.grad(out, (xg, wg), tdo)
    jdx, jdw = _jax_segment_vjp(jx, jw, jdo, rows)
    assert dx.dtype == dw.dtype == tdt
    rel = 1e-5 if dtype == "float32" else 2.0 ** -7
    for g, jg in ((dx, jdx), (dw, jdw)):
        assert bool(torch.isfinite(g).all())
        if dtype == "float32":
            _rel_close(g.numpy(), jg, rel)
        else:                        # one bf16 rounding on each side
            jb = torch.from_numpy(jg.copy()).bfloat16().float().numpy()
            np.testing.assert_allclose(
                g.float().numpy(), jb, rtol=rel,
                atol=rel * float(np.abs(jb).max()) * 2.0 ** -8)
    if rows is not None:
        assert not bool(dx[torch.from_numpy(dead)].any())


def test_cpu_backward_counts_no_launch():
    before = (k4.segment_matmul_backward.launches,
              k5.flash_attention_bwd.launches)
    x = torch.ones(2, 3, 8, requires_grad=True)
    w = torch.ones(2, 8, 4, requires_grad=True)
    k4.segment_matmul_ad(x, w).sum().backward()
    q = torch.ones(1, 1, 4, 16, requires_grad=True)
    k5.flash_attention_ad(q, q, q).sum().backward()
    assert (k4.segment_matmul_backward.launches,
            k5.flash_attention_bwd.launches) == before


# --------------------------------------------------------------------- #
# On the card                                                            #
# --------------------------------------------------------------------- #
def _bwd_bound(q, k, v, out, dout, causal, scale, route="fma"):
    """Per-entry bounds on |kernel - plain| for (dq, dk, dv), both float32
    arithmetic on the same inputs.  A float32 sum of n terms in any order
    lies within n 2^-24 of the sum of the terms' magnitudes, so two orders
    within twice that.  P's relative error e_p: twice the scores' (hd-term
    dot products, times scale) and the row's log-sum-exp's (T terms), plus
    2^-21 for expf.  dS = P (dp - D): e_p |dS| plus P times the error of
    dp - D (two hd-term sums).  Each gradient: the error of its terms
    times their factors' magnitudes, plus its own sum's order.  A bf16
    output adds one rounding on each side (2^-7 of the larger; the
    caller adds it).  The wgmma route adds 2^-16 for each split operand
    (dO in dP, dS in dK and dQ), 2^-14 for dV's three hi / lo products and
    (2 + 2.35 max|s|) 2^-23 to e_p for the forward's lse."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    eps = 2.0 ** -24
    qs = q.float() * scale
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    do = dout.float()
    s = torch.einsum("bhsd,bhtd->bhst", qs, kf)
    if causal:
        vis = torch.ones(S, T, dtype=torch.bool, device=q.device).tril()
        s = torch.where(vis, s, float("-inf"))
    P = torch.softmax(s, -1)
    smax = float(torch.einsum("bhsd,bhtd->bhst", qs.abs(), kf.abs()).amax())
    e_p = 2 * (2 * hd * eps * smax + 2 * T * eps) + 2.0 ** -21
    split = dv_split = 0.0
    if route == "wgmma":
        e_p += (2 + 2.35 * smax) * 2.0 ** -23
        split, dv_split = 2.0 ** -16, 2.0 ** -14
    ds = P * (torch.einsum("bhsd,bhtd->bhst", do, vf)
              - (do * out.float()).sum(-1, keepdim=True))
    mag_dp = (torch.einsum("bhsd,bhtd->bhst", do.abs(), vf.abs())
              + (do * out.float()).abs().sum(-1, keepdim=True))
    n = max(S * rep, T)
    err_ds = (e_p + split) * ds.abs() + (4 * hd * eps + split) * P * mag_dp
    term = err_ds + 2 * n * eps * ds.abs()
    tol_dq = scale * torch.einsum("bhst,bhtd->bhsd", term, kf.abs())
    tol_dk = torch.einsum("bhst,bhsd->bhtd", term, qs.abs())
    tol_dv = (e_p + 2 * n * eps + dv_split) * torch.einsum(
        "bhst,bhsd->bhtd", P, do.abs())
    if rep > 1:
        tol_dk = tol_dk.reshape(B, KV, rep, T, -1).sum(2)
        tol_dv = tol_dv.reshape(B, KV, rep, T, -1).sum(2)
    return tol_dq, tol_dk, tol_dv


@pytest.mark.gpu
def test_cuda_flash_attention_bwd_matches_plain_version():
    """K5's backward kernels on the card against the plain backward within
    :func:`_bwd_bound` of the route each call takes (bf16 at a pair of
    ``WGMMA_WIDTHS``: wgmma, three launches; the rest: fma, two), float32
    and bf16, causal and full, rep 1, 2 and 3, ragged S and the model's
    [B, S, H, d] views, at equal widths and at MLA's (dk, dv) pairs
    (MiniCPM3-4B's (96, 64), DeepSeek-V2-Lite's (192, 128)), and the same
    bits from two calls.  At (192, 128) each dkv block walks several
    64-key items: T 200, 97 and 161 leave the last item ragged, the causal
    diagonal lies inside each item's first tile, and KV < H at rep 2 and
    3."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B, H, KV, S, dk, dv, views in ((1, 1, 1, 1, 16, 16, False),
                                       (2, 3, 1, 63, 64, 64, False),
                                       (1, 6, 2, 130, 128, 128, False),
                                       (2, 4, 4, 445, 64, 64, True),
                                       (2, 16, 16, 512, 128, 128, True),
                                       (2, 4, 4, 445, 96, 64, True),
                                       (1, 6, 2, 130, 96, 64, False),
                                       (2, 4, 4, 300, 192, 128, True),
                                       (1, 6, 3, 63, 192, 128, False),
                                       (1, 4, 2, 200, 192, 128, True),
                                       (2, 2, 2, 97, 192, 128, False),
                                       (1, 3, 1, 161, 192, 128, False)):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                shapes = [(B, S, h, d) if views else (B, h, S, d)
                          for h, d in ((H, dk), (KV, dk), (KV, dv))]
                q, k, v = (torch.from_numpy(_normal(i, s)).to("cuda", dtype)
                           for i, s in enumerate(shapes))
                if views:
                    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
                scale = dk ** -0.5
                out, lse = k5.flash_attention(q, k, v, causal=causal,
                                              scale=scale, return_lse=True)
                dout = torch.from_numpy(_normal(9, (B, H, S, dv))).cuda()
                route = k5.bwd_route(q, k, v)
                assert route == ("wgmma" if dtype == torch.bfloat16
                                 and (dk, dv) in k5.WGMMA_WIDTHS else "fma")
                launches = k5.flash_attention_bwd.launches
                got = k5.flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                             causal=causal, scale=scale)
                assert (k5.flash_attention_bwd.launches
                        == launches + k5.BWD_LAUNCHES[route])
                again = k5.flash_attention_bwd(q, k, v, out, dout, lse=lse,
                                               causal=causal, scale=scale)
                want = tref.flash_attention_bwd(
                    *(t.contiguous() for t in (q, k, v)), out, dout,
                    causal=causal, scale=scale)
                tols = _bwd_bound(q, k, v, out, dout, causal, scale, route)
                for g, a, w, tol in zip(got, again, want, tols):
                    assert g.dtype == dtype and g.shape == w.shape
                    assert torch.equal(g, a)
                    if dtype == torch.bfloat16:
                        tol = tol + 2.0 ** -7 * torch.maximum(
                            g.float().abs(), w.float().abs())
                    err = (g.float() - w.float()).abs()
                    assert bool((err <= tol).all()), float(err.max())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_segment_matmul_bwd_matches_plain_version():
    """K4's backward on the card (two launches a call: the tiles kernel's
    dx and dw forms in bf16, K4's fma kernel over copies in float32)
    against the plain backward, with ragged rows and NaN in x past them;
    C = 13 (no multiple of 8, under one stage) and 320 (the training
    capacity)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for E, C, D, F in ((4, 13, 24, 40), (8, 320, 256, 128)):
        rows = torch.tensor(np.random.default_rng(C).integers(0, C + 1, E),
                            dtype=torch.int32)
        rows[0] = 0
        rows[-1] = C
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(_normal(1, (E, C, D))).to(dtype)
            w = torch.from_numpy(_normal(2, (E, D, F), D ** -0.5)).to(dtype)
            dout = torch.from_numpy(_normal(3, (E, C, F))).to(dtype)
            dead = torch.arange(C)[None, :] >= rows.long()[:, None]
            x[dead] = float("nan")
            want = k4.segment_matmul_backward(dout, x, w, rows)
            launches = k4.segment_matmul_backward.launches
            got = k4.segment_matmul_backward(dout.cuda(), x.cuda(), w.cuda(),
                                             rows.cuda())
            assert k4.segment_matmul_backward.launches == launches + 2
            rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            for g, wn in zip(got, want):
                g = g.cpu().float()
                wn = wn.float()
                assert bool(torch.isfinite(g).all())
                torch.testing.assert_close(
                    g, wn, rtol=rel, atol=rel * float(wn.abs().max()))
    torch.cuda.synchronize()
