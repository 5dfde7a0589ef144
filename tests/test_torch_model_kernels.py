"""Model-side kernels K4 (``segment_matmul``) and K5 (``flash_attention``).

On the CPU the port's wrappers run their plain PyTorch versions, held
against the JAX package on the same numpy inputs: ``repro.kernels.ref``,
the Pallas kernels of ``repro.kernels.ops`` in interpret mode and, for K5,
the model's chunked flash (``repro.models.attention.flash_attention_ref``).
K4's ``rows`` (zeros past each expert's live rows) is checked against
the dense forms on inputs that are zero there, as the MoE layer's are.
Tolerances are those of ``tests/test_kernels.py``: float32 K4
``atol = rtol = 1e-4`` and bf16 ``atol = 0.5, rtol = 0.05``; float32 K5
``atol = 3e-5, rtol = 1e-4`` and bf16 ``atol = 0.06, rtol = 0.05`` (the
port returns float32 where the JAX forms round to bf16).  GQA: the JAX
kernels take pre-repeated KV heads, the port reads head ``h // rep``.
The ``gpu`` tests hold each CUDA kernel against its plain version on the
card; they skip without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _propcheck import given, settings, st

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import flash_attention_ref as jmodel_flash
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_matmul as k4
from repro_torch.models.attention import flash_attention_ref as tmodel_flash


def _normal(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _bf16(a):
    """numpy float32 -> (jnp bf16, torch bf16) holding the same values."""
    j = jnp.asarray(a, jnp.bfloat16)
    t = torch.from_numpy(np.asarray(j, np.float32)).to(torch.bfloat16)
    return j, t


# --------------------------------------------------------------------- #
# K4 segment_matmul                                                      #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("E,C,D,F,bm,bn,bk", [
    (2, 128, 128, 128, 128, 128, 128),
    (4, 256, 128, 256, 128, 128, 128),
    (3, 128, 256, 128, 64, 128, 128),
    (1, 256, 384, 128, 128, 64, 128),
])
def test_plain_segment_matmul_matches_pallas_and_ref(E, C, D, F, bm, bn, bk):
    x = _normal(1, (E, C, D), 0.5)
    w = _normal(2, (E, D, F), 0.05)
    got = k4.segment_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (E, C, F)
    pallas = jops.segment_matmul(jnp.asarray(x), jnp.asarray(w), block_m=bm,
                                 block_n=bn, block_k=bk)
    for want in (pallas, jref.segment_matmul(jnp.asarray(x), jnp.asarray(w))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_plain_segment_matmul_bf16():
    jx, tx = _bf16(_normal(1, (2, 128, 128)))
    jw, tw = _bf16(_normal(2, (2, 128, 128), 0.1))
    got = k4.segment_matmul(tx, tw)
    assert got.dtype == torch.bfloat16
    for want in (jops.segment_matmul(jx, jw), jref.segment_matmul(jx, jw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=0.5, rtol=0.05)


@pytest.mark.parametrize("E,C,D,F", [(3, 1, 7, 5), (2, 67, 33, 130),
                                     (1, 4, 2048, 96)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_segment_matmul_ragged_shapes(E, C, D, F, dtype):
    """Shapes no 128-tile divides (the Pallas kernel asserts it; the port
    takes them): against ``repro.kernels.ref``."""
    x, w = _normal(3, (E, C, D), 0.5), _normal(4, (E, D, F), 0.05)
    if dtype == "bfloat16":
        (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
        atol, rtol = 0.5, 0.05
    else:
        jx, tx, jw, tw = (jnp.asarray(x), torch.from_numpy(x),
                          jnp.asarray(w), torch.from_numpy(w))
        atol = rtol = 1e-4
    got = k4.segment_matmul(tx, tw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jref.segment_matmul(jx, jw),
                                          np.float32), atol=atol, rtol=rtol)


@settings(max_examples=10, deadline=None)
@given(E=st.integers(1, 3), C=st.integers(1, 20), D=st.integers(1, 40),
       F=st.integers(1, 40), bf16=st.integers(0, 1), seed=st.integers(0, 999))
def test_plain_segment_matmul_rows(E, C, D, F, bf16, seed):
    """``rows``: on inputs whose rows past ``rows[e]`` are zero (as the MoE
    layer's are) the plain version with rows equals it without, and the
    JAX kernel (Pallas, interpret mode) and ``repro.kernels.ref`` within
    the tolerances above; with garbage (NaN, 1e30) past ``rows[e]`` it
    gives the same rows and exact zeros past them."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, C + 1, E).astype(np.int32)
    live = np.arange(C)[None, :] < rows[:, None]                  # [E, C]
    x = np.where(live[..., None], _normal(seed, (E, C, D), 0.5), 0.0
                 ).astype(np.float32)
    w = _normal(seed + 1, (E, D, F), 0.05)
    if bf16:
        (jx, tx), (jw, tw) = _bf16(x), _bf16(w)
        tol = dict(atol=0.5, rtol=0.05)
    else:
        jx, tx, jw, tw = (jnp.asarray(x), torch.from_numpy(x),
                          jnp.asarray(w), torch.from_numpy(w))
        tol = dict(atol=1e-4, rtol=1e-4)
    trows = torch.from_numpy(rows)
    got = k4.segment_matmul(tx, tw, trows)
    assert got.dtype == tx.dtype and got.shape == (E, C, F)
    np.testing.assert_array_equal(got.float().numpy(),
                                  k4.segment_matmul(tx, tw).float().numpy())
    for want in (jops.segment_matmul(jx, jw), jref.segment_matmul(jx, jw)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)
    garbage = np.where(rng.integers(0, 2, (E, C, D)) == 1, np.nan, 1e30)
    tx_bad = torch.where(torch.from_numpy(live)[..., None], tx,
                         torch.from_numpy(garbage).to(tx.dtype))
    bad = k4.segment_matmul(tx_bad, tw, trows).float().numpy()
    np.testing.assert_array_equal(bad, got.float().numpy())
    assert not bad[~live].any()


@pytest.mark.parametrize("bad", ["mixed dtypes", "float64", "short w",
                                 "strided x", "2-d x", "rows int64",
                                 "rows [E + 1]", "rows [E, 1]",
                                 "rows elsewhere"])
def test_segment_matmul_rejects_bad_inputs(bad):
    x, w = torch.zeros(2, 8, 16), torch.zeros(2, 16, 4)
    rows, err = None, ValueError
    if bad == "mixed dtypes":
        w, err = w.to(torch.bfloat16), TypeError
    elif bad == "float64":
        x, w, err = x.double(), w.double(), TypeError
    elif bad == "short w":
        w = torch.zeros(2, 15, 4)
    elif bad == "strided x":
        x = torch.zeros(2, 16, 8).transpose(1, 2)
    elif bad == "2-d x":
        x = x[0]
    elif bad == "rows int64":
        rows, err = torch.zeros(2, dtype=torch.int64), TypeError
    elif bad == "rows [E + 1]":
        rows = torch.zeros(3, dtype=torch.int32)
    elif bad == "rows [E, 1]":
        rows = torch.zeros(2, 1, dtype=torch.int32)
    else:
        rows = torch.zeros(2, dtype=torch.int32, device="meta")
    with pytest.raises(err):
        k4.segment_matmul(x, w, rows)


# --------------------------------------------------------------------- #
# K5 flash_attention                                                     #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,H,KV,S,hd", [
    (1, 1, 1, 128, 64),
    (2, 3, 3, 256, 64),
    (1, 2, 2, 384, 128),
    (2, 4, 2, 256, 32),          # GQA, rep 2
    (1, 6, 2, 128, 16),          # GQA, rep 3
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas_and_ref(B, H, KV, S, hd, causal):
    q = _normal(0, (B, H, S, hd))
    k = _normal(1, (B, KV, S, hd))
    v = _normal(2, (B, KV, S, hd))
    got = k5.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (B, H, S, hd)
    rep = H // KV
    jq, jk, jv = (jnp.asarray(a) for a in (q, np.repeat(k, rep, axis=1),
                                            np.repeat(v, rep, axis=1)))
    for want in (jops.flash_attention(jq, jk, jv, causal=causal),
                 jref.flash_attention(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=3e-5, rtol=1e-4)


def test_plain_flash_bf16():
    (jq, tq), (jk, tk), (jv, tv) = (_bf16(_normal(i, (2, 2, 256, 64)))
                                    for i in range(3))
    got = k5.flash_attention(tq, tk, tv)
    assert got.dtype == torch.float32
    for want in (jops.flash_attention(jq, jk, jv),
                 jref.flash_attention(jq, jk, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   atol=0.06, rtol=0.05)


@pytest.mark.parametrize("H,KV", [(2, 2), (4, 2)])
@pytest.mark.parametrize("S", [1, 63, 256])
def test_flash_matches_model_reference(H, KV, S):
    """K5 (scale applied to q beforehand, as the port's model does) and the
    port's ``flash_attention_ref`` against the JAX model's chunked flash, in
    the model's ``[B, S, H, hd]`` layout, with a block smaller than S."""
    B, hd = 2, 64
    q = _normal(5, (B, S, H, hd))
    k = _normal(6, (B, S, KV, hd))
    v = _normal(7, (B, S, KV, hd))
    want = np.asarray(jmodel_flash(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=True, block=128))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    model_form = tmodel_flash(tq, tk, tv, causal=True, block=128)
    kernel = k5.flash_attention(
        (tq * hd ** -0.5).transpose(1, 2).contiguous(),
        tk.transpose(1, 2).contiguous(), tv.transpose(1, 2).contiguous(),
        causal=True, scale=1.0).transpose(1, 2)
    for got in (model_form, kernel):
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("bad", ["causal S != T", "head_dim 48",
                                 "H not a multiple of KV", "mixed dtypes",
                                 "hd not innermost"])
def test_flash_rejects_bad_inputs(bad):
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16)
    v, causal, err = k.clone(), True, ValueError
    if bad == "causal S != T":
        k, v = torch.zeros(1, 2, 9, 16), torch.zeros(1, 2, 9, 16)
    elif bad == "head_dim 48":
        q, k, v = (torch.zeros(*t.shape[:3], 48) for t in (q, k, v))
    elif bad == "H not a multiple of KV":
        k, v = torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16)
    elif bad == "mixed dtypes":
        v, err = v.to(torch.bfloat16), TypeError
    else:
        q = torch.zeros(1, 4, 16, 8).transpose(2, 3)
    with pytest.raises(err):
        k5.flash_attention(q, k, v, causal=causal)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_reads_views_as_their_copies(dtype, causal):
    """q, k, v in the model's ``[B, S, H, hd]`` layout seen through
    ``.transpose(1, 2)`` (hd innermost, the other strides in another
    order) give the same bits as their contiguous copies."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(_normal(20 + i, s)).to(dt) for i, s in
               enumerate([(2, 63, 6, 128), (2, 63, 2, 128), (2, 63, 2, 128)]))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    got = k5.flash_attention(*views, causal=causal)
    want = k5.flash_attention(*(t.contiguous() for t in views), causal=causal)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _wgmma_arithmetic(q, k, v, causal, scale, split=True, block=128):
    """K5's wgmma route on the CPU: the scores are exact bf16 products
    summed (here in float64) and rounded to float32, then scaled; the
    online softmax runs in float32 over 128-key tiles; P is split into
    ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, rounded to nearest even as
    the kernel's ``__float2bfloat16_rn`` does (``split=False``: P rounded
    once to bf16, as a plain bf16 P V would), and ``hi V + lo V`` is
    summed exactly and rounded to float32 once a tile."""
    B, H, S, _ = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    qd = q.double()
    kd = k.double().repeat_interleave(rep, dim=1)
    vd = v.double().repeat_interleave(rep, dim=1)
    m = torch.full((B, H, S), tref.NEG_INF, dtype=torch.float32)
    l = torch.zeros((B, H, S), dtype=torch.float32)
    acc = torch.zeros((B, H, S, v.shape[-1]), dtype=torch.float32)
    for k0 in range(0, T, block):
        kb, vb = kd[:, :, k0:k0 + block], vd[:, :, k0:k0 + block]
        s = torch.einsum("bhsd,bhtd->bhst", qd, kb).float() * scale
        if causal:
            keep = (torch.arange(k0, k0 + kb.shape[2])[None, :]
                    <= torch.arange(S)[:, None])
            s = torch.where(keep, s, tref.NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        hi = p.to(torch.bfloat16)
        parts = [hi]
        if split:
            parts.append((p - hi.float()).to(torch.bfloat16))
        pv = sum(torch.einsum("bhst,bhtd->bhsd", part.double(), vb)
                 for part in parts)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    return acc / torch.clamp(l, min=1e-20)[..., None]


def _flash_misses(got, want, v):
    """How many outputs miss each tolerance K5 is held to: the bound of
    ``chip_smoke.py::check_flash`` (3e-5 + 2 T 2^-24 max|v|) and
    ``atol = 3e-5, rtol = 1e-4`` (the ``gpu`` test below)."""
    T = v.shape[2]
    err = (got - want).abs()
    bound = 3e-5 + 2 * T * 2.0**-24 * float(v.float().abs().max())
    return (int((err > bound).sum()),
            int((err > 3e-5 + 1e-4 * want.abs()).sum()))


@pytest.mark.parametrize("rep", [1, 3])
@pytest.mark.parametrize("S", [1, 63, 445])
@pytest.mark.parametrize("causal", [True, False])
def test_split_p_keeps_the_float32_accuracy(S, rep, causal):
    """The wgmma route's P = hi + lo in bf16 against the float32 plain
    version at hd 128: within both tolerances K5 is held to."""
    q, k, v = (torch.from_numpy(_normal(30 + i, s)).to(torch.bfloat16)
               for i, s in enumerate([(2, 2 * rep, S, 128), (2, 2, S, 128),
                                      (2, 2, S, 128)]))
    scale = 128 ** -0.5
    got = _wgmma_arithmetic(q, k, v, causal, scale)
    want = tref.flash_attention(q, k, v, causal=causal, scale=scale)
    assert _flash_misses(got, want, v) == (0, 0)


def test_one_bf16_rounding_of_p_misses_the_float32_accuracy():
    """Why P is split: rounded once to bf16, P V misses both tolerances
    at the serve's prefill length."""
    q, k, v = (torch.from_numpy(_normal(30 + i, s)).to(torch.bfloat16)
               for i, s in enumerate([(2, 2, 445, 128), (2, 2, 445, 128),
                                      (2, 2, 445, 128)]))
    scale = 128 ** -0.5
    want = tref.flash_attention(q, k, v, causal=True, scale=scale)
    once = _wgmma_arithmetic(q, k, v, True, scale, split=False)
    bound_misses, tol_misses = _flash_misses(once, want, v)
    assert bound_misses > 0 and tol_misses > 0


def test_full_attention_takes_s_other_than_t():
    q, k, v = (torch.from_numpy(_normal(i, s)) for i, s in
               enumerate([(1, 2, 5, 32), (1, 2, 9, 32), (1, 2, 9, 32)]))
    got = k5.flash_attention(q, k, v, causal=False)
    want = jref.flash_attention(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                                jnp.asarray(v.numpy()), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5,
                               rtol=1e-4)


def test_cpu_tensors_never_count_launches():
    before = (k4.segment_matmul.launches, k5.flash_attention.launches)
    k4.segment_matmul(torch.ones(1, 2, 3), torch.ones(1, 3, 4))
    k5.flash_attention(torch.ones(1, 1, 4, 16), torch.ones(1, 1, 4, 16),
                       torch.ones(1, 1, 4, 16))
    assert (k4.segment_matmul.launches, k5.flash_attention.launches) == before


# --------------------------------------------------------------------- #
# On the card                                                            #
# --------------------------------------------------------------------- #
@pytest.mark.gpu
def test_cuda_segment_matmul_matches_plain_version():
    """K4 on the card against its plain version: float32 within
    ``1e-5 * sqrt(D) * max|x| * max|w|``-scale tolerance (another order of
    float32 sums), bf16 within one bf16 rounding of the output (the
    products are exact, the float32 sums differ in order).  Each shape
    dense and with ``rows`` all zero, full, and ragged (expert 0 at 0 rows,
    NaN in x past every expert's rows), rows past ``rows[e]`` exactly zero.
    The shapes reach every kernel: D or F no multiple of 8 (WMMA, FMA),
    C < 64 (the stream kernel, C = 4 and 12), C >= 64 (the tiles kernel,
    C = 1780), D and F no multiples of 64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for E, C, D, F in ((1, 1, 1, 1), (3, 67, 33, 130), (8, 4, 2048, 1024),
                       (4, 300, 256, 96), (3, 12, 72, 200),
                       (4, 1780, 200, 136)):
        ragged = np.random.default_rng(C).integers(0, C + 1, E)
        ragged[0] = 0
        cases = (None, np.zeros(E), np.full(E, C), ragged)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(_normal(E + C, (E, C, D), 0.5)).to(
                "cuda", dtype)
            w = torch.from_numpy(_normal(D + F, (E, D, F), 0.05)).to(
                "cuda", dtype)
            for case in cases:
                rows = (None if case is None else
                        torch.tensor(case, dtype=torch.int32, device="cuda"))
                live = torch.ones(E, C, dtype=torch.bool, device="cuda")
                if rows is not None:
                    live = (torch.arange(C, device="cuda")[None, :]
                            < rows.long()[:, None])
                xc = x.masked_fill(~live[..., None], float("nan"))
                launches = k4.segment_matmul.launches
                got = k4.segment_matmul(xc, w, rows)
                assert k4.segment_matmul.launches == launches + 1
                want = tref.segment_matmul(xc, w, rows)
                assert got.dtype == dtype and got.shape == want.shape
                tol = (1e-4 if dtype == torch.float32 else 2.0**-7)
                err = (got.float() - want.float()).abs()
                assert bool((err <= tol * (1 + want.float().abs())).all())
                assert not bool(got[~live].any())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_flash_attention_matches_plain_version():
    """K5 on the card against its plain version (float32 arithmetic in both,
    sums in another order; the wgmma route's P split into bf16 hi and lo):
    ``atol = 3e-5, rtol = 1e-4`` from float32 and bf16 inputs alike,
    causal and full, rep 1 and 3, ragged S.  bf16 at hd 128 and 64 takes
    the wgmma route, at hd 128 also at S = 64, 445 and 4096 and from the
    model's
    ``[B, S, H, hd]`` layout through ``.transpose(1, 2)``, which gives
    the same bits as its contiguous copy; so do MLA's (dk, dv) pairs of
    ``WGMMA_WIDTHS`` (MiniCPM3-4B's (96, 64), DeepSeek-V2-Lite's
    (192, 128)) at S = 63, 445 and 1,024, rep 1 and 2; every other call
    the fma route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def run(q, k, v, causal, route):
        before = dict(k5.routes)
        launches = k5.flash_attention.launches
        got = k5.flash_attention(q, k, v, causal=causal)
        assert k5.flash_attention.launches == launches + 1
        assert {r: k5.routes[r] - before[r] for r in k5.ROUTES} == {
            r: int(r == route) for r in k5.ROUTES}
        want = tref.flash_attention(q, k, v, causal=causal,
                                    scale=q.shape[-1] ** -0.5)
        torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
        return got

    for B, H, KV, S, hd in ((1, 1, 1, 1, 16), (2, 3, 1, 63, 64),
                            (1, 6, 2, 130, 128), (2, 4, 4, 512, 32)):
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = (torch.from_numpy(_normal(i, s)).to("cuda", dtype)
                           for i, s in enumerate([(B, H, S, hd),
                                                  (B, KV, S, hd),
                                                  (B, KV, S, hd)]))
                route = ("wgmma" if dtype == torch.bfloat16
                         and (hd, hd) in k5.WGMMA_WIDTHS else "fma")
                run(q, k, v, causal, route)
    for B, H, KV, S in ((2, 6, 2, 64), (4, 16, 16, 445), (1, 16, 16, 4096)):
        for causal in (True, False):
            q, k, v = (torch.from_numpy(_normal(40 + i, s)).to(
                "cuda", torch.bfloat16).transpose(1, 2) for i, s in
                enumerate([(B, S, H, 128), (B, S, KV, 128), (B, S, KV, 128)]))
            got = run(q, k, v, causal, "wgmma")
            copies = [t.contiguous() for t in (q, k, v)]
            torch.testing.assert_close(run(*copies, causal, "wgmma"), got,
                                       atol=0, rtol=0)
    for dk, dv in k5.MLA_WIDTHS:
        if (dk, dv) not in k5.WGMMA_WIDTHS:
            continue
        for B, H, KV, S in ((2, 4, 4, 63), (2, 8, 4, 445), (1, 8, 8, 1024)):
            for causal in (True, False):
                q, k, v = (torch.from_numpy(_normal(60 + i, s)).to(
                    "cuda", torch.bfloat16).transpose(1, 2) for i, s in
                    enumerate([(B, S, H, dk), (B, S, KV, dk),
                               (B, S, KV, dv)]))
                got = run(q, k, v, causal, "wgmma")
                copies = [t.contiguous() for t in (q, k, v)]
                torch.testing.assert_close(run(*copies, causal, "wgmma"),
                                           got, atol=0, rtol=0)
    torch.cuda.synchronize()
