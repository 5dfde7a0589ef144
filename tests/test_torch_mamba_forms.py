"""K7's arithmetic as ``csrc/mamba_scan.cu`` computes it, emulated in float32
on the CPU, held to the bounds ``chip_smoke.py`` holds the card's kernel to.

The kernel runs only on the card, so its forms are emulated here with
numpy, step by step, on the same numpy inputs as the plain versions and
JAX's scan:

* the forward: da = ex2 of the rounded ``delta * a2`` (``a2 = a log2(e)``
  rounded once; ex2 taken exactly, then rounded, subnormals flushed to
  zero), dbx = ``(delta B) x``, ``h = fma(da, h, dbx)`` (the fma
  emulated in float64, then rounded), a lane's four ``h C`` products by
  fmas, the channel's four lanes by the transposed butterfly's order
  ``(P0 + P2) + (P1 + P3)``, ``y = fma(x, d_skip, sum)``; the state
  before every ``CHECKPOINT_EVERY``-th step kept as the backward's
  checkpoints;
* the backward: the chunks of ``CHECKPOINT_EVERY`` steps recomputed from
  those checkpoints with ``exp_of`` (one ex2 of ``z = p log2(e)`` times
  ``1 + (p - z ln 2)``, ln 2 in two parts), the walk down with its fmas,
  the sums over n in the butterfly's order, those over d over a block's 32
  channels in order, then over a cluster's blocks in rank order, then over
  the clusters (the cluster the largest divisor of the row's blocks up to
  8), dd_skip by each lane's own steps, then over the lanes.

Each is checked with ``chip_smoke.check_mamba`` / ``check_mamba_bwd``
against ``ref.mamba_scan`` / ``ref.mamba_scan_bwd`` and, the same bounds,
against JAX's scan (``_jax_scan`` of ``tests/test_torch_mamba_scan.py``)
and its ``jax.vjp``; the planted faults "state not carried" and "dh_fin
dropped" land beyond them.  Shapes are ragged in S, d_inner and N (N 3, 4
and 16), with and without a state, several blocks and clusters a row.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import mamba_scan as k7
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]

LANES = 4             # lanes a channel (FwdMap, BwdMap); 4 states a lane
CHANNELS = 32         # channels a block
MAX_N = 16
MAX_CLUSTER = 8
CK = k7.CHECKPOINT_EVERY
LOG2E = np.float32(1.4426950408889634)
LN2_HI = np.float32(0.693145751953125)
LN2_LO = np.float32(1.42860682030941723e-6)


def _load(name, path):
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def _smoke():
    """``chip_smoke.py`` as a module (it imports nothing at the top but the
    standard library)."""
    return _load("chip_smoke", ROOT / "chip_smoke.py")


def _jax_scan():
    return _load("_k7_scan_tests",
                 ROOT / "tests" / "test_torch_mamba_scan.py")._jax_scan


def _fma(a, b, c):
    """fma(a, b, c) rounded to float32 (the product exact in float64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def _ex2(z):
    """ex2.approx.ftz taken exactly and rounded: 2^z, subnormals to 0."""
    r = np.exp2(np.asarray(z, np.float64)).astype(np.float32)
    return np.where(r < 2.0**-126, np.float32(0), r)


def _exp_of(p):
    z = (p * LOG2E).astype(np.float32)
    r = _fma(-z, LN2_LO, _fma(-z, LN2_HI, p))
    e = _ex2(z)
    return _fma(e, r, e)


def _dot(h, c):
    """sum_n h c over ``[..., 16]``: a lane's four products by fmas, then
    the butterfly over the four lanes."""
    hq = h.reshape(h.shape[:-1] + (LANES, MAX_N // LANES))
    cq = np.broadcast_to(c, h.shape).reshape(hq.shape)
    p = (hq[..., 0] * cq[..., 0]).astype(np.float32)
    for s in range(1, MAX_N // LANES):
        p = _fma(hq[..., s], cq[..., s], p)
    return ((p[..., 0] + p[..., 2]).astype(np.float32)
            + (p[..., 1] + p[..., 3]).astype(np.float32)).astype(np.float32)


def _pad(v, n):
    out = np.zeros(v.shape[:-1] + (n,), np.float32)
    out[..., :v.shape[-1]] = v
    return out


def _cluster(nblk):
    return next(k for k in range(MAX_CLUSTER, 0, -1) if nblk % k == 0)


def _sum_over_d(v):
    """sum_d of ``v [B, DI, 16]`` in the kernel's order: a block's 32
    channels in order, a cluster's blocks in rank order, the clusters in
    order (from 0.0)."""
    B, DI, _ = v.shape
    nblk = -(-DI // CHANNELS)
    kc = _cluster(nblk)
    w = np.zeros((B, nblk * CHANNELS, MAX_N), np.float32)
    w[:, :DI] = v
    w = w.reshape(B, nblk // kc, kc, CHANNELS, MAX_N)
    blk = w[..., 0, :]
    for c in range(1, CHANNELS):
        blk = (blk + w[..., c, :]).astype(np.float32)
    clu = blk[:, :, 0]
    for r in range(1, kc):
        clu = (clu + blk[:, :, r]).astype(np.float32)
    tot = np.zeros((B, MAX_N), np.float32)
    for j in range(nblk // kc):
        tot = (tot + clu[:, j]).astype(np.float32)
    return tot


def emulate_forward(x, delta, bmat, cmat, a, d_skip, h0):
    """(y, the final state, the checkpoints) as the forward computes them."""
    B, S, DI = x.shape
    N = a.shape[-1]
    a2 = (_pad(a, MAX_N) * LOG2E).astype(np.float32)
    b16, c16 = _pad(bmat, MAX_N), _pad(cmat, MAX_N)
    h = (np.zeros((B, DI, MAX_N), np.float32) if h0 is None
         else _pad(h0, MAX_N))
    y = np.empty((B, S, DI), np.float32)
    cks = []
    for t in range(S):
        if t % CK == 0:
            cks.append(h.copy())
        dl = delta[:, t, :, None]
        da = _ex2((dl * a2).astype(np.float32))
        dbx = ((dl * b16[:, t, None]).astype(np.float32)
               * x[:, t, :, None]).astype(np.float32)
        h = _fma(da, h, dbx)
        y[:, t] = _fma(x[:, t], d_skip, _dot(h, c16[:, t, None]))
    return y, h[..., :N], cks


def _owned_steps(S, q):
    """Lane q's steps of dd_skip, in the order it adds them: chunks last
    first, each chunk's second 8 steps first, its two steps of the 8 in
    order."""
    out = []
    for c in reversed(range(-(-S // CK))):
        for half in reversed(range(CK // 8)):
            out += [t for t in (c * CK + half * 8 + 2 * q + j for j in (0, 1))
                    if t < S]
    return out


def emulate_backward(x, delta, bmat, cmat, a, d_skip, cks, dy, dh):
    """(dx, ddelta, dB, dC, da, dd_skip, dh0) as the backward computes them
    from the forward's checkpoints."""
    B, S, DI = x.shape
    N = a.shape[-1]
    an = _pad(a, MAX_N)
    b16, c16 = _pad(bmat, MAX_N), _pad(cmat, MAX_N)
    g = (np.zeros((B, DI, MAX_N), np.float32) if dh is None
         else _pad(dh, MAX_N))
    acc_a = np.zeros_like(g)
    dx, ddl = (np.empty((B, S, DI), np.float32) for _ in range(2))
    db, dc = (np.empty((B, S, MAX_N), np.float32) for _ in range(2))
    zero = np.zeros((B, DI), np.float32)
    for c in reversed(range(len(cks))):
        tc = c * CK
        h = cks[c].copy()
        hp, da = [], []

        def inputs(t):
            if t >= S:
                return zero, zero, zero, np.zeros((B, 1, MAX_N), np.float32), \
                    np.zeros((B, 1, MAX_N), np.float32)
            return (delta[:, t], x[:, t], dy[:, t], b16[:, t, None],
                    c16[:, t, None])

        for i in range(CK):
            dl, xv, _, bt, _ = inputs(tc + i)
            hp.append(h)
            da.append(_exp_of((dl[..., None] * an).astype(np.float32)))
            h = _fma(da[i], h, ((dl[..., None] * bt).astype(np.float32)
                                * xv[..., None]).astype(np.float32))
        for i in reversed(range(CK)):
            t = tc + i
            dl, xv, gy, bt, ct = inputs(t)
            ht = hp[i + 1] if i + 1 < CK else h
            dlx = (dl * xv).astype(np.float32)
            g = _fma(gy[..., None], ct, g)
            rc = (gy[..., None] * ht).astype(np.float32)
            rb = (g * dlx[..., None]).astype(np.float32)
            u = ((g * hp[i]).astype(np.float32) * da[i]).astype(np.float32)
            acc_a = _fma(u, dl[..., None], acc_a)
            s1 = _dot(g, bt)
            s2 = _dot(u, np.broadcast_to(an, u.shape))
            if t < S:
                ddl[:, t] = _fma(xv, s1, s2)
                dx[:, t] = _fma(dl, s1, (gy * d_skip).astype(np.float32))
                db[:, t] = _sum_over_d(rb)
                dc[:, t] = _sum_over_d(rc)
            g = (g * da[i]).astype(np.float32)
    dA = np.zeros((DI, MAX_N), np.float32)
    for b in range(B):
        dA = (dA + acc_a[b]).astype(np.float32)
    lane = np.zeros((LANES, B, DI), np.float32)
    for q in range(LANES):
        for t in _owned_steps(S, q):
            lane[q] = _fma(dy[:, t], x[:, t], lane[q])
    per_b = ((lane[0] + lane[2]).astype(np.float32)
             + (lane[1] + lane[3]).astype(np.float32)).astype(np.float32)
    dsk = np.zeros(DI, np.float32)
    for b in range(B):
        dsk = (dsk + per_b[b]).astype(np.float32)
    return (dx, ddl, db[..., :N], dc[..., :N], dA[:, :N], dsk,
            g[..., :N])


def _inputs(seed, B, S, DI, N, state):
    """K7's inputs as ``chip_smoke.mamba_inputs`` makes them, from numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    x = n(B, S, DI)
    delta = np.log1p(np.exp(n(B, S, DI))).astype(np.float32)
    bmat, cmat = n(B, S, N), n(B, S, N)
    a = (-np.exp(np.log(np.arange(1, N + 1)) + 0.2 * n(DI, N))).astype(
        np.float32)
    d_skip = (1 + 0.2 * n(DI)).astype(np.float32)
    h0 = n(B, DI, N) if state else None
    dy, dh = n(B, S, DI), n(B, DI, N)
    return (x, delta, bmat, cmat, a, d_skip, h0), dy, dh


def _t(v):
    return None if v is None else torch.from_numpy(np.array(v, np.float32))


SHAPES = [(2, 45, 37, 4), (1, 70, 300, 16), (3, 1, 40, 16), (2, 33, 70, 3),
          (1, 17, 224, 16)]


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_form_within_check_mamba(shape, state):
    cs = _smoke()
    args, _, _ = _inputs(sum(shape), *shape, state)
    y, h, _ = emulate_forward(*args)
    targs = tuple(_t(v) for v in args)
    cs.check_mamba(torch, "emulated forward", (_t(y), _t(h)), targs)
    if state:
        y0, h0, _ = emulate_forward(*args[:6], None)
        with pytest.raises(cs.SmokeFailure):
            cs.check_mamba(torch, "state not carried", (_t(y0), _t(h0)),
                           targs)


@pytest.mark.parametrize("dh", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_form_within_check_mamba_bwd(shape, dh):
    cs = _smoke()
    args, dy, dhf = _inputs(7 + sum(shape), *shape, True)
    _, _, cks = emulate_forward(*args)
    got = emulate_backward(*args[:6], cks, dy, dhf if dh else None)
    targs = tuple(_t(v) for v in args)
    cs.check_mamba_bwd(torch, "emulated backward", tuple(_t(v) for v in got),
                       targs, _t(dy), _t(dhf) if dh else None)
    if dh:
        dropped = emulate_backward(*args[:6], cks, dy, None)
        with pytest.raises(cs.SmokeFailure):
            cs.check_mamba_bwd(torch, "dh_fin dropped",
                               tuple(_t(v) for v in dropped), targs, _t(dy),
                               _t(dhf))


def _jax_inputs(args):
    x, delta, bmat, cmat, a, d_skip, h0 = args
    if h0 is None:
        h0 = np.zeros((x.shape[0], x.shape[2], a.shape[-1]), np.float32)
    return tuple(jnp.asarray(v) for v in (x, delta, bmat, cmat, a, d_skip,
                                          h0))


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("shape", SHAPES[:3],
                         ids=lambda s: "x".join(map(str, s)))
def test_forms_within_the_bounds_of_jaxs_scan(shape, state, monkeypatch):
    """The same bounds with JAX's scan and its vjp in the plain version's
    place (``ref`` patched for the call)."""
    cs = _smoke()
    args, dy, dh = _inputs(3 + sum(shape), *shape, state)
    (jy, jh), vjp = jax.vjp(_jax_scan(), *_jax_inputs(args))
    jgrads = [np.asarray(v) for v in vjp((jnp.asarray(dy), jnp.asarray(dh)))]
    monkeypatch.setattr(tref, "mamba_scan",
                        lambda *a: (_t(np.asarray(jy)), _t(np.asarray(jh))))
    monkeypatch.setattr(tref, "mamba_scan_bwd",
                        lambda *a: tuple(_t(v) for v in jgrads))
    y, h, cks = emulate_forward(*args)
    targs = tuple(_t(v) for v in args)
    cs.check_mamba(torch, "emulated forward against JAX", (_t(y), _t(h)),
                   targs)
    got = emulate_backward(*args[:6], cks, dy, dh)
    cs.check_mamba_bwd(torch, "emulated backward against JAX's vjp",
                       tuple(_t(v) for v in got), targs, _t(dy), _t(dh))


def test_exp_of_error_is_independent_of_the_argument():
    """``exp_of`` against exp in float64 over the arguments a Mamba head
    sees (down to -87): within 3 units in the last place however large
    |delta a|, where ex2 of the twice-rounded ``delta * a2`` (the forward's
    form) drifts by |delta a| units."""
    rng = np.random.default_rng(0)
    dl = np.log1p(np.exp(rng.standard_normal(20000) * 2)).astype(np.float32)
    a = (-np.exp(rng.uniform(0, np.log(30), 20000))).astype(np.float32)
    p = (dl * a).astype(np.float32)
    keep = p > -87
    dl, a, p = dl[keep], a[keep], p[keep]
    want = np.exp(p.astype(np.float64))
    ulp = np.spacing(want.astype(np.float32)).astype(np.float64)
    err = np.abs(_exp_of(p) - want) / ulp
    assert err.max() <= 3
    fwd = _ex2((dl * (a * LOG2E).astype(np.float32)).astype(np.float32))
    drift = np.abs(fwd - want) / ulp
    assert drift[np.abs(p) > 40].max() > 8
