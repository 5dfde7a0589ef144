"""K6's backward against JAX, on the CPU.

The JAX package has no backward of its own for K6: its model
differentiates the ``lax.scan`` of ``repro.models.ssm.rwkv6_apply``, and
``repro.kernels.ref.rwkv_scan`` is that scan.  So the port's backward
(``ref.rwkv_scan_bwd``, the plain version, and ``rwkv_scan_bwd``, which
runs it for CPU tensors) is held against ``jax.vjp`` of
``repro.kernels.ref.rwkv_scan`` on the same numpy inputs, against
``torch.autograd`` through ``ref.rwkv_scan``, and through the autograd
function the model calls (``rwkv_scan_ad``).  On the card (the ``gpu``
test) the CUDA backward is held against its plain version.

Tolerances, stated from the arithmetic:

* float32: both sides take the same float32 products and sum them in
  other orders (JAX's vjp of the scan, the port's einsums), so each
  gradient agrees within ``1e-5`` of the largest entry of its tensor;
* bf16 r, k, v (the model's call; w float32): dr, dk and dv are each
  side's float32 gradient rounded once to bf16, so two sides a hair apart
  on either side of a rounding boundary land one bf16 ulp apart
  (``rtol = 2^-7``);
* ``chip_smoke.py``'s ``check_rwkv_bwd``, the bound the card is held to:
  the exact gradients (float64) rounded to the outputs' types stay within
  it, and each planted fault ("G not decayed", "dw reads S_t for S_{t-1}",
  "du of one batch row", "dv without one row band's share") lands beyond
  it.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_scan as k6

ROOT = Path(__file__).resolve().parents[1]


def _smoke():
    """``chip_smoke.py`` as a module (it imports nothing of the card at
    import time)."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(B, H, T, hd, seed=0):
    """r, k, v (normal * 0.5), w in (0.45, 0.95), u (normal * 0.1), a
    state0 (normal * 0.5), dout (normal) and dstate_T (normal * 0.5),
    float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, H, T, hd)))) + 0.45
         ).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.5).astype(np.float32)
    dout = rng.standard_normal((B, H, T, hd)).astype(np.float32)
    ds = (rng.standard_normal((B, H, hd, hd)) * 0.5).astype(np.float32)
    return r, k, v, w, u, s0, dout, ds


def _bf16(a):
    """a rounded to bf16, as float32 numpy (the values both sides get)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


def _jax_vjp(r, k, v, w, u, s0, dout, ds, dtype):
    """(dr, dk, dv, dw, du, dstate0) by jax.vjp of
    repro.kernels.ref.rwkv_scan, r, k, v and dout in ``dtype``."""
    jr, jk, jv, jd = (jnp.asarray(a, dtype) for a in (r, k, v, dout))
    prim = [jr, jk, jv, jnp.asarray(w), jnp.asarray(u)]
    if s0 is not None:
        prim.append(jnp.asarray(s0))
    (out, fin), vjp = jax.vjp(lambda *a: jref.rwkv_scan(*a), *prim)
    ct = jnp.zeros_like(fin) if ds is None else jnp.asarray(ds)
    grads = vjp((jd, ct))
    return [np.asarray(g, np.float32) for g in grads]


def _rel_close(got, want, rel=1e-5, rtol=0.0):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(
        got, want, rtol=rtol,
        atol=rel * max(float(np.abs(want).max()), 1e-30))


@pytest.mark.parametrize("T", [1, 15, 16, 17, 53])
@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("hd", [16, 32, 64])
def test_plain_backward_matches_jax_vjp(hd, dtype, T):
    """Every gradient, with and without state0 and a dstate_T."""
    r, k, v, w, u, s0, dout, ds = _inputs(2, 2, T, hd, seed=hd + T)
    bf = dtype == "bf16"
    if bf:
        r, k, v, dout = (_bf16(a) for a in (r, k, v, dout))
    tdt = torch.bfloat16 if bf else torch.float32
    for s0_, ds_ in ((None, None), (s0, ds), (None, ds), (s0, None)):
        want = _jax_vjp(r, k, v, w, u, s0_, dout, ds_,
                        jnp.bfloat16 if bf else jnp.float32)
        got = tref.rwkv_scan_bwd(
            *(torch.from_numpy(a).to(tdt) for a in (r, k, v)),
            torch.from_numpy(w), torch.from_numpy(u),
            None if s0_ is None else torch.from_numpy(s0_),
            torch.from_numpy(dout).to(tdt),
            None if ds_ is None else torch.from_numpy(ds_))
        assert [g.dtype for g in got] == [tdt] * 3 + [torch.float32] * 3
        for i, name in enumerate(("dr", "dk", "dv", "dw", "du", "dstate0")):
            if i == 5 and s0_ is None:
                continue                # JAX takes no state0 to differentiate
            _rel_close(got[i], want[i], rtol=2.0**-7 if bf and i < 3 else 0)


@pytest.mark.parametrize("with_state", [False, True])
def test_plain_backward_matches_torch_autograd(with_state):
    """The same gradients as ``torch.autograd`` through ``ref.rwkv_scan``
    (the plain forward), all-bf16 inputs too (w bf16, dw in bf16)."""
    r, k, v, w, u, s0, dout, ds = _inputs(2, 3, 21, 32, seed=7)
    for dt in (torch.float32, torch.bfloat16):
        ins = [torch.from_numpy(a).to(dt) for a in (r, k, v, w)]
        ins += [torch.from_numpy(u),
                torch.from_numpy(s0) if with_state else None]
        live = [None if a is None else a.clone().requires_grad_(True)
                for a in ins]
        out, fin = tref.rwkv_scan(*live)
        d = torch.from_numpy(dout).to(dt)
        loss = (out.float() * d.float()).sum() + (fin * torch.from_numpy(ds)
                                                  ).sum()
        want = torch.autograd.grad(loss, [a for a in live if a is not None])
        got = tref.rwkv_scan_bwd(*ins, d, torch.from_numpy(ds))
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype
            _rel_close(g, wnt.float(), rtol=2.0**-7 if dt != torch.float32
                       else 0)


def test_rwkv_scan_ad_on_the_cpu_takes_the_plain_backward():
    """The autograd function the model calls, on CPU tensors passed as the
    model passes them (bf16 r, k, v and float32 w as [B, H, T, hd] views of
    [B, T, H * hd] activations): the plain version's gradients bit for
    bit, no kernel launch counted, and with no gradient to take it is
    ``rwkv_scan`` itself."""
    B, H, T, hd = 2, 3, 19, 16
    r, k, v, w, u, _, dout, _ = _inputs(B, H, T, hd, seed=3)
    acts = [torch.from_numpy(a.transpose(0, 2, 1, 3).reshape(B, T, H * hd)
                             .copy()) for a in (r, k, v, w)]
    acts[:3] = [a.to(torch.bfloat16) for a in acts[:3]]
    live = [a.clone().requires_grad_(True) for a in acts]
    tu = torch.from_numpy(u).requires_grad_(True)
    views = [a.view(B, T, H, hd).transpose(1, 2) for a in live]
    launches = (k6.rwkv_scan.launches, k6.rwkv_scan_bwd.launches)
    out, fin = k6.rwkv_scan_ad(*views, tu)
    d = torch.from_numpy(dout).to(torch.bfloat16)
    grads = torch.autograd.grad(out, live + [tu], d)
    plain = tref.rwkv_scan_bwd(*(a.detach().view(B, T, H, hd).transpose(1, 2)
                                 for a in acts), tu.detach(), None, d)
    for g, p in zip(grads[:4], plain[:4]):
        assert g.dtype == p.dtype
        assert torch.equal(g, p.transpose(1, 2).reshape(B, T, H * hd))
    assert torch.equal(grads[4], plain[4])
    assert (k6.rwkv_scan.launches, k6.rwkv_scan_bwd.launches) == launches
    with torch.no_grad():
        plain_out = k6.rwkv_scan_ad(*views, tu)
    assert not plain_out[0].requires_grad and torch.equal(plain_out[0], out)
    # The checkpoint buffer exists only on the card.
    assert k6.rwkv_scan(*(v_.detach() for v_ in views), tu.detach(),
                        checkpoints=True)[2] is None


def test_rwkv_scan_ad_takes_state0_and_the_final_state_gradient():
    """state0 and the final state in the graph (a carried state): their
    gradients are the plain version's dstate0 and its dstate_T input."""
    r, k, v, w, u, s0, dout, ds = _inputs(1, 2, 9, 16, seed=11)
    ins = [torch.from_numpy(a).requires_grad_(True)
           for a in (r, k, v, w, u, s0)]
    out, fin = k6.rwkv_scan_ad(*ins)
    grads = torch.autograd.grad((out, fin), ins, (torch.from_numpy(dout),
                                                  torch.from_numpy(ds)))
    plain = tref.rwkv_scan_bwd(*(a.detach() for a in ins),
                               torch.from_numpy(dout), torch.from_numpy(ds))
    for g, p in zip(grads, plain):
        assert torch.equal(g, p)


@pytest.mark.parametrize("bad", ["dout dtype", "dout shape", "dstate shape",
                                 "dstate bf16"])
def test_rwkv_scan_bwd_rejects_bad_inputs(bad):
    B, H, T, hd = 1, 2, 5, 16
    r, k, v, w = (torch.zeros(B, H, T, hd) for _ in range(4))
    u, dout, ds = torch.zeros(H, hd), torch.zeros(B, H, T, hd), None
    if bad == "dout dtype":
        dout = dout.to(torch.bfloat16)
    elif bad == "dout shape":
        dout = torch.zeros(B, H, T + 1, hd)
    elif bad == "dstate shape":
        ds = torch.zeros(B, H, hd, hd + 1)
    else:
        ds = torch.zeros(B, H, hd, hd, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        k6.rwkv_scan_bwd(r, k, v, w, u, None, dout, ds)


def _exact(args, dout, ds, fault=None):
    """The gradients in float64 (the exact ones, to within float64's
    rounding), rounded to the outputs' types; ``fault`` plants one of the
    named faults."""
    r, k, v, w, u, s0 = (None if a is None else a.double() for a in args)
    d = dout.double()
    B, H, T, hd = r.shape
    s = torch.zeros((B, H, hd, hd), dtype=torch.float64) if s0 is None else s0
    states = []
    for t in range(T):
        states.append(s)
        s = w[:, :, t, :, None] * s + k[:, :, t, :, None] * v[:, :, t, None, :]
    g = (torch.zeros((B, H, hd, hd), dtype=torch.float64) if ds is None
         else ds.double())
    dr, dk, dv, dw = (torch.empty((B, H, T, hd), dtype=torch.float64)
                      for _ in range(4))
    du = torch.zeros((B, H, hd), dtype=torch.float64)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dt = (x[:, :, t] for x in (r, k, v, w, d))
        vd = (vt * dt).sum(-1, keepdim=True)
        sp = states[t]
        dr[:, :, t] = torch.einsum("bhkc,bhc->bhk", sp, dt) + u * kt * vd
        dk[:, :, t] = torch.einsum("bhkc,bhc->bhk", g, vt) + u * rt * vd
        lo = 32 if fault == "dv without band 0" else 0
        dv[:, :, t] = (torch.einsum("bhkc,bhk->bhc", g[:, :, lo:],
                                    kt[:, :, lo:])
                       + dt * (rt * u * kt).sum(-1, keepdim=True))
        after = wt[..., None] * sp + kt[..., None] * vt[..., None, :]
        dw[:, :, t] = (g * (after if fault == "dw reads S_t" else sp)).sum(-1)
        du += rt * kt * vd
        g = (1.0 if fault == "G not decayed" else wt[..., None]) * g \
            + rt[..., None] * dt[..., None, :]
    du = du[0] if fault == "du of one batch row" else du.sum(0)
    return (dr.to(args[0].dtype), dk.to(args[0].dtype), dv.to(args[0].dtype),
            dw.to(args[3].dtype), du.float(), g.float())


#: The faults planted in the backward: the exact gradients with one term
#: wrong (``_exact``), as ``chip_smoke.rwkv_bwd_faults`` plants them in the
#: wrapper.
FAULTS = ("G not decayed", "dw reads S_t", "du of one batch row",
          "dv without band 0")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("kind", ["float32", "bf16 r, k, v", "bf16"])
@pytest.mark.parametrize("hd", [16, 64])
def test_check_rwkv_bwd_admits_the_exact_gradients_and_no_planted_fault(
        hd, kind, fault):
    """``chip_smoke.py``'s bound of K6's backward against its plain version
    admits the exact gradients (each side of the check lies within half of
    it), and the planted fault lands beyond it ("dv without band 0": G^T k
    without the first 32 rows, the share of the cluster's first block)."""
    cs = _smoke()
    r, k, v, w, u, s0, dout, ds = _inputs(3, 2, 2 * 8 + 5, hd, seed=hd)
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    if kind != "float32":
        args[:3] = [a.to(torch.bfloat16) for a in args[:3]]
    if kind == "bf16":
        args[3] = args[3].to(torch.bfloat16)
    d = torch.from_numpy(dout).to(args[0].dtype)
    dst = torch.from_numpy(ds)
    cs.check_rwkv_bwd(torch, "exact", _exact(args, d, dst), args, d, dst)
    with pytest.raises(cs.SmokeFailure):
        cs.check_rwkv_bwd(torch, fault, _exact(args, d, dst, fault), args,
                          d, dst)


@pytest.mark.parametrize("which", range(len(FAULTS)))
def test_smoke_faults_stand_in_for_the_backward_and_break_the_bound(which):
    """Each fault ``chip_smoke.py`` plants in the backward's wrapper (it
    still calls the wrapper, here its plain version) takes its signature
    and lands beyond ``check_rwkv_bwd``'s bound."""
    cs = _smoke()
    faults = cs.rwkv_bwd_faults(torch, k6)
    assert len(faults) == len(FAULTS)
    name, fn = faults[which]
    r, k, v, w, u, s0, dout, ds = _inputs(2, 2, 13, 16, seed=5)
    args = [torch.from_numpy(a) for a in (r, k, v, w, u, s0)]
    d, dst = torch.from_numpy(dout), torch.from_numpy(ds)
    got = fn(*args, d, dst, checkpoints=None)
    assert [g.dtype for g in got] == [g.dtype for g in
                                     k6.rwkv_scan_bwd(*args, d, dst)]
    with pytest.raises(cs.SmokeFailure):
        cs.check_rwkv_bwd(torch, name, got, args, d, dst)


@pytest.mark.gpu
def test_cuda_rwkv_scan_bwd_matches_plain_version():
    """K6's backward on the card against its plain version, within
    ``check_rwkv_bwd``'s bound, the same bits from two calls, one launch a
    call; the forward gives the same out and state bits with and without
    its checkpoints.  hd 16, 32 and 64 (and 5), T = 1, 7, 8, 9 and 29,
    with and without state0 and dstate_T, the three type kinds, contiguous
    and as views in the model's layout; and B 1, H 32, hd 64, T 29 (the
    cluster's case: 64 blocks, past two chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cs = _smoke()
    # (1, 32, 29, 64): a cluster of two blocks a (b, h), 64 of them, past
    # two chunks.
    for B, H, T, hd in ((1, 1, 1, 64), (2, 3, 7, 64), (2, 3, 8, 32),
                        (3, 2, 9, 16), (2, 2, 29, 64), (1, 2, 29, 5),
                        (1, 32, 29, 64)):
        r, k, v, w, u, s0, dout, ds = _inputs(B, H, T, hd, seed=T + hd)
        for kind in ("float32", "bf16 r, k, v", "bf16"):
            for with_state in (False, True):
                for views in (False, True):
                    args = [torch.from_numpy(a).cuda() for a in (r, k, v, w)]
                    d = torch.from_numpy(dout).cuda()
                    if kind != "float32":
                        args[:3] = [x.to(torch.bfloat16) for x in args[:3]]
                        d = d.to(torch.bfloat16)
                    if kind == "bf16":
                        args[3] = args[3].to(torch.bfloat16)
                    if views:
                        args = [x.transpose(1, 2).contiguous().transpose(1, 2)
                                for x in args]
                        d = d.transpose(1, 2).contiguous().transpose(1, 2)
                    args += [torch.from_numpy(u).cuda(),
                             torch.from_numpy(s0).cuda() if with_state
                             else None]
                    dst = torch.from_numpy(ds).cuda() if with_state else None
                    out, fin, ck = k6.rwkv_scan(*args, checkpoints=True)
                    plain_out, plain_fin = k6.rwkv_scan(*args)
                    assert torch.equal(out, plain_out)
                    assert torch.equal(fin, plain_fin)
                    launches = k6.rwkv_scan_bwd.launches
                    got = k6.rwkv_scan_bwd(*args, d, dst, checkpoints=ck)
                    again = k6.rwkv_scan_bwd(*args, d, dst, checkpoints=ck)
                    assert k6.rwkv_scan_bwd.launches == launches + 2
                    assert all(torch.equal(a, b) for a, b in zip(got, again))
                    if views and T > 1:
                        assert got[0].stride() == args[0].stride()
                    cs.check_rwkv_bwd(torch, f"{kind} {B, H, T, hd}", got,
                                      args, d, dst)
    torch.cuda.synchronize()
