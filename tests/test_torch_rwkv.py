"""The RWKV6 slice of the port against the JAX package, on the CPU.

K6 (``rwkv_scan``): on the CPU the port's wrapper runs its plain PyTorch
version, held against ``repro.kernels.ref.rwkv_scan`` and the Pallas kernel
of ``repro.kernels.ops`` in interpret mode on the same numpy inputs, within
``tests/test_kernels.py``'s ``atol = rtol = 1e-4``.  The RWKV6 layers
(``rwkv6_apply``, ``rwkv6_cmix_apply``) against ``repro.models.ssm``, with
and without a carried state; the whole model, its cache and the serve
engine are in ``tests/test_torch_serve.py`` (``ARCHS``).

Tolerances of the layers, from the arithmetic: float32 compute sums in
other orders in the two frameworks, so outputs agree to ``atol = 2e-5,
rtol = 1e-5`` and the float32 state to ``1e-5`` relative to its magnitude
(T accumulated steps); in bf16 both round at the same places, and one
rounding that lands on the other side spreads through the recurrence, so
``atol = 0.0625, rtol = 0.02`` as for the models (four bf16 ulps at
magnitude 2-4).

The ``gpu`` test holds the CUDA kernel against its plain version on the
card; it skips without one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import model as jm
from repro.models import ssm as jssm
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rwkv_scan as k6
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax

F32 = dict(atol=2e-5, rtol=1e-5)
BF16 = dict(atol=0.0625, rtol=0.02)


def _scan_inputs(B, H, T, hd, seed=0):
    """r, k, v (normal * 0.5), w in (0.45, 0.95), u (normal * 0.1) and a
    state0 (normal * 0.5), float32 numpy, as ``tests/test_kernels.py``
    draws them."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, H, T, hd)).astype(np.float32) * 0.5
               for _ in range(3))
    w = (0.5 / (1.0 + np.exp(-rng.standard_normal((B, H, T, hd)))) + 0.45
         ).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((B, H, hd, hd)) * 0.5).astype(np.float32)
    return r, k, v, w, u, s0


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _f32(a):
    return (a.float().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a, np.float32))


# --------------------------------------------------------------------- #
# K6 rwkv_scan                                                           #
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("B,H,T,hd", [(1, 1, 32, 64), (2, 2, 64, 64),
                                      (1, 3, 128, 32), (2, 4, 40, 16)])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_rwkv_scan_matches_pallas_and_ref(B, H, T, hd, with_state):
    r, k, v, w, u, s0 = _scan_inputs(B, H, T, hd)
    s0 = s0 if with_state else None
    out, state = k6.rwkv_scan(*_t(r, k, v, w, u),
                              None if s0 is None else torch.from_numpy(s0))
    assert out.dtype == torch.float32 and out.shape == (B, H, T, hd)
    assert state.dtype == torch.float32 and state.shape == (B, H, hd, hd)
    js0 = None if s0 is None else jnp.asarray(s0)
    for wout, wstate in (jops.rwkv_scan(*_j(r, k, v, w, u), js0),
                         jref.rwkv_scan(*_j(r, k, v, w, u), js0)):
        np.testing.assert_allclose(out.numpy(), np.asarray(wout),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(state.numpy(), np.asarray(wstate),
                                   atol=1e-4, rtol=1e-4)


def test_plain_rwkv_scan_state_chaining():
    """Two halves with the carried state == one full scan (the analogue of
    ``tests/test_kernels.py::test_rwkv_scan_state_chaining``), and both
    equal the JAX oracle's full scan."""
    r, k, v, w, u, _ = _scan_inputs(1, 2, 64, 64, seed=1)
    tr, tk, tv, tw, tu = _t(r, k, v, w, u)
    full, s_full = k6.rwkv_scan(tr, tk, tv, tw, tu)
    h1, s1 = k6.rwkv_scan(*(x[:, :, :32].contiguous()
                            for x in (tr, tk, tv, tw)), tu)
    h2, s2 = k6.rwkv_scan(*(x[:, :, 32:].contiguous()
                            for x in (tr, tk, tv, tw)), tu, s1)
    np.testing.assert_allclose(torch.cat([h1, h2], 2).numpy(), full.numpy(),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), atol=1e-4,
                               rtol=1e-4)
    wout, wstate = jref.rwkv_scan(*_j(r, k, v, w, u))
    np.testing.assert_allclose(full.numpy(), np.asarray(wout), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s2.numpy(), np.asarray(wstate), atol=1e-4,
                               rtol=1e-4)


def test_plain_rwkv_scan_bf16_and_one_step():
    """bf16 r, k, v, w: the plain version (``ref.rwkv_scan``, JAX's
    signature) does float32 arithmetic on the same values as the oracle and
    rounds the output once to bf16 (within one bf16 rounding, 2^-7
    relative), the state float32; K6's wrapper takes the Pallas kernel's
    types, and on the CPU gives exactly the plain version's bits for bf16
    r, k, v with a float32 w (as the model calls it) and with a bf16 w.
    And T = 1, a decode step, through the wrapper on views in the model's
    ``[B, T, H, hd]`` layout."""
    r, k, v, w, u, s0 = _scan_inputs(2, 3, 24, 32, seed=2)
    jin = [jnp.asarray(a, jnp.bfloat16) for a in (r, k, v, w)]
    tin = [torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
           for a in jin]
    out, state = tref.rwkv_scan(*tin, torch.from_numpy(u),
                                torch.from_numpy(s0))
    wout, wstate = jref.rwkv_scan(*jin, jnp.asarray(u), jnp.asarray(s0))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(wout), atol=1e-4,
                               rtol=2.0**-7)
    np.testing.assert_allclose(state.numpy(), np.asarray(wstate), atol=1e-4,
                               rtol=1e-4)
    for w_in in (tin[3], torch.from_numpy(w)):
        got = k6.rwkv_scan(*tin[:3], w_in, torch.from_numpy(u),
                           torch.from_numpy(s0))
        want = tref.rwkv_scan(*tin[:3], w_in, torch.from_numpy(u),
                              torch.from_numpy(s0))
        assert got[0].dtype == torch.bfloat16
        assert got[1].dtype == torch.float32
        for g, p in zip(got, want):
            assert torch.equal(g, p)
    one = [x[:, :, :1].transpose(1, 2).contiguous().transpose(1, 2)
           for x in _t(r, k, v, w)]
    out1, state1 = k6.rwkv_scan(*one, torch.from_numpy(u),
                                torch.from_numpy(s0))
    wout1, wstate1 = jref.rwkv_scan(*(jnp.asarray(a[:, :, :1])
                                      for a in (r, k, v, w)),
                                    jnp.asarray(u), jnp.asarray(s0))
    np.testing.assert_allclose(out1.numpy(), np.asarray(wout1), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(state1.numpy(), np.asarray(wstate1),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("bad", ["mixed dtypes", "float64", "u bf16",
                                 "float16", "w bf16 under float32 r",
                                 "state0 shape", "u shape",
                                 "head size 65", "strided r", "layouts differ",
                                 "3-d r"])
def test_rwkv_scan_rejects_bad_inputs(bad):
    B, H, T, hd = 1, 2, 5, 16
    r, k, v, w = (torch.zeros(B, H, T, hd) for _ in range(4))
    u, s0, err = torch.zeros(H, hd), torch.zeros(B, H, hd, hd), ValueError
    if bad == "mixed dtypes":
        v, err = v.to(torch.bfloat16), TypeError
    elif bad == "float64":
        r, k, v, w = (x.double() for x in (r, k, v, w))
        err = TypeError
    elif bad == "u bf16":
        u, err = u.to(torch.bfloat16), TypeError
    elif bad == "float16":
        r, k, v, w = (x.to(torch.float16) for x in (r, k, v, w))
        err = TypeError
    elif bad == "w bf16 under float32 r":
        w, err = w.to(torch.bfloat16), TypeError
    elif bad == "state0 shape":
        s0 = torch.zeros(B, H, hd, hd + 1)
    elif bad == "u shape":
        u = torch.zeros(H + 1, hd)
    elif bad == "head size 65":
        r, k, v, w = (torch.zeros(B, H, T, 65) for _ in range(4))
        u, s0 = torch.zeros(H, 65), None
    elif bad == "strided r":
        r = torch.zeros(B, H, hd, T).transpose(2, 3)
    elif bad == "layouts differ":
        r = torch.zeros(B, T, H, hd).transpose(1, 2)
    else:
        r, k, v, w = (x[0] for x in (r, k, v, w))
    with pytest.raises(err):
        k6.rwkv_scan(r, k, v, w, u, s0)


def _fma(a, b, c):
    """float32 a * b + c rounded once (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _kernel_arithmetic(r, k, v, w, u, s0):
    """K6's CUDA kernel's order of float32 operations, replayed on the CPU:
    HDP = hd rounded up to 16, 32 or 64 (zero padding); the bonus beta_t as
    sixteen multiply-add chains of HDP / 16 terms of (r u) k and a shuffle
    tree; each thread's 4 x NC tile starting out_t[c] at beta_t v_t[c] (row
    group 0) and adding r S by multiply-adds before S = w S + k v; the
    HDP / 4 row groups' partial sums added as a tree; out rounded once to
    r's dtype."""
    B, H, T, hd = r.shape
    HDP = 16 if hd <= 16 else 32 if hd <= 32 else 64
    pad = (0, HDP - hd)
    rf, kf, vf, wf = (torch.nn.functional.pad(x.float(), pad)
                      for x in (r, k, v, w))
    uf = torch.nn.functional.pad(u.float(), pad)
    S = torch.zeros((B, H, HDP, HDP))
    if s0 is not None:
        S[:, :, :hd, :hd] = s0
    RG = HDP // 4
    out = torch.empty((B, H, T, HDP))
    for t in range(T):
        rt, kt, vt, wt = (x[:, :, t] for x in (rf, kf, vf, wf))
        parts = torch.zeros((B, H, 16))
        ru = (rt * uf).view(B, H, 16, HDP // 16)
        kp = kt.view(B, H, 16, HDP // 16)
        for m in range(HDP // 16):
            parts = _fma(ru[..., m], kp[..., m], parts)
        for o in (8, 4, 2, 1):
            parts = parts + parts[..., torch.arange(16) ^ o]
        beta = parts[..., 0]
        acc = torch.zeros((B, H, RG, HDP))
        acc[:, :, 0] = beta[..., None] * vt
        for j in range(4):
            rows = torch.arange(RG) * 4 + j
            kv = kt[:, :, rows, None] * vt[:, :, None, :]
            acc = _fma(rt[:, :, rows, None], S[:, :, rows], acc)
            S[:, :, rows] = _fma(wt[:, :, rows, None], S[:, :, rows], kv)
        span = 1
        while span < RG:
            acc[:, :, 0:RG:2 * span] = (acc[:, :, 0:RG:2 * span]
                                        + acc[:, :, span:RG:2 * span])
            span *= 2
        out[:, :, t] = acc[:, :, 0]
    return out[..., :hd].to(r.dtype), S[:, :, :hd, :hd]


def _within_check_rwkv(got, args):
    """``chip_smoke.py::check_rwkv``'s bound of K6 against the plain
    version: out within eps (6 P + (hd + 3 + max(hd, 16) + 3) O), plus one
    bf16 ulp of the larger side for a bf16 out, the final state within
    2 eps (3 D + A), with O, P, A, D its envelope of magnitudes."""
    r, k, v, w, u, s0 = (None if a is None else a.float().abs()
                         for a in args)
    B, H, T, hd = r.shape
    A = torch.zeros((B, H, hd, hd)) if s0 is None else s0.clone()
    D = torch.zeros_like(A)
    O, P = torch.empty((B, H, T, hd)), torch.empty((B, H, T, hd))
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        O[:, :, t] = torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                                  A + u[..., None] * kv)
        P[:, :, t] = torch.einsum("bhk,bhkv->bhv", r[:, :, t], D)
        A = w[:, :, t, :, None] * A + kv
        D = w[:, :, t, :, None] * D + A
    want, want_state = tref.rwkv_scan(*args)
    eps = 2.0**-24
    tol = eps * (6 * P + (hd + 3 + max(hd, 16) + 3) * O)
    if args[0].dtype == torch.bfloat16:
        big = torch.maximum(got[0].float().abs(), want.float().abs())
        tol = tol + torch.where(big > 0, torch.ldexp(
            torch.ones_like(tol), torch.frexp(big)[1] - 8), 0.0)
    return (bool(((got[0].float() - want.float()).abs() <= tol).all()),
            bool(((got[1] - want_state).abs()
                  <= 2 * eps * (3 * D + A)).all()))


@pytest.mark.parametrize("hd", [5, 16, 32, 64])
@pytest.mark.parametrize("kind", ["float32", "bf16 r, k, v"])
def test_kernel_arithmetic_stays_within_the_stated_bound(hd, kind):
    """The CUDA kernel's order of operations (the bonus as one dot product,
    4 x NC tiles, the row groups' tree), replayed in float32 on the CPU,
    stays within the bound ``chip_smoke.py`` holds the kernel to, and a
    kernel that dropped the bonus would not."""
    r, k, v, w, u, s0 = _t(*_scan_inputs(2, 3, 40, hd, seed=hd))
    if kind != "float32":
        r, k, v = (x.to(torch.bfloat16) for x in (r, k, v))
    args = (r, k, v, w, u, s0)
    assert _within_check_rwkv(_kernel_arithmetic(*args), args) == (True, True)
    no_bonus = _kernel_arithmetic(r, k, v, w, torch.zeros_like(u), s0)
    assert not _within_check_rwkv(no_bonus, args)[0]


@pytest.mark.gpu
def test_cuda_rwkv_scan_matches_plain_version():
    """K6 on the card against its plain version (float32 arithmetic in both,
    on the same widened values; the kernel sums out_t's terms in another
    order and takes the bonus as one dot product): ``atol = rtol = 1e-4``,
    and for a bf16 out one bf16 rounding more (``rtol = 2^-7``, as the
    plain version against the oracle); with and without state0, T = 0, 1
    and ragged, hd of 5 to 64, float32, bf16 r, k, v with a float32 w (the
    model's call) and all bf16, contiguous and as views in the model's
    ``[B, T, H, hd]`` layout (out then comes back in that layout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for B, H, T, hd in ((1, 1, 1, 64), (2, 3, 63, 64), (1, 4, 130, 32),
                        (3, 2, 17, 16), (1, 2, 33, 5), (2, 1, 0, 48)):
        r, k, v, w, u, s0 = _scan_inputs(B, H, T, hd, seed=T + hd)
        for kind in ("float32", "bf16 r, k, v", "bf16"):
            for with_state in (False, True):
                for views in (False, True):
                    args = [x.cuda() for x in _t(r, k, v, w)]
                    if kind != "float32":
                        args[:3] = [x.to(torch.bfloat16) for x in args[:3]]
                    if kind == "bf16":
                        args[3] = args[3].to(torch.bfloat16)
                    if views:
                        args = [x.transpose(1, 2).contiguous().transpose(1, 2)
                                for x in args]
                    args += [torch.from_numpy(u).cuda(),
                             torch.from_numpy(s0).cuda() if with_state
                             else None]
                    launches = k6.rwkv_scan.launches
                    out, state = k6.rwkv_scan(*args)
                    assert k6.rwkv_scan.launches == launches + 1
                    want, wstate = tref.rwkv_scan(*args)
                    assert out.shape == want.shape
                    assert out.dtype == want.dtype == args[0].dtype
                    assert state.dtype == torch.float32
                    assert out.stride() == args[0].stride() or T <= 1
                    rtol = 1e-4 if kind == "float32" else 2.0**-7
                    np.testing.assert_allclose(_f32(out), _f32(want),
                                               atol=1e-4, rtol=rtol)
                    np.testing.assert_allclose(state.cpu().numpy(),
                                               wstate.cpu().numpy(),
                                               atol=1e-4, rtol=1e-4)
    torch.cuda.synchronize()


# --------------------------------------------------------------------- #
# The RWKV6 layers                                                       #
# --------------------------------------------------------------------- #
def _layer_input(compute_dtype, B=2, S=12, D=64):
    x = np.random.default_rng(7).standard_normal((B, S, D)).astype(
        np.float32)
    jdt = jnp.float32 if compute_dtype == "float32" else jnp.bfloat16
    jx = jnp.asarray(x, jdt)
    tx = torch.from_numpy(np.asarray(jx, np.float32)).to(
        getattr(torch, compute_dtype))
    return jx, tx


def _state(B, D, H, seed):
    """A carried state as a decode would hold it: wkv float32, the shift
    float32 holding bf16 values."""
    rng = np.random.default_rng(seed)
    hd = D // H
    wkv = (rng.standard_normal((B, H, hd, hd)) * 0.5).astype(np.float32)
    shift = np.asarray(jnp.asarray(rng.standard_normal((B, 1, D)),
                                   jnp.bfloat16), np.float32)
    return ({"wkv": jnp.asarray(wkv), "shift": jnp.asarray(shift)},
            {"wkv": torch.from_numpy(wkv), "shift": torch.from_numpy(shift)})


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_apply_matches_jax(compute_dtype, with_state):
    B, S, D, H = 2, 12, 64, 4
    jp = jssm.rwkv6_init(jax.random.PRNGKey(3), D, H)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jx, tx = _layer_input(compute_dtype, B, S, D)
    jst, tst = _state(B, D, H, 8) if with_state else (None, None)
    jout, jnew = jssm.rwkv6_apply(jp, jx, n_heads=H, state=jst)
    tout, tnew = tssm.rwkv6_apply(tp, tx, n_heads=H, state=tst)
    assert tout.dtype == tx.dtype and tout.shape == tx.shape
    tol = F32 if compute_dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)
    if not with_state:
        assert tnew is None and jnew is None
        return
    assert tnew["wkv"].dtype == torch.float32
    np.testing.assert_allclose(tnew["wkv"].numpy(), np.asarray(jnew["wkv"]),
                               atol=1e-5 * float(np.abs(jnew["wkv"]).max()),
                               rtol=1e-5)
    np.testing.assert_array_equal(tnew["shift"].numpy(),
                                  np.asarray(jnew["shift"]))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_cmix_apply_matches_jax(compute_dtype, with_state):
    B, S, D, F = 2, 12, 64, 128
    jp = jssm.rwkv6_cmix_init(jax.random.PRNGKey(4), D, F)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    jx, tx = _layer_input(compute_dtype, B, S, D)
    jlast = tlast = None
    if with_state:
        _, tst = _state(B, D, 4, 9)
        tlast = tst["shift"]
        jlast = jnp.asarray(tlast.numpy())
    jout, jnew = jssm.rwkv6_cmix_apply(jp, jx, jlast)
    tout, tnew = tssm.rwkv6_cmix_apply(tp, tx, tlast)
    tol = F32 if compute_dtype == "float32" else BF16
    np.testing.assert_allclose(_f32(tout), _f32(jout), **tol)
    if with_state:
        assert tnew.dtype == torch.float32
        np.testing.assert_array_equal(tnew.numpy(), np.asarray(jnew))
    else:
        assert tnew is None and jnew is None


def test_rwkv6_layer_calls_k6_once_through_its_module(monkeypatch):
    """The recurrence is one call of K6 through ``k6.rwkv_scan`` (where a
    recorder stands in on the card), on ``[B, H, S, hd]`` r, k and v in the
    compute dtype (here bf16) and a float32 w."""
    calls = []

    def recorder(r, k, v, w, u, state0=None):
        calls.append((r.dtype, k.dtype, v.dtype, w.dtype, tuple(r.shape),
                      state0 is not None))
        return tref.rwkv_scan(r, k, v, w, u, state0)

    monkeypatch.setattr(k6, "rwkv_scan", recorder)
    tp = tssm.rwkv6_init(torch.Generator().manual_seed(0), 64, 4)
    _, tx = _layer_input("bfloat16", 2, 5, 64)
    tssm.rwkv6_apply(tp, tx, n_heads=4,
                     state=tssm.rwkv6_state_init(2, 64, 4))
    bf = torch.bfloat16
    assert calls == [(bf, bf, bf, torch.float32, (2, 4, 5, 16), True)]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv6_apply_hands_k6_its_activations_as_they_come(
        monkeypatch, compute_dtype, with_state):
    """K6 gets r, k and v in the compute dtype and w in float32 as views of
    the layer's ``[B, S, D]`` activations (no float32 copy of r, k, v), and
    its ``out`` goes on as it comes (no cast): the layer's output and state
    are bit for bit those of the layer that cast r, k and v to float32
    before K6 and cast ``out`` back after it."""
    seen = []

    def as_given(r, k, v, w, u, state0=None):
        seen.append([(x.dtype, x.is_contiguous(), x._base is not None)
                     for x in (r, k, v, w)])
        out, state = tref.rwkv_scan(r, k, v, w, u, state0)
        assert out.dtype == r.dtype
        return out, state

    def cast_first(r, k, v, w, u, state0=None):
        out, state = tref.rwkv_scan(*(x.float() for x in (r, k, v, w)), u,
                                    state0)
        return out.to(r.dtype), state

    B, S, D, H = 2, 7, 64, 4
    tp = tssm.rwkv6_init(torch.Generator().manual_seed(5), D, H)
    _, tx = _layer_input(compute_dtype, B, S, D)
    results = []
    for stand_in in (as_given, cast_first):
        monkeypatch.setattr(k6, "rwkv_scan", stand_in)
        state = None
        if with_state:
            state = {key: t.clone()
                     for key, t in _state(B, D, H, 6)[1].items()}
        results.append(tssm.rwkv6_apply(tp, tx, n_heads=H, state=state))
    dt = getattr(torch, compute_dtype)
    assert seen == [[(dt, False, True)] * 3 + [(torch.float32, False, True)]]
    (out, new), (want, want_new) = results
    assert out.dtype == dt and torch.equal(out, want)
    if with_state:
        for key in ("wkv", "shift"):
            assert torch.equal(new[key], want_new[key])


# --------------------------------------------------------------------- #
# Config, conversion, the serve CLI                                      #
# --------------------------------------------------------------------- #
def test_rwkv_config_is_published_and_counts_its_parameters():
    cfg = get_config("rwkv6-1.6b")
    assert (cfg.family, cfg.attn, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.hd, cfg.d_ff, cfg.vocab) == ("ssm", "none", 24, 2048, 32, 64,
                                             7168, 65536)
    assert cfg.param_count() == 1_482_686_464
    smoke = get_smoke("rwkv6-1.6b")
    params = tm.init_params(smoke, 0, "cpu")
    assert len(params["blocks"]) == smoke.n_layers
    assert set(params["blocks"][0]) == {"ln1", "tmix", "ln2", "cmix"}
    assert params["blocks"][0]["tmix"]["u"].shape == (smoke.n_heads,
                                                      smoke.hd)
    cache = tm.init_cache(smoke, 3, 1000, "cpu")["blocks"][0]
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        "wkv": (3, smoke.n_heads, smoke.hd, smoke.hd),
        "shift": (3, 1, smoke.d_model), "cshift": (3, 1, smoke.d_model)}
    assert all(t.dtype == torch.float32 for t in cache.values())


def test_params_from_jax_carries_the_ssm_tree():
    jcfg = jget_smoke("rwkv6-1.6b")
    tcfg = get_smoke("rwkv6-1.6b")
    jp = jm.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert len(tp["blocks"]) == tcfg.n_layers
    for name in ("wr", "w0", "u", "ln_x", "w_b"):
        np.testing.assert_array_equal(
            tp["blocks"][1]["tmix"][name].numpy(),
            np.asarray(jp["blocks"]["tmix"][name][1]))
    np.testing.assert_array_equal(tp["blocks"][0]["cmix"]["wv"].numpy(),
                                  np.asarray(jp["blocks"]["cmix"]["wv"][0]))
    np.testing.assert_array_equal(tp["blocks"][1]["ln2"].numpy(),
                                  np.asarray(jp["blocks"]["ln2"][1]))


def test_serve_cli_serves_rwkv_on_the_cpu(capsys):
    done = tlaunch.main(["--arch", "rwkv6-1.6b", "--smoke", "--requests",
                         "5", "--max-new", "3", "--device", "cpu"])
    assert len(done) == 5 and all(len(r.out_tokens) == 3 for r in done)
    assert all(0 <= t < 256 for r in done for t in r.out_tokens)
    assert "completed 5 requests" in capsys.readouterr().out
