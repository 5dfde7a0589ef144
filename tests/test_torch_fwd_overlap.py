"""The arithmetic of K5's forward at (dk, dv) = (64, 64), the overlap form.

``csrc/flash_attention.cu`` runs Whisper's (64, 64) calls on 64-key tiles
with the scale folded into the exponent: each row keeps the running
extreme m of its raw scores s = q . k (the max for scale >= 0, the min
for scale < 0, so that m scale is the largest scaled score), each score
becomes p = 2^fma(s, c, -(m c)) with c = scale log2(e), masked keys never
move m and get p = 0, the accumulator is rescaled by 2^(m_old c - m_new c)
and summed from P's bf16 hi and lo parts (hi p truncated to bf16, lo the
rest rounded), and the log-sum-exp is
m scale + log(max(l, 1e-20)).  No kernel runs here: a float32 emulation
of that arithmetic (CPU tensors) is held to ``chip_smoke.py``'s
``check_flash`` and ``check_lse`` bounds against the plain version, and to
the same bound against the JAX reference on the same numpy inputs, at
ragged S and T, causal and full, with GQA; the two forward faults the
smoke plants (the causal mask off, q scaled twice) land beyond the bound.
"""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref as tref

ROOT = Path(__file__).resolve().parents[1]
LOG2E = 1.4426950408889634


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


def _f32(x):
    return x.to(torch.float32)


def _fma(a, b, c):
    """float32 fma: the product of two float32 values is exact in float64,
    the sum rounded once to float32 (twice where float64 rounds first,
    within a float32 unit)."""
    return _f32(a.double() * b.double() + c.double())


def _split(x):
    """x = hi + lo + r: hi x truncated to bf16 (its top 16 bits), lo
    bf16(x - hi), |r| <= 2^-16 |x|."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).float()


def _overlap_fwd(q, k, v, causal, scale, mask=True):
    """The overlap form's arithmetic in float32 on 64-key tiles: (out,
    lse).  ``mask=False`` is the smoke's "causal mask off"."""
    B, H, S, _ = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    neg = bool(c < 0)
    m_init = -tref.NEG_INF if neg else tref.NEG_INF
    m = torch.full((B, H, S), m_init, dtype=torch.float32)
    l = torch.zeros((B, H, S), dtype=torch.float32)
    acc = torch.zeros((B, H, S, v.shape[-1]), dtype=torch.float32)
    rows = torch.arange(S)[:, None]
    n = (T + 63) // 64 if not causal else (S + 63) // 64
    for j in range(n):
        k0 = 64 * j
        keys = torch.arange(k0, k0 + 64)[None, :]
        s = torch.einsum("bhsd,bhtd->bhst", qf, kf[:, :, k0:k0 + 64])
        s = torch.nn.functional.pad(s, (0, 64 - s.shape[-1]))
        masked = (keys >= T) | ((keys > rows) if causal and mask else False)
        s = torch.where(masked, torch.tensor(m_init), s)
        ext = s.amin(-1) if neg else s.amax(-1)
        mx = torch.minimum(m, ext) if neg else torch.maximum(m, ext)
        mc = _f32(mx * c)
        p = torch.exp2(_fma(s, c.expand_as(s), -mc[..., None]))
        p = torch.where(masked, torch.zeros(()), p)
        corr = torch.exp2(_f32(m * c) - mc)
        l = l * corr + p.sum(-1)
        m = mx
        acc = acc * corr[..., None]
        ph, pl = _split(p)
        vt = torch.nn.functional.pad(vf[:, :, k0:k0 + 64],
                                     (0, 0, 0, 64 - min(64, T - k0)))
        acc = (acc + torch.einsum("bhst,bhtd->bhsd", ph, vt)
               + torch.einsum("bhst,bhtd->bhsd", pl, vt))
    denom = torch.clamp(l, min=1e-20)
    return acc / denom[..., None], m * scale + torch.log(denom)


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _case(seed, B, H, KV, S, T):
    """bf16 q, k, v at (64, 64) from numpy."""
    return tuple(torch.from_numpy(_normal(seed + i, (B, h, n, 64))).to(
        torch.bfloat16) for i, (h, n) in enumerate(((H, S), (KV, T),
                                                    (KV, T))))


CASES = [(1, 2, 2, 1, 150, False), (1, 4, 2, 63, 200, False),
         (2, 4, 4, 130, 130, True), (1, 6, 2, 97, 97, True),
         (1, 6, 3, 200, 77, False), (1, 2, 1, 64, 64, True)]


@pytest.mark.parametrize("B,H,KV,S,T,causal", CASES)
def test_overlap_arithmetic_within_check_flash(B, H, KV, S, T, causal):
    cs = _smoke()
    q, k, v = _case(70 + S, B, H, KV, S, T)
    scale = 64 ** -0.5
    out, lse = _overlap_fwd(q, k, v, causal, scale)
    err = cs.check_flash(torch, "overlap emulation", out, q, k, v, causal,
                         scale)
    cs.check_lse(torch, "overlap emulation", lse, q, k, v, causal, scale)
    assert err > 0


@pytest.mark.parametrize("B,H,KV,S,T,causal", CASES[:4])
def test_overlap_arithmetic_against_jax(B, H, KV, S, T, causal):
    """The same bound against ``repro.kernels.ref.flash_attention`` on the
    bf16-rounded inputs in float32 (JAX's causal mask is bottom-right, the
    same as the port's at S == T)."""
    q, k, v = _case(90 + S, B, H, KV, S, T)
    scale = 64 ** -0.5
    out, _ = _overlap_fwd(q, k, v, causal, scale)
    rep = H // KV
    want = np.asarray(jref.flash_attention(
        jnp.asarray(q.float().numpy()),
        jnp.asarray(k.float().repeat_interleave(rep, 1).numpy()),
        jnp.asarray(v.float().repeat_interleave(rep, 1).numpy()),
        causal=causal, scale=scale))
    tol = 3e-5 + 2 * T * 2.0**-24 * float(v.float().abs().max())
    assert np.abs(out.numpy() - want).max() <= tol


@pytest.mark.parametrize("scale", [-0.125, 0.0, 1.0])
def test_overlap_arithmetic_at_any_scale(scale):
    """A negative scale turns m into the row's min of raw scores; scale 0
    gives every visible key the same weight and masked keys none."""
    cs = _smoke()
    q, k, v = _case(110, 1, 4, 2, 70, 70)
    out, lse = _overlap_fwd(q, k, v, True, scale)
    cs.check_flash(torch, f"overlap emulation scale {scale}", out, q, k, v,
                   True, scale)
    # check_lse's bound with |scale| (the smoke calls it at scale > 0 only).
    _, want = tref.flash_attention(q, k, v, causal=True, scale=scale,
                                   return_lse=True)
    smax = float(torch.einsum("bhsd,bhtd->bhst", q.float().abs(),
                              k.float().abs().repeat_interleave(2, 1))
                 .amax()) * abs(scale)
    tol = ((2 * 64 * smax + 2 * 70) * 2.0**-24
           + (2 + 2.35 * smax) * 2.0**-23 + 2.0**-23 * want.abs())
    assert bool(((lse - want).abs() <= tol).all())


@pytest.mark.parametrize("fault", ["mask off", "q scaled twice"])
def test_planted_forward_faults_exceed_check_flash(fault):
    cs = _smoke()
    q, k, v = _case(130, 1, 4, 2, 130, 130)
    scale = 64 ** -0.5
    if fault == "mask off":
        out, _ = _overlap_fwd(q, k, v, True, scale, mask=False)
    else:
        out, _ = _overlap_fwd(q, k, v, True, scale * 64 ** -0.5)
    with pytest.raises(cs.SmokeFailure, match="beyond"):
        cs.check_flash(torch, fault, out, q, k, v, True, scale)


def test_build_check_names_spilled_kernels():
    """``chip_smoke.spilled`` reads ptxas's ``-v`` lines: a (64, 64) wgmma
    kernel with spill stores or loads is named, one without and the other
    widths' are not."""
    cs = _smoke()
    text = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_Z18flash_bwd_dq_wgmmaILi64ELi64EEvPf' for 'sm_90a'",
        "ptxas info    : Function properties for "
        "_Z18flash_bwd_dq_wgmmaILi64ELi64EEvPf",
        "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_Z11flash_wgmmaILi64ELi64EEvPf' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function "
        "'_Z19flash_bwd_dkv_wgmmaILi96ELi64EEvPf' for 'sm_90a'",
        "    0 bytes stack frame, 296 bytes spill stores, 296 bytes spill "
        "loads"])
    got = cs.spilled(text, cs.K5_WGMMA_KERNELS, "Li64ELi64E")
    assert [fn for fn, _ in got] == ["_Z18flash_bwd_dq_wgmmaILi64ELi64EEvPf"]
    assert cs.spilled(text, cs.K5_WGMMA_KERNELS, "Li96ELi64E")[0][0] == (
        "_Z19flash_bwd_dkv_wgmmaILi96ELi64EEvPf")


def _bwd64(q, k, v, out, dout, lse, causal, scale, drop_d=False, mask=True):
    """The (64, 64) wgmma backward's arithmetic in float32: as
    ``tests/test_torch_bwd_forms.py::_wgmma_bwd`` (dO, P and dS split into
    bf16 hi + lo, each product summed in float32), but P = 2^fma(s, c,
    -(lse log2(e))) with c = scale log2(e) and masked keys 0.  ``drop_d``
    and ``mask=False`` are the smoke's planted faults."""
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    do = dout.float()
    d = torch.zeros_like(lse) if drop_d else (do * out).sum(-1)
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = _f32(lse * torch.tensor(LOG2E, dtype=torch.float32))
    p = torch.exp2(_fma(s, c.expand_as(s), -lse2[..., None]))
    if causal and mask:
        p = torch.where(torch.ones(S, T, dtype=torch.bool).tril(), p,
                        torch.zeros(()))

    def split(x):
        hi = x.to(torch.bfloat16).float()
        return hi, (x - hi).to(torch.bfloat16).float()

    dh, dl = split(do)
    dp = (torch.einsum("bhsd,bhtd->bhst", dh, vf)
          + torch.einsum("bhsd,bhtd->bhst", dl, vf))
    ds = p * (dp - d[..., None])
    ph, pl = split(p)
    sh, sl = split(ds)
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


def _bwd_case(seed, B, H, KV, S, T, causal):
    q, k, v = _case(seed, B, H, KV, S, T)
    scale = 64 ** -0.5
    out, lse = _overlap_fwd(q, k, v, causal, scale)
    dout = torch.from_numpy(_normal(seed + 9, (B, H, S, 64)))
    return q, k, v, out, lse, dout, scale


@pytest.mark.parametrize("B,H,KV,S,T,causal", [(1, 2, 2, 63, 150, False),
                                                (1, 6, 2, 130, 130, True),
                                                (2, 4, 4, 97, 97, True)])
def test_bwd64_arithmetic_within_check_flash_bwd(B, H, KV, S, T, causal):
    """From the overlap form's out and lse, as the training path feeds the
    backward."""
    cs = _smoke()
    q, k, v, out, lse, dout, scale = _bwd_case(150 + S, B, H, KV, S, T,
                                               causal)
    got = _bwd64(q, k, v, out, dout, lse, causal, scale)
    err = cs.check_flash_bwd(torch, "(64, 64) backward emulation", got, q, k,
                             v, out, dout, causal, scale, route="wgmma")
    assert err > 0


@pytest.mark.parametrize("fault", ["drop_d", "mask_off"])
def test_planted_bwd64_faults_exceed_check_flash_bwd(fault):
    cs = _smoke()
    q, k, v, out, lse, dout, scale = _bwd_case(170, 1, 4, 2, 130, 130, True)
    got = _bwd64(q, k, v, out, dout, lse, True, scale,
                 drop_d=fault == "drop_d", mask=fault != "mask_off")
    with pytest.raises(cs.SmokeFailure, match="beyond the stated bound"):
        cs.check_flash_bwd(torch, fault, got, q, k, v, out, dout, True,
                           scale, route="wgmma")
