"""The arithmetic of K5's sliding window at (dk, dv) = (64, 64).

``csrc/flash_attention.cu`` runs a causal call with a window on its own
forms (``flash_window``, ``dq_window`` and ``flash_bwd_dkv_wgmma``'s window
instantiation).  The forward keeps the overlap form's arithmetic (p =
2^fma(s, c, -(m c)) on raw scores s = q . k, c = scale log2(e), P V from
P's bf16 hi (truncated) and lo parts) on 64-key tiles, each unit of 64
query rows of one head walking its key tiles up from its first row's
first key to its diagonal tile.  Only the diagonal tile and those holding
a row's window edge are masked (key kj of row r visible when 0 <= r - kj
< window), once, before the row's extreme (no second pass after the
exponential): a masked key gets p = 2^((m_init - m) c) = 0 once the row
has seen a visible key, and before that (a unit's lower rows on its first
tile) weighs 1 until the row's first visible key makes corr = 0; a second
pass only where |c| < 2^-20, as at scale 0.  Every exponential is ex2.
The backward takes P = 2^fma(s, c, -(lse log2(e))), masked keys 0.

No kernel runs here: a float32 emulation of that arithmetic (CPU tensors,
each unit's tiles in the kernel's order) is held to ``chip_smoke.py``'s
``check_flash`` / ``check_lse`` / ``check_flash_bwd`` bounds against the
plain version with the window, and to the same forward bound against the
JAX reference's windowed mask (``repro.models.attention.
flash_attention_ref``, ``:95-96``) on the same numpy inputs: ragged S,
windows 1, 63, 64, 65 and 1,023, GQA (rep 5, 2 and 1), scale 64^-0.5,
four times it and 0.  The
planted faults, the window one key wider and an edge row left unmasked,
land beyond the bounds, forward and backward, and so does one masking
pass at scale 0.
"""
import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
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
    """float32 fma: the product exact in float64, the sum rounded once."""
    return _f32(a.double() * b.double() + c.double())


def _first(t, W):
    return max(0, 64 * t - W + 1) // 64


def _outside(rows, keys, W, unmasked_row=False):
    """[rows, keys] bool: key outside the row's window (not 0 <= r - kj <
    W).  ``unmasked_row``: the fault "an edge row left unmasked", the
    keys below the window of each unit's last row counted."""
    d = rows[:, None] - keys[None, :]
    out = (d < 0) | (d >= W)
    if unmasked_row:
        out &= ~(((rows % 64) == 63)[:, None] & (d >= W))
    return out


def _split(x):
    """hi x truncated to bf16, lo bf16(x - hi)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).float()


def _window_fwd(q, k, v, scale, W, unmasked_row=False, second_pass=None):
    """flash_window's arithmetic in float32: (out, lse), each unit (row
    tile t of head hh; its arithmetic does not depend on the block it shares
    with others) on its key tiles in order.  ``second_pass`` (default:
    where |c| < 2^-20) masks p again after the exponential."""
    B, H, S, _ = q.shape
    KV = k.shape[1]
    rep = H // KV
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    neg = bool(c < 0)
    if second_pass is None:
        second_pass = abs(float(c)) < 2.0**-20
    m_init = -tref.NEG_INF if neg else tref.NEG_INF
    out = torch.zeros((B, H, S, v.shape[-1]))
    lse = torch.zeros((B, H, S))
    qf, kf, vf = q.float(), k.float(), v.float()
    for t in range(-(-S // 64)):
        for hh in range(rep):
            r0, r1 = 64 * t, min(64 * t + 64, S)
            rows = torch.arange(r0, r1)
            m = torch.full((B, KV, r1 - r0), m_init)
            l = torch.zeros((B, KV, r1 - r0))
            acc = torch.zeros((B, KV, r1 - r0, v.shape[-1]))
            for j in range(_first(t, W), t + 1):
                k0, k1 = 64 * j, min(64 * j + 64, S)
                s = torch.einsum("bgsd,bgtd->bgst",
                                 qf[:, hh::rep][:, :, r0:r1],
                                 kf[:, :, k0:k1])
                edge = j == t or 64 * j <= 64 * t + 63 - W
                masked = _outside(rows, torch.arange(k0, k1), W,
                                  unmasked_row and j != t)
                if edge:
                    s = torch.where(masked, torch.tensor(m_init), s)
                ext = s.amin(-1) if neg else s.amax(-1)
                mx = torch.minimum(m, ext) if neg else torch.maximum(m, ext)
                mc = _f32(mx * c)
                x = _fma(s, c.expand_as(s), -mc[..., None])
                p = torch.exp2(x)
                if edge and second_pass:
                    p = torch.where(masked, torch.zeros(()), p)
                corr = torch.exp2(_f32(m * c) - mc)
                l = l * corr + p.sum(-1)
                m = mx
                ph, pl = _split(p)
                acc = (acc * corr[..., None]
                       + torch.einsum("bgst,bgtd->bgsd", ph, vf[:, :, k0:k1])
                       + torch.einsum("bgst,bgtd->bgsd", pl, vf[:, :, k0:k1]))
            denom = torch.clamp(l, min=1e-20)
            out[:, hh::rep, r0:r1] = acc / denom[..., None]
            lse[:, hh::rep, r0:r1] = m * scale + torch.log(denom)
    return out, lse


def _window_bwd(q, k, v, out, dout, lse, scale, W, unmasked_row=False):
    """The window's backward arithmetic in float32 (dq_window and the
    window's dkv): dO, P and dS split into bf16 hi + lo, each product
    summed in float32, P = 2^fma(s, c, -(lse log2(e))), keys outside the
    window 0."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    rep = H // KV
    qf = q.float()
    kf = k.float().repeat_interleave(rep, 1)
    vf = v.float().repeat_interleave(rep, 1)
    do = dout.float()
    d = (do * out).sum(-1)
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    lse2 = _f32(lse * torch.tensor(LOG2E, dtype=torch.float32))
    p = torch.exp2(_fma(s, c.expand_as(s), -lse2[..., None]))
    idx = torch.arange(S)
    p = torch.where(_outside(idx, idx, W, unmasked_row), torch.zeros(()), p)

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
    dk = dk.reshape(B, KV, rep, S, hd).sum(2)
    dv = dv.reshape(B, KV, rep, S, hd).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _case(seed, B, H, KV, S):
    """bf16 q, k, v at (64, 64) from numpy."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (B, h, S, 64)).astype(np.float32)).to(torch.bfloat16)
        for h in (H, KV, KV))


#: (B, H, KV, S, window).
CASES = [(1, 5, 1, 130, 1), (1, 5, 1, 97, 63), (1, 4, 2, 200, 64),
         (1, 5, 1, 150, 65), (1, 2, 1, 1100, 1023), (2, 10, 2, 300, 65),
         (1, 3, 3, 190, 70)]


@pytest.mark.parametrize("B,H,KV,S,W,mul",
                         [c + (1,) for c in CASES]
                         + [c + (4,) for c in CASES[1:5:3]])
def test_window_forward_within_check_flash(B, H, KV, S, W, mul):
    """At scale 64^-0.5 and (rows' weights further apart, more of a
    masked tile's p underflowing) four times it."""
    cs = _smoke()
    q, k, v = _case(300 + S + W, B, H, KV, S)
    scale = mul * 64 ** -0.5
    out, lse = _window_fwd(q, k, v, scale, W)
    what = f"window emulation S={S} W={W} scale={scale:.4g}"
    err = cs.check_flash(torch, what, out, q, k, v, True, scale, W)
    cs.check_lse(torch, what, lse, q, k, v, True, scale, W)
    assert err > 0


@pytest.mark.parametrize("B,H,KV,S,W", CASES[:4] + CASES[5:6])
def test_window_forward_against_jax(B, H, KV, S, W):
    """The same bound against JAX's windowed mask on the bf16-rounded
    inputs in float32."""
    q, k, v = _case(400 + S + W, B, H, KV, S)
    scale = 64 ** -0.5
    out, _ = _window_fwd(q, k, v, scale, W)
    want = np.asarray(jattn.flash_attention_ref(
        *(jnp.asarray(t.float().numpy().transpose(0, 2, 1, 3))
          for t in (q, k, v)), causal=True, window=W, scale=scale))
    tol = 3e-5 + 2 * S * 2.0**-24 * float(v.float().abs().max())
    assert np.abs(out.numpy() - want.transpose(0, 2, 1, 3)).max() <= tol


def test_window_forward_at_scale_zero():
    """|c| < 2^-20: masked keys masked again after the exponential, so
    every visible key weighs alike and a masked one not at all."""
    cs = _smoke()
    q, k, v = _case(500, 1, 5, 1, 150)
    out, _ = _window_fwd(q, k, v, 0.0, 65)
    cs.check_flash(torch, "window emulation scale 0", out, q, k, v, True,
                   0.0, 65)


@pytest.mark.parametrize("B,H,KV,S,W", [(1, 5, 1, 130, 64),
                                        (1, 4, 2, 97, 63),
                                        (1, 2, 1, 1100, 1023),
                                        (2, 10, 2, 300, 65),
                                        (1, 3, 3, 190, 70)])
def test_window_backward_within_check_flash_bwd(B, H, KV, S, W):
    """From the window forward's out and lse, as the training path feeds
    the backward."""
    cs = _smoke()
    q, k, v = _case(600 + S, B, H, KV, S)
    scale = 64 ** -0.5
    out, lse = _window_fwd(q, k, v, scale, W)
    dout = torch.from_numpy(np.random.default_rng(601 + S).standard_normal(
        (B, H, S, 64)).astype(np.float32))
    got = _window_bwd(q, k, v, out, dout, lse, scale, W)
    err = cs.check_flash_bwd(torch, f"window backward emulation W={W}", got,
                             q, k, v, out, dout, True, scale, "wgmma", W)
    assert err > 0


@pytest.mark.parametrize("fault", ["window + 1", "edge row unmasked"])
@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_planted_window_faults_exceed_the_bounds(fault, direction):
    cs = _smoke()
    B, H, KV, S, W = 1, 5, 1, 300, 63
    q, k, v = _case(700, B, H, KV, S)
    scale = 64 ** -0.5
    wide = W + 1 if fault == "window + 1" else W
    unmasked = fault == "edge row unmasked"
    out, lse = _window_fwd(q, k, v, scale, W)
    with pytest.raises(cs.SmokeFailure, match="beyond"):
        if direction == "forward":
            bad, _ = _window_fwd(q, k, v, scale, wide, unmasked_row=unmasked)
            cs.check_flash(torch, fault, bad, q, k, v, True, scale, W)
        else:
            dout = torch.from_numpy(np.random.default_rng(701).standard_normal(
                (B, H, S, 64)).astype(np.float32))
            bad = _window_bwd(q, k, v, out, dout, lse, scale, wide, unmasked)
            cs.check_flash_bwd(torch, fault, bad, q, k, v, out, dout, True,
                               scale, "wgmma", W)


def test_one_masking_pass_needs_a_scale():
    """At scale 0 (c = 0) a masked score's p = 2^0 = 1 whatever the row's
    extreme: with one masking pass the output lands beyond check_flash,
    which is why |c| < 2^-20 takes the second."""
    cs = _smoke()
    q, k, v = _case(800, 1, 5, 1, 150)
    bad, _ = _window_fwd(q, k, v, 0.0, 65, second_pass=False)
    with pytest.raises(cs.SmokeFailure, match="beyond"):
        cs.check_flash(torch, "scale 0, one pass", bad, q, k, v, True, 0.0,
                       65)
