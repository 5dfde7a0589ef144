"""Plain PyTorch versions of the hand-written kernels.

The counterpart of ``repro.kernels.ref`` for the kernels ported so far.
:mod:`repro_torch.kernels.partition` runs these for CPU tensors (the tests)
and ``chip_smoke.py`` holds each CUDA kernel against them on the card.
They repeat the kernels' arithmetic and are no yardstick of speed: the
row gather materializes ``[N, W]``, the grouped matmul upcasts its inputs
to float32, attention materializes a ``[S, block]`` score tile per
head, and the RWKV6 and Mamba scans walk T in Python with a few ops a
step.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.ops import ld_thresholds, within_dest_ranks


def partition(keys: torch.Tensor, counters: torch.Tensor,
              cdf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Routing-table partition: (dest [N] int32, histogram [W] int32).

    ``dest = #{w : u(counter) >= cdf[key, w]}`` clipped to ``W - 1``; keys
    outside ``[0, K)`` are clamped into range, as the kernel does.
    """
    num_keys, num_workers = cdf.shape
    u = ld_thresholds(counters)
    rows = cdf[keys.to(torch.int64).clamp(0, num_keys - 1)]
    dest = (u[:, None] >= rows).sum(dim=1).clamp_(max=num_workers - 1)
    hist = torch.bincount(dest, minlength=num_workers)
    return dest.to(torch.int32), hist.to(torch.int32)


def partition_scatter(keys: torch.Tensor, counters: torch.Tensor,
                      cdf: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused exchange: (dest [N], within-destination rank [N], hist [W]).

    ``rank[i] = #{j < i : dest[j] == dest[i]}`` from a stable sort, so
    ``exclusive_cumsum(hist)[dest] + rank`` groups the chunk by
    destination in arrival order.
    """
    dest, hist = partition(keys, counters, cdf)
    return dest, within_dest_ranks(dest, cdf.shape[1]), hist


def partition_scatter_fold(keys: torch.Tensor,
                           counters: Optional[torch.Tensor],
                           vals: torch.Tensor, valid: torch.Tensor,
                           cdf: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    """Fused exchange + per-key fold over the live lanes of a masked chunk:
    (dest [N], rank [N], hist [W], fold_counts [K] int32, fold_sums [K]
    float32).

    Wide columns are cast first: int64 keys and counters wrap to int32,
    float64 vals round to float32, and ``counters=None`` is all zero.
    ``dest`` by :func:`partition` for every lane; ``rank`` and ``hist``
    count live lanes only (dead lanes get rank 0); the folds count and sum
    (in float32, with ``index_add_``) the live lanes whose key lies in
    ``[0, K)``.
    """
    keys = keys.to(torch.int32)
    counters = (torch.zeros_like(keys) if counters is None
                else counters.to(torch.int32))
    vals = vals.to(torch.float32)
    num_keys, num_workers = cdf.shape
    dest, _ = partition(keys, counters, cdf)
    live = valid.to(torch.bool)
    lanes = live.to(torch.int32)
    hist = torch.zeros(num_workers, dtype=torch.int32, device=keys.device)
    hist.index_add_(0, dest.to(torch.int64), lanes)
    rank = within_dest_ranks(dest, num_workers, valid=lanes) * lanes
    k64 = keys.to(torch.int64)
    inr = live & (k64 >= 0) & (k64 < num_keys)
    slot = torch.where(inr, k64, 0)
    cnt = torch.zeros(num_keys, dtype=torch.int32, device=keys.device)
    cnt.index_add_(0, slot, inr.to(torch.int32))
    sums = torch.zeros(num_keys, dtype=torch.float32, device=keys.device)
    sums.index_add_(0, slot, torch.where(inr, vals, 0.0))
    return dest, rank, hist, cnt, sums


def match_expand(wk: torch.Tensor, wv: torch.Tensor, wmask: torch.Tensor,
                 mcounts: torch.Tensor, emit_width: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-join probe expansion of a popped ``[W, B]`` window.

    Not the plain version of a kernel: the reference's ``match_expand`` is
    jitted jnp code, not Pallas, and runs as these torch ops on the card
    too.  ``mcounts`` is the ``[W, K]`` per-(worker, key) build-match table
    (``wk`` must hold keys in ``[0, K)`` in every lane, dead ones too).
    Each live lane ``(k, v)`` of worker ``w`` is emitted ``mcounts[w, k]``
    times into a padded ``[W, emit_width]`` block, lanes in stream order and
    a lane's copies contiguous, as ``np.repeat`` per worker: output slot
    ``j`` takes the first lane whose inclusive fanout cumsum exceeds ``j``
    (a row-wise binary search), and slots past the row's total are dead.
    ``emit_width`` must bound the row totals.  Returns ``(out_keys,
    out_vals, keep)``, each ``[W, emit_width]``.
    """
    W, B = wk.shape
    m = torch.where(wmask, mcounts.gather(1, wk), 0)
    csum = torch.cumsum(m, dim=1)                      # [W, B] inclusive
    iot = torch.arange(emit_width, dtype=csum.dtype, device=wk.device)
    src = torch.searchsorted(csum, iot.expand(W, emit_width).contiguous(),
                             right=True).clamp_(max=B - 1)
    keep = iot[None, :] < csum[:, -1:]
    return wk.gather(1, src), wv.gather(1, src), keep


def segment_matmul(x: torch.Tensor, w: torch.Tensor,
                   rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped expert matmul ``x [E, C, D] @ w [E, D, F] -> [E, C, F]``,
    accumulated in float32 and rounded once to ``x.dtype``.  With ``rows``
    (``[E]``), rows ``r >= rows[e]`` of ``out[e]`` are zero, whatever x
    holds there."""
    out = torch.bmm(x.float(), w.float())
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < rows.to(x.device, torch.int64)[:, None])
        out = torch.where(live[..., None], out, 0.0)
    return out.to(x.dtype)


def segment_matmul_backward(dout: torch.Tensor, x: torch.Tensor,
                            w: torch.Tensor,
                            rows: Optional[torch.Tensor] = None):
    """(dx, dw) of :func:`segment_matmul` at ``dout``, from the untransposed
    tensors: ``dx = dout w^T`` with its rows past ``rows`` zero and
    ``dw = x^T dout`` over the live rows only (x and dout zeroed past
    ``rows`` first: x may hold NaN there), each accumulated in float32 and
    rounded once to x's dtype."""
    xz, dz = x, dout
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :, None]
                < rows.to(x.device, torch.int64)[:, None, None])
        xz = torch.where(live, x, x.new_zeros(()))
        dz = torch.where(live, dout, dout.new_zeros(()))
    return (segment_matmul(dout, w.transpose(1, 2), rows),
            segment_matmul(xz.transpose(1, 2), dz))


#: The mask value of the reference's attention (not -inf).
NEG_INF = -2.0 ** 30


def _window_ok(window: Optional[int], causal: bool, S: int, T: int) -> None:
    if window is not None and (not causal or S != T or window < 1):
        raise ValueError(f"a window needs causal attention with S == T and "
                         f"a width of at least 1, got window={window}, "
                         f"causal={causal}, S={S}, T={T}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    block: int = 1024, return_lse: bool = False,
                    window: Optional[int] = None):
    """Online-softmax attention over KV blocks, float32 ``[B, H, S, dv]``;
    with ``return_lse``, ``(out, lse)``, lse the float32 ``[B, H, S]``
    log-sum-exp of each row's scaled (masked) scores, ``m + log(max(l,
    1e-20))`` from the final running max and sum, as the card's kernel
    writes it.

    q ``[B, H, S, hd]``; k ``[B, KV, T, hd]`` and v ``[B, KV, T, dv]`` with
    ``H`` a multiple of ``KV`` (query head ``h`` reads KV head
    ``h // (H // KV)``).  q is cast to float32 and then scaled (``scale``
    defaults to ``hd ** -0.5``); when causal, query ``i`` sees keys
    ``j <= i``, and with a sliding ``window`` (causal, S == T) only keys
    ``j > i - window``, the mask of ``repro.models.attention`` (``:95-96``).
    Masked scores take :data:`NEG_INF`; the output is
    ``acc / max(l, 1e-20)``, as in ``repro.models.attention`` and the
    Pallas kernel.  Blocks wholly above the diagonal change nothing and
    are skipped.
    """
    B, H, S, hd = q.shape
    KV, T, dv = k.shape[1], k.shape[2], v.shape[-1]
    _window_ok(window, causal, S, T)
    rep = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    q_pos = torch.arange(S, device=q.device)
    acc = torch.zeros((B, H, S, dv), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=q.device)
    for start in range(0, T, block):
        if causal and start > S - 1:
            break
        kb, vb = kf[:, :, start:start + block], vf[:, :, start:start + block]
        s = torch.einsum("bhsd,bhtd->bhst", qf, kb)
        if causal:
            kv_pos = torch.arange(start, start + kb.shape[2], device=q.device)
            vis = kv_pos[None, :] <= q_pos[:, None]
            if window is not None:
                vis = vis & (kv_pos[None, :] > q_pos[:, None] - window)
            s = torch.where(vis, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhst,bhtd->bhsd", p, vb)
        m = m_new
    denom = torch.clamp(l, min=1e-20)
    out = acc / denom[..., None]
    return (out, m + torch.log(denom)) if return_lse else out



def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, *,
                        causal: bool = True,
                        scale: Optional[float] = None,
                        window: Optional[int] = None):
    """The backward of :func:`flash_attention`: (dq, dk, dv) at ``dout``,
    the gradient at its float32 output ``out`` (``window`` as there).

    P is recomputed in float32 (``softmax`` of the scores masked as the
    forward masks them), ``D_i = sum_d dout[i, d] out[i, d]``,
    ``dS = P (dout v^T - D)``, ``dq = scale dS k``, ``dk = dS^T (scale q)``
    and ``dv = P^T dout``, summed over the ``H // KV`` query heads of each
    KV head; each gradient is returned in its input's dtype.  It
    materializes the ``[B, H, S, T]`` scores.
    """
    B, H, S, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    rep = H // KV
    _window_ok(window, causal, S, T)
    scale = scale if scale is not None else hd ** -0.5
    qf = q.float() * scale
    kf, vf = k.float(), v.float()
    if rep > 1:
        kf = kf.repeat_interleave(rep, dim=1)
        vf = vf.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", qf, kf)
    if causal:
        kv_pos = torch.arange(T, device=q.device)[None, :]
        q_pos = torch.arange(S, device=q.device)[:, None]
        vis = kv_pos <= q_pos
        if window is not None:
            vis = vis & (kv_pos > q_pos - window)
        s = torch.where(vis, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    do = dout.float()
    dd = (do * out.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bhsd,bhtd->bhst", do, vf) - dd)
    dq = torch.einsum("bhst,bhtd->bhsd", ds, kf) * scale
    dk = torch.einsum("bhst,bhsd->bhtd", ds, qf)
    dv = torch.einsum("bhst,bhsd->bhtd", p, do)
    if rep > 1:
        dk = dk.reshape(B, KV, rep, T, hd).sum(2)
        dv = dv.reshape(B, KV, rep, T, -1).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)

def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 recurrence, ``repro.kernels.ref.rwkv_scan``: r, k, v, w
    ``[B, H, T, hd]``, u ``[H, hd]``, state0 ``[B, H, hd, hd]`` (zeros when
    None).  In float32, one step at a time:

        out_t = r_t (S + diag(u) k_t v_t^T)
        S     = diag(w_t) S + k_t v_t^T

    Returns (out ``[B, H, T, hd]`` in ``r.dtype``, the final state
    ``[B, H, hd, hd]`` float32).
    """
    B, H, T, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[..., None]                                  # [H, hd, 1]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float().clone())
    out = torch.empty((B, H, T, hd), dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]       # [B, H, hd, hd]
        out[:, :, t] = torch.einsum("bhk,bhkv->bhv", rf[:, :, t], s + uf * kv)
        s = wf[:, :, t, :, None] * s + kv
    return out.to(r.dtype), s


def rwkv_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state0: Optional[torch.Tensor], dout: torch.Tensor,
                  dstate_T: Optional[torch.Tensor] = None):
    """The gradients of :func:`rwkv_scan`, the vjp of
    ``repro.kernels.ref.rwkv_scan``: from the inputs, ``dout`` (the
    gradient at out) and ``dstate_T`` (at the final state; zeros when
    None), in float32, one step at a time backwards.  With G_t the
    gradient of the state after step t, beta_t = sum_k r_t u k_t and
    vd_t = v_t . dout_t:

        dr_t = S_{t-1} dout_t + u k_t vd_t     dk_t = G_t v_t + u r_t vd_t
        dv_t = G_t^T k_t + dout_t beta_t       dw_t = rowsum(G_t * S_{t-1})
        du   = sum_{b,t} r_t k_t vd_t          G_{t-1} = w_t G_t + r_t dout_t^T

    and dstate0 = G_{-1}.  The states S_{t-1} are recomputed forward from
    state0 (never by dividing by w_t, which may come near 0).  Returns
    (dr, dk, dv in r's dtype, dw in w's, du ``[H, hd]`` and dstate0
    ``[B, H, hd, hd]`` float32), as JAX's vjp of the casts rounds them."""
    B, H, T, hd = r.shape
    rf, kf, vf, wf, df = (x.float() for x in (r, k, v, w, dout))
    uf = u.float()                                             # [H, hd]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float())
    states = []                                # S_{t-1} for each step t
    for t in range(T):
        states.append(s)
        s = wf[:, :, t, :, None] * s + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    g = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if dstate_T is None else dstate_T.float().clone())
    dr, dk, dv, dw = (torch.empty((B, H, T, hd), dtype=torch.float32,
                                  device=r.device) for _ in range(4))
    du = torch.zeros((H, hd), dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        rt, kt, vt, wt, dt = (x[:, :, t] for x in (rf, kf, vf, wf, df))
        sp = states[t]
        vd = (vt * dt).sum(-1, keepdim=True)                   # [B, H, 1]
        beta = (rt * uf * kt).sum(-1, keepdim=True)
        dr[:, :, t] = torch.einsum("bhkc,bhc->bhk", sp, dt) + uf * kt * vd
        dk[:, :, t] = torch.einsum("bhkc,bhc->bhk", g, vt) + uf * rt * vd
        dv[:, :, t] = torch.einsum("bhkc,bhk->bhc", g, kt) + dt * beta
        dw[:, :, t] = (g * sp).sum(-1)
        du += (rt * kt * vd).sum(0)
        g = wt[..., None] * g + rt[..., None] * dt[..., None, :]
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dw.to(w.dtype),
            du, g)


def mamba_scan(x: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
               cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The selective scan of ``repro.models.ssm.mamba_apply``
    (``ssm.py:176-207``; its ``lax.scan``, ``:193-206``): x ``[B, S, DI]``, delta ``[B, S,
    DI]``, bmat and cmat ``[B, S, N]``, a ``[DI, N]``, d_skip ``[DI]``,
    h0 ``[B, DI, N]`` (zeros when None).  In float32, as JAX computes it:

        da  = exp(delta a)            dbx = (delta B) x
        h_t = da_t h_{t-1} + dbx_t    y_t = sum_n h_t C_t + x_t d_skip

    Returns (y ``[B, S, DI]`` in x's dtype, the final state ``[B, DI, N]``
    float32)."""
    B, S, DI = x.shape
    xf = x.float()
    dl = delta.float()
    bf, cf = bmat.float(), cmat.float()
    da = torch.exp(dl[..., None] * a.float()[None, None])      # [B,S,DI,N]
    dbx = dl[..., None] * bf[:, :, None, :] * xf[..., None]
    h = (torch.zeros((B, DI, a.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float().clone())
    ys = torch.empty((B, S, DI), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = da[:, t] * h + dbx[:, t]
        ys[:, t] = torch.einsum("bdn,bn->bd", h, cf[:, t])
    y = ys + xf * d_skip.float()
    return y.to(x.dtype), h


def mamba_scan_bwd(x: torch.Tensor, delta: torch.Tensor, bmat: torch.Tensor,
                   cmat: torch.Tensor, a: torch.Tensor, d_skip: torch.Tensor,
                   h0: Optional[torch.Tensor], dy: torch.Tensor,
                   dh_fin: Optional[torch.Tensor] = None):
    """The gradients of :func:`mamba_scan` at ``dy`` (the gradient at y)
    and ``dh_fin`` (at the final state; zeros when None), in float32, one
    step at a time backwards.  With G_t the gradient at h_t and h_{t-1}
    the state before step t (recomputed forward from h0):

        G_t     = dy_t C_t + da_{t+1} G_{t+1}     (G_{S-1} adds dh_fin)
        dC_t    = sum_d dy_t h_t                  dB_t = sum_d G_t delta_t x_t
        u_t     = G_t h_{t-1} da_t                (at delta_t a)
        ddelta_t = sum_n (u_t a + G_t B_t x_t)    da = sum_{b,t} u_t delta_t
        dx_t    = sum_n G_t delta_t B_t + dy_t d_skip
        dd_skip = sum_{b,t} dy_t x_t              dh0 = da_0 G_0

    Returns (dx in x's dtype, ddelta, dbmat, dcmat, da ``[DI, N]``,
    dd_skip ``[DI]`` and dh0 ``[B, DI, N]``, float32)."""
    B, S, DI = x.shape
    xf, dl, bf, cf = (t.float() for t in (x, delta, bmat, cmat))
    af = a.float()
    dyf = dy.float()
    h = (torch.zeros((B, DI, af.shape[-1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    da = torch.exp(dl[..., None] * af[None, None])
    dbx = dl[..., None] * bf[:, :, None, :] * xf[..., None]
    states = []                                # h_{t-1} for each step t
    for t in range(S):
        states.append(h)
        h = da[:, t] * h + dbx[:, t]
    g = (torch.zeros_like(h) if dh_fin is None else dh_fin.float().clone())
    dx, ddl = (torch.empty((B, S, DI), dtype=torch.float32, device=x.device)
               for _ in range(2))
    db, dc = (torch.empty((B, S, af.shape[-1]), dtype=torch.float32,
                          device=x.device) for _ in range(2))
    dA = torch.zeros_like(af)
    for t in reversed(range(S)):
        hp = states[t]
        ht = da[:, t] * hp + dbx[:, t]
        g = g + dyf[:, t, :, None] * cf[:, t, None, :]
        dc[:, t] = torch.einsum("bd,bdn->bn", dyf[:, t], ht)
        gx = g * xf[:, t, :, None]
        db[:, t] = torch.einsum("bdn,bd->bn", gx, dl[:, t])
        u = g * hp * da[:, t]
        dA += (u * dl[:, t, :, None]).sum(0)
        ddl[:, t] = (u * af).sum(-1) + (gx * bf[:, t, None, :]).sum(-1)
        dx[:, t] = (g * (dl[:, t, :, None] * bf[:, t, None, :])).sum(-1) \
            + dyf[:, t] * d_skip.float()
        g = g * da[:, t]
    dskip = (dyf * xf).sum((0, 1))
    return dx.to(x.dtype), ddl, db, dc, dA, dskip, g


# ---------------------------------------------------------------------------
# The in-dispatch skew controller's arithmetic (plain version of ctrl_step)
# ---------------------------------------------------------------------------
# Twins of the host controller's decision math: the skew test
# (core/skew_test.py), the adaptive-tau step (core/adaptive_tau.py), the
# phase-2 split ratio (core/load_transfer.py), the mean-model estimator
# (core/estimator.py) and the derived routing consts
# (core/partitioner.routing_cdf32).  Each must be bit-exact against the host
# in float64, so every reduction a decision depends on is a strictly
# sequential left-to-right chain of IEEE adds (``core.estimator.seq_sum``),
# never ``torch.sum`` or ``cumsum``.  The scalar chains run on Python
# floats, which are IEEE float64 with no contraction, as the host's are.

#: ``MitigationPhase.PHASE_ONE.value`` / ``PHASE_TWO.value``.
PH1, PH2 = 2, 3


def _floats(v) -> list:
    return v.tolist() if isinstance(v, torch.Tensor) else [float(x) for x in v]


def seq_sum_vec(v) -> float:
    """Sequential left-to-right float64 sum of a 1-D vector (``seq_sum``)."""
    acc = 0.0
    for x in _floats(v):
        acc += x
    return acc


def ring_mean_stderr(obs_row, n: int, pos: int) -> Tuple[float, float]:
    """(predict, stderr) of one worker's observation ring, the twin of
    ``MeanModelEstimator.predict`` / ``stderr``: the ring holds ``n`` valid
    entries ending just before slot ``pos``, read oldest first.  ``predict``
    is 0.0 on an empty sample; ``stderr`` is +inf below two samples, else
    ``d * sqrt(1 + 1/n)`` with ``d = sqrt(ssq / (n - 1))``."""
    row = _floats(obs_row)
    window = len(row)
    n, pos = int(n), int(pos)
    start = (pos - n) % window
    vals = [row[(start + i) % window] for i in range(n)]
    acc = 0.0
    for x in vals:
        acc += x
    mean = acc / n if n > 0 else 0.0
    ssq = 0.0
    for x in vals:
        d = x - mean
        ssq += d * d
    if n < 2:
        return mean, math.inf
    d = math.sqrt(ssq / (n - 1.0))
    return mean, d * math.sqrt(1.0 + 1.0 / n)


def skew_test(phi_l: float, phi_c: float, eta: float, tau: float) -> bool:
    """Twin of :func:`repro_torch.core.skew_test.skew_test`."""
    return phi_l >= eta and phi_l - phi_c >= tau


def adjust_tau(phi_s: float, phi_h: float, eps: float, tau: float, *, eta,
               eps_lower, eps_upper, tau_increase, enabled: bool
               ) -> Tuple[float, bool, bool]:
    """Twin of :func:`repro_torch.core.adaptive_tau.adjust_tau`: returns
    ``(new_tau, changed, decreased)``; ``enabled`` folds in both
    ``cfg.adaptive_tau`` and the adjustment budget."""
    gap = phi_s - phi_h
    passes = skew_test(phi_s, phi_h, eta, tau)
    finite = math.isfinite(eps)
    inc = enabled and finite and passes and eps > eps_upper
    dec = (enabled and finite and not passes and eps < eps_lower and gap > 0
           and phi_s >= eta)
    if inc:
        return tau + tau_increase, True, False
    if dec:
        return max(gap, 1e-9), True, True
    return tau, False, False


def phase2_fraction(f_s: float, f_h: float) -> float:
    """Single-helper twin of ``load_transfer.phase2_fractions_multi``: the
    fraction of the skewed worker's future share handed to the helper (0.0
    when ``f_s <= 0``)."""
    avg = (f_s + f_h) / 2.0
    give = max(avg - f_h, 0.0)
    max_total = max(f_s - avg, 0.0)
    if give > max_total and max_total > 0:
        give = give * (max_total / give)
    return give / f_s if f_s > 0 else 0.0


def saturated_cdf32_seq(weights: torch.Tensor) -> torch.Tensor:
    """Twin of ``core.partitioner.routing_cdf32``: the float32 row-CDF as a
    sequential chain over the columns (numpy's cumsum order), saturated to
    1.0 from each row's last positive column on (the last column for a row
    with none)."""
    K, W = weights.shape
    acc = torch.zeros(K, dtype=torch.float32, device=weights.device)
    cols = []
    for j in range(W):
        acc = acc + weights[:, j].to(torch.float32)
        cols.append(acc)
    cdf = torch.stack(cols, dim=1)
    pos = weights > 0
    idx = torch.arange(W, device=weights.device)
    last = torch.where(pos, idx, -1).amax(dim=1)
    last = torch.where(last < 0, W - 1, last)
    return torch.where(idx[None, :] >= last[:, None], 1.0, cdf)


def routing_consts(weights: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(cdf32, primary, is_split) of float64 weights: the twin of
    ``RoutingTable._refresh_derived`` (``primary`` the first arg-max)."""
    primary = torch.argmax(weights, dim=1)
    is_split = (weights > 0).sum(dim=1) > 1
    return saturated_cdf32_seq(weights), primary, is_split


def ctrl_step(spec, c, arrived: torch.Tensor, phi, t0: int, k: int,
              tuples_left: float, rate: float) -> None:
    """Plain version of the ``ctrl_step`` kernel: one super-tick window
    ``[t0, t0 + k)`` of the in-dispatch controller on the state ``c``.

    The twin of the JAX package's jitted ``controller_step``: the window's
    owner-attributed arrivals and ``phi`` go into the observation log, then
    every metric round in the window replays the host controller's round
    (tracker update, the mitigations in ``mit_seq`` order, adaptive tau,
    detection and helper assignment, the phase-1 / phase-2 rewrites), and
    the routing consts are rebuilt once if ``epoch`` moved.  Mutates ``c``
    in place and zeroes ``arrived``.  ``rate`` is unused: the eligible
    configuration migrates at an infinite rate.  Where the reference masks
    an update by a predicate, this branches on it: a masked-off update is
    the identity, so skipping it is exact.
    """
    W = spec.W
    window = spec.window
    inf = math.inf
    # Owner-attributed arrivals (integer counts: any order is exact).
    arr_i = torch.zeros(W, dtype=torch.int64, device=arrived.device)
    arr_i.index_add_(0, c["owner"], arrived)
    arrived.zero_()
    arr0 = [float(x) for x in arr_i.tolist()]
    phi = _floats(phi)
    n_log = int(c["log_n"])
    if n_log >= c["log_phi"].shape[0]:
        raise RuntimeError("controller observation log is full")
    c["log_phi"][n_log] = torch.tensor(phi, dtype=torch.float64)
    c["log_arr"][n_log] = torch.tensor(arr0, dtype=torch.float64)
    c["log_n"].fill_(n_log + 1)

    obs = c["obs"].tolist()
    obs_n = c["obs_n"].tolist()
    obs_pos = c["obs_pos"].tolist()
    tau = float(c["tau"])
    tau_adj = int(c["tau_adj"])
    active = c["mit_active"].tolist()
    helper = c["mit_helper"].tolist()
    phase = c["mit_phase"].tolist()
    calm_r = c["mit_calm"].tolist()
    seq = c["mit_seq"].tolist()
    seq_next = int(c["seq_next"])
    epoch0 = epoch = int(c["epoch"])
    weights = c["weights"]
    owner = c["owner"]

    def stderr(w):
        return ring_mean_stderr(obs[w], obs_n[w], obs_pos[w])[1]

    def shares():
        means = [ring_mean_stderr(obs[w], obs_n[w], obs_pos[w])[0]
                 for w in range(W)]
        total = seq_sum_vec(means)
        if total <= 0:
            return [1.0 / W] * W
        return [m / total for m in means]

    def phase1(s, h):
        # plan_phase1 (full partition): every key owned by S with S-mass
        # hands that mass to H (row sums kept).
        col_s, col_h = weights[:, s], weights[:, h]
        sel = (owner == s) & (col_s > 0.0)
        if not bool(sel.any()):
            return False
        weights[:, h] = torch.where(sel, col_h + col_s, col_h)
        weights[:, s] = torch.where(sel, 0.0, col_s)
        return True

    def phase2(s, h):
        # plan_phase2 (SBR, one helper): every key owned by S gets the row
        # [S: 1 - r, H: r] from the predicted shares.
        f = shares()
        r = phase2_fraction(f[s], f[h])
        row = [0.0] * W
        row[s] = 1.0 - r
        row[h] = row[h] + r
        owned = owner == s
        if not bool(owned.any()):
            return False
        weights[owned] = torch.tensor(row, dtype=weights.dtype,
                                      device=weights.device)
        return True

    arr = arr0
    for i in range(int(k)):
        t = int(t0) + i
        if t < spec.initial_delay or (t - spec.initial_delay) % \
                spec.metric_period:
            continue
        # ---- tracker.update -------------------------------------------
        total = seq_sum_vec(arr)
        if total > 0:
            scale = spec.horizon / total
            for w in range(W):
                obs[w][obs_pos[w]] = arr[w] * scale
                obs_n[w] = min(obs_n[w] + 1, window)
                obs_pos[w] = (obs_pos[w] + 1) % window
        arr = [0.0] * W             # the adapter drains every round
        # ---- _advance_mitigations (insertion order == mit_seq order) --
        for s in sorted((w for w in range(W) if active[w]),
                        key=lambda w: (seq[w], w)):
            h = helper[s]
            q_s, q_h = phi[s], phi[h]
            top = max(max(q_s, q_h), 1.0)
            p1_to_p2 = (phase[s] == PH1
                        and q_h >= q_s - spec.catchup_tolerance * top)
            in_p2 = phase[s] == PH2
            s_ahead = skew_test(q_s, q_h, spec.eta, tau)
            h_ahead = skew_test(q_h, q_s, spec.eta, tau)
            calm = in_p2 and not (s_ahead or h_ahead)
            div = in_p2 and (s_ahead or h_ahead)
            new_calm = calm_r[s] + 1
            retire = (calm and spec.retire_window > 0
                      and new_calm >= spec.retire_window)
            if div:
                # adaptive tau on divergence (eps before the resets)
                eps = max(stderr(s), stderr(h))
                if (spec.adaptive_tau and math.isfinite(eps)
                        and eps > spec.eps_upper
                        and tau_adj < spec.max_tau_adjustments):
                    tau = tau + spec.tau_increase
                    tau_adj += 1
                obs_n[s] = 0        # reset_samples([s, h])
                obs_n[h] = 0
            start_p1 = div and s_ahead
            start_p2 = (div and not s_ahead) or p1_to_p2
            if not spec.enable_phase1:
                start_p2, start_p1 = start_p2 or start_p1, False
            if start_p1:
                epoch += phase1(s, h)
                phase[s] = PH1
            elif start_p2:
                epoch += phase2(s, h)       # post-reset shares
                phase[s] = PH2
            if calm:
                calm_r[s] = new_calm
            elif div:
                calm_r[s] = 0
            if retire:
                active[s] = False
        # ---- _detect --------------------------------------------------
        busy = list(active)
        for s in range(W):
            if active[s]:
                busy[helper[s]] = True
        free = [not b for b in busy]
        nfree = sum(free)
        s0 = h0 = 0
        hi, lo = -inf, inf
        for w in range(W):
            if free[w] and phi[w] > hi:
                s0, hi = w, phi[w]
            if free[w] and phi[w] < lo:
                h0, lo = w, phi[w]
        eps0 = max(stderr(s0), stderr(h0))
        t_new, t_chg, t_dec = adjust_tau(
            phi[s0], phi[h0], eps0, tau, eta=spec.eta,
            eps_lower=spec.eps_lower, eps_upper=spec.eps_upper,
            tau_increase=spec.tau_increase,
            enabled=(spec.adaptive_tau
                     and tau_adj < spec.max_tau_adjustments))
        app = nfree >= 2 and math.isfinite(eps0)
        detect_tau = t_new if app and t_dec else tau
        if app and t_chg:
            tau = t_new
            tau_adj += 1
        # the skewed set: free workers >= eta whose gap to the free
        # minimum (excluding themselves) reaches detect_tau
        m1 = m2 = inf
        i1 = 0
        for w in range(W):
            if free[w] and phi[w] < m1:
                i1, m1 = w, phi[w]
        for w in range(W):
            if free[w] and w != i1 and phi[w] < m2:
                m2 = phi[w]
        skewed = [free[w] and phi[w] >= spec.eta
                  and phi[w] - (m2 if w == i1 else m1) >= detect_tau
                  for w in range(W)]
        f_hat = shares()
        L = float(tuples_left)
        taken = [b or sk for b, sk in zip(busy, skewed)]
        processed = [False] * W
        for _ in range(W):
            s, best = -1, -inf
            for w in range(W):
                if skewed[w] and not processed[w] and (s < 0 or phi[w] > best):
                    s, best = w, phi[w]
            if s < 0:
                break               # no skewed worker left: the rest is idle
            processed[s] = True
            cands = [free[w] and not taken[w] and phi[s] - phi[w] >= detect_tau
                     and w != s for w in range(W)]
            if not any(cands):
                continue
            # choose_helpers, max_helpers=1: the lexicographic minimum by
            # (f_hat, phi, index), the host's stable double sort
            h = min((w for w in range(W) if cands[w]),
                    key=lambda w: (f_hat[w], phi[w], w))
            for w in range(W):
                taken[w] = taken[w] or cands[w]
            f_s, f_h = f_hat[s], f_hat[h]
            lr_max = (f_s - (f_s + f_h) / 2.0) * L
            future = max(L, 0.0) * f_s          # M = 0 (infinite rate)
            if not min(lr_max, future) >= -1e-12:
                continue
            if spec.enable_phase1:
                epoch += phase1(s, h)
                phase[s] = PH1
            else:
                epoch += phase2(s, h)
                phase[s] = PH2
            active[s] = True
            helper[s] = h
            calm_r[s] = 0
            seq[s] = seq_next
            seq_next += 1

    i32 = torch.int32
    c["obs"].copy_(torch.tensor(obs, dtype=torch.float64))
    for name, vals, dt in (("obs_n", obs_n, i32), ("obs_pos", obs_pos, i32),
                           ("mit_active", active, torch.bool),
                           ("mit_helper", helper, i32),
                           ("mit_phase", phase, i32),
                           ("mit_calm", calm_r, i32), ("mit_seq", seq, i32)):
        c[name].copy_(torch.tensor(vals, dtype=dt))
    c["tau"].fill_(tau)
    c["tau_adj"].fill_(tau_adj)
    c["seq_next"].fill_(seq_next)
    c["epoch"].fill_(epoch)
    if epoch != epoch0:
        cdf, primary, is_split = routing_consts(weights)
        c["cdf"].copy_(cdf)
        c["primary"].copy_(primary)
        c["is_split"].copy_(is_split)
