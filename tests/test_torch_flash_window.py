"""K5's sliding window (the hybrid family's attention) on the CPU.

Two parts.  The plain versions with a window, ``ref.flash_attention`` and
``ref.flash_attention_bwd``, against the JAX reference's windowed mask
(``repro.models.attention.flash_attention_ref(window=)``, ``:95-96``) and
its ``jax.vjp``, on the same numpy inputs, at windows 1, 4, 63, 64, 65 and
past S, with GQA (5 query heads a KV head, Hymba's), over KV blocks of
1,024 and of 32 keys (where whole blocks lie below some rows' windows):
float32, the output within 2e-6 + 1e-5 relative and the gradients within
1e-5 of each one's largest entry, or of 1 where that is smaller (sums in
other orders; at window 1 dq is the difference of two equal terms, 0 in
JAX and ~1e-7 here); the windowed output differs from the full one beyond
that.

Then the kernels' walks over tiles, emulated in numpy with the index
arithmetic of ``csrc/flash_attention.cu``: the (64, 64) window forward
``flash_window`` and ``dq_window`` (blocks of 2 or 3 warpgroups, each a
unit of 64 query rows of one head, the rep heads of a KV head packed into
consecutive units; 64-key tiles on one ring per block, each unit's walk
from its first row's first key up to its diagonal),
``flash_bwd_dkv_wgmma``'s window items (128 keys,
64-query tiles up to the last query that sees the item's last key, a
warpgroup skipping tiles past its keys' windows) and the fma kernels (64 x
64 tiles): every visible (query, key) pair is multiplied by the tile walk
that owns it, once for each query head, no tile is multiplied whose pairs
are all masked, and a tile the kernel does not mask (not an edge tile)
holds no masked pair.  Last, dkv's items at Hymba's train shape scheduled
on the card's SMs: the grid's own order already ends as soon as any
schedule of whole 128-key items can.
"""
import heapq

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from types import SimpleNamespace

from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as k5
from repro_torch.kernels import ref as tref

WINDOWS = (1, 4, 63, 64, 65, 1000)


def _inputs(seed, B, H, KV, S, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    return q, k, v


def _bhsd(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))


@pytest.mark.parametrize("block", [1024, 32])
@pytest.mark.parametrize("window", WINDOWS)
def test_windowed_plain_versions_match_jax(window, block):
    B, H, KV, S, d = 2, 5, 1, 97, 16
    q, k, v = _inputs(window, B, H, KV, S, d)
    scale = d ** -0.5
    jfn = lambda q, k, v: jattn.flash_attention_ref(
        q, k, v, causal=True, window=window, block=block, scale=scale)
    want, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = np.asarray(want).transpose(0, 2, 1, 3)
    tq, tk, tv = _bhsd(q), _bhsd(k), _bhsd(v)
    got = tref.flash_attention(tq, tk, tv, causal=True, scale=scale,
                               block=block, window=window)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=1e-5)
    full = tref.flash_attention(tq, tk, tv, causal=True, scale=scale)
    if window < S:
        assert np.abs(full.numpy() - want).max() > 1e-3
    # The wrapper's CPU path is the plain version.
    np.testing.assert_array_equal(
        k5.flash_attention(tq, tk, tv, causal=True, scale=scale,
                           window=window).numpy(),
        tref.flash_attention(tq, tk, tv, causal=True, scale=scale,
                             window=window).numpy())
    dout = np.random.default_rng(window + 7).standard_normal(
        want.shape).astype(np.float32)
    jg = vjp(jnp.asarray(dout.transpose(0, 2, 1, 3)))
    tg = tref.flash_attention_bwd(tq, tk, tv, got, torch.from_numpy(dout),
                                  scale=scale, window=window)
    for name, a, b in zip("qkv", tg, jg):
        b = np.asarray(b).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


def test_window_refusals():
    """A window needs causal attention and a width of at least 1; on the
    card's ``wgmma`` route only (64, 64) takes one."""
    q, k, v = (_bhsd(a) for a in _inputs(0, 1, 2, 1, 8, 16))
    with pytest.raises(ValueError, match="causal"):
        k5.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError, match="at least 1"):
        k5.flash_attention(q, k, v, causal=True, window=0)
    with pytest.raises(ValueError, match="causal"):
        k5.flash_attention_bwd(q, k, v, torch.zeros(1, 2, 8, 16),
                               torch.zeros(1, 2, 8, 16), causal=False,
                               window=4)

    def card(d, dv):
        return (SimpleNamespace(device=torch.device("cuda", 0),
                                dtype=torch.bfloat16, shape=(1, 1, 8, d)),
                SimpleNamespace(shape=(1, 1, 8, dv)))

    for pair in k5.WGMMA_WIDTHS:
        qs, vs = card(*pair)
        if pair == k5.WINDOW_WGMMA:
            assert k5._window(1024, True, qs, vs) == 1024
        else:
            with pytest.raises(ValueError, match="wgmma"):
                k5._window(1024, True, qs, vs)
    assert k5._window(None, False, *card(128, 128)) == 0


# --------------------------------------------------------------------- #
# The kernels' tile walks                                                #
# --------------------------------------------------------------------- #
def _visible(S, W):
    """[S, S] bool: query i sees key j when i - W < j <= i."""
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    return (j <= i) & (j > i - W)


def _cdiv(a, b):
    return -(-a // b)


def _check_tile(vis, rows, keys, edge, what):
    """A multiplied tile: some pair visible; and a tile the kernel does not
    mask (edge False) holds no masked pair among its real rows and keys."""
    sub = vis[rows, keys] if isinstance(rows, slice) else vis[np.ix_(rows,
                                                                     keys)]
    assert sub.any(), f"{what}: a wholly masked tile is multiplied"
    if not edge:
        assert sub.all(), f"{what}: a tile with masked pairs is not masked"


def _first(t, W):
    """WinUnits::first_tile: the key tile of row tile t's first row's
    first key."""
    return max(0, 64 * t - W + 1) // 64


def _win_blocks(S, rep, wgs):
    """The window forms' blocks of one (b, KV head): each its units (row
    tile t, head hh), one a consumer warpgroup: wgs consecutive units u =
    t rep + hh."""
    n_t = _cdiv(S, 64)
    return [[(u // rep, u % rep) for u in range(u0, min(u0 + wgs,
                                                        rep * n_t))]
            for u0 in range(0, rep * n_t, wgs)]


def _rows(t, S):
    return slice(64 * t, min(64 * t + 64, S))


def _keys(j, T):
    return slice(64 * j, min(64 * j + 64, T))


def _window_walks(S, W, wgs, rep=1):
    """flash_window's and dq_window's walks (the same): a block's ring
    walks key tiles first(t_lo) up to t_hi, each warpgroup multiplying its
    own first(t)..t; covered pairs [rep, S, S].  A block's row tiles lie
    at most one apart where rep >= wgs - 1."""
    T = S
    vis = _visible(S, W)
    cov = np.zeros((rep, S, S), np.int8)
    for blk in _win_blocks(S, rep, wgs):
        t_lo, t_hi = blk[0][0], blk[-1][0]
        assert t_hi - t_lo <= (1 if rep >= wgs - 1 else wgs - 1)
        for t, hh in blk:
            for j in range(_first(t_lo, W), t_hi + 1):
                if not _first(t, W) <= j <= t:
                    continue
                edge = j == t or 64 * j <= 64 * t + 63 - W
                _check_tile(vis, _rows(t, S), _keys(j, T), edge,
                            f"window S={S} W={W} t={t}")
                cov[hh, _rows(t, S), _keys(j, T)] += vis[_rows(t, S),
                                                         _keys(j, T)]
    return cov


def _dkv_wgmma(S, W):
    """flash_bwd_dkv_wgmma's window items at (64, 64) (kOwnKeys, 128 keys,
    each warpgroup its own 64): covered pairs."""
    T = S
    vis = _visible(S, W)
    cov = np.zeros((S, S), int)
    for k0 in range(0, T, 128):
        q_start = k0
        q_end = min(S, k0 + 128 - 1 + W)
        n_q = _cdiv(q_end - q_start, 64)
        for wg in range(2):
            kw0 = k0 + 64 * wg
            keys = np.arange(kw0, min(kw0 + 64, T))
            for u in range(n_q):
                q0 = q_start + 64 * u
                if kw0 >= T or q0 + 63 < kw0 or q0 >= kw0 + 63 + W:
                    continue
                rows = np.arange(q0, min(q0 + 64, S))
                edge = q0 < kw0 + 63 or q0 + 63 >= kw0 + W
                _check_tile(vis, rows, keys, edge, f"dkv S={S} W={W}")
                cov[np.ix_(rows, keys)] += vis[np.ix_(rows, keys)]
    return cov


def _fma_rows(S, W):
    """flash_fma and flash_bwd_dq: a block of 64 queries over 64-key tiles
    from kv_start; flash_bwd_dkv: a block of 64 keys over 64-query tiles
    up to q_end."""
    T = S
    vis = _visible(S, W)
    by_q = np.zeros((S, S), int)
    for q0 in range(0, S, 64):
        rows = np.arange(q0, min(q0 + 64, S))
        for k0 in range(max(0, q0 - W + 1) // 64 * 64, min(T, q0 + 64), 64):
            keys = np.arange(k0, min(k0 + 64, T))
            _check_tile(vis, rows, keys, True, f"fma S={S} W={W}")
            by_q[np.ix_(rows, keys)] += vis[np.ix_(rows, keys)]
    by_k = np.zeros((S, S), int)
    for k0 in range(0, T, 64):
        keys = np.arange(k0, min(k0 + 64, T))
        for q0 in range(k0, min(S, k0 + 63 + W), 64):
            rows = np.arange(q0, min(q0 + 64, S))
            _check_tile(vis, rows, keys, True, f"fma dkv S={S} W={W}")
            by_k[np.ix_(rows, keys)] += vis[np.ix_(rows, keys)]
    return by_q, by_k


@pytest.mark.parametrize("S", [1, 63, 64, 65, 200, 1100, 2048])
@pytest.mark.parametrize("W", [1, 63, 64, 65, 1023, 1024, 5000])
def test_tile_walks_cover_every_visible_pair_once(S, W):
    """At 2 and 3 warpgroups, for each query head of rep 5 (Hymba's), rep
    2 (a block's units across two row tiles) and rep 1 (a block's rows two
    tiles apart)."""
    want = _visible(S, W).astype(int)
    for wgs in (2, 3):
        for rep in (5, 2, 1):
            cov = _window_walks(S, W, wgs, rep)
            assert np.array_equal(cov, np.broadcast_to(want, cov.shape)), (
                f"wgs={wgs} rep={rep}")
    np.testing.assert_array_equal(_dkv_wgmma(S, W), want)
    by_q, by_k = _fma_rows(S, W)
    np.testing.assert_array_equal(by_q, want)
    np.testing.assert_array_equal(by_k, want)


def test_a_window_cuts_the_walk():
    """At Hymba's S 2,048, window 1,024 and rep 5, flash_window multiplies
    about S W of the S^2 / 2 causal pairs' tiles (under 80% of a causal
    walk's), and its ring loads under 5% more tiles than its warpgroups
    multiply (the blocks whose units span two row tiles), at the three
    consumer warpgroups a block window_wgs takes there."""
    S, W, rep, wgs = 2048, 1024, 5, 3
    own = walked = causal = 0
    for blk in _win_blocks(S, rep, wgs):
        t_lo, t_hi = blk[0][0], blk[-1][0]
        walked += t_hi + 1 - _first(t_lo, W)
        for t, _ in blk:
            own += t + 1 - _first(t, W)
            causal += t + 1
    assert own < 0.8 * causal
    assert walked * wgs < 1.05 * own


def _dkv_items(S, W, rep):
    """flash_bwd_dkv_wgmma's window items of one (b, KV head) in grid
    order (key block y): each one's query-tile steps, rep n_q (its two
    warpgroups walk them side by side)."""
    return [rep * _cdiv(min(S, k0 + 127 + W) - k0, 64)
            for k0 in range(0, S, 128)]


def _list_schedule(jobs, sms):
    """The makespan of jobs taken in order, each by the first SM free."""
    free = [0] * sms
    for job in jobs:
        heapq.heapreplace(free, free[0] + job)
    return max(free)


def test_dkv_grid_order_already_meets_its_item_bound():
    """At Hymba's train shape (B 4, KV 5, rep 5, S 2,048, window 1,024) on
    132 SMs (an H100 SXM's), one dkv block an SM: the grid's own order
    (key block by key block, the heaviest items first) ends when the two
    heaviest items that must share an SM end, so no schedule of whole
    items (a persistent grid taking them heaviest first) ends sooner; the
    tail's loss against perfect balance is what 128-key items cost."""
    B, KV, rep, S, W, sms = 4, 5, 5, 2048, 1024, 132
    per = _dkv_items(S, W, rep)
    in_order = [n for n in per for _ in range(B * KV)]
    heaviest = sorted(in_order, reverse=True)
    bound = max(heaviest[sms - 1] + heaviest[sms], sum(in_order) / sms)
    assert _list_schedule(in_order, sms) == bound == 2 * 18 * rep
    assert _list_schedule(heaviest, sms) == bound
    assert 1.09 < bound / (sum(in_order) / sms) < 1.11
