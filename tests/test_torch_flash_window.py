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
arithmetic of ``csrc/flash_attention.cu``: the (64, 64) overlap forward
(blocks of 2 or 3 warpgroups of 64 rows, 64-key tiles; the block's walk
from the tile holding its first row's first key, each warpgroup's own
tiles from its first row's), ``flash_bwd_dkv_wgmma``'s items (128 keys,
64-query tiles up to the last query that sees the item's last key, a
warpgroup skipping tiles past its keys' windows), ``flash_bwd_dq_wgmma``
(64-key tiles from the block's first row's first key, a warpgroup skipping
tiles below its windows) and the fma kernels (64 x 64 tiles): every
visible (query, key) pair is multiplied by the tile walk that owns it,
no tile is multiplied whose pairs are all masked, the ring walks in a
block are the same for its producer and consumers, and a tile the kernel
does not mask (not an edge tile) holds no masked pair.
"""
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
    sub = vis[np.ix_(rows, keys)]
    assert sub.any(), f"{what}: a wholly masked tile is multiplied"
    if not edge:
        assert sub.all(), f"{what}: a tile with masked pairs is not masked"


def _fwd_overlap(S, W, wgs):
    """flash_overlap's walks: covered pairs."""
    T, BM = S, 64 * wgs
    vis = _visible(S, W)
    cov = np.zeros((S, S), int)
    for q0 in range(0, S, BM):
        n_kv = _cdiv(min(T, q0 + BM), 64)
        j_lo = max(0, q0 - W + 1) // 64
        walk = list(range(j_lo, n_kv))
        for wg in range(wgs):
            row_lo = q0 + 64 * wg
            n_own = j_lo if row_lo >= S else min(n_kv, row_lo // 64 + 1)
            j_own = max(j_lo, max(0, row_lo - W + 1) // 64) if row_lo < S \
                else j_lo
            own = list(range(j_own, n_own))
            assert set(own) <= set(walk)
            rows = np.arange(row_lo, min(row_lo + 64, S))
            for j in own:
                k0 = 64 * j
                keys = np.arange(k0, min(k0 + 64, T))
                edge = (k0 + 64 > T or k0 + 63 > row_lo
                        or k0 <= row_lo + 63 - W)
                _check_tile(vis, rows, keys, edge, f"fwd S={S} W={W} wg={wg}")
                cov[np.ix_(rows, keys)] += vis[np.ix_(rows, keys)]
    return cov


def _dkv_wgmma(S, W):
    """flash_bwd_dkv_wgmma's items at (64, 64) (kOwnKeys, 128 keys)."""
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


def _dq_wgmma(S, W, wgs):
    """flash_bwd_dq_wgmma at (64, 64): blocks of wgs x 64 queries over the
    padded rows, 64-key tiles from j_lo."""
    T = S
    Sp = _cdiv(S, 128) * 128
    vis = _visible(S, W)
    cov = np.zeros((S, S), int)
    for q0 in range(0, Sp, 64 * wgs):
        n_kv = _cdiv(min(T, q0 + 64 * wgs), 64)
        j_lo = max(0, q0 - W + 1) // 64
        for wg in range(wgs):
            row_lo = q0 + 64 * wg
            rows = np.arange(row_lo, min(row_lo + 64, S))
            for j in range(j_lo, n_kv):
                k0 = 64 * j
                if k0 > row_lo + 63 or k0 + 63 <= row_lo - W:
                    continue
                if len(rows) == 0:
                    continue
                keys = np.arange(k0, min(k0 + 64, T))
                edge = (k0 + 63 > row_lo or k0 + 64 > T
                        or k0 <= row_lo + 63 - W)
                _check_tile(vis, rows, keys, edge, f"dq S={S} W={W}")
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
    want = _visible(S, W).astype(int)
    for wgs in (2, 3):
        np.testing.assert_array_equal(_fwd_overlap(S, W, wgs), want)
        np.testing.assert_array_equal(_dq_wgmma(S, W, wgs), want)
    np.testing.assert_array_equal(_dkv_wgmma(S, W), want)
    by_q, by_k = _fma_rows(S, W)
    np.testing.assert_array_equal(by_q, want)
    np.testing.assert_array_equal(by_k, want)


def test_a_window_cuts_the_walk():
    """At Hymba's S 2,048 and window 1,024 the overlap forward multiplies
    about S W of the S^2 / 2 causal pairs' tiles: its tiles number under
    80% of the causal walk's."""
    S, W = 2048, 1024

    def tiles(W):
        n = 0
        for q0 in range(0, S, 192):
            j_lo = max(0, q0 - W + 1) // 64 if W else 0
            for wg in range(3):
                row_lo = q0 + 64 * wg
                if row_lo >= S:
                    continue
                n_own = min(_cdiv(min(S, q0 + 192), 64), row_lo // 64 + 1)
                j_own = max(j_lo, max(0, row_lo - W + 1) // 64) if W else 0
                n += n_own - j_own
        return n
    assert tiles(W) < 0.8 * tiles(0)
