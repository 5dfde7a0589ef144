"""Partition kernel K2 (``partition_scatter_fold``).

On the CPU the port's wrapper runs its plain PyTorch version, held against
the Pallas kernel of ``repro.kernels.partition`` in interpret mode and
against ``repro.kernels.ref`` on the same numpy inputs: destinations,
ranks, histogram and per-key counts exactly; per-key float32 sums within
``rtol = atol = 1e-5`` (the tolerance of ``tests/test_kernels.py``), since
the three add in different orders.  Masks are all live, suffix-padded (an
upload's padding) or holed (a Filter's dead lanes anywhere), and counters
sit near the int32 wrap.  The ``gpu`` test holds the CUDA kernel against
its plain version on the card; it skips without one.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.ops import saturated_cdf32
from repro_torch.kernels import partition as kpart
from repro_torch.kernels import ref as tref

jpart = importlib.import_module("repro.kernels.partition")
jops = importlib.import_module("repro.kernels.ops")

MASKS = ("live", "suffix", "holes")


def _inputs(seed, n, num_keys, num_workers, mask, split_frac=0.4):
    """Keys, counters within 64 of the int32 wrap (both sides), float32
    vals in [0, 8) as in ``tests/test_kernels.py`` (non-negative, so the
    relative tolerance holds without cancellation), a lane mask and a table
    of one-hot and split rows."""
    rng = np.random.default_rng(seed)
    w = np.zeros((num_keys, num_workers))
    w[np.arange(num_keys), rng.integers(0, num_workers, num_keys)] = 1.0
    for k in np.flatnonzero(rng.random(num_keys) < split_frac):
        m = int(rng.integers(1, min(num_workers, 4) + 1))
        w[k] = 0.0
        w[k, rng.choice(num_workers, m, replace=False)] = rng.dirichlet(
            np.ones(m))
    keys = rng.integers(0, num_keys, n).astype(np.int32)
    counters = rng.integers(2**31 - 64, 2**31 + 64, n).astype(np.int32)
    vals = rng.uniform(0.0, 8.0, n).astype(np.float32)
    if mask == "live":
        valid = np.ones(n, bool)
    elif mask == "suffix":
        valid = np.arange(n) < n - n // 3
    else:
        valid = rng.random(n) < 0.6
    return keys, counters, vals, valid, w


def _torch(keys, counters, vals, valid, w):
    return (torch.from_numpy(keys), torch.from_numpy(counters),
            torch.from_numpy(vals), torch.from_numpy(valid),
            saturated_cdf32(torch.from_numpy(w)))


def _assert_same(got, want):
    for i, (g, p) in enumerate(zip(got, want)):
        p = np.asarray(p)
        assert g.shape == p.shape
        if i < 4:           # dest, rank, hist, fold_counts
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, p)
        else:               # fold_sums: float32, another summation order
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("num_keys", [5, 64])
@pytest.mark.parametrize("num_workers", [1, 3, 20])
@pytest.mark.parametrize("n", [1, 7, 1023, 1025, 3000])
def test_plain_fold_matches_pallas_interpret_and_ref(n, num_workers, num_keys,
                                                     mask):
    args = _inputs(n * 31 + num_workers * 7 + num_keys, n, num_keys,
                   num_workers, mask)
    keys, counters, vals, valid, w = args
    tens = _torch(*args)
    got = [x.numpy() for x in kpart.partition_scatter_fold(*tens)]
    jargs = (jnp.asarray(keys), jnp.asarray(counters), jnp.asarray(vals),
             jnp.asarray(w, jnp.float32))
    cdf = jnp.asarray(tens[-1].numpy())
    _assert_same(got, jpart.partition_scatter_fold(
        *jargs, valid=jnp.asarray(valid, jnp.int32), cdf=cdf, interpret=True))
    _assert_same(got, jref.partition_scatter_fold(
        *jargs, valid=jnp.asarray(valid), cdf=cdf))
    dest, rank, hist, cnt, _ = got
    assert int(hist.sum()) == int(valid.sum()) == int(cnt.sum())
    assert not rank[~valid].any()               # dead lanes: rank 0
    # Live lanes, placed at bounds[dest] + rank, fill [0, live) exactly once.
    pos = np.r_[0, np.cumsum(hist)][dest[valid]] + rank[valid]
    np.testing.assert_array_equal(np.sort(pos), np.arange(int(valid.sum())))


def test_fold_equals_partition_scatter_on_live_lanes():
    """K2's dest is K1's on every lane, and its rank / hist are K1's on the
    chunk with the dead lanes removed."""
    keys, counters, vals, valid, w = _inputs(11, 2000, 64, 20, "holes")
    tens = _torch(keys, counters, vals, valid, w)
    dest, rank, hist, _, _ = kpart.partition_scatter_fold(*tens)
    d1, _, _ = kpart.partition_scatter(tens[0], tens[1], tens[4])
    np.testing.assert_array_equal(dest.numpy(), d1.numpy())
    m = torch.from_numpy(valid)
    d2, r2, h2 = kpart.partition_scatter(tens[0][m].contiguous(),
                                         tens[1][m].contiguous(), tens[4])
    np.testing.assert_array_equal(rank[m].numpy(), r2.numpy())
    np.testing.assert_array_equal(hist.numpy(), h2.numpy())


def test_out_of_range_keys_are_left_out_of_the_fold():
    """Keys outside [0, K) route by the clamped row (as K1 does) but add to
    no fold column, as the TPU kernel's key one-hot matches none."""
    keys, counters, vals, valid, w = _inputs(5, 500, 8, 4, "live")
    keys[::3] = 8 + np.arange(keys[::3].size) % 5       # past the table
    tk, tc, tv, tm, cdf = _torch(keys, counters, vals, valid, w)
    dest, _, hist, cnt, sums = kpart.partition_scatter_fold(tk, tc, tv, tm,
                                                            cdf)
    d1, _ = kpart.partition(tk, tc, cdf)
    np.testing.assert_array_equal(dest.numpy(), d1.numpy())
    assert int(hist.sum()) == 500
    inr = keys < 8
    np.testing.assert_array_equal(cnt.numpy(),
                                  np.bincount(keys[inr], minlength=8))
    np.testing.assert_allclose(
        sums.numpy(), np.bincount(keys[inr], weights=vals[inr], minlength=8),
        rtol=1e-5, atol=1e-5)


def test_uint8_mask_equals_bool_mask():
    args = _inputs(9, 777, 16, 6, "holes")
    tens = _torch(*args)
    a = kpart.partition_scatter_fold(*tens)
    b = kpart.partition_scatter_fold(*tens[:3], tens[3].to(torch.uint8),
                                     tens[4])
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["float16 vals", "int32 mask", "short vals",
                                 "strided mask", "int16 keys",
                                 "short int64 counters"])
def test_wrapper_rejects_bad_inputs(bad):
    tk, tc, tv, tm, cdf = _torch(*_inputs(3, 16, 4, 3, "live"))
    err = ValueError
    if bad == "float16 vals":
        tv, err = tv.half(), TypeError
    elif bad == "int32 mask":
        tm, err = tm.to(torch.int32), TypeError
    elif bad == "short vals":
        tv = tv[:-1].clone()
    elif bad == "strided mask":
        tm = torch.stack([tm, tm], dim=1)[:, 0]
    elif bad == "int16 keys":
        tk, err = tk.to(torch.int16), TypeError
    elif bad == "short int64 counters":
        tc = tc[:-1].long()
    with pytest.raises(err):
        kpart.partition_scatter_fold(tk, tc, tv, tm, cdf)


def _wide(seed, n, num_keys):
    """int64 keys, many far outside int32's range (some wrap into [0, K),
    some to negative or past K), int64 counters likewise, and float64 vals
    that round to float32: most between two float32 values, some exactly
    halfway (ties go to even), some below float32's normal range."""
    rng = np.random.default_rng(seed)
    keys = (rng.integers(0, num_keys + 3, n)
            + rng.integers(-3, 4, n) * 2**32).astype(np.int64)
    keys[::7] = rng.integers(-2**62, 2**62, keys[::7].size)
    counters = rng.integers(-2**40, 2**40, n).astype(np.int64)
    base = rng.uniform(-8.0, 8.0, n).astype(np.float32).astype(np.float64)
    ulp = np.spacing(np.abs(base).astype(np.float32)).astype(np.float64)
    vals = base + ulp * rng.uniform(-0.5, 0.5, n)
    vals[::5] = base[::5] + ulp[::5] / 2                 # a tie
    vals[::11] = rng.uniform(-1.0, 1.0, vals[::11].size) * 2.0**-140
    return keys, counters, vals


@pytest.mark.parametrize("form", ["int64 keys", "int64 counters",
                                  "no counters", "float64 vals", "all wide"])
@pytest.mark.parametrize("n", [1, 700, 4097])
def test_wide_inputs_equal_cast_inputs(n, form):
    """K2 takes the resident plane's columns as they are: int64 keys and
    counters, None for zero counters, float64 vals.  Its plain version
    gives, bit for bit, what it gives on the columns cast first
    (``.to(torch.int32)`` wraps as numpy's astype does;
    ``.to(torch.float32)`` rounds to nearest even), and the Pallas kernel
    in interpret mode agrees on the cast columns."""
    num_keys, num_workers = 40, 20
    keys64, ctr64, vals64 = _wide(n + len(form), n, num_keys)
    _, _, _, valid, w = _inputs(n, n, num_keys, num_workers, "holes")
    cdf = saturated_cdf32(torch.from_numpy(w))
    k32, c32, v32 = (keys64.astype(np.int32), ctr64.astype(np.int32),
                     vals64.astype(np.float32))
    keys = keys64 if form in ("int64 keys", "all wide") else k32
    counters = {"int64 counters": ctr64, "no counters": None,
                "all wide": None}.get(form, c32)
    vals = vals64 if form in ("float64 vals", "all wide") else v32
    cast = (k32, np.zeros(n, np.int32) if counters is None else c32, v32)
    tvalid = torch.from_numpy(valid)
    got = kpart.partition_scatter_fold(
        torch.from_numpy(keys),
        None if counters is None else torch.from_numpy(counters),
        torch.from_numpy(vals), tvalid, cdf)
    want = kpart.partition_scatter_fold(*map(torch.from_numpy, cast), tvalid,
                                        cdf)
    for g, p in zip(got, want):
        assert g.dtype == p.dtype and torch.equal(g, p)
    _assert_same([x.numpy() for x in got], jops.partition_scatter_fold(
        *map(jnp.asarray, cast), jnp.asarray(w, jnp.float32),
        valid=jnp.asarray(valid, jnp.int32), cdf=jnp.asarray(cdf.numpy())))


def test_cpu_tensors_never_count_launches():
    before = kpart.partition_scatter_fold.launches
    kpart.partition_scatter_fold(*_torch(*_inputs(4, 300, 10, 6, "holes")))
    assert kpart.partition_scatter_fold.launches == before


@pytest.mark.gpu
def test_cuda_fold_kernel_matches_plain_version():
    """K2 on the card against its plain version: integer outputs bit for
    bit, sums within c * 2^-23 * sum|v| of a float64 sum (any order of c
    float32 additions is within c * 2^-24 * sum|v|), at odd sizes, every
    mask kind, one key space past the kernel's shared-memory fold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = [(1, 3, 1), (1023, 50, 20), (1025, 50, 48), (4097, 300, 64),
              (2**20 + 7, 4096, 64), (70_000, 30_000, kpart.MAX_WORKERS)]
    for seed, (n, num_keys, num_workers) in enumerate(shapes):
        for mask in MASKS:
            args = _inputs(seed, n, num_keys, num_workers, mask)
            tens = [x.cuda() for x in _torch(*args)]
            launches = kpart.partition_scatter_fold.launches
            got = kpart.partition_scatter_fold(*tens)
            assert kpart.partition_scatter_fold.launches == launches + 1
            want = tref.partition_scatter_fold(*tens)
            for g, p in zip(got[:4], want[:4]):
                assert torch.equal(g, p), (n, num_keys, num_workers, mask)
            keys, _, vals, valid, _ = tens
            slot = torch.where(valid, keys.long(), 0)
            v64 = torch.where(valid, vals.double(), 0.0)
            exact = torch.zeros(num_keys, dtype=torch.float64,
                                device="cuda").index_add_(0, slot, v64)
            sumabs = torch.zeros_like(exact).index_add_(0, slot, v64.abs())
            tol = got[3].double() * 2.0**-23 * sumabs
            assert bool(((got[4].double() - exact).abs() <= tol).all())
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_one_and_multi_tile_fold_kernels():
    """K2's one-block kernel (N <= 4096) and its one-pass multi-tile kernel
    on both sides of the tile, at the main paths' worker counts and the
    widest table, every mask kind, and with the resident plane's wide
    columns (int64 keys and counters, None, float64 vals): integer outputs
    bit for bit against the plain version, sums within c * 2^-23 * sum|v|
    of a float64 sum of the float32 values."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seed = 0
    for n in (1, 4095, 4096, 4097):
        for num_workers in (1, 20, 48, 64, kpart.MAX_WORKERS):
            for mask in MASKS + ("wide",):
                seed += 1
                args = _inputs(seed, n, 300, num_workers,
                               "holes" if mask == "wide" else mask)
                tens = [x.cuda() for x in _torch(*args)]
                if mask == "wide":
                    keys64, _, vals64 = _wide(seed, n, 300)
                    tens[0] = torch.from_numpy(keys64).cuda()
                    tens[1] = None
                    tens[2] = torch.from_numpy(vals64).cuda()
                launches = kpart.partition_scatter_fold.launches
                got = kpart.partition_scatter_fold(*tens)
                assert kpart.partition_scatter_fold.launches == launches + 1
                want = tref.partition_scatter_fold(*tens)
                for g, p in zip(got[:4], want[:4]):
                    assert torch.equal(g, p), (n, num_workers, mask)
                keys = tens[0].to(torch.int32).long()
                live = tens[3] & (keys >= 0) & (keys < 300)
                slot = torch.where(live, keys, 0)
                v64 = torch.where(live, tens[2].float().double(), 0.0)
                exact = torch.zeros(300, dtype=torch.float64,
                                    device="cuda").index_add_(0, slot, v64)
                sumabs = torch.zeros_like(exact).index_add_(0, slot,
                                                            v64.abs())
                tol = got[3].double() * 2.0**-23 * sumabs
                assert bool(((got[4].double() - exact).abs() <= tol).all())
    torch.cuda.synchronize()
