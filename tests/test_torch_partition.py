"""Partition kernels K1 (``partition_scatter``) and K3 (``partition``).

On the CPU the port's wrappers run their plain PyTorch versions; these are
held bit for bit against the Pallas kernels of ``repro.kernels.partition``
in interpret mode (``block_n=256``, so chunks of several blocks exercise
the TPU kernel's cross-block carry) and against ``repro.kernels.ref``, on
the same numpy inputs.  The ``gpu`` test holds each CUDA kernel against its
plain version on the card; it skips without one.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core.ops import ld_thresholds, saturated_cdf32
from repro_torch.core.partitioner import routing_cdf32
from repro_torch.kernels import partition as kpart
from repro_torch.kernels import ref as tref

jpart = importlib.import_module("repro.kernels.partition")


def _inputs(seed, n, num_keys, num_workers, split_frac=0.5):
    """Keys, wrapping counters and a table of one-hot and split rows."""
    rng = np.random.default_rng(seed)
    w = np.zeros((num_keys, num_workers))
    w[np.arange(num_keys), rng.integers(0, num_workers, num_keys)] = 1.0
    split = rng.random(num_keys) < split_frac
    w[split] = rng.dirichlet(np.ones(num_workers), int(split.sum()))
    keys = rng.integers(0, num_keys, n).astype(np.int32)
    counters = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    return keys, counters, w


def _torch(keys, counters, w):
    cdf = saturated_cdf32(torch.from_numpy(w))
    return torch.from_numpy(keys), torch.from_numpy(counters), cdf


#: Float64 weights whose float32 row-CDF rounds above 1 before the last
#: positive column: [.., 0.9544028, 1.0000001, 1.0].
ROUNDS_ABOVE_ONE = [2.9226431534880243e-01, 9.3378590947111456e-03,
                    1.3774107888430048e-01, 1.0934441588710811e-01,
                    4.0571506790850898e-01, 4.5597261426568905e-02,
                    1.45e-09]


def _adversarial_weights(seed, num_workers):
    """Non-negative weight rows of every kind a routing table can hold: a
    row whose float32 CDF rounds above 1 before its last positive column
    (alone, with zero columns between its weights, and after them), a
    tiny last weight, zero columns between and after live ones, all-zero
    rows, one live column (first, middle, last) and dense rows."""
    rng = np.random.default_rng(seed)
    W = num_workers
    rows = [np.zeros(W)]
    for col in sorted({0, W // 2, W - 1}):
        rows.append(np.eye(W)[col])
    if W >= 7:
        for spread in (1, 2, W // 7):
            row = np.zeros(W)
            row[np.arange(7) * spread] = ROUNDS_ABOVE_ONE
            rows.append(row)
    for _ in range(4):
        row = np.zeros(W)
        live = rng.choice(W, size=min(W, 3), replace=False)
        row[live] = rng.dirichlet(np.ones(live.size))
        rows.append(row)
        rows.append(rng.dirichlet(np.ones(W)))
        tiny = rng.dirichlet(np.ones(W)) * (1 - 1e-9)
        tiny[-1] = 1e-9
        rows.append(tiny)
    return np.array(rows)


def _counters_for(u_ints):
    """int32 counters whose Weyl threshold is exactly ``u_ints * 2^-24``
    (the threshold's bits are ``(c + 1) * GOLDEN mod 2^32``; GOLDEN is odd,
    so invertible mod 2^32)."""
    inv = pow(2654435769, -1, 2**32)
    bits = np.asarray(u_ints, dtype=object) * 256
    return np.array([(int(b) * inv - 1) % 2**32 for b in bits],
                    dtype=np.uint32).view(np.int32)


def _search(rows, u):
    """dest by binary lifting over each row: the longest prefix whose
    entries are all <= u, clipped to the last worker."""
    W = rows.shape[1]
    d = np.zeros(len(u), dtype=np.int64)
    step = 1 << (W.bit_length() - 1)
    while step:
        probe = d + step
        ok = probe <= W
        ok[ok] = rows[np.flatnonzero(ok), probe[ok] - 1] <= u[ok]
        d[ok] = probe[ok]
        step >>= 1
    return np.minimum(d, W - 1)


@pytest.mark.parametrize("table", ["routing_cdf32", "saturated_cdf32"])
@pytest.mark.parametrize("num_workers", [1, 2, 63, 64, 1024])
def test_cdf_rows_hold_the_search_prefix_property(table, num_workers):
    """The kernels route by binary search (``csrc/partition.cu``).  For a
    table of non-negative weights, saturated from each row's last positive
    column, and a threshold u < 1, ``cdf[w] <= u`` holds on a prefix of
    every row, even where the row decreases; so a search equals the plain
    count, at u = 0, u = 1 - 2^-24 and on both sides of every entry."""
    w = _adversarial_weights(num_workers, num_workers)
    if table == "routing_cdf32":
        cdf = routing_cdf32(w)
    else:
        cdf = saturated_cdf32(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(cdf, routing_cdf32(w))
    if num_workers >= 7:
        assert (np.diff(cdf, axis=1) < 0).any()      # not monotone
    cols = np.arange(num_workers)
    for r, row in enumerate(cdf):
        near = np.floor(row.astype(np.float64) * 2**24)[None, :] + [[-1], [0],
                                                                    [1]]
        u_ints = np.unique(np.clip(np.r_[near.ravel(), 0, 2**24 - 1], 0,
                                   2**24 - 1)).astype(np.int64)
        u = (u_ints * 2.0**-24).astype(np.float32)
        holds = row[None, :] <= u[:, None]
        count = holds.sum(axis=1)
        np.testing.assert_array_equal(holds, cols[None, :] < count[:, None])
        searched = _search(np.repeat(row[None, :], u.size, 0), u)
        np.testing.assert_array_equal(searched,
                                      np.minimum(count, num_workers - 1))
        keys = torch.full((u.size,), r, dtype=torch.int32)
        counters = torch.from_numpy(_counters_for(u_ints))
        np.testing.assert_array_equal(ld_thresholds(counters).numpy(), u)
        dest, _ = kpart.partition(keys, counters, torch.from_numpy(cdf))
        np.testing.assert_array_equal(dest.numpy(), searched)


def _stable_positions(dest):
    """pos = bounds[dest] + rank must be the inverse stable argsort."""
    order = np.argsort(dest, kind="stable")
    inv = np.empty(dest.size, dtype=np.int64)
    inv[order] = np.arange(dest.size)
    return inv


@pytest.mark.parametrize("n", [0, 1, 255, 256, 700, 2049])
def test_partition_scatter_matches_pallas_interpret_and_ref(n):
    keys, counters, w = _inputs(n, n, 40, 24)
    tk, tc, cdf = _torch(keys, counters, w)
    dest, rank, hist = (x.numpy() for x in kpart.partition_scatter(tk, tc, cdf))
    jargs = (jnp.asarray(keys), jnp.asarray(counters), jnp.asarray(w))
    pd, pr, ph = jpart.partition_scatter(*jargs, cdf=jnp.asarray(cdf.numpy()),
                                         block_n=256, interpret=True)
    rd, rr, rh = jref.partition_scatter(*jargs, cdf=jnp.asarray(cdf.numpy()))
    for got, pallas, oracle in ((dest, pd, rd), (rank, pr, rr), (hist, ph, rh)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(pallas))
        np.testing.assert_array_equal(got, np.asarray(oracle))
    assert hist.shape == (24,) and int(hist.sum()) == n
    np.testing.assert_array_equal(np.r_[0, np.cumsum(hist)][dest] + rank,
                                  _stable_positions(dest))


@pytest.mark.parametrize("n", [0, 1, 255, 256, 700, 2049])
def test_partition_matches_pallas_interpret_and_ref(n):
    keys, counters, w = _inputs(100 + n, n, 40, 24)
    tk, tc, cdf = _torch(keys, counters, w)
    dest, hist = (x.numpy() for x in kpart.partition(tk, tc, cdf))
    jargs = (jnp.asarray(keys), jnp.asarray(counters), jnp.asarray(w))
    pd, ph = jpart.partition(*jargs, cdf=jnp.asarray(cdf.numpy()), block_n=256,
                             interpret=True)
    rd, rh = jref.partition(*jargs, cdf=jnp.asarray(cdf.numpy()))
    for got, pallas, oracle in ((dest, pd, rd), (hist, ph, rh)):
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, np.asarray(pallas))
        np.testing.assert_array_equal(got, np.asarray(oracle))
    np.testing.assert_array_equal(hist, np.bincount(dest, minlength=24))


@pytest.mark.parametrize("seed", range(5))
def test_partition_properties_against_jnp_oracle(seed):
    """Port of the kernel-suite properties: random tables, several block
    widths of records, destinations and histogram equal to the oracle,
    every record landing on exactly one worker, and ranks reproducing a
    stable sort by destination."""
    rng = np.random.default_rng(1000 + seed)
    num_keys, num_workers = int(rng.integers(2, 41)), int(rng.integers(2, 33))
    n = int(rng.integers(1, 4)) * 256 + int(rng.integers(0, 256))
    keys = rng.integers(0, num_keys, n).astype(np.int32)
    counters = rng.integers(0, 10_000, n).astype(np.int32)
    w = rng.dirichlet(np.ones(num_workers), num_keys)
    tk, tc, cdf = _torch(keys, counters, w)
    d1, h1 = (x.numpy() for x in kpart.partition(tk, tc, cdf))
    d2, r2, h2 = (x.numpy() for x in kpart.partition_scatter(tk, tc, cdf))
    jd, jr, jh = jref.partition_scatter(jnp.asarray(keys), jnp.asarray(counters),
                                        jnp.asarray(w), cdf=jnp.asarray(cdf.numpy()))
    np.testing.assert_array_equal(d1, np.asarray(jd))
    np.testing.assert_array_equal(h1, np.asarray(jh))
    np.testing.assert_array_equal(d2, d1)
    np.testing.assert_array_equal(h2, h1)
    np.testing.assert_array_equal(r2, np.asarray(jr))
    assert int(h1.sum()) == n
    np.testing.assert_array_equal(np.r_[0, np.cumsum(h2)][d2] + r2,
                                  _stable_positions(d2))


def test_partition_one_hot_routing_is_exact():
    """With a one-hot table the kernel is plain hash partitioning."""
    num_keys, num_workers, n = 8, 4, 512
    w = np.zeros((num_keys, num_workers))
    w[np.arange(num_keys), np.arange(num_keys) % num_workers] = 1.0
    keys = np.random.default_rng(0).integers(0, num_keys, n).astype(np.int32)
    tk, tc, cdf = _torch(keys, np.zeros(n, np.int32), w)
    dest, _ = kpart.partition(tk, tc, cdf)
    np.testing.assert_array_equal(dest.numpy(), keys % num_workers)


def test_out_of_range_keys_are_clamped():
    keys, counters, w = _inputs(7, 64, 5, 3, split_frac=1.0)
    tk, tc, cdf = _torch(keys, counters, w)
    wild = tk.clone()
    wild[::2] = torch.where(wild[::2] % 2 == 0, torch.tensor(-7, dtype=torch.int32),
                            torch.tensor(99, dtype=torch.int32))
    d_wild, _ = kpart.partition(wild, tc, cdf)
    d_clamped, _ = kpart.partition(wild.clamp(0, 4), tc, cdf)
    np.testing.assert_array_equal(d_wild.numpy(), d_clamped.numpy())


@pytest.mark.parametrize("bad", ["int64 keys", "float64 cdf", "shape", "too wide",
                                 "strided", "devices"])
def test_wrappers_reject_bad_inputs(bad):
    keys, counters, w = _inputs(3, 16, 4, 3)
    tk, tc, cdf = _torch(keys, counters, w)
    err = ValueError
    if bad == "int64 keys":
        tk, err = tk.long(), TypeError
    elif bad == "float64 cdf":
        cdf, err = cdf.double(), TypeError
    elif bad == "shape":
        tc = tc[:-1].clone()
    elif bad == "too wide":
        cdf = torch.zeros((4, kpart.MAX_WORKERS + 1), dtype=torch.float32)
    elif bad == "strided":
        tk, tc = tk[::2], tc[::2]
    elif bad == "devices":
        cdf = cdf.to("meta")
    for fn in (kpart.partition, kpart.partition_scatter):
        with pytest.raises(err):
            fn(tk, tc, cdf)


def test_cpu_tensors_never_count_launches():
    keys, counters, w = _inputs(5, 300, 10, 6)
    before = (kpart.partition_scatter.launches, kpart.partition.launches)
    kpart.partition_scatter(*_torch(keys, counters, w))
    kpart.partition(*_torch(keys, counters, w))
    assert (kpart.partition_scatter.launches, kpart.partition.launches) == before


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """K1 and K3 on the card, bit for bit against their plain versions,
    at odd sizes, several widths and the widest table the kernels take."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    shapes = [(1, 3, 1), (1023, 50, 20), (1025, 50, 48), (4097, 300, 64),
              (2**20 + 7, 4096, 64), (70_000, 1000, kpart.MAX_WORKERS)]
    for seed, (n, num_keys, num_workers) in enumerate(shapes):
        keys, counters, w = _inputs(seed, n, num_keys, num_workers, split_frac=0.3)
        tk, tc, cdf = (x.cuda() for x in _torch(keys, counters, w))
        launches = kpart.partition_scatter.launches
        got = kpart.partition_scatter(tk, tc, cdf)
        assert kpart.partition_scatter.launches == launches + 1
        want = tref.partition_scatter(tk, tc, cdf)
        for g, p in zip(got, want):
            assert torch.equal(g, p), (n, num_keys, num_workers)
        got = kpart.partition(tk, tc, cdf)
        want = tref.partition(tk, tc, cdf)
        for g, p in zip(got, want):
            assert torch.equal(g, p), (n, num_keys, num_workers)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_one_and_multi_tile_kernels():
    """K1's one-block kernel (N <= 4096) and its one-pass multi-tile kernel
    on both sides of the tile, and K3, at the main paths' worker counts and
    the widest table, on the adversarial tables: bit for bit against the
    plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (1, 4095, 4096, 4097):
        for num_workers in (1, 20, 48, 64, kpart.MAX_WORKERS):
            cdf = saturated_cdf32(torch.from_numpy(
                _adversarial_weights(n, num_workers))).cuda()
            rng = np.random.default_rng(n + num_workers)
            keys = torch.from_numpy(rng.integers(
                0, cdf.shape[0], n).astype(np.int32)).cuda()
            counters = torch.from_numpy(_counters_for(
                rng.integers(0, 2**24, n))).cuda()
            launches = kpart.partition_scatter.launches
            got = kpart.partition_scatter(keys, counters, cdf)
            assert kpart.partition_scatter.launches == launches + 1
            want = tref.partition_scatter(keys, counters, cdf)
            for g, p in zip(got, want):
                assert torch.equal(g, p), (n, num_workers)
            for g, p in zip(kpart.partition(keys, counters, cdf),
                            tref.partition(keys, counters, cdf)):
                assert torch.equal(g, p), (n, num_workers)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_partition_is_one_launch_and_leaves_its_accumulator_zero():
    """K3 at one tile (N <= 4096: one block writes hist itself) and at many
    (persistent blocks fold their counts into the workspace's accumulator,
    and the last block out writes hist and zeroes it), at W in {1, 20, 64,
    1024}, called repeatedly on one stream between K1 calls that use the
    same workspace: bit for bit against the plain version every time, one
    launch a call, and the accumulator zero after every call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    index, stream = kpart._build.device_and_stream(torch.device("cuda"))
    for n in (1, 4096, 4097, 70_000, 2**20 + 7):
        for num_workers in (1, 20, 64, kpart.MAX_WORKERS):
            keys, counters, w = _inputs(n + num_workers, n, 300, num_workers,
                                        split_frac=0.3)
            tk, tc, cdf = (x.cuda() for x in _torch(keys, counters, w))
            want = tref.partition(tk, tc, cdf)
            for _ in range(3):
                launches = kpart.partition.launches
                got = kpart.partition(tk, tc, cdf)
                assert kpart.partition.launches == launches + 1
                for g, p in zip(got, want):
                    assert torch.equal(g, p), (n, num_workers)
                kpart.partition_scatter(tk, tc, cdf)
            ws = kpart._WORKSPACE.get((index, stream))
            if n > kpart.TILE_RECORDS:
                # int64 words 2 .. 2 + MAX_WORKERS / 2: the accumulator.
                acc = ws[2:2 + kpart.MAX_WORKERS // 2]
                assert int(acc.abs().sum()) == 0, (n, num_workers)
    torch.cuda.synchronize()
