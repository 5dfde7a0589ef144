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
from repro_torch.core.ops import saturated_cdf32
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
