"""Routing primitives of the PyTorch port against the JAX package.

``repro_torch.core.ops`` (torch) is held bit for bit against
``repro.core.ops`` (jnp) and the numpy host rule of
``repro.core.partitioner`` on the same numpy inputs.  Every output is an
integer or a float32 computed by the same exact rule, so every comparison
is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ops as jops
from repro.core.partitioner import RoutingTable, ld_thresholds, routing_cdf32
from repro.kernels import ref as jref
from repro_torch.core import ops as tops

WRAP_COUNTERS = np.array([0, 1, 2**31 - 1, -1, 2**32 - 1, 2**32, 2**24 + 3,
                          -(2**31)], dtype=np.int64)


def _weights(rng, num_keys, num_workers):
    """Dirichlet rows, one-hot rows, zero-weight tails and an empty row."""
    w = rng.dirichlet(np.ones(num_workers), num_keys)
    w[1] = 0.0
    w[1, num_workers // 2] = 1.0                     # one-hot
    w[2, num_workers // 2:] = 0.0                    # zero-weight tail
    w[2] /= w[2].sum()
    w[3] = 0.0                                       # no mass at all
    w[4, : num_workers - 1] = 0.0                    # one-hot last column
    w[4, -1] = 1.0
    return w


def test_ld_thresholds_wrapping_counters_match_numpy():
    rng = np.random.default_rng(0)
    c = np.concatenate([WRAP_COUNTERS, rng.integers(-2**40, 2**40, 500)])
    got = tops.ld_thresholds(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, ld_thresholds(c))


def test_ld_thresholds_int32_match_jnp():
    rng = np.random.default_rng(1)
    c = np.concatenate([WRAP_COUNTERS.astype(np.int32),
                        rng.integers(-2**31, 2**31 - 1, 500).astype(np.int32)])
    got = tops.ld_thresholds(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.ld_thresholds(jnp.asarray(c))))
    assert got.dtype == np.float32 and got.min() >= 0 and got.max() < 1


@pytest.mark.parametrize("seed", range(4))
def test_saturated_cdf32_matches_numpy_and_jnp(seed):
    rng = np.random.default_rng(seed)
    w = _weights(rng, 24, int(rng.integers(2, 50)))
    got = tops.saturated_cdf32(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got, routing_cdf32(w))
    np.testing.assert_array_equal(got, np.asarray(jref.saturated_cdf32_seq(jnp.asarray(w))))
    # repro.core.ops.saturated_cdf32 sums with jnp.cumsum, which XLA
    # reassociates (its docstring says so): the saturated entries agree
    # exactly and the partial sums to float32 rounding of a 50-term sum.
    cumsum_twin = np.asarray(jops.saturated_cdf32(jnp.asarray(w)))
    np.testing.assert_array_equal(got == 1.0, cumsum_twin == 1.0)
    np.testing.assert_allclose(got, cumsum_twin, rtol=1e-6, atol=0)


@pytest.mark.parametrize("seed", range(4))
def test_route_records_matches_host_table_and_jnp(seed):
    rng = np.random.default_rng(10 + seed)
    num_keys, num_workers = 24, int(rng.integers(2, 40))
    rt = RoutingTable(num_keys, num_workers)
    w = _weights(rng, num_keys, num_workers)
    w[3] = rt.weights[3]                             # tables keep stochastic rows
    rt.restore_keys(range(num_keys), w)
    keys = rng.integers(0, num_keys, 2000)
    counters = np.concatenate([WRAP_COUNTERS, rng.integers(0, 2**32, 1992)])
    got = tops.route_records(torch.from_numpy(rt.weights), torch.from_numpy(keys),
                             torch.from_numpy(counters),
                             cdf=torch.from_numpy(rt.cdf32)).numpy()
    np.testing.assert_array_equal(got, rt.route_lowdiscrepancy(keys, counters))
    want = jops.route_records(jnp.asarray(rt.weights), jnp.asarray(keys.astype(np.int32)),
                              jnp.asarray(counters.astype(np.int32)),
                              cdf=jnp.asarray(rt.cdf32))
    np.testing.assert_array_equal(got, np.asarray(want))
    # without a cdf the port derives it, as the jnp twin does
    derived = tops.route_records(torch.from_numpy(rt.weights), torch.from_numpy(keys),
                                 torch.from_numpy(counters)).numpy()
    np.testing.assert_array_equal(derived, got)


@pytest.mark.parametrize("seed", range(3))
def test_within_dest_ranks_and_per_key_counters_match_jnp(seed):
    rng = np.random.default_rng(20 + seed)
    n, num_workers = int(rng.integers(1, 3000)), int(rng.integers(1, 40))
    dest = rng.integers(0, num_workers, n).astype(np.int32)
    valid = (rng.random(n) < 0.7).astype(np.int32)
    got = tops.within_dest_ranks(torch.from_numpy(dest), num_workers).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.within_dest_ranks(jnp.asarray(dest), num_workers)))
    got_v = tops.within_dest_ranks(torch.from_numpy(dest), num_workers,
                                   valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(
        got_v, np.asarray(jops.within_dest_ranks(jnp.asarray(dest), num_workers,
                                                 valid=jnp.asarray(valid))))
    got_k = tops.per_key_counters(torch.from_numpy(dest), num_workers).numpy()
    np.testing.assert_array_equal(
        got_k, np.asarray(jops.per_key_counters(jnp.asarray(dest), num_workers)))
    assert got.dtype == got_v.dtype == got_k.dtype == np.int32


def test_within_dest_ranks_empty():
    out = tops.within_dest_ranks(torch.zeros(0, dtype=torch.int32), 4)
    assert out.shape == (0,) and out.dtype == torch.int32


def test_worker_load_and_queue_sizes_match_jnp():
    rng = np.random.default_rng(30)
    # dyadic weights and integer counts: every sum is exact in any order
    w = rng.integers(0, 5, (16, 6)).astype(np.float32) / 4.0
    counts = rng.integers(0, 1000, 16).astype(np.int32)
    got = tops.worker_load_from_routing(torch.from_numpy(w), torch.from_numpy(counts))
    want = jops.worker_load_from_routing(jnp.asarray(w), jnp.asarray(counts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    received = rng.integers(0, 100, 32).astype(np.int32)
    processed = rng.integers(0, 100, 32).astype(np.int32)
    got_q = tops.queue_sizes(torch.from_numpy(received), torch.from_numpy(processed))
    want_q = jops.queue_sizes(jnp.asarray(received), jnp.asarray(processed))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
