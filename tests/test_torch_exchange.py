"""The port's per-chunk exchange against the JAX package's numpy plane.

``TorchPartitionBackend(device="cpu")`` runs the kernels' plain PyTorch
versions; it is held against ``repro.dataflow.exchange.NumpyPartitionBackend``
on two independent routing tables (one per package) with identical weights
and rewrites, so each side advances its own per-key counters.  Every output
is an integer: comparisons are exact.
"""
import numpy as np
import pytest
import torch

from repro.core.partitioner import RoutingTable as JaxTable
from repro.dataflow import build_w1 as jax_build_w1
from repro.dataflow.exchange import NumpyPartitionBackend
from repro_torch.core.partitioner import RoutingTable, routing_table_from_numpy
from repro_torch.dataflow import Engine, build_w1
from repro_torch.dataflow.exchange import (
    Exchange,
    TorchPartitionBackend,
    get_backend,
)
from repro_torch.kernels import partition as kpart


def _tables(num_keys=12, num_workers=6):
    """The same table in both packages: two splits and a move."""
    out = []
    for cls in (JaxTable, RoutingTable):
        rt = cls(num_keys, num_workers)
        rt.split_key(0, [0, 1], [0.5, 0.5])
        rt.split_key(3, [2, 3, 4], [0.25, 0.25, 0.5])
        rt.move_key(7, 5)
        out.append(rt)
    return out


def _rank_of(plan):
    """Within-destination rank of each record, from any plan form."""
    order = plan.gather_indices()
    if order is None:
        order = np.arange(plan.dest.size)
    pos = np.empty(plan.dest.size, dtype=np.int64)
    pos[order] = np.arange(plan.dest.size)
    return pos - plan.bounds[plan.dest]


def _assert_plans_equal(p_np, p_t, keys):
    np.testing.assert_array_equal(p_np.dest, p_t.dest)
    np.testing.assert_array_equal(p_np.hist, p_t.hist)
    np.testing.assert_array_equal(p_np.bounds, p_t.bounds)
    np.testing.assert_array_equal(p_np.take(keys), p_t.take(keys))
    vals = np.arange(keys.size, dtype=np.float64)
    np.testing.assert_array_equal(p_np.take(vals), p_t.take(vals))
    np.testing.assert_array_equal(_rank_of(p_np), _rank_of(p_t))
    assert p_t.dest.dtype == p_t.hist.dtype == np.int64


@pytest.mark.parametrize("n", [1, 37, 256, 1000, 5000])
def test_destinations_histogram_and_placement_match_numpy(n):
    rt_np, rt_t = _tables()
    be_np, be_t = NumpyPartitionBackend(), TorchPartitionBackend("cpu")
    keys = np.random.default_rng(n).integers(0, rt_np.num_keys, n).astype(np.int64)
    d1, h1 = be_np.partition(rt_np, keys)
    d2, h2 = be_t.partition(rt_t, keys)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(h1, h2)
    assert int(h2.sum()) == n
    _assert_plans_equal(be_np.partition_scatter(rt_np, keys),
                        be_t.partition_scatter(rt_t, keys), keys)
    np.testing.assert_array_equal(rt_np._count, rt_t._count)


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097])
def test_scatter_plan_on_both_sides_of_one_tile(n):
    """K1 runs on one block up to 4096 records and in one multi-tile pass
    above; the exchange reads its packed output back in one copy and
    splits it on the host.  The plan equals the numpy backend's on both
    sides of the tile, over a wide table with split keys."""
    rt_np, rt_t = _tables(num_keys=300, num_workers=48)
    be_np, be_t = NumpyPartitionBackend(), TorchPartitionBackend("cpu")
    keys = np.random.default_rng(n).integers(0, 300, n).astype(np.int64)
    for _ in range(2):          # the second chunk continues the counters
        _assert_plans_equal(be_np.partition_scatter(rt_np, keys),
                            be_t.partition_scatter(rt_t, keys), keys)
    np.testing.assert_array_equal(rt_np._count, rt_t._count)


def test_agreement_across_midstream_rewrites():
    rng = np.random.default_rng(8)
    rt_np, rt_t = _tables()
    be_np, be_t = NumpyPartitionBackend(), TorchPartitionBackend("cpu")
    for _ in range(4):
        keys = rng.integers(0, rt_np.num_keys, 300).astype(np.int64)
        _assert_plans_equal(be_np.partition_scatter(rt_np, keys),
                            be_t.partition_scatter(rt_t, keys), keys)
        for rt in (rt_np, rt_t):                  # mid-stream rewrite
            rt.split_key(0, [0, 1, 2], [0.2, 0.3, 0.5])
            rt.redirect_worker(2, 3)
    np.testing.assert_array_equal(rt_np._count, rt_t._count)


@pytest.mark.parametrize("seed", range(6))
def test_random_tables_and_rewrites_match_numpy(seed):
    rng = np.random.default_rng(seed)
    num_keys, num_workers = int(rng.integers(1, 40)), int(rng.integers(1, 12))
    rt_np, rt_t = JaxTable(num_keys, num_workers), RoutingTable(num_keys, num_workers)
    be_np, be_t = NumpyPartitionBackend(), TorchPartitionBackend("cpu")
    for _ in range(3):
        for _ in range(int(rng.integers(0, 4))):  # the same random rewrites
            k = int(rng.integers(0, num_keys))
            m = min(num_workers, int(rng.integers(1, 4)))
            ws = [int(w) for w in rng.choice(num_workers, size=m, replace=False)]
            fr = rng.dirichlet(np.ones(m))
            for rt in (rt_np, rt_t):
                if m == 1:
                    rt.move_key(k, ws[0])
                else:
                    rt.split_key(k, ws, fr)
        n = int(rng.integers(1, 2000))
        keys = rng.integers(0, num_keys, n).astype(np.int64)
        _assert_plans_equal(be_np.partition_scatter(rt_np, keys),
                            be_t.partition_scatter(rt_t, keys), keys)


def test_exchange_send_conserves_and_counts():
    rt = RoutingTable(4, 4)
    rt.split_key(0, [0, 1], [0.3, 0.7])

    class Collect:
        num_workers = 4
        arrived_by_key = None

        def __init__(self):
            self.got = np.zeros(4, dtype=np.int64)

        def receive_sorted(self, keys, vals, bounds):
            self.got += np.diff(bounds)

    op = Collect()
    ex = Exchange(rt, op, "torch", device="cpu")
    ex.send((np.zeros(4000, dtype=np.int64), np.ones(4000)))
    rt.split_key(0, [2, 3], [0.6, 0.4])
    ex.send((np.zeros(6000, dtype=np.int64), np.ones(6000)))
    np.testing.assert_array_equal(op.got, ex.sent_per_worker)
    assert ex.tuples_sent == 10_000 == int(op.got.sum())
    ideal = np.array([1200, 2800, 3600, 2400])
    assert np.abs(op.got - ideal).max() < 32


def test_device_cdf_cache_follows_rewrites_and_restores():
    """The cache is keyed by the host cdf32 array, not by ``version``: a
    restore that rewinds ``version`` with other weights must not reuse the
    stale device copy."""
    rt_np, rt_t = _tables()
    be_np, be_t = NumpyPartitionBackend(), TorchPartitionBackend("cpu")
    keys = np.random.default_rng(1).integers(0, 12, 500).astype(np.int64)
    _assert_plans_equal(be_np.partition_scatter(rt_np, keys),
                        be_t.partition_scatter(rt_t, keys), keys)
    first = be_t._device_cdf(rt_t)
    for rt in (rt_np, rt_t):                      # a checkpoint-style restore
        version = rt.version
        rt.weights[0] = 0.0
        rt.weights[0, 5] = 1.0
        rt.weights[3] = [0.0, 0.0, 0.0, 0.0, 0.5, 0.5]
        rt.version = version
        rt.invalidate_cache()
    _assert_plans_equal(be_np.partition_scatter(rt_np, keys),
                        be_t.partition_scatter(rt_t, keys), keys)
    assert be_t._device_cdf(rt_t) is not first
    assert be_t._device_cdf(rt_t) is be_t._device_cdf(rt_t)
    np.testing.assert_array_equal(be_t._device_cdf(rt_t).numpy(), rt_t.cdf32)


def test_backend_registry_and_device_of_resolved_backends():
    assert isinstance(get_backend("torch", "cpu"), TorchPartitionBackend)
    assert get_backend("torch", "cpu").device == torch.device("cpu")
    assert get_backend("numpy", "cpu").name == "numpy"
    be = TorchPartitionBackend("cpu")
    assert get_backend(be) is be
    eng = Engine(partition_backend="torch", device="cpu")
    assert eng.partition_backend.name == "torch"
    with pytest.raises(ValueError):
        get_backend("pallas", "cpu")


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the cuda default is served")
    for make in (TorchPartitionBackend, Engine, lambda: get_backend(None),
                 lambda: build_w1(scale=0.01)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_routing_state_carried_across_from_the_jax_package():
    """Run the JAX package's W1 until Reshape has split CA's key, hand the
    edge's table to the port, and route the next 20 chunks through both."""
    wf = jax_build_w1(strategy="reshape", scale=0.03, num_workers=16,
                      service_rate=4, partition_backend="numpy")
    rt = wf.edges[0].routing
    ca = wf.meta["ca"]
    while np.count_nonzero(rt.weights[ca]) < 2:
        assert not wf.engine.done(), "the controller never split CA's key"
        wf.engine.run_tick()
    state = {name: np.array(getattr(rt, name))
             for name in ("weights", "owner", "_count", "_credit", "version")}
    rt_np, rt_t = rt.copy(), routing_table_from_numpy(state)
    assert rt_t.version == rt.version
    np.testing.assert_array_equal(rt_t.cdf32, rt_np.cdf32)
    src = wf.engine.sources[0]
    be_np, be_t = NumpyPartitionBackend(), TorchPartitionBackend("cpu")
    launches = kpart.partition_scatter.launches
    for i in range(20):
        start = src.pos + i * src.emit_rate
        keys = src.keys[start:start + src.emit_rate]
        assert keys.size > 0
        _assert_plans_equal(be_np.partition_scatter(rt_np, keys),
                            be_t.partition_scatter(rt_t, keys), keys)
    np.testing.assert_array_equal(rt_np._count, rt_t._count)
    assert rt_t._count[ca] > state["_count"][ca]       # the split key advanced
    assert kpart.partition_scatter.launches == launches   # CPU: plain version
