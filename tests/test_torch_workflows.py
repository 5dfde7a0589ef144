"""The port's W1-W3 end to end against the JAX package.

``repro_torch.dataflow.build_w*(device="cpu")`` (the torch exchange on its
plain PyTorch versions) is held against the JAX package's numpy plane and
its ``reference=True`` tuple-at-a-time oracle: equal ticks, identical
``Sink.series`` and ``Sink.counts``, equal per-edge ``sent_per_worker``,
equal controller events field by field, identical W2 group-by state and W3
sorted output.  The two packages' classes are distinct, so events are
compared as plain values with enums by name.
"""
import dataclasses
import enum

import numpy as np
import pytest

import repro.dataflow as jdf
from repro.core import ReshapeConfig as JaxConfig
from repro_torch import dataflow as tdf
from repro_torch.core import ReshapeConfig

SIZES = {
    "w1": dict(scale=0.03, num_workers=16, service_rate=4),
    "w2": dict(n_tuples=3000, num_workers=8, service_rate=4),
    "w3": dict(n_tuples=3000, num_workers=8, service_rate=6),
}


def _plain(x):
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x.item() if isinstance(x, np.generic) else x


def _events(wf):
    return [[_plain(dataclasses.asdict(e)) for e in c.events]
            for c in wf.controllers]


def _series_equal(a, b):
    return (len(a) == len(b)
            and all(t1 == t2 and np.array_equal(c1, c2)
                    for (t1, c1), (t2, c2) in zip(a, b)))


def _assert_same_run(port, jax_wf, name):
    assert port.engine.tick == jax_wf.engine.tick
    assert _series_equal(port.sink.series, jax_wf.sink.series)
    np.testing.assert_array_equal(port.sink.counts, jax_wf.sink.counts)
    assert len(port.engine.edges) == len(jax_wf.engine.edges)
    for e1, e2 in zip(port.engine.edges, jax_wf.engine.edges):
        np.testing.assert_array_equal(e1.sent_per_worker, e2.sent_per_worker)
        assert e1.tuples_sent == e2.tuples_sent
    assert _events(port) == _events(jax_wf)
    if name == "w2":
        for pw, jw in zip(port.meta["groupby"].workers,
                          jax_wf.meta["groupby"].workers):
            assert dict(pw.state.items()) == dict(jw.state.items())
    if name == "w3":
        np.testing.assert_array_equal(port.monitored[0].sorted_output(),
                                      jax_wf.monitored[0].sorted_output())


@pytest.mark.parametrize("strategy", ["reshape", "none"])
@pytest.mark.parametrize("name", ["w1", "w2", "w3"])
def test_workflow_identical_to_numpy_plane_and_reference(name, strategy):
    kw = dict(strategy=strategy, **SIZES[name])
    port = getattr(tdf, f"build_{name}")(device="cpu", **kw)
    port.run()
    assert port.engine.partition_backend.name == "torch"
    if strategy == "reshape":
        assert port.controllers and port.controllers[0].events
    for jax_kw in (dict(partition_backend="numpy"), dict(reference=True)):
        jax_wf = getattr(jdf, f"build_{name}")(**kw, **jax_kw)
        jax_wf.run()
        _assert_same_run(port, jax_wf, name)


def test_batched_scheduler_identical_to_numpy_plane_and_reference():
    kw = dict(strategy="reshape", scale=0.02, num_workers=16, service_rate=4,
              batch_ticks=8, snapshot_every=4)
    port = tdf.build_w1(device="cpu", cfg=ReshapeConfig(metric_period=3), **kw)
    port.run()
    for jax_kw in (dict(partition_backend="numpy"), dict(reference=True)):
        jax_wf = jdf.build_w1(cfg=JaxConfig(metric_period=3), **kw, **jax_kw)
        jax_wf.run()
        _assert_same_run(port, jax_wf, "w1")
    np.testing.assert_array_equal(port.sink.counts,
                                  tdf.datasets.tweet_counts(0.02))


@pytest.mark.parametrize("name", ["w1", "w3"])
def test_port_host_plane_identical_to_torch_plane(name):
    kw = dict(strategy="reshape", **SIZES[name])
    torch_wf = getattr(tdf, f"build_{name}")(device="cpu", **kw)
    torch_wf.run()
    host = getattr(tdf, f"build_{name}")(device="cpu", partition_backend="numpy", **kw)
    host.run()
    assert host.engine.partition_backend.name == "numpy"
    _assert_same_run(torch_wf, host, name)


def test_w4_runs_on_the_port_like_the_numpy_plane():
    kw = dict(strategy="reshape", n_tuples=4000, num_workers=12)
    port = tdf.build_w4(device="cpu", **kw)
    port.run()
    jax_wf = jdf.build_w4(partition_backend="numpy", **kw)
    jax_wf.run()
    _assert_same_run(port, jax_wf, "w4")
