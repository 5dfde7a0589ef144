"""The port's device-resident exchange plane against the JAX package.

``repro_torch.dataflow.device`` runs on ``device="cpu"`` here (K2 by its
plain PyTorch version).  Every run is held against the JAX package's numpy
host plane and against the port's own per-chunk plane
(``device_executor="host"``), on the same inputs: ticks, ``Sink.series``,
``Sink.counts``, ``sent_per_worker``, the routing counters, worker
mirrors, controller events and row state (``ScopeRows``) bit for bit;
float sums ``allclose`` (the resident GroupBy folds with ``index_add_``,
and the sink adds K2's float32 per-chunk sums, so the summation order
differs).  The analogues of the JAX suite's ``tests/test_device_plane.py``
and ``tests/test_device_rowstate.py`` are named after them.  One test also
compares with the JAX jit plane under a test-scoped ``enable_x64`` shim.
"""
import jax
import jax.experimental
import numpy as np
import pytest
import torch

import repro.dataflow as jdf
import repro.dataflow.engine as jeng
import repro.dataflow.operators as jops
from repro.core import ReshapeConfig as JaxConfig
from repro_torch import dataflow as tdf
from repro_torch.core import ReshapeConfig
from repro_torch.core.ops import saturated_cdf32
from repro_torch.dataflow import device as tdev
from repro_torch.dataflow import engine as teng
from repro_torch.dataflow import operators as tops
from repro_torch.dataflow.exchange import DeviceExchange, Exchange
from repro_torch.kernels import partition as kpart

NK = 16

#: plane -> (engine module, operator module, config class, engine kwargs)
PLANES = {
    "numpy": (jeng, jops, JaxConfig, dict(partition_backend="numpy")),
    "resident": (teng, tops, ReshapeConfig,
                 dict(device="cpu", device_executor="jit")),
    "per-chunk": (teng, tops, ReshapeConfig,
                  dict(device="cpu", device_executor="host")),
}


def _series_equal(a, b):
    return (len(a) == len(b)
            and all(t1 == t2 and np.array_equal(c1, c2)
                    for (t1, c1), (t2, c2) in zip(a, b)))


def _all_pass(k, v):
    return v >= 0


def _half_pass(k, v):
    return v >= 5.0


def _proj(k, v):
    return k, v * 2.0


def _zipf_stream(n, num_keys, seed=0, hot_frac=0.0):
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n) - 1, num_keys - 1).astype(np.int64)
    if hot_frac:
        keys[rng.random(n) < hot_frac] = 0
    return keys, rng.uniform(0.0, 10.0, n)


def _fold_pipeline(plane, *, n=5000, num_keys=24, num_workers=4, chunk=8,
                   batch_ticks=4, predicate=_all_pass, project=None,
                   controller=False, hot_frac=0.0, seed=0):
    """Source -> Filter [-> Project] -> GroupByAgg -> Sink."""
    eng_mod, ops, cfg, kw = PLANES[plane]
    keys, vals = _zipf_stream(n, num_keys, seed, hot_frac)
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **kw)
    src = eng.add_source(eng_mod.Source("src", keys, vals, num_workers * chunk))
    stages = [eng.add_op(ops.Filter("filter", num_workers, num_workers * chunk,
                                    predicate=predicate))]
    if project is not None:
        stages.append(eng.add_op(ops.Project("proj", num_workers,
                                             num_workers * chunk, fn=project)))
    grp = eng.add_op(ops.GroupByAgg("groupby", num_workers, chunk))
    stages.append(grp)
    sink = eng.add_op(ops.Sink("sink", num_keys, snapshot_every=batch_ticks))
    prev = src
    for op in stages:
        eng.connect(prev, op, num_keys)
        prev = op
    eng.connect(prev, sink, num_keys)
    ctrl = (eng.attach_controller(grp, cfg(metric_period=4))
            if controller else None)
    return eng, sink, grp, ctrl


def _row_stream(n, seed, hot=0.5):
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n) - 1, NK - 1).astype(np.int64)
    keys[rng.random(n) < hot] = 0
    return keys, rng.uniform(0.0, 10.0, n)


def _sort_pipeline(plane, *, n=5000, num_workers=4, chunk=8, batch_ticks=4,
                   controller=False, seed=2):
    """Source -> RangeSort -> Sink (the W3 shape)."""
    eng_mod, ops, cfg, kw = PLANES[plane]
    keys, vals = _row_stream(n, seed)
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **kw)
    src = eng.add_source(eng_mod.Source("src", keys, vals, num_workers * chunk))
    sort = eng.add_op(ops.RangeSort("sort", num_workers, chunk))
    sink = eng.add_op(ops.Sink("sink", NK, snapshot_every=batch_ticks))
    eng.connect(src, sort, NK)
    eng.connect(sort, sink, NK)
    ctrl = (eng.attach_controller(sort, cfg(metric_period=4))
            if controller else None)
    return eng, sink, sort, ctrl


def _build_pipeline(plane, *, n=3000, num_workers=4, chunk=8, batch_ticks=4,
                    seed=3):
    """Source -> HashJoinBuild (blocking terminal: device row state)."""
    eng_mod, ops, _, kw = PLANES[plane]
    keys, vals = _row_stream(n, seed)
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **kw)
    src = eng.add_source(eng_mod.Source("src", keys, vals, num_workers * chunk))
    bld = eng.add_op(ops.HashJoinBuild("build", num_workers, chunk))
    eng.connect(src, bld, NK)
    return eng, None, bld, None


def _assert_runs_identical(a, b):
    """Integer results, mirrors and counters bit for bit."""
    assert a[0].tick == b[0].tick
    if a[1] is not None:
        assert _series_equal(a[1].series, b[1].series)
        np.testing.assert_array_equal(a[1].counts, b[1].counts)
        # The resident sink adds K2's float32 per-chunk sums: ~7 digits.
        np.testing.assert_allclose(a[1].sums, b[1].sums, rtol=1e-5)
    assert len(a[0].edges) == len(b[0].edges)
    for ea, eb in zip(a[0].edges, b[0].edges):
        np.testing.assert_array_equal(ea.sent_per_worker, eb.sent_per_worker)
        assert ea.tuples_sent == eb.tuples_sent
        ea.routing.sync_counters()
        eb.routing.sync_counters()
        np.testing.assert_array_equal(ea.routing._count, eb.routing._count)
    if a[3] is not None:
        assert ([(e.tick, e.kind, e.skewed, tuple(e.helpers))
                 for e in a[3].events]
                == [(e.tick, e.kind, e.skewed, tuple(e.helpers))
                    for e in b[3].events])
    for oa, ob in zip(a[0].ops, b[0].ops):
        for wa, wb in zip(oa.workers, ob.workers):
            assert wa.stats.processed_total == wb.stats.processed_total
            assert wa.stats.emitted_total == wb.stats.emitted_total


def _assert_row_state_identical(op_a, op_b):
    """Per-worker ScopeRows equality: scope sets + exact scope arrays."""
    op_a._device_sync()
    op_b._device_sync()
    for wa, wb in zip(op_a.workers, op_b.workers):
        for ta, tb in ((wa.state, wb.state), (wa.scattered, wb.scattered)):
            assert set(ta.keys()) == set(tb.keys())
            for k in ta.keys():
                np.testing.assert_array_equal(ta.scope_array(int(k)),
                                              tb.scope_array(int(k)))


def _assert_groupby_identical(op_a, op_b):
    op_a._device_sync()
    op_b._device_sync()
    for wa, wb in zip(op_a.workers, op_b.workers):
        for ta, tb in ((wa.state, wb.state), (wa.scattered, wb.scattered)):
            np.testing.assert_array_equal(ta.present, tb.present)
            np.testing.assert_array_equal(ta.counts, tb.counts)
            np.testing.assert_allclose(ta.sums, tb.sums, rtol=1e-12)


def _run_three(build, **kw):
    """The same pipeline on the JAX numpy plane, the port's resident plane
    and the port's per-chunk plane."""
    runs = {}
    for plane in ("numpy", "resident", "per-chunk"):
        runs[plane] = build(plane, **kw)
        runs[plane][0].run()
    res = runs["resident"][0]
    assert all(e.device_plane == "jit" for e in res.edges)
    assert all(isinstance(e.exchange, DeviceExchange) for e in res.edges)
    assert all(e.device_plane is None and isinstance(e.exchange, Exchange)
               for e in runs["per-chunk"][0].edges)
    assert not res.incidents.query(kind="demotion")
    for other in ("numpy", "per-chunk"):
        _assert_runs_identical(runs[other], runs["resident"])
    return runs


# --------------------------------------------------------------------- #
# Fold, map and sink steps (test_device_plane.py analogues)              #
# --------------------------------------------------------------------- #
def test_fold_pipeline_bit_identical():
    """test_device_plane.py:94 — Filter -> GroupBy -> Sink, skewed stream,
    batched scheduler."""
    runs = _run_three(_fold_pipeline)
    _assert_groupby_identical(runs["numpy"][2], runs["resident"][2])


def test_groupby_state_identical():
    """test_device_plane.py:106 — a Filter that kills half the lanes (holes
    in the middle of every device chunk) ahead of the fold."""
    runs = _run_three(_fold_pipeline, predicate=_half_pass)
    for plane in ("numpy", "per-chunk"):
        _assert_groupby_identical(runs[plane][2], runs["resident"][2])


def test_project_stage_passthrough():
    """test_device_plane.py:120 — Filter -> Project -> GroupBy -> Sink."""
    runs = _run_three(_fold_pipeline, project=_proj)
    _assert_groupby_identical(runs["numpy"][2], runs["resident"][2])


def test_controller_rewrites_and_migrations():
    """test_device_plane.py:128 — a Reshape controller on the resident
    GroupBy: detections, the two-phase rewrites (split keys through K2's
    split counters), scattered folds and the END merge replay identically."""
    runs = _run_three(_fold_pipeline, num_workers=6, controller=True,
                      hot_frac=0.5, seed=1, n=8000)
    res = runs["resident"]
    assert any(e.kind == "phase2" for e in res[3].events)
    _assert_groupby_identical(runs["numpy"][2], res[2])
    for w in res[2].workers:
        assert not len(w.scattered)               # merged at END


def test_kernel_counts_feed_the_key_stats():
    """K2's per-key counts are the arrival-stats fold: the controller's
    per-key totals equal the host plane's."""
    runs = _run_three(_fold_pipeline, num_workers=6, controller=True,
                      hot_frac=0.5, seed=1, n=8000)
    np.testing.assert_array_equal(runs["numpy"][2].key_arrivals_total,
                                  runs["resident"][2].key_arrivals_total)


def test_forced_device_controller_leg(monkeypatch):
    """test_device_plane.py:146 — ``REPRO_DEVICE_CONTROLLER=1`` arms the
    monitored GroupBy's in-dispatch controller, and on the same window
    schedule the run, the event stream with its details included, is
    bit-identical to the JAX package's host-stepped numpy plane."""
    kw = dict(num_workers=6, controller=True, hot_frac=0.5, seed=1, n=8000)
    a = _fold_pipeline("numpy", **kw)
    while not a[0].done():
        a[0].run_super_tick(4)
    monkeypatch.setenv("REPRO_DEVICE_CONTROLLER", "1")
    b = _fold_pipeline("resident", **kw)
    assert b[0].device_controller
    dev = b[2].device
    assert dev is not None and dev.ctrl is not None and dev.ctrl.active
    while not b[0].done():
        b[0].run_super_tick(4)
    _assert_runs_identical(a, b)
    ev = lambda c: [(e.tick, e.kind, e.skewed, tuple(e.helpers),
                     tuple(sorted(e.detail.items()))) for e in c.events]
    assert ev(a[3]) == ev(b[3])
    assert any(e.kind == "phase2" for e in b[3].events)
    assert b[3].rounds_on_device > 0
    assert b[0].incidents.count("ctrl-mismatch") == 0
    _assert_groupby_identical(a[2], b[2])


# --------------------------------------------------------------------- #
# Row-state steps (test_device_rowstate.py analogues)                    #
# --------------------------------------------------------------------- #
def test_sort_pipeline_bit_identical():
    """test_device_rowstate.py:160 — Source -> RangeSort -> Sink."""
    runs = _run_three(_sort_pipeline)
    _assert_row_state_identical(runs["numpy"][2], runs["resident"][2])
    np.testing.assert_array_equal(runs["numpy"][2].sorted_output(),
                                  runs["resident"][2].sorted_output())


def test_build_row_state_identical():
    """test_device_rowstate.py:171 — the flat segment store materializes
    into the exact ScopeRows the host plane holds."""
    runs = _run_three(_build_pipeline)
    _assert_row_state_identical(runs["numpy"][2], runs["resident"][2])
    _assert_row_state_identical(runs["per-chunk"][2], runs["resident"][2])


def test_sort_controller_rewrites_and_scattered_merge():
    """test_device_rowstate.py:195 — SBR splits scatter rows to helper
    workers on the device; END merge and the run replay identically."""
    runs = _run_three(_sort_pipeline, num_workers=6, controller=True, n=8000,
                      seed=4)
    res = runs["resident"]
    assert any(e.kind == "phase2" for e in res[3].events)
    _assert_row_state_identical(runs["numpy"][2], res[2])
    for w in res[2].workers:
        assert not len(w.scattered)               # merged at END


def test_scattered_rewrites_are_no_boundary(monkeypatch):
    """A SCATTERED rewrite moves no state, so the resident sort is
    materialized only at END; the controller's state-size reads come from
    the owned-rows mirror, which equals the host copy once synced."""
    calls = []
    sync_host = tdev.DeviceOpRuntime.sync_host

    def counted(self):
        calls.append(self.kind)
        return sync_host(self)

    monkeypatch.setattr(tdev.DeviceOpRuntime, "sync_host", counted)
    eng, _, sort, ctrl = _sort_pipeline("resident", num_workers=6,
                                        controller=True, n=8000, seed=4)
    for _ in range(150):
        eng.run_super_tick(eng._fusible_ticks(4))
    assert eng.edges[0].routing.version > 0 and calls == []
    mirror = [sort.state_units(w, None) for w in range(6)]
    assert calls == []
    sort._device_sync()
    assert mirror == [float(w.state.total_rows()) for w in sort.workers]
    eng.run()
    assert calls.count("rows") <= 2


@pytest.mark.parametrize("build", ["sort", "fold"])
def test_split_tables_through_the_kernel_ingest(build):
    """test_device_rowstate.py:210 — a manual SBR split mid-run: the split
    key's records take K2's counter-driven destinations on the resident
    plane and land on the same workers as on the host plane, including a
    split-key counter above 2^31 (the int32 cast wraps like numpy's)."""
    fn = _sort_pipeline if build == "sort" else _fold_pipeline

    def scenario(plane):
        t = fn(plane, n=3000)
        for _ in range(4):
            t[0].run_super_tick(t[0]._fusible_ticks(4))
        routing = t[0].edges[0].routing
        routing.split_key(0, [0, 1, 2], [0.5, 0.25, 0.25])
        # A host advance takes the counters back from the device (the
        # backend-swap handshake); the next dispatch uploads them again.
        routing.advance_counters(np.zeros(0, np.int64))
        routing._count[0] = 2**31 + 5
        t[0].run()
        return t

    runs = {p: scenario(p) for p in ("numpy", "resident", "per-chunk")}
    assert all(e.device_plane == "jit" for e in runs["resident"][0].edges)
    for other in ("numpy", "per-chunk"):
        _assert_runs_identical(runs[other], runs["resident"])
    assert runs["resident"][0].edges[0].routing._count[0] > 2**31
    if build == "sort":
        _assert_row_state_identical(runs["numpy"][2], runs["resident"][2])


def test_int32_cast_wraps_like_numpy():
    """The resident plane hands K2 its int64 keys and split counters as they
    are; K2 narrows them by two's-complement wrap, as ``np.astype(np.int32)``
    does (the plain version with ``.to(torch.int32)``, the kernel in
    registers)."""
    x = np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 5, 2**32 + 7, 3 * 2**32 - 1,
                  -1, -(2**31), -(2**31) - 1], dtype=np.int64)
    w = np.random.default_rng(0).dirichlet(np.ones(6), 8)
    cdf = saturated_cdf32(torch.from_numpy(w))
    vals = torch.arange(x.size, dtype=torch.float64)
    valid = torch.ones(x.size, dtype=torch.bool)
    x32 = torch.from_numpy(x.astype(np.int32))
    wide = kpart.partition_scatter_fold(torch.from_numpy(x),
                                        torch.from_numpy(x), vals, valid, cdf)
    narrow = kpart.partition_scatter_fold(x32, x32, vals.float(), valid, cdf)
    assert int(wide[3].sum()) == 3        # 0, 1 and 2^32 + 7 -> 7 in [0, 8)
    for a, b in zip(wide, narrow):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# Eligibility, demotion and errors                                       #
# --------------------------------------------------------------------- #
def test_two_dim_vals_demote_to_the_per_chunk_path():
    """test_device_plane.py:510."""
    eng = teng.Engine(device="cpu", device_executor="jit")
    src = eng.add_source(teng.Source("s", np.arange(50) % 8,
                                     np.ones((50, 2)), 10))
    filt = eng.add_op(tops.Filter("f", 2, 10, predicate=lambda k, v: np.ones(
        k.shape[0], bool)))
    sink = eng.add_op(tops.Sink("k", 8))
    eng.connect(src, filt, 8)
    eng.connect(filt, sink, 8)
    eng.run()
    assert all((e.device_plane or "").startswith("demoted")
               for e in eng.edges)
    assert all(isinstance(e.exchange, Exchange) for e in eng.edges)
    assert eng.incidents.count("demotion") == 2
    assert int(sink.counts.sum()) == 50


def test_raising_predicate_demotes_with_an_incident():
    """A Filter predicate that cannot run on device tensors (numpy-only
    ``astype``) demotes its edge before any state moved; the run replays
    on the per-chunk path and matches the host plane."""
    def numpy_only(k, v):
        return v.astype(np.float64) >= 2.0

    def build(plane):
        eng_mod, ops, _, kw = PLANES[plane]
        keys, vals = _zipf_stream(400, 8, seed=5)
        eng = eng_mod.Engine(**kw)
        src = eng.add_source(eng_mod.Source("s", keys, vals, 10))
        filt = eng.add_op(ops.Filter("f", 2, 10, predicate=numpy_only))
        sink = eng.add_op(ops.Sink("k", 8))
        eng.connect(src, filt, 8)
        eng.connect(filt, sink, 8)
        return eng, sink, filt, None

    a = build("numpy")
    a[0].run()
    b = build("resident")
    with pytest.warns(RuntimeWarning, match="demoting"):
        b[0].run()
    assert b[0].edges[0].device_plane == "demoted(user fn)"
    assert b[0].edges[1].device_plane == "jit"
    (inc,) = b[0].incidents.query(kind="demotion")
    assert inc.edge == "f" and inc.cause == "user fn"
    _assert_runs_identical(a, b)


def test_kernel_error_propagates_instead_of_demoting(monkeypatch):
    """A failure inside K2 (here a wrapper patched to raise, standing in
    for a build or CUDA error) ends the run; the edge is not demoted."""
    def broken(*args):
        raise RuntimeError("partition_scatter_fold failed to launch")

    monkeypatch.setattr(kpart, "partition_scatter_fold", broken)
    eng, sink, grp, _ = _fold_pipeline("resident", n=200)
    with pytest.raises(RuntimeError, match="failed to launch"):
        eng.run()
    assert all(e.device_plane == "jit" for e in eng.edges)
    assert not eng.incidents.query(kind="demotion")


def test_second_upstream_demotes():
    """test_device_plane.py:542."""
    eng = teng.Engine(device="cpu", device_executor="jit")
    s1 = eng.add_source(teng.Source("s1", np.arange(30) % 8, np.ones(30), 10))
    s2 = eng.add_source(teng.Source("s2", np.arange(30) % 8, np.ones(30), 10))
    sink = eng.add_op(tops.Sink("k", 8))
    eng.connect(s1, sink, 8)
    assert sink.device is not None
    eng.connect(s2, sink, 8)
    assert sink.device is None
    assert eng.edges[0].device_plane == "demoted(multiple upstreams)"
    eng.run()
    assert int(sink.counts.sum()) == 60


def test_executor_selection():
    """``"jit"`` puts eligible edges on the resident plane; ``"host"``, the
    default, keeps the per-chunk exchange."""
    for bogus in ("bogus", None):
        with pytest.raises(ValueError, match="device executor"):
            teng.Engine(device="cpu", device_executor=bogus)
    assert teng.Engine(device="cpu").device_executor == "host"
    assert tdf.build_w3(device="cpu", n_tuples=100).engine.device_executor \
        == "host"
    for executor, plane in (("jit", "jit"), ("host", None)):
        eng = teng.Engine(device="cpu", device_executor=executor)
        src = eng.add_source(teng.Source("s", np.arange(8), np.ones(8), 4))
        eng.connect(src, eng.add_op(tops.Sink("k", 8)), 8)
        assert eng.edges[0].device_plane == plane
    eng = teng.Engine(device="cpu", partition_backend="numpy")
    src = eng.add_source(teng.Source("s", np.arange(8), np.ones(8), 4))
    eng.connect(src, eng.add_op(tops.Sink("k", 8)), 8)
    assert eng.edges[0].device_plane is None


# --------------------------------------------------------------------- #
# Workflows                                                              #
# --------------------------------------------------------------------- #
def test_w1_all_resident_matches_numpy_plane():
    """W1 under reshape with every edge resident: the filter, the probe
    and the sink."""
    kw = dict(strategy="reshape", scale=0.03, num_workers=16, service_rate=4,
              batch_ticks=4, snapshot_every=2)
    a = jdf.build_w1(partition_backend="numpy", **kw)
    a.run()
    b = tdf.build_w1(device="cpu", device_executor="jit", **kw)
    b.run()
    assert [e.device_plane for e in b.engine.edges] == ["jit", "jit", "jit"]
    assert not b.engine.incidents.query(kind="demotion")
    _assert_runs_identical((a.engine, a.sink, None, a.controllers[0]),
                           (b.engine, b.sink, None, b.controllers[0]))
    np.testing.assert_array_equal(b.sink.counts,
                                  tdf.datasets.tweet_counts(0.03))


def test_w3_resident_matches_reference_oracle():
    """test_device_rowstate.py:229 — W3 with every edge resident, series
    and the globally sorted output bit-identical to the JAX package's
    tuple-at-a-time oracle."""
    kw = dict(strategy="reshape", n_tuples=3000, num_workers=8,
              service_rate=6, batch_ticks=4, snapshot_every=2)
    r = jdf.build_w3(reference=True, **kw)
    r.run()
    b = tdf.build_w3(device="cpu", device_executor="jit", **kw)
    b.run()
    assert [e.device_plane for e in b.engine.edges] == ["jit", "jit"]
    assert r.engine.tick == b.engine.tick
    assert _series_equal(r.sink.series, b.sink.series)
    np.testing.assert_array_equal(r.monitored[0].sorted_output(),
                                  b.monitored[0].sorted_output())
    np.testing.assert_array_equal(b.monitored[0].sorted_output(),
                                  np.sort(b.meta["prices"]))


@pytest.fixture
def jax_jit_plane(monkeypatch):
    """The JAX package's jit plane imports ``jax.experimental.enable_x64``,
    which this jax no longer has; shim it for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def test_w3_resident_matches_jax_jit_plane(jax_jit_plane):
    """W3 against the JAX jit plane with its kernel sink
    (``device_use_kernel=True``): the same edges resident, integers bit for
    bit, and the sink's sums — both float32 K2 sums per chunk, added to
    float64 — within float32 rounding of each other."""
    kw = dict(strategy="reshape", n_tuples=3000, num_workers=4,
              service_rate=6, batch_ticks=4)
    j = jdf.build_w3(partition_backend="pallas", device_executor="jit", **kw)
    for op in j.engine.ops:     # Engine(device_use_kernel=True), post-build
        op.device.use_kernel = True
    j.run()
    b = tdf.build_w3(device="cpu", device_executor="jit", **kw)
    b.run()
    assert [e.device_plane for e in j.engine.edges] == ["jit", "jit"]
    assert [e.device_plane for e in b.engine.edges] == ["jit", "jit"]
    _assert_runs_identical((j.engine, j.sink, j.monitored[0], j.controllers[0]),
                           (b.engine, b.sink, b.monitored[0], b.controllers[0]))
    np.testing.assert_allclose(b.sink.sums, j.sink.sums, rtol=1e-6)
    _assert_row_state_identical(j.monitored[0], b.monitored[0])
