"""The port's probe kind and multi-edge chain fusion against the JAX package.

``repro_torch.dataflow.device`` runs on ``device="cpu"`` here (K2 by its
plain PyTorch version).  ``match_expand`` is held against
``repro.kernels.ref.match_expand`` bit for bit.  Every pipeline is held
against the JAX package's numpy host plane on the same inputs, and fused
runs against the port's own ``device_chain=False`` runs: ticks,
``Sink.series``, ``Sink.counts``, ``sent_per_worker``, the routing
counters, the worker mirrors and the controller events bit for bit; sink
sums within c * 2^-23 * sum|v| per key (c the key's count; the resident
sink adds K2's float32 per-chunk sums; every stream here has vals >= 0, so
sum|v| is the host plane's sum).  The analogues of ``TestChainFusion``
(``tests/test_device_plane.py``) and ``TestProbeChainFusion`` /
``TestRowStateSatelliteFixes`` (``tests/test_device_rowstate.py``) are
named after them.  W1 is also held against the JAX jit plane under a
test-scoped ``enable_x64`` shim.
"""
import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.dataflow as jdf
import repro.dataflow.engine as jeng
import repro.dataflow.operators as jops
from repro.core import ReshapeConfig as JaxConfig
from repro.kernels import ref as jref
from repro_torch import dataflow as tdf
from repro_torch.core import ReshapeConfig
from repro_torch.dataflow import datasets
from repro_torch.dataflow import device as tdev
from repro_torch.dataflow import engine as teng
from repro_torch.dataflow import operators as tops
from repro_torch.kernels import partition as kpart
from repro_torch.kernels import ref as tref

NK = 16

#: plane -> (engine module, operator module, config class, engine kwargs)
PLANES = {
    "numpy": (jeng, jops, JaxConfig, dict(partition_backend="numpy")),
    "resident": (teng, tops, ReshapeConfig,
                 dict(device="cpu", device_executor="jit")),
    "apart": (teng, tops, ReshapeConfig,
              dict(device="cpu", device_executor="jit", device_chain=False)),
}


# --------------------------------------------------------------------- #
# match_expand                                                           #
# --------------------------------------------------------------------- #
def _expand_case(name):
    """(wk, wv, wmask, mcounts, emit_width) as numpy arrays from seed 0."""
    rng = np.random.default_rng(0)
    W, B, K = 5, 7, 9
    wk = rng.integers(0, K, (W, B))
    wv = rng.uniform(-10.0, 10.0, (W, B))
    wmask = rng.random((W, B)) < 0.7
    mcounts = rng.integers(0, 4, (W, K))
    if name == "zero fanout":
        mcounts[:] = 0
    elif name == "all-dead rows":
        wmask[[0, 3]] = False
    elif name == "fills the emit width":
        wmask[1] = True
        mcounts[1] = 3
    elif name == "M = 1":
        mcounts = (rng.random((W, K)) < 0.6).astype(np.int64)
    M = max(int(mcounts.max()), 1)
    return wk, wv, wmask, mcounts, B * M


@pytest.mark.parametrize("name", ["random", "zero fanout", "all-dead rows",
                                  "fills the emit width", "M = 1"])
def test_match_expand_matches_the_reference(name):
    """The torch ops give the jnp reference's keys, vals and mask bit for
    bit (int64 / float64 on both sides)."""
    wk, wv, wmask, mcounts, width = _expand_case(name)
    with jax.enable_x64(True):
        want = jref.match_expand(jnp.asarray(wk), jnp.asarray(wv),
                                 jnp.asarray(wmask), jnp.asarray(mcounts),
                                 width)
        want = [np.asarray(x) for x in want]
    got = tref.match_expand(torch.from_numpy(wk), torch.from_numpy(wv),
                            torch.from_numpy(wmask),
                            torch.from_numpy(mcounts), width)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)
    # np.repeat per worker, lanes in stream order, the rest dead.
    keep = got[2].numpy()
    for w in range(wk.shape[0]):
        reps = np.where(wmask[w], mcounts[w, wk[w]], 0)
        np.testing.assert_array_equal(got[0].numpy()[w][keep[w]],
                                      np.repeat(wk[w], reps))
        np.testing.assert_array_equal(got[1].numpy()[w][keep[w]],
                                      np.repeat(wv[w], reps))
    if name == "fills the emit width":
        assert keep[1].all()
    if name in ("zero fanout",):
        assert not keep.any()
    if name == "all-dead rows":
        assert not keep[[0, 3]].any()


# --------------------------------------------------------------------- #
# Pipelines                                                              #
# --------------------------------------------------------------------- #
def _series_equal(a, b):
    return (len(a) == len(b)
            and all(t1 == t2 and np.array_equal(c1, c2)
                    for (t1, c1), (t2, c2) in zip(a, b)))


def _all_pass(k, v):
    return v >= 0


def _half_pass(k, v):
    return v >= 5.0


def _proj_keep(k, v):
    return k, v + 1.0


def _rekey(k, v):
    return (k + 1) % 24, v


def _zipf_stream(n, num_keys, seed=0, hot_frac=0.0):
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n) - 1, num_keys - 1).astype(np.int64)
    if hot_frac:
        keys[rng.random(n) < hot_frac] = 0
    return keys, rng.uniform(0.0, 10.0, n)


def _build_table(nk=NK):
    """Key k holds 1 + (k % 3) build rows: a per-key fanout, M = 3."""
    bk = np.repeat(np.arange(nk, dtype=np.int64), 1 + (np.arange(nk) % 3))
    return bk, np.ones(bk.size, dtype=np.float64)


def _fold_pipeline(plane, *, n=5000, num_keys=24, num_workers=4, chunk=8,
                   batch_ticks=4, controller=False, hot_frac=0.0, seed=0):
    """Source -> Filter -> GroupByAgg -> Sink."""
    eng_mod, ops, cfg, kw = PLANES[plane]
    keys, vals = _zipf_stream(n, num_keys, seed, hot_frac)
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **kw)
    src = eng.add_source(eng_mod.Source("src", keys, vals, num_workers * chunk))
    filt = eng.add_op(ops.Filter("filter", num_workers, num_workers * chunk,
                                 predicate=_all_pass))
    grp = eng.add_op(ops.GroupByAgg("groupby", num_workers, chunk))
    sink = eng.add_op(ops.Sink("sink", num_keys, snapshot_every=batch_ticks))
    eng.connect(src, filt, num_keys)
    eng.connect(filt, grp, num_keys)
    eng.connect(grp, sink, num_keys)
    ctrl = (eng.attach_controller(grp, cfg(metric_period=4))
            if controller else None)
    return eng, sink, grp, ctrl


def _chain_pipeline(plane, *, n=5000, num_keys=24, num_workers=4, chunk=8,
                    batch_ticks=4, project=_proj_keep, preserves_keys=True):
    """Source -> Filter -> Project -> GroupByAgg -> Sink over one key space:
    three routing-equivalent edges."""
    eng_mod, ops, _, kw = PLANES[plane]
    keys, vals = _zipf_stream(n, num_keys, 0)
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **kw)
    src = eng.add_source(eng_mod.Source("src", keys, vals, num_workers * chunk))
    filt = eng.add_op(ops.Filter("filter", num_workers, num_workers * chunk,
                                 predicate=_all_pass))
    proj = eng.add_op(ops.Project("proj", num_workers, num_workers * chunk,
                                  fn=project, preserves_keys=preserves_keys))
    grp = eng.add_op(ops.GroupByAgg("groupby", num_workers, chunk))
    sink = eng.add_op(ops.Sink("sink", num_keys, snapshot_every=batch_ticks))
    prev = src
    for op in (filt, proj, grp, sink):
        eng.connect(prev, op, num_keys)
        prev = op
    return eng, sink, grp, None


def _join_pipeline(plane, *, n=5000, num_workers=4, chunk=8, batch_ticks=4,
                   controller=False, seed=1, hot=0.5):
    """Source -> Filter -> HashJoinProbe -> Sink (the W1 shape; Filter ->
    Probe is the fusible probe chain)."""
    eng_mod, ops, cfg, kw = PLANES[plane]
    keys, vals = _zipf_stream(n, NK, seed)
    keys[np.random.default_rng(seed + 100).random(n) < hot] = 0
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **kw)
    src = eng.add_source(eng_mod.Source("src", keys, vals, num_workers * chunk))
    filt = eng.add_op(ops.Filter("filter", num_workers, num_workers * chunk,
                                 predicate=_all_pass))
    join = eng.add_op(ops.HashJoinProbe("join", num_workers, chunk))
    sink = eng.add_op(ops.Sink("sink", NK, snapshot_every=batch_ticks))
    eng.connect(src, filt, NK)
    je = eng.connect(filt, join, NK)
    eng.connect(join, sink, NK)
    join.install_build(je.routing, *_build_table())
    ctrl = (eng.attach_controller(join, cfg(metric_period=4))
            if controller else None)
    return eng, sink, join, ctrl


def _sums_within_bound(a_sink, b_sink):
    """Sink sums within c * 2^-23 * sum|v| per key (vals >= 0 here)."""
    tol = a_sink.counts * 2.0**-23 * np.abs(a_sink.sums)
    assert (np.abs(a_sink.sums - b_sink.sums) <= tol).all()


def _assert_runs_identical(a, b):
    """Integers bit for bit, sink sums within the resident plane's bound."""
    assert a[0].tick == b[0].tick
    assert _series_equal(a[1].series, b[1].series)
    np.testing.assert_array_equal(a[1].counts, b[1].counts)
    _sums_within_bound(a[1], b[1])
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
    _mirrors_equal(a[0], b[0])


def _mirrors_equal(a_eng, b_eng):
    for oa, ob in zip(a_eng.ops, b_eng.ops):
        np.testing.assert_array_equal(oa.received_totals(),
                                      ob.received_totals())
        for wa, wb in zip(oa.workers, ob.workers):
            assert wa.stats.processed_total == wb.stats.processed_total
            assert wa.stats.emitted_total == wb.stats.emitted_total


def _run(build, plane, **kw):
    t = build(plane, **kw)
    t[0].run()
    return t


def _placements(eng):
    return [e.exchange.placements for e in eng.edges]


# --------------------------------------------------------------------- #
# Chain fusion (TestChainFusion analogues)                               #
# --------------------------------------------------------------------- #
def test_chain_bit_identical_and_placements_drop():
    """Filter -> Project -> GroupBy: three placements a super-tick collapse
    to one (the head edge's), bit-identical to the host plane."""
    a = _run(_chain_pipeline, "numpy")
    b = _run(_chain_pipeline, "resident")
    _assert_runs_identical(a, b)
    head, mid, tail = _placements(b[0])[:3]
    assert head > 0 and mid == 0 and tail == 0
    assert all(p > 0 for p in _placements(a[0])[1:3])
    assert not b[0].incidents.query(kind="demotion")


def test_filter_groupby_chain_placements_2_to_1():
    """Filter -> GroupBy pays two placements per emitting super-tick apart
    and one fused (the GroupBy edge's partition is gone)."""
    fused = _run(_fold_pipeline, "resident")
    apart = _run(_fold_pipeline, "apart")
    _assert_runs_identical(apart, fused)
    f_head = fused[0].edges[0].exchange.placements
    assert f_head > 0
    assert fused[0].edges[1].exchange.placements == 0
    assert apart[0].edges[0].exchange.placements == f_head
    assert apart[0].edges[1].exchange.placements == pytest.approx(
        f_head, rel=0.1)


def test_unfused_flag_is_bit_identical():
    """``device_chain=False`` pays a placement on every edge and gives the
    same bits as the fused run and the host plane."""
    a = _run(_chain_pipeline, "apart")
    assert all(p > 0 for p in _placements(a[0])[:3])
    b = _run(_chain_pipeline, "resident")
    _assert_runs_identical(a, b)
    _assert_runs_identical(_run(_chain_pipeline, "numpy"), a)


def test_env_var_turns_fusion_off(monkeypatch):
    """``REPRO_DEVICE_CHAIN=0`` is ``device_chain=False``; an explicit
    argument wins over it."""
    monkeypatch.setenv("REPRO_DEVICE_CHAIN", "0")
    assert not teng.Engine(device="cpu", device_executor="jit").device_chain
    assert teng.Engine(device="cpu", device_executor="jit",
                       device_chain=True).device_chain
    b = _run(_chain_pipeline, "resident")
    assert all(p > 0 for p in _placements(b[0])[:3])
    monkeypatch.delenv("REPRO_DEVICE_CHAIN")
    assert teng.Engine(device="cpu", device_executor="jit").device_chain


def test_rekeying_project_never_chains():
    """A Project without ``preserves_keys`` re-keys, so the edge after it
    partitions again; the run stays correct."""
    kw = dict(project=_rekey, preserves_keys=False)
    a = _run(_chain_pipeline, "numpy", **kw)
    b = _run(_chain_pipeline, "resident", **kw)
    _assert_runs_identical(a, b)
    assert b[0].edges[1].exchange.placements == 0   # Filter -> Project fused
    assert b[0].edges[2].exchange.placements > 0


def test_sink_tail_chain():
    """A W = 1 Filter -> Sink pair is routing-equivalent: the sink at the
    chain's tail folds the carry through K2 (counts bit for bit, sums in
    the bound), with received / processed mirrors exact."""
    calls = []

    def build(plane):
        eng_mod, ops, _, kw = PLANES[plane]
        keys, vals = _zipf_stream(3000, 16, seed=7)
        eng = eng_mod.Engine(batch_ticks=4, **kw)
        src = eng.add_source(eng_mod.Source("s", keys, vals, 32))
        filt = eng.add_op(ops.Filter("f", 1, 32, predicate=_half_pass))
        sink = eng.add_op(ops.Sink("k", 16, snapshot_every=4))
        eng.connect(src, filt, 16)
        eng.connect(filt, sink, 16)
        eng.run()
        return eng, sink, None, None

    def spy(*args):
        calls.append(args[4].shape)
        return fold(*args)

    fold = kpart.partition_scatter_fold
    a = build("numpy")
    c = build("apart")
    kpart.partition_scatter_fold = spy
    try:
        b = build("resident")
    finally:
        kpart.partition_scatter_fold = fold
    _assert_runs_identical(a, b)
    _assert_runs_identical(c, b)
    sink_rt = b[0].ops[1].device
    assert sink_rt is not None and sink_rt._chain_serial > 0
    # One K2 call a fused super-tick at the head, one at the sink tail.
    assert calls.count((16, 1)) == 2 * b[0].edges[0].exchange.placements


def test_controller_rewrite_breaks_chain_mid_run():
    """A Reshape mitigation splits keys on the GroupBy edge: its token
    voids, the chain falls back per edge mid-run, bit-identical
    throughout."""
    kw = dict(num_workers=6, controller=True, hot_frac=0.5, seed=1, n=8000)
    a = _run(_fold_pipeline, "numpy", **kw)
    b = _run(_fold_pipeline, "resident", **kw)
    _assert_runs_identical(a, b)
    assert any(e.kind == "phase2" for e in b[3].events)
    assert 0 < b[0].edges[1].exchange.placements \
        < a[0].edges[1].exchange.placements


def test_mid_chain_demotion_preserves_mirrors():
    """A Project whose function fails on device tensors, in the middle of
    a fused chain: the pre-check un-fuses (a ``chain-fallback`` incident),
    the Project's own tick demotes it with its ``user fn`` incident, and
    the mirrors stay exact with nothing counted twice."""
    def numpy_only(k, v):
        return k, v.astype(np.float64) * 2.0

    a = _run(_chain_pipeline, "numpy", project=numpy_only)
    with pytest.warns(RuntimeWarning):
        b = _run(_chain_pipeline, "resident", project=numpy_only)
    assert b[0].ops[1].device is None
    assert b[0].edges[1].device_plane == "demoted(user fn)"
    assert all(b[0].edges[i].device_plane == "jit" for i in (0, 2, 3))
    (inc,) = b[0].incidents.query(kind="demotion")
    assert inc.edge == "proj" and inc.cause == "user fn"
    assert len(b[0].incidents.query(kind="chain-fallback")) == 1
    _assert_runs_identical(a, b)


def test_lockstep_rewrite_with_head_backlog():
    """Both chain tables rewritten in lockstep keep equal tokens, but the
    head's backlog was placed under the old table: the placement epoch
    keeps the chain apart until it drains, and the run is delivered
    exactly as on the host plane."""
    def scenario(plane):
        eng_mod, ops, _, kw = PLANES[plane]
        keys, vals = _zipf_stream(8000, 16, seed=11)
        eng = eng_mod.Engine(batch_ticks=4, **kw)
        src = eng.add_source(eng_mod.Source("src", keys, vals, 128))
        filt = eng.add_op(ops.Filter("filter", 4, 8,     # slow: backlog
                                     predicate=_all_pass))
        grp = eng.add_op(ops.GroupByAgg("groupby", 4, 8))
        sink = eng.add_op(ops.Sink("sink", 16, snapshot_every=4))
        eng.connect(src, filt, 16)
        eng.connect(filt, grp, 16)
        eng.connect(grp, sink, 16)
        for _ in range(4):
            eng.run_super_tick(eng._fusible_ticks(4))
        assert filt.backlog_total() > 0
        for e in eng.edges[:2]:
            e.routing.move_key(0, 2)            # tokens stay equal
        eng.run()
        return eng, sink, grp, None

    a = scenario("numpy")
    b = scenario("resident")
    np.testing.assert_array_equal(a[2].received_totals(),
                                  b[2].received_totals())
    _assert_runs_identical(a, b)
    # Per-edge placements were paid while the old backlog drained.
    assert b[0].edges[1].exchange.placements > 0


def test_staleness_flip_mid_super_tick():
    """A chunk staged on a fused follower, then a rewrite of its table
    before the dispatch: the chunk routes under the table it was sent
    under, as the host plane routed it at send time."""
    def scenario(plane):
        eng, sink, grp, _ = _fold_pipeline(plane, seed=2)
        for _ in range(4):
            eng.run_super_tick(eng._fusible_ticks(4))
        e = eng.edges[1]
        e.send((np.zeros(40, dtype=np.int64), np.ones(40)))
        e.routing.split_key(0, [0, 1], [0.5, 0.5])
        eng.run()
        return eng, sink, grp, None

    a = scenario("numpy")
    b = scenario("resident")
    np.testing.assert_array_equal(a[2].received_totals(),
                                  b[2].received_totals())
    _assert_runs_identical(a, b)


def test_kernel_error_in_fused_dispatch_propagates(monkeypatch):
    """A K2 failure inside a fused dispatch (here the wrapper patched to
    raise there, standing in for a build or CUDA error) ends the run: no
    un-fusing, no demotion."""
    in_chain = []
    dispatch_chain = tdev.DeviceOpRuntime._dispatch_chain
    fold = kpart.partition_scatter_fold

    def tracked(self, members, budget):
        in_chain.append(len(members))
        return dispatch_chain(self, members, budget)

    def broken(*args):
        if in_chain:
            raise RuntimeError("partition_scatter_fold failed to launch")
        return fold(*args)

    monkeypatch.setattr(tdev.DeviceOpRuntime, "_dispatch_chain", tracked)
    monkeypatch.setattr(kpart, "partition_scatter_fold", broken)
    eng, _, _, _ = _join_pipeline("resident", n=400)
    with pytest.raises(RuntimeError, match="failed to launch"):
        eng.run()
    assert in_chain == [2]
    assert all(e.device_plane == "jit" for e in eng.edges)
    assert not eng.incidents.query(kind="demotion")
    assert not eng.incidents.query(kind="chain-fallback")


# --------------------------------------------------------------------- #
# The probe kind (TestProbeChainFusion / satellite-fix analogues)        #
# --------------------------------------------------------------------- #
def test_join_pipeline_bit_identical():
    """Filter -> Probe -> Sink with a per-key fanout (M = 3): every edge
    resident, identical to the host plane, fused or apart."""
    a = _run(_join_pipeline, "numpy")
    b = _run(_join_pipeline, "resident")
    c = _run(_join_pipeline, "apart")
    assert all(e.device_plane == "jit" for e in b[0].edges)
    assert b[2].device.M == 3
    _assert_runs_identical(a, b)
    _assert_runs_identical(a, c)


def test_filter_probe_placements_2_to_1():
    """A token-equal Filter -> Probe chain pays one placement per emitting
    super-tick fused (the probe edge's is gone), two apart."""
    fused = _run(_join_pipeline, "resident")
    apart = _run(_join_pipeline, "apart")
    _assert_runs_identical(apart, fused)
    f_head = fused[0].edges[0].exchange.placements
    assert f_head > 0
    assert fused[0].edges[1].exchange.placements == 0
    assert apart[0].edges[0].exchange.placements == f_head
    assert apart[0].edges[1].exchange.placements > 0


def test_rewrite_breaks_probe_chain_and_stays_identical():
    """A mitigation splitting the probe edge voids its token: the chain
    falls back per edge mid-run (REPLICATE migrations reload the match
    table), bit-identical to the host plane throughout."""
    kw = dict(num_workers=6, controller=True, n=8000, seed=1)
    a = _run(_join_pipeline, "numpy", **kw)
    b = _run(_join_pipeline, "resident", **kw)
    _assert_runs_identical(a, b)
    assert any(e.kind == "phase2" for e in b[3].events)
    assert 0 < b[0].edges[1].exchange.placements \
        < a[0].edges[1].exchange.placements
    assert not b[0].incidents.query(kind="demotion")


def test_probe_head_chains_into_groupby_tail():
    """A probe can head a chain: Probe -> GroupBy over one key space
    advances in one dispatch (the expanded block feeds the fold
    pre-placed), keyed state and series as on the host plane."""
    def build(plane):
        eng_mod, ops, _, kw = PLANES[plane]
        keys, vals = _zipf_stream(5000, NK, seed=0)
        keys[np.random.default_rng(5).random(5000) < 0.4] = 0
        eng = eng_mod.Engine(batch_ticks=4, **kw)
        src = eng.add_source(eng_mod.Source("s", keys, vals, 32))
        join = eng.add_op(ops.HashJoinProbe("j", 4, 8))
        grp = eng.add_op(ops.GroupByAgg("g", 4, 32))
        sink = eng.add_op(ops.Sink("k", NK, snapshot_every=4))
        e = eng.connect(src, join, NK)
        eng.connect(join, grp, NK)
        eng.connect(grp, sink, NK)
        join.install_build(e.routing, *_build_table())
        eng.run()
        return eng, sink, grp, None

    a = build("numpy")
    b = build("resident")
    _assert_runs_identical(a, b)
    b[2]._device_sync()
    for wa, wb in zip(a[2].workers, b[2].workers):
        np.testing.assert_array_equal(wa.state.counts, wb.state.counts)
        np.testing.assert_allclose(wa.state.sums, wb.state.sums, rtol=1e-12)
    assert b[0].edges[0].exchange.placements > 0
    assert b[0].edges[1].exchange.placements == 0


def test_probe_fanout_ceiling_demotes():
    """A build table whose fanout would make W * B * M pass
    ``MAX_EMIT_CELLS`` demotes the probe edge (``probe fanout``) to the
    per-chunk path, and the result stays right."""
    keys = np.zeros(200, dtype=np.int64)
    eng = teng.Engine(device="cpu", device_executor="jit", batch_ticks=2)
    src = eng.add_source(teng.Source("s", keys, np.ones(200), 100))
    join = eng.add_op(tops.HashJoinProbe("j", 2, 4096))
    sink = eng.add_op(tops.Sink("k", 8))
    e = eng.connect(src, join, 8)
    eng.connect(join, sink, 8)
    m = tdev.MAX_EMIT_CELLS // (2 * 2 * 4096) + 1   # B = 2 * 4096
    join.install_build(e.routing, np.zeros(m, np.int64), np.ones(m))
    eng.run()
    assert e.device_plane == "demoted(probe fanout)"
    (inc,) = eng.incidents.query(kind="demotion")
    assert inc.cause == "probe fanout"
    assert int(sink.counts[0]) == 200 * m


def test_probe_sums_owned_and_scattered_matches():
    """A split build key with rows in the owned table and in `scattered`
    matches the sum of both on the resident plane, as on the host plane."""
    def build(plane):
        eng_mod, ops, _, kw = PLANES[plane]
        eng = eng_mod.Engine(batch_ticks=2, **kw)
        keys = np.tile(np.arange(8, dtype=np.int64), 40)
        src = eng.add_source(eng_mod.Source("s", keys, np.ones(keys.size), 16))
        join = eng.add_op(ops.HashJoinProbe("j", 2, 8))
        sink = eng.add_op(ops.Sink("k", 8, snapshot_every=2))
        e = eng.connect(src, join, 8)
        eng.connect(join, sink, 8)
        join.install_build(e.routing, np.arange(8), np.ones(8))
        w0 = int(e.routing.owner[0])
        join.workers[w0].scattered.extend_segments(np.zeros(3, np.int64),
                                                   np.full(3, 2.0))
        eng.run()
        return eng, sink, join, None

    a = build("numpy")
    b = build("resident")
    assert b[0].edges[0].device_plane == "jit" and b[2].device.M == 4
    assert int(b[1].counts[0]) == 40 * 4 and int(b[1].counts[1]) == 40
    _assert_runs_identical(a, b)


def test_install_build_mid_run_keeps_device_backlog():
    """A mid-run ``install_build`` materializes the device rings first and
    reloads the match table after, so no resident backlog is lost and the
    new rows match from the next dispatch on."""
    def scenario(plane):
        t = _join_pipeline(plane, n=3000)
        for _ in range(3):
            t[0].run_super_tick(t[0]._fusible_ticks(4))
        assert t[2].backlog_total() > 0
        t[2].install_build(t[0].edges[1].routing, np.ones(2, np.int64),
                           np.full(2, 5.0))
        t[0].run()
        return t

    a = scenario("numpy")
    b = scenario("resident")
    assert b[2].device.M == 4         # key 1: 2 rows + 2 new
    _assert_runs_identical(a, b)


# --------------------------------------------------------------------- #
# Workflows W1 and W4 with every edge resident                           #
# --------------------------------------------------------------------- #
def _workflow_runs_identical(a, b):
    _assert_runs_identical((a.engine, a.sink, None, a.controllers[0]),
                           (b.engine, b.sink, None, b.controllers[0]))
    assert ([(e.tick, e.kind, e.skewed, tuple(e.helpers),
              tuple(sorted(e.detail.items())))
             for e in a.controllers[0].events]
            == [(e.tick, e.kind, e.skewed, tuple(e.helpers),
                 tuple(sorted(e.detail.items())))
                for e in b.controllers[0].events])


W1_KW = dict(strategy="reshape", scale=0.03, num_workers=16, service_rate=4,
             batch_ticks=4, snapshot_every=2)
W4_KW = dict(strategy="reshape", n_tuples=8000, num_workers=16,
             service_rate=4, batch_ticks=4, snapshot_every=2)


@pytest.mark.parametrize("chain", [True, False])
def test_w1_resident_matches_numpy_plane(chain, monkeypatch):
    """W1 under reshape with every edge resident, fused and apart
    (``REPRO_DEVICE_CHAIN``): the Filter -> Probe chain fuses until the
    controller's first rewrite of the probe table, then runs per edge."""
    monkeypatch.setenv("REPRO_DEVICE_CHAIN", "1" if chain else "0")
    a = jdf.build_w1(partition_backend="numpy", **W1_KW)
    a.run()
    b = tdf.build_w1(device="cpu", device_executor="jit", **W1_KW)
    b.run()
    assert [e.device_plane for e in b.engine.edges] == ["jit", "jit", "jit"]
    assert not b.engine.incidents.query(kind="demotion")
    _workflow_runs_identical(a, b)
    np.testing.assert_array_equal(b.sink.counts, datasets.tweet_counts(0.03))
    probe, host = (b.engine.edges[1].exchange.placements,
                   a.engine.edges[1].exchange.placements)
    assert (0 < probe < host) if chain else probe == host


def test_w4_resident_matches_numpy_plane():
    """W4 (paper §7.8) under reshape with both edges resident: identical to
    the host plane, and the sink's per-key counts are the stream's key
    counts times the build rows per key."""
    a = jdf.build_w4(partition_backend="numpy", **W4_KW)
    a.run()
    b = tdf.build_w4(device="cpu", device_executor="jit", **W4_KW)
    b.run()
    assert [e.device_plane for e in b.engine.edges] == ["jit", "jit"]
    assert not b.engine.incidents.query(kind="demotion")
    assert any(e.kind == "phase2" for e in b.controllers[0].events)
    _workflow_runs_identical(a, b)
    keys, _ = datasets.synthetic_changing(8000, 42, 3)
    bk, _ = datasets.synthetic_small_table(42)
    np.testing.assert_array_equal(
        b.sink.counts,
        np.bincount(keys, minlength=42) * np.bincount(bk, minlength=42))


@pytest.fixture
def jax_jit_plane(monkeypatch):
    """The JAX package's jit plane imports ``jax.experimental.enable_x64``,
    which this jax no longer has; shim it for this test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda: jax.enable_x64(True), raising=False)


def test_w1_resident_matches_jax_jit_plane(jax_jit_plane):
    """W1 against the JAX jit plane at ``tests/test_device_plane.py``'s
    size: the same three edges resident, the same placements per edge
    (fusion engages and breaks at the same super-ticks), integers bit for
    bit, sink sums within the bound."""
    kw = dict(strategy="reshape", scale=0.005, num_workers=6, service_rate=4,
              batch_ticks=4, snapshot_every=2)
    j = jdf.build_w1(partition_backend="pallas", device_executor="jit", **kw)
    j.run()
    b = tdf.build_w1(device="cpu", device_executor="jit", **kw)
    b.run()
    assert [e.device_plane for e in j.engine.edges] == ["jit"] * 3
    assert [e.device_plane for e in b.engine.edges] == ["jit"] * 3
    assert _placements(b.engine) == _placements(j.engine)
    assert _placements(b.engine)[1] > 0
    _workflow_runs_identical(j, b)
