"""The port's spill tier against the JAX package.

``repro_torch.dataflow.spill`` and the spill half of the resident runtime
(``repro_torch.dataflow.device``) run here on ``device="cpu"`` (K2 by its
plain PyTorch version).  These are the JAX suite's ``tests/test_spill.py``
classes on the port's resident plane, at the JAX suite's sizes: W3 at
40,000 orders against a 10,000-cell budget, W1 at scale 0.05 against 256
cells, and W1 at 0.02 with ``MAX_EMIT_CELLS`` 1 << 7.  Every run with a
budget must equal two runs exactly: the port's own run without a budget,
and the JAX package's ``numpy`` host plane on the same inputs
(``Sink.series`` and the sort's row state bit for bit).
"""
import numpy as np
import pytest
import torch

from _propcheck import given, settings, st

import repro.dataflow as jdf
import repro.dataflow.engine as jeng
import repro.dataflow.operators as jops
from repro.core import ReshapeConfig as JaxConfig
from repro.dataflow import spill as jsp
from repro_torch.core import ReshapeConfig
from repro_torch.dataflow import device as tdev
from repro_torch.dataflow import engine as teng
from repro_torch.dataflow import operators as tops
from repro_torch.dataflow import resilience as rs
from repro_torch.dataflow import spill as sp
from repro_torch.dataflow import workflows as twf
from repro_torch.analysis.sanitize import SanitizeError


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The resident plane's many small CPU ops run far faster on one
    thread than on a shared pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _series_equal(a, b):
    return (len(a) == len(b)
            and all(t1 == t2 and np.array_equal(c1, c2)
                    for (t1, c1), (t2, c2) in zip(a, b)))


def _rows_equal(a, b):
    """Per-worker ScopeRows equality (state and scattered), after
    materializing the port's device-resident state."""
    a._device_sync()
    for wa, wb in zip(a.workers, b.workers):
        for ta, tb in ((wa.state, wb.state), (wa.scattered, wb.scattered)):
            if set(ta.keys()) != set(tb.keys()):
                return False
            for k in ta.keys():
                if not np.array_equal(ta.scope_array(int(k)),
                                      tb.scope_array(int(k))):
                    return False
    return True


_RESIDENT = dict(device="cpu", device_executor="jit")


# --------------------------------------------------------------------- #
# Units: config, segments, state                                         #
# --------------------------------------------------------------------- #
class TestSpillUnits:
    def test_config_validation(self):
        with pytest.raises(ValueError):
            sp.SpillConfig(budget_cells=0)
        with pytest.raises(ValueError):
            sp.SpillConfig(budget_cells=64, low_wm=0.9, high_wm=0.5)
        cfg = sp.SpillConfig(budget_cells=100)
        assert cfg.per_worker(4) == 25
        assert cfg.per_worker(1000) == 8          # functional floor

    def test_resolve_budget(self, monkeypatch):
        monkeypatch.delenv("REPRO_DEVICE_BUDGET", raising=False)
        assert sp.resolve_budget(None) is None
        assert sp.resolve_budget(64).budget_cells == 64
        cfg = sp.SpillConfig(budget_cells=32, high_wm=0.9, low_wm=0.1)
        assert sp.resolve_budget(cfg) is cfg
        monkeypatch.setenv("REPRO_DEVICE_BUDGET", "128")
        assert sp.resolve_budget(None).budget_cells == 128
        eng = teng.Engine(device="cpu", device_executor="jit")
        assert eng.device_budget.budget_cells == 128

    def test_segment_roundtrip_and_crc(self):
        k = np.arange(10, dtype=np.int64)
        v = np.linspace(0, 1, 10)
        seg = sp.SpillSegment((k, v), 10)
        assert seg.verify()
        assert np.array_equal(seg.arrays[0], k)
        # the same bytes give the JAX package's checksum
        assert seg.crc == jsp.SpillSegment((k, v), 10).crc
        seg.corrupt()
        assert not seg.verify()

    def test_state_ordering_and_prefetch(self):
        cfg = sp.SpillConfig(budget_cells=64)
        st_ = sp.SpillState(cfg, 2)
        a = sp.SpillSegment((np.array([1, 2], np.int64),), 2)
        b = sp.SpillSegment((np.array([3], np.int64),), 1)
        c = sp.SpillSegment((np.array([4], np.int64),), 1)
        st_.prepend_ring(0, b)       # eviction: newest resident -> front
        st_.prepend_ring(0, a)       # older eviction goes in front of it
        st_.append_ring(0, c)        # fresh overflow -> back
        assert st_.ring_len(0) == 4 and st_.any()
        st_.prefetch(0, lambda x: x)      # identity "upload"
        seg, dev = st_.pop_ring_front(0)
        assert seg is a and dev is not None       # prefetch hit
        assert st_.prefetch_hits == 1
        assert [s.n for s in st_.rings[0]] == [1, 1]
        st_.clear()
        assert not st_.any()

    def test_corrupt_one_and_drain_raises(self):
        cfg = sp.SpillConfig(budget_cells=64)
        st_ = sp.SpillState(cfg, 1)
        st_.append_rows(0, sp.SpillSegment(
            (np.arange(4, dtype=np.int64),), 4))
        assert st_.corrupt_one()
        with pytest.raises(sp.SpillCorruptError):
            st_.drain_rows(0)

    def test_prefetch_upload_copies_on_the_cpu(self):
        wf = twf.build_w3(n_tuples=2000, device_budget=64, **_RESIDENT)
        rt = wf.monitored[0].device
        a = np.arange(5, dtype=np.int64)
        dev, pinned = rt._spill_upload(a)
        assert pinned is None and dev.device.type == "cpu"
        a[0] = 99                    # the copy does not alias the segment
        assert dev.tolist() == [0, 1, 2, 3, 4]


# --------------------------------------------------------------------- #
# The acceptance workflows: W3's row store 4x over its budget; W1        #
# --------------------------------------------------------------------- #
class TestAcceptance:
    def test_w3_4x_over_budget_stays_resident(self, monkeypatch):
        # W3's sort row store holds all 40,000 rows; a 10,000-cell budget
        # is exceeded 4x, and the rings spill on top of that.
        host = jdf.build_w3(strategy="reshape", partition_backend="numpy")
        host.run()
        own = twf.build_w3(strategy="reshape", **_RESIDENT)
        own.run()
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        wf = twf.build_w3(strategy="reshape", device_budget=10_000,
                          **_RESIDENT)
        wf.run()
        inc = wf.engine.incidents
        assert inc.count("demotion") == 0, inc.kinds()
        assert inc.count("mem-pressure") >= 1
        assert wf.engine.tick == own.engine.tick == host.engine.tick
        assert _series_equal(wf.sink.series, own.sink.series)
        assert _series_equal(wf.sink.series, host.sink.series)
        assert _rows_equal(wf.monitored[0], host.monitored[0])
        assert wf.monitored[0].device.spill.rows_spilled > 0
        assert wf.controllers[0].pressure_consumed >= 1
        assert wf.controllers[0].pressure_events == []
        for e in wf.engine.edges:
            assert e.device_plane == "jit"

    def test_w3_4x_over_budget_armed_controller(self, monkeypatch):
        """test_spill.py:109 — the same acceptance with the controller
        armed in-dispatch (``REPRO_DEVICE_CONTROLLER=1``): the pressure the
        spill tier raises reaches the host twin through the drains, and
        the run equals the JAX package's host numpy plane."""
        host = jdf.build_w3(strategy="reshape", partition_backend="numpy")
        host.run()
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        monkeypatch.setenv("REPRO_DEVICE_CONTROLLER", "1")
        wf = twf.build_w3(strategy="reshape", device_budget=10_000,
                          **_RESIDENT)
        dev = wf.monitored[0].device
        assert dev.ctrl is not None and dev.ctrl.active
        wf.run()
        inc = wf.engine.incidents
        assert inc.count("demotion") == 0, inc.kinds()
        assert inc.count("ctrl-mismatch") == inc.count("ctrl-demotion") == 0
        assert inc.count("mem-pressure") >= 1
        assert wf.engine.tick == host.engine.tick
        assert _series_equal(wf.sink.series, host.sink.series)
        assert _rows_equal(wf.monitored[0], host.monitored[0])
        assert ([(e.tick, e.kind, e.skewed, tuple(e.helpers))
                 for e in wf.controllers[0].events]
                == [(e.tick, e.kind, e.skewed, tuple(e.helpers))
                    for e in host.controllers[0].events])
        assert dev.spill.rows_spilled > 0
        assert wf.controllers[0].rounds_on_device > 0
        assert wf.controllers[0].pressure_consumed >= 1
        assert wf.controllers[0].pressure_events == []
        for e in wf.engine.edges:
            assert e.device_plane == "jit"

    def test_w1_probe_with_budget_bit_identical(self, monkeypatch):
        host = jdf.build_w1(strategy="none", scale=0.05,
                            partition_backend="numpy")
        host.run()
        own = twf.build_w1(strategy="none", scale=0.05, **_RESIDENT)
        own.run()
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        wf = twf.build_w1(strategy="none", scale=0.05, device_budget=256,
                          **_RESIDENT)
        wf.run()
        assert wf.engine.incidents.count("demotion") == 0
        assert wf.engine.incidents.count("mem-pressure") >= 1
        assert _series_equal(wf.sink.series, own.sink.series)
        assert _series_equal(wf.sink.series, host.sink.series)
        np.testing.assert_array_equal(wf.sink.counts, host.sink.counts)

    def test_row_boundaries_inside_the_spilled_prefix(self, monkeypatch):
        """The port's row sync is incremental: a boundary may find unsynced
        rows inside the spilled prefix.  Materialize every 37 ticks while
        the sort spills and hold the row state against the host plane at
        the same tick."""
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        host = jdf.build_w3(strategy="reshape", n_tuples=12_000,
                            partition_backend="numpy")
        wf = twf.build_w3(strategy="reshape", n_tuples=12_000,
                          device_budget=2_000, **_RESIDENT)
        checked = 0
        while not (wf.engine.done() and host.engine.done()):
            wf.engine.run_super_tick(1)
            host.engine.run_super_tick(1)
            if wf.engine.tick % 37 == 0:
                rt = wf.monitored[0].device
                behind = bool((rt.rows_synced < rt.spilled_rows).any())
                assert _rows_equal(wf.monitored[0], host.monitored[0])
                checked += behind
        assert checked > 0, "no boundary found unsynced spilled rows"
        assert _series_equal(wf.sink.series, host.sink.series)


# --------------------------------------------------------------------- #
# Invariance: tiny watermarks, chaos mid-spill                           #
# --------------------------------------------------------------------- #
def _pipeline(port: bool, *, budget=None, n=3000, num_keys=24,
              num_workers=4, chunk=8, batch_ticks=4, hot_frac=0.3,
              seed=0, numpy_plane=False):
    """Source -> Filter -> GroupByAgg -> Sink with a controller: the port's
    resident plane (or its numpy plane), else the JAX numpy plane."""
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n) - 1, num_keys - 1).astype(np.int64)
    if hot_frac:
        keys[rng.random(n) < hot_frac] = 0
    vals = rng.uniform(0.0, 10.0, n)
    if port:
        eng_mod, ops, cfg = teng, tops, ReshapeConfig
        kw = (dict(device="cpu", partition_backend="numpy") if numpy_plane
              else dict(_RESIDENT, device_budget=budget))
    else:
        eng_mod, ops, cfg = jeng, jops, JaxConfig
        kw = dict(partition_backend="numpy")
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **kw)
    src = eng.add_source(eng_mod.Source("src", keys, vals,
                                        num_workers * chunk))
    filt = eng.add_op(ops.Filter("filter", num_workers, num_workers * chunk,
                                 predicate=lambda k, v: v >= 0))
    grp = eng.add_op(ops.GroupByAgg("groupby", num_workers, chunk))
    sink = eng.add_op(ops.Sink("sink", num_keys, snapshot_every=batch_ticks))
    eng.connect(src, filt, num_keys)
    eng.connect(filt, grp, num_keys)
    eng.connect(grp, sink, num_keys)
    ctrl = eng.attach_controller(grp, cfg(metric_period=4))
    return eng, sink, ctrl


_REF = {}


def _ref_series(seed):
    """The JAX numpy plane's run, which the port's own resident run without
    a budget must equal first (the port has no in-dispatch controller, so
    its windows are the host plane's): a budgeted run compared with it is
    compared with both."""
    if seed not in _REF:
        eng, sink, _ = _pipeline(False, seed=seed)
        eng.run()
        own, own_sink, _ = _pipeline(True, seed=seed)
        own.run()
        assert _series_equal(own_sink.series, sink.series)
        _REF[seed] = sink.series
    return _REF[seed]


class TestSpillInvariance:
    def test_budget_is_inert_on_the_numpy_plane(self, monkeypatch):
        """No resident runtimes: the environment's budget changes
        nothing."""
        monkeypatch.setenv("REPRO_DEVICE_BUDGET", "48")
        eng, sink, _ = _pipeline(True, seed=0, numpy_plane=True)
        eng.run()
        assert all(op.device is None for op in eng.ops)
        assert _series_equal(sink.series, _ref_series(0))

    @settings(max_examples=8, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_tiny_budget_bit_identical(self, seed):
        """Any tiny budget (every edge spills repeatedly), any stream seed:
        the resident plane matches the host plane bit for bit."""
        stream = seed % 3
        budget = [48, 64, 96, 128][seed % 4]
        eng, sink, _ = _pipeline(True, budget=budget, seed=stream)
        eng.run()
        assert _series_equal(sink.series, _ref_series(stream)), (
            f"seed={seed} budget={budget}")
        assert eng.incidents.count("demotion") == 0
        assert eng.incidents.count("mem-pressure") >= 1

    @settings(max_examples=6, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_chaos_mid_spill_bit_identical(self, seed):
        """Checkpoint fail/recover and the rest of the taxonomy while the
        spill tier is active; the JAX numpy plane's runner under the same
        plan gives the same series."""
        eng, sink, _ = _pipeline(True, budget=64, seed=0)
        plan = rs.FaultPlan.from_seed(seed, max_tick=70)
        rs.ChaosRunner(eng, plan, every_ticks=16).run()
        assert _series_equal(sink.series, _ref_series(0)), (
            f"seed={seed} plan={plan.describe()}")


# --------------------------------------------------------------------- #
# Directed chaos: the two spill fault kinds                              #
# --------------------------------------------------------------------- #
class TestChaosKinds:
    def test_mem_pressure_budget_shrink(self):
        """A mid-run budget shrink forces spill; healed in place (undo
        only, no rollback), results bit-identical."""
        eng, sink, _ = _pipeline(True, budget=None, seed=0)
        runner = rs.ChaosRunner(
            eng, rs.FaultPlan([rs.FaultEvent(rs.MEM_PRESSURE, 20,
                                             duration=12, target=1)]),
            every_ticks=16)          # target=1: the groupby runtime
        runner.run()
        assert _series_equal(sink.series, _ref_series(0))
        assert runner.injected[rs.MEM_PRESSURE] == 1
        assert eng.incidents.count("fault", cause="mem-pressure") == 1
        assert eng.incidents.count("mem-pressure") >= 1   # spill engaged
        assert eng.incidents.count("recovery") == 0       # no rollback
        assert all(o.device is None or o.device.budget_cfg is None
                   for o in eng.ops)

    def test_spill_corrupt_recovers_from_cut(self):
        """A CRC-corrupted spill segment is discarded by rollback to the
        last valid cut; results bit-identical."""
        eng, sink, _ = _pipeline(True, budget=48, seed=0)
        runner = rs.ChaosRunner(
            eng, rs.FaultPlan([rs.FaultEvent(rs.SPILL_CORRUPT, 40)]),
            every_ticks=8)
        runner.run()
        assert _series_equal(sink.series, _ref_series(0))
        assert runner.injected[rs.SPILL_CORRUPT] == 1
        assert eng.incidents.count("recovery") == 1
        inc = eng.incidents.query("fault", cause="spill-corrupt")
        assert len(inc) == 1 and "no spill segments" not in inc[0].action

    @pytest.mark.parametrize("store", ["ring", "rows"])
    def test_crc_failure_raises_and_records(self, store):
        """A poisoned segment read back at a refill or a boundary raises
        and records a ``spill-corrupt`` incident."""
        if store == "ring":
            eng, sink, _ = _pipeline(True, budget=48, seed=0)
        else:
            eng = twf.build_w3(strategy="reshape", n_tuples=6000,
                               device_budget=400, **_RESIDENT).engine
        while not eng.done():
            eng.run_super_tick(1)
            for o in eng.ops:
                spl = o.device.spill if o.device is not None else None
                if spl is None:
                    continue
                segs = spl.rings if store == "ring" else spl.rows
                w = next((w for w, s in enumerate(segs) if s), None)
                if w is None:
                    continue
                # a segment not read back yet: a ring's front (the next
                # refill's), the row log's newest
                (segs[w][0] if store == "ring" else segs[w][-1]).corrupt()
                with pytest.raises(sp.SpillCorruptError):
                    while not eng.done():
                        eng.run_super_tick(1)
                        for o2 in eng.ops:
                            if o2.device is not None:
                                o2.device.sync_host()
                assert eng.incidents.count("spill-corrupt") >= 1
                return
        pytest.fail("no spill segment ever existed to corrupt")


# --------------------------------------------------------------------- #
# Degradation paths: regrow cap, chunked probe emission                  #
# --------------------------------------------------------------------- #
class TestDegradation:
    def test_regrow_capped_incident_once(self):
        """Ring regrowth past the budget's cap (a burst bigger than the
        budget itself) records one ``regrow-capped`` incident and still
        grows."""
        num_keys = 8
        rng = np.random.default_rng(1)
        keys = rng.integers(0, num_keys, 64).astype(np.int64)
        vals = rng.uniform(0, 1, 64)
        eng = teng.Engine(device_budget=sp.SpillConfig(budget_cells=16),
                          **_RESIDENT)
        src = eng.add_source(teng.Source("src", keys, vals, 8))
        grp = eng.add_op(tops.GroupByAgg("groupby", 2, 1))
        eng.add_op(tops.Sink("sink", num_keys))
        eng.connect(src, grp, num_keys)
        eng.connect(grp, eng.sink, num_keys)
        eng.run_super_tick(1)          # small first burst -> small cap
        for n_burst in (600, 1200):    # bursts way past the budget cap
            k = rng.integers(0, num_keys, n_burst).astype(np.int64)
            src.out_edge.send((k, rng.uniform(0, 1, n_burst)))
            eng.run_super_tick(1)
        assert eng.incidents.count("regrow-capped") == 1   # one-time
        assert grp.device.cap >= 1200

    def test_probe_cliff_becomes_chunked_emission(self, monkeypatch):
        """With a budget, a probe whose emit block would pass
        MAX_EMIT_CELLS emits in sub-budget dispatches (``degraded-emit``)
        instead of demoting: bit-identical to the host plane and to the
        port's own run without a budget."""
        host = jdf.build_w1(strategy="none", scale=0.02,
                            partition_backend="numpy")
        host.run()
        own = twf.build_w1(strategy="none", scale=0.02, **_RESIDENT)
        own.run()
        monkeypatch.setattr(tdev, "MAX_EMIT_CELLS", 1 << 7)
        wf = twf.build_w1(strategy="none", scale=0.02,
                          device_budget=100_000, **_RESIDENT)
        wf.run()
        inc = wf.engine.incidents
        assert inc.count("degraded-emit") == 1
        assert inc.count("demotion", cause="probe fanout") == 0
        assert [e.device_plane for e in wf.engine.edges] == ["jit"] * 3
        assert _series_equal(wf.sink.series, own.sink.series)
        assert _series_equal(wf.sink.series, host.sink.series)

    def test_chunked_emission_while_spilling(self, monkeypatch):
        """Chunked emission under a budget the probe's rings pass: a
        sub-dispatch may leave no resident record while spilled ones
        remain, and the next one must refill and pop them (the JAX plane
        stops there and falls behind the host plane)."""
        host = jdf.build_w1(strategy="none", scale=0.05,
                            partition_backend="numpy")
        host.run()
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        monkeypatch.setattr(tdev, "MAX_EMIT_CELLS", 1 << 7)
        wf = twf.build_w1(strategy="none", scale=0.05, device_budget=256,
                          **_RESIDENT)
        wf.run()
        inc = wf.engine.incidents
        assert inc.count("degraded-emit") == 1
        assert inc.count("demotion") == 0
        assert wf.monitored[0].device.spill.refills > 0
        assert _series_equal(wf.sink.series, host.sink.series)

    def test_probe_cliff_without_budget_still_demotes(self, monkeypatch):
        monkeypatch.setattr(tdev, "MAX_EMIT_CELLS", 1 << 7)
        wf = twf.build_w1(strategy="none", scale=0.02, **_RESIDENT)
        wf.run()
        assert wf.engine.incidents.count("demotion",
                                         cause="probe fanout") == 1
        assert wf.engine.incidents.count("degraded-emit") == 0


# --------------------------------------------------------------------- #
# Sanitizer: the spill cross-check                                       #
# --------------------------------------------------------------------- #
class TestSanitizeSpill:
    @pytest.mark.parametrize("mirror", ["spilled_lens", "lens"])
    def test_forked_mirror_trips(self, monkeypatch, mirror):
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        eng, sink, _ = _pipeline(True, budget=48, seed=0)
        forked = False
        kind = "sanitize-spill" if mirror == "spilled_lens" else \
            "sanitize-mirror"
        with pytest.raises(SanitizeError):
            while not eng.done():
                eng.run_super_tick(1)
                for o in eng.ops:
                    rt = o.device
                    if (not forked and rt is not None
                            and rt.spilled_lens.sum() > 0):
                        getattr(rt, mirror)[0] += 1     # fork the mirror
                        forked = True
                    if forked and rt is not None:
                        rt.sync_host()
        assert forked
        assert eng.incidents.count(kind) >= 1

    def test_nan_fold_sum_trips(self, monkeypatch):
        monkeypatch.setenv("REPRO_SANITIZE", "1")
        eng, sink, _ = _pipeline(True, budget=48, seed=0)
        for _ in range(8):
            eng.run_super_tick(1)
        gb = eng.ops[1].device
        gb.state["sums"][0] = float("nan")
        gb._host_fresh = False
        with pytest.raises(SanitizeError):
            gb.sync_host()
        assert eng.incidents.count("sanitize-nan") == 1
