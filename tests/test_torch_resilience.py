"""The port's checkpoints, chaos harness, oracle and metrics against the JAX
package.

The JAX suite's ``tests/test_resilience.py`` classes run here on the port's
planes, on ``device="cpu"``: ``resident`` (``device_executor="jit"``, K2 by
its plain version), ``numpy`` (the port's host plane) and ``reference``
(``Engine(reference=True)``, the tuple-at-a-time oracle).  Every chaos run
is held against the fault-free run and against the JAX package's
``ChaosRunner`` on its numpy plane under the same plan: ``Sink.series``
bit for bit, and the incident kinds equal apart from those only the
resident plane records (retries, demotions, spill).  ``FaultPlan.from_seed``
gives the same events in both packages, and ``snapshot`` agrees field by
field with the JAX snapshot at the same tick (its CRCs cannot: pickles name
the module).
"""
import dataclasses
import enum
import os

import numpy as np
import pytest
import torch

from _propcheck import given, settings, st

import repro.dataflow as jdf
import repro.dataflow.engine as jeng
import repro.dataflow.operators as jops
from repro.core import ReshapeConfig as JaxConfig
from repro.dataflow import checkpoint as jckpt
from repro.dataflow import metrics as jmetrics
from repro.dataflow import resilience as jrs
from repro_torch import dataflow as tdf
from repro_torch.core import ReshapeConfig
from repro_torch.dataflow import checkpoint as ckpt
from repro_torch.dataflow import engine as teng
from repro_torch.dataflow import metrics as tmetrics
from repro_torch.dataflow import operators as tops
from repro_torch.dataflow import resilience as rs
from repro_torch.dataflow.exchange import Exchange, TorchPartitionBackend


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The resident plane's many small CPU ops run far faster on one
    thread than on a shared pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


#: incident kinds only the resident plane records.
DEVICE_ONLY = {"retry", "demotion", "mem-pressure", "spill-corrupt",
               "regrow-capped", "degraded-emit", "chain-fallback"}

PORT_PLANES = {
    "reference": dict(device="cpu", reference=True),
    "numpy": dict(device="cpu", partition_backend="numpy"),
    "resident": dict(device="cpu", device_executor="jit"),
}


def _series_equal(a, b):
    return (len(a) == len(b)
            and all(t1 == t2 and np.array_equal(c1, c2)
                    for (t1, c1), (t2, c2) in zip(a, b)))


def _plain(x):
    if isinstance(x, enum.Enum):
        return x.name
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return _plain(dataclasses.asdict(x))
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x.item() if isinstance(x, np.generic) else x


def _pipeline(plane="numpy", *, n=3000, num_keys=24, num_workers=4, chunk=8,
              batch_ticks=4, controller=True, hot_frac=0.3, seed=0,
              **engine_kw):
    """Source -> Filter -> GroupByAgg -> Sink on a port plane, or on the
    JAX package's numpy plane (``plane="jax"``); skewed stream, controller
    attached."""
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n) - 1, num_keys - 1).astype(np.int64)
    if hot_frac:
        keys[rng.random(n) < hot_frac] = 0
    vals = rng.uniform(0.0, 10.0, n)
    if plane == "jax":
        eng_mod, ops, cfg = jeng, jops, JaxConfig
        kw = dict(partition_backend="numpy")
    else:
        eng_mod, ops, cfg = teng, tops, ReshapeConfig
        kw = dict(PORT_PLANES[plane], **engine_kw)
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
    ctrl = (eng.attach_controller(grp, cfg(metric_period=4))
            if controller else None)
    return eng, sink, grp, ctrl


_BASELINE = {}


def _baseline(controller=True):
    """The JAX numpy plane's fault-free run."""
    if controller not in _BASELINE:
        eng, sink, _, _ = _pipeline("jax", controller=controller)
        eng.run()
        _BASELINE[controller] = sink
    return _BASELINE[controller]


def _advance(eng, coord=None, until=None):
    while not eng.done() and (until is None or eng.tick < until):
        if coord is not None:
            coord.maybe_checkpoint()
        eng.run_super_tick(eng._fusible_ticks(eng.batch_ticks))


def _jax_events(events):
    return [jrs.FaultEvent(**dataclasses.asdict(e)) for e in events]


_JAX_CHAOS = {}


def _jax_chaos(events, every_ticks):
    """The JAX package's runner on its numpy plane under the same plan:
    (series, incident kinds, recovered)."""
    key = (tuple(events), every_ticks)
    if key not in _JAX_CHAOS:
        eng, sink, _, _ = _pipeline("jax")
        runner = jrs.ChaosRunner(eng, jrs.FaultPlan(_jax_events(events)),
                                 every_ticks=every_ticks)
        runner.run()
        _JAX_CHAOS[key] = (sink.series, eng.incidents.kinds(),
                           runner.recovered)
    return _JAX_CHAOS[key]


def _chaos_identical(plane, events, *, every_ticks=16):
    eng, sink, grp, ctrl = _pipeline(plane)
    runner = rs.ChaosRunner(eng, rs.FaultPlan(events),
                            every_ticks=every_ticks)
    runner.run()
    desc = rs.FaultPlan(events).describe()
    assert _series_equal(sink.series, _baseline().series), (
        f"series diverged under {desc} on the {plane} plane")
    j_series, j_kinds, j_recovered = _jax_chaos(events, every_ticks)
    assert _series_equal(sink.series, j_series)
    kinds = {k: v for k, v in eng.incidents.kinds().items()
             if k not in DEVICE_ONLY}
    assert kinds == {k: v for k, v in j_kinds.items()
                     if k not in DEVICE_ONLY}, (plane, desc)
    assert runner.recovered == j_recovered
    assert eng.chaos is None
    return eng, runner


# --------------------------------------------------------------------- #
# Fault plans: the same seed, the same plan in both packages             #
# --------------------------------------------------------------------- #
class TestFaultPlan:
    @pytest.mark.parametrize("seed", [0, 1, 7, 123, 9_999])
    @pytest.mark.parametrize("max_tick", [50, 18_000])
    def test_from_seed_matches_the_jax_package(self, seed, max_tick):
        a = rs.FaultPlan.from_seed(seed, max_tick=max_tick, n_faults=6)
        b = jrs.FaultPlan.from_seed(seed, max_tick=max_tick, n_faults=6)
        assert ([dataclasses.asdict(e) for e in a.events]
                == [dataclasses.asdict(e) for e in b.events])
        assert a.describe() == b.describe()
        assert rs.ALL_FAULT_KINDS == jrs.ALL_FAULT_KINDS

    def test_seeded_and_validated(self):
        a = rs.FaultPlan.from_seed(7, max_tick=50)
        assert a.events == rs.FaultPlan.from_seed(7, max_tick=50).events
        with pytest.raises(ValueError):
            rs.FaultPlan([rs.FaultEvent("bogus", 1)])


# --------------------------------------------------------------------- #
# Hardened checkpointing                                                 #
# --------------------------------------------------------------------- #
class TestCheckpointing:
    @pytest.mark.parametrize("plane", ["numpy", "resident"])
    def test_no_double_cut_at_tick_zero(self, plane):
        eng, sink, _, _ = _pipeline(plane, controller=False)
        coord = ckpt.CheckpointCoordinator(eng, every_ticks=20)
        assert coord.checkpoints_taken == 1         # the initial cut
        assert coord.maybe_checkpoint() is None     # tick 0: no re-cut
        coord.run()
        ticks = [c.tick for c in coord.cuts]
        assert len(ticks) == len(set(ticks))        # never two per tick
        assert coord.checkpoints_taken == 1 + (eng.tick - 1) // 20

    @pytest.mark.parametrize("plane", ["numpy", "resident"])
    def test_incremental_matches_full_and_reuses(self, plane):
        eng, sink, _, _ = _pipeline(plane)
        inc = ckpt.CutBuilder(eng, incremental=True)
        full = ckpt.CutBuilder(eng, incremental=False)
        for _ in range(4):
            for _ in range(12):
                if eng.done():
                    break
                eng.run_tick()
            si, ci = inc.build()
            sf, cf = full.build()
            assert ci == cf == ckpt.compute_crc(si) == ckpt.compute_crc(sf)
        eng.run()                                   # drain: ops go idle
        si, ci = inc.build()
        _, cf = full.build()
        assert ci == cf
        _, ci2 = inc.build()                        # idle engine: all clean
        assert ci2 == ci
        assert inc.reused_ops > 0 and inc.reused_edges > 0
        assert full.reused_ops == 0 and full.reused_edges == 0

    def test_corrupted_cut_falls_back_to_previous(self):
        eng, sink, _, _ = _pipeline("resident")
        coord = ckpt.CheckpointCoordinator(eng, every_ticks=16)
        _advance(eng, coord, until=40)
        assert len(coord.cuts) >= 2
        prev_tick = coord.cuts[-2].tick
        assert coord.corrupt_latest()
        cut = coord.recover()
        assert cut.tick == prev_tick                # fell back one cut
        assert coord.corrupt_detected == 1
        assert eng.incidents.count("checkpoint-corrupt") == 1
        assert eng.incidents.count("recovery") == 1
        _advance(eng, coord)
        assert _series_equal(sink.series, _baseline().series)

    def test_all_cuts_corrupt_raises(self):
        eng, _, _, _ = _pipeline("resident", controller=False)
        coord = ckpt.CheckpointCoordinator(eng, every_ticks=16)
        for _ in range(20):
            coord.maybe_checkpoint()
            eng.run_tick()
        for c in coord.cuts:
            c.payload["state_units_moved"] = (
                float(c.payload["state_units_moved"]) + 1.0)
        with pytest.raises(rs.CheckpointError):
            coord.recover()

    def test_disk_persistence_retention_and_corrupt_file(self, tmp_path):
        store = str(tmp_path / "cuts")
        eng, sink, _, _ = _pipeline("resident")
        coord = ckpt.CheckpointCoordinator(eng, every_ticks=16,
                                           retention=2, store=store)
        for _ in range(60):
            coord.maybe_checkpoint()
            eng.run_tick()
        files = sorted(os.listdir(store))
        assert len(files) == 2                      # retention bounds disk
        latest = ckpt.load_latest(store)
        assert latest.tick == coord.cuts[-1].tick
        with open(os.path.join(store, files[-1]), "r+b") as f:
            f.seek(12)
            b = f.read(1)
            f.seek(12)
            f.write(bytes([b[0] ^ 0xFF]))
        with pytest.raises(rs.CheckpointError):
            ckpt.load_cut(os.path.join(store, files[-1]))
        assert ckpt.load_latest(store).tick == coord.cuts[-2].tick

    def test_snapshot_isolation(self):
        eng, sink, grp, ctrl = _pipeline("resident")
        for _ in range(30):
            eng.run_tick()
        snap = ckpt.snapshot(eng)
        crc0 = ckpt.compute_crc(snap)
        if sink.series:
            sink.series[-1][1][:] += 7
        sink.counts[:] += 1
        for e in eng.edges:
            e.routing.weights[:, 0] += 0.25
            e.routing._count[:] += 3
            e.tuples_sent += 5
        for w in grp.workers:
            for k in list(w.state.keys()):
                c, s = w.state[k]
                w.state[k] = (c + 1, s + 1.0)
                break
        ctrl.tau += 123.0
        ctrl.tracker.phi[:] += 9.0
        eng.state_units_moved += 42.0
        assert ckpt.compute_crc(snap) == crc0       # the cut is an island

    def test_restore_idempotency_resident_plane(self):
        """restore -> run k -> restore -> run k replays bit-identically on
        the resident plane, the chain re-formed from the restored host."""
        eng, sink, grp, ctrl = _pipeline("resident")
        for _ in range(6):
            eng.run_super_tick(eng._fusible_ticks(eng.batch_ticks))
        snap = ckpt.snapshot(eng)
        crc0 = ckpt.compute_crc(snap)

        def probe(k=4):
            for _ in range(k):
                eng.run_super_tick(eng._fusible_ticks(eng.batch_ticks))
            return [(t, c.copy()) for t, c in sink.series], eng.tick

        s1, t1 = probe()
        ckpt.restore(eng, snap)
        assert ckpt.compute_crc(snap) == crc0       # restore reads only
        for op in eng.ops:                          # uploaded at once
            assert op.device.state is not None
            assert op.device._chain_serial == -1
        s2, t2 = probe()
        assert t1 == t2 and _series_equal(s1, s2)
        ckpt.restore(eng, snap)
        eng.run()
        assert _series_equal(sink.series, _baseline().series)

    @pytest.mark.parametrize("plane", ["numpy", "resident"])
    def test_snapshot_agrees_with_the_jax_snapshot(self, plane):
        """Field by field at the same tick (counts, queues, routing,
        controller bit for bit; float sums within the resident plane's
        bound)."""
        eng, _, _, _ = _pipeline(plane)
        jeng_, _, _, _ = _pipeline("jax")
        for _ in range(9):
            eng.run_super_tick(eng._fusible_ticks(eng.batch_ticks))
            jeng_.run_super_tick(jeng_._fusible_ticks(jeng_.batch_ticks))
        a, b = ckpt.snapshot(eng), jckpt.snapshot(jeng_)
        assert a["tick"] == b["tick"] > 0
        assert a["state_units_moved"] == b["state_units_moved"]
        assert a["sources"] == b["sources"]
        assert _plain(a["controllers"]) == _plain(b["controllers"])
        for ea, eb in zip(a["edges"], b["edges"]):
            assert _plain(ea) == _plain(eb)
        for oa, ob in zip(a["ops"], b["ops"]):
            assert oa["finished"] == ob["finished"]
            for f in ("arrived", "totals", "counts"):
                assert _plain(oa.get(f)) == _plain(ob.get(f))
            if "sums" in oa:
                np.testing.assert_allclose(oa["sums"], ob["sums"],
                                           rtol=1e-6)
            if "series" in oa:
                assert _series_equal(oa["series"], ob["series"])
            for wa, wb in zip(oa["workers"], ob["workers"]):
                for f in ("received", "processed", "emitted"):
                    assert wa[f] == wb[f]
                for qa, qb in zip(wa["queue"], wb["queue"]):
                    np.testing.assert_array_equal(qa, qb)
                for f in ("state", "scattered"):
                    if hasattr(wa[f], "export_dense"):
                        ca, sa, pa = wa[f].export_dense()
                        cb, sb, pb = wb[f].export_dense()
                        np.testing.assert_array_equal(ca, cb)
                        np.testing.assert_array_equal(pa, pb)
                        np.testing.assert_allclose(sa, sb, rtol=1e-12)


# --------------------------------------------------------------------- #
# Retry / backoff on the resident plane                                  #
# --------------------------------------------------------------------- #
class TestDeviceRetry:
    def test_transient_dispatch_fault_retries_in_place(self):
        eng, sink, _, _ = _pipeline("resident")
        plan = rs.FaultPlan([rs.FaultEvent(rs.DISPATCH_FAIL, 12, count=2)])
        runner = rs.ChaosRunner(eng, plan, every_ticks=20)
        runner.run()
        assert _series_equal(sink.series, _baseline().series)
        assert eng.incidents.count("retry") == 2    # healed by retrying
        assert eng.incidents.count("demotion") == 0
        assert runner.injected[rs.DISPATCH_FAIL] == 1

    def test_exhausted_retries_demote_drain_first(self):
        eng, sink, _, _ = _pipeline("resident")
        burst = eng.retry_policy.max_attempts + 1   # one edge exhausts
        plan = rs.FaultPlan([rs.FaultEvent(rs.DISPATCH_FAIL, 12,
                                           count=burst)])
        rs.ChaosRunner(eng, plan, every_ticks=20).run()
        assert _series_equal(sink.series, _baseline().series)
        demos = eng.incidents.query("demotion",
                                    cause="dispatch retries exhausted")
        assert len(demos) == 1
        assert eng.incidents.count("retry") == eng.retry_policy.max_attempts
        # the demoted edge runs the per-chunk torch exchange (K1)
        edge = next(e for e in eng.edges if e.dst.name == demos[0].edge)
        assert edge.device_plane == "demoted(dispatch retries exhausted)"
        assert type(edge.exchange) is Exchange
        assert isinstance(edge.exchange.backend, TorchPartitionBackend)

    def test_demotion_folds_the_spill_tier(self):
        """An edge demoted while it holds spilled spans hands them to the
        host queues (after its resident records) before the per-chunk path
        takes over."""

        class AlwaysFail:
            def dispatch_fault(self, runtime):
                raise rs.InjectedDispatchFault("chaos: injected failure")

        eng, sink, grp, _ = _pipeline("resident", device_budget=48)
        while not grp.device.spilled_lens.any():
            eng.run_super_tick(eng._fusible_ticks(eng.batch_ticks))
        assert not grp.device._chaos_dispatch_ok(AlwaysFail())
        assert grp.device is None
        _advance(eng)
        assert _series_equal(sink.series, _baseline().series)
        assert eng.incidents.count(
            "demotion", cause="dispatch retries exhausted") == 1

    @pytest.mark.parametrize("count,demoted", [(2, 0), (4, 1)])
    def test_fused_chain_consumes_faults_at_its_head(self, count, demoted):
        """Without a controller the Filter -> GroupBy chain stays fused; a
        fault is consumed at the chain head: retried in place, or the head
        demotes and the chain comes apart."""
        eng, sink, grp, _ = _pipeline("resident", controller=False)
        filt = eng.ops[0]
        _advance(eng, until=8)
        assert grp.device.placements == 0           # fused so far
        plan = rs.FaultPlan([rs.FaultEvent(rs.DISPATCH_FAIL, 12,
                                           count=count)])
        rs.ChaosRunner(eng, plan, every_ticks=20).run()
        assert _series_equal(sink.series, _baseline(False).series)
        demos = eng.incidents.query("demotion")
        assert len(demos) == demoted
        assert eng.incidents.count("retry") == min(
            count, eng.retry_policy.max_attempts)
        assert all(i.edge == "filter"
                   for i in eng.incidents.query("retry"))
        if demoted:
            assert filt.device is None and grp.device.chain_up is None
        else:
            assert grp.device.placements == 0       # still fused

    def test_only_injected_faults_are_retried(self, monkeypatch):
        eng, sink, grp, _ = _pipeline("resident")
        _advance(eng, until=8)
        rt = grp.device

        def broken(*args, **kw):
            raise RuntimeError("device failure")

        monkeypatch.setattr(rt, "_dispatch", broken)
        monkeypatch.setattr(rt, "_dispatch_chain", broken)
        eng.chaos = type("Quiet", (), {"dispatch_fault": lambda s, r: None})()
        with pytest.raises(RuntimeError, match="device failure"):
            _advance(eng)
        assert eng.incidents.count("retry") == 0
        assert eng.incidents.count("demotion") == 0


# --------------------------------------------------------------------- #
# The chaos harness: directed per-fault-kind coverage                    #
# --------------------------------------------------------------------- #
DIRECTED = {
    "worker-loss": [rs.FaultEvent(rs.WORKER_LOSS, 21, target=1)],
    "straggler": [rs.FaultEvent(rs.STRAGGLER, 10, duration=6)],
    "corrupt-cut": [rs.FaultEvent(rs.CORRUPT_CUT, 40)],
    "missing-cut": [rs.FaultEvent(rs.MISSING_CUT, 40)],
    "ctrl-drop-delay": [rs.FaultEvent(rs.CTRL_DROP, 9, duration=4),
                        rs.FaultEvent(rs.CTRL_DELAY, 33, duration=3)],
    "dispatch-fail": [rs.FaultEvent(rs.DISPATCH_FAIL, 12, count=1)],
}


class TestChaosDirected:
    @pytest.mark.parametrize("plane", ["reference", "numpy", "resident"])
    @pytest.mark.parametrize("name", sorted(DIRECTED))
    def test_fault_kind(self, name, plane):
        eng, runner = _chaos_identical(plane, DIRECTED[name])
        kinds = [e.kind for e in DIRECTED[name]]
        for k in kinds:
            assert runner.injected[k] == kinds.count(k)
        rollbacks = sum(k not in (rs.DISPATCH_FAIL, rs.MEM_PRESSURE)
                        for k in kinds)
        assert eng.incidents.count("recovery") == rollbacks
        if name == "corrupt-cut":
            assert eng.incidents.count("checkpoint-corrupt") == 1
        if name == "dispatch-fail":
            assert eng.incidents.count("retry") == (plane == "resident")

    def test_worker_loss_mid_mitigation(self):
        """A worker loss while a mitigation is in flight on the resident
        plane replays bit-identically."""
        from repro_torch.core.types import MitigationPhase
        eng, sink, grp, ctrl = _pipeline("resident")
        mit_tick = None
        while not eng.done():
            eng.run_super_tick(eng._fusible_ticks(eng.batch_ticks))
            if any(m.phase is not MitigationPhase.IDLE
                   for m in ctrl.mitigations.values()):
                mit_tick = eng.tick
                break
        assert mit_tick is not None, "no mitigation fired on the probe run"
        eng2, runner = _chaos_identical(
            "resident", [rs.FaultEvent(rs.WORKER_LOSS, mit_tick + 1,
                                       target=1)])
        assert eng2.incidents.count("recovery") == 1


    def test_worker_loss_mid_mitigation_armed_controller(self, monkeypatch):
        """test_resilience.py:470 — a worker loss while a mitigation is in
        flight, with the controller armed in-dispatch
        (``REPRO_DEVICE_CONTROLLER=1``), replays bit-identically to the
        fault-free armed run.  Armed, metric rounds no longer cut windows,
        so that run is held against the JAX package's numpy plane driven by
        the same windows."""
        monkeypatch.setenv("REPRO_DEVICE_CONTROLLER", "1")
        eng, sink, grp, ctrl = _pipeline("resident")
        dev = grp.device
        assert dev.ctrl is not None and dev.ctrl.active
        widths, mit_tick = [], None
        while not eng.done():
            widths.append(eng._fusible_ticks(eng.batch_ticks))
            eng.run_super_tick(widths[-1])
            if (mit_tick is None and dev.ctrl.active
                    and bool(dev.ctrl.cstate["mit_active"].any())):
                mit_tick = eng.tick
        assert mit_tick is not None, "no mitigation fired on the clean run"
        jax_eng, jax_sink, _, jax_ctrl = _pipeline("jax")
        for k in widths:
            jax_eng.run_super_tick(k)
        assert jax_eng.done() and jax_eng.tick == eng.tick
        assert _series_equal(sink.series, jax_sink.series)
        assert _plain(ctrl.events) == _plain(jax_ctrl.events)
        eng2, sink2, _, ctrl2 = _pipeline("resident")
        runner = rs.ChaosRunner(
            eng2, rs.FaultPlan([rs.FaultEvent(rs.WORKER_LOSS, mit_tick + 1,
                                              target=1)]),
            every_ticks=16)
        runner.run()
        assert _series_equal(sink2.series, sink.series)
        assert _plain(ctrl2.events) == _plain(ctrl.events)
        assert runner.injected[rs.WORKER_LOSS] == 1
        assert eng2.incidents.count("recovery") == 1
        assert eng2.incidents.count("ctrl-mismatch") == 0
        assert ctrl2.rounds_on_device > 0


class TestChaosProperty:
    @settings(max_examples=9, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000))
    def test_any_fault_schedule_is_bit_identical(self, seed):
        """Under any seeded fault schedule ``Sink.series`` equals the
        fault-free run and the JAX runner's under the same plan, on a plane
        rotated by the seed, and every rollback is in the log."""
        plane = ["reference", "numpy", "resident"][seed % 3]
        plan = rs.FaultPlan.from_seed(seed, max_tick=70)
        eng, runner = _chaos_identical(plane, list(plan.events))
        rollbacks = sum(runner.injected[k] for k in runner.injected
                        if k not in (rs.DISPATCH_FAIL, rs.MEM_PRESSURE))
        assert eng.incidents.count("recovery") == rollbacks
        assert eng.incidents.count("fault") == sum(runner.injected.values())


# --------------------------------------------------------------------- #
# The reference=True oracle and the §7 metrics                           #
# --------------------------------------------------------------------- #
class TestReferenceOracle:
    @pytest.mark.parametrize("name,kw", [
        ("w1", dict(scale=0.03, num_workers=16)),
        ("w3", dict(n_tuples=3000, num_workers=8)),
    ])
    def test_oracle_matches_the_jax_oracle(self, name, kw):
        port = getattr(tdf, f"build_{name}")(
            strategy="reshape", reference=True, device="cpu",
            device_executor="jit", **kw)
        port.run()
        assert all(op.device is None for op in port.engine.ops)
        assert all(e.device_plane is None for e in port.engine.edges)
        ref = getattr(jdf, f"build_{name}")(strategy="reshape",
                                            reference=True, **kw)
        ref.run()
        assert port.engine.tick == ref.engine.tick
        assert _series_equal(port.sink.series, ref.sink.series)
        resident = getattr(tdf, f"build_{name}")(
            strategy="reshape", device="cpu", device_executor="jit", **kw)
        resident.run()
        assert _series_equal(port.sink.series, resident.sink.series)


class TestMetrics:
    def test_metrics_match_the_jax_package(self):
        wf = tdf.build_w1(strategy="reshape", scale=0.03, num_workers=16,
                          device="cpu")
        wf.run()
        m = wf.meta
        series = wf.sink.series
        final = wf.sink.counts
        args = (series, m["ca"], m["az"], m["actual_ca_az"])
        assert tmetrics.ratio_series(*args) == jmetrics.ratio_series(*args)
        for tol in (0.05, 0.1):
            assert (tmetrics.convergence_tick(*args, tol)
                    == jmetrics.convergence_tick(*args, tol))
        rep = tmetrics.representativeness(series, final)
        assert rep == jmetrics.representativeness(series, final)
        assert tmetrics.area_under(rep) == jmetrics.area_under(rep)
        totals = wf.edges[0].sent_per_worker
        a = tmetrics.PairLoadSampler(m["ca_worker"], m["az_worker"])
        b = jmetrics.PairLoadSampler(m["ca_worker"], m["az_worker"])
        for scale in (1.0, 2.0, 3.0):
            a.sample(totals * scale, baseline=totals)
            b.sample(totals * scale, baseline=totals)
        assert a.samples == b.samples and a.average == b.average
        un = {0: 10.0, 1: 3.0}
        mi = {0: 6.0, 1: 5.0}
        assert (tmetrics.load_reduction_measured(un, mi)
                == jmetrics.load_reduction_measured(un, mi))
