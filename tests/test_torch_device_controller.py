"""The port's in-dispatch skew controller against the JAX package.

``ctrl_step`` runs by its plain version here (``device="cpu"``); the one
test that needs the card holds the CUDA kernel against it.  The module
parity test feeds every window of an armed JAX run (its jit plane, under a
test-scoped ``enable_x64`` shim) to the JAX package's jitted step and to
the port's, and requires every field of the controller state bit for bit.
The analogues of the JAX suite's ``tests/test_device_controller.py`` run
the port's resident plane armed (``device_executor="jit"``,
``device_controller=True``) and hold it against the port's host numpy
plane driven by the same fixed-width windows: controller events, tau,
mitigations, ``Sink.series``, counts, ``sent_per_worker``, routing weights
and counters bit for bit, with no ``ctrl-mismatch``.
"""
import ctypes
import dataclasses

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _propcheck import given, settings, st

import repro.dataflow as jdf
import repro.dataflow.engine as jeng
import repro.dataflow.operators as jops
from repro.core import ReshapeConfig as JaxConfig
from repro.dataflow import device as jdev
from repro_torch import dataflow as tdf
from repro_torch.core import ReshapeConfig
from repro_torch.core.controller import _Mitigation
from repro_torch.core.types import MitigationPhase, TransferMode
from repro_torch.dataflow import checkpoint as ckpt
from repro_torch.dataflow import device as tdev
from repro_torch.dataflow import engine as teng
from repro_torch.dataflow import operators as tops
from repro_torch.kernels import ctrl_step as kctrl
from repro_torch.kernels import ref as kref


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The resident plane's many small CPU ops run far faster on one
    thread than on a shared pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x64_shim(mp):
    """The JAX package's jit plane imports ``jax.experimental.enable_x64``,
    which this jax no longer has; shim it."""
    mp.setattr(jax.experimental, "enable_x64",
               lambda: jax.enable_x64(True), raising=False)


def _skewed_stream(n, num_keys, seed=0, hot_frac=0.4):
    rng = np.random.default_rng(seed)
    keys = np.minimum(rng.zipf(1.3, n) - 1, num_keys - 1).astype(np.int64)
    if hot_frac:
        keys[rng.random(n) < hot_frac] = 0
    return keys, rng.uniform(0.0, 10.0, n)


#: plane -> (engine module, operator module, config class, engine kwargs)
PLANES = {
    "jax-armed": (jeng, jops, JaxConfig,
                  dict(partition_backend="pallas", device_executor="jit",
                       device_controller=True)),
    "numpy": (teng, tops, ReshapeConfig,
              dict(device="cpu", partition_backend="numpy")),
    "resident": (teng, tops, ReshapeConfig,
                 dict(device="cpu", device_executor="jit")),
    "armed": (teng, tops, ReshapeConfig,
              dict(device="cpu", device_executor="jit",
                   device_controller=True)),
}


def _monitored(plane, *, n=3000, num_keys=24, num_workers=4, chunk=8,
               batch_ticks=4, hot_frac=0.4, seed=0, metric_period=1,
               cfg=None, snapshot_every=1, **engine_kw):
    """Source -> GroupByAgg (monitored, SCATTERED-eligible) -> Sink."""
    eng_mod, ops, cfg_cls, kw = PLANES[plane]
    keys, vals = _skewed_stream(n, num_keys, seed, hot_frac)
    eng = eng_mod.Engine(batch_ticks=batch_ticks, **dict(kw, **engine_kw))
    src = eng.add_source(eng_mod.Source("src", keys, vals,
                                        num_workers * chunk))
    grp = eng.add_op(ops.GroupByAgg("groupby", num_workers, chunk))
    sink = eng.add_op(ops.Sink("sink", num_keys,
                               snapshot_every=snapshot_every))
    eng.connect(src, grp, num_keys)
    eng.connect(grp, sink, num_keys)
    ctrl = eng.attach_controller(
        grp, cfg or cfg_cls(metric_period=metric_period))
    return eng, sink, grp, ctrl


def _drive(eng, k, max_ticks=50_000):
    """Fixed-width window schedule (identical across compared runs)."""
    while not eng.done() and eng.tick < max_ticks:
        eng.run_super_tick(k)
    return eng.tick


def _decisions(ctrl):
    return dict(
        events=[(e.tick, e.kind, e.skewed, tuple(e.helpers),
                 tuple(sorted(e.detail.items()))) for e in ctrl.events],
        tau=ctrl.tau, tau_adjustments=ctrl.tau_adjustments,
        iterations=ctrl.iterations_total,
        mitigations={s: (m.phase.name, tuple(m.helpers), m.calm_rounds,
                         m.iteration)
                     for s, m in ctrl.mitigations.items()})


def _series_equal(a, b):
    return (len(a) == len(b)
            and all(t1 == t2 and np.array_equal(c1, c2)
                    for (t1, c1), (t2, c2) in zip(a, b)))


def _assert_runs_identical(a, b):
    """Decisions, ticks, the sink and every edge's routing, bit for bit;
    and no arbitration was needed on the armed side."""
    assert _decisions(a[3]) == _decisions(b[3])
    assert a[0].tick == b[0].tick
    assert _series_equal(a[1].series, b[1].series)
    np.testing.assert_array_equal(a[1].counts, b[1].counts)
    for ea, eb in zip(a[0].edges, b[0].edges):
        np.testing.assert_array_equal(ea.sent_per_worker, eb.sent_per_worker)
        ea.routing.sync_counters()
        eb.routing.sync_counters()
        np.testing.assert_array_equal(ea.routing._count, eb.routing._count)
        np.testing.assert_array_equal(ea.routing.weights, eb.routing.weights)
    for run in (a, b):
        assert run[0].incidents.count("ctrl-mismatch") == 0


def _armed(run):
    dev = run[2].device
    return dev is not None and dev.ctrl is not None and dev.ctrl.active


# --------------------------------------------------------------------- #
# Module parity: the plain ctrl_step against the JAX package's step      #
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def jax_windows():
    """Every window the JAX package's armed jit plane hands its jitted
    ``ctrl_step`` (n 2,500, 4 workers, seed 3, windows of 4): the spec, the
    state before the step (copied: the step donates it), and its inputs."""
    mp = pytest.MonkeyPatch()
    _x64_shim(mp)
    step = jdev._step_for("ctrl")
    calls = []

    def recording(cs, c, arrived, phi, t0, k, left, rate):
        calls.append((cs, {n: np.array(v) for n, v in c.items()},
                      np.array(arrived), np.array(phi), int(t0), int(k),
                      float(left), float(rate)))
        return step(cs, c, arrived, phi, t0, k, left, rate)

    mp.setitem(jdev._STEP_CACHE, "ctrl", recording)
    try:
        run = _monitored("jax-armed", n=2500, num_workers=4, seed=3)
        _drive(run[0], 4)
    finally:
        mp.undo()
    assert run[0].incidents.count("ctrl-mismatch") == 0
    return calls


def _port_spec(cs) -> tdev.CtrlSpec:
    return tdev.CtrlSpec(**{f.name: getattr(cs, f.name)
                            for f in dataclasses.fields(tdev.CtrlSpec)})


@pytest.mark.parametrize("k", [1, 4, 16])
def test_ctrl_step_matches_the_jax_step(jax_windows, k, monkeypatch):
    """Each recorded state and input window, re-run over ``k`` ticks by
    both steps: every ``cstate`` field bit for bit (weights, the routing
    consts, the rings, tau, the mitigation arrays, ``seq_next``, ``epoch``
    and the log), ``arrived`` zeroed.  The windows cover a phase-1 start, a
    phase-1 -> phase-2 move and a retirement."""
    _x64_shim(monkeypatch)
    step = jdev._step_for("ctrl")
    seen = dict(p1_start=0, p1_to_p2=0, retire=0)
    for cs, before, arrived, phi, t0, _, left, rate in jax_windows:
        with jdev._x64():
            out, _ = step(dataclasses.replace(cs, KMAX=max(cs.KMAX, k)),
                          {n: jnp.asarray(v) for n, v in before.items()},
                          jnp.asarray(arrived), jnp.asarray(phi),
                          np.int64(t0), np.int64(k), np.float64(left),
                          np.float64(rate))
            want = {n: np.asarray(v) for n, v in out.items()}
        c = tdev.ctrl_state_from_numpy(before, "cpu")
        arr = torch.from_numpy(arrived.copy())
        kctrl.ctrl_step(_port_spec(cs), c, arr, phi, t0, k, left, rate)
        assert not arr.any()
        for name in kctrl.STATE_DTYPES:
            got = c[name].numpy()
            assert got.dtype == want[name].dtype, name
            assert np.array_equal(got, want[name]), (name, t0, k)
        was_p1 = before["mit_active"] & (before["mit_phase"] == kref.PH1)
        now_p1 = want["mit_active"] & (want["mit_phase"] == kref.PH1)
        seen["p1_start"] += bool((now_p1 & ~was_p1).any())
        seen["p1_to_p2"] += bool((was_p1 & (want["mit_phase"]
                                            == kref.PH2)).any())
        # a retirement, the worker maybe detected again in the window
        seen["retire"] += bool((before["mit_active"] & (
            ~want["mit_active"]
            | (want["mit_seq"] != before["mit_seq"]))).any())
    assert all(seen.values()), seen


def test_ctrl_step_wrapper_checks_and_counts():
    """On the CPU the wrapper runs the plain version and counts no launch;
    a state of the wrong dtype is refused before anything moves."""
    run = _monitored("armed", n=600)
    dev = run[2].device
    c = dev.ctrl.cstate
    before = kctrl.ctrl_step.launches
    arrived = torch.ones(dev.K, dtype=torch.int64)
    kctrl.ctrl_step(dev.ctrl.spec, c, arrived, np.zeros(dev.W), 5, 1,
                    100.0, 32.0)
    assert kctrl.ctrl_step.launches == before
    assert not arrived.any() and int(c["log_n"]) == 1
    bad = dict(c, tau_adj=c["tau_adj"].to(torch.int64))
    with pytest.raises(ValueError, match="tau_adj"):
        kctrl.ctrl_step(dev.ctrl.spec, bad, arrived, np.zeros(dev.W), 6, 1,
                        100.0, 32.0)
    assert int(c["log_n"]) == 1


def test_ctrl_arg_block_layout():
    """The argument block's structure is ``CtrlArgs`` field for field: 22
    pointers, the call's and the spec's scalars, then phi's
    ``PHI_PARAM`` doubles, which a numpy view writes in place."""
    assert kctrl._Args.phi_param.offset == 22 * 8 + 3 * 8 + 6 * 8 + 10 * 4
    assert ctypes.sizeof(kctrl._Args) == (kctrl._Args.phi_param.offset
                                          + 8 * kctrl.PHI_PARAM)
    spec = _default_spec(20, 40)
    state, _, phi = _random_state(0, 20, 40)
    block = kctrl.ArgBlock(spec, tdev.ctrl_state_from_numpy(state, "cpu"))
    block.set_phi(phi)
    assert list(block.args.phi_param[:20]) == phi.tolist()
    assert (block.args.W, block.args.K, block.args.window) == (20, 40, 64)
    assert block.args.eps_upper == spec.eps_upper


def _names(block, cstate):
    """Whether the argument block points at every tensor of ``cstate``."""
    return all(getattr(block.args, name) == cstate[name].data_ptr()
               for name in kctrl.STATE_DTYPES)


def test_ctrl_arg_block_follows_the_state(monkeypatch):
    """The argument block is built with each ``cstate`` and names its
    tensors: every step passes it; it still names them after a
    ``ctrl-mismatch`` host-wins overwrite (in place) and the drain's
    ``log_n`` reset, and ``on_restore`` builds a new state and a new block
    with it.  A block handed over with another state is not used."""
    seen = []
    real = kctrl.ctrl_step

    def recording(spec, c, arrived, phi, t0, k, left, rate, block=None):
        seen.append((block, c))
        return real(spec, c, arrived, phi, t0, k, left, rate, block=block)

    monkeypatch.setattr(kctrl, "ctrl_step", recording)
    k = 4
    eng, _, grp, ctrl = _monitored("armed", n=4000, num_workers=6,
                                   hot_frac=0.6, seed=1, batch_ticks=k)
    dc = grp.device.ctrl
    block = dc.args
    assert block is not None and block.cstate is dc.cstate
    assert _names(block, dc.cstate)
    for _ in range(8):
        eng.run_super_tick(k)
    assert seen and all(b is block and c is dc.cstate for b, c in seen)
    assert dc.args is block and _names(block, dc.cstate)
    # a device table the host twin disagrees with: the drain's host wins
    assert dc.active and dc.meta, "the drain needs logged windows"
    dc.cstate["cdf"][0, 0] += 0.5
    with pytest.warns(RuntimeWarning, match="host wins"):
        dc.drain()
    assert eng.incidents.count("ctrl-mismatch") == 1
    assert dc.args is block and _names(block, dc.cstate)
    assert int(dc.cstate["log_n"]) == 0
    snap = ckpt.snapshot(eng)
    eng.run_super_tick(k)
    ckpt.restore(eng, snap)
    assert dc.active and dc.args is not block
    assert dc.args.cstate is dc.cstate and _names(dc.args, dc.cstate)
    assert not _names(block, dc.cstate)
    del seen[:]
    eng.run_super_tick(k)
    assert seen and all(b is dc.args for b, _ in seen)
    # another state with this block: the call runs on that state
    other = {n: t.clone() for n, t in dc.cstate.items()}
    n_log = int(dc.cstate["log_n"])
    kctrl.ctrl_step(dc.spec, other, torch.zeros(grp.device.K,
                                                dtype=torch.int64),
                    np.zeros(6), eng.tick, 1, 100.0, 0.0, block=dc.args)
    assert int(other["log_n"]) == n_log + 1
    assert int(dc.cstate["log_n"]) == n_log


def _random_state(seed, W, K, window=64, share=4):
    """A controller state with mitigations live in both phases (one worker
    in ``share`` skewed, each with its own helper: at 2 every worker is
    busy, as at W3's tick 9,001), split and one-hot rows, rings of every
    fill, and random workloads and arrivals."""
    rng = np.random.default_rng(seed)
    owner = rng.integers(0, W, K)
    weights = np.zeros((K, W))
    weights[np.arange(K), owner] = 1.0
    split = rng.random(K) < 0.3
    other = (owner + 1 + rng.integers(0, W - 1, K)) % W
    frac = rng.random(K)
    weights[split, owner[split]] = 1.0 - frac[split]
    weights[split, other[split]] += frac[split]
    cdf, primary, is_split = kref.routing_consts(torch.from_numpy(weights))
    workers = rng.permutation(W)
    m = max(1, W // share)
    mit = np.zeros((5, W), np.int32)
    for seq, (s, h) in enumerate(zip(workers[:m], workers[m:2 * m])):
        phase = 2 + seq if seq < 2 else rng.integers(2, 4)   # both live
        mit[:, s] = (1, h, phase, rng.integers(0, 5), seq)
    state = dict(
        weights=weights, cdf=cdf.numpy(), primary=primary.numpy(),
        is_split=is_split.numpy(), owner=owner,
        obs=rng.uniform(0.0, 300.0, (W, window)),
        obs_n=rng.integers(0, window + 1, W), obs_pos=rng.integers(0, window, W),
        tau=np.float64(100.0), tau_adj=np.int32(rng.integers(0, 3)),
        mit_active=mit[0].astype(bool), mit_helper=mit[1], mit_phase=mit[2],
        mit_calm=mit[3], mit_seq=mit[4], seq_next=np.int32(m),
        epoch=np.int32(0), log_phi=np.zeros((64, W)),
        log_arr=np.zeros((64, W)), log_n=np.int32(rng.integers(0, 60)))
    phi = rng.integers(0, 400, W).astype(np.float64)
    return state, rng.integers(0, 60, K).astype(np.int64), phi


def _default_spec(W, K, window=None):
    cfg = ReshapeConfig()
    return tdev.CtrlSpec(
        W=W, K=K, window=window or cfg.sample_window, R=64, eta=cfg.eta,
        metric_period=1, initial_delay=cfg.initial_delay_ticks,
        adaptive_tau=True, eps_lower=cfg.eps_lower, eps_upper=cfg.eps_upper,
        tau_increase=cfg.tau_increase,
        max_tau_adjustments=cfg.max_tau_adjustments,
        catchup_tolerance=cfg.catchup_tolerance,
        retire_window=window or cfg.sample_window, enable_phase1=True,
        horizon=2000.0)


#: (W, K, one worker in ``share`` mitigating): W3's 20 workers, W1's 48,
#: and 64 (two workers a lane of the kernel's warp); a quarter and half.
RANDOM_SHAPES = [pytest.param(W, K, share, id=f"{W}-{K}" + (
    "-half" if share == 2 else "")) for W, K in [(4, 24), (20, 40), (48, 56),
                                                 (64, 128)]
                 for share in (4, 2)]


@pytest.mark.parametrize("W, K, share", RANDOM_SHAPES)
def test_ctrl_step_matches_the_jax_step_on_random_states(W, K, share,
                                                         monkeypatch):
    """Random states with mitigations live in both phases, random workloads
    and arrivals (divergence, adaptive tau and rewrites on most of them),
    through the JAX package's jitted step and the port's plain one: every
    field bit for bit, k 1 and 16."""
    _x64_shim(monkeypatch)
    step = jdev._step_for("ctrl")
    spec = _default_spec(W, K)
    jspec = jdev.CtrlSpec(KMAX=16, **dataclasses.asdict(spec))
    moved = 0
    for seed in range(8):
        state, arrived, phi = _random_state(100 * W + seed, W, K,
                                            share=share)
        # the port's dtypes, which are the JAX package's
        state = {n: t.numpy() for n, t in
                 tdev.ctrl_state_from_numpy(state, "cpu").items()}
        for k in (1, 16):
            with jdev._x64():
                out, _ = step(jspec, {n: jnp.asarray(v)
                                      for n, v in state.items()},
                              jnp.asarray(arrived), jnp.asarray(phi),
                              np.int64(3 + seed), np.int64(k),
                              np.float64(5e4), np.float64(0.0))
                want = {n: np.asarray(v) for n, v in out.items()}
            c = tdev.ctrl_state_from_numpy(state, "cpu")
            kctrl.ctrl_step(spec, c, torch.from_numpy(arrived.copy()), phi,
                            3 + seed, k, 5e4, 0.0)
            for name in kctrl.STATE_DTYPES:
                got = c[name].numpy()
                assert got.dtype == want[name].dtype, name
                assert np.array_equal(got, want[name]), (name, seed, k)
            moved += int(want["tau_adj"]) != int(state["tau_adj"])
            moved += not np.array_equal(want["mit_calm"], state["mit_calm"])
    assert moved > 0


@pytest.mark.gpu
def test_cuda_ctrl_step_matches_plain_version():
    """The kernel on the card against its plain version on the host, from
    the same random states: every field bit for bit, W 20, 48 and 64 with a
    quarter and half of the workers mitigating, W 150 (phi wider than the
    parameter block: staged) and W 200 with a window of 160 (the rings too
    wide for shared memory: read in place), k 1 and 16, a launch counted
    each call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cases = [(W, K, share, 64) for W, K in [(20, 40), (64, 300), (48, 56),
                                            (64, 7)] for share in (4, 2)]
    cases += [(150, 60, 2, 64), (200, 70, 4, 160)]
    for seed, (W, K, share, window) in enumerate(cases):
        for k in (1, 16):
            state, arrived, phi = _random_state(seed, W, K, window, share)
            spec = _default_spec(W, K, window)
            host = tdev.ctrl_state_from_numpy(state, "cpu")
            card = tdev.ctrl_state_from_numpy(state, "cuda")
            arr_h = torch.from_numpy(arrived.copy())
            arr_d = arr_h.cuda()
            kref.ctrl_step(spec, host, arr_h, phi, 3, k, 5e4, 120.0)
            launches = kctrl.ctrl_step.launches
            kctrl.ctrl_step(spec, card, arr_d, phi, 3, k, 5e4, 120.0)
            assert kctrl.ctrl_step.launches == launches + 1
            assert not arr_d.any()
            for name in kctrl.STATE_DTYPES:
                assert torch.equal(card[name].cpu(), host[name]), (
                    name, seed, W, k)


# --------------------------------------------------------------------- #
# The analogues of tests/test_device_controller.py                        #
# --------------------------------------------------------------------- #
class TestBitIdentity:
    @settings(max_examples=12, deadline=None)
    @given(st.integers(min_value=0, max_value=10_000),
           st.floats(min_value=0.0, max_value=0.7),
           st.integers(min_value=0, max_value=1))
    def test_decisions_match_host_controller(self, seed, hot_frac, k_ix):
        """Across random streams, skew levels and window widths the armed
        resident plane's decisions and data plane equal the host numpy
        plane's, driven by the same windows."""
        k = (4, 8)[k_ix]
        kw = dict(n=2500, num_workers=4, hot_frac=hot_frac, seed=seed,
                  batch_ticks=k)
        a = _monitored("numpy", **kw)
        _drive(a[0], k)
        b = _monitored("armed", **kw)
        assert _armed(b)
        _drive(b[0], k)
        _assert_runs_identical(a, b)
        assert b[3].rounds_on_device > 0

    @settings(max_examples=6, deadline=None)
    @given(st.integers(min_value=1, max_value=12),
           st.integers(min_value=0, max_value=10_000))
    def test_checkpoint_cut_preserves_decisions(self, cut_windows, seed):
        """An armed run cut by snapshot and restore at a random super-tick
        continues bit-identically to the host plane's uninterrupted run
        (the controller drains at the cut and re-forms from the restored
        host twin)."""
        k = 4
        kw = dict(n=2000, num_workers=4, seed=seed, batch_ticks=k)
        a = _monitored("numpy", **kw)
        _drive(a[0], k)
        b = _monitored("armed", **kw)
        for _ in range(cut_windows):
            if b[0].done():
                break
            b[0].run_super_tick(k)
        snap = ckpt.snapshot(b[0])
        for _ in range(3):
            if not b[0].done():
                b[0].run_super_tick(k)
        ckpt.restore(b[0], snap)
        _drive(b[0], k)
        _assert_runs_identical(a, b)

    def test_staged_chunks_flush_before_the_rounds(self):
        """A chunk staged on the monitored edge after its tick (a blocking
        upstream's END output) routes under the table it was sent under:
        the step flushes it before any in-dispatch rewrite of that window.
        Source -> RangeSort (emits everything at its END) -> GroupByAgg
        (monitored) -> Sink, against the host plane."""
        def build(plane):
            eng_mod, ops, cfg_cls, kw = PLANES[plane]
            keys, vals = _skewed_stream(3000, 24, seed=5, hot_frac=0.5)
            eng = eng_mod.Engine(batch_ticks=4, **kw)
            src = eng.add_source(eng_mod.Source("src", keys, vals, 64))
            pre = eng.add_op(ops.RangeSort("pre", 4, 200))
            grp = eng.add_op(ops.GroupByAgg("groupby", 4, 8))
            sink = eng.add_op(ops.Sink("sink", 24))
            eng.connect(src, pre, 24)
            eng.connect(pre, grp, 24)
            eng.connect(grp, sink, 24)
            ctrl = eng.attach_controller(grp, cfg_cls(metric_period=1))
            return eng, sink, grp, ctrl

        a, b = build("numpy"), build("armed")
        assert _armed(b)
        flushed = []
        rt = b[2].device
        real = rt.flush_staged

        def counting():
            flushed.append(len(rt.staged))
            real()

        rt.flush_staged = counting
        _drive(a[0], 4)
        _drive(b[0], 4)
        _assert_runs_identical(a, b)
        assert any(flushed), "no chunk was staged across a step"
        assert any(e.kind == "phase1" for e in b[3].events)

    def test_w3_armed_matches_the_jax_numpy_plane(self, monkeypatch):
        """W3 (RangeSort, SBR + SCATTERED) armed through
        ``REPRO_DEVICE_CONTROLLER``: every metric round on the device, and
        the run equal to the JAX package's host numpy plane, row state
        included; the END merge stands the controller down without a
        demotion."""
        kw = dict(strategy="reshape", n_tuples=20_000)
        host = jdf.build_w3(partition_backend="numpy", **kw)
        host.run()
        monkeypatch.setenv("REPRO_DEVICE_CONTROLLER", "1")
        wf = tdf.build_w3(device="cpu", device_executor="jit", **kw)
        dev = wf.monitored[0].device
        assert dev.ctrl is not None and dev.ctrl.active
        wf.run()
        ev = lambda c: [(e.tick, e.kind, e.skewed, tuple(e.helpers),
                         tuple(sorted(e.detail.items()))) for e in c.events]
        assert ev(wf.controllers[0]) == ev(host.controllers[0])
        assert wf.controllers[0].tau == host.controllers[0].tau
        assert wf.engine.tick == host.engine.tick
        assert _series_equal(wf.sink.series, host.sink.series)
        np.testing.assert_array_equal(wf.edges[0].routing.weights,
                                      host.edges[0].routing.weights)
        np.testing.assert_array_equal(wf.monitored[0].sorted_output(),
                                      host.monitored[0].sorted_output())
        rounds = host.controllers[0].metric_messages() // 20
        assert wf.controllers[0].rounds_on_device == rounds
        assert dev.ctrl.steps == rounds        # metric_period 1, batch 1
        assert dev.ctrl.reason == "END"
        inc = wf.engine.incidents
        assert inc.count("ctrl-mismatch") == inc.count("ctrl-demotion") == 0


class TestLifecycle:
    def test_restore_mid_mitigation_reforms(self):
        """A restore while mitigations are live in PHASE_ONE / PHASE_TWO
        re-forms the device controller from the restored host state (it
        stays armed) and continues bit-identically to the host plane."""
        k = 4
        kw = dict(n=4000, num_workers=6, hot_frac=0.6, seed=1, batch_ticks=k)
        a = _monitored("numpy", **kw)
        _drive(a[0], k)
        b = _monitored("armed", **kw)
        for _ in range(8):
            b[0].run_super_tick(k)
        snap = ckpt.snapshot(b[0])
        assert b[3].mitigations, "cut must land mid-mitigation"
        assert all(m.phase in (MitigationPhase.PHASE_ONE,
                               MitigationPhase.PHASE_TWO)
                   for m in b[3].mitigations.values())
        b[0].run_super_tick(k)
        ckpt.restore(b[0], snap)
        assert _armed(b)                    # re-formed
        _drive(b[0], k)
        _assert_runs_identical(a, b)

    def test_restore_demotes_on_unsupported_state(self):
        """A restored host twin with a mitigation the device cannot hold (a
        MIGRATING phase) demotes cleanly on ``on_restore``; host stepping
        finishes the run."""
        b = _monitored("armed", num_workers=4)
        dev = b[2].device
        assert _armed(b)
        b[3].mitigations[1] = _Mitigation(
            skewed=1, helpers=[2], mode=TransferMode.SBR,
            phase=MitigationPhase.MIGRATING)
        dev.ctrl.on_restore()
        assert not dev.ctrl.active
        assert dev.ctrl.reason == "non-reformable mitigation"
        del b[3].mitigations[1]
        _drive(b[0], 4)
        a = _monitored("numpy", num_workers=4)
        _drive(a[0], 4)
        np.testing.assert_array_equal(a[1].counts, b[1].counts)
        assert b[0].incidents.count("ctrl-mismatch") == 0

    @pytest.mark.parametrize("cfg, why", [
        (ReshapeConfig(max_helpers=2), "multi-helper"),
        (ReshapeConfig(control_delay_ticks=2), "control delay"),
        (ReshapeConfig(pinned_helpers={0: 1}), "pinned helpers"),
        (ReshapeConfig(pressure_rounds=True), "pressure rounds"),
    ], ids=["multi-helper", "control-delay", "pinned", "pressure-rounds"])
    def test_ineligible_configs_refuse(self, cfg, why):
        """Multi-helper, delayed-control, pinned and pressure-round configs
        stay host-stepped, the refusal memoized, and the run matches the
        host plane's."""
        b = _monitored("armed", cfg=cfg, n=600)
        dev = b[2].device
        assert dev.ctrl is None and dev._ctrl_refused == why
        assert not dev.arm_controller(b[3])
        _drive(b[0], 4)
        assert dev.ctrl is None
        a = _monitored("numpy", cfg=dataclasses.replace(cfg), n=600)
        _drive(a[0], 4)
        _assert_runs_identical(a, b)

    def test_env_var_arms_controller(self, monkeypatch):
        monkeypatch.setenv("REPRO_DEVICE_CONTROLLER", "1")
        b = _monitored("resident", n=600)
        assert b[0].device_controller and _armed(b)
        monkeypatch.setenv("REPRO_DEVICE_CONTROLLER", "0")
        c = _monitored("resident", n=600)
        assert not c[0].device_controller and c[2].device.ctrl is None

    def test_metric_rounds_no_longer_cut_fused_spans(self):
        """Armed, ``_fusible_ticks`` ignores the metric grid (spans run to
        the horizon); host-stepped, every metric round is a boundary."""
        kw = dict(metric_period=1, batch_ticks=16, n=2000, snapshot_every=0)
        host = _monitored("resident", **kw)
        armed = _monitored("armed", **kw)
        host[0].run_super_tick(host[0]._fusible_ticks(16))   # past delay
        assert host[0]._fusible_ticks(16) == 1
        armed[0].run_super_tick(armed[0]._fusible_ticks(16))
        assert armed[0]._fusible_ticks(16) == 16
        armed[0].run()
        host[0].run()
        assert armed[0].super_ticks < host[0].super_ticks
        np.testing.assert_array_equal(host[1].counts, armed[1].counts)
        assert armed[0].incidents.count("ctrl-mismatch") == 0

    def test_metric_messages_accounting(self):
        """Armed: in-dispatch rounds cost no host traffic, only boundary
        drains count.  Host-stepped on the resident plane: each super-tick's
        boundary drain counts on top of the rounds; on the numpy plane
        there is none."""
        kw = dict(metric_period=1, batch_ticks=8, n=2000)
        host = _monitored("resident", **kw)
        _drive(host[0], 8)
        armed = _monitored("armed", **kw)
        _drive(armed[0], 8)
        plain = _monitored("numpy", **kw)
        _drive(plain[0], 8)
        assert armed[3].rounds_on_device > 0
        assert armed[3].sync_readbacks >= 1          # the END drain
        assert host[3].sync_readbacks > 0
        assert plain[3].sync_readbacks == 0
        assert armed[3].metric_messages() < host[3].metric_messages()
        assert (armed[3].metric_messages()
                == 4 * (plain[3].metric_messages() // 4
                        - armed[3].rounds_on_device
                        + armed[3].sync_readbacks))
        assert armed[0].incidents.count("ctrl-mismatch") == 0
