"""Port parity: repro_torch.obs (sentinels, health probes, SLOs, drift,
request traces) and the probes of the port's engines vs repro.obs on the CPU.

Mirrors tests/test_obs.py.  The trainers start from the reference's
parameters (``convert.load_reference_params``) with Omega from the
seed-fused threefry stream, as in tests/test_torch_fedsim.py.  Tolerances:
probe values and the fault ledger from one round and one flush within 1e-4
x max(1, max|leaf|) (the round engine's tolerance,
tests/test_round_engine.py:77); SLO alert timelines, drift timelines and
fire times, request-tracer samples and span trees exactly equal (host-side
Python on equal inputs); a probed run bit for bit an unprobed one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.comm import netsim as jnetsim  # noqa: E402
from repro.data import make_domains  # noqa: E402
from repro.federated import model as jmodel  # noqa: E402
from repro.federated.network import RoundPlan as JPlan  # noqa: E402
from repro.federated.protocol import FedRFTCATrainer as JTrainer  # noqa: E402
from repro.federated.protocol import ProtocolConfig as JProto  # noqa: E402
from repro.fedsim import AsyncConfig as JAsyncConfig  # noqa: E402
from repro.fedsim import AsyncScheduler as JAsync  # noqa: E402
from repro.fedsim import SyncScheduler as JSync  # noqa: E402
from repro.fleet import Topology as JTopology  # noqa: E402
from repro.robust import get_rule as jget_rule  # noqa: E402
from repro_torch import convert, obs  # noqa: E402
from repro_torch.comm import netsim  # noqa: E402
from repro_torch.federated import model as tmodel  # noqa: E402
from repro_torch.federated.network import RoundPlan  # noqa: E402
from repro_torch.federated.protocol import FedRFTCATrainer as TTrainer  # noqa: E402
from repro_torch.federated.protocol import ProtocolConfig as TProto  # noqa: E402
from repro_torch.fedsim import AsyncConfig, AsyncScheduler, SyncScheduler  # noqa: E402
from repro_torch.fleet import Topology  # noqa: E402
from repro_torch.obs import sentinel  # noqa: E402
from repro_torch.robust import get_rule  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

LEAF_TOL = 1e-4
SIZES = dict(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
             rff_impl="fused", lambda_mmd=2.0)
JCFG = jmodel.ClientConfig(**SIZES)
TCFG = tmodel.ClientConfig(**SIZES)
PROBE_KEYS = {"moment_mass", "attribution_moments", "attribution_w_rf", "update_norm",
              "tgt_update_norm"}


@pytest.fixture(scope="module")
def doms():
    d = make_domains(4, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    return d[:3], d[3]


def _proto(pkg, rounds, **kw):
    ids = [0, 1, 2]
    if pkg == "ref":
        scenario = jnetsim.TraceScenario([JPlan(ids, ids, ids)], cycle=True)
        topo = JTopology.of_groups(kw.pop("topology")) if "topology" in kw else None
        return JProto(n_rounds=rounds, t_c=2, warmup_rounds=0, lr=1e-2, batch_size=32, seed=0,
                      scenario=scenario, topology=topo, **kw)
    scenario = netsim.TraceScenario([RoundPlan(ids, ids, ids)], cycle=True)
    topo = Topology.of_groups(kw.pop("topology")) if "topology" in kw else None
    return TProto(n_rounds=rounds, t_c=2, warmup_rounds=0, lr=1e-2, batch_size=32, seed=0,
                  scenario=scenario, topology=topo, **kw)


def _pair(doms, rounds=2, warmup=1, **kw):
    """A reference and a port trainer from the reference's initial
    parameters, warmed up alike."""
    srcs, target = doms
    jt = JTrainer(srcs, target, JCFG, _proto("ref", rounds, **dict(kw)))
    tt = TTrainer(srcs, target, TCFG, _proto("port", rounds, **dict(kw)), device="cpu")
    convert.load_reference_params(tt, jax.tree_util.tree_map(np.asarray, jt.tgt_params))
    for tr in (jt, tt):
        tr._warmup(warmup)
    return jt, tt


def _close(a, b, tol=LEAF_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert float(np.abs(a - b).max(initial=0.0)) <= tol * max(1.0, float(np.abs(a).max(
        initial=0.0)))


def _probes_close(jp, tp):
    assert set(jp) == set(tp) == PROBE_KEYS
    for k in jp:
        _close(jp[k], tp[k])


# ---- sentinel -----------------------------------------------------------------------------

def test_sentinel_counts_new_signatures_like_retraces():
    """A new shape bumps (jit retraces); a new Python number does not (a
    weakly typed traced scalar); a new static value does."""
    calls = sentinel.count("unit.port.f")
    f = sentinel.wrap("unit.port.f", lambda x, k=0, tag="a": x)
    f(torch.ones(3), k=5)
    f(torch.ones(3), k=7)  # a traced int: no retrace
    f(torch.ones(3), k=True)  # ... but a new type of scalar is
    assert sentinel.count("unit.port.f") == calls + 2
    f(torch.ones(5), k=5)  # new shape
    f(torch.ones(5, dtype=torch.float64), k=5)  # new dtype
    f({"a": torch.ones(5)}, k=5)  # new tree structure
    f(torch.ones(5), k=5, tag="b")  # new static value
    f(torch.ones(5))  # new keyword set
    assert sentinel.count("unit.port.f") == calls + 7
    jf = jax.jit(jobs.sentinel.wrap("unit.ref.f", lambda x: x * 2))
    before = jobs.sentinel.count("unit.ref.f")
    for n in (3, 3, 5):
        jf(jax.numpy.ones(n))
    assert jobs.sentinel.count("unit.ref.f") - before == 2
    assert f(torch.arange(3.0)).tolist() == [0.0, 1.0, 2.0]


def test_sentinel_assert_stable_and_registry():
    before = sentinel.counts()
    g = sentinel.wrap("unit.port.g", lambda x: x + 1)
    reg = obs.MetricsRegistry()
    with obs.use_registry(reg):
        g(torch.ones(2))
        g(torch.ones(2))
    sentinel.assert_stable(before, ("unit.port.g",), expect=1)
    assert reg.counter("jit.retraces").value(plane="unit.port.g") == 1
    g(np.ones(4, np.float32))  # numpy arrays enter by shape and dtype
    with pytest.raises(AssertionError, match="retraced"):
        sentinel.assert_stable(before, ("unit.port.g",), expect=1)


@pytest.mark.parametrize("engine", ["batched", "serial"])
def test_round_planes_stable_like_reference(doms, engine):
    """Four rounds: the batched engine's round plane sees one signature in
    both packages; the serial planes are counted (informative) in both."""
    jt, tt = _pair(doms, rounds=4, engine=engine)
    jb, tb = jobs.sentinel.counts(), sentinel.counts()
    JSync(jt).run(4)
    SyncScheduler(tt).run(4)
    planes = ("engine.round",) if engine == "batched" else (
        "serial.src_step_mmd", "serial.tgt_step", "serial.msg_of")
    for p in planes:
        j = jobs.sentinel.count(p) - jb.get(p, 0)
        t = sentinel.count(p) - tb.get(p, 0)
        assert t == j and t >= 1, (p, j, t)
    if engine == "batched":
        sentinel.assert_stable(tb, ("engine.round",), expect=1)


def test_flush_plane_traces_once(doms):
    jt, tt = _pair(doms, rounds=3, probe=True)
    before = sentinel.counts()
    AsyncScheduler(tt, AsyncConfig(buffer_size=3)).run(3)
    sentinel.assert_stable(before, ("engine.flush",), expect=1)


# ---- health probes ------------------------------------------------------------------------

ROUND_CASES = {
    "mean": {},
    "trimmed_mean": dict(rule="trimmed_mean"),
    "norm_clip_two_tier": dict(rule="norm_clip", topology=[[0, 1], [2]]),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_round_probes_match_reference(doms, case):
    """One round of each engine with ``probe=True``: the same probe values
    (moment mass, attributions, update norms) within the round's tolerance."""
    jt, tt = _pair(doms, probe=True, **ROUND_CASES[case])
    jt.round(1)
    tt.round(1)
    jp, tp = jt.last_probes, tt.last_probes
    _probes_close(jp, tp)
    assert float(tp["moment_mass"]) == pytest.approx(3.0)
    assert np.all(tp["update_norm"] > 0) and float(tp["tgt_update_norm"]) > 0
    if case == "mean":
        assert not np.any(tp["attribution_moments"]) and not np.any(tp["attribution_w_rf"])


def test_flush_probes_and_fault_ledger_match_reference(doms):
    """Two async flushes under the trimmed mean: the flush probes and the
    fault ledger (``quarantine_totals``) as the reference's."""
    jt, tt = _pair(doms, rounds=2, probe=True, rule="trimmed_mean")
    jreg, treg = jobs.MetricsRegistry(), obs.MetricsRegistry()
    with jobs.use_registry(jreg):
        jh = JAsync(jt, JAsyncConfig(buffer_size=2)).run(2)
    with obs.use_registry(treg):
        th = AsyncScheduler(tt, AsyncConfig(buffer_size=2)).run(2)
    assert [h["members"] for h in jh] == [h["members"] for h in th]
    _probes_close(jt.last_probes, tt.last_probes)
    jtot, ttot = jobs.quarantine_totals(jreg), obs.quarantine_totals(treg)
    assert ttot and set(jtot) == set(ttot)
    for m in jtot:
        assert ttot[m] == pytest.approx(jtot[m], abs=LEAF_TOL * max(1.0, jtot[m]))
    jsnap, tsnap = jreg.snapshot(), treg.snapshot()
    for name in ("probe.update_norm", "probe.moment_mass", "probe.update_norm.mean"):
        assert set(jsnap[name]) == set(tsnap[name]) == {"plane=flush"}


def test_emit_probes_schema_equals_reference():
    """One dict through both emitters: the same host arrays and the same
    registry series (gauges, histograms, the ledger)."""
    rng = np.random.default_rng(0)
    probes = {"moment_mass": np.float32(3.0),
              "update_norm": rng.random(4).astype(np.float32),
              "attribution_moments": np.array([0.0, 0.5, 0.0, 1.0], np.float32),
              "attribution_w_rf": np.zeros(4, np.float32)}
    jreg, treg = jobs.MetricsRegistry(), obs.MetricsRegistry()
    jhost = jobs.emit_probes(probes, plane="round", registry=jreg)
    thost = obs.emit_probes({k: torch.as_tensor(v) for k, v in probes.items()}, plane="round",
                            registry=treg)
    for k in probes:
        np.testing.assert_array_equal(jhost[k], thost[k])
        assert jhost[k].shape == thost[k].shape
    assert jreg.snapshot() == treg.snapshot()
    assert obs.quarantine_totals(treg) == jobs.quarantine_totals(jreg) == {1: 0.5, 3: 1.0}
    assert obs.quarantine_totals(treg, kind="w_rf") == {}
    assert obs.emit_probes({}, plane="round") == {}


@pytest.mark.parametrize("engine", ["batched", "serial"])
def test_probed_run_is_bit_for_bit_unprobed(doms, engine):
    """Telemetry off vs on (probes, a registry, a tracer): the same
    parameters bit for bit."""
    _, off = _pair(doms, rounds=3, engine=engine)
    _, on = _pair(doms, rounds=3, engine=engine, probe=True)
    SyncScheduler(off).run(3)
    with obs.use_registry(obs.MetricsRegistry()), obs.use_tracer(obs.Tracer()):
        SyncScheduler(on).run(3)
    for a, b in zip(tree_leaves((off.tgt_params, [off._src_param(i) for i in range(3)])),
                    tree_leaves((on.tgt_params, [on._src_param(i) for i in range(3)]))):
        assert torch.equal(a, b)


def test_last_probes_pipeline_drains(doms):
    _, tt = _pair(doms, rounds=3, probe=True)
    tt.round(1)
    assert tt._pending_probes is not None and tt._last_probes is None
    tt.round(2)  # emits round 1's, queues round 2's
    assert tt._last_probes is not None and tt._pending_probes[0] == "round"
    first = tt._last_probes
    p1 = tt.last_probes
    assert p1 is tt.last_probes and p1 is not first and tt._pending_probes is None


# ---- SLO engine ---------------------------------------------------------------------------

def _slo_stream(eng, objective, rng, n=300):
    t, fired = 0.0, []
    for i in range(n):
        t += float(rng.exponential(0.05))
        bad = 5.0 if (i // 40) % 3 == 2 else 0.1
        v = eng.observe(objective, t, float(rng.choice([0.1, bad])))
        fired.append(None if v is None else v.to_dict())
    return fired


def test_slo_alert_timelines_equal_reference():
    def build(m):
        return m.SloEngine([
            m.Slo("lat", target=0.9, bound=1.0, window_fast_s=0.5, window_slow_s=3.0),
            m.quarantine_slo(max_rate=0.5, window_fast_s=0.03, window_slow_s=0.12),
            m.Slo("up", target=0.9, kind="availability", window_fast_s=1.0, window_slow_s=4.0,
                  min_samples=2)])

    j, t = build(jobs), build(obs)
    assert _slo_stream(j, "lat", np.random.default_rng(3)) == _slo_stream(
        t, "lat", np.random.default_rng(3))
    for eng in (j, t):
        for i, ok in enumerate([True, False, False, True, False, False, False]):
            eng.observe("up", 0.5 * i, ok=ok)
    totals = {0: 0.0, 2: 3.0, 5: 1.0}
    for r in range(1, 6):
        for eng in (j, t):
            eng.feed_quarantine(0.01 * r, objective="robust.quarantine_rate", rounds=r,
                                totals=totals)
    assert [v.to_dict() for v in j.history] == [v.to_dict() for v in t.history]
    assert any(v.detail == "member=2" for v in t.history)
    for bad in (dict(target=1.0, bound=1.0), dict(target=0.9, window_fast_s=2.0,
                                                  window_slow_s=1.0)):
        with pytest.raises(ValueError):
            obs.Slo("x", **bad)
    with pytest.raises(ValueError, match="rounds"):
        t.feed_quarantine(0.0, objective="robust.quarantine_rate", rounds=0)


# ---- drift monitor ------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(alpha=0.3, window=2, k_consecutive=2, calibration_windows=3, threshold_scale=4.0,
         burnin_windows=1),
    dict(alpha=1.0, window=1, k_consecutive=1, threshold=0.5),
    dict(alpha=0.15, window=4, k_consecutive=2, calibration_windows=2, threshold_ratio=2.5,
         burnin_windows=0),
])
def test_drift_timelines_and_fires_equal_reference(kw):
    rng = np.random.default_rng(1)
    stream = [(0.1 * i, (2.0 if i >= 30 else 0.0) + 0.05 * rng.standard_normal(6)
               .astype(np.float32), 4 + i % 3) for i in range(48)]
    fired = {"ref": [], "port": []}
    mons = {"ref": jobs.DriftMonitor(on_alert=lambda p, r: fired["ref"].append(r.t), **kw),
            "port": obs.DriftMonitor(on_alert=lambda p, r: fired["port"].append(r.t), **kw)}
    for name, mon in mons.items():
        assert mon.observe("p", 0.0, stream[0][1], 4) is None  # before a reference
        mon.set_reference("p", np.zeros(6, np.float32))
        for t, m, n in stream:
            mon.observe("p", t, m, n)
            if t == 3.5:
                mon.set_reference("p", np.full(6, 2.0, np.float32))
    assert mons["port"].timeline() == mons["ref"].timeline()
    assert fired["port"] == fired["ref"] and mons["port"].fires == mons["ref"].fires
    jp, jn = mons["ref"].recent_mean("p")
    tp, tn = mons["port"].recent_mean("p")
    np.testing.assert_array_equal(jp, tp)
    assert jn == tn and mons["port"].pair_threshold("p") == mons["ref"].pair_threshold("p")


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shift_at", [120, 122])
def test_drift_refresh_refires_like_reference(shift_at, seed):
    """The serving drift loop at its settings (alpha 0.15, window 4, k 2,
    three calibration windows at scale 4, two burn-in windows), each fire
    re-pinning the reference to the recent window's pooled moment as
    ``AlignerServer.refresh_from_moments`` does.  Batch moments carry noise
    of rank 4 (RFF moments are correlated) that falls with their column
    count; the first reference is a fit's 795-column mean.  Both packages give
    one timeline.  A shift off a window's edge leaves calm batches in the
    first pool, so the re-pinned reference sits short of the shifted stream
    and the monitor fires again as soon as it can: two burn-in and two
    consecutive evaluations after the first fire."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(64).astype(np.float32)
    delta = np.full(64, 1.0, np.float32)
    mix = (rng.standard_normal((64, 4)) / 2.0).astype(np.float32)
    stream = []
    for i in range(200):
        n = int(rng.integers(16, 65))
        noise = mix @ rng.standard_normal(4).astype(np.float32) / np.sqrt(n)
        stream.append((0.01 * i, base + (delta if i >= shift_at else 0.0) + noise, n))
    fit = base + mix @ rng.standard_normal(4).astype(np.float32) / np.sqrt(795)
    kw = dict(alpha=0.15, window=4, k_consecutive=2, calibration_windows=3,
              threshold_scale=4.0, burnin_windows=2)
    mons = {"ref": jobs.DriftMonitor(**kw), "port": obs.DriftMonitor(**kw)}
    for mon in mons.values():
        mon.on_alert = lambda p, r, mon=mon: mon.set_reference(p, mon.recent_mean(p)[0])
        mon.set_reference("p", fit)
        for t, m, n in stream:
            mon.observe("p", t, m, n)
    assert mons["port"].timeline() == mons["ref"].timeline()
    hist = mons["port"].history
    at = [i for i, r in enumerate(hist) if r.fired]
    assert mons["port"].fires == mons["ref"].fires == len(at) >= 1
    assert hist[at[0]].t >= stream[shift_at][0]
    if shift_at % kw["window"]:
        assert at[1] - at[0] == kw["burnin_windows"] + kw["k_consecutive"]


# ---- request tracer -----------------------------------------------------------------------

@pytest.mark.parametrize("rate,seed", [(0.3, 7), (0.1, 0), (1.0, 0), (0.0, 3)])
def test_request_tracer_sampling_equals_reference(rate, seed):
    ids = range(500)
    assert [obs.RequestTracer(rate=rate, seed=seed).sampled(i) for i in ids] == [
        jobs.RequestTracer(rate=rate, seed=seed).sampled(i) for i in ids]


def test_request_tracer_span_trees_equal_reference():
    events = {}
    for name, m in (("ref", jobs), ("port", obs)):
        tracer = m.Tracer()
        rt = m.RequestTracer(rate=1.0, tracer=tracer)
        for rid, t0 in ((0, 1.0), (4, 2.0)):
            assert rt.begin(rid, t0)
            rt.leg(rid, "serve.queue_wait", t0, 0.2)
            rt.leg(rid, "serve.batch_assembly", t0 + 0.2, 0.1)
            rt.leg(rid, "serve.padded_dispatch", t0 + 0.3, 0.4, pid=m.PID_VIRTUAL)
            rt.leg(rid, "serve.batch_assembly", 0.5, 0.01, pid=m.PID_WALL)
            rt.finish(rid, t0 + 0.7)
        rt.begin(9, 3.0)
        rt.leg(9, "serve.queue_wait", 3.0, 0.1)
        rt.finish(9, 3.1)  # incomplete tree: does not count
        rt.finish(99, 4.0)  # never begun: no-op
        rt.emit_admission([("serve.wire_decode", 0.01), ("serve.moment_merge", 0.02),
                           ("serve.w_rf_ship", 0.03)], wall0=0.5)
        assert m.count_request_trees(tracer.events) == 2 and rt.emitted == 3
        assert m.validate_trace(tracer.events) == []
        events[name] = tracer.events
    assert events["port"] == events["ref"]
    assert not obs.RequestTracer(rate=1.0).begin(0, 0.0)  # no ambient tracer


def test_obs_exports_equal_reference():
    assert set(obs.__all__) == set(jobs.__all__)
    assert obs.sentinel.__name__ == "repro_torch.obs.sentinel"
    assert callable(obs.metrics) and obs.metrics() is obs.get_registry()
    for bad in (dict(alpha=0.0), dict(window=0), dict(threshold_ratio=0.5),
                dict(burnin_windows=-1), dict(threshold=None, calibration_windows=0)):
        with pytest.raises(ValueError):
            obs.DriftMonitor(**bad)
    assert get_rule("mean").is_mean and jget_rule("mean").is_mean
