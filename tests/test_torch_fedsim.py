"""Port parity: repro_torch.fedsim (clock, events, availability traces, the
Sync and Async schedulers), the batched engine's buffered ``flush``, the
trainer's async hooks, the typed records and virtual-time tracing vs
repro.fedsim / repro.obs on the CPU.

Mirrors tests/test_fedsim.py, the async cases of tests/test_fleet.py:372-480
and the crash cases of tests/test_robust.py:370-470.  Both packages start
from the reference's parameters (``convert.load_reference_params``) with
Omega from the seed-fused threefry stream.  Tolerances: a flush's
parameters and Adam states 1e-4 (tests/test_round_engine.py:77); scheduler
histories (times, members, staleness, weights, crash rows) exactly equal;
the port's sync/async degeneracy 1e-6 (tests/test_fedsim.py:216); a no-churn
``SyncScheduler`` and ``train()``, and two runs with a server crash, bit
for bit; availability traces and their JSON exactly equal.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import fedsim as jfedsim  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.comm import netsim as jnetsim  # noqa: E402
from repro.data import make_domains  # noqa: E402
from repro.data.domains import Domain  # noqa: E402
from repro.federated import model as jmodel  # noqa: E402
from repro.federated.network import RoundPlan as JPlan  # noqa: E402
from repro.federated.protocol import FedRFTCATrainer as JTrainer  # noqa: E402
from repro.federated.protocol import ProtocolConfig as JProto  # noqa: E402
from repro.fleet import Topology as JTopology  # noqa: E402
from repro.robust import faults as jfaults  # noqa: E402
from repro_torch import convert, fedsim, obs  # noqa: E402
from repro_torch.comm import netsim  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.federated import model as tmodel  # noqa: E402
from repro_torch.federated.network import RoundPlan  # noqa: E402
from repro_torch.federated.protocol import FedRFTCATrainer as TTrainer  # noqa: E402
from repro_torch.federated.protocol import ProtocolConfig as TProto  # noqa: E402
from repro_torch.fleet import Topology  # noqa: E402
from repro_torch.robust import faults as tfaults  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402

LEAF_TOL = 1e-4
DEGENERACY_TOL = 1e-6
SIZES = dict(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
             rff_impl="fused", lambda_mmd=2.0)
JCFG = jmodel.ClientConfig(**SIZES)
TCFG = tmodel.ClientConfig(**SIZES)
PKGS = {"ref": (jfedsim, jnetsim, JTopology), "port": (fedsim, netsim, Topology)}


@pytest.fixture(scope="module")
def doms():
    d = make_domains(5, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    return d[:4], d[4]


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _leaf_err(jtree, ttree) -> float:
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    errs = []
    for a, b in zip(jl, tl):
        a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        ok = np.isfinite(a)
        errs.append(float(np.abs(a[ok] - b[ok]).max()) if ok.any() else 0.0)
    return max(errs)


def _state(tr):
    return (tr.tgt_params, tr.tgt_opt, tr._src_stack, tr._src_opt_stack)


def _proto_kw(pkg, kw):
    """ProtocolConfig keywords for one package: topologies and fault configs
    are given as plain data and built from that package's classes."""
    kw = dict(kw)
    if kw.get("topology") is not None:
        kw["topology"] = (JTopology if pkg == "ref" else Topology).of_groups(kw["topology"])
    if kw.get("faults") is not None:
        kw["faults"] = (jfaults if pkg == "ref" else tfaults).FaultConfig(**kw["faults"])
    if kw.get("scenario") == "full":
        ids = list(range(4))
        kw["scenario"] = (jnetsim.TraceScenario([JPlan(ids, ids, ids)], cycle=True)
                          if pkg == "ref" else
                          netsim.TraceScenario([RoundPlan(ids, ids, ids)], cycle=True))
    return kw


def _pair(doms, warmup=1, sources=None, **kw):
    """A reference and a port trainer from the reference's initial
    parameters, both warmed up alike."""
    srcs, target = doms
    srcs = sources or srcs
    jt = JTrainer(srcs, target, JCFG, JProto(warmup_rounds=0, **_proto_kw("ref", kw)))
    tt = TTrainer(srcs, target, TCFG, TProto(warmup_rounds=0, **_proto_kw("port", kw)),
                  device="cpu")
    convert.load_reference_params(tt, jax.tree_util.tree_map(np.asarray, jt.tgt_params))
    for tr in (jt, tt):
        tr._warmup(warmup)
    return jt, tt


def _reference_uniforms(seed):
    """The reference's ``jax.random`` uniforms for ``channel_uniforms``: the
    key chain fold_in(PRNGKey(seed ^ 0x5EED), chan_key...), then the path."""
    base = jax.random.PRNGKey(seed ^ 0x5EED)

    def uniforms(chan_key, path, n_rows, shape):
        k = base
        for c in (chan_key if isinstance(chan_key, tuple) else (chan_key,)):
            k = jax.random.fold_in(k, c)
        for p in path:
            k = jax.random.fold_in(k, p)
        if n_rows is None:
            u = jax.random.uniform(k, shape, jnp.float32)
        else:
            u = jax.vmap(lambda kk: jax.random.uniform(kk, shape, jnp.float32))(
                jax.random.split(k, n_rows))
        return torch.from_numpy(np.array(u))

    return uniforms


def _reference_fault_draws(tt, seed):
    """The port plan's fault draws replaced by the reference's (keys as in
    tests/test_torch_robust.py)."""
    from test_torch_robust import _reference_draws

    plan = tt._engine.faults
    base = jax.random.PRNGKey(seed ^ 0x5EED)
    plan.draws = lambda kind, chan_key, path, n_rows, shape, device: _reference_draws(
        plan, kind, jax.random.fold_in(jax.random.fold_in(base, chan_key), path[0]), n_rows,
        shape)


# ---- clock, events, availability traces ----------------------------------------------------

def test_event_queue_pops_like_reference():
    """FIFO at equal times, on a sequence with many ties."""
    rng = np.random.default_rng(0)
    times = rng.integers(0, 6, size=60).astype(float) / 2
    qs = {pkg: mods[0].EventQueue() for pkg, mods in PKGS.items()}
    for i, t in enumerate(times):
        for q in qs.values():
            q.push(t, i)
    popped = {pkg: [q.pop() for _ in range(len(times))] for pkg, q in qs.items()}
    assert popped["port"] == popped["ref"]
    assert popped["port"] == sorted(popped["port"], key=lambda e: (e[0], e[1]))
    q = fedsim.EventQueue()
    assert not q and len(q) == 0
    with pytest.raises(ValueError, match="NaN"):
        q.push(float("nan"), "bad")
    c = fedsim.VirtualClock()
    c.advance_to(3.5)
    with pytest.raises(ValueError, match="backwards"):
        c.advance_to(3.0)
    assert c.now == 3.5


def test_events_are_the_reference_dataclasses():
    for name in ("ClientJoined", "ClientDeparted", "ClientUpdateArrived", "SyncBarrier",
                 "EdgeUplinkArrived", "EvalTick", "RequestArrived", "RequestCompleted",
                 "UplinkGaveUp", "ServerCrashed", "EdgeCrashed"):
        j = getattr(jfedsim.events, name)
        t = getattr(fedsim.events, name)
        assert [f.name for f in j.__dataclass_fields__.values()] == [
            f.name for f in t.__dataclass_fields__.values()]
    assert fedsim.ClientJoined(2).client == 2
    assert fedsim.ClientDeparted(1) != fedsim.ClientJoined(1)
    assert fedsim.events.RequestArrived(3).trace_id == -1


TRACES = {
    "markov": lambda m: m.markov_trace(6, 321.5, mean_on=7.3, mean_off=2.1, seed=42),
    "markov_calm": lambda m: m.markov_trace(8, 2000.0, mean_on=30.0, mean_off=3.0, seed=0),
    "markov_no_churn": lambda m: m.markov_trace(3, 50.0, mean_on=5.0, mean_off=0.0, seed=1),
    "duty_staggered": lambda m: m.duty_cycle_trace(5, 40.0, period=4.0, on_fraction=0.5),
    "duty_aligned": lambda m: m.duty_cycle_trace(2, 10.0, period=4.0, on_fraction=0.5,
                                                 stagger=False),
    "duty_full": lambda m: m.duty_cycle_trace(2, 30.0, period=10.0, on_fraction=1.0),
    "always_on": lambda m: m.always_on_trace(3, 5.0),
}


@pytest.mark.parametrize("name", sorted(TRACES))
def test_availability_traces_equal_reference(name):
    j, t = TRACES[name](jfedsim), TRACES[name](fedsim)
    assert t.horizon == j.horizon and t.meta == j.meta
    assert t.intervals == j.intervals  # exact floats: the same numpy draws
    for i in range(t.n_clients):
        assert t.edges(i) == j.edges(i) and t.uptime(i) == j.uptime(i)
    for when in (0.0, 1.9, 2.5, 4.999):
        assert t.available_at(when) == j.available_at(when)


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_trace_json_crosses_packages(tmp_path, direction):
    src, dst = (fedsim, jfedsim) if direction == "port_to_reference" else (jfedsim, fedsim)
    tr = src.markov_trace(4, 321.5, mean_on=7.3, mean_off=2.1, seed=42)
    path = tmp_path / "churn.json"
    src.save_trace(tr, path)
    back = dst.load_trace(path)
    assert type(back).__module__.startswith(dst.__name__)
    assert back.horizon == tr.horizon and back.intervals == tr.intervals
    assert back.meta == tr.meta
    other = tmp_path / "again.json"
    dst.save_trace(back, other)
    assert other.read_bytes() == path.read_bytes()


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_trace_validation_and_coalescing(pkg):
    m = PKGS[pkg][0]
    with pytest.raises(ValueError, match="bad interval"):
        m.AvailabilityTrace(5.0, [[(3.0, 2.0)]])
    with pytest.raises(ValueError, match="overlapping"):
        m.AvailabilityTrace(5.0, [[(0.0, 3.0), (2.0, 4.0)]])
    with pytest.raises(ValueError, match="period"):
        m.duty_cycle_trace(2, 5.0, period=0.0, on_fraction=0.5)
    with pytest.raises(ValueError, match="mean_on"):
        m.markov_trace(2, 5.0, mean_on=0.0, mean_off=1.0)
    t2 = m.AvailabilityTrace(20.0, [[(0.0, 5.0), (5.0, 8.0), (9.0, 20.0)]])
    assert t2.intervals[0] == [(0.0, 8.0), (9.0, 20.0)]
    assert t2.edges(0) == [(0.0, True), (8.0, False), (9.0, True)]


@pytest.mark.parametrize("mode", ["constant", "polynomial", "polynomial:2.0", "auto"])
def test_staleness_weights_modes_equal_reference(mode):
    from repro.federated import aggregation as jagg

    s = np.array([0, 1, 3, 7])
    n = [100, 200, 300, 50]
    w = tagg.staleness_weights(s, mode, n_samples=n)
    np.testing.assert_array_equal(w, jagg.staleness_weights(s, mode, n_samples=n))
    assert w.dtype == np.float32
    if mode != "auto":
        assert w[0] == 1.0  # staleness 0 is exactly unit weight (the degeneracy)
    for bad, match in (("exponential", "unknown staleness"), ("constant", "negative")):
        with pytest.raises(ValueError, match=match):
            tagg.staleness_weights([-1] if match == "negative" else s, bad)


# ---- records and tracing ---------------------------------------------------------------------

def test_records_are_the_reference_records():
    for name in ("RoundRecord", "FlushRecord", "CrashRecord", "EvalRecord", "CommRecord"):
        j, t = getattr(jobs.records, name), getattr(obs.records, name)
        assert list(j.__dataclass_fields__) == list(t.__dataclass_fields__)
    row = obs.RoundRecord(t=1.5, round=2, participants=3)
    assert row["t"] == 1.5 and "acc" not in row
    row["acc"] = 0.9
    assert set(dict(row)) == {"t", "round", "participants", "acc"}
    with pytest.raises(KeyError):
        row["nope"] = 1.0
    hist = [obs.FlushRecord(t=2.0, flush=1, version=1, members=[0], staleness=[0],
                            weights=[1.0]), obs.CrashRecord(t=3.0, crash="edge", edge=1,
                                                            lost=[2]), {"x": 1}]
    jhist = [jobs.FlushRecord(t=2.0, flush=1, version=1, members=[0], staleness=[0],
                              weights=[1.0]), jobs.CrashRecord(t=3.0, crash="edge", edge=1,
                                                               lost=[2]), {"x": 1}]
    assert obs.as_rows(hist) == jobs.as_rows(jhist)


def _emit(m, tracer):
    tracer.begin("round", 0.5, args={"round": 1})
    tracer.complete("compute", 0.25, 1.0, tid=2, args={"client": 1})
    tracer.instant("checkpoint", 1.25, args={"flushes": 3})
    tracer.end("round", 1.5)
    tracer.complete("serve.request", 2.0, 1.0, tid=9, args={"trace_id": 4})
    for leg, ts in (("serve.queue_wait", 2.0), ("serve.batch_assembly", 2.5),
                    ("serve.padded_dispatch", 2.75)):
        tracer.complete(leg, ts, 0.25, tid=9, args={"trace_id": 4})
    with tracer.span("wall"):
        pass
    with pytest.raises(ValueError, match="negative duration"):
        tracer.complete("bad", 0.0, -1.0)


def test_tracer_equals_reference_tracer(tmp_path):
    j, t = jobs.Tracer(), obs.Tracer()
    _emit(jobs, j)
    _emit(obs, t)
    virt = lambda tr: [e for e in tr.events if e["pid"] == obs.PID_VIRTUAL]  # noqa: E731
    assert virt(t) == virt(j)
    assert [e["name"] for e in t.events] == [e["name"] for e in j.events]
    assert obs.validate_trace(t.events) == [] == jobs.validate_trace(j.events)
    assert obs.count_request_trees(t.events) == 1 == jobs.count_request_trees(j.events)
    t.write(tmp_path / "t.json")
    assert obs.validate_trace_file(tmp_path / "t.json", require_request_trees=1) == []
    assert jobs.validate_trace_file(tmp_path / "t.json", require_request_trees=1) == []
    bad = [{"name": "a", "ph": "B", "ts": 5.0, "pid": 2, "tid": 0},
           {"name": "b", "ph": "E", "ts": 1.0, "pid": 2, "tid": 0},
           {"name": "c", "ph": "E", "ts": 1.0, "pid": 2, "tid": 1},
           {"name": "d", "ph": "X", "ts": 1.0, "pid": 2, "tid": 1},
           {"name": "e", "ph": "B", "ts": 1.0, "pid": 2, "tid": 3}, {"ph": "i"}]
    assert obs.validate_trace(bad) == jobs.validate_trace(bad) and len(obs.validate_trace(bad)) == 6
    assert obs.get_tracer() is None
    with obs.use_tracer() as tr:
        assert obs.get_tracer() is tr
    assert obs.get_tracer() is None


# ---- the trainer's async hooks and the engine's flush --------------------------------------

FLUSH_CASES = {
    "flat": dict(kw={}, buf=[1, 0, 1, 1], stale=[0, 0, 2, 1]),
    "two_tier": dict(kw=dict(topology=[[0, 1], [2, 3]], client_chunk=3), buf=[1, 1, 0, 1],
                     stale=[1, 0, 0, 3]),
    "trimmed_mean_byzantine": dict(kw=dict(rule="trimmed_mean", faults=dict(
        byzantine=(0,), byzantine_mode="scale", byzantine_scale=100.0)), buf=[1, 1, 1, 1],
        stale=[0, 1, 0, 2]),
    "finite_mean_nan_two_tier": dict(kw=dict(rule="finite_mean", topology=[[0, 2], [1, 3]],
                                             faults=dict(corrupt_moments=0.5, corrupt_w_rf=0.5,
                                                         corrupt_classifier=0.5,
                                                         corruption="nan")),
                                     buf=[1, 1, 1, 0], stale=[2, 0, 1, 0]),
    # one stale client: the classifier's merged mass is under 1 (its 1e-9 floor)
    "single_stale_client": dict(kw={}, buf=[0, 0, 1, 0], stale=[0, 0, 3, 0]),
    "qint8": dict(kw=dict(transport="wire", codec="qint8"), buf=[0, 1, 1, 1],
                  stale=[0, 1, 0, 4]),
    "qint8_two_tier": dict(kw=dict(transport="wire", codec="qint8", edge_codec="qint8",
                                   topology=[[0, 1], [2, 3]]), buf=[1, 1, 1, 1],
                           stale=[0, 0, 3, 1]),
}


@pytest.mark.parametrize("case", sorted(FLUSH_CASES))
def test_flush_matches_reference(doms, case):
    """Two flushes (f = 1, then f = 2 with the classifier merge) on equal
    inputs drawn through the trainers' async hooks: parameters and Adam
    states within 1e-4, non-finite positions equal.  The qint cases feed the
    port the reference's uniforms (the dispatch downlink's two-level key
    included); the fault cases its fault draws."""
    spec = FLUSH_CASES[case]
    kw = dict(n_rounds=0, t_c=2, batch_size=32, seed=0, **spec["kw"])
    jt, tt = _pair(doms, **kw)
    if tt._engine.channel or tt._engine.edge_channel:
        tt._engine.channel_uniforms = _reference_uniforms(kw["seed"])
    if tt._engine.faults is not None:
        _reference_fault_draws(tt, kw["seed"])
    assert _leaf_err(_state(jt), _state(tt)) <= LEAF_TOL
    start = tree_map(torch.clone, tt._src_opt_stack)
    buf = np.float32(spec["buf"])
    wts = tagg.staleness_weights(spec["stale"], "polynomial") * buf
    jbase = jax.random.PRNGKey(kw["seed"] ^ 0x5EED)
    for f in (1, 2):
        draws = []
        for i in range(tt.k):
            jd, td = jt.draw_client_dispatch(i), tt.draw_client_dispatch(i)
            for a, b in zip(jd, td):
                np.testing.assert_array_equal(a, b)
            draws.append(jd)
        xt = jt.draw_target_steps()
        np.testing.assert_array_equal(xt, tt.draw_target_steps())
        jmsgs, tmsgs = [], []
        for d in (2 * f - 1, 2 * f):  # two dispatches: clients 0, 2 got one, 1, 3 the other
            jkey = jax.random.fold_in(jax.random.fold_in(jbase, 0x00A5), d)
            jmsgs.append(np.asarray(jt.target_message(chan_key=jkey)))
            tmsgs.append(tt.target_message(chan_key=(0x00A5, d)))
            assert _leaf_err(jmsgs[-1], tmsgs[-1]) <= LEAF_TOL
        xs = np.stack([d[0] for d in draws], axis=1)
        ys = np.stack([d[1] for d in draws], axis=1)
        x_msg = np.stack([d[2] for d in draws])
        tgt_msgs = np.stack([jmsgs[i % 2] for i in range(tt.k)])
        jbatch = {"xs": jnp.asarray(xs), "ys": jnp.asarray(ys.astype(np.int32)),
                  "x_msg": jnp.asarray(x_msg), "xt_steps": jnp.asarray(xt),
                  "tgt_msgs": jnp.asarray(tgt_msgs), "bmask": jt._bmask,
                  "msg_mask": jt._msg_mask}
        tbatch = {"xs": torch.from_numpy(xs), "ys": torch.from_numpy(ys),
                  "x_msg": torch.from_numpy(x_msg), "xt_steps": torch.from_numpy(xt),
                  "tgt_msgs": torch.from_numpy(tgt_msgs), "bmask": tt._bmask,
                  "msg_mask": tt._msg_mask}
        do_clf = f % kw["t_c"] == 0
        jout = jt._engine.flush(*_state_args(jt), jbatch, {
            "buf": jnp.asarray(buf), "weights": jnp.asarray(wts), "do_clf": jnp.asarray(do_clf)},
            chan_key=jax.random.fold_in(jbase, f))
        tout = tt._engine.flush(*_state_args(tt), tbatch, {
            "buf": torch.from_numpy(buf), "weights": torch.from_numpy(wts), "do_clf": do_clf},
            chan_key=f)
        assert _leaf_err(jout[:4], tout) <= LEAF_TOL
        jt._src_stack, jt._src_opt_stack, jt.tgt_params, jt.tgt_opt = jout[:4]
        tt._src_stack, tt._src_opt_stack, tt.tgt_params, tt.tgt_opt = tout
    # the rows outside the buffer keep their local steps' Adam state untouched
    out = torch.from_numpy(np.flatnonzero(buf == 0))
    for a, b in zip(tree_leaves(start), tree_leaves(tt._src_opt_stack)):
        if a.ndim and out.numel():
            assert torch.equal(a[out], b[out])


def _state_args(tr):
    return tr._src_stack, tr._src_opt_stack, tr.tgt_params, tr.tgt_opt


def test_flush_without_channel_key_raises(doms):
    _, tt = _pair(doms, warmup=0, n_rounds=0, batch_size=32, transport="wire", codec="qint8")
    with pytest.raises(ValueError, match="chan_key"):
        tt._engine.flush(*_state_args(tt), {}, {"buf": None, "weights": None, "do_clf": False})
    with pytest.raises(ValueError, match="chan_key"):
        tt.target_message()


def test_dispatch_key_draws_apart_from_round_keys(doms):
    """A two-level key draws its own uniforms; an int key draws what it drew
    before the two-level form existed (the round's draws are unchanged)."""
    _, tt = _pair(doms, warmup=0, n_rounds=0, batch_size=32, transport="wire", codec="qint8")
    draw = tt._engine.channel_uniforms
    words = [tt._engine.channel_seed & 0xFFFFFFFF, 165, 3, 0]
    seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1
    want = torch.rand((5,), generator=torch.Generator().manual_seed(seed))
    assert torch.equal(draw(165, (3, 0), None, (5,)), want)
    dispatch = draw((0x00A5, 3), (), None, (5,))
    assert not torch.equal(dispatch, want)
    assert torch.equal(dispatch, draw((0x00A5, 3), (), None, (5,)))
    assert not torch.equal(dispatch, draw((0x00A5, 4), (), None, (5,)))


# ---- schedulers ------------------------------------------------------------------------------

def _rows(hist):
    """History rows without the accuracy, which is compared on its own."""
    return [{k: v for k, v in h.to_dict().items() if k != "acc"} for h in hist]


def _accs(hist):
    return [h.get("acc") for h in hist]


def _assert_histories_equal(jh, th):
    assert [type(h).__name__ for h in th] == [type(h).__name__ for h in jh]
    assert _rows(th) == _rows(jh)
    for a, b in zip(_accs(jh), _accs(th)):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) < 1e-6


def _links(m, spec):
    return m.LinkScenario(links=[m.LinkModel(**link) for link in spec["links"]],
                          **spec.get("scenario", {}))


SCHED_CASES = {
    "churn_heterogeneous_links": dict(
        kw=dict(t_c=4), cfg=dict(buffer_size=2, staleness="auto"),
        avail=dict(mean_on=12.0, mean_off=6.0, seed=5),
        links=dict(links=[dict(latency_s=0.5 + 0.3 * i, jitter_s=0.2, drop=0.2)
                          for i in range(4)], scenario=dict(backhaul_bps=1e4)),
        flushes=8, eval_every=4),
    "edge_buffers_edge_links": dict(
        kw=dict(t_c=3, topology=[[0, 1], [2, 3]]),
        cfg=dict(buffer_size=2, staleness="polynomial", eval_interval=1.5),
        links=dict(links=[dict(latency_s=0.5 + 0.3 * i, jitter_s=0.1) for i in range(4)]),
        edge_links=dict(links=[dict(latency_s=0.7), dict(latency_s=0.2, jitter_s=0.3)]),
        flushes=6),
    "giveups": dict(
        kw=dict(t_c=3), cfg=dict(buffer_size=2, compute_s=1.0),
        links=dict(links=[dict(latency_s=0.3), dict(latency_s=0.3), dict(drop=1.0),
                          dict(latency_s=0.4, drop=0.5)],
                   scenario=dict(retry_s=0.5, max_retries=2)),
        flushes=6),
    "server_and_edge_crash": dict(
        kw=dict(t_c=2, topology=[[0, 1], [2, 3]], transport="wire", codec="qint8"),
        cfg=dict(buffer_size=2, compute_s=1.0, server_crash_times=(4.5,),
                 checkpoint_interval_s=2.0, edge_crash_times=((2.0, 0),), restart_delay_s=0.5),
        links=dict(links=[dict(latency_s=0.4 * (i + 1)) for i in range(4)]),
        edge_links=dict(links=[dict(latency_s=0.3), dict(latency_s=0.3)]),
        flushes=6),
}


def _scheduler(pkg, tr, spec, tmp_path=None):
    m, net, _ = PKGS[pkg]
    cfg = dict(spec["cfg"])
    if cfg.get("server_crash_times"):
        cfg["ckpt_dir"] = str(tmp_path / pkg)
    avail = (m.markov_trace(tr.k, horizon=4000.0, **spec["avail"]) if "avail" in spec
             else None)
    edge = _links(net, spec["edge_links"]) if "edge_links" in spec else None
    return m.AsyncScheduler(tr, m.AsyncConfig(**cfg), availability=avail,
                            links=_links(net, spec["links"]), edge_links=edge)


@pytest.mark.parametrize("case", sorted(SCHED_CASES))
def test_async_scheduler_history_equals_reference(doms, tmp_path, case):
    """Churn, heterogeneous links with backhaul contention, per-edge buffers
    over edge links, give-ups, server and edge crashes: the histories are
    equal row for row, the comm logs equal, parameters within 1e-4 (the
    qint8 case on the reference's uniforms)."""
    spec = SCHED_CASES[case]
    kw = dict(n_rounds=0, batch_size=32, seed=0, **spec["kw"])
    jt, tt = _pair(doms, **kw)
    if tt._engine.channel:
        tt._engine.channel_uniforms = _reference_uniforms(kw["seed"])
    js, ts = _scheduler("ref", jt, spec, tmp_path), _scheduler("port", tt, spec, tmp_path)
    jh = js.run(spec["flushes"], eval_every=spec.get("eval_every", 0))
    th = ts.run(spec["flushes"], eval_every=spec.get("eval_every", 0))
    _assert_histories_equal(jh, th)
    assert (ts.flushes, ts.version, ts.dispatches, ts.giveups) == (
        js.flushes, js.version, js.dispatches, js.giveups)
    assert ts.clock.now == js.clock.now
    assert ts.payload_bytes == js.payload_bytes
    assert tt.comm.bytes_by_kind == jt.comm.bytes_by_kind
    assert tt.ingress_bytes == jt.ingress_bytes
    np.testing.assert_array_equal(tt.client_versions, jt.client_versions)
    assert tt.model_version == jt.model_version
    assert _leaf_err(_state(jt), _state(tt)) <= LEAF_TOL
    if case == "giveups":
        assert ts.giveups >= 1
        assert 2 not in {c for h in th if "members" in h for c in h["members"]}
    if case == "server_and_edge_crash":
        crashes = [h for h in th if "crash" in h]
        assert {h["crash"] for h in crashes} == {"server", "edge"}
        assert len(ts.recoveries) == 1 and ts.recoveries[0]["rollback_s"] <= 2.0


def test_sync_scheduler_history_equals_reference(doms):
    """Per-edge backhaul legs on heterogeneous links with an availability
    trace: barrier times and participants equal, parameters within 1e-4."""
    kw = dict(n_rounds=4, t_c=2, batch_size=32, seed=0, topology=[[0, 1], [2, 3]])
    jt, tt = _pair(doms, **kw)
    hists = []
    for pkg, tr in (("ref", jt), ("port", tt)):
        m, net, _ = PKGS[pkg]
        links = net.LinkScenario(links=[net.LinkModel(latency_s=0.3 * (i + 1), jitter_s=0.2)
                                        for i in range(4)])
        edge = net.LinkScenario(links=[net.LinkModel(latency_s=2.0), net.LinkModel(
            latency_s=0.25, drop=0.3)], retry_s=0.5, max_retries=1)
        avail = m.duty_cycle_trace(4, 100.0, period=3.0, on_fraction=0.7)
        hists.append(m.SyncScheduler(tr, availability=avail, links=links, edge_links=edge,
                                     compute_s=[1.0, 0.5, 1.5, 1.0]).run(4, eval_every=2))
    _assert_histories_equal(*hists)
    assert _leaf_err(_state(jt), _state(tt)) <= LEAF_TOL


def test_sync_scheduler_no_churn_is_train(doms):
    kw = dict(n_rounds=5, t_c=2, warmup_rounds=1, batch_size=32, seed=0)
    full = _proto_kw("port", dict(scenario="full"))["scenario"]
    tr_a = TTrainer(*doms, TCFG, TProto(scenario=full, **kw), device="cpu")
    tr_a.train()
    tr_b = TTrainer(*doms, TCFG, TProto(scenario=full, **kw), device="cpu")
    hist = fedsim.SyncScheduler(tr_b).run(5)
    for a, b in zip(tree_leaves(_state(tr_a)), tree_leaves(_state(tr_b))):
        assert torch.equal(a, b)
    assert tr_a.comm.total == tr_b.comm.total
    assert [h["t"] for h in hist] == [1.0, 2.0, 3.0, 4.0, 5.0]
    assert tr_b.model_version == 5 and (tr_b.client_versions == 5).all()


@pytest.mark.parametrize("ragged", [False, True])
def test_async_degenerates_to_the_batched_round(doms, ragged):
    """Uniform latencies, no churn, buffer_size = K: every flush a full
    buffer at staleness 0, parameters within 1e-6 of ``train()``'s, the comm
    logs equal (tests/test_fedsim.py:216-268)."""
    sources = doms[0][:3]
    if ragged:
        sources = [sources[0], Domain("s1", sources[1].x[:, :70], sources[1].y[:70]),
                   Domain("s2", sources[2].x[:, :20], sources[2].y[:20])]
    k, rounds = 3, 6
    kw = dict(n_rounds=rounds, t_c=2, local_steps=1 if ragged else 2, warmup_rounds=2,
              batch_size=32, message_batch_size=64 if ragged else 256, seed=0)
    ids = list(range(k))
    full = netsim.TraceScenario([RoundPlan(ids, ids, ids)], cycle=True)
    tr_sync = TTrainer(sources, doms[1], TCFG, TProto(scenario=full, **kw), device="cpu")
    tr_sync.train()
    tr_async = TTrainer(sources, doms[1], TCFG, TProto(scenario=full, **kw), device="cpu")
    links = netsim.LinkScenario(links=[netsim.LinkModel(latency_s=0.25) for _ in range(k)])
    hist = fedsim.AsyncScheduler(tr_async, fedsim.AsyncConfig(
        buffer_size=k, staleness="polynomial"), links=links).run(rounds)
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(_state(tr_sync)), tree_leaves(_state(tr_async))))
    assert err <= DEGENERACY_TOL
    assert all(h["staleness"] == [0] * k and h["weights"] == [1.0] * k for h in hist)
    assert tr_sync.comm.bytes_by_kind == tr_async.comm.bytes_by_kind
    assert (tr_sync.comm.data_messages, tr_sync.comm.w_rf, tr_sync.comm.classifier) == (
        tr_async.comm.data_messages, tr_async.comm.w_rf, tr_async.comm.classifier)
    assert tr_async.model_version == rounds and (tr_async.client_versions == rounds).all()


def test_server_crash_replay_is_bit_for_bit(doms, tmp_path):
    def run(d):
        tr = TTrainer(doms[0][:3], doms[1], TCFG, TProto(n_rounds=0, t_c=2, warmup_rounds=1,
                                                         batch_size=32, seed=0), device="cpu")
        sched = fedsim.AsyncScheduler(tr, fedsim.AsyncConfig(
            buffer_size=3, compute_s=1.0, server_crash_times=(5.5,), checkpoint_interval_s=2.0,
            ckpt_dir=str(d)))
        return tr, sched, sched.run(8)

    tr_a, s_a, h_a = run(tmp_path / "a")
    tr_b, _, h_b = run(tmp_path / "b")
    assert h_a == h_b and s_a.flushes == 8
    (rec,) = s_a.recoveries
    assert 0.0 <= rec["rollback_s"] <= 2.0 and rec["restored_flush"] < 8
    for a, b in zip(tree_leaves(_state(tr_a)), tree_leaves(_state(tr_b))):
        assert torch.equal(a, b)


def test_virtual_time_trace_equals_reference(doms):
    """The port's virtual-time trace of a run with churn, an eval tick, a
    crash and checkpoints passes validate_trace and has the reference's
    events: names, phases, lanes, times, durations and arguments (the eval
    tick's accuracy within 1e-6)."""
    kw = dict(n_rounds=0, t_c=3, batch_size=32, seed=0)
    jt, tt = _pair(doms, **kw)
    events = {}
    for pkg, tr, o in (("ref", jt, jobs), ("port", tt, obs)):
        m, net, _ = PKGS[pkg]
        avail = m.markov_trace(4, horizon=1e4, mean_on=8.0, mean_off=3.0, seed=7)
        sched = m.AsyncScheduler(tr, m.AsyncConfig(
            buffer_size=2, staleness="polynomial", eval_interval=2.0, server_crash_times=(4.0,),
            checkpoint_interval_s=2.0, restart_delay_s=0.5), availability=avail,
            links=net.LinkScenario(links=[net.LinkModel(latency_s=0.2 * (i + 1))
                                          for i in range(4)]))
        with o.use_tracer() as tracer:
            sched.run(5)
        events[pkg] = tracer.events
    assert obs.validate_trace(events["port"]) == []
    names = {e["name"] for e in events["port"]}
    assert {"compute", "uplink", "flush", "server_crash", "recovery", "checkpoint",
            "eval"} <= names

    def strip(evs):
        out = []
        for e in evs:
            e = json.loads(json.dumps(e))
            acc = e.get("args", {}).pop("acc", None)
            out.append((e, acc))
        return out

    for (je, ja), (te, ta) in zip(strip(events["ref"]), strip(events["port"]), strict=True):
        assert te == je
        assert (ja is None) == (ta is None) and (ja is None or abs(ja - ta) < 1e-6)


VALIDATION = [
    (dict(engine="serial"), dict(buffer_size=1), {}, "batched engine"),
    ({}, dict(buffer_size=7), {}, "buffer_size"),
    ({}, dict(buffer_size=0), {}, "buffer_size"),
    ({}, dict(buffer_size=1, staleness="bogus"), {}, "unknown staleness"),
    ({}, dict(buffer_size=1, eval_interval=0.0), {}, "eval_interval"),
    ({}, dict(buffer_size=1, checkpoint_interval_s=-1.0), {}, "checkpoint_interval_s"),
    ({}, dict(buffer_size=1, restart_delay_s=-0.5), {}, "restart_delay_s"),
    ({}, dict(buffer_size=1, edge_crash_times=((1.0, 1),)), {}, "edge id out of range"),
    ({}, dict(buffer_size=1, edge_crash_times=((-1.0, 0),)), {}, "time must be >= 0"),
    ({}, dict(buffer_size=1, server_crash_times=(-2.0,)), {}, "server crash times"),
    ({}, dict(buffer_size=1), dict(avail=2), "availability trace covers"),
    ({}, dict(buffer_size=1), dict(edge_links=1), "edge_links need"),
    ({}, dict(buffer_size=1), dict(links=2), "links for"),
    (dict(topology=[[0, 1, 2], [3]]), dict(buffer_size=2), {}, "smallest edge"),
    (dict(topology=[[0, 1], [2, 3]]), dict(buffer_size=1), dict(edge_links=1), "edge links for"),
]


@pytest.mark.parametrize("proto,cfg,extra,match", VALIDATION)
def test_async_validation_matches_reference(doms, proto, cfg, extra, match):
    """The same ValueError in both packages (tests/test_fedsim.py:360-378,
    tests/test_fleet.py:440-456, runtime.py:355-393)."""
    for pkg in ("ref", "port"):
        m, net, topo = PKGS[pkg]
        kw = _proto_kw(pkg, dict(n_rounds=0, batch_size=32, seed=0, **proto))
        tr = ((JTrainer(*doms, JCFG, JProto(warmup_rounds=0, **kw))) if pkg == "ref" else
              TTrainer(*doms, TCFG, TProto(warmup_rounds=0, **kw), device="cpu"))
        args = {}
        if "avail" in extra:
            args["availability"] = m.always_on_trace(extra["avail"], 10.0)
        if "edge_links" in extra:
            args["edge_links"] = net.LinkScenario(links=[net.LinkModel()] * extra["edge_links"])
        if "links" in extra:
            args["links"] = net.LinkScenario(links=[net.LinkModel()] * extra["links"])
        with pytest.raises(ValueError, match=match):
            m.AsyncScheduler(tr, m.AsyncConfig(**cfg), **args)


def test_probes_stay_out_of_the_port(doms):
    """The probes are ported now: an async run with ``probe=True`` emits the
    flush's probes, the reference's keys, and drains them at its end."""
    tr = TTrainer(*doms, TCFG, TProto(warmup_rounds=0, batch_size=32, probe=True), device="cpu")
    fedsim.AsyncScheduler(tr, fedsim.AsyncConfig(buffer_size=2)).run(2)
    assert tr._pending_probes is None
    assert set(tr.last_probes) == {"moment_mass", "attribution_moments", "attribution_w_rf",
                                   "update_norm", "tgt_update_norm"}
    assert not math.isnan(fedsim.AsyncConfig().restart_delay_s)


def test_fedsim_exports_equal_reference():
    import repro.federated as jfed

    import repro_torch.federated as tfed

    assert set(jfedsim.__dict__) - set(fedsim.__dict__) <= {"__file__", "__path__", "__spec__",
                                                             "__loader__", "__cached__"}
    public = {n for n in dir(jfed) if not n.startswith("_") and n not in (
        "aggregation", "engine", "model", "network", "protocol", "distributed", "vertical")}
    assert public <= set(dir(tfed))


def test_fedrf_paper_config_equals_reference():
    from repro.configs import fedrf_paper as jconf

    from repro_torch.configs import fedrf_paper as tconf

    assert vars(tconf.CLIENT) == vars(jconf.CLIENT)
    assert vars(tconf.PROTOCOL) == vars(jconf.PROTOCOL)
