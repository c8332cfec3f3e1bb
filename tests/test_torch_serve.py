"""Port parity: repro_torch.serve (model store, batching dispatcher, live
admission, the aligner server, the load generator) vs repro.serve on the CPU.

Mirrors tests/test_serve.py.  Where both packages must serve one aligner,
the port's state takes the reference's solved W_RF (the seed-fused Omega is
the same threefry draw in both), so only the featurize and the projection
are compared.  Tolerances: dispatcher outputs and moments 2e-5, pad columns
exactly zero; admission moments 2e-5; store behaviour, arrivals and the
request mix exactly equal; a re-solve from moments (``refresh_from_moments``)
eigenvalues rtol 1e-2 and the spanned subspace (ROADMAP's rule for solved
aligners: raw eigenvectors are free in sign and rotation).  ``run_open_loop``
batches by measured wall time, so across packages only what does not depend
on the clock is compared: arrivals, request ids and per-request outputs.
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
import repro.core.rf_tca  # noqa: E402,F401
from repro.obs import sentinel as jsentinel  # noqa: E402
from repro_torch import serve  # noqa: E402
from repro_torch.comm.transport import WireTransport, resolve_codecs  # noqa: E402
from repro_torch.core.rff import rff_features  # noqa: E402
from repro_torch.core.rf_tca import (  # noqa: E402
    RFTCAState,
    fused_omega_cache_info,
    fused_transform_omega,
    rf_tca_fit,
    rf_tca_transform,
)
from repro_torch.obs import (  # noqa: E402
    DriftMonitor,
    MetricsRegistry,
    RequestTracer,
    Slo,
    SloEngine,
    Tracer,
    count_request_trees,
    sentinel,
    use_registry,
    use_tracer,
)
from repro_torch.serve import (  # noqa: E402
    AdmissionGateway,
    AlignerServer,
    ModelStore,
    MomentStats,
    Request,
    StoreEntry,
    poisson_arrivals,
    run_open_loop,
    synth_requests,
)

jrf = sys.modules["repro.core.rf_tca"]  # the package __init__ shadows the module

DIM = 8
FIT_KW = dict(n_features=16, m=4, seed=0)
TOL = 2e-5


def _domain(seed, n=90, shift=0.7):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((DIM, n)).astype(np.float32)
    xt = (rng.standard_normal((DIM, n - 7)) + shift).astype(np.float32)
    return xs, xt


def _server(capacity=4, **kw):
    return AlignerServer(capacity=capacity, min_bucket=4, max_bucket=32, device="cpu", **kw)


def _jserver(capacity=4, **kw):
    return jserve.AlignerServer(capacity=capacity, min_bucket=4, max_bucket=32, **kw)


def _entry(seed=0):
    xs, xt = _domain(seed)
    return StoreEntry(state=rf_tca_fit(xs, xt, device="cpu", **FIT_KW))


def _port_state(jstate) -> RFTCAState:
    """The reference's solved (seed-fused) state as a port state."""
    return RFTCAState(omega=None, w_rf=torch.from_numpy(np.array(jstate.w_rf)),
                      eigvals=torch.from_numpy(np.array(jstate.eigvals)),
                      fused=tuple(jstate.fused))


def _shared_entries(seed=4, classifier=None):
    """One reference fit, served by a reference and a port entry."""
    xs, xt = _domain(seed)
    jstate = jrf.rf_tca_fit(jnp.asarray(xs), jnp.asarray(xt), w_rf="fused:1234", **FIT_KW)
    jentry = jserve.StoreEntry(state=jstate, classifier=classifier)
    tentry = StoreEntry(state=_port_state(jstate), classifier=classifier)
    return jentry, tentry


# ---- model store ------------------------------------------------------------------------

def _store_script(m, entry):
    """One sequence of store operations; returns everything observable."""
    store = m.ModelStore(capacity=2)
    seen = []
    for i in range(3):
        seen.append(store.put(("s", f"t{i}"), entry))
    seen.append(store.get(("s", "t0")) is None)
    seen.append(store.latest_version(("s", "t0")))
    seen.append(store.get(("s", "t1")) is not None)
    store.put(("s", "t3"), entry)
    seen.append(store.get(("s", "t2")) is None)
    seen.append(store.put(("s", "t1"), entry, bump=True))
    seen.append(store.get(("s", "t1"), version=0) is None)
    seen.append(store.put(("s", "t1"), entry, codec="qint8"))
    seen.append(store.latest_version(("s", "t1")))
    seen.append((("s", "t1"), "float32", 1) in store)
    return seen, store.snapshot(), len(store)


def test_store_lru_eviction_and_versions_equal_reference():
    assert _store_script(serve, _entry(0)) == _store_script(jserve, object())


def test_store_lru_eviction_at_capacity():
    store = ModelStore(capacity=2)
    for i in range(3):
        store.put(("s", f"t{i}"), _entry(i))
    assert len(store) == 2 and store.evictions == 1
    assert store.get(("s", "t0")) is None and store.latest_version(("s", "t0")) is None
    assert store.get(("s", "t1")) is not None and store.get(("s", "t2")) is not None
    assert store.hits == 2 and store.misses == 1
    store.get(("s", "t1"))
    store.put(("s", "t3"), _entry(3))
    assert store.get(("s", "t1")) is not None and store.get(("s", "t2")) is None


def test_store_version_invalidation():
    store = ModelStore(capacity=4)
    assert store.put(("a", "b"), _entry(0)) == 0
    assert store.put(("a", "b"), _entry(1)) == 0 and store.invalidations == 0
    assert store.put(("a", "b"), _entry(2), bump=True) == 1
    assert store.invalidations == 1 and len(store) == 1
    assert store.get(("a", "b"), version=0) is None
    assert store.get(("a", "b"), version=1) is not None
    assert store.put(("a", "b"), _entry(3), codec="qint8") == 0
    assert store.latest_version(("a", "b")) == 1
    with pytest.raises(ValueError, match="capacity"):
        ModelStore(capacity=0)


# ---- batching dispatcher ----------------------------------------------------------------

@pytest.mark.parametrize("widths", [(3, 5, 2, 7), (1,), (8,), (16, 16), (30,)])
def test_dispatcher_outputs_match_reference(widths):
    """One burst through each dispatcher on one aligner: per-request outputs
    within 2e-5 of the reference's."""
    jentry, tentry = _shared_entries()
    rng = np.random.default_rng(sum(widths))
    xs = [rng.standard_normal((DIM, n)).astype(np.float32) for n in widths]
    jd = jserve.BatchingDispatcher(min_bucket=4, max_bucket=32, sentinel_prefix="pj")
    td = serve.BatchingDispatcher(min_bucket=4, max_bucket=32, sentinel_prefix="pt")
    for d in (jd, td):
        for x in xs:
            d.submit((jserve.Request if d is jd else Request)(x=x, key=("s", "t")))
    jdone, tdone = jd.flush(jentry), td.flush(tentry)
    assert [r.x.shape for r, _ in tdone] == [r.x.shape for r, _ in jdone]
    for (_, a), (_, b) in zip(jdone, tdone):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=TOL)
    assert td.histogram() == jd.histogram()


@pytest.mark.parametrize("n", [1, 3, 5, 9, 31])
def test_probe_plane_pads_exact_zeros_and_moment_matches_reference(n):
    """The planes themselves at a padded width: pad columns exactly zero,
    the valid ones and the batch moment within 2e-5 of the reference's."""
    from repro.federated.protocol import _cycle_pad as jpad
    from repro.federated.protocol import _ragged_mask as jmask
    from repro.serve import dispatcher as jdisp

    from repro_torch.serve import dispatcher as tdisp

    jentry, tentry = _shared_entries()
    x = np.random.default_rng(n).standard_normal((DIM, n)).astype(np.float32)
    bucket = serve.BatchingDispatcher(min_bucket=4, max_bucket=32).bucket_for(n)
    x_pad, _ = jpad(x, None, bucket)
    mrow = jmask([n], bucket)
    mask = np.ones(bucket, np.float32) if mrow is None else np.asarray(mrow[0])
    jst, tst = jentry.state, tentry.state
    jout, jmom = jdisp._transform_probe_body(jst.w_rf, jrf.fused_transform_omega(jst, DIM),
                                             jnp.asarray(x_pad), jnp.asarray(mask))
    tout, tmom = tdisp._transform_probe_body(tst.w_rf, fused_transform_omega(tst, DIM),
                                             torch.from_numpy(x_pad), torch.from_numpy(mask))
    assert torch.all(tout[:, n:] == 0)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=TOL)
    np.testing.assert_allclose(tmom.numpy(), np.asarray(jmom), rtol=0, atol=TOL)
    plain = tdisp._transform_body(tst.w_rf, fused_transform_omega(tst, DIM),
                                  torch.from_numpy(x_pad), torch.from_numpy(mask))
    assert torch.equal(plain, tout)


def test_predict_outputs_match_reference():
    rng = np.random.default_rng(9)
    clf = {"w": rng.standard_normal((4, 3)).astype(np.float32),
           "b": rng.standard_normal(3).astype(np.float32)}
    jentry, tentry = _shared_entries(classifier=clf)
    x = rng.standard_normal((DIM, 5)).astype(np.float32)
    jd = jserve.BatchingDispatcher(min_bucket=4, max_bucket=32, sentinel_prefix="pj")
    td = serve.BatchingDispatcher(min_bucket=4, max_bucket=32, sentinel_prefix="pt")
    jd.submit(jserve.Request(x=x, key=("s", "t"), mode="predict"))
    td.submit(Request(x=x, key=("s", "t"), mode="predict"))
    (_, a), = jd.flush(jentry)
    (_, b), = td.flush(tentry)
    np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="mode"):
        Request(x=x, mode="align")


def test_dispatcher_buckets_and_masked_padding():
    srv = _server()
    xs, xt = _domain(4)
    srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
    entry = srv.store.get(("s", "t"))
    assert [srv.dispatcher.bucket_for(n) for n in (1, 5, 999)] == [4, 8, 32]
    rng = np.random.default_rng(7)
    reqs = [Request(x=rng.standard_normal((DIM, n)).astype(np.float32), key=("s", "t"))
            for n in (3, 5, 2, 7)]
    done = srv.serve(reqs)
    assert len(done) == 4
    for req, out in done:
        ref = rf_tca_transform(entry.state, req.x).numpy()
        assert out.shape == ref.shape
        np.testing.assert_allclose(out, ref, atol=1e-5)
    srv.dispatcher.submit(Request(x=np.zeros((DIM, 33), np.float32), key=("s", "t")))
    with pytest.raises(ValueError, match="max_bucket"):
        srv.dispatcher.flush(entry)


def test_dispatcher_one_signature_per_bucket_like_reference():
    """Warm-up then every rung again: each rung's plane sees one signature in
    the port and traces once in the reference."""
    xs, xt = _domain(5)
    counts = {}
    for name, srv, sen in (("port", _server(sentinel_prefix="sig_t"), sentinel),
                           ("ref", _jserver(sentinel_prefix="sig_j"), jsentinel)):
        srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
        before = sen.counts()
        srv.warmup(("s", "t"))
        rng = np.random.default_rng(8)
        for n in (3, 4, 2, 7, 8, 20, 31, 1):
            srv.serve([Request(x=rng.standard_normal((DIM, n)).astype(np.float32),
                               key=("s", "t"))])
        prefix = "sig_t" if name == "port" else "sig_j"
        planes = tuple(f"{prefix}.transform.b{b}" for b in (4, 8, 16, 32))
        sen.assert_stable(before, planes, expect=1)
        counts[name] = srv.dispatcher.histogram()
    assert counts["port"] == counts["ref"]


# ---- live admission -----------------------------------------------------------------------

@pytest.mark.parametrize("role", ["source", "target"])
@pytest.mark.parametrize("kernel", ["gauss", "laplace"])
def test_client_moment_matches_reference(role, kernel):
    x = np.random.default_rng(3).standard_normal((DIM, 40)).astype(np.float32)
    kw = dict(n_features=16, fused_seed=1234, sigma=1.3, kernel=kernel, role=role)
    a = jserve.client_moment(x, **kw)
    b = serve.client_moment(x, device="cpu", **kw)
    assert b.dtype == np.float32 and b.shape == a.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="role"):
        serve.client_moment(x, device="cpu", **{**kw, "role": "both"})


def test_admission_message_and_wire_match_reference():
    m = np.random.default_rng(2).standard_normal(32).astype(np.float32)
    jmsg = jserve.admission_message(m, sender=3, version=-1)
    tmsg = serve.admission_message(m, sender=3, version=-1)
    assert (tmsg.kind, tmsg.sender, tmsg.round) == (jmsg.kind, jmsg.sender, jmsg.round) == (
        "moments", 3, 0)
    np.testing.assert_array_equal(tmsg.arrays["msg"], jmsg.arrays["msg"])


@pytest.mark.parametrize("codec", ["float32", "qint8"])
def test_admission_refit_free_and_matches_refit(codec):
    srv = _server(transport=WireTransport(resolve_codecs(codec), seed=0))
    xs, xt = _domain(10)
    srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
    v_before = srv.store.latest_version(("s", "t"))
    entry = srv.store.get(("s", "t"))
    rng = np.random.default_rng(11)
    res = srv.admit(("s", "t"), rng.standard_normal((DIM, 40)).astype(np.float32),
                    role="source", sender=3)
    assert res.delivered and res.version == v_before
    assert srv.store.latest_version(("s", "t")) == v_before and srv.refits == 0
    assert entry.stats.admitted == 1 and entry.stats.n_source == 90 + 40
    assert res.bytes_up > 0 and res.bytes_down > res.bytes_up
    probe = rng.standard_normal((DIM, 13)).astype(np.float32)
    scratch = rf_tca_fit(xs, xt, w_rf=f"fused:{srv.fused_seed}", device="cpu", **FIT_KW)
    got = rf_tca_transform(res.state, probe)
    want = rf_tca_transform(scratch, probe)
    if codec == "float32":  # tests/test_serve.py's gate
        assert float((got - want).abs().max()) <= 1e-3
    else:  # the downlink rounds each entry of W_RF within one step of its bin
        served = entry.state.w_rf
        step = float(served.abs().max()) / 127
        assert float((res.state.w_rf - served).abs().max()) <= step * (1 + 1e-6)
        feats = rff_features(torch.from_numpy(probe), fused_transform_omega(scratch, DIM))
        bound = step * feats.abs().sum(dim=0) + 1e-5
        assert bool(((got - want).abs() <= bound[None, :]).all())
    assert res.state.omega is None and res.state.fused is not None


def test_admission_merge_and_stats_match_reference():
    """The same admissions through both servers (one fit each): the merged
    moment ledger within 2e-5, the same counts and versions."""
    xs, xt = _domain(12)
    rng = np.random.default_rng(13)
    clients = [(rng.standard_normal((DIM, n)).astype(np.float32), role)
               for n, role in ((40, "source"), (25, "target"), (9, "source"))]
    stats = {}
    for name, srv in (("ref", _jserver()), ("port", _server())):
        srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
        for i, (x, role) in enumerate(clients):
            res = srv.admit(("s", "t"), x, role=role, sender=i)
            assert res.delivered and res.version == 0
        st = srv.store.get(("s", "t")).stats
        stats[name] = (st, srv.stats())
    (js, jstats), (ts, tstats) = stats["ref"], stats["port"]
    assert (ts.n_source, ts.n_target, ts.admitted) == (js.n_source, js.n_target, js.admitted)
    np.testing.assert_allclose(ts.source_mean, np.asarray(js.source_mean), atol=TOL)
    np.testing.assert_allclose(ts.target_mean, np.asarray(js.target_mean), atol=TOL)
    assert jstats["admissions"] == tstats["admissions"] == 3
    assert jstats["wire"] == tstats["wire"]


def test_admission_moment_merge_tracks_u():
    stats = MomentStats()
    rng = np.random.default_rng(12)
    chunks = [rng.standard_normal((16, n)) for n in (10, 25, 5)]
    for c in chunks:
        stats.merge(np.mean(c, axis=1), c.shape[1], role="source")
    tgt = rng.standard_normal((16, 30))
    stats.merge(-np.mean(tgt, axis=1), 30, role="target")
    pooled = np.mean(np.concatenate(chunks, axis=1), axis=1) - np.mean(tgt, axis=1)
    np.testing.assert_allclose(stats.u, pooled, atol=1e-12)
    assert stats.admitted == 4 and stats.n_source == 40 and stats.n_target == 30
    with pytest.raises(ValueError, match="role"):
        stats.merge(np.zeros(16), 1, role="both")
    with pytest.raises(ValueError, match="n_samples"):
        stats.merge(np.zeros(16), 0)


def test_admission_requires_fused_state_and_rejects_seed_replay():
    with pytest.raises(ValueError, match="seed_replay"):
        AdmissionGateway(ModelStore(), transport=WireTransport(
            resolve_codecs("float32", w_rf="seed_replay")))
    xs, xt = _domain(13)
    srv = _server()
    srv.fit_domain(("s", "t"), xs, xt, w_rf=None, **FIT_KW)
    assert srv.store.get(("s", "t")).state.fused is None
    with pytest.raises(ValueError, match="fused"):
        srv.admit(("s", "t"), xs[:, :5])
    with pytest.raises(KeyError, match="fit_domain"):
        srv.get_or_fit(("never", "fitted"))


def test_fused_omega_memoized_across_serving():
    srv = _server()
    xs, xt = _domain(14)
    srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
    srv.warmup(("s", "t"))
    regen = fused_omega_cache_info()["regenerations"]
    rng = np.random.default_rng(15)
    for _ in range(6):
        srv.serve([Request(x=rng.standard_normal((DIM, 5)).astype(np.float32),
                           key=("s", "t"))])
    assert fused_omega_cache_info()["regenerations"] == regen


# ---- the server's fits and moment-space refresh -------------------------------------------

def _subspace_gap(wa, wb) -> float:
    qa = np.linalg.qr(np.asarray(wa, np.float64))[0]
    qb = np.linalg.qr(np.asarray(wb, np.float64))[0]
    return float(np.linalg.norm(qa @ qa.T - qb @ qb.T, 2))


def _solved_close(jstate, tstate):
    jv, tv = np.asarray(jstate.eigvals), tstate.eigvals.numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-2)
    assert _subspace_gap(jstate.w_rf, tstate.w_rf) <= 1e-2
    assert tuple(tstate.fused) == tuple(jstate.fused)


@pytest.mark.parametrize("shift", [0.0, 1.5])
def test_refresh_from_moments_matches_reference(shift):
    """The fits and the statistics-space re-solve from one updated target
    moment: eigenvalues rtol 1e-2 and the spanned subspace; one version bump
    in each package, the target ledger reset to the moment."""
    xs, xt = _domain(20)
    rng = np.random.default_rng(21)
    x_live = (rng.standard_normal((DIM, 60)) + 0.7 + shift).astype(np.float32)
    moment = -serve.client_moment(x_live, n_features=16, fused_seed=1234, role="target",
                                  device="cpu")
    out = {}
    for name, srv in (("ref", _jserver()), ("port", _server())):
        srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
        fitted = srv.store.get(("s", "t")).state
        v = srv.refresh_from_moments(("s", "t"), target_mean=moment, n_target=60)
        entry = srv.store.get(("s", "t"))
        out[name] = (fitted, entry, v, srv.moment_refreshes)
    (jfit, jentry, jv, jn), (tfit, tentry, tv, tn) = out["ref"], out["port"]
    _solved_close(jfit, tfit)
    _solved_close(jentry.state, tentry.state)
    assert jv == tv == 1 and jn == tn == 1
    assert tentry.stats.n_target == 60 and tentry.stats.admitted == 0
    np.testing.assert_allclose(tentry.stats.target_mean, moment, atol=0)
    np.testing.assert_allclose(tentry.stats.source_mean, np.asarray(jentry.stats.source_mean),
                               atol=TOL)


def test_refresh_from_moments_needs_fused_fit_and_monitor():
    srv = _server()
    xs, xt = _domain(22)
    srv.fit_domain(("s", "t"), xs, xt, w_rf=None, **FIT_KW)
    with pytest.raises(KeyError, match="retained fit statistics"):
        srv.refresh_from_moments(("s", "t"), target_mean=np.zeros(32, np.float32))
    srv.fit_domain(("s", "u"), xs, xt, **FIT_KW)
    with pytest.raises(ValueError, match="DriftMonitor"):
        srv.refresh_from_moments(("s", "u"))
    assert srv.refresh(("s", "u")) == 1 and srv.refits == 1


# ---- load generator -----------------------------------------------------------------------

@pytest.mark.parametrize("rate,n,seed", [(100.0, 50, 3), (4000.0, 400, 20), (250.0, 7, 0)])
def test_poisson_arrivals_equal_reference(rate, n, seed):
    np.testing.assert_array_equal(poisson_arrivals(rate, n, seed=seed),
                                  jserve.poisson_arrivals(rate, n, seed=seed))
    with pytest.raises(ValueError, match="rate"):
        poisson_arrivals(0.0, 5, seed=0)


@pytest.mark.parametrize("kw", [dict(cols_lo=2, cols_hi=8), dict(shift=0.9, mode="predict"),
                                dict(cols_lo=96, cols_hi=224, shift=3.9)])
def test_synth_requests_equal_reference(kw):
    keys = [("s", f"t{i}") for i in range(3)]
    a = synth_requests(keys, dim=DIM, n_requests=12, seed=4, **kw)
    b = jserve.synth_requests(keys, dim=DIM, n_requests=12, seed=4, **kw)
    for ra, rb in zip(a, b):
        np.testing.assert_array_equal(ra.x, rb.x)
        assert (ra.key, ra.mode, ra.id) == (rb.key, rb.mode, rb.id)


def test_open_loop_ids_arrivals_and_outputs_match_reference():
    """The same open-loop run in both packages: ids and arrivals exactly,
    every request's output within 2e-5 (the batching depends on the clock,
    the per-request outputs do not)."""
    jentry, tentry = _shared_entries(seed=16)
    served = {}
    for name, srv, entry in (("ref", _jserver(), jentry), ("port", _server(), tentry)):
        srv.store.put(("s", "t"), entry)
        srv._domains[("s", "t")] = None  # known pair: never refit (capacity holds it)
        outs = {}
        serve_fn = srv.serve

        def recording(reqs, serve_fn=serve_fn, outs=outs):
            done = serve_fn(reqs)
            outs.update({r.id: (r.arrival, np.asarray(o)) for r, o in done})
            return done

        srv.serve = recording
        reqs = synth_requests([("s", "t")], dim=DIM, n_requests=30, seed=4, cols_lo=2,
                              cols_hi=8)
        res = (jserve.run_open_loop if name == "ref" else run_open_loop)(srv, reqs, rate=300.0,
                                                                         seed=5)
        assert res.summary()["completed"] == 30
        served[name] = outs
    assert sorted(served["port"]) == sorted(served["ref"]) == list(range(30))
    for i, (arr, out) in served["port"].items():
        assert arr == served["ref"][i][0]
        np.testing.assert_allclose(out, served["ref"][i][1], rtol=0, atol=TOL)


def test_loadgen_open_loop_and_validation():
    srv = _server()
    xs, xt = _domain(16)
    srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
    srv.warmup(("s", "t"))
    reqs = synth_requests([("s", "t")], dim=DIM, n_requests=40, seed=4, cols_lo=2, cols_hi=8)
    summary = run_open_loop(srv, reqs, rate=300.0, seed=5, service_scale=2.5).summary()
    assert summary["completed"] == 40 and summary["service_scale"] == 2.5
    assert summary["p99_ms"] >= summary["p50_ms"] > 0 and summary["throughput_rps"] > 0
    for bad in (0.0, -1.0, float("inf"), float("nan")):
        with pytest.raises(ValueError, match="service_scale"):
            run_open_loop(srv, reqs, rate=200.0, seed=13, service_scale=bad)


def test_loadgen_cache_misses_under_many_pairs():
    srv = _server(capacity=2)
    pairs = [("s", f"t{i}") for i in range(3)]
    for i, pair in enumerate(pairs):
        xs, xt = _domain(20 + i)
        srv.fit_domain(pair, xs, xt, **FIT_KW)
    reqs = synth_requests(pairs, dim=DIM, n_requests=30, seed=6, cols_lo=2, cols_hi=6)
    assert run_open_loop(srv, reqs, rate=200.0, seed=7).summary()["completed"] == 30
    assert srv.refits > 0 and 0.0 < srv.store.hit_rate < 1.0


# ---- telemetry off vs on ------------------------------------------------------------------

def test_serve_telemetry_off_on_bitwise_identical():
    def run():
        srv = _server()
        xs, xt = _domain(30)
        srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
        reqs = synth_requests([("s", "t")], dim=DIM, n_requests=8, seed=8, cols_lo=2,
                              cols_hi=8)
        outs = [out for _, out in srv.serve(reqs)]
        outs.append(srv.admit(("s", "t"), xs[:, :11], role="source").state.w_rf.numpy())
        return outs

    plain = run()
    with use_registry(MetricsRegistry()), use_tracer(Tracer()):
        instrumented = run()
    for a, b in zip(plain, instrumented):
        np.testing.assert_array_equal(a, b)


def test_serve_observability_off_runs_no_probe_planes():
    def outputs(srv):
        xs, xt = _domain(40)
        srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
        reqs = synth_requests([("s", "t")], dim=DIM, n_requests=10, seed=9, cols_lo=2,
                              cols_hi=8)
        return [out for _, out in srv.serve(reqs)]

    before = sentinel.counts()
    plain = outputs(_server(sentinel_prefix="off1"))
    srv2 = _server(sentinel_prefix="off2")
    srv2.attach(request_tracer=RequestTracer(rate=1.0), slo=SloEngine(
        [Slo("serve.latency", target=0.9, bound=1.0, window_fast_s=1.0, window_slow_s=4.0)]))
    wired = outputs(srv2)
    for a, b in zip(plain, wired):
        np.testing.assert_array_equal(a, b)
    after = sentinel.counts()
    assert [k for k, v in after.items() if ".probe" in k and v > before.get(k, 0)] == []
    assert srv2.reqtrace.sampled_total == 0


def test_serve_drift_probe_planes_one_signature_and_bitwise():
    """Port-only mirror of the reference's drift-plane test (which fails on
    the reference): each probed rung sees one signature, and its outputs are
    bit for bit the unprobed plane's."""
    srv = _server(sentinel_prefix="dr1")
    xs, xt = _domain(41)
    srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
    srv.attach(drift=DriftMonitor(window=1, threshold=1e9))
    reqs = synth_requests([("s", "t")], dim=DIM, n_requests=10, seed=10, cols_lo=2, cols_hi=8)
    before = sentinel.counts()
    srv.warmup(("s", "t"))
    done = srv.serve(reqs)
    sentinel.assert_stable(before, tuple(f"dr1.transform.b{b}.probe" for b in (4, 8, 16, 32)),
                           expect=1)
    bare = _server(sentinel_prefix="dr1_bare")
    bare.store.put(("s", "t"), srv.store.get(("s", "t")))
    bare._domains[("s", "t")] = None
    for (_, a), (_, b) in zip(done, bare.serve(reqs)):
        np.testing.assert_array_equal(a, b)
    assert srv.drift.pairs() == [("s", "t")]


def test_serve_auto_refresh_on_drift_alert():
    rng = np.random.default_rng(42)
    clf = {"w": rng.standard_normal((4, 3)).astype(np.float32)}
    srv = _server(sentinel_prefix="dr2")
    xs, xt = _domain(43)
    srv.fit_domain(("s", "t"), xs, xt, classifier=clf, **FIT_KW)
    srv.attach(drift=DriftMonitor(alpha=1.0, window=1, k_consecutive=1, threshold=0.02))
    srv.admit(("s", "t"), xs[:, :9], role="source")
    v0 = srv.store.latest_version(("s", "t"))
    x_shift = (rng.standard_normal((DIM, 20)) + 3.0).astype(np.float32)
    for _ in range(4):
        srv.virtual_now += 0.01
        srv.serve([Request(x=x_shift, key=("s", "t"))])
    assert srv.drift.fires == 1 and srv.moment_refreshes == 1
    assert srv.store.latest_version(("s", "t")) == v0 + 1
    entry = srv.store.get(("s", "t"))
    assert entry.classifier is clf and entry.stats.admitted == 0
    rec = srv.drift.history[-1]
    assert not rec.fired and rec.mmd < srv.drift.pair_threshold(("s", "t"))


def test_loadgen_emits_request_trees_under_live_tracer():
    srv = _server()
    xs, xt = _domain(45)
    srv.fit_domain(("s", "t"), xs, xt, **FIT_KW)
    srv.attach(request_tracer=RequestTracer(rate=1.0))
    srv.warmup(("s", "t"))
    reqs = synth_requests([("s", "t")], dim=DIM, n_requests=7, seed=14, cols_lo=2, cols_hi=8)
    tracer = Tracer()
    with use_tracer(tracer):
        run_open_loop(srv, reqs, rate=300.0, seed=15)
    assert count_request_trees(tracer.events) == 7 and srv.reqtrace.emitted == 7
    srv.attach(request_tracer=RequestTracer(rate=0.0))
    t2 = Tracer()
    with use_tracer(t2):
        run_open_loop(srv, reqs, rate=300.0, seed=16)
    assert count_request_trees(t2.events) == 0 and srv.reqtrace.sampled_total == 0
    with use_tracer(t3 := Tracer()):
        srv.attach(request_tracer=RequestTracer(rate=1.0))
        srv.admit(("s", "t"), xs[:, :7], role="source")
    assert {e["name"] for e in t3.events} == {"serve.admission", "serve.wire_decode",
                                              "serve.moment_merge", "serve.w_rf_ship"}


def test_server_without_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: device=None resolves to it")
    with pytest.raises(RuntimeError, match="CUDA"):
        AlignerServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.client_moment(np.zeros((DIM, 3), np.float32), n_features=4, fused_seed=0)


def test_serve_exports_equal_reference():
    assert set(serve.__all__) == set(jserve.__all__)
