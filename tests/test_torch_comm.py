"""Port parity: repro_torch.comm (codecs, wire frames, transports, netsim,
autocodec) vs repro.comm on the same arrays and numpy generators.

Codec bytes and frames are compared bit for bit; frames made by either
package decode in the other (all but the ``w_rf_init`` seed-replay
generator, whose key feeds each package's own random stream).  An
``omega_fused`` frame decodes to the threefry stream in both: the bits are
the same, the floats within 8 ULP (the port's plain threefry against XLA's
transform on the CPU, as tests/test_torch_prng.py holds it).
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.comm import autocodec as jauto  # noqa: E402
from repro.comm import codecs as jcodecs  # noqa: E402
from repro.comm import netsim as jnet  # noqa: E402
from repro.comm import transport as jtr  # noqa: E402
from repro.comm import wire as jwire  # noqa: E402
from repro_torch.comm import autocodec as tauto  # noqa: E402
from repro_torch.comm import codecs as tcodecs  # noqa: E402
from repro_torch.comm import netsim as tnet  # noqa: E402
from repro_torch.comm import transport as ttr  # noqa: E402
from repro_torch.comm import wire as twire  # noqa: E402

CODECS = ["float32", "float16", "bfloat16", "qint8", "qint4", "topk:0.25", "topk:7"]
OMEGA_ULP = 8


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(11)
    return {
        "msg": (rng.normal(size=(64,)) * 0.3).astype(np.float32),
        "w_rf": rng.normal(size=(64, 4)).astype(np.float32),
        "odd": rng.normal(size=(13,)).astype(np.float32),
        "zero": np.zeros((9,), np.float32),
    }


def _ulps(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mag = np.maximum(np.abs(a), np.abs(b)).astype(np.float32)
    spacing = np.spacing(mag).astype(np.float64)
    return float((np.abs(a - b) / spacing).max())


@pytest.mark.parametrize("spec", CODECS)
@pytest.mark.parametrize("name", ["msg", "w_rf", "odd", "zero"])
def test_codec_bytes_equal_reference(spec, name, arrays):
    x = arrays[name]
    jc, tc = jcodecs.get_codec(spec), tcodecs.get_codec(spec)
    jb = jc.encode(x, rng=np.random.default_rng(5))
    tb = tc.encode(x, rng=np.random.default_rng(5))
    assert tb == jb
    assert len(tb) == tc.nbytes(x.shape, x.dtype) == jc.nbytes(x.shape, x.dtype)
    np.testing.assert_array_equal(tc.decode(jb, x.shape, x.dtype),
                                  jc.decode(tb, x.shape, x.dtype))
    assert (tc.name, tc.wire_id, tc.lossy) == (jc.name, jc.wire_id, jc.lossy)


def _messages(mod, arrays, rnd):
    return [
        mod.moments_message(arrays["msg"], sender=2, round=rnd, downlink=True),
        mod.w_rf_message(arrays["w_rf"], sender=-1, round=rnd),
        mod.classifier_message({"w": arrays["w_rf"][:4], "b": arrays["odd"][:4]}, sender=3,
                               round=rnd),
    ]


@pytest.mark.parametrize("spec", CODECS)
def test_frames_cross_both_ways(spec, arrays):
    for jm, tm in zip(_messages(jwire, arrays, 7), _messages(twire, arrays, 7)):
        jf = jwire.serialize(jm, jcodecs.get_codec(spec), rng=np.random.default_rng(1))
        tf = twire.serialize(tm, tcodecs.get_codec(spec), rng=np.random.default_rng(1))
        assert tf == jf
        assert len(tf) == twire.serialized_size(
            tm.kind, {k: (v.shape, v.dtype) for k, v in tm.arrays.items()},
            tcodecs.get_codec(spec))
        for frame in (jf, tf):
            jd, jc = jwire.deserialize(frame)
            td, tc = twire.deserialize(frame)
            assert (td.kind, td.sender, td.round, td.downlink, tc.wire_id) == (
                jd.kind, jd.sender, jd.round, jd.downlink, jc.wire_id)
            for k in jd.arrays:
                np.testing.assert_array_equal(td.arrays[k], jd.arrays[k])


def test_omega_fused_replay_crosses_and_w_rf_init_bytes_match(arrays):
    key = np.array([5, 1], np.uint32)
    shape = (24, 6)
    m_j = jwire.w_rf_message(np.zeros(shape, np.float32), sender=0, round=1,
                             replay=("omega_fused", key))
    m_t = twire.w_rf_message(np.zeros(shape, np.float32), sender=0, round=1,
                             replay=("omega_fused", key))
    jf = jwire.serialize(m_j, jcodecs.get_codec("seed_replay"))
    tf = twire.serialize(m_t, tcodecs.get_codec("seed_replay"))
    assert tf == jf and len(tf) < 64
    for frame in (jf, tf):
        a = jwire.deserialize(frame)[0].arrays["w_rf"]
        b = twire.deserialize(frame)[0].arrays["w_rf"]
        assert _ulps(a, b) <= OMEGA_ULP
    # w_rf_init: the same bytes on the wire, each package replays its own stream
    w_key = np.array([3, 9], np.uint32)
    jb = jcodecs.get_codec("seed_replay").encode(None, replay=("w_rf_init", w_key))
    tb = tcodecs.get_codec("seed_replay").encode(None, replay=("w_rf_init", w_key))
    assert tb == jb
    w = tcodecs.get_codec("seed_replay").decode(tb, (16, 4), np.float32)
    assert w.shape == (16, 4) and np.isfinite(w).all()
    with pytest.raises(ValueError):
        tcodecs.get_codec("seed_replay").encode(arrays["msg"])


@pytest.mark.parametrize("spec", ["float16", "bfloat16", "topk:0.25", "topk:7"])
def test_deterministic_roundtrips_match_reference(spec, arrays):
    """The tensor round trip of each row equals the reference's jnp twin."""
    x = arrays["w_rf"][:3]  # three payload rows of 4 values
    stack = np.stack([arrays["msg"], arrays["msg"][::-1] * 2.0, arrays["msg"] * 0.5])
    for rows in (x, stack):
        got = tcodecs.get_codec(spec).roundtrip(torch.from_numpy(rows)).numpy()
        exp = np.stack([np.asarray(jcodecs.get_codec(spec).roundtrip(jnp.asarray(r)))
                        for r in rows])
        np.testing.assert_array_equal(got, exp)


@pytest.mark.parametrize("spec", ["qint8", "qint4", "topk:0.5"])
def test_wire_transport_matches_reference(spec, arrays):
    """Per-message numpy generators: the same frames and decoded arrays,
    the same log, delta coding included."""
    codecs = dict(codec_moments=spec, codec_w_rf=spec, codec_classifier=spec)
    jt = jtr.build_transport("wire", "float32", seed=4, **codecs)
    tt = ttr.build_transport("wire", "float32", seed=4, **codecs)
    for rnd in (1, 2):
        for jm, tm in zip(_messages(jwire, arrays, rnd), _messages(twire, arrays, rnd)):
            if jm.kind == "classifier":
                ja, ta = jt.transfer_delta(jm, link="c"), tt.transfer_delta(tm, link="c")
            else:
                ja, ta = jt.transfer(jm), tt.transfer(tm)
            for k in ja:
                np.testing.assert_array_equal(ta[k], ja[k])
    assert tt.log.snapshot().to_dict() == jt.log.snapshot().to_dict()
    assert ttr.IdentityTransport(tt.codecs).channel_fns() is None
    assert set(tt.channel_fns()) == {"moments", "w_rf", "classifier"}


def test_resolve_codecs_and_errors_match_reference():
    for default, kw in (("float32", {}), ("seed_replay", {}), ("qint8", {"w_rf": "float16"}),
                        ("bfloat16", {"classifier": "topk:0.1"})):
        j = {k: c.name for k, c in jtr.resolve_codecs(default, **kw).items()}
        t = {k: c.name for k, c in ttr.resolve_codecs(default, **kw).items()}
        assert t == j
    for bad in (lambda m: m.resolve_codecs("float32", moments="seed_replay"),
                lambda m: m.build_transport("carrier-pigeon"),
                lambda m: m.resolve_codecs("qint3")):
        with pytest.raises(ValueError):
            bad(jtr)
        with pytest.raises(ValueError):
            bad(ttr)


def _plans(trace):
    return [(p.msg_clients, p.w_clients, p.c_clients) for p in trace.plans]


def _scenarios(mod):
    links = [mod.LinkModel(drop=0.2, latency_s=0.1 * i, jitter_s=0.05, bandwidth_bps=5e4)
             for i in range(6)]
    return [
        mod.TableIIIScenario("I"), mod.TableIIIScenario("II"), mod.TableIIIScenario("III"),
        mod.BernoulliScenario(p_msg=0.2, p_w=0.3, p_c=0.1),
        mod.BernoulliScenario(p_msg=0.5, sample_s_t=False),
        mod.LinkScenario(links, deadline_s=0.4, payload_bytes={"moments": 300, "w_rf": 9000}),
        mod.LinkScenario(links, deadline_s=0.6, payload_bytes={"moments": 300},
                         backhaul_bps=2e5),
        mod.CorruptionScenario(mod.TableIIIScenario("III"), rates={"w_rf": 0.5},
                               max_retries=1),
    ]


def test_netsim_plans_and_traces_equal_reference(tmp_path):
    for js, ts in zip(_scenarios(jnet), _scenarios(tnet)):
        jt = jnet.record_trace(js, np.random.default_rng(3), 6, 12)
        tt = tnet.record_trace(ts, np.random.default_rng(3), 6, 12)
        assert _plans(tt) == _plans(jt)
    for setting in ("I", "II", "III"):
        assert _plans(tnet.table3_trace(setting, 5, 9, seed=2)) == _plans(
            jnet.table3_trace(setting, 5, 9, seed=2))
    path = tmp_path / "trace.json"
    jnet.save_trace(jnet.table3_trace("III", 4, 6, seed=1), path)
    assert _plans(tnet.load_trace(path)) == _plans(jnet.load_trace(path))
    ls_j, ls_t = _scenarios(jnet)[6], _scenarios(tnet)[6]
    rj, rt = np.random.default_rng(8), np.random.default_rng(8)
    for c in range(6):
        assert ls_t.uplink_outcome(rt, c, 4000, inflight_bytes=1e4) == ls_j.uplink_outcome(
            rj, c, 4000, inflight_bytes=1e4)
    assert tnet.amortized_interval_bytes(100, 4) == jnet.amortized_interval_bytes(100, 4)
    assert math.isinf(tnet.LinkModel(drop=1.0).delivery_time(np.random.default_rng(0), 10))


def test_pick_codec_matches_reference():
    record = jauto.load_record()
    assert tauto.DEFAULT_RECORD_PATH == jauto.DEFAULT_RECORD_PATH
    assert tauto.codec_table(record) == jauto.codec_table(record)
    gaps = sorted(row["gap"] for row in jauto.codec_table(record).values())
    for budget in [0.0, 0.005, 0.02, 0.05, 1.0, *gaps]:
        try:
            exp = jauto.pick_codec(budget, record=record)
        except ValueError:
            with pytest.raises(ValueError):
                tauto.pick_codec(budget, record=record)
            continue
        assert tauto.pick_codec(budget) == exp
        assert tauto.resolve(f"auto:{budget}") == jauto.resolve(f"auto:{budget}")
    assert tauto.resolve("qint8") == "qint8"
    with pytest.raises(ValueError):
        tauto.resolve("auto:cheap")


def test_corrupted_frames_raise_typed_error(arrays):
    frame = bytearray(twire.serialize(_messages(twire, arrays, 1)[0],
                                      tcodecs.get_codec("qint8")))
    frame[12] ^= 0xFF
    with pytest.raises(twire.WireDecodeError):
        twire.deserialize(bytes(frame))
    with pytest.raises(twire.WireDecodeError):
        twire.deserialize(bytes(frame[:10]))
