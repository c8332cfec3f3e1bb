"""Port parity: repro_torch.federated (model, Adam, aggregation, both round
engines, the trainer, checkpoints) vs repro.federated on the CPU.

Sizes are those of tests/test_round_engine.py:15-33.  Both packages draw
Omega from the seed-fused threefry stream (``rff_impl="fused"``), and the
port's trainers start from the reference's initial parameters
(``convert.load_reference_params``), so the only differences left are the
order of float sums.  Tolerances: losses and gradients 1e-5; trainer leaves
1e-4 (tests/test_round_engine.py:77); byte and message logs exactly equal;
one batched wire-qint8 round with the reference's uniforms: every entry
within one quantization step, at least 99 % within 1e-4 (XLA computes the
scale as absmax * (1/qmax), the port as absmax / qmax: a bin can flip).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data import make_domains  # noqa: E402
from repro.data.domains import Domain  # noqa: E402
from repro.federated import aggregation as jagg  # noqa: E402
from repro.federated import model as jmodel  # noqa: E402
from repro.federated import network as jnetwork  # noqa: E402
from repro.federated.protocol import FedRFTCATrainer as JTrainer  # noqa: E402
from repro.federated.protocol import ProtocolConfig as JProto  # noqa: E402
from repro.optim import adam as jadam  # noqa: E402
from repro.optim import apply_updates as japply  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm import wire as twire  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.federated import model as tmodel  # noqa: E402
from repro_torch.federated import network as tnetwork  # noqa: E402
from repro_torch.federated.network import RoundPlan  # noqa: E402
from repro_torch.federated.protocol import FedRFTCATrainer as TTrainer  # noqa: E402
from repro_torch.federated.protocol import ProtocolConfig as TProto  # noqa: E402
from repro_torch.kernels import quantize  # noqa: E402
from repro_torch.optim import adam as tadam  # noqa: E402
from repro_torch.optim import apply_updates as tapply  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

GRAD_TOL = 1e-5
LEAF_TOL = 1e-4
SIZES = dict(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
             rff_impl="fused", lambda_mmd=2.0)
JCFG = jmodel.ClientConfig(**SIZES)
TCFG = tmodel.ClientConfig(**SIZES)


@pytest.fixture(scope="module")
def setups():
    doms = make_domains(4, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    ragged = [doms[0], Domain("s1", doms[1].x[:, :70], doms[1].y[:70]),
              Domain("s2", doms[2].x[:, :20], doms[2].y[:20])]
    return {"equal": (doms[:3], doms[3]), "ragged": (ragged, doms[3])}


@pytest.fixture(scope="module")
def start():
    """The reference's shared initial parameters and Omega, as numpy."""
    params = jax.jit(jmodel.init_params, static_argnums=0)(JCFG, jax.random.PRNGKey(0))
    return (jax.tree_util.tree_map(np.asarray, params),
            np.asarray(jax.jit(jmodel.make_omega, static_argnums=0)(JCFG)))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _leaf_err(jtree, ttree) -> float:
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    return max(float(np.abs(np.asarray(a) - np.asarray(b.detach() if isinstance(b, torch.Tensor)
                                                      else b)).max()) for a, b in zip(jl, tl))


def _trainer_err(jt, tt) -> float:
    errs = [_leaf_err(jt.tgt_params, tt.tgt_params)]
    errs += [_leaf_err(jt._src_param(i), tt._src_param(i)) for i in range(jt.k)]
    return max(errs)


def _full_plan(monkeypatch, msg=None):
    def plan(rng, n, s):
        return RoundPlan(list(range(n)) if msg is None else msg, list(range(n)), list(range(n)))

    monkeypatch.setattr(jnetwork, "plan_round", plan)
    monkeypatch.setattr(tnetwork, "plan_round", plan)


# ---- model, Adam, aggregation ------------------------------------------------

def test_omega_and_init_shapes(start):
    params, omega = start
    t_omega = tmodel.make_omega(TCFG, device="cpu").numpy()
    np.testing.assert_allclose(t_omega, omega, rtol=0, atol=1e-6)
    t_init = tmodel.init_params(TCFG, 0, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(t_init)] == [
        x.shape for x in jax.tree_util.tree_leaves(params)]
    with pytest.raises(ValueError):
        tmodel.make_omega(tmodel.ClientConfig(input_dim=2, n_classes=2, rff_impl="x"),
                          device="cpu")


@pytest.mark.parametrize("ragged,gate", [(False, None), (True, 1.0), (True, 0.0)])
def test_source_loss_and_grads_match(start, setups, ragged, gate):
    params, omega = start
    dom = setups["equal"][0][0]
    x, y = dom.x[:, :32], dom.y[:32]
    mask = (np.arange(32) < 20).astype(np.float32) if ragged else None
    tgt_msg = np.asarray(jmodel.client_message(params, jnp.asarray(omega),
                                               jnp.asarray(setups["equal"][1].x[:, :40]), -1.0))
    jkw = dict(mmd_gate=None if gate is None else jnp.float32(gate),
               sample_mask=None if mask is None else jnp.asarray(mask))
    (jl, jaux), jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.source_loss(p, jnp.asarray(omega), jnp.asarray(x), jnp.asarray(y),
                                     jnp.asarray(tgt_msg), JCFG, **jkw), has_aux=True))(params)
    tkw = dict(mmd_gate=None if gate is None else torch.tensor(gate),
               sample_mask=None if mask is None else _t(mask))
    tp = convert.params_from_reference(params, device="cpu")
    tg, (tl, taux) = torch.func.grad_and_value(
        lambda p: tmodel.source_loss(p, _t(omega), _t(x), _t(y, torch.int64), _t(tgt_msg), TCFG,
                                     **tkw), has_aux=True)(tp)
    assert abs(float(tl) - float(jl)) <= GRAD_TOL
    assert abs(float(taux["l_mmd"]) - float(jaux["l_mmd"])) <= GRAD_TOL
    assert _leaf_err(jg, tg) <= GRAD_TOL


def test_target_loss_messages_and_accuracy_match(start, setups):
    params, omega = start
    sources, target = setups["equal"]
    xt = target.x[:, :48]
    jmsg = jax.jit(jmodel.client_message, static_argnums=3)
    msgs = np.stack([np.asarray(jmsg(params, jnp.asarray(omega), jnp.asarray(s.x[:, :30]), 1.0))
                     for s in sources])
    mask = (np.arange(30) < 17).astype(np.float32)
    tp = convert.params_from_reference(params, device="cpu")
    jm = jmsg(params, jnp.asarray(omega), jnp.asarray(sources[0].x[:, :30]), 1.0,
              mask=jnp.asarray(mask))
    tm = tmodel.client_message(tp, _t(omega), _t(sources[0].x[:, :30]), 1.0, mask=_t(mask))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=GRAD_TOL)
    for w in (None, np.float32([1, 0, 1])):
        (jl, _), jg = jax.jit(jax.value_and_grad(lambda p: jmodel.target_loss(
            p, jnp.asarray(omega), jnp.asarray(xt), jnp.asarray(msgs), JCFG,
            weights=None if w is None else jnp.asarray(w)), has_aux=True))(params)
        tg, (tl, _) = torch.func.grad_and_value(lambda p: tmodel.target_loss(
            p, _t(omega), _t(xt), _t(msgs), TCFG, weights=None if w is None else _t(w)),
            has_aux=True)(tp)
        assert abs(float(tl) - float(jl)) <= GRAD_TOL
        assert _leaf_err(jg, tg) <= GRAD_TOL
    ja = float(jax.jit(jmodel.accuracy)(params, jnp.asarray(omega), jnp.asarray(target.x),
                                        jnp.asarray(target.y)))
    ta = float(tmodel.accuracy(tp, _t(omega), _t(target.x), _t(target.y, torch.int64)))
    assert abs(ta - ja) < 1e-6  # the same count; the float32 means may part by one ULP


def test_adam_steps_match(start):
    params, _ = start
    rng = np.random.default_rng(2)
    grads = [jax.tree_util.tree_map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                                    params) for _ in range(4)]
    jopt, topt = jadam(5e-3), tadam(5e-3)
    jp, tp = params, convert.params_from_reference(params, device="cpu")
    js, ts = jopt.init(jp), topt.init(tp)

    @jax.jit
    def jstep(g, js, jp):
        ju, js = jopt.update(g, js, jp)
        return japply(jp, ju), js

    for g in grads:
        jp, js = jstep(g, js, jp)
        tu, ts = topt.update(convert.params_from_reference(g, device="cpu"), ts, tp)
        tp = tapply(tp, tu)
    assert int(ts.step) == int(js.step) == 4
    assert _leaf_err(jp, tp) <= 1e-6
    assert _leaf_err(js.nu, ts.nu) <= 1e-6


def test_aggregation_matches(start):
    params, _ = start
    rng = np.random.default_rng(4)
    jps = [jax.tree_util.tree_map(lambda a: (a + rng.normal(size=a.shape)).astype(np.float32),
                                  params) for _ in range(3)]
    tps = [convert.params_from_reference(p, device="cpu") for p in jps]
    assert _leaf_err(jagg.fedavg_w_rf(jps, jps[0], [0, 2]),
                     tagg.fedavg_w_rf(tps, tps[0], [0, 2])) <= 1e-6
    assert _leaf_err(jagg.fedavg_classifier(jps, [1, 2]),
                     tagg.fedavg_classifier(tps, [1, 2])) <= 1e-6
    assert tagg.fedavg_classifier(tps, []) is None
    for w in (None, [1.0, 2.0, 5.0]):
        assert _leaf_err(jagg.fedavg_models(jps, w), tagg.fedavg_models(tps, w)) <= 1e-6
    logits = rng.normal(size=(4, 30, 3)).astype(np.float32)
    logits[:, :5] = logits[0, :5]  # ties broken by summed logits
    np.testing.assert_array_equal(tagg.hard_vote(logits), jagg.hard_vote(logits))
    for mode in ("constant", "polynomial", "polynomial:1.5", "auto"):
        np.testing.assert_array_equal(
            tagg.staleness_weights([0, 1, 3], mode, n_samples=[10, 20, 5]),
            jagg.staleness_weights([0, 1, 3], mode, n_samples=[10, 20, 5]))
    for seed in range(5):
        for s in ("I", "II", "III"):
            assert tnetwork.plan_round(np.random.default_rng(seed), 6, s) == RoundPlan(
                *vars(jnetwork.plan_round(np.random.default_rng(seed), 6, s)).values())


# ---- trainers ----------------------------------------------------------------

def _pair(sources, target, params, **kw):
    """A reference and a port trainer built from the same initial parameters."""
    jt = JTrainer(sources, target, JCFG, JProto(warmup_rounds=0, **kw))
    tt = TTrainer(sources, target, TCFG, TProto(warmup_rounds=0, **kw), device="cpu")
    convert.load_reference_params(tt, jax.tree_util.tree_map(np.asarray, jt.tgt_params))
    if params is not None:
        assert _leaf_err(jt.tgt_params, tt.tgt_params) == 0.0
    return jt, tt


def test_serial_identity_trainer_matches_reference(setups):
    sources, target = setups["equal"]
    kw = dict(engine="serial", n_rounds=4, t_c=2, batch_size=32, drop_setting="II", seed=0)
    jt, tt = _pair(sources, target, True, **kw)
    for tr in (jt, tt):
        tr._warmup(2)
        tr.train()
    assert _trainer_err(jt, tt) < LEAF_TOL
    assert tt.comm.total == jt.comm.total
    assert tt.comm.bytes_by_kind == jt.comm.bytes_by_kind


@pytest.mark.parametrize("setup", ["equal", "ragged"])
def test_batched_matches_serial_under_full_participation(setups, monkeypatch, setup):
    sources, target = setups[setup]
    _full_plan(monkeypatch)
    kw = dict(n_rounds=4, t_c=2, local_steps=2, warmup_rounds=2, batch_size=32,
              message_batch_size=64, seed=0)
    ser = TTrainer(sources, target, TCFG, TProto(engine="serial", **kw), device="cpu")
    ser.train()
    bat = TTrainer(sources, target, TCFG, TProto(engine="batched", **kw), device="cpu")
    bat.train()
    if setup == "ragged":
        assert bat._batch_sizes == [32, 32, 20] and bat._msg_sizes == [64, 64, 20]
        assert tuple(bat._bmask.shape) == (3, 32) and tuple(bat._msg_mask.shape) == (3, 64)
    err = max([_leaf_err(jax.tree_util.tree_map(lambda t: t.numpy(), ser.tgt_params),
                         bat.tgt_params)]
              + [_leaf_err(jax.tree_util.tree_map(lambda t: t.numpy(), ser._src_param(i)),
                           bat._src_param(i)) for i in range(len(sources))])
    assert err < LEAF_TOL
    assert ser.comm.total == bat.comm.total
    assert abs(ser.evaluate() - bat.evaluate()) < 1e-6


@pytest.fixture(scope="module")
def tiny():
    doms = make_domains(4, 96, shift=0.5, seed=1, dim=8, n_classes=3)
    sizes = dict(input_dim=8, n_classes=3, n_rff=16, m=4, extractor_widths=(8, 4))
    return doms[:3], doms[3], jmodel.ClientConfig(**sizes), tmodel.ClientConfig(**sizes)


_REF_LOGS: dict = {}


@pytest.mark.parametrize("engine", ["serial", "batched"])
@pytest.mark.parametrize("transport,codec", [("identity", "float32"), ("wire", "float32"),
                                             ("wire", "qint8")])
def test_byte_accounting_equals_reference(tiny, transport, codec, engine):
    """tests/test_comm.py:249-305's runs: the same plans give the same logs."""
    sources, target, jcfg, tcfg = tiny
    kw = dict(n_rounds=4, t_c=2, warmup_rounds=1, batch_size=24, seed=0, transport=transport,
              codec=codec)
    # float32 over the wire logs what the identity transport logs (the
    # reference's own tests/test_comm.py:249), so one reference run serves both
    key = ("identity", "float32") if codec == "float32" else (transport, codec)
    if key not in _REF_LOGS:
        jt = JTrainer(sources, target, jcfg, JProto(engine="serial", **{
            **kw, "transport": key[0]}))
        jt.train()
        _REF_LOGS[key] = (dict(jt.comm.bytes_by_kind), dict(jt.comm.messages_by_kind),
                          jt.comm.total)
    tt = TTrainer(sources, target, tcfg, TProto(engine=engine, **kw), device="cpu")
    tt.train()
    assert (tt.comm.bytes_by_kind, tt.comm.messages_by_kind, tt.comm.total) == _REF_LOGS[key]
    assert 0.0 <= tt.evaluate() <= 1.0


def test_batched_wire_qint8_round_with_reference_uniforms(setups, monkeypatch):
    sources, target = setups["equal"]
    _full_plan(monkeypatch)
    kw = dict(engine="batched", transport="wire", codec="qint8", n_rounds=1, t_c=1,
              batch_size=32, seed=0)
    jt, tt = _pair(sources, target, True, **kw)
    chan_base = jax.random.PRNGKey(kw["seed"] ^ 0x5EED)

    def reference_uniforms(chan_key, path, n_rows, shape):
        k = jax.random.fold_in(jax.random.fold_in(chan_base, chan_key), path[0])
        for p in path[1:]:
            k = jax.random.fold_in(k, p)
        if n_rows is None:
            return _t(jax.random.uniform(k, shape, jnp.float32))
        keys = jax.random.split(k, n_rows)
        return _t(jax.vmap(lambda kk: jax.random.uniform(kk, shape, jnp.float32))(keys))

    monkeypatch.setattr(tt._engine, "channel_uniforms", reference_uniforms)
    launches = quantize.LAUNCHES["fake_quant"]
    jt.train()
    tt.train()
    assert quantize.LAUNCHES["fake_quant"] == launches  # CPU: the plain version
    step = max(float(np.abs(np.asarray(leaf)).max()) / 127 for leaf in
               jax.tree_util.tree_leaves((jt.tgt_params["w_rf"], jt.tgt_params["classifier"])))
    diffs = np.concatenate([
        np.abs(np.asarray(a) - b.numpy()).ravel()
        for a, b in zip(jax.tree_util.tree_leaves((jt.tgt_params, jt._src_stack)),
                        tree_leaves((tt.tgt_params, tt._src_stack)))])
    assert diffs.max() <= step
    assert np.mean(diffs <= 1e-4) >= 0.99
    assert tt.comm.bytes_by_kind == jt.comm.bytes_by_kind


@pytest.fixture(scope="module")
def ckpt_pair(setups):
    sources, target = setups["equal"]
    kw = dict(engine="batched", n_rounds=2, t_c=1, warmup_rounds=1, batch_size=32, seed=3)
    return (JTrainer(sources, target, JCFG, JProto(**kw)),
            TTrainer(sources, target, TCFG, TProto(**kw), device="cpu"))


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_checkpoints_cross_between_packages(ckpt_pair, tmp_path, direction):
    """Trained in one package, saved, restored into the other's trainer of the
    same structure: every array leaf and the host-side randomness equal."""
    jt, tt = ckpt_pair
    if direction == "port_to_reference":
        tt.train()
        jt.restore_state(tt.save_state(str(tmp_path / "ck")))
    else:
        jt.train()
        jt.save_state(str(tmp_path / "ck"), step=5)
        tt.restore_state(str(tmp_path / "ck"))
    assert _leaf_err(jt._array_state(), tt._array_state()) == 0.0
    assert tt.model_version == jt.model_version
    assert tt._tgt_msg_iter.state() == jt._tgt_msg_iter.state()
    assert tt.rng.bit_generator.state == jt.rng.bit_generator.state


@pytest.mark.parametrize("engine", ["serial", "batched"])
def test_seed_replay_pins_w_rf_and_hard_vote_runs(tiny, engine):
    sources, target, _, tcfg = tiny
    proto = TProto(engine=engine, transport="wire", codec="seed_replay", n_rounds=4, t_c=2,
                   warmup_rounds=1, batch_size=24, seed=0, aggregate_classifier=False)
    tr = TTrainer(sources, target, tcfg, proto, device="cpu")
    tr.train()
    for i in range(tr.k):
        assert torch.equal(tr._src_param(i)["w_rf"], tr._w_init)
    assert torch.equal(tr.tgt_params["w_rf"], tr._w_init)
    if tr.comm.messages_by_kind["w_rf"]:
        assert tr.comm.bytes_by_kind["w_rf"] / tr.comm.messages_by_kind["w_rf"] < 64
    assert tr.comm.w_rf == 0
    assert 0.0 <= tr.evaluate() <= 1.0
    with pytest.raises(ValueError):
        convert.load_reference_params(tr, {})


@pytest.mark.parametrize("engine", ["serial", "batched"])
@pytest.mark.parametrize("codec", ["float16", "bfloat16", "qint4", "topk:0.5", "auto:0.05"])
def test_every_codec_trains_over_the_wire(tiny, engine, codec):
    """Every codec runs on both engines over the wire: the same messages as
    float32, each frame at its codec's analytic size; ``auto:`` resolves as
    the reference resolves it."""
    from repro.comm import autocodec as jauto

    sources, target, _, tcfg = tiny
    kw = dict(engine=engine, transport="wire", n_rounds=3, t_c=2, warmup_rounds=1, batch_size=24,
              seed=1)
    tr = TTrainer(sources, target, tcfg, TProto(codec=codec, **kw), device="cpu")
    tr.train()
    assert tr.resolved_codec == jauto.resolve(codec)
    ref = TTrainer(sources, target, tcfg, TProto(codec="float32", **kw), device="cpu")
    ref.train()
    assert tr.comm.messages_by_kind == ref.comm.messages_by_kind
    for kind, n in tr.comm.messages_by_kind.items():  # every frame at its analytic size
        size = twire.serialized_size(kind, tr._specs[kind], tr.transport.codecs[kind])
        assert tr.comm.bytes_by_kind[kind] == n * size
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(tr.tgt_params))
    assert 0.0 <= tr.evaluate() <= 1.0


def test_classifier_crosses_the_channel_on_t_c_rounds_only(tiny):
    """The batched engine sends the classifier leaves through the lossy
    channel on T_C rounds only; the other kinds every round."""
    sources, target, _, tcfg = tiny
    proto = TProto(engine="batched", transport="wire", codec="qint8", n_rounds=4, t_c=2,
                   warmup_rounds=1, batch_size=24, seed=0)
    tr = TTrainer(sources, target, tcfg, proto, device="cpu")
    draws = []
    draw = tr._engine.channel_uniforms

    def recording(chan_key, path, n_rows, shape):
        draws.append((chan_key, path[0]))
        return draw(chan_key, path, n_rows, shape)

    tr._engine.channel_uniforms = recording
    tr.train()
    rounds = sorted({t for t, _ in draws})
    assert len(rounds) == 4
    for kind in (0, 1, 2):
        assert sorted(t for t, k in draws if k == kind) == rounds
    clf = sorted({t for t, k in draws if k == 3})
    assert clf == [t for t in rounds if t % 2 == 0] and clf
