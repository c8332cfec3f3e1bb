"""Port parity: repro_torch.robust (the five aggregation rules, the value
corruptors and Byzantine crafts, FaultConfig, ByteFaultInjector) and the
trainer's ``rule`` / ``faults`` options vs repro.robust on the CPU.

The port draws its fault randomness from ``FaultPlan.draws`` (a torch
generator keyed by round and path) where the reference folds ``jax.random``
keys; the parity tests hand the port the reference's own draws.
Tolerances: rule outputs 1e-5; corruptors bit for bit; trainers 1e-4
(tests/test_round_engine.py:77), with equal non-finite positions; the serial
wire plane's reject, drop, message and byte counts equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm.netsim import TraceScenario as JTrace  # noqa: E402
from repro.data import make_domains  # noqa: E402
from repro.federated import model as jmodel  # noqa: E402
from repro.federated.network import RoundPlan as JPlan  # noqa: E402
from repro.federated.protocol import FedRFTCATrainer as JTrainer  # noqa: E402
from repro.federated.protocol import ProtocolConfig as JProto  # noqa: E402
from repro.fleet import Topology as JTopology  # noqa: E402
from repro.robust import faults as jfaults  # noqa: E402
from repro.robust import rules as jrules  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm.netsim import TraceScenario  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.federated import model as tmodel  # noqa: E402
from repro_torch.federated.network import RoundPlan  # noqa: E402
from repro_torch.federated.protocol import FedRFTCATrainer as TTrainer  # noqa: E402
from repro_torch.federated.protocol import ProtocolConfig as TProto  # noqa: E402
from repro_torch.fleet import Topology  # noqa: E402
from repro_torch.robust import faults as tfaults  # noqa: E402
from repro_torch.robust import rules as trules  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

RULE_TOL = 1e-5
LEAF_TOL = 1e-4
RULES = ["mean", "finite_mean", "norm_clip", "norm_clip:2", "trimmed_mean",
         "trimmed_mean:0", "trimmed_mean:0.3", "geomedian", "geomedian:3"]
SIZES = dict(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
             rff_impl="fused", lambda_mmd=2.0)
JCFG = jmodel.ClientConfig(**SIZES)
TCFG = tmodel.ClientConfig(**SIZES)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _close(t: torch.Tensor, j, tol=RULE_TOL):
    t, j = t.detach().numpy(), np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    ok = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), ok)
    if ok.any():
        assert np.abs(t[ok] - j[ok]).max() <= tol * max(1.0, float(np.abs(j[ok]).max()))


def _stacks():
    """(name, values (K, ...), weights (K,)): random, tied, with non-finite
    rows, with an undelivered row and an outlier."""
    rng = np.random.default_rng(0)
    out = [("random", rng.normal(size=(7, 5, 3)), rng.uniform(0.2, 2.0, size=7))]
    ties = rng.integers(-2, 3, size=(9, 6)).astype(np.float64)
    out.append(("ties", ties, np.array([1, 1, 0, 1, 2, 1, 1, 0.5, 1])))
    bad = rng.normal(size=(6, 4))
    bad[1, 2], bad[4, 0] = np.nan, np.inf
    out.append(("non_finite", bad, np.array([1, 1, 1, 0, 1, 1])))
    outlier = rng.normal(size=(5, 8))
    outlier[3] = 1e6
    out.append(("outlier", outlier, np.ones(5)))
    out.append(("none_delivered", rng.normal(size=(3, 4)), np.zeros(3)))
    return [(n, v.astype(np.float32), w.astype(np.float32)) for n, v, w in out]


@pytest.mark.parametrize("spec", RULES)
@pytest.mark.parametrize("stack", range(5))
def test_rules_match_reference(spec, stack):
    name, v, w = _stacks()[stack]
    jr, tr = jrules.get_rule(spec), trules.get_rule(spec)
    assert tr.name == jr.name and tr.is_mean == jr.is_mean
    js, jm = jr.weighted_sum(jnp.asarray(v), jnp.asarray(w))
    ts, tm = tr.weighted_sum(_t(v), _t(w))
    _close(ts, js)
    _close(tm, jm)
    _close(tr.estimate(_t(v), _t(w)), jr.estimate(jnp.asarray(v), jnp.asarray(w)))
    _close(tr.attribution(_t(v), _t(w)), jr.attribution(jnp.asarray(v), jnp.asarray(w)))
    msgs = v.reshape(v.shape[0], -1)
    for a, b in zip(tr.merge_moments(_t(msgs), _t(w)),
                    jr.merge_moments(jnp.asarray(msgs), jnp.asarray(w))):
        _close(a, b)


def test_finite_guard_matches_reference():
    v = np.array([[1.0, 2.0], [np.nan, 0.0], [3.0, np.inf], [4.0, 5.0]], np.float32)
    w = np.array([1, 1, 1, 0.5], np.float32)
    jv, jw = jrules.finite_guard(jnp.asarray(v), jnp.asarray(w))
    tv, tw = trules.finite_guard(_t(v), _t(w))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert tw.tolist() == [1.0, 0.0, 0.0, 0.5]


def test_get_rule_parsing_matches_reference():
    for spec in ("mean", "finite_mean", "norm_clip", "norm_clip:2.5", "trimmed_mean:0.25",
                 "geomedian:4", "geomedian"):
        jr, tr = jrules.get_rule(spec), trules.get_rule(spec)
        assert type(tr).__name__ == type(jr).__name__ and tr.name == jr.name
        for attr in ("clip", "beta", "iters"):
            assert getattr(tr, attr, None) == getattr(jr, attr, None)
    rule = trules.TrimmedMeanRule(0.1)
    assert trules.get_rule(rule) is rule
    assert trules.rule_names() == jrules.rule_names()
    assert tagg.get_rule is trules.get_rule  # the aggregation re-export seam
    for make, match in ((lambda m: m.get_rule("krum"), "unknown aggregation rule"),
                        (lambda m: m.TrimmedMeanRule(0.5), "trim fraction"),
                        (lambda m: m.GeoMedianRule(0), "Weiszfeld")):
        for mod in (jrules, trules):
            with pytest.raises(ValueError, match=match):
                make(mod)


# ---- value corruptors and Byzantine crafts on the reference's draws ------------------------

def _reference_draws(plan: tfaults.FaultPlan, kind: str, key, n_rows: int, shape):
    """What ``FaultPlan.draws`` returns, computed from the reference's keys:
    one key per row, the craft on it, the corruptor on fold_in(key, 1) split
    into (gate, hit), bit_flip's hit split again into (index, bit)."""
    size = int(np.prod(shape))
    keys = jax.random.split(key, n_rows)
    out = {}
    fn = plan.corruptors.get(kind)
    if fn is not None:
        ck = jax.vmap(lambda k: jax.random.split(jax.random.fold_in(k, 1)))(keys)
        gate, hit = ck[:, 0], ck[:, 1]
        out["gate"] = jax.vmap(lambda k: jax.random.uniform(k, ()))(gate)
        if fn.mode == "bit_flip":
            pair = jax.vmap(jax.random.split)(hit)
            out["index"] = jax.vmap(lambda k: jax.random.randint(k, (), 0, size))(pair[:, 0])
            out["bit"] = jax.vmap(lambda k: jax.random.randint(k, (), 0, 32))(pair[:, 1])
        elif fn.mode == "nan":
            out["index"] = jax.vmap(lambda k: jax.random.randint(k, (), 0, size))(hit)
        elif fn.mode == "truncate":
            out["offset"] = jax.vmap(lambda k: jax.random.randint(k, (), 1, size))(hit)
    if plan.craft is not None and plan.craft.mode == "random":
        out["noise"] = jax.vmap(lambda k: jax.random.normal(k, shape))(keys)
    return {k: torch.from_numpy(np.array(v)).to(torch.float32 if k in ("gate", "noise")
                                                else torch.int64) for k, v in out.items()}


@pytest.mark.parametrize("mode", tfaults.VALUE_MODES)
@pytest.mark.parametrize("rate", [0.0, 0.5, 1.0])
def test_corruptors_match_reference_on_its_draws(mode, rate):
    x = np.random.default_rng(3).normal(size=(6, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    cfg = dict(corrupt_moments=rate, corruption=mode, corruption_scale=7.0)
    jplan = jfaults.build_fault_plan(jfaults.FaultConfig(**cfg), 6)
    tplan = tfaults.build_fault_plan(tfaults.FaultConfig(**cfg), 6)
    if rate == 0.0:
        assert jplan is None and tplan is None
        return
    want = np.asarray(jplan.apply("moments", jnp.asarray(x), key))
    dr = _reference_draws(tplan, "moments", key, 6, (4, 3))
    got = tplan.corruptors["moments"](_t(x), dr).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if rate == 1.0 and mode != "scale":
        assert (got != x).any(axis=(1, 2)).all() or mode == "truncate"


@pytest.mark.parametrize("mode", tfaults.BYZANTINE_MODES)
def test_byzantine_crafts_match_reference_on_its_draws(mode):
    x = np.random.default_rng(4).normal(size=(5, 7)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    cfg = dict(byzantine=(1, 3), byzantine_mode=mode, byzantine_scale=4.0,
               corrupt_w_rf=0.5, corruption="sign_flip")
    jplan = jfaults.build_fault_plan(jfaults.FaultConfig(**cfg), 5)
    tplan = tfaults.build_fault_plan(tfaults.FaultConfig(**cfg), 5)
    want = np.asarray(jplan.apply("w_rf", jnp.asarray(x), key))
    draws = _reference_draws(tplan, "w_rf", key, 5, (7,))
    tplan.draws = lambda *a: draws
    got = tplan.apply("w_rf", _t(x), 1, (8,)).numpy()
    _close(torch.from_numpy(got), want, tol=1e-6)
    assert tplan.apply("classifier", _t(x), 1, (9,)).shape == x.shape


def test_fault_plan_draws_are_keyed_by_round_and_path():
    plan = tfaults.build_fault_plan(tfaults.FaultConfig(corrupt_classifier=0.5,
                                                        corruption="nan", byzantine=(0,),
                                                        byzantine_mode="random"), 4, seed=3)
    a = plan.draws("classifier", 5, (9,), 4, (3,), "cpu")
    b = plan.draws("classifier", 5, (9,), 4, (6, 2), "cpu")
    assert torch.equal(a["gate"], b["gate"])  # payloads of one message share gates
    assert set(a) == {"gate", "index", "noise"} and tuple(b["noise"].shape) == (4, 6, 2)
    c = plan.draws("classifier", 6, (9,), 4, (3,), "cpu")
    assert not torch.equal(a["gate"], c["gate"])
    assert plan.draws("moments", 5, (7,), 4, (3,), "cpu").keys() == {"noise"}


def test_fault_config_validation_matches_reference():
    for mod in (jfaults, tfaults):
        assert mod.FaultConfig().is_noop
        assert mod.build_fault_plan(mod.FaultConfig(), 3) is None
        assert mod.build_fault_plan(None, 3) is None
        for kw, match in ((dict(corruption="gamma_ray"), "corruption mode"),
                          (dict(byzantine_mode="subtle"), "byzantine mode"),
                          (dict(corrupt_moments=1.5), r"in \[0, 1\]")):
            with pytest.raises(ValueError, match=match):
                mod.FaultConfig(**kw)
        with pytest.raises(ValueError, match="out of range"):
            mod.build_fault_plan(mod.FaultConfig(byzantine=(7,)), 3)
        assert mod.FaultConfig(corrupt_w_rf=0.1).rates == {"moments": 0.0, "w_rf": 0.1,
                                                           "classifier": 0.0}
    plan = tfaults.build_fault_plan(tfaults.FaultConfig(byzantine=(1,)), 3)
    out = plan.apply("moments", torch.ones(3, 4), 0, (7,))
    assert torch.equal(out[1], -torch.ones(4)) and torch.equal(out[0], torch.ones(4))


@pytest.mark.parametrize("mode", tfaults.BYTE_MODES)
def test_byte_fault_injector_matches_reference_frame_for_frame(mode):
    kw = dict(rates={"moments": 0.6, "w_rf": 0.3}, mode=mode, max_retries=3, seed=5)
    ji, ti = jfaults.ByteFaultInjector(**kw), tfaults.ByteFaultInjector(**kw)
    rng = np.random.default_rng(0)
    for i in range(60):
        data = rng.integers(0, 256, size=int(rng.integers(1, 40)), dtype=np.uint8).tobytes()
        kind = ("moments", "w_rf", "classifier")[i % 3]
        assert ti.corrupt(kind, data) == ji.corrupt(kind, data)
    cfg = dict(corrupt_moments=0.2, corruption="nan", max_retries=4, seed=9)
    a = tfaults.ByteFaultInjector.from_config(tfaults.FaultConfig(**cfg))
    b = jfaults.ByteFaultInjector.from_config(jfaults.FaultConfig(**cfg))
    assert (a.rates, a.mode, a.max_retries, a.seed) == (b.rates, b.mode, b.max_retries, b.seed)
    with pytest.raises(ValueError, match="byte mode"):
        tfaults.ByteFaultInjector(mode="nan")


# ---- trainers ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def doms():
    d = make_domains(5, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    return d[:4], d[4]


def _reference_fault_draws(tt, seed):
    """Replace the port plan's draws with the reference's: round key
    fold_in(PRNGKey(seed ^ 0x5EED), t), then fold_in(path)."""
    plan = tt._engine.faults
    base = jax.random.PRNGKey(seed ^ 0x5EED)

    def draws(kind, chan_key, path, n_rows, shape, device):
        key = jax.random.fold_in(jax.random.fold_in(base, chan_key), path[0])
        return _reference_draws(plan, kind, key, n_rows, shape)

    plan.draws = draws


def _pair(sources, target, faults, **kw):
    ids = list(range(len(sources)))
    jt = JTrainer(sources, target, JCFG, JProto(
        warmup_rounds=0, faults=None if faults is None else jfaults.FaultConfig(**faults),
        scenario=JTrace([JPlan(ids, ids, ids)], cycle=True), **kw.get("j", {}), **kw["both"]))
    tt = TTrainer(sources, target, TCFG, TProto(
        warmup_rounds=0, faults=None if faults is None else tfaults.FaultConfig(**faults),
        scenario=TraceScenario([RoundPlan(ids, ids, ids)], cycle=True), **kw.get("t", {}),
        **kw["both"]), device="cpu")
    convert.load_reference_params(tt, jax.tree_util.tree_map(np.asarray, jt.tgt_params))
    return jt, tt


TRAINER_CASES = {
    "trimmed_byzantine_scale": (dict(byzantine=(0,), byzantine_mode="scale",
                                     byzantine_scale=100.0), "trimmed_mean", None),
    "finite_mean_nan_flat": (dict(corrupt_moments=0.5, corrupt_w_rf=0.5,
                                  corrupt_classifier=0.5, corruption="nan"), "finite_mean",
                             None),
    "finite_mean_nan_two_tier": (dict(corrupt_moments=0.5, corrupt_w_rf=0.5,
                                      corrupt_classifier=0.5, corruption="nan"), "finite_mean",
                                 [[0, 1], [2, 3]]),
    "mean_nan_two_tier": (dict(corrupt_moments=0.5, corruption="nan"), "mean",
                          [[0, 1], [2, 3]]),
    "geomedian_bit_flip_two_tier": (dict(corrupt_w_rf=0.5, corrupt_classifier=1.0,
                                         corruption="bit_flip"), "geomedian",
                                    [[0, 2], [1, 3]]),
    "norm_clip_byzantine_random": (dict(byzantine=(2,), byzantine_mode="random"), "norm_clip",
                                   None),
}


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_robust_trainer_matches_reference(doms, case):
    """The port on the reference's fault draws follows the reference's
    trajectory, non-finite positions included: under NaN corruption a
    two-tier merge spreads a NaN to every edge through the weighted-membership
    contraction (the K9 contract), and both packages keep it."""
    sources, target = doms
    faults, rule, groups = TRAINER_CASES[case]
    both = dict(n_rounds=4, t_c=2, batch_size=32, seed=0, rule=rule)
    jt, tt = _pair(sources, target, faults, both=both,
                   j=dict(topology=None if groups is None else JTopology.of_groups(groups)),
                   t=dict(topology=None if groups is None else Topology.of_groups(groups)))
    _reference_fault_draws(tt, both["seed"])
    for tr in (jt, tt):
        tr._warmup(1)
        tr.train()
    for jtree, ttree in ((jt.tgt_params, tt.tgt_params), (jt._src_stack, tt._src_stack)):
        for a, b in zip(jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)):
            _close(b, a, tol=LEAF_TOL)
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(tt.tgt_params))
    assert finite == (rule != "mean")


def test_nan_corruption_poisons_mean_but_not_robust_rules(doms):
    """tests/test_robust.py:281 on the port's own draws."""
    sources, target = doms
    ids = list(range(4))
    kw = dict(n_rounds=3, t_c=2, warmup_rounds=1, batch_size=32, seed=0,
              scenario=TraceScenario([RoundPlan(ids, ids, ids)], cycle=True),
              faults=tfaults.FaultConfig(corrupt_moments=0.5, corrupt_w_rf=0.5,
                                         corruption="nan"))
    for rule in ("mean", "finite_mean", "trimmed_mean", "geomedian", "norm_clip"):
        tr = TTrainer(sources, target, TCFG, TProto(rule=rule, **kw), device="cpu")
        tr.train()
        leaves = tree_leaves((tr.tgt_params, tr._src_stack))
        assert all(bool(torch.isfinite(x).all()) for x in leaves) == (rule != "mean"), rule


def test_mean_rule_and_noop_faults_are_the_fault_free_round(doms):
    sources, target = doms
    kw = dict(n_rounds=3, t_c=2, warmup_rounds=1, batch_size=32, seed=0)
    ref = TTrainer(sources, target, TCFG, TProto(**kw), device="cpu")
    ref.train()
    tr = TTrainer(sources, target, TCFG, TProto(rule="mean", faults=tfaults.FaultConfig(), **kw),
                  device="cpu")
    assert tr._engine.faults is None
    tr.train()
    for a, b in zip(tree_leaves((ref.tgt_params, ref._src_stack)),
                    tree_leaves((tr.tgt_params, tr._src_stack))):
        assert torch.equal(a, b)


def test_serial_wire_trainer_survives_frame_corruption_like_reference(doms):
    sources, target = doms
    faults = dict(corrupt_moments=0.3, corrupt_w_rf=0.3, corrupt_classifier=0.3)
    jt, tt = _pair(sources[:3], target, faults, both=dict(
        n_rounds=4, t_c=2, batch_size=32, seed=0, engine="serial", transport="wire"))
    for tr in (jt, tt):
        tr._warmup(1)
        tr.train()
    assert tt.transport.fault_injector is not None and tt.comm.rejects_total > 0
    for field in ("rejects_by_kind", "drops_by_kind", "messages_by_kind", "bytes_by_kind"):
        assert getattr(tt.comm, field) == getattr(jt.comm, field), field
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(tt.tgt_params))
    err = max(float(np.abs(np.asarray(a) - b.numpy()).max()) for a, b in zip(
        jax.tree_util.tree_leaves(jt.tgt_params), tree_leaves(tt.tgt_params)))
    assert err < LEAF_TOL


@pytest.mark.parametrize("kw,match", [
    (dict(engine="serial", rule="trimmed_mean"), "batched engine"),
    (dict(engine="serial", faults="nan"), "transport='wire'"),
])
def test_robust_protocol_validation_matches_reference(doms, kw, match):
    sources, target = doms
    for P, Tr, cfg, F, extra in ((JProto, JTrainer, JCFG, jfaults.FaultConfig, {}),
                                 (TProto, TTrainer, TCFG, tfaults.FaultConfig,
                                  {"device": "cpu"})):
        args = dict(kw)
        if "faults" in args:
            args["faults"] = F(corrupt_moments=0.5, corruption=args["faults"])
        with pytest.raises(ValueError, match=match):
            Tr(sources, target, cfg, P(warmup_rounds=0, **args), **extra)
