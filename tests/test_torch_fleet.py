"""Port parity: repro_torch.fleet (Topology, the K9 segment reduce's plain
version, the two-tier merges, chunked and sharded client maps) and the
trainer's fleet options vs repro.fleet on the CPU.

Tolerances: segment sums 1e-5 (tests/test_fleet.py:95), with equal
non-finite positions; the hierarchy's merges 1e-5; chunked and sharded maps
bit for bit; the working-set proxy exactly linear in the chunk (the
reference's own test of it fails on this CPU build, so the port is held to
the property that test states); trainers 1e-4 (tests/test_round_engine.py:77)
against the reference, 1e-6 port singleton against port flat
(tests/test_fleet.py:162); byte and message logs of both tiers equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm.codecs import get_codec as jget_codec  # noqa: E402
from repro.comm.netsim import TraceScenario as JTrace  # noqa: E402
from repro.data import make_domains  # noqa: E402
from repro.federated import model as jmodel  # noqa: E402
from repro.federated.network import RoundPlan as JPlan  # noqa: E402
from repro.federated.protocol import FedRFTCATrainer as JTrainer  # noqa: E402
from repro.federated.protocol import ProtocolConfig as JProto  # noqa: E402
from repro.fleet import Topology as JTopology  # noqa: E402
from repro.fleet import edge_moment_merge as j_moment_merge  # noqa: E402
from repro.fleet import edge_param_merge as j_param_merge  # noqa: E402
from repro.fleet import server_combine as j_server_combine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.comm.codecs import get_codec  # noqa: E402
from repro_torch.comm.netsim import TraceScenario  # noqa: E402
from repro_torch.federated import aggregation as tagg  # noqa: E402
from repro_torch.federated import model as tmodel  # noqa: E402
from repro_torch.federated.network import RoundPlan  # noqa: E402
from repro_torch.federated.protocol import FedRFTCATrainer as TTrainer  # noqa: E402
from repro_torch.federated.protocol import ProtocolConfig as TProto  # noqa: E402
from repro_torch.fleet import (  # noqa: E402
    Topology,
    chunked_vmap,
    client_mesh,
    edge_moment_merge,
    edge_param_merge,
    server_combine,
    sharded_client_map,
    working_set_proxy,
)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import segment_reduce as tseg  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

SEG_TOL = 1e-5
LEAF_TOL = 1e-4
SIZES = dict(input_dim=8, n_classes=3, n_rff=32, m=8, extractor_widths=(16, 8),
             rff_impl="fused", lambda_mmd=2.0)
JCFG = jmodel.ClientConfig(**SIZES)
TCFG = tmodel.ClientConfig(**SIZES)
SEG_SHAPES = [(8, 16, 3), (128, 64, 4), (130, 70, 5), (1, 5, 1)]


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


def _leaf_err(jtree, ttree) -> float:
    jl, tl = jax.tree_util.tree_leaves(jtree), tree_leaves(ttree)
    assert len(jl) == len(tl)
    return max(float(np.abs(np.asarray(a) - b.detach().numpy()).max()) for a, b in zip(jl, tl))


def _trainer_err(jt, tt) -> float:
    return max(_leaf_err(jt.tgt_params, tt.tgt_params), _leaf_err(jt._src_stack, tt._src_stack))


def _reference_uniforms(seed):
    """The reference's channel uniforms, in the port's ``channel_uniforms``
    signature: path (p0, p1, ...) is fold_in(fold_in(round key, p0), p1)...,
    then one key per row."""
    chan_base = jax.random.PRNGKey(seed ^ 0x5EED)

    def uniforms(chan_key, path, n_rows, shape):
        k = jax.random.fold_in(chan_base, chan_key)
        for p in path:
            k = jax.random.fold_in(k, p)
        if n_rows is None:
            return _t(jax.random.uniform(k, shape, jnp.float32))
        keys = jax.random.split(k, n_rows)
        return _t(jax.vmap(lambda kk: jax.random.uniform(kk, shape, jnp.float32))(keys))

    return uniforms


# ---- topology -------------------------------------------------------------------------

@pytest.mark.parametrize("make", [
    lambda T: T.uniform(10, 3), lambda T: T.uniform(7, 7), lambda T: T.singleton(5),
    lambda T: T.star(4), lambda T: T.of_groups([[0, 2], [1, 3]]),
    lambda T: T.of_groups([[3], [0, 1, 4], [2]]), lambda T: T((0, 1, 0, 2, 1)),
])
def test_topology_matches_reference(make):
    jt, tt = make(JTopology), make(Topology)
    assert tt.assignment == jt.assignment
    assert (tt.n_clients, tt.n_edges) == (jt.n_clients, jt.n_edges)
    np.testing.assert_array_equal(tt.segment_ids, jt.segment_ids)
    assert tt.segment_ids.dtype == jt.segment_ids.dtype
    np.testing.assert_array_equal(tt.edge_matrix(), jt.edge_matrix())
    for e in range(jt.n_edges):
        assert tt.members(e) == jt.members(e)
    for k in range(jt.n_clients):
        assert tt.edge_of(k) == jt.edge_of(k)
    assert tt.edges_of([0, jt.n_clients - 1]) == jt.edges_of([0, jt.n_clients - 1])


@pytest.mark.parametrize("make", [
    lambda T: T((0, 2)), lambda T: T((1, 2)), lambda T: T(()),
    lambda T: T.of_groups([[0, 1], [1]]), lambda T: T.of_groups([[0, 1], []]),
    lambda T: T.of_groups([[0, 2]]), lambda T: T.uniform(4, 5), lambda T: T.uniform(4, 0),
])
def test_topology_validation_matches_reference(make):
    with pytest.raises(ValueError) as jerr:
        make(JTopology)
    with pytest.raises(ValueError) as terr:
        make(Topology)
    assert str(terr.value) == str(jerr.value)


# ---- K9's plain version ------------------------------------------------------------------

@pytest.mark.parametrize("k,d,e", SEG_SHAPES)
def test_segment_reduce_plain_matches_reference(k, d, e):
    rng = np.random.default_rng(k * 7 + d)
    vals = rng.normal(size=(k, d)).astype(np.float32)
    seg = rng.integers(0, e, size=(k,)).astype(np.int32)
    w = rng.random(size=(k,)).astype(np.float32)
    want = np.asarray(jops.segment_reduce(jnp.asarray(vals), jnp.asarray(seg), jnp.asarray(w),
                                          n_segments=e, interpret=True))
    twin = np.asarray(jref.segment_reduce_ref(jnp.asarray(vals), jnp.asarray(seg),
                                              jnp.asarray(w), e))
    launches = tseg.LAUNCHES["segment_reduce"]
    for fn in (lambda v, s, ww: tseg.segment_reduce_plain(v, s, ww, e),
               lambda v, s, ww: tops.segment_reduce(v, s, ww, n_segments=e),
               lambda v, s, ww: tref.segment_reduce_ref(v, s, ww, e),
               lambda v, s, ww: tagg.edge_weighted_sums(v, s, ww, e)):
        out = fn(_t(vals), torch.from_numpy(seg), _t(w)).numpy()
        assert out.shape == (e, d) and out.dtype == np.float32
        assert np.abs(out - want).max() < SEG_TOL and np.abs(out - twin).max() < SEG_TOL
        zero = fn(_t(vals), torch.from_numpy(seg), torch.zeros(k)).numpy()
        assert np.abs(zero).max() == 0.0  # zero weights contribute exact zeros
    assert tseg.LAUNCHES["segment_reduce"] == launches  # CPU tensors: the plain version


def test_segment_reduce_plain_spreads_non_finite_values_like_reference():
    """0 * NaN = NaN in the weighted-membership product: a non-finite value
    in column d reaches every edge's column d, and the port keeps it."""
    rng = np.random.default_rng(5)
    cases = [(np.array([[1, 2, 3], [np.nan, 5, 6], [7, 8, np.inf], [1, 2, 3]], np.float32),
              np.array([0, 0, 1, 1], np.int32), np.array([1, 0, 1, 1], np.float32), 2)]
    vals = rng.normal(size=(130, 70)).astype(np.float32)
    vals[3, 5], vals[77, 5], vals[12, 9], vals[100, 40] = np.nan, np.inf, -np.inf, np.nan
    w = rng.random(size=(130,)).astype(np.float32)
    w[12] = 0.0  # 0 * -Inf
    cases.append((vals, rng.integers(0, 5, size=(130,)).astype(np.int32), w, 5))
    for vals, seg, w, e in cases:
        want = np.asarray(jref.segment_reduce_ref(jnp.asarray(vals), jnp.asarray(seg),
                                                  jnp.asarray(w), e))
        out = tseg.segment_reduce_plain(_t(vals), torch.from_numpy(seg), _t(w), e).numpy()
        np.testing.assert_array_equal(np.isnan(out), np.isnan(want))
        np.testing.assert_array_equal(np.isposinf(out), np.isposinf(want))
        np.testing.assert_array_equal(np.isneginf(out), np.isneginf(want))
        ok = np.isfinite(want)
        assert np.abs(out[ok] - want[ok]).max() < SEG_TOL and not ok.all()
    first = tseg.segment_reduce_plain(*(torch.from_numpy(a) for a in cases[0][:3]), 2).numpy()
    np.testing.assert_array_equal(first, [[np.nan, 2, np.nan], [np.nan, 10, np.inf]])


def test_segment_reduce_refuses_mixed_devices():
    with pytest.raises(ValueError, match="segment_reduce"):
        tseg.segment_reduce(torch.ones(2, 3), torch.zeros(2, dtype=torch.int32),
                            torch.ones(2, device="meta"), 1)


# ---- the hierarchy's merges --------------------------------------------------------------

def _edge_channels(seed_path):
    """The tier-2 qint8 round trip in both packages on the same uniforms."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), seed_path)
    jcodec, tcodec = jget_codec("qint8"), get_codec("qint8")

    def port(rows):
        keys = jax.random.split(key, rows.shape[0])
        u = jax.vmap(lambda kk: jax.random.uniform(kk, tuple(rows.shape[1:]), jnp.float32))(keys)
        return tcodec.roundtrip(rows, _t(u))

    return (jcodec.roundtrip, key), port


@pytest.mark.parametrize("tier2", [False, True])
@pytest.mark.parametrize("topo", ["uniform", "singleton", "star", "grouped"])
def test_merges_match_reference(topo, tier2):
    make = {"uniform": lambda T: T.uniform(7, 3), "singleton": lambda T: T.singleton(7),
            "star": lambda T: T.star(7),
            "grouped": lambda T: T.of_groups([[0, 3, 6], [1, 2], [4, 5]])}[topo]
    jt, tt = make(JTopology), make(Topology)
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(7, 6, 4)).astype(np.float32)
    msgs = rng.normal(size=(7, 10)).astype(np.float32)
    w = rng.random(size=(7,)).astype(np.float32)
    w[1] = 0.0
    jseg, tseg_ids = jnp.asarray(jt.segment_ids), torch.from_numpy(tt.segment_ids)
    (jfn, jkey), tfn = _edge_channels(1) if tier2 else ((None, None), None)
    jp, jm = j_param_merge(jnp.asarray(vals), jnp.asarray(w), jseg, jt.n_edges, jfn, jkey)
    tp, tm = edge_param_merge(_t(vals), _t(w), tseg_ids, tt.n_edges, tfn)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=SEG_TOL)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=SEG_TOL)
    js, jmass = j_server_combine(jp, jm)
    ts, tmass = server_combine(tp, tm)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=SEG_TOL)
    assert abs(float(tmass) - float(jmass)) < SEG_TOL
    if not tier2:  # associativity: the two-tier sum is the flat sum
        flat = np.einsum("k,kij->ij", w, vals)
        np.testing.assert_allclose(ts.numpy(), flat, rtol=0, atol=SEG_TOL)
    (jfn, jkey), tfn = _edge_channels(2) if tier2 else ((None, None), None)
    jpool, jmm = j_moment_merge(jnp.asarray(msgs), jnp.asarray(w), jseg, jt.n_edges, jfn, jkey)
    tpool, tmm = edge_moment_merge(_t(msgs), _t(w), tseg_ids, tt.n_edges, tfn)
    np.testing.assert_allclose(tpool.numpy(), np.asarray(jpool), rtol=0, atol=SEG_TOL)
    np.testing.assert_allclose(tmm.numpy(), np.asarray(jmm), rtol=0, atol=SEG_TOL)


def test_moment_merge_pooling_semantics():
    """tests/test_fleet.py:131's pins on the port: a singleton participant
    pools to its own message bit for bit; an empty edge has zero mass and a
    finite row."""
    msgs = _t(np.random.default_rng(1).normal(size=(4, 10)))
    seg = torch.from_numpy(Topology.of_groups([[0, 1], [2, 3]]).segment_ids)
    pooled, mass = edge_moment_merge(msgs, torch.tensor([1.0, 0.0, 0.0, 1.0]), seg, 2)
    assert torch.equal(pooled[0], msgs[0]) and torch.equal(pooled[1], msgs[3])
    assert mass.tolist() == [1.0, 1.0]
    pooled, mass = edge_moment_merge(msgs, torch.tensor([1.0, 1.0, 0.0, 0.0]), seg, 2)
    assert float(mass[1]) == 0.0 and bool(torch.isfinite(pooled).all())


# ---- chunked and sharded client maps -----------------------------------------------------

def _map_inputs():
    rng = np.random.default_rng(0)
    return (_t(rng.normal(size=(5, 6, 4))), _t(rng.normal(size=(5, 4, 3))),
            _t(rng.normal(size=(4,))))


def _body(xi, wi, ci):
    z = torch.tanh(xi @ wi)
    return z.sum(-1) + (xi @ ci).sum(), z


@pytest.mark.parametrize("chunk", [2, 3, 5, 9, None])
def test_chunked_vmap_is_vmap_bit_for_bit(chunk):
    x, w, c = _map_inputs()
    want = torch.func.vmap(_body, in_dims=(0, 0, None))(x, w, c)
    got = chunked_vmap(_body, (0, 0, None), chunk=chunk)(x, w, c)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_chunked_vmap_errors_match_reference():
    x, w, c = _map_inputs()
    with pytest.raises(ValueError, match="chunk must be"):
        chunked_vmap(_body, (0, 0, None), chunk=0)
    with pytest.raises(ValueError, match="at least one mapped"):
        chunked_vmap(lambda a: a, (None,), chunk=2)(c)
    with pytest.raises(ValueError, match="args for in_axes"):
        chunked_vmap(_body, (0, 0, None), chunk=2)(x, w)


def test_sharded_client_map_on_one_device_mesh():
    rng = np.random.default_rng(1)
    x, w = _t(rng.normal(size=(8, 6, 4))), _t(rng.normal(size=(8, 4, 3)))

    def f(xi, wi):
        return torch.tanh(xi @ wi).sum(-1)

    want = torch.func.vmap(f)(x, w)
    for chunk in (None, 3, 4):
        got = sharded_client_map((torch.device("cpu"),), f, (0, 0), chunk=chunk)(x, w)
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not divide"):
        sharded_client_map((torch.device("cpu"),) * 3, f, (0, 0))(x, w)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="need 1 devices"):
            client_mesh(1)


def test_working_set_proxy_is_linear_in_the_chunk():
    """The property tests/test_fleet.py:318 states (that reference test fails
    on this CPU build): the proxy of the chunked map is exactly the unchunked
    one times chunk / K, and grows with the chunk."""
    rng = np.random.default_rng(2)
    k, b, p, h = 32, 16, 12, 10
    x, w = _t(rng.normal(size=(k, b, p))), _t(rng.normal(size=(k, p, h)))

    def f(xi, wi):
        return torch.tanh(xi @ wi).sum(-1)

    full = working_set_proxy(lambda *a: torch.func.vmap(f)(*a), x, w)
    assert full == k * b * h * 4  # the (K, b, h) product, tanh's output
    prev = 0
    for chunk in (2, 4, 8):
        ws = working_set_proxy(chunked_vmap(f, (0, 0), chunk=chunk), x, w)
        assert ws == full * chunk // k and ws > prev
        prev = ws


# ---- trainers against the reference ------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_doms():
    doms = make_domains(5, 120, shift=0.5, seed=1, dim=8, n_classes=3)
    return doms[:4], doms[4]


def _plans(kind, rounds):
    ids = list(range(4))
    if kind == "full":
        rows = [(ids, ids, ids)] * rounds
    else:  # one moments participant per edge of [[0, 1], [2, 3]], full W/C
        rows = [([0, 2], ids, ids), ([1, 3], ids, ids)] * (rounds // 2)
    return (JTrace([JPlan(*r) for r in rows], cycle=True),
            TraceScenario([RoundPlan(*r) for r in rows], cycle=True))


def _pair(sources, target, plans, jkw, tkw, warmup=1, **kw):
    jsc, tsc = _plans(plans, kw.get("n_rounds", 4))
    jt = JTrainer(sources, target, JCFG, JProto(warmup_rounds=0, scenario=jsc, **jkw, **kw))
    tt = TTrainer(sources, target, TCFG, TProto(warmup_rounds=0, scenario=tsc, **tkw, **kw),
                  device="cpu")
    convert.load_reference_params(tt, jax.tree_util.tree_map(np.asarray, jt.tgt_params))
    for tr in (jt, tt):
        tr._warmup(warmup)
    return jt, tt


CASES = {
    "singleton": ("full", lambda T: dict(topology=T.singleton(4)), {}),
    "grouped": ("one_per_edge", lambda T: dict(topology=T.of_groups([[0, 1], [2, 3]])), {}),
    "chunk2": ("full", lambda T: dict(client_chunk=2), {}),
    "grouped_chunk3_full": ("full", lambda T: dict(topology=T.of_groups([[0, 1], [2, 3]]),
                                                   client_chunk=3), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fleet_trainer_matches_reference(fleet_doms, case):
    sources, target = fleet_doms
    plans, opts, extra = CASES[case]
    kw = dict(n_rounds=4, t_c=2, local_steps=2, batch_size=32, seed=0, **extra)
    jt, tt = _pair(sources, target, plans, opts(JTopology), opts(Topology), **kw)
    jt.train()
    tt.train()
    assert _trainer_err(jt, tt) < LEAF_TOL
    assert (tt.comm.bytes_by_kind, tt.comm.messages_by_kind) == (jt.comm.bytes_by_kind,
                                                                 jt.comm.messages_by_kind)
    assert tt.ingress_bytes == jt.ingress_bytes
    if jt.edge_transport is not None:
        assert tt.edge_transport.log.bytes_by_kind == jt.edge_transport.log.bytes_by_kind
        assert tt.edge_transport.log.messages_by_kind == jt.edge_transport.log.messages_by_kind


def test_two_tier_wire_edge_qint8_matches_reference(fleet_doms):
    """Tier-1 float32 over the wire, tier-2 qint8 on the edge uplinks (paths
    (4,), (5,), (6, i)), the port fed the reference's uniforms."""
    sources, target = fleet_doms
    kw = dict(n_rounds=2, t_c=2, batch_size=32, seed=0, transport="wire", edge_codec="qint8")
    jt, tt = _pair(sources, target, "full", dict(topology=JTopology.of_groups([[0, 1], [2, 3]])),
                   dict(topology=Topology.of_groups([[0, 1], [2, 3]])), **kw)
    assert tt._engine.edge_channel and not tt._engine.channel
    paths = []
    uniforms = _reference_uniforms(kw["seed"])

    def recording(chan_key, path, n_rows, shape):
        paths.append(path)
        return uniforms(chan_key, path, n_rows, shape)

    tt._engine.channel_uniforms = recording
    jt.train()
    tt.train()
    assert sorted(set(paths)) == [(4,), (5,), (6, 0), (6, 1)]
    assert _trainer_err(jt, tt) < LEAF_TOL
    assert tt.edge_transport.log.bytes_by_kind == jt.edge_transport.log.bytes_by_kind
    assert tt.ingress_bytes == jt.ingress_bytes and tt.comm.total == jt.comm.total


def test_port_singleton_equals_port_flat(fleet_doms):
    """tests/test_fleet.py:162 on the port: E = K routes every merge through
    the hierarchy and must reproduce the flat engine within 1e-6."""
    sources, target = fleet_doms
    _, tsc = _plans("full", 4)
    kw = dict(n_rounds=4, t_c=2, local_steps=2, warmup_rounds=1, batch_size=32, seed=0,
              scenario=tsc)
    flat = TTrainer(sources, target, TCFG, TProto(**kw), device="cpu")
    flat.train()
    two = TTrainer(sources, target, TCFG, TProto(topology=Topology.singleton(4), **kw),
                   device="cpu")
    two.train()
    err = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves((flat.tgt_params, flat._src_stack)), tree_leaves((two.tgt_params,
                                                                      two._src_stack))))
    assert err <= 1e-6
    assert flat.comm.total == two.comm.total


def test_ingress_and_both_logs_equal_reference():
    """K = 8 over 2 edges, wire qint8 on tier 1 and float16 on tier 2: the
    server ingress shrinks below the flat figure, and both tiers' logs equal
    the reference's."""
    doms = make_domains(9, 60, shift=0.5, seed=2, dim=8, n_classes=3)
    ids = list(range(8))
    out = {}
    for name, T, P, Tr, Plan, Trace, cfg, extra in (
            ("ref", JTopology, JProto, JTrainer, JPlan, JTrace, JCFG, {}),
            ("port", Topology, TProto, TTrainer, RoundPlan, TraceScenario, TCFG,
             {"device": "cpu"})):
        for topo in (None, T.uniform(8, 2)):
            proto = P(n_rounds=2, t_c=2, warmup_rounds=0, batch_size=16, seed=0,
                      transport="wire", codec="qint8", edge_codec="float16", topology=topo,
                      scenario=Trace([Plan(ids, ids, ids)] * 2, cycle=True))
            tr = Tr(doms[:8], doms[8], cfg, proto, **extra)
            tr.train()
            edge = tr.edge_transport
            out[name, topo is None] = (dict(tr.ingress_bytes), dict(tr.comm.bytes_by_kind),
                                       dict(tr.comm.messages_by_kind),
                                       None if edge is None else dict(edge.log.bytes_by_kind),
                                       None if edge is None else dict(edge.log.messages_by_kind))
    assert out["port", True] == out["ref", True] and out["port", False] == out["ref", False]
    flat, two = out["port", True][0], out["port", False][0]
    assert sum(two.values()) < sum(flat.values()) and two["w_rf"] < flat["w_rf"]


@pytest.mark.parametrize("kw,match", [
    (dict(engine="serial", topology="singleton4"), "batched engine"),
    (dict(topology="singleton3"), "topology covers"),
    (dict(topology="singleton4", edge_codec="seed_replay"), "seed_replay"),
])
def test_fleet_protocol_validation_matches_reference(fleet_doms, kw, match):
    sources, target = fleet_doms
    for T, P, Tr, cfg, extra in ((JTopology, JProto, JTrainer, JCFG, {}),
                                 (Topology, TProto, TTrainer, TCFG, {"device": "cpu"})):
        args = {**kw, "topology": T.singleton(int(kw["topology"][-1]))}
        with pytest.raises(ValueError, match=match):
            Tr(sources, target, cfg, P(warmup_rounds=0, **args), **extra)
