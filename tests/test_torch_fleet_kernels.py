"""Port parity for the fleet's two kernels' host sides, on the CPU: K9's
membership plan and its sums-with-masses path, and K10's in-kernel scale
rule and its round trip without uniforms, against the reference.

The plan equals a stable argsort of the reference ``Topology``'s segment ids
(exactly); the sums and masses equal, bit for bit, the contraction of the
payload with a ones column that the port's hierarchy ran before its kernel
wrote the masses itself, and the reference's ``fleet.hierarchy._sums_and_mass``
within 1e-5 (tests/test_fleet.py:95; torch's and XLA's CPU products sum in
different orders, ~1e-6 apart) with equal non-finite positions, non-finite
values and weights included; the scale equals the reference's ``jnp.where(absmax > 0,
absmax / qmax, 1)`` bit for bit on NaN, Inf, zero and -0.0 rows, and the
round trip equals the reference codec's with u = 0.5 bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.comm import codecs as jcodecs  # noqa: E402
from repro.fleet import Topology as JTopology  # noqa: E402
from repro.fleet import hierarchy as jhier  # noqa: E402
from repro_torch.comm import codecs as tcodecs  # noqa: E402
from repro_torch.fleet import hierarchy as thier  # noqa: E402
from repro_torch.kernels import quantize  # noqa: E402
from repro_torch.kernels import segment_reduce as tseg  # noqa: E402


def _topology(kind: str) -> JTopology:
    if kind == "fl":  # FL's fleet (the reference's sums at this size take ~3 s)
        return JTopology.uniform(1024, 64)
    if kind == "uniform":
        return JTopology.uniform(64, 8)
    if kind == "uneven":
        return JTopology.uniform(130, 7)
    if kind == "singleton":
        return JTopology.singleton(9)
    if kind == "star":
        return JTopology.star(5)
    rng = np.random.default_rng(11)  # every edge non-empty, members interleaved
    asg = np.concatenate([np.arange(6), rng.integers(0, 6, size=34)])
    return JTopology(tuple(int(e) for e in rng.permutation(asg)))


@pytest.mark.parametrize("kind", ["fl", "uniform", "uneven", "singleton", "star", "random"])
def test_membership_plan_is_a_stable_argsort(kind):
    topo = _topology(kind)
    seg = topo.segment_ids
    order = np.argsort(seg, kind="stable")
    counts = np.array([len(topo.members(e)) for e in range(topo.n_edges)])
    offsets = np.concatenate([[0], np.cumsum(counts)])
    for plan in (tseg.membership_plan(seg, topo.n_edges),
                 tseg._device_plan(torch.from_numpy(seg), topo.n_edges)):
        assert plan.order.dtype == torch.int32 and plan.offsets.dtype == torch.int32
        np.testing.assert_array_equal(plan.seg_ids.numpy(), seg)
        np.testing.assert_array_equal(plan.order.numpy(), order)
        np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
        for e in range(topo.n_edges):  # each edge's members in ascending k
            assert plan.order[plan.offsets[e]:plan.offsets[e + 1]].tolist() == topo.members(e)


def test_membership_plan_places_ids_outside_the_edges_at_the_ends():
    seg = np.array([2, -1, 0, 5, 1, 0, 3], np.int32)  # E = 3: -1 below, 5 and 3 past
    plan = tseg.membership_plan(seg, 3)
    assert plan.order.tolist() == [1, 2, 5, 4, 0, 6, 3]
    assert plan.offsets.tolist() == [1, 3, 4, 5]


def _merge_inputs(kind: str):
    topo = _topology(kind)
    k = topo.n_clients
    rng = np.random.default_rng(k)
    vals = rng.normal(size=(k, 12)).astype(np.float32)
    w = (rng.random(size=(k,)) < 0.8).astype(np.float32) * rng.random(size=(k,)).astype(
        np.float32)
    if kind == "random":  # non-finite values in two edges, a weight of 0 against -Inf
        vals[3, 5], vals[17, 5], vals[9, 2], vals[30, 11] = np.nan, np.inf, -np.inf, np.nan
        w[9] = 0.0
    if kind == "uneven":  # a non-finite weight: every other edge's row and mass NaN
        w[40] = np.inf
    return topo, vals, w


def _same(a: np.ndarray, b: np.ndarray) -> None:
    """Equal bit for bit where finite, with equal NaN and +-Inf positions."""
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(a), test(b))
    np.testing.assert_array_equal(np.nan_to_num(a, nan=7.0), np.nan_to_num(b, nan=7.0))


def _close(a: np.ndarray, b: np.ndarray) -> None:
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(a), test(b))
    ok = np.isfinite(b)
    assert not ok.any() or np.abs(a[ok] - b[ok]).max() < 1e-5


@pytest.mark.parametrize("kind", ["uniform", "uneven", "singleton", "star", "random"])
def test_sums_and_mass_plain_matches_reference(kind):
    topo, vals, w = _merge_inputs(kind)
    seg = topo.segment_ids
    js, jm = jhier._sums_and_mass(jnp.asarray(vals), jnp.asarray(w), jnp.asarray(seg),
                                  topo.n_edges)
    plan = tseg.membership_plan(seg, topo.n_edges)
    launches = tseg.LAUNCHES["segment_reduce"]
    ts, tm = thier._sums_and_mass(torch.from_numpy(vals), torch.from_numpy(w), plan,
                                  topo.n_edges)
    by_ids = thier._sums_and_mass(torch.from_numpy(vals), torch.from_numpy(w),
                                  torch.from_numpy(seg), topo.n_edges)
    assert tseg.LAUNCHES["segment_reduce"] == launches  # CPU tensors: the plain version
    _same(by_ids[0].numpy(), ts.numpy())
    _same(by_ids[1].numpy(), tm.numpy())
    assert ts.shape == (topo.n_edges, vals.shape[1]) and tm.shape == (topo.n_edges,)
    _close(ts.numpy(), np.asarray(js))
    _close(tm.numpy(), np.asarray(jm))
    # the ones-column contraction, as the hierarchy ran it before: bit for bit
    aug = np.concatenate([vals, np.ones((vals.shape[0], 1), np.float32)], axis=1)
    ones = tseg.segment_reduce_plain(torch.from_numpy(aug), torch.from_numpy(seg),
                                     torch.from_numpy(w), topo.n_edges).numpy()
    _same(ts.numpy(), ones[:, :-1])
    _same(tm.numpy(), ones[:, -1])
    if kind == "uneven":
        edge = int(seg[40])
        assert np.isnan(np.delete(tm.numpy(), edge)).all() and np.isinf(tm.numpy()[edge])
        assert np.isnan(np.delete(ts.numpy(), edge, axis=0)).all()
    if kind == "random":
        assert np.isnan(ts.numpy()[:, 5]).all() and np.isfinite(tm.numpy()).all()


def _scale_rows(d: int) -> np.ndarray:
    rng = np.random.default_rng(d)
    x = rng.normal(size=(9, d)).astype(np.float32) * 3.0
    x[1, d // 2] = np.nan
    x[2, 0] = np.inf
    x[3, -1] = -np.inf
    x[4] = 0.0
    x[5] = -0.0
    x[6, :] = np.nan
    x[7, 1 % d] = np.inf
    x[7, 0] = np.nan
    x[8] = np.float32(1e-30)  # a subnormal scale
    return x


@pytest.mark.parametrize("d", [5, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_quant_scale_edge_rows_match_reference(d, bits):
    x = _scale_rows(d)
    qmax = quantize.qmax_of(bits)
    want = np.array([np.asarray(jnp.where(jnp.max(jnp.abs(r)) > 0, jnp.max(jnp.abs(r)) / qmax,
                                          1.0)) for r in jnp.asarray(x)], np.float32)
    host = np.array([jcodecs.quant_scale(np.max(np.abs(r)), qmax) for r in x], np.float32)
    got = quantize.quant_scale(torch.from_numpy(x), qmax).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)
    assert got[1] == 1.0 and got[4] == 1.0 and got[5] == 1.0 and got[6] == 1.0
    assert np.isinf(got[2]) and np.isinf(got[3]) and got[7] == 1.0


@pytest.mark.parametrize("d", [5, 1024])
@pytest.mark.parametrize("bits", [8, 4])
def test_round_trip_without_uniforms_matches_reference_codec(d, bits):
    """u = None in the port (the kernel's constant 0.5) against the
    reference codec's keyless round trip (u = 0.5), row by row."""
    x = _scale_rows(d)
    want = np.asarray(jax.vmap(jcodecs.QuantCodec(bits).roundtrip)(jnp.asarray(x)))
    launches = quantize.LAUNCHES["fake_quant"]
    got = tcodecs.QuantCodec(bits).roundtrip(torch.from_numpy(x)).numpy()
    rows = quantize.fake_quant_rows(torch.from_numpy(x), None, bits=bits).numpy()
    assert quantize.LAUNCHES["fake_quant"] == launches
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(rows, want)
    half = torch.full((9, d), 0.5)
    plain = quantize.fake_quant_plain(torch.from_numpy(x), half,
                                      quantize.quant_scale(torch.from_numpy(x),
                                                           quantize.qmax_of(bits)),
                                      qmax=quantize.qmax_of(bits)).numpy()
    np.testing.assert_array_equal(plain, want)


def test_fused_entry_point_refuses_what_the_kernel_does_not_take():
    x = torch.ones((2, 4))
    with pytest.raises(ValueError, match="fake_quant_rows"):
        quantize.fake_quant_fused(x.to("meta"), None, qmax=7)
    plan = tseg.membership_plan(np.array([0, 1], np.int32), 2)
    with pytest.raises(ValueError, match="segment_reduce: a plan of"):
        tseg.segment_reduce(x, plan, torch.ones(2), 1, with_mass=True)  # a plan of 2 edges
    stale = plan._replace(order=plan.order[:1])
    with pytest.raises(ValueError, match="segment_reduce: a plan of"):
        tseg.segment_reduce(x, stale, torch.ones(2), 2, with_mass=True)
