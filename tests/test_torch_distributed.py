"""Port parity: the sharded FedRF-TCA round (repro_torch.federated.distributed)
against repro's, four clients on the CPU.

The reference's round runs in a subprocess with four forced CPU devices (the
XLA device count is fixed at jax's first import), its outputs read whole
through ``np.asarray``; the same subprocess computes the host math of
tests/test_distributed.py (each client's step from the mean of the messages,
the others' messages constant) from the same start.  The port runs in four
processes, one client a rank of a gloo group, from the reference's initial
parameters and omega.  Tolerance 1e-5 on every parameter, as the
reference's test holds its round to the host math, and on the metrics.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro_torch.federated import ClientConfig  # noqa: E402
from repro_torch.federated import distributed as tdist  # noqa: E402
from repro_torch.federated.model import client_message, source_loss  # noqa: E402
from repro_torch.core.mmd import mmd_projected  # noqa: E402
from repro_torch.optim import adam, apply_updates  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K = 4
ATOL = 1e-5  # tests/test_distributed.py:71-72
TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One thread for this module's small tensors and host linear algebra
    (torch's pool; OpenBLAS and OpenMP through threadpoolctl where it is
    installed): the suite runs in parallel workers, where each one's pools
    would contend for the same cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        from threadpoolctl import threadpool_limits
    except ImportError:
        threadpool_limits = None
    if threadpool_limits is None:
        yield
    else:
        with threadpool_limits(limits=1):
            yield
    torch.set_num_threads(before)


_FLATTEN = '''
def flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k in tree:
            flatten(tree[k], f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree, np.float32)
    return out
'''

# tests/test_distributed.py's setting and host math, the outputs saved whole
REFERENCE = textwrap.dedent('''
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.federated.distributed import build_sharded_round, make_client_mesh, stack_clients
    from repro.federated.model import (
        ClientConfig, client_message, init_params, make_omega, source_loss,
    )
    from repro.core.mmd import mmd_projected
    from repro.optim import adam, apply_updates
    ''') + _FLATTEN + textwrap.dedent('''
    K = 4
    cfg = ClientConfig(input_dim=6, n_classes=3, n_rff=16, m=4, extractor_widths=(8, 4))
    omega = make_omega(cfg)
    key = jax.random.PRNGKey(0)
    params = [init_params(cfg, jax.random.fold_in(key, i)) for i in range(K)]
    opt = adam(1e-2)
    opts = [opt.init(p) for p in params]
    rng = np.random.default_rng(0)
    xs = jnp.asarray(rng.normal(size=(K, 6, 8)), jnp.float32)
    ys = jnp.asarray(rng.integers(0, 3, size=(K, 8)))
    x_t = jnp.asarray(rng.normal(size=(6, 8)), jnp.float32)

    def run(n):
        """The reference's round over the first n clients, read whole, and
        the host math of the same n clients."""
        rnd = build_sharded_round(make_client_mesh(n), cfg, omega, opt)
        sp2, so2, metrics = rnd(stack_clients(params[:n]), stack_clients(opts[:n]), xs[:n],
                                ys[:n], x_t)
        ref_params = []
        for i in range(n):
            msg_t = client_message(params[i], omega, x_t, -1.0)
            def loss_fn(p, i=i, msg_t=msg_t):
                l, aux = source_loss(p, omega, xs[i], ys[i], msg_t, cfg, with_mmd=False)
                m_s = client_message(p, omega, xs[i], +1.0)
                others = [client_message(params[j], omega, xs[j], +1.0)
                          for j in range(n) if j != i]
                return l + cfg.lambda_mmd * mmd_projected(p["w_rf"], (m_s + sum(others)) / n,
                                                          msg_t)
            u, _ = opt.update(jax.grad(loss_fn)(params[i]), opts[i], params[i])
            ref_params.append(apply_updates(params[i], u))
        return sp2, metrics, ref_params, sum(p["w_rf"] for p in ref_params) / n

    out = {"omega": np.asarray(omega), "xs": np.asarray(xs), "ys": np.asarray(ys),
           "x_t": np.asarray(x_t)}
    for i in range(K):
        flatten(params[i], f"init/{i}", out)
    # all K clients under the bare prefixes; the first two of the K devices under k2/
    for n, pre in ((K, ""), (2, "k2/")):
        sp2, metrics, ref_params, ref_wrf = run(n)
        out[f"{pre}host/w_rf"] = np.asarray(ref_wrf)
        out[f"{pre}sharded/l_c"] = np.asarray(metrics["l_c"])
        out[f"{pre}sharded/l_mmd"] = np.asarray(metrics["l_mmd"])
        for i in range(n):
            flatten(ref_params[i], f"{pre}host/{i}", out)
        flatten(sp2, f"{pre}sharded", out)  # every leaf (n, ...) read whole
    np.savez(sys.argv[1], **out)
    ''')

# one rank of the port's round over the first n of four gloo ranks on a file
# store: the reference's client ``rank``, or no round past the first n
PORT = textwrap.dedent('''
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch import convert
    from repro_torch.federated import ClientConfig
    from repro_torch.federated import distributed as tdist
    from repro_torch.optim import adam
    ''') + _FLATTEN + textwrap.dedent('''
    src, store, out_path = sys.argv[1], sys.argv[2], sys.argv[3]
    rank, n = int(sys.argv[4]), int(sys.argv[5])
    ref = np.load(src)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
    try:
        group = tdist.make_client_mesh(n)
        if rank >= n:
            assert group is dist.GroupMember.NON_GROUP_MEMBER, group
            sys.exit(0)
        cfg = ClientConfig(input_dim=6, n_classes=3, n_rff=16, m=4, extractor_widths=(8, 4))
        tree = {"extractor": [{"w": ref[f"init/{rank}/extractor/{j}/w"],
                               "b": ref[f"init/{rank}/extractor/{j}/b"]} for j in range(2)],
                "w_rf": ref[f"init/{rank}/w_rf"],
                "classifier": {"w": ref[f"init/{rank}/classifier/w"],
                               "b": ref[f"init/{rank}/classifier/b"]}}
        params = convert.params_from_reference(tree, device="cpu")
        opt = adam(1e-2)
        rnd = tdist.build_sharded_round(group, cfg, torch.tensor(ref["omega"]), opt)
        params, _, metrics = rnd(params, opt.init(params), torch.tensor(ref["xs"][rank]),
                                 torch.tensor(ref["ys"][rank]), torch.tensor(ref["x_t"]))
        out = flatten(metrics, "metrics", {})
        np.savez(out_path, **flatten(params, "params", out))
    finally:
        dist.destroy_process_group()
    ''')


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def reference_round(tmp_path_factory):
    path = tmp_path_factory.mktemp("ref") / "round.npz"
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(path)], capture_output=True,
                         text=True, env=_env(), timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    return dict(np.load(path))


def _leaf_keys(ref, prefix):
    return sorted(k[len(prefix):] for k in ref if k.startswith(prefix))


def test_reference_round_matches_host_math(reference_round):
    """The oracle itself: the reference's sharded round (read whole) agrees
    with the host math, as tests/test_distributed.py asks (that test fails
    on this jax at ``unstack_clients``' indexing of a sharded array)."""
    ref = reference_round
    for i in range(K):
        np.testing.assert_allclose(ref["sharded/w_rf"][i], ref["host/w_rf"], atol=ATOL)
        for leaf in _leaf_keys(ref, f"host/{i}/"):
            if leaf != "w_rf":
                np.testing.assert_allclose(ref[f"sharded/{leaf}"][i], ref[f"host/{i}/{leaf}"],
                                           atol=ATOL, err_msg=leaf)
    assert float(ref["sharded/l_mmd"]) >= 0.0


def _run_port(reference_round, tmp_path, n):
    """The port's round over the first n of four gloo ranks; the outputs of
    ranks 0 .. n-1."""
    src = tmp_path / "ref.npz"
    np.savez(src, **reference_round)
    store = tmp_path / "store"
    procs = [subprocess.Popen([sys.executable, "-c", PORT, str(src), str(store),
                               str(tmp_path / f"rank{r}.npz"), str(r), str(n)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env()) for r in range(K)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=TIMEOUT_S)
            errs.append(err)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(e[-2000:] for e in errs)
    assert not any((tmp_path / f"rank{r}.npz").exists() for r in range(n, K))
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(n)]


def _check_port(ref, outs, pre):
    for r, out in enumerate(outs):
        for leaf in _leaf_keys(ref, f"{pre}host/{r}/"):
            got = out[f"params/{leaf}"]
            np.testing.assert_allclose(got, ref[f"{pre}sharded/{leaf}"][r], atol=ATOL,
                                       err_msg=leaf)
            exp = ref[f"{pre}host/w_rf"] if leaf == "w_rf" else ref[f"{pre}host/{r}/{leaf}"]
            np.testing.assert_allclose(got, exp, atol=ATOL, err_msg=leaf)
        for m in ("l_c", "l_mmd"):
            np.testing.assert_allclose(out[f"metrics/{m}"], ref[f"{pre}sharded/{m}"], atol=ATOL)
    # FedAvg leaves every rank the same aligner, bit for bit
    for out in outs[1:]:
        np.testing.assert_array_equal(out["params/w_rf"], outs[0]["params/w_rf"])


def test_sharded_round_matches_reference_on_four_gloo_ranks(reference_round, tmp_path):
    _check_port(reference_round, _run_port(reference_round, tmp_path, K), "")


def test_two_clients_on_the_first_two_of_four_gloo_ranks(reference_round, tmp_path):
    """As the reference takes the first n devices: two clients on a job of
    four ranks run on ranks 0 and 1; ranks 2 and 3 get no group and no
    round."""
    ref = reference_round
    for i in range(2):  # the reference's own round over the first two devices
        np.testing.assert_allclose(ref["k2/sharded/w_rf"][i], ref["k2/host/w_rf"], atol=ATOL)
    _check_port(ref, _run_port(ref, tmp_path, 2), "k2/")


def _host_step(params, omega, x, y, x_t, cfg, opt):
    """One client alone (K = 1): CE + lambda MMD against its own message."""
    p = tree_map(lambda t: t.detach().requires_grad_(True), params)
    msg_t = client_message(params, omega, x_t, -1.0).detach()
    loss, _ = source_loss(p, omega, x, y.long(), msg_t, cfg, with_mmd=False)
    total = loss + cfg.lambda_mmd * mmd_projected(p["w_rf"], client_message(p, omega, x, 1.0),
                                                  msg_t)
    grads = tree_unflatten_like(p, list(torch.autograd.grad(total, tree_leaves(p))))
    upd, _ = opt.update(grads, opt.init(params), params)
    return apply_updates(params, upd)


def test_client_mesh_and_a_one_rank_round(tmp_path):
    """``make_client_mesh`` raises without a group and where the group's size
    is not the client count; at one rank the round is the client's own step."""
    from repro_torch.federated import init_params, make_omega

    if dist.is_initialized():
        pytest.skip("a process group is already running in this process")
    with pytest.raises(ValueError, match="process group"):
        tdist.make_client_mesh(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="need 2 ranks"):
            tdist.make_client_mesh(2)
        cfg = ClientConfig(input_dim=6, n_classes=3, n_rff=16, m=4, extractor_widths=(8, 4))
        omega = make_omega(cfg, device="cpu")
        params = init_params(cfg, 0, device="cpu")
        rng = np.random.default_rng(1)
        x = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32))
        y = torch.tensor(rng.integers(0, 3, size=8))
        x_t = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32))
        opt = adam(1e-2)
        rnd = tdist.build_sharded_round(tdist.make_client_mesh(1), cfg, omega, opt)
        got, state, metrics = rnd(params, opt.init(params), x, y, x_t)
        exp = _host_step(params, omega, x, y, x_t, cfg, opt)
        for a, b in zip(tree_leaves(got), tree_leaves(exp)):
            np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=1e-6)
        assert int(state.step) == 1 and set(metrics) == {"l_c", "l_mmd"}
        assert float(metrics["l_mmd"]) >= 0.0
    finally:
        dist.destroy_process_group()


def test_stack_and_unstack_clients():
    trees = [{"w": torch.full((2, 3), float(i)), "b": [torch.tensor(i)]} for i in range(3)]
    stacked = tdist.stack_clients(trees)
    assert tuple(stacked["w"].shape) == (3, 2, 3) and tuple(stacked["b"][0].shape) == (3,)
    back = tdist.unstack_clients(stacked, 3)
    assert all(torch.equal(a["w"], b["w"]) and torch.equal(a["b"][0], b["b"][0])
               for a, b in zip(back, trees))

