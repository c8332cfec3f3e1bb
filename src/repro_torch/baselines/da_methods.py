"""Every DA baseline the paper compares against that is reproducible offline:

- source-only (no adaptation)
- vanilla TCA / R-TCA / RF-TCA pipelines (transductive, kernel on raw features)
- JDA-lite (joint marginal+conditional MMD with pseudo-label iterations)
- CORAL (second-order statistics alignment)
- DaNN (1-hidden-layer net with an MMD penalty on the hidden layer)
- plain FedAvg (federated, no adaptation — the paper's Table VIII/IX ablation)

Port of ``repro.baselines.da_methods``.  All take columns-as-samples domains
and return target accuracy with a shared classifier family.  The reference's
``jnp`` steps (kernels, TCA solves, classifiers, RF-TCA) run in torch on the
device; its numpy steps (CORAL's covariances and matrix roots, JDA's MMD
matrices, Cholesky and eigh in float64) stay numpy on the host, in the
reference's dtypes.  ``device=None`` is the CUDA card.  Each trainer's
initial weights come from a CPU ``torch.Generator`` (``*_init``) and its loop
is a function of its own (``*_train``), so a test can start the loop from
the reference's weights.  The aligned features of TCA, R-TCA and RF-TCA
are eigenvector projections whose signs the solver picks freely (the card's
and the CPU's pick differently, as the reference's and the port's do); here
each feature's sign is fixed so its largest-magnitude entry is positive,
so both devices score the same features.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.baselines.classifiers import (
    adam_train,
    fit_mlp,
    knn_1,
    score,
    softmax_ce,
)
from repro_torch.core.kernels_math import centering_matrix, ell_vector, gaussian_kernel
from repro_torch.core.rf_tca import rf_tca
from repro_torch.core.tca import r_tca, vanilla_tca
from repro_torch.data.domains import Domain, batches, normalize_unit
from repro_torch.device import as_f32, resolve_device
from repro_torch.federated.aggregation import fedavg_models
from repro_torch.federated.model import (
    ClientConfig,
    accuracy,
    init_params,
    make_omega,
    source_loss,
)
from repro_torch.optim import adam, apply_updates
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten_like


def _concat(sources: list[Domain]) -> Domain:
    return Domain(
        "+".join(d.name for d in sources),
        np.concatenate([d.x for d in sources], axis=1),
        np.concatenate([d.y for d in sources]),
    )


def _unit(d: Domain) -> Domain:
    """Unit-norm columns — the paper's preprocessing for all kernel methods."""
    return Domain(d.name, normalize_unit(d.x), d.y)


def source_only(sources: list[Domain], target: Domain, *, classifier="mlp", seed=0,
                device=None) -> float:
    src = _concat(sources)
    if classifier == "knn":
        pred = knn_1(src.x.T, src.y, device=device)
    else:
        pred = fit_mlp(src.x.T, src.y, int(src.y.max()) + 1, seed=seed, device=device)
    return score(pred, target.x.T, target.y)


def standardize(feats_s: np.ndarray, feats_t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Standardise both sides jointly: eigenvector-based features are
    O(1/sqrt(n)) scaled."""
    both = np.concatenate([feats_s, feats_t])
    mu = np.mean(both, axis=0, keepdims=True)
    sd = np.std(both, axis=0, keepdims=True) + 1e-8
    return (feats_s - mu) / sd, (feats_t - mu) / sd


def canonical_signs(feats: np.ndarray) -> np.ndarray:
    """(m, n) features with each row's sign set so that its entry of largest
    magnitude is positive (eigenvectors are defined up to sign)."""
    peak = feats[np.arange(feats.shape[0]), np.argmax(np.abs(feats), axis=1)]
    return feats * np.where(peak < 0, -1.0, 1.0).astype(feats.dtype)[:, None]


def _transductive_eval(feats_s, y_s, feats_t, y_t, classifier="mlp", seed=0,
                       device=None) -> float:
    n_classes = int(max(y_s.max(), y_t.max())) + 1
    feats_s, feats_t = standardize(feats_s, feats_t)
    if classifier == "knn":
        pred = knn_1(feats_s, y_s, device=device)
    else:
        pred = fit_mlp(feats_s, y_s, n_classes, seed=seed, device=device)
    return score(pred, feats_t, y_t)


def tca_features(sources: list[Domain], target: Domain, *, m: int = 32, gamma: float = 1e-2,
                 sigma: float = 1.0, variant: str = "vanilla",
                 device=None) -> tuple[np.ndarray, Domain, Domain]:
    """The (m, n_S + n_T) aligned features of vanilla TCA / R-TCA on the
    pooled kernel (signs canonical), with the unit-normed source and target."""
    dev = resolve_device(device)
    src = _unit(_concat(sources))
    target = _unit(target)
    x = as_f32(np.concatenate([src.x, target.x], axis=1), dev)
    ell = ell_vector(src.x.shape[1], target.x.shape[1], device=dev)
    k = gaussian_kernel(x, sigma)
    solver = vanilla_tca if variant == "vanilla" else r_tca
    return canonical_signs(solver(k, ell, gamma, m).features.cpu().numpy()), src, target


def tca_baseline(
    sources: list[Domain],
    target: Domain,
    *,
    m: int = 32,
    gamma: float = 1e-2,
    sigma: float = 1.0,
    variant: str = "vanilla",
    classifier: str = "mlp",
    seed: int = 0,
    device=None,
) -> float:
    """Vanilla TCA / R-TCA on the pooled kernel (transductive)."""
    feats, src, target = tca_features(sources, target, m=m, gamma=gamma, sigma=sigma,
                                      variant=variant, device=device)
    n_s = src.x.shape[1]
    return _transductive_eval(
        feats[:, :n_s].T, src.y, feats[:, n_s:].T, target.y, classifier, seed, device
    )


def rf_tca_baseline(
    sources: list[Domain],
    target: Domain,
    *,
    n_features: int = 512,
    m: int = 32,
    gamma: float = 1e-2,
    sigma: float = 1.0,
    classifier: str = "mlp",
    seed: int = 0,
    device=None,
    **rf_tca_kw,
) -> float:
    """RF-TCA (Algorithm 1) pipeline — the paper's single-machine method.

    Extra keyword args pass through to :func:`rf_tca` — e.g.
    ``w_rf="fused:<seed>"`` / ``ensemble=S`` for the seed-fused statistics
    pass, or ``solver`` / ``mode`` overrides.  With ``w_rf=None`` Omega is
    the port's ``draw_omega(seed)``, not the reference's ``jax.random`` one."""
    src = _unit(_concat(sources))
    target = _unit(target)
    f_s, f_t, _ = rf_tca(src.x, target.x, n_features=n_features, m=m, gamma=gamma,
                         sigma=sigma, seed=seed, device=device, **rf_tca_kw)
    n_s = f_s.shape[1]
    feats = canonical_signs(torch.cat([f_s, f_t], dim=1).cpu().numpy())
    return _transductive_eval(
        feats[:, :n_s].T, src.y, feats[:, n_s:].T, target.y, classifier, seed, device
    )


def coral_features(sources: list[Domain], target: Domain) -> tuple[np.ndarray, Domain]:
    """CORAL's recoloured source rows (float64, numpy) and the source."""
    src = _concat(sources)
    xs, xt = src.x.T, target.x.T  # rows-as-samples
    cs = np.cov(xs, rowvar=False) + np.eye(xs.shape[1])
    ct = np.cov(xt, rowvar=False) + np.eye(xt.shape[1])

    def inv_sqrt(c):
        w, v = np.linalg.eigh(c)
        return v @ np.diag(w ** -0.5) @ v.T

    def sqrt(c):
        w, v = np.linalg.eigh(c)
        return v @ np.diag(w ** 0.5) @ v.T

    return xs @ inv_sqrt(cs) @ sqrt(ct), src


def coral_baseline(sources: list[Domain], target: Domain, *, classifier="mlp", seed=0,
                   device=None) -> float:
    """CORAL: recolor source features to the target second-order statistics."""
    xs_al, src = coral_features(sources, target)
    return _transductive_eval(xs_al, src.y, target.x.T, target.y, classifier, seed, device)


def jda_baseline(
    sources: list[Domain],
    target: Domain,
    *,
    m: int = 32,
    gamma: float = 1e-2,
    sigma: float = 1.0,
    iters: int = 3,
    seed: int = 0,
    device=None,
) -> float:
    """JDA-lite: marginal + class-conditional MMD, pseudo-label refinement.

    Solves  K H K w = lam (gamma I + K M K) w  with
    M = M_0 + sum_c M_c (Long et al. 2013), via Cholesky whitening.  The
    kernel is computed on the device in fp32; the rest is the reference's
    numpy on the host (K H K in float32, the whitened solve in float64).
    """
    dev = resolve_device(device)
    src = _unit(_concat(sources))
    target = _unit(target)
    n_s, n_t = src.x.shape[1], target.x.shape[1]
    n = n_s + n_t
    n_classes = int(src.y.max()) + 1
    x = as_f32(np.concatenate([src.x, target.x], axis=1), dev)
    k = gaussian_kernel(x, sigma).cpu().numpy()
    h = centering_matrix(n).numpy()
    khk = k @ h @ k
    ell = ell_vector(n_s, n_t).numpy()
    y_t_pseudo = None
    acc = 0.0
    for _ in range(iters):
        m0 = np.zeros((n, n))
        m0 += np.outer(ell, ell)
        if y_t_pseudo is not None:
            for c in range(n_classes):
                e = np.zeros(n)
                s_idx = np.where(src.y == c)[0]
                t_idx = n_s + np.where(y_t_pseudo == c)[0]
                if len(s_idx) == 0 or len(t_idx) == 0:
                    continue
                e[s_idx] = 1.0 / len(s_idx)
                e[t_idx] = -1.0 / len(t_idx)
                m0 += np.outer(e, e)
        b = gamma * np.eye(n) + k @ m0 @ k
        chol = np.linalg.cholesky(b + 1e-8 * np.eye(n))
        c_mat = np.linalg.solve(chol, np.linalg.solve(chol, khk).T).T
        c_mat = 0.5 * (c_mat + c_mat.T)
        _, v = np.linalg.eigh(c_mat)
        vecs = np.linalg.solve(chol.T, v[:, ::-1][:, :m])
        feats = vecs.T @ k  # (m, n)
        pred = knn_1(feats[:, :n_s].T, src.y, device=dev)
        y_t_pseudo = pred(feats[:, n_s:].T)
        acc = float(np.mean(y_t_pseudo == target.y))
    return acc


def dann_init(in_dim: int, hidden: int, n_classes: int, seed: int, *, device=None) -> dict:
    """DaNN's initial weights: He-normal w1, w2 / sqrt(hidden), zero biases."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    w1 = torch.randn((in_dim, hidden), generator=gen) * math.sqrt(2.0 / in_dim)
    w2 = torch.randn((hidden, n_classes), generator=gen) / math.sqrt(hidden)
    return {"w1": w1.to(dev), "b1": torch.zeros((hidden,), device=dev),
            "w2": w2.to(dev), "b2": torch.zeros((n_classes,), device=dev)}


def dann_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x @ p["w1"] + p["b1"])


def dann_train(params: dict, xs: torch.Tensor, ys: torch.Tensor, xt: torch.Tensor,
               n_classes: int, *, lam: float = 1.0, steps: int = 400,
               lr: float = 5e-3) -> dict:
    """DaNN's loop: CE on the source plus ``lam`` times the linear-kernel MMD
    between the source's and the target's mean hidden layer."""

    def loss(p):
        hs, ht = dann_hidden(p, xs), dann_hidden(p, xt)
        gap = torch.mean(hs, dim=0) - torch.mean(ht, dim=0)
        return softmax_ce(hs @ p["w2"] + p["b2"], ys, n_classes) + lam * (gap @ gap)

    return adam_train(params, loss, steps=steps, lr=lr)


def dann_mmd_baseline(
    sources: list[Domain],
    target: Domain,
    *,
    hidden: int = 64,
    lam: float = 1.0,
    steps: int = 400,
    lr: float = 5e-3,
    seed: int = 0,
    device=None,
) -> float:
    """DaNN (Ghifary et al. 2014): 1-hidden-layer net + MMD penalty on hidden."""
    dev = resolve_device(device)
    src = _concat(sources)
    n_classes = int(src.y.max()) + 1
    xs = as_f32(src.x.T, dev)
    ys = torch.as_tensor(src.y, dtype=torch.int64, device=dev)
    xt = as_f32(target.x.T, dev)
    params = dann_init(xs.shape[1], hidden, n_classes, seed, device=dev)
    params = dann_train(params, xs, ys, xt, n_classes, lam=lam, steps=steps, lr=lr)
    with torch.no_grad():
        logits_t = dann_hidden(params, xt) @ params["w2"] + params["b2"]
    return float(np.mean(torch.argmax(logits_t, -1).cpu().numpy() == target.y))


def fedavg_train(params: list, sources: list[Domain], omega: torch.Tensor, cfg: ClientConfig,
                 *, rounds: int = 200, local_steps: int = 1, batch_size: int = 64,
                 lr: float = 1e-2, seed: int = 0) -> list:
    """FedAvg's rounds from the clients' initial parameters (one tree each):
    local source-CE steps on each client's batches, then every client takes
    the plain average."""
    dev = omega.device
    opt = adam(lr)
    opts = [opt.init(p) for p in params]
    iters = [batches(d.x, d.y, batch_size, seed=seed + i) for i, d in enumerate(sources)]
    zero = torch.zeros((2 * cfg.n_rff,), device=dev)
    for _ in range(rounds):
        for i in range(len(sources)):
            for _ in range(local_steps):
                x, y = next(iters[i])
                x = as_f32(x, dev)
                y = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=dev)
                live = tree_map(lambda t: t.detach().requires_grad_(), params[i])
                loss, _ = source_loss(live, omega, x, y, zero, cfg, with_mmd=False)
                grads = torch.autograd.grad(loss, tree_leaves(live))
                with torch.no_grad():
                    u, opts[i] = opt.update(tree_unflatten_like(live, list(grads)), opts[i],
                                            params[i])
                    params[i] = apply_updates(params[i], u)
        avg = fedavg_models(params)
        params = [avg for _ in sources]
    return params


def fedavg_baseline(
    sources: list[Domain],
    target: Domain,
    cfg: ClientConfig,
    *,
    rounds: int = 200,
    local_steps: int = 1,
    batch_size: int = 64,
    lr: float = 1e-2,
    seed: int = 0,
    device=None,
) -> float:
    """Plain FedAvg: identical client model, no message exchange, no MMD —
    the paper's 'ResNet updated using FedAvg' ablation row (Tables VIII/IX).
    Client i starts from ``init_params(cfg, seed + i)``."""
    dev = resolve_device(device)
    omega = make_omega(cfg, device=dev)
    params = [init_params(cfg, seed + i, device=dev) for i in range(len(sources))]
    params = fedavg_train(params, sources, omega, cfg, rounds=rounds, local_steps=local_steps,
                          batch_size=batch_size, lr=lr, seed=seed)
    with torch.no_grad():
        return float(accuracy(params[0], omega, as_f32(target.x, dev),
                              torch.as_tensor(target.y, device=dev)))
