"""The paper's technique as a first-class backbone head.

Port of ``repro.models.fda_head``: pooled final hidden states -> fixed
shared-seed RFF compressor -> trainable linear aligner W_RF -> decomposable
MMD loss across clients (paper eq. 11).  Plain torch, as the reference
computes it outside any kernel.  The batch is laid out as
``(n_clients, per_client, ...)``; the only cross-client quantity is the mean
of the (n_clients, 2N) message matrix.

Under a mesh (``par``) the batch lies over the data axes and each rank
holds whole clients (``n_clients`` a multiple of the data ranks): the
federation mean is one all-reduce over the data axes of each rank's sum of
its messages (2N floats: the reference's XLA partitions its mean over the
client axis so), and each rank's share of the loss is summed over them.
The head is replicated over the model axis.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.param import ParamDecl


def fda_decl(cfg: ModelConfig) -> dict:
    n = cfg.fda_n_rff
    return {
        # fixed compressor: shared-seed Omega (no gradient in the loss);
        # std ~ 2 on unit-normalised pooled features
        "omega": ParamDecl((n, cfg.d_model), "std", torch.float32, scale=2.0,
                           spec=(None, None)),
        "w_rf": ParamDecl((2 * n, cfg.fda_m), "normal", torch.float32, spec=(None, None)),
    }


def fda_messages(params, hidden: torch.Tensor, n_clients: int) -> torch.Tensor:
    """Per-client compressed messages Sigma ell: (n_clients, 2N)."""
    b = hidden.shape[0]
    pooled = torch.mean(hidden.to(torch.float32), dim=1)  # (b, d)
    pooled = pooled / (torch.linalg.vector_norm(pooled, dim=-1, keepdim=True) + 1e-6)
    omega = params["omega"].detach()
    z = pooled @ omega.T  # (b, N)
    n = omega.shape[0]
    feats = torch.cat([torch.cos(z), torch.sin(z)], dim=-1) / math.sqrt(n)  # (b, 2N)
    return feats.reshape(n_clients, b // n_clients, 2 * n).mean(dim=1)


def fda_loss(params, hidden: torch.Tensor, n_clients: int, par=None) -> torch.Tensor:
    """Align every client's mean embedding to the federation mean (eq. 11 with
    the global mean as the target message).  With ``par``, ``hidden`` is this
    rank's batch, its ``n_clients / data ranks`` clients."""
    if par is None or not par.data:
        msgs = fda_messages(params, hidden, n_clients)
        center = torch.mean(msgs, dim=0)
        v = (msgs - center[None, :]) @ params["w_rf"]  # (nc, m)
        return torch.mean(torch.sum(v * v, dim=-1))
    if n_clients % par.d_size:
        raise ValueError(f"{n_clients} clients over {par.d_size} data ranks: each rank must "
                         f"hold whole clients")
    msgs = fda_messages(params, hidden, n_clients // par.d_size)
    center = par.data_sum(torch.sum(msgs, dim=0)) / n_clients  # the 2N-float all-reduce
    v = (msgs - center[None, :]) @ params["w_rf"]
    return par.data_sum_rep(torch.sum(torch.sum(v * v, dim=-1))) / n_clients
