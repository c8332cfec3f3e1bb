"""Sharded FedRF-TCA data plane: the paper's communication pattern as
``torch.distributed`` collectives.

Port of ``repro.federated.distributed``.  The host-side simulator
(``protocol.py``) runs the asynchronous protocol; here the synchronous
round (all clients in S_t) runs one client a process, every process
calling the same round on its own client's state:

- each client computes its 2N-float message  Sigma ell  locally;
- the message exchange is ONE ``all_reduce`` over the clients' group: an
  all-reduce of 2N floats, the O(KN) claim of Table I;
- FedAvg of W_RF is ONE all-reduce mean of the (2N, m) aligner: O(KNm).

Nothing here scales with the per-client sample count n.  The reference
maps clients onto the devices of a ``clients`` mesh axis with
``shard_map``; the port maps them onto the ranks of a process group, which
the caller starts (``torch.distributed.init_process_group`` with one rank a
client; ``"cpu:gloo,cuda:nccl"`` serves CPU and CUDA tensors alike).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.mmd import mmd_projected
from repro_torch.federated.model import ClientConfig, client_message, source_loss
from repro_torch.optim import apply_updates
from repro_torch.utils.tree import (
    stack_trees,
    tree_leaves,
    tree_map,
    tree_unflatten_like,
    unstack_tree,
)


def make_client_mesh(n_clients: int):
    """The clients' process group: the first ``n_clients`` ranks of the
    default group, as the reference takes the first n devices, raising where
    there are fewer.  Every rank calls it (a smaller group is made by
    ``new_group``, collective over the default group); a rank past the
    first n gets ``dist.GroupMember.NON_GROUP_MEMBER`` and runs no round."""
    if not dist.is_initialized():
        raise ValueError(f"need a process group of {n_clients} ranks for the sharded data "
                         "plane; start one with torch.distributed.init_process_group")
    have = dist.get_world_size()
    if have < n_clients:
        raise ValueError(f"need {n_clients} ranks for the sharded data plane, have {have}")
    if have == n_clients:
        return dist.group.WORLD
    return dist.new_group(list(range(n_clients)))


def _mean_over(t: torch.Tensor, group) -> torch.Tensor:
    """The all-reduce mean of ``t`` over ``group`` (a sum, then a division:
    gloo has no average)."""
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / dist.get_world_size(group)


def build_sharded_round(group, cfg: ClientConfig, omega: torch.Tensor, opt):
    """Returns ``one_round(params, opt_state, x, y, x_t) -> (params,
    opt_state, metrics)``, a synchronous round of this rank's client: its
    parameters and optimizer state, its batch ``x`` (p, b) and labels ``y``
    (b,), and the target batch ``x_t`` every rank holds.  ``metrics`` (l_c,
    l_mmd) are means over the clients."""

    def one_round(params, opt_state, x, y, x_t):
        n = dist.get_world_size(group)
        y = y.long()
        # target message, computed with THIS client's current extractor view
        # of the target batch (synchronous round: target params == broadcast)
        with torch.no_grad():
            msg_t = client_message(params, omega, x_t, -1.0)
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, aux = source_loss(p, omega, x, y, msg_t, cfg, with_mmd=False)
        msg_s = client_message(p, omega, x, +1.0)
        # >>> THE EXCHANGE: one all-reduce of a 2N-float message <<<  The
        # other clients' messages arrive over the wire and are constants to
        # this client: gradient flows through the local term only.
        msg_sum = msg_s.detach().clone()
        dist.all_reduce(msg_sum, op=dist.ReduceOp.SUM, group=group)
        msg_sum = msg_s + (msg_sum - msg_s).detach()
        l_mmd = mmd_projected(p["w_rf"], msg_sum / n, msg_t)
        total = loss + cfg.lambda_mmd * l_mmd
        grads = tree_unflatten_like(p, list(torch.autograd.grad(total, tree_leaves(p))))
        upd, opt_state = opt.update(grads, opt_state, params)
        params = apply_updates(params, upd)
        # >>> FedAvg of the aligner: one all-reduce mean of (2N, m) <<<
        params = {**params, "w_rf": _mean_over(params["w_rf"], group)}
        metrics = {"l_c": _mean_over(aux["l_c"], group), "l_mmd": _mean_over(l_mmd, group)}
        return params, opt_state, metrics

    return one_round


def stack_clients(param_list):
    return stack_trees(param_list)


def unstack_clients(stacked, k: int):
    return [unstack_tree(stacked, i) for i in range(k)]
