"""The LM's collectives over a (data, model) mesh, with JAX's transposes.

The reference writes its model on global arrays and lets XLA's SPMD
partitioner place the collectives its ``PartitionSpec``s imply.  The port
runs one process a rank on this rank's shards, so the collectives are
written out, each an autograd ``Function`` whose backward is the transpose
``jax.grad`` takes of the partitioned program:

====================  ==========================  ===========================
operation             forward                     backward
====================  ==========================  ===========================
``copy``              identity                    all-reduce (sum)
``reduce``            all-reduce (sum)            identity (``psum`` into a
                                                  replicated output)
``all_reduce``        all-reduce (sum)            all-reduce (sum)
``gather``            all-gather                  reduce-scatter
``gather_rep``        all-gather                  this rank's slice
``scatter``           reduce-scatter              all-gather
``split``             this rank's slice           all-gather
====================  ==========================  ===========================

A value the ranks of a model group all hold (replicated) carries the whole
gradient on every rank.  A replicated value that feeds a model-sharded
product enters it through ``copy``: each rank's product gives part of the
gradient, and the backward sums the parts.  A sharded product's partial
sums leave through ``reduce`` (or ``scatter`` onto sequence shards under
``seq_parallel``).  ``gather`` and ``scatter`` are Megatron's sequence
parallelism: the block's input is gathered from the sequence shards into
products that are all sharded, and its partial output is reduce-scattered
back onto them.  Over the data axes every rank holds its own batch:
``data_mean`` (``pmean``) makes a rank's scalar the global one with the
identity backward, so each rank's gradient is its own batch's part and the
train step sums the parts (``launch.train``).

:class:`Par` holds a rank's view of the mesh: the model axis's group, size
and index, the data axes', and the two layout switches (the residual's
sequence over model, the batch over data).  With no mesh, or axes of size
1, every operation is the identity and issues no collective.

gloo runs ``all_reduce`` and ``broadcast`` on CUDA tensors and no other
collective: where a group's backend is gloo alone, an all-gather or
reduce-scatter of a CUDA tensor goes through host memory, and ``STAGED``
counts those calls.  The decision reads the group's backend; under NCCL
(or ``cpu:gloo,cuda:nccl``) nothing is staged.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

SUM, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MAX
# collective kind -> calls whose operand went through host memory
STAGED = {"all_gather": 0, "reduce_scatter": 0}
_GLOO_CUDA = ("all_reduce", "broadcast")  # gloo's collectives on CUDA tensors
_all_gather_flat = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_flat = (getattr(dist, "reduce_scatter_single", None)
                        or dist.reduce_scatter_tensor)


def _staged(kind: str, x: torch.Tensor, group) -> bool:
    return (x.is_cuda and kind not in _GLOO_CUDA
            and str(dist.get_backend(group)).lower() == "gloo")


def all_reduce(x: torch.Tensor, group, op=SUM) -> torch.Tensor:
    """The all-reduce of ``x`` over ``group`` as a new tensor."""
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=group)
    return y


def all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``x`` concatenated along ``dim``, in rank order."""
    dim %= x.dim()
    x = x.contiguous()
    flat = x.reshape(-1)
    if _staged("all_gather", x, group):
        STAGED["all_gather"] += 1
        out = torch.empty((n * flat.numel(),), dtype=x.dtype)
        _all_gather_flat(out, flat.cpu(), group=group)
        out = out.to(x.device)
    else:
        out = x.new_empty((n * flat.numel(),))
        _all_gather_flat(out, flat, group=group)
    shape = (*x.shape[:dim], n * x.shape[dim], *x.shape[dim + 1:])
    return out.view(n, *x.shape).movedim(0, dim).reshape(shape)


def reduce_scatter(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The sum over the ``n`` ranks of ``x``, cut into ``n`` chunks along
    ``dim``: this rank's chunk."""
    dim %= x.dim()
    chunk = x.shape[dim] // n
    parts = x.reshape(*x.shape[:dim], n, chunk, *x.shape[dim + 1:]).movedim(dim, 0)
    flat = parts.contiguous().reshape(-1)
    shape = (*x.shape[:dim], chunk, *x.shape[dim + 1:])
    if _staged("reduce_scatter", x, group):
        STAGED["reduce_scatter"] += 1
        out = torch.empty((flat.numel() // n,), dtype=x.dtype)
        _reduce_scatter_flat(out, flat.cpu(), group=group)
        return out.to(x.device).view(shape)
    out = x.new_empty((flat.numel() // n,))
    _reduce_scatter_flat(out, flat, group=group)
    return out.view(shape)


def _slice(x: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    chunk = x.shape[dim] // n
    return x.narrow(dim, i * chunk, chunk).contiguous()


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, *ctx.args), None, None, None


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.args = (dim, n, i)
        return all_gather(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, *ctx.args), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.args = (dim, group, n)
        return reduce_scatter(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, n, i):
        ctx.args = (dim, group, n)
        return _slice(x, dim, n, i)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, *ctx.args), None, None, None, None


def _axis(mesh, name: str) -> tuple:
    """(group, size, index) of this rank along mesh axis ``name``."""
    names = list(mesh.mesh_dim_names)
    if name not in names:
        return None, 1, 0
    n = int(mesh.size(names.index(name)))
    if n == 1:
        return None, 1, 0
    return mesh.get_group(name), n, int(mesh.get_local_rank(name))


class Par:
    """This rank's view of ``rules.mesh`` for one call of the LM.

    ``seq``: the residual's sequence lies over the model axis between blocks
    (``cfg.seq_parallel``; forward and loss only, as in the reference).
    ``batch``: the batch lies over the data axes; where it does not (a
    decode batch the data axes do not divide), the attention caches' sequence
    does instead, and the tokens are the same on every data rank."""

    def __init__(self, rules=None, *, seq: bool = False, batch: bool = True):
        mesh = getattr(rules, "mesh", None)
        self.rules = rules
        self.m_group, self.m_size, self.m_rank = (None, 1, 0) if mesh is None else _axis(
            mesh, rules.model_axis)
        if self.m_size > 1 and rules.model_size != self.m_size:
            raise ValueError(f"ShardRules.model_size {rules.model_size} is not the mesh's model "
                             f"axis, {self.m_size}")
        # the data axes of size > 1, outer first: (group, size, index)
        self.data = [] if mesh is None else [
            a for a in (_axis(mesh, name) for name in rules.batch_axes) if a[1] > 1]
        self.d_size = math.prod(a[1] for a in self.data)
        self.d_rank = 0
        for _, n, i in self.data:
            self.d_rank = self.d_rank * n + i
        self.seq = bool(seq) and self.m_size > 1
        self.batch = bool(batch)

    @property
    def tp(self) -> bool:
        return self.m_size > 1

    def shards(self, dim: int) -> bool:
        """Whether the model axis shards a dimension of global size ``dim``
        (the reference's ``ShardRules.tp``: only where it divides)."""
        return self.m_size > 1 and dim % self.m_size == 0

    # -- the model axis -------------------------------------------------------
    def copy(self, x):
        return _Copy.apply(x, self.m_group) if self.tp else x

    def reduce(self, x):
        return _Reduce.apply(x, self.m_group) if self.tp else x

    def all_reduce(self, x):
        return _AllReduce.apply(x, self.m_group) if self.tp else x

    def gather_rep(self, x, dim: int):
        if not self.tp:
            return x
        return _GatherRep.apply(x, dim, self.m_group, self.m_size, self.m_rank)

    def split(self, x, dim: int):
        if not self.tp:
            return x
        return _Split.apply(x, dim, self.m_group, self.m_size, self.m_rank)

    def enter(self, x, sharded: bool):
        """A block's input (b, s, d) from the residual: gathered from the
        sequence shards under ``seq``; into products that are all model-
        sharded (``sharded``) through ``copy`` or ``gather``, otherwise
        replicated (the block places its own ``copy`` where a replicated
        value meets a sharded product)."""
        if self.seq:
            if sharded:
                return _Gather.apply(x, 1, self.m_group, self.m_size)
            return self.gather_rep(x, 1)
        return self.copy(x) if sharded else x

    def leave(self, y, partial: bool):
        """A block's output (b, s, d) onto the residual: partial sums reduced
        (reduce-scattered onto the sequence shards under ``seq``), a
        replicated output sliced to this rank's shard under ``seq``."""
        if self.seq:
            if partial:
                return _Scatter.apply(y, 1, self.m_group, self.m_size)
            return self.split(y, 1)
        return self.reduce(y) if partial else y

    def norm_scale(self, scale):
        """A norm's scale, applied on sequence shards under ``seq``: each
        rank's gradient is its shard's part, summed over the model axis."""
        return self.copy(scale) if self.seq else scale

    def model_max(self, x):
        """Element-wise max over the model axis (no gradient)."""
        return all_reduce(x.detach(), self.m_group, MAX) if self.tp else x.detach()

    def model_gather(self, x, dim: int):
        """All-gather over the model axis with no gradient (caches, logits)."""
        return all_gather(x, dim, self.m_group, self.m_size) if self.tp else x

    # -- the data axes --------------------------------------------------------
    def _over_data(self, x, fn):
        for group, _, _ in self.data:
            x = fn(x, group)
        return x

    def data_sum_rep(self, x):
        """Sum over the data ranks into a value every rank holds, the
        identity backward (each rank's gradient stays its own part)."""
        return self._over_data(x, _Reduce.apply)

    def data_sum(self, x):
        """Sum over the data ranks feeding each rank's own terms: the
        backward sums the parts (the FDA head's federation mean)."""
        return self._over_data(x, _AllReduce.apply)

    def data_mean(self, x):
        """``pmean`` over the data axes."""
        return self.data_sum_rep(x) / self.d_size if self.data else x

    def data_reduce(self, x, op=SUM):
        """All-reduce over the data axes with no gradient."""
        return self._over_data(x.detach(), lambda t, g: all_reduce(t, g, op))
