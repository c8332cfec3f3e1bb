"""Roofline terms of one step of the port, counted as it runs (no compiler).

Port of ``repro.launch.roofline``.  Terms per step, in seconds, on one card:

    compute    = FLOPs / PEAK_FLOPS
    memory     = HBM bytes / HBM_BW
    collective = collective bytes / NVLINK_BW

The reference reads XLA's ``cost_analysis`` and the compiled HLO text.  The
port has neither, so :func:`from_step` runs the step itself under a
``TorchDispatchMode`` (:class:`StepCounter`) that sees every aten operation
below autograd, on any device, the ``meta`` device included:

- FLOPs: ``torch.utils.flop_counter``'s formulas for the products (mm,
  addmm, bmm, baddbmm, convolutions, SDPA); elementwise work is not counted,
  as XLA's products dominate its count too;
- HBM bytes: the bytes each operation reads and writes, every tensor input
  read once and every output written once.  Views (outputs that share their
  input's storage, with no mutation) and ``empty`` allocations move nothing.
  Nothing is fused, so this is an upper bound on the traffic of the step;
- the hand-written kernels: a ctypes launch is invisible to the dispatcher,
  so each kernel's wrapper adds the (flops, bytes) of every call, on the
  card or on meta tensors, to its ``COST`` (``kernels.flash_attention``);
  the counter adds what they reported during the step.  On CPU tensors a
  wrapper runs its plain version, whose own operations are counted instead;
- collectives: the result bytes of each ``torch.distributed`` collective
  the step issues, by kind, the reference's rule: the ``c10d`` operations
  (``torch.distributed.all_reduce`` and its kin, in place) and the
  functional ones (``_c10d_functional``).  Under a mesh each rank's step
  is counted, so the counts are per card, as the reference's
  ``from_compiled`` gives them.

:class:`StepCounter` also tracks the bytes of the storages the step creates
while they live (a ``weakref.finalize`` on every tensor an operation returns,
a count of live tensors per storage): ``peak_bytes`` is the most that were
alive at once, the step's temporaries and outputs, less its arguments.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import flash_attention as _flash

# NVIDIA H100 SXM5 80 GB, the datasheet's figures (not measurements): dense
# bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4 per direction (900 GB/s
# bidirectional).  The card may be set below its 700 W maximum and then runs
# slower under load.
PEAK_FLOPS = 989e12  # bf16 FLOP/s per card, dense
HBM_BW = 3.35e12  # bytes/s per card
NVLINK_BW = 450e9  # bytes/s per direction, NVLink 4

_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")
# c10d operations (the dispatcher's names) -> their kind; the first argument
# is each one's result (output) tensor or list of them
_C10D_KINDS = {
    "allreduce_": "all_reduce", "allreduce_coalesced_": "all_reduce",
    "allgather_": "all_gather", "_allgather_base_": "all_gather",
    "allgather_into_tensor_coalesced_": "all_gather", "allgather_coalesced_": "all_gather",
    "reduce_scatter_": "reduce_scatter", "_reduce_scatter_base_": "reduce_scatter",
    "reduce_scatter_tensor_coalesced_": "reduce_scatter",
    "alltoall_": "all_to_all", "alltoall_base_": "all_to_all",
}
# functional collectives (``_c10d_functional``) -> their kind; each returns its result
_FUNCTIONAL_KINDS = {
    "all_reduce": "all_reduce", "all_reduce_": "all_reduce",
    "all_reduce_coalesced": "all_reduce", "all_reduce_coalesced_": "all_reduce",
    "all_gather_into_tensor": "all_gather", "all_gather_into_tensor_out": "all_gather",
    "all_gather_into_tensor_coalesced": "all_gather",
    "reduce_scatter_tensor": "reduce_scatter", "reduce_scatter_tensor_out": "reduce_scatter",
    "reduce_scatter_tensor_coalesced": "reduce_scatter",
    "all_to_all_single": "all_to_all",
}
_ALLOCATORS = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")
# the kernels whose wrappers report their work (``COST``)
KERNEL_COSTS = {"flash_attention": _flash.COST["flash_attention"],
                "flash_attention_bwd": _flash.COST["flash_attention_bwd"]}


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """The tensors of nested lists, tuples and dicts (and NamedTuples)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _no_collectives() -> dict[str, int]:
    return {k: 0 for k in _COLLECTIVES}


@dataclass
class StepCount:
    flops: int = 0  # products counted from the dispatched operations
    hbm_bytes: int = 0  # dispatched operations' reads and writes
    kernel_flops: int = 0  # reported by the hand-written kernels' wrappers
    kernel_bytes: int = 0
    kernels: dict = field(default_factory=dict)  # name -> {"calls", "flops", "bytes"}
    coll_by_kind: dict = field(default_factory=_no_collectives)
    ops: int = 0
    by_op: dict = field(default_factory=dict)  # operation name -> [calls, bytes]
    peak_bytes: int = 0  # live storages the step created, at most at once
    alias_bytes: int = 0  # outputs that are the arguments' own storages

    @property
    def total_flops(self) -> int:
        return self.flops + self.kernel_flops

    @property
    def total_bytes(self) -> int:
        return self.hbm_bytes + self.kernel_bytes


class StepCounter(TorchDispatchMode):
    """Counts a step's products, bytes and collectives, and the peak of the
    storages it creates (see the module's docstring).  ``args`` are the
    step's arguments: their storages are not the step's own."""

    def __init__(self, args=()):
        super().__init__()
        self.count = StepCount()
        self._arg_storages = {_storage_key(t) for t in _tensors(args)}
        self._live: dict[int, list] = {}  # storage key -> [tensors alive, nbytes]
        self._live_bytes = 0
        self._kernels0 = {k: dict(v) for k, v in KERNEL_COSTS.items()}

    def _release(self, key: int) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[0] -= 1
        if entry[0] == 0:
            self._live_bytes -= entry[1]
            del self._live[key]

    def _track(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        if key in self._arg_storages:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [0, t.untyped_storage().nbytes()]
            self._live_bytes += entry[1]
            self.count.peak_bytes = max(self.count.peak_bytes, self._live_bytes)
        entry[0] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.count.ops += 1
        ns, name = func.namespace, func.overloadpacket.__name__
        if ns == "c10d":
            kind = _C10D_KINDS.get(name)
            if kind is not None:
                moved = sum(_nbytes(t) for t in _tensors(args[0]))
                self.count.coll_by_kind[kind] += moved
            return out
        if ns == "_c10d_functional":
            kind = _FUNCTIONAL_KINDS.get(name)
            if kind is not None:
                self.count.coll_by_kind[kind] += sum(_nbytes(t) for t in _tensors(out))
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.count.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        in_keys = {_storage_key(t) for t in ins}
        view = bool(outs) and not func._schema.is_mutable and all(
            _storage_key(t) in in_keys for t in outs)
        moved = 0
        if not view and name not in _ALLOCATORS:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            self.count.hbm_bytes += moved
        entry = self.count.by_op.setdefault(name, [0, 0])
        entry[0] += 1
        entry[1] += moved
        for t in outs:
            self._track(t)
        return out

    def finish(self, outputs=()) -> StepCount:
        """Close the count: the kernels' reported work during the step and the
        bytes of ``outputs`` that alias the arguments."""
        c = self.count
        for k, v in KERNEL_COSTS.items():
            d = {f: v[f] - self._kernels0[k][f] for f in ("calls", "flops", "bytes")}
            c.kernels[k] = d
            c.kernel_flops += d["flops"]
            c.kernel_bytes += d["bytes"]
        seen = set()
        for t in _tensors(outputs):
            key = _storage_key(t)
            if key in self._arg_storages and key not in seen:
                seen.add(key)
                c.alias_bytes += t.untyped_storage().nbytes()
        return c


@dataclass
class Roofline:
    flops_per_chip: float
    hbm_bytes_per_chip: float
    coll_bytes_per_chip: float
    coll_by_kind: dict

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_chip / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes_per_chip / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "coll_by_kind": self.coll_by_kind,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
        }


def count_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a :class:`StepCounter`: returns
    (its outputs, the :class:`StepCount`)."""
    counter = StepCounter((args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    return out, counter.finish(out)


def collective_bytes(fn, *args, **kwargs) -> dict[str, int]:
    """Per-collective-kind result bytes of the ``torch.distributed``
    collectives one call of ``fn`` issues (the reference's dict shape,
    under ``torch.distributed``'s names)."""
    return count_step(fn, *args, **kwargs)[1].coll_by_kind


def from_count(c: StepCount) -> Roofline:
    return Roofline(
        flops_per_chip=float(c.total_flops),
        hbm_bytes_per_chip=float(c.total_bytes),
        coll_bytes_per_chip=float(sum(c.coll_by_kind.values())),
        coll_by_kind=dict(c.coll_by_kind),
    )


def from_step(fn, *args, **kwargs) -> Roofline:
    """The roofline of one call of ``fn`` (the counterpart of the
    reference's ``from_compiled``): the step runs once, on whatever device
    its arguments are on."""
    return from_count(count_step(fn, *args, **kwargs)[1])


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N·D for inference."""
    return (6.0 if kind == "train" else 2.0) * n_params_active * n_tokens
