"""Host-side collection of the engine's health probes.

Port of ``repro.obs.probes``.  The round and flush of
``federated.engine.BatchedRoundEngine`` with ``probe=True`` return a probes
dict beside the parameters: moment mass, per-client update norms, and the
:meth:`repro_torch.robust.rules.AggregationRule.attribution` trim/quarantine
indicators, all tensors on the engine's device.  :func:`emit_probes` brings
the dict to the host in one device-to-host copy (the tensors are flattened
into one and copied with one ``.cpu()``) and fans it into the metrics
registry.

Emission schema (all under the active registry), the reference's:

- ``probe.<name>`` gauge — scalar probes (e.g. ``moment_mass``), labelled
  ``plane=round|flush``;
- ``probe.<name>`` histogram + ``probe.<name>.mean`` gauge — vector probes
  (e.g. per-client ``update_norm``): the histogram observes the max per
  emission, the gauge tracks the mean;
- ``robust.trim_quarantine`` counter — attribution probes
  (``attribution_moments`` / ``attribution_w_rf``), accumulated per member
  with labels ``kind=<payload> member=<i>``: the per-client fault ledger.

Returns the probes as host numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.obs.registry import get_registry

ATTRIBUTION_PREFIX = "attribution_"


def _to_host(probes: dict) -> dict[str, np.ndarray]:
    """One device-to-host copy for the whole dict: the tensors are flattened
    into one float32 tensor on their device, copied, and split again."""
    names = sorted(probes)
    tensors = [torch.as_tensor(probes[k]) for k in names]
    if not tensors:
        return {}
    dev = tensors[0].device
    flat = torch.cat([t.detach().to(device=dev, dtype=torch.float32).reshape(-1)
                      for t in tensors]).cpu().numpy()
    out, off = {}, 0
    for name, t in zip(names, tensors):
        out[name] = flat[off:off + t.numel()].reshape(tuple(t.shape))
        off += t.numel()
    return out


def emit_probes(probes: dict, *, plane: str, registry=None) -> dict:
    """Bring ``probes`` (tensors) to the host and emit them as metrics."""
    host = _to_host(probes)
    reg = get_registry() if registry is None else registry
    if not reg.collecting:
        return host
    for name, arr in sorted(host.items()):
        if name.startswith(ATTRIBUTION_PREFIX):
            kind = name[len(ATTRIBUTION_PREFIX):]
            ledger = reg.counter("robust.trim_quarantine")
            for i, v in enumerate(arr.reshape(-1).tolist()):
                if v > 0:
                    ledger.inc(float(v), kind=kind, member=i)
        elif arr.ndim == 0:
            reg.gauge(f"probe.{name}").set(float(arr), plane=plane)
        else:
            flat = arr.reshape(-1)
            reg.histogram(f"probe.{name}").observe(float(flat.max()), plane=plane)
            reg.gauge(f"probe.{name}.mean").set(float(flat.mean()), plane=plane)
    return host


def quarantine_totals(registry=None, *, kind: str | None = None) -> dict[int, float]:
    """Per-member cumulative trim/quarantine mass from the fault ledger.

    Sums the ``robust.trim_quarantine`` counter across payload kinds (or one
    ``kind``), keyed by member index.
    """
    reg = get_registry() if registry is None else registry
    totals: dict[int, float] = {}
    counter = reg.counter("robust.trim_quarantine")
    for key, value in getattr(counter, "series", {}).items():
        labels = dict(part.split("=", 1) for part in key.split(",") if "=" in part)
        if kind is not None and labels.get("kind") != kind:
            continue
        member = int(labels["member"])
        totals[member] = totals.get(member, 0.0) + value
    return totals
