"""Batching dispatcher: coalesce concurrent requests into one dispatch.

Port of ``repro.serve.dispatcher``.  N concurrent transform/predict requests
against the same cached aligner become ONE call over their concatenated
sample columns, padded to a *bucketed* width so each plane sees a small
closed set of shapes.

- **Buckets.**  ``bucket_for(n)`` rounds the total column count up to the
  next power-of-two rung of the ladder ``min_bucket .. max_bucket``; a burst
  larger than ``max_bucket`` is split across several dispatches.  Each rung
  owns its plane, a plain function on tensors wrapped in the sentinel
  ``serve.<mode>.b<bucket>[.probe]`` (``obs.sentinel``): a rung sees one
  argument signature, and a shape-unstable argument fails the gate.
- **Validity masks.**  ``federated.protocol._cycle_pad`` fills the pad
  columns by cycling real samples (never zeros) and ``_ragged_mask`` marks
  the valid ones; the plane multiplies its output by the mask, so pad
  columns leave the dispatch as exact zeros and per-request slices are taken
  on the host.
- **The card.**  The batch is assembled on the host, copied to the state's
  device once, featurized there (``core.rff.rff_features``: the K1 kernel on
  a CUDA state, one launch a dispatch), projected by ``torch.matmul``, and
  copied back once: that copy ends the dispatch.
- **Telemetry.**  Batch sizes (requests and valid columns per dispatch) land
  in the metrics registry and in host-side counters.  None of it touches a
  value, so telemetry off is bit for bit telemetry on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.rf_tca import fused_transform_omega
from repro_torch.core.rff import rff_features
from repro_torch.device import as_f32
from repro_torch.federated.protocol import _cycle_pad, _ragged_mask
from repro_torch.obs import metrics, sentinel


@dataclass
class Request:
    """One serving request: transform (aligned features) or predict (logits)
    for a column batch ``x`` (p, n) against a cached domain pair."""

    x: Any  # (p, n) sample columns, host numpy (or a tensor)
    key: Any = None  # domain pair (routing; the dispatcher is per-entry)
    mode: str = "transform"  # transform | predict
    id: int = -1
    arrival: float = 0.0  # virtual arrival time (load generator bookkeeping)

    def __post_init__(self):
        if self.mode not in ("transform", "predict"):
            raise ValueError(f"mode must be 'transform' or 'predict', got {self.mode!r}")


def _transform_body(w_rf, omega, x, mask):
    return (w_rf.T @ rff_features(x, omega)) * mask[None, :]  # (m, bucket)


def _transform_probe_body(w_rf, omega, x, mask):
    """Transform plane with a moment probe: beside the served output, the
    batch's mean RFF row over the *valid* columns (the drift monitor's live
    statistic), from the features the plane computed anyway."""
    feats = rff_features(x, omega)  # (2N, bucket)
    out = w_rf.T @ feats
    moment = (feats * mask[None, :]).sum(dim=1) / torch.clamp_min(mask.sum(), 1.0)
    return out * mask[None, :], moment


def _predict_body(w_rf, omega, clf_w, clf_b, x, mask):
    aligned = w_rf.T @ rff_features(x, omega)  # (m, bucket)
    logits = clf_w.T @ aligned + clf_b[:, None]  # (C, bucket)
    return logits * mask[None, :]


def _host_cols(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float32).numpy()
    return np.asarray(x, np.float32)


class BatchingDispatcher:
    """Coalesces queued requests into bucketed dispatches."""

    def __init__(
        self, *, min_bucket: int = 8, max_bucket: int = 256,
        sentinel_prefix: str = "serve",
    ):
        if min_bucket < 1 or max_bucket < min_bucket:
            raise ValueError(
                f"need 1 <= min_bucket <= max_bucket, got {min_bucket}, {max_bucket}"
            )
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self.sentinel_prefix = str(sentinel_prefix)
        # (mode, bucket, probe) -> plane, each with its own sentinel so the
        # signature gate is per bucket rung, not per dispatcher
        self._planes: dict[tuple[str, int, bool], Any] = {}
        self.pending: list[Request] = []
        self.dispatches = 0
        self.batch_requests: dict[int, int] = {}  # requests/dispatch -> count
        self.batch_columns: dict[int, int] = {}  # bucket width -> count
        # drift wiring: when set, transform dispatches run the probed plane
        # and hand (domain_pair, batch moment, n_valid_cols) to this callable
        self.moment_hook = None
        self._leg_log: list[tuple[float, float]] = []  # (assemble_s, dispatch_s)

    def bucket_for(self, n_cols: int) -> int:
        """Smallest power-of-two rung >= n_cols (clamped to the ladder)."""
        b = self.min_bucket
        while b < n_cols and b < self.max_bucket:
            b *= 2
        return b

    def _plane(self, mode: str, bucket: int, *, probe: bool = False):
        key = (mode, bucket, probe)
        plane = self._planes.get(key)
        if plane is None:
            if probe:
                body, suffix = _transform_probe_body, ".probe"
            else:
                body = _transform_body if mode == "transform" else _predict_body
                suffix = ""
            plane = sentinel.wrap(f"{self.sentinel_prefix}.{mode}.b{bucket}{suffix}", body)
            self._planes[key] = plane
        return plane

    def submit(self, req: Request) -> None:
        self.pending.append(req)
        reg = metrics()
        reg.counter("serve.requests").inc(mode=req.mode)
        reg.gauge("serve.queue_depth").set(len(self.pending))

    def _take_batch(self) -> list[Request]:
        """Pop a head-of-line run of same-mode requests filling <= max_bucket
        columns (a request wider than max_bucket is a caller error)."""
        batch: list[Request] = []
        cols = 0
        mode = self.pending[0].mode
        while self.pending and self.pending[0].mode == mode:
            n = int(self.pending[0].x.shape[1])
            if n > self.max_bucket:
                raise ValueError(
                    f"request has {n} columns > max_bucket={self.max_bucket}"
                )
            if batch and cols + n > self.max_bucket:
                break
            batch.append(self.pending.pop(0))
            cols += n
        return batch

    def _dispatch(self, entry, batch: list[Request]) -> list[np.ndarray]:
        """One call over the batch's concatenated columns."""
        t0 = time.perf_counter()
        state = entry.state
        dev = state.w_rf.device
        x = np.concatenate([_host_cols(r.x) for r in batch], axis=1)
        n_cols = x.shape[1]
        bucket = self.bucket_for(n_cols)
        x_pad, _ = _cycle_pad(x, None, bucket)
        mask_rows = _ragged_mask([n_cols], bucket)
        mask = np.ones((bucket,), np.float32) if mask_rows is None else mask_rows[0]
        x_pad = torch.as_tensor(np.ascontiguousarray(x_pad), device=dev)
        mask = torch.as_tensor(mask, device=dev)
        omega = state.omega
        if omega is None:
            omega = fused_transform_omega(state, x.shape[0])
        mode = batch[0].mode
        probe = self.moment_hook is not None and mode == "transform"
        t1 = time.perf_counter()
        moment = None
        if mode == "predict":
            if entry.classifier is None:
                raise ValueError("predict request against an entry with no classifier")
            out = self._plane(mode, bucket)(
                state.w_rf, omega, as_f32(entry.classifier["w"], dev),
                as_f32(entry.classifier["b"], dev), x_pad, mask,
            )
        elif probe:
            out, moment = self._plane(mode, bucket, probe=True)(state.w_rf, omega, x_pad, mask)
        else:
            out = self._plane(mode, bucket)(state.w_rf, omega, x_pad, mask)
        out = out.cpu().numpy()  # the copy to the host ends the dispatch
        t2 = time.perf_counter()
        self._leg_log.append((t1 - t0, t2 - t1))
        self.dispatches += 1
        self.batch_requests[len(batch)] = self.batch_requests.get(len(batch), 0) + 1
        self.batch_columns[bucket] = self.batch_columns.get(bucket, 0) + 1
        reg = metrics()
        reg.counter("serve.dispatches").inc(mode=mode, bucket=bucket)
        reg.histogram("serve.batch_requests").observe(len(batch))
        reg.histogram("serve.batch_fill").observe(n_cols / bucket)
        reg.histogram("serve.dispatch_s").observe(t2 - t1, bucket=bucket)
        if moment is not None:
            self.moment_hook(batch[0].key, moment.cpu().numpy(), n_cols)
        results, off = [], 0
        for r in batch:
            n = int(r.x.shape[1])
            results.append(out[:, off : off + n])
            off += n
        return results

    def take_legs(self) -> list[tuple[float, float]]:
        """Drain the wall-clock ``(assemble_s, dispatch_s)`` pairs logged
        since the last call — the request tracer's processing-leg split."""
        legs, self._leg_log = self._leg_log, []
        return legs

    def flush(self, entry) -> list[tuple[Request, np.ndarray]]:
        """Drain the pending queue against one store entry; returns
        ``(request, result)`` pairs in submission order.  Each head-of-line
        same-mode run becomes one dispatch."""
        done: list[tuple[Request, np.ndarray]] = []
        while self.pending:
            batch = self._take_batch()
            for req, res in zip(batch, self._dispatch(entry, batch)):
                done.append((req, res))
        return done

    def histogram(self) -> dict:
        """JSON-ready batch statistics for the bench record."""
        return {
            "dispatches": self.dispatches,
            "requests_per_dispatch": {
                str(k): v for k, v in sorted(self.batch_requests.items())
            },
            "bucket_widths": {
                str(k): v for k, v in sorted(self.batch_columns.items())
            },
        }
