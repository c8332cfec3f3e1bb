"""Aligner server: the persistent adaptation-as-a-service facade.

Port of ``repro.serve.server``.  A server runs on one device (``device=None``:
the card): every fit and refit goes through the port's ``core.rf_tca`` there
(the K5 kernel for a seed-fused fit), and every retained tensor (the states,
the fit-time Gram) sits on it; the moment ledger, like the reference's, is
host numpy.

One object owns the three serving-plane pieces and their policies:

- a :class:`~repro_torch.serve.store.ModelStore` of fitted aligner states (LRU
  capacity + version-tagged invalidation),
- a :class:`~repro_torch.serve.dispatcher.BatchingDispatcher` coalescing concurrent
  transform/predict requests into bucketed dispatches,
- an :class:`~repro_torch.serve.admission.AdmissionGateway` admitting new clients
  over the real wire with an incremental moment merge (no refit).

The server retains the fit data per domain pair, which buys two behaviours
the bench measures: an LRU *miss* on a previously-fitted pair re-solves from
the retained data inside the request path (cache-miss cost is real, counted
in ``refits``), and :meth:`refresh` re-solves on demand and bumps the version
(the invalidation path — e.g. after enough admitted moments accumulate).

Seed-fused fits additionally retain their *statistics* (merged Gram G_H,
mean-discrepancy u, and the solve hyperparameters), which unlocks the
moment-space refresh: :meth:`refresh_from_moments` re-solves W_RF from the
retained Gram and an *updated* target moment — no raw-data pass — and the
attached observability stack (:meth:`attach`) closes the loop: the drift
monitor watches live batch moments streamed out of the probed dispatch
planes and, on a confirmed RF-MMD alert, triggers exactly that refresh
(one version bump, staleness counter reset, reference re-pinned).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.comm.transport import Transport
from repro_torch.core.rf_tca import (
    fused_transform_omega,
    rf_tca_fit,
    rf_tca_fit_with_stats,
    rf_tca_resolve,
)
from repro_torch.core.rff import rff_features
from repro_torch.device import as_f32, resolve_device
from repro_torch.obs import metrics
from repro_torch.serve.admission import (
    AdmissionGateway,
    AdmissionResult,
    admission_message,
    client_moment,
)
from repro_torch.serve.dispatcher import BatchingDispatcher, Request
from repro_torch.serve.store import ModelStore, StoreEntry

# rf_tca_fit kwargs the statistics-returning fit does not take (the fused
# path ignores it anyway: it requires mode="stream")
_NON_STATS_KW = ("mode",)


class AlignerServer:
    """Persistent serving endpoint over cached RF-TCA aligners."""

    def __init__(
        self,
        *,
        capacity: int = 8,
        codec: str = "float32",
        transport: Transport | None = None,
        min_bucket: int = 8,
        max_bucket: int = 256,
        fused_seed: int = 1234,
        seed: int = 0,
        sentinel_prefix: str = "serve",
        device=None,
    ):
        self.device = resolve_device(device)
        self.store = ModelStore(capacity)
        self.dispatcher = BatchingDispatcher(
            min_bucket=min_bucket, max_bucket=max_bucket,
            sentinel_prefix=sentinel_prefix,
        )
        self.codec = codec
        self.fused_seed = fused_seed
        self.admission = AdmissionGateway(self.store, transport=transport, seed=seed)
        # pair key -> (x_s, x_t, fit_kw): enough to re-solve on miss/refresh
        self._domains: dict[tuple, tuple[Any, Any, dict]] = {}
        # pair key -> retained fit statistics (fused path): gram, u, moments,
        # solve hyperparameters — the moment-space refresh re-solves from these
        self._fit_stats: dict[tuple, dict] = {}
        self.refits = 0
        self.moment_refreshes = 0
        # observability wiring (attach()): all None/off by default, and the
        # serving path with them off is bitwise identical to pre-wiring
        self.slo = None
        self.drift = None
        self.reqtrace = None
        self.virtual_now = 0.0  # stamped by the load generator per batch

    @staticmethod
    def _key(domain_pair) -> tuple:
        return tuple(domain_pair)

    def _solve(self, domain_pair) -> StoreEntry:
        key = self._key(domain_pair)
        x_s, x_t, fit_kw = self._domains[key]
        w_rf = fit_kw.get("w_rf")
        if not (isinstance(w_rf, str) and w_rf.startswith("fused:")):
            state = rf_tca_fit(x_s, x_t, **fit_kw)
            return StoreEntry(state=state, fit_kw=dict(fit_kw))
        stats_kw = {k: v for k, v in fit_kw.items() if k not in _NON_STATS_KW}
        state, fstats = rf_tca_fit_with_stats(x_s, x_t, **stats_kw)
        entry = StoreEntry(state=state, fit_kw=dict(fit_kw), gram=fstats["gram"])
        # Seed the moment ledger with the fit-time statistics so admissions
        # merge against the fit moments and refreshes reconstruct u exactly:
        # target_mean is the mean RFF row of the fit target data and
        # source_mean = u + target_mean (float32-exact consistency with the
        # solved statistic, by construction).
        omega = fused_transform_omega(state, int(x_t.shape[0]))
        feats = rff_features(as_f32(x_t, self.device), omega)
        t_mean = feats.mean(dim=1).cpu().numpy()
        s_mean = fstats["u"].cpu().numpy() + t_mean
        entry.stats.source_mean = s_mean
        entry.stats.n_source = int(x_s.shape[1])
        entry.stats.target_mean = t_mean
        entry.stats.n_target = int(x_t.shape[1])
        self._fit_stats[key] = {
            "gram": fstats["gram"],
            "source_mean": s_mean,
            "target_mean": t_mean,
            "gamma": fstats["gamma"], "m": fstats["m"],
            "solver": fstats["solver"], "seed": fstats["seed"],
            "fused_spec": state.fused,
        }
        return entry

    def fit_domain(self, domain_pair, x_s, x_t, *, classifier=None, **fit_kw) -> int:
        """Fit and cache an aligner for ``domain_pair``; returns its version.

        Defaults to the seed-fused W_RF path (``w_rf="fused:<fused_seed>"``)
        so admissions can ship the solved matrix alone — pass an explicit
        ``w_rf`` to override.  The fit runs on the server's device.
        """
        fit_kw.setdefault("w_rf", f"fused:{self.fused_seed}")
        fit_kw["device"] = self.device
        self._domains[self._key(domain_pair)] = (x_s, x_t, fit_kw)
        entry = self._solve(domain_pair)
        entry.classifier = classifier
        version = self.store.put(domain_pair, entry, codec=self.codec)
        if self.drift is not None and self._key(domain_pair) in self._fit_stats:
            self.drift.set_reference(
                self._key(domain_pair),
                self._fit_stats[self._key(domain_pair)]["target_mean"],
            )
        return version

    def get_or_fit(self, domain_pair) -> StoreEntry:
        """Store lookup; an LRU miss on a known pair re-solves in-path."""
        entry = self.store.get(domain_pair, self.codec)
        if entry is None:
            if self._key(domain_pair) not in self._domains:
                raise KeyError(f"unknown domain pair {domain_pair!r} (fit_domain first)")
            entry = self._solve(domain_pair)
            self.refits += 1
            metrics().counter("serve.refits").inc()
            self.store.put(domain_pair, entry, codec=self.codec)
        return entry

    def serve(self, requests: list[Request]) -> list[tuple[Request, np.ndarray]]:
        """Dispatch a burst of requests; same-key runs batch together."""
        done: list[tuple[Request, np.ndarray]] = []
        i = 0
        while i < len(requests):
            key = requests[i].key
            j = i
            while j < len(requests) and requests[j].key == key:
                self.dispatcher.submit(requests[j])
                j += 1
            entry = self.get_or_fit(key)
            done.extend(self.dispatcher.flush(entry))
            i = j
        return done

    def warmup(self, domain_pair, *, modes: tuple[str, ...] = ("transform",)) -> int:
        """Run every bucket rung once (dummy batches) so load runs never pay a
        first call (plane build, the K1 kernel's first launch at that width)
        in-path; returns the number of planes run."""
        entry = self.get_or_fit(domain_pair)
        dim = int(self._domains[self._key(domain_pair)][0].shape[0])
        planes = 0
        for mode in modes:
            b = self.dispatcher.min_bucket
            while True:
                self.dispatcher.submit(Request(
                    x=np.zeros((dim, b), np.float32), key=self._key(domain_pair), mode=mode,
                ))
                self.dispatcher.flush(entry)
                planes += 1
                if b >= self.dispatcher.max_bucket:
                    break
                b *= 2
        return planes

    def admit(self, domain_pair, x_client, *, role: str = "source",
              sender: int = 0) -> AdmissionResult:
        """Admit a new client device holding raw samples ``x_client`` (p, n).

        Convenience wrapper running both halves of the protocol in-process:
        the client-side moment + frame (:func:`~repro_torch.serve.admission.
        client_moment`) and the server-side merge + aligner downlink.  The
        wire in between is real (serialize/CRC/codec/retries).
        """
        entry = self.store.get(domain_pair, self.codec)
        if entry is None:
            entry = self.get_or_fit(domain_pair)
        state = entry.state
        if state.fused is None:
            raise ValueError("admission requires a seed-fused aligner "
                             '(fit_domain default, w_rf="fused:<seed>")')
        f_seed, _, f_sigma, f_kernel = state.fused
        moment = client_moment(
            x_client,
            n_features=state.w_rf.shape[0] // 2,
            fused_seed=f_seed, sigma=f_sigma, kernel=f_kernel, role=role, device=self.device,
        )
        version = self.store.latest_version(domain_pair, self.codec) or 0
        msg = admission_message(moment, sender=sender, version=version)
        return self.admission.admit(
            domain_pair, msg,
            n_samples=int(x_client.shape[1]), role=role, codec=self.codec,
        )

    def refresh(self, domain_pair) -> int:
        """Re-solve from retained data and bump the version (invalidation):
        the explicit refresh path, e.g. once ``entry.stats.admitted`` crosses
        a staleness budget.  Returns the new version."""
        old = self.store.get(domain_pair, self.codec)
        entry = self._solve(domain_pair)
        if old is not None:
            entry.classifier = old.classifier
        self.refits += 1
        metrics().counter("serve.refits").inc()
        return self.store.put(domain_pair, entry, codec=self.codec, bump=True)

    # -- observability wiring (request tracing / SLOs / drift) ---------------

    def attach(self, *, slo=None, drift=None, request_tracer=None) -> None:
        """Wire the observability stack into the serving path.

        - ``request_tracer`` (:class:`repro_torch.obs.RequestTracer`) — per-request
          span trees; also handed to the admission gateway for its wire legs.
        - ``slo`` (:class:`repro_torch.obs.SloEngine`) — the load generator feeds
          completion latencies into it (see ``run_open_loop``).
        - ``drift`` (:class:`repro_torch.obs.DriftMonitor`) — switches
          transform dispatches to the probed planes (batch moments stream out
          of the dispatch), pins each fitted pair's target moment as the drift
          reference, and routes alerts to :meth:`refresh_from_moments`.
        """
        if request_tracer is not None:
            self.reqtrace = request_tracer
            self.admission.reqtrace = request_tracer
        if slo is not None:
            self.slo = slo
        if drift is not None:
            self.drift = drift
            drift.on_alert = self._on_drift_alert
            self.dispatcher.moment_hook = self._on_batch_moment
            for key, fs in self._fit_stats.items():
                drift.set_reference(key, fs["target_mean"])

    def rearm_drift(self) -> None:
        """Re-pin every fitted pair's drift reference, clearing the live
        EWMA/window state — e.g. after :meth:`warmup`, whose dummy batches
        would otherwise pollute threshold calibration."""
        if self.drift is None:
            return
        for key, fs in self._fit_stats.items():
            self.drift.set_reference(key, fs["target_mean"])

    def _on_batch_moment(self, key, moment, n_cols: int) -> None:
        """Dispatcher probe callback: one batch's mean RFF row, stamped with
        the load generator's virtual clock."""
        if self.drift is not None:
            self.drift.observe(self._key(key), self.virtual_now, moment, n_cols)

    def _on_drift_alert(self, pair, record) -> None:
        """Confirmed RF-MMD drift on ``pair`` — refresh from live moments."""
        if self._key(pair) in self._fit_stats:
            self.refresh_from_moments(pair)

    def refresh_from_moments(self, domain_pair, target_mean=None,
                             n_target: int | None = None) -> int:
        """Re-solve W_RF from the retained Gram and an updated target moment.

        The drift-driven refresh: ``u_new = source_mean - target_mean`` where
        ``target_mean`` defaults to the drift monitor's recency-weighted live
        moment (:meth:`repro_torch.obs.DriftMonitor.recent_mean`).  The merged Gram
        G_H is covariate-shift-invariant under the fused feature map, so the
        re-solve is one statistics-space eigensolve — no raw-data pass, no
        wire traffic.  Exactly one version bump; the entry's target-side
        ledger resets to the refreshed moment and ``admitted`` restarts (the
        staleness counter); the drift reference re-pins so detection re-arms.
        Returns the new version.
        """
        key = self._key(domain_pair)
        fs = self._fit_stats.get(key)
        if fs is None:
            raise KeyError(
                f"no retained fit statistics for {domain_pair!r} "
                '(moment-space refresh needs a seed-fused fit_domain)'
            )
        if target_mean is None:
            if self.drift is None:
                raise ValueError(
                    "target_mean=None needs an attached DriftMonitor "
                    "(attach(drift=...)) to pool live moments from"
                )
            target_mean, n_target = self.drift.recent_mean(key)
        target_mean = np.asarray(target_mean, np.float32)
        u_new = torch.as_tensor(fs["source_mean"] - target_mean, device=fs["gram"].device)
        old = self.store.get(domain_pair, self.codec)
        state = rf_tca_resolve(
            fs["gram"], u_new, gamma=fs["gamma"], m=fs["m"],
            solver=fs["solver"], seed=fs["seed"], fused_spec=fs["fused_spec"],
        )
        _, _, fit_kw = self._domains[key]
        entry = StoreEntry(state=state, fit_kw=dict(fit_kw), gram=fs["gram"])
        if old is not None:
            entry.classifier = old.classifier
            # source side carries through (admissions included); target side
            # resets to the refreshed moment; admitted restarts at 0
            entry.stats.source_mean = old.stats.source_mean
            entry.stats.n_source = old.stats.n_source
        else:
            entry.stats.source_mean = fs["source_mean"]
        entry.stats.target_mean = target_mean
        entry.stats.n_target = int(n_target) if n_target else 0
        fs["target_mean"] = target_mean
        self.moment_refreshes += 1
        metrics().counter("serve.moment_refreshes").inc()
        version = self.store.put(domain_pair, entry, codec=self.codec, bump=True)
        if self.drift is not None:
            self.drift.set_reference(key, target_mean)
        return version

    def stats(self) -> dict:
        """JSON-ready serving counters (store + dispatcher + admission)."""
        return {
            "store": self.store.snapshot(),
            "dispatcher": self.dispatcher.histogram(),
            "admissions": self.admission.admissions,
            "admission_failures": self.admission.failures,
            "refits": self.refits,
            "moment_refreshes": self.moment_refreshes,
            "wire": {
                "bytes_total": int(self.admission.transport.log.bytes_total),
                "rejects_total": int(self.admission.transport.log.rejects_total),
            },
        }
