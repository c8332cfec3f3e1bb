"""Live client admission: join the federation without a global refit.

Port of ``repro.serve.admission``.  The wire legs are the port's ``comm``
(host numpy, as the reference's); the client's moment is computed on its
device: the K4 kernel draws draw 0's Omega and the K1 kernel featurizes.
The admitted client's state is rebuilt on the server state's device from
the decoded downlink.

The deployment story behind FedRF-TCA's O(1) communication: a *new* device
suffering domain shift streams its Sigma-ell moment vector (2N floats, eq. 2)
to the server and gets back a fitted aligner — total traffic a few KB,
independent of the device's sample count, and the server never re-solves
anything.

The path is real wire end to end (``comm/wire.py``): the client's moments and
the server's aligner response are serialized frames with CRC32 trailers
through a :class:`~repro_torch.comm.transport.WireTransport`, so codecs, integrity
rejects and retry budgets all apply.  Server-side, the moment folds into the
store entry's :class:`~repro_torch.serve.store.MomentStats` by *incremental merge*
(the weighted-mean associativity the fleet hierarchy already exploits) — the
cached aligner's version does not change, which is the refit-free contract
the bench gates.

The aligner states are seed-fused (``w_rf="fused:<seed>"``): the response
carries only the solved (2N, m) matrix plus the fused spec the client already
shares, so the *server* never materializes the (N, p) frequency matrix per
admission — the admitted client re-derives draw-0 omega from the shared seed
(memoized, ``core.rf_tca.fused_transform_omega``) exactly like any fused
transform.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.comm import wire
from repro_torch.comm.transport import Transport, WireTransport, resolve_codecs
from repro_torch.core.rf_tca import RFTCAState
from repro_torch.core.rff import rff_features
from repro_torch.device import as_f32, resolve_device
from repro_torch.kernels.prng import fused_omega
from repro_torch.obs import get_tracer, metrics
from repro_torch.serve.store import ModelStore


def client_moment(
    x,
    *,
    n_features: int,
    fused_seed: int,
    sigma: float = 1.0,
    kernel: str = "gauss",
    role: str = "source",
    device=None,
) -> np.ndarray:
    """The joining device's only data-dependent message: sign * mean RFF row.

    Drawn against the shared fused seed, so the client's omega is bit-exactly
    the fit's draw-0 matrix (``kernels.prng.fused_omega``, the K4 kernel on
    the card) — the device materializes its own (N, p) omega locally; the
    server never does.  ``device=None`` is the card.
    """
    if role not in ("source", "target"):
        raise ValueError(f"role must be 'source' or 'target', got {role!r}")
    dev = resolve_device(device)
    x = as_f32(x, dev)
    omega = fused_omega(fused_seed, n_features, x.shape[0], sigma=sigma, rf_kernel=kernel,
                        device=dev)
    sign = 1.0 if role == "source" else -1.0
    return sign * torch.mean(rff_features(x, omega), dim=1).cpu().numpy()


def admission_message(moment, *, sender: int, version: int = 0) -> wire.Message:
    """Frame the moment vector for the uplink (round = the version the client
    saw advertised; the server echoes its actual latest back)."""
    return wire.moments_message(
        np.asarray(moment, np.float32), sender=sender, round=max(version, 0)
    )


@dataclass
class AdmissionResult:
    """Outcome of one admission: the client's aligner (decoded off the wire)
    plus the accounting the bench gates on."""

    delivered: bool
    state: RFTCAState | None  # the admitted client's aligner (fused spec kept)
    version: int | None  # store version served (unchanged by the admission)
    bytes_up: int = 0  # moments frame bytes (retransmits included)
    bytes_down: int = 0  # aligner response bytes


class AdmissionGateway:
    """Server-side admission endpoint over a model store + wire transport."""

    def __init__(self, store: ModelStore, *, transport: Transport | None = None,
                 seed: int = 0):
        if transport is None:
            transport = WireTransport(resolve_codecs("float32"), seed=seed)
        if transport.codecs["w_rf"].name == "seed_replay":
            # seed_replay replays the seed-derived *init*; admission ships the
            # SOLVED aligner, which is data-dependent and cannot be replayed
            raise ValueError(
                "admission responses carry the solved W_RF; the seed_replay "
                "codec would reconstruct the init instead"
            )
        self.store = store
        self.transport = transport
        self.admissions = 0
        self.failures = 0
        # optional obs.RequestTracer: emits one wall-clock admission span
        # tree (wire decode -> moment merge -> W_RF ship) per admit
        self.reqtrace = None

    def _bytes(self) -> int:
        return int(self.transport.log.bytes_total)

    def _rejects(self) -> int:
        return int(self.transport.log.rejects_total)

    def admit(
        self,
        domain_pair,
        moment_msg: wire.Message,
        *,
        n_samples: int,
        role: str = "source",
        codec: str = "float32",
    ) -> AdmissionResult:
        """Admit one client: merge its moments, return the cached aligner.

        Refit-free by construction — the entry's stats update in place and
        the store version is untouched.  ``delivered=False`` means a wire leg
        exhausted its retry budget (fault injection); the moment is NOT
        merged unless its uplink actually decoded.
        """
        entry = self.store.get(domain_pair, codec)
        if entry is None:
            raise KeyError(f"no fitted aligner for domain pair {domain_pair!r}")
        if entry.state.fused is None:
            raise ValueError(
                "admission requires a seed-fused aligner state "
                '(rf_tca_fit(w_rf="fused:<seed>")) so the client can re-derive '
                "omega from the shared seed"
            )
        version = self.store.latest_version(domain_pair, codec) or 0
        reg = metrics()
        rt = self.reqtrace
        tracer = get_tracer() if rt is not None else None
        wall0 = tracer.wall_now() if tracer is not None else 0.0
        legs: list[tuple[str, float]] = []  # (leg name, wall duration s)
        b0, r0 = self._bytes(), self._rejects()
        t0 = time.perf_counter()
        arrays = self.transport.transfer(moment_msg)
        legs.append(("serve.wire_decode", time.perf_counter() - t0))
        bytes_up = self._bytes() - b0
        reg.counter("serve.admission_bytes").inc(bytes_up, leg="up")
        if arrays is None:
            self.failures += 1
            reg.counter("serve.admission_failures").inc(leg="uplink")
            self._trace(rt, tracer, legs, wall0, b0, r0)
            return AdmissionResult(False, None, version, bytes_up, 0)
        t0 = time.perf_counter()
        entry.stats.merge(arrays["msg"], n_samples, role=role)
        legs.append(("serve.moment_merge", time.perf_counter() - t0))
        t0 = time.perf_counter()
        response = wire.w_rf_message(
            entry.state.w_rf.float(), sender=-1, round=version, downlink=True,
        )
        b1 = self._bytes()
        decoded = self.transport.transfer(response)
        legs.append(("serve.w_rf_ship", time.perf_counter() - t0))
        bytes_down = self._bytes() - b1
        reg.counter("serve.admission_bytes").inc(bytes_down, leg="down")
        if decoded is None:
            self.failures += 1
            reg.counter("serve.admission_failures").inc(leg="downlink")
            self._trace(rt, tracer, legs, wall0, b0, r0)
            return AdmissionResult(False, None, version, bytes_up, bytes_down)
        client_state = RFTCAState(
            omega=None,
            w_rf=as_f32(decoded["w_rf"], entry.state.w_rf.device),
            eigvals=entry.state.eigvals,
            fused=entry.state.fused,
        )
        self.admissions += 1
        reg.counter("serve.admissions").inc(role=role)
        self._trace(rt, tracer, legs, wall0, b0, r0)
        return AdmissionResult(True, client_state, version, bytes_up, bytes_down)

    def _trace(self, rt, tracer, legs, wall0: float, b0: int, r0: int) -> None:
        """Close out one admission's telemetry: retry counter + span tree."""
        retries = self._rejects() - r0
        if retries:
            metrics().counter("serve.admission_retries").inc(retries)
        if rt is not None and tracer is not None:
            rt.emit_admission(legs, wall0=wall0)
