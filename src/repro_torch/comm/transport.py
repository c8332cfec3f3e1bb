"""Transports: how federated payloads cross the (simulated) wire.

Port of ``repro.comm.transport`` (host-side numpy, copied).  The one
difference is :meth:`Transport.channel_fns`: it hands the batched engine the
lossy codecs themselves, whose ``roundtrip(x_rows, u)`` distorts a stack of
client payloads at once (K10 for the quantizing codecs).

Two implementations behind one interface:

- :class:`IdentityTransport` — arrays pass through untouched (the original
  in-process simulator), but every transfer is *byte-accounted exactly* via
  ``wire.serialized_size`` — the analytic twin of ``len(serialize(...))``.
- :class:`WireTransport` — every transfer is really serialized to bytes under
  the payload's codec and parsed back; the protocol consumes the decoded
  arrays, so lossy codecs (bf16/qint8/qint4/topk) genuinely distort training
  and accuracy-vs-codec curves are measurable (bench_comm_wire).

Both replace the seed's float-counter with :class:`CommLog`, which keeps the
legacy float fields (Table I/II accounting) *and* exact per-payload bytes.

Codec resolution: ``ProtocolConfig(codec=...)`` sets the default for all
three payload kinds; ``codec_moments``/``codec_w_rf``/``codec_classifier``
override per kind.  ``codec="seed_replay"`` means *W_RF by seed replay* —
moments and classifier payloads are data-dependent and cannot be replayed
from a key, so they fall back to float32 — and flips the protocol into
frozen-W mode: W_RF stays pinned at the shared seed-derived init (all clients
bit-identical, gradients stopped), W-aggregation becomes the O(1)-byte key
exchange, and the decoded matrix is bit-exact by construction.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.comm import wire
from repro_torch.comm.codecs import Codec, TopKCodec, get_codec
from repro_torch.obs.records import CommRecord
from repro_torch.obs.registry import get_registry

KIND_FIELD = {"moments": "data_messages", "w_rf": "w_rf", "classifier": "classifier"}


@dataclass
class CommLog:
    """Communication record: legacy float counts + exact on-wire bytes.

    ``data_messages``/``w_rf``/``classifier`` count *uploaded floats* exactly
    as the seed's counter did (Table I/II units); ``bytes_by_kind`` counts the
    exact serialized bytes of every message under the active codec, and
    ``messages_by_kind`` the message count.  Seed-replay transfers upload no
    floats (the key is not a float payload) but do cost their O(1) bytes.
    """

    data_messages: int = 0  # Sigma ell floats
    w_rf: int = 0
    classifier: int = 0
    rounds: int = 0
    history: list = field(default_factory=list)
    bytes_by_kind: dict = field(
        default_factory=lambda: {"moments": 0, "w_rf": 0, "classifier": 0}
    )
    messages_by_kind: dict = field(
        default_factory=lambda: {"moments": 0, "w_rf": 0, "classifier": 0}
    )
    rejects_by_kind: dict = field(
        default_factory=lambda: {"moments": 0, "w_rf": 0, "classifier": 0}
    )
    drops_by_kind: dict = field(
        default_factory=lambda: {"moments": 0, "w_rf": 0, "classifier": 0}
    )

    @property
    def total(self) -> int:
        return self.data_messages + self.w_rf + self.classifier

    @property
    def bytes_total(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def rejects_total(self) -> int:
        return sum(self.rejects_by_kind.values())

    @property
    def drops_total(self) -> int:
        return sum(self.drops_by_kind.values())

    def record(self, kind: str, n_floats: int, nbytes: int) -> None:
        setattr(self, KIND_FIELD[kind], getattr(self, KIND_FIELD[kind]) + n_floats)
        self.bytes_by_kind[kind] += nbytes
        self.messages_by_kind[kind] += 1
        reg = get_registry()
        reg.counter("comm.bytes").inc(nbytes, kind=kind)
        reg.counter("comm.messages").inc(kind=kind)
        reg.counter("comm.floats").inc(n_floats, kind=kind)

    def reject(self, kind: str) -> None:
        """One frame failed integrity and was discarded (will retransmit)."""
        self.rejects_by_kind[kind] += 1
        get_registry().counter("comm.rejects").inc(kind=kind)

    def drop(self, kind: str) -> None:
        """One payload was given up on after exhausting its retry budget."""
        self.drops_by_kind[kind] += 1
        get_registry().counter("comm.drops").inc(kind=kind)

    def snapshot(self) -> CommRecord:
        """The ledger as one typed record (see ``repro_torch.obs.records``)."""
        return CommRecord(
            rounds=self.rounds,
            data_messages=self.data_messages,
            w_rf=self.w_rf,
            classifier=self.classifier,
            bytes_by_kind=dict(self.bytes_by_kind),
            messages_by_kind=dict(self.messages_by_kind),
            rejects_by_kind=dict(self.rejects_by_kind),
            drops_by_kind=dict(self.drops_by_kind),
            bytes_total=self.bytes_total,
            floats_total=self.total,
        )


def resolve_codecs(
    default: str = "float32",
    *,
    moments: str | None = None,
    w_rf: str | None = None,
    classifier: str | None = None,
) -> dict[str, Codec]:
    """Per-kind codecs from a default + overrides (see module docstring)."""
    fallback = "float32" if default == "seed_replay" else default
    names = {
        "moments": moments or fallback,
        "w_rf": w_rf or default,
        "classifier": classifier or fallback,
    }
    if names["moments"] == "seed_replay" or names["classifier"] == "seed_replay":
        raise ValueError(
            "seed_replay only applies to seed-derived payloads (w_rf); moments "
            "and classifier contents depend on private data"
        )
    return {k: get_codec(v) for k, v in names.items()}


class Transport:
    """Base: per-kind codecs, a CommLog, deterministic per-message RNG."""

    name = "base"

    def __init__(self, codecs: dict[str, Codec], *, seed: int = 0):
        self.codecs = codecs
        self.log = CommLog()
        self.seed = seed

    @property
    def frozen_w(self) -> bool:
        return self.codecs["w_rf"].name == "seed_replay"

    def _rng(self, msg: wire.Message) -> np.random.Generator:
        """Deterministic stochastic-rounding stream per (seed, round, sender,
        kind, direction) — every payload of a round draws independent bits."""
        return np.random.default_rng(
            (
                self.seed,
                msg.round,
                msg.sender & 0xFFFF,
                wire.KINDS.index(msg.kind),
                1 if msg.downlink else 0,
            )
        )

    def payload_sizes(self, specs: dict[str, dict]) -> dict[str, int]:
        """Exact wire bytes per kind from array specs (for LinkScenario)."""
        return {
            kind: wire.serialized_size(kind, spec, self.codecs[kind])
            for kind, spec in specs.items()
        }

    def _floats_of(self, msg: wire.Message) -> int:
        if self.codecs[msg.kind].name == "seed_replay":
            return 0  # a key is not a float payload
        return int(sum(np.prod(a.shape, dtype=np.int64) for a in msg.arrays.values()))

    def transfer(self, msg: wire.Message) -> dict[str, np.ndarray]:
        raise NotImplementedError

    def account(self, msg: wire.Message) -> None:
        """Record a transfer that happened elsewhere (batched engine's
        in-graph exchange): identical bytes via the analytic size."""
        self.log.record(msg.kind, self._floats_of(msg), msg.nbytes(self.codecs[msg.kind]))

    def account_spec(self, kind: str, specs: dict, *, count: int = 1) -> None:
        """Record ``count`` transfers of a payload known only by shape — the
        batched engine's (and identity transport's) accounting path.  Exact:
        ``wire.serialized_size`` equals ``len(wire.serialize(...))``."""
        codec = self.codecs[kind]
        nbytes = wire.serialized_size(kind, specs, codec)
        floats = (
            0
            if codec.name == "seed_replay"
            else int(sum(np.prod(s, dtype=np.int64) for s, _ in specs.values()))
        )
        for _ in range(count):
            self.log.record(kind, floats, nbytes)

    def channel_fns(self) -> dict[str, Codec] | None:
        """The lossy codecs per kind, whose ``roundtrip`` the batched engine
        applies to its stacked payloads, or None when every codec is the
        identity on values."""
        fns = {}
        for kind, codec in self.codecs.items():
            if self.applies_values and codec.lossy:
                fns[kind] = codec
        return fns or None

    applies_values = False  # does transfer() distort the array values?


class IdentityTransport(Transport):
    """Pass-through values + exact analytic byte accounting (the default)."""

    name = "identity"
    applies_values = False

    def transfer(self, msg: wire.Message) -> dict[str, np.ndarray]:
        self.account(msg)
        return msg.arrays

    def transfer_delta(self, msg: wire.Message, *, link: str) -> dict[str, np.ndarray]:
        return self.transfer(msg)


class WireTransport(Transport):
    """Serialize -> bytes -> deserialize on every transfer; counts len(bytes).

    With a ``fault_injector`` (an object with ``corrupt(kind, data)`` and
    ``max_retries``, such as ``robust.ByteFaultInjector``) installed, each
    frame may be corrupted in flight: the CRC32 envelope check rejects it
    (typed :class:`~repro_torch.comm.wire.WireDecodeError` — never a crash),
    the reject is accounted, and the frame is retransmitted
    up to the injector's ``max_retries``; on give-up :meth:`transfer`
    returns ``None`` and the payload is accounted as a drop, which the
    serial round treats exactly like a lost message.
    """

    name = "wire"
    applies_values = True

    def __init__(self, codecs: dict[str, Codec], *, seed: int = 0, fault_injector=None):
        super().__init__(codecs, seed=seed)
        self._delta_refs: dict[tuple[str, str], dict[str, np.ndarray]] = {}
        self.fault_injector = fault_injector

    def transfer(self, msg: wire.Message) -> dict[str, np.ndarray] | None:
        codec = self.codecs[msg.kind]
        rng = self._rng(msg)
        attempts = 1 + (self.fault_injector.max_retries if self.fault_injector else 0)
        for _ in range(attempts):
            data = wire.serialize(msg, codec, rng=rng)
            if self.fault_injector is not None:
                data = self.fault_injector.corrupt(msg.kind, data)
            # every attempt crosses the wire: retransmits cost real bytes
            self.log.record(msg.kind, self._floats_of(msg), len(data))
            try:
                decoded, _ = wire.deserialize(data)
            except wire.WireDecodeError:
                self.log.reject(msg.kind)
                continue
            return decoded.arrays
        self.log.drop(msg.kind)
        return None

    def transfer_delta(self, msg: wire.Message, *, link: str) -> dict[str, np.ndarray]:
        """Delta-coded transfer for sparsifying codecs (top-k classifier sync).

        Both endpoints of ``link`` hold the reconstruction of the previous
        transfer as the shared reference (zeros initially — the first
        transfer ships the full value as its own delta).  The payload on the
        wire is ``codec(value - ref)``; the receiver reconstructs
        ``ref + decoded`` and both sides roll the reference forward, so
        sparsification error does not accumulate across syncs.  Codecs that
        are exact on the wire (float32) skip the delta detour — ``ref +
        (value - ref)`` would itself cost an ulp.
        """
        if not isinstance(self.codecs[msg.kind], TopKCodec):
            return self.transfer(msg)
        ref = self._delta_refs.get((msg.kind, link))
        if ref is None:
            ref = {k: np.zeros_like(np.asarray(v)) for k, v in msg.arrays.items()}
        delta = wire.Message(
            msg.kind, msg.sender, msg.round,
            {k: np.asarray(v) - ref[k] for k, v in msg.arrays.items()},
            msg.downlink, msg.replay,
        )
        decoded = self.transfer(delta)
        if decoded is None:  # gave up under fault injection: reference unrolled
            return None
        recon = {k: ref[k] + decoded[k] for k in decoded}
        self._delta_refs[(msg.kind, link)] = recon
        return recon


def build_transport(
    name: str,
    codec: str = "float32",
    *,
    seed: int = 0,
    codec_moments: str | None = None,
    codec_w_rf: str | None = None,
    codec_classifier: str | None = None,
) -> Transport:
    codecs = resolve_codecs(
        codec, moments=codec_moments, w_rf=codec_w_rf, classifier=codec_classifier
    )
    if name in ("identity", "none"):
        return IdentityTransport(codecs, seed=seed)
    if name == "wire":
        return WireTransport(codecs, seed=seed)
    raise ValueError(f"unknown transport {name!r} (want 'identity' or 'wire')")
