"""Wire format for FedRF-TCA federated messages (Table I/II made literal).

A copy of ``repro.comm.wire`` over the port's codecs: the same frames, so a
frame serialized by either package deserializes in the other (all but the
``w_rf_init`` seed-replay generator, whose key feeds each package's own
random stream).

The protocol exchanges exactly three payload kinds (paper Alg. 5):

- ``moments``     — the Sigma ell moment vector, 2N floats (eq. 2);
- ``w_rf``        — the (2N, m) aligner W_RF (Alg. 4 FedAvg);
- ``classifier``  — classifier params, (m, C) weight + (C,) bias (every T_C).

A :class:`Message` is a typed envelope around one payload (possibly several
named arrays, e.g. the classifier's w and b); :func:`serialize` produces the
exact on-wire bytes and :func:`deserialize` recovers the arrays through the
payload codec.  :func:`serialized_size` computes the same byte count
analytically — ``len(serialize(msg, codec)) == serialized_size(...)`` is a
tested invariant, which lets the identity transport and the batched engine
do *exact* byte accounting without ever serializing.

Layout (little-endian)::

    magic   4s   b"RFTC"
    version u8
    kind    u8       moments=0 | w_rf=1 | classifier=2
    codec   u8       codecs.Codec.wire_id
    flags   u8       bit0 = downlink
    sender  i16      client id, -1 = server/target
    round   u32
    n_arr   u8
    per array:
      name_len u8, name ascii
      ndim     u8, dims u32 * ndim
      dtype    u8   (logical/decoded dtype)
      plen     u32, payload bytes (codec-specific)
    crc     u32  CRC32 of everything above (integrity trailer, version 2)

Integrity: every frame ends in a CRC32 of the preceding bytes.  A frame that
was bit-flipped, truncated, or replaced in flight fails the check and
:func:`deserialize` raises the typed :class:`WireDecodeError` — transports
reject-and-account (then retransmit) instead of crashing on a raw
``struct.error`` deep inside the parser.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.comm import codecs as codecs_mod
from repro_torch.comm.codecs import Codec, codec_from_wire_id, dtype_id

MAGIC = b"RFTC"
VERSION = 2  # version 1 + CRC32 integrity trailer

KINDS = ("moments", "w_rf", "classifier")
_KIND_IDS = {k: i for i, k in enumerate(KINDS)}

_HEADER = struct.Struct("<4sBBBBhIB")
_CRC = struct.Struct("<I")


class WireDecodeError(ValueError):
    """A frame that cannot be decoded: bad checksum, truncated or garbage
    bytes, unknown magic/version/codec.  Subclasses ValueError so legacy
    ``except ValueError`` call sites keep working."""


@dataclass
class Message:
    """One federated message: a typed payload envelope.

    ``arrays`` maps payload part names to arrays (moments: {"msg"}, w_rf:
    {"w_rf"}, classifier: {"w", "b"}).  ``replay`` carries the (generator,
    key_data) pair for seed-derived payloads (see codecs.SeedReplayCodec).
    """

    kind: str
    sender: int
    round: int
    arrays: dict[str, np.ndarray]
    downlink: bool = False
    replay: tuple[str, np.ndarray] | None = field(default=None, repr=False)

    def __post_init__(self):
        if self.kind not in _KIND_IDS:
            raise ValueError(f"unknown payload kind {self.kind!r}; have {KINDS}")

    def nbytes(self, codec: Codec) -> int:
        return serialized_size(
            self.kind, {k: (v.shape, v.dtype) for k, v in self.arrays.items()}, codec
        )


def _host(a) -> np.ndarray:
    """A payload array on the host (tensors are copied off their device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def moments_message(msg_vec, *, sender: int, round: int, downlink: bool = False) -> Message:
    return Message("moments", sender, round, {"msg": _host(msg_vec)}, downlink)


def w_rf_message(w, *, sender: int, round: int, downlink: bool = False, replay=None) -> Message:
    return Message("w_rf", sender, round, {"w_rf": _host(w)}, downlink, replay)


def classifier_message(clf, *, sender: int, round: int, downlink: bool = False) -> Message:
    return Message(
        "classifier", sender, round,
        {"w": _host(clf["w"]), "b": _host(clf["b"])}, downlink,
    )


def _array_header(name: str, shape: tuple[int, ...], dtype, plen: int) -> bytes:
    nm = name.encode("ascii")
    return (
        struct.pack("<B", len(nm))
        + nm
        + struct.pack("<B", len(shape))
        + struct.pack(f"<{len(shape)}I", *shape)
        + struct.pack("<BI", dtype_id(dtype), plen)
    )


def serialize(msg: Message, codec: Codec, *, rng=None) -> bytes:
    """Exact on-wire bytes of ``msg`` under ``codec``.

    ``rng`` (np.random.Generator) drives stochastic-rounding codecs; pass a
    generator seeded from (seed, round, sender) for deterministic replay.
    """
    out = [
        _HEADER.pack(
            MAGIC, VERSION, _KIND_IDS[msg.kind], codec.wire_id,
            1 if msg.downlink else 0, msg.sender, msg.round, len(msg.arrays),
        )
    ]
    for name, arr in msg.arrays.items():
        arr = np.asarray(arr)
        payload = codec.encode(arr, rng=rng, replay=msg.replay)
        out.append(_array_header(name, arr.shape, arr.dtype, len(payload)))
        out.append(payload)
    body = b"".join(out)
    return body + _CRC.pack(zlib.crc32(body) & 0xFFFFFFFF)


def deserialize(data: bytes) -> tuple[Message, Codec]:
    """Parse wire bytes -> (Message with decoded arrays, codec used).

    Raises :class:`WireDecodeError` on any malformed frame — checksum
    mismatch, truncation, unknown magic/version/codec, trailing garbage.
    """
    try:
        return _parse(data)
    except WireDecodeError:
        raise
    except (struct.error, ValueError, KeyError, IndexError, UnicodeDecodeError) as e:
        raise WireDecodeError(f"malformed frame ({len(data)} bytes): {e}") from e


def _parse(data: bytes) -> tuple[Message, Codec]:
    if len(data) < _HEADER.size + _CRC.size:
        raise WireDecodeError(f"frame too short: {len(data)} bytes")
    body, (crc,) = data[: -_CRC.size], _CRC.unpack_from(data, len(data) - _CRC.size)
    if zlib.crc32(body) & 0xFFFFFFFF != crc:
        raise WireDecodeError("checksum mismatch")
    magic, version, kind_id, codec_id, flags, sender, rnd, n_arr = _HEADER.unpack_from(
        body, 0
    )
    if magic != MAGIC:
        raise WireDecodeError(f"bad magic {magic!r}")
    if version != VERSION:
        raise WireDecodeError(f"wire version {version} != {VERSION}")
    codec = codec_from_wire_id(codec_id)
    off = _HEADER.size
    arrays: dict[str, np.ndarray] = {}
    for _ in range(n_arr):
        (name_len,) = struct.unpack_from("<B", body, off)
        off += 1
        name = body[off : off + name_len].decode("ascii")
        off += name_len
        (ndim,) = struct.unpack_from("<B", body, off)
        off += 1
        shape = struct.unpack_from(f"<{ndim}I", body, off)
        off += 4 * ndim
        dt_id, plen = struct.unpack_from("<BI", body, off)
        off += 5
        arrays[name] = codec.decode(
            body[off : off + plen], tuple(shape), codecs_mod.DTYPE_CODES[dt_id]
        )
        off += plen
    if off != len(body):
        raise WireDecodeError(f"trailing bytes: parsed {off} of {len(body)}")
    if kind_id >= len(KINDS):
        raise WireDecodeError(f"unknown kind id {kind_id}")
    msg = Message(KINDS[kind_id], sender, rnd, arrays, bool(flags & 1))
    return msg, codec


def serialized_size(
    kind: str, specs: dict[str, tuple[tuple[int, ...], np.dtype]], codec: Codec
) -> int:
    """Analytic ``len(serialize(...))`` from shapes alone (no data needed)."""
    total = _HEADER.size + _CRC.size
    for name, (shape, dtype) in specs.items():
        total += 1 + len(name) + 1 + 4 * len(shape) + 5 + codec.nbytes(shape, dtype)
    return total
