"""Payload codec registry for the FedRF-TCA wire format.

Port of ``repro.comm.codecs``.  Every codec has three faces:

- ``encode``/``decode``: host-side numpy serialization, byte for byte the
  reference's (the same bytes for the same array and numpy generator);
- ``nbytes(shape, dtype)``: the analytic encoded size,
  ``len(encode(x)) == nbytes(x.shape, x.dtype)``;
- ``roundtrip(x, u)``: decode(encode(x)) on a *stack* of payloads, a tensor
  x of shape (R, ...) whose rows are R separate payloads (one per client),
  the batched round engine's in-graph channel.  Only the quantizing codecs
  are stochastic (``stochastic = True``); they take uniforms ``u`` of x's
  shape, and ``QuantCodec.roundtrip`` launches the K10 kernel on the card,
  one launch for the whole stack with one absmax scale per row.

Codecs: ``float32``, ``float16``, ``bfloat16``, ``qint8``, ``qint4``,
``topk:<k>`` and ``seed_replay`` (a generator id + raw key replaces the
array).  bfloat16 bytes are made by torch's round-to-nearest-even cast, the
same bytes as the reference's ml_dtypes cast; a payload whose *logical*
dtype is bfloat16 has no numpy dtype here and is refused.
"""
from __future__ import annotations

import struct
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import quantize

# dtype wire codes (logical/decoded dtype of a payload); 2 is bfloat16
DTYPE_CODES: dict[int, np.dtype] = {
    0: np.dtype(np.float32),
    1: np.dtype(np.float16),
    3: np.dtype(np.int8),
    4: np.dtype(np.uint8),
    5: np.dtype(np.int32),
    6: np.dtype(np.uint32),
}
DTYPE_IDS = {v: k for k, v in DTYPE_CODES.items()}


def dtype_id(dtype) -> int:
    try:
        return DTYPE_IDS[np.dtype(dtype)]
    except KeyError as e:
        raise ValueError(f"dtype {dtype} has no wire code") from e


# ---------------------------------------------------------------------------
# seed-replay generator registry (ids in registration order, as the reference)
# ---------------------------------------------------------------------------
REPLAY_GENERATORS: dict[str, Callable] = {}
_REPLAY_IDS: dict[str, int] = {}


def register_replay_generator(name: str, fn: Callable) -> None:
    """``fn(key_data: uint32[2], shape, dtype) -> np.ndarray``, deterministic."""
    if name not in _REPLAY_IDS:
        _REPLAY_IDS[name] = len(_REPLAY_IDS)
    REPLAY_GENERATORS[name] = fn


def _w_rf_init(key_data: np.ndarray, shape, dtype) -> np.ndarray:
    """Replay of ``federated.model.init_params``'s W_RF draw from its key
    (``federated.model.draw_w_rf``, a ``torch.Generator`` stream).  Frames
    of this generator decode only in this package: the reference replays the
    same id from a ``jax.random`` key."""
    from repro_torch.federated.model import draw_w_rf

    return draw_w_rf(key_data, shape, device="cpu").numpy().astype(dtype)


register_replay_generator("w_rf_init", _w_rf_init)


def _omega_fused(key_data: np.ndarray, shape, dtype) -> np.ndarray:
    """Replay of the seed-fused threefry stream: ``key_data = (seed,
    ensemble_index)``, the payload ``kernels.prng.fused_omega``.  The bits
    equal the reference's, so these frames cross between the packages."""
    from repro_torch.kernels.prng import fused_omega

    arr = fused_omega(int(key_data[0]), shape[0], shape[1], ensemble_index=int(key_data[1]),
                      device="cpu")
    return arr.numpy().astype(dtype)


register_replay_generator("omega_fused", _omega_fused)


# ---------------------------------------------------------------------------
# codec base + registry
# ---------------------------------------------------------------------------
class Codec:
    name: str = ""
    wire_id: int = -1
    lossy: bool = False
    stochastic: bool = False  # roundtrip draws on uniforms

    def encode(self, arr: np.ndarray, *, rng=None, replay=None) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes, shape: tuple[int, ...], dtype) -> np.ndarray:
        raise NotImplementedError

    def nbytes(self, shape: tuple[int, ...], dtype) -> int:
        raise NotImplementedError

    def roundtrip(self, x: torch.Tensor, u: torch.Tensor | None = None) -> torch.Tensor:
        """decode(encode(row)) for every row of x (identity when lossless)."""
        return x


class _CastCodec(Codec):
    """Serialize as ``wire_dtype``, decode by casting back."""

    wire_dtype: np.dtype

    def encode(self, arr, *, rng=None, replay=None) -> bytes:
        return np.ascontiguousarray(arr).astype(self.wire_dtype).tobytes()

    def decode(self, data, shape, dtype):
        flat = np.frombuffer(data, dtype=self.wire_dtype)
        return flat.reshape(shape).astype(dtype)

    def nbytes(self, shape, dtype) -> int:
        return int(np.prod(shape, dtype=np.int64)) * self.wire_dtype.itemsize


class Float32Codec(_CastCodec):
    name, wire_id = "float32", 0
    wire_dtype = np.dtype(np.float32)


class Float16Codec(_CastCodec):
    name, wire_id, lossy = "float16", 1, True
    wire_dtype = np.dtype(np.float16)

    def roundtrip(self, x, u=None):
        return x.to(torch.float16).to(x.dtype)


class BFloat16Codec(Codec):
    """bf16 on the wire (2 bytes/elt, round to nearest even)."""

    name, wire_id, lossy = "bfloat16", 2, True

    def encode(self, arr, *, rng=None, replay=None) -> bytes:
        t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()

    def decode(self, data, shape, dtype):
        bits = torch.from_numpy(np.frombuffer(data, dtype=np.int16).copy())
        return bits.view(torch.bfloat16).float().numpy().reshape(shape).astype(dtype)

    def nbytes(self, shape, dtype) -> int:
        return int(np.prod(shape, dtype=np.int64)) * 2

    def roundtrip(self, x, u=None):
        return x.to(torch.bfloat16).to(x.dtype)


def quant_scale(absmax, qmax: int):
    """Per-tensor scale; degenerate all-zero tensors quantize through scale 1."""
    return np.where(absmax > 0, absmax / qmax, 1.0).astype(np.float32)


class QuantCodec(Codec):
    """absmax/qmax per-tensor scale + unbiased stochastic rounding
    ``q = clip(floor(x/scale + u), -qmax, qmax)`` with ``u ~ U[0,1)``.

    Wire layout: f32 scale, then int8 codes (qint8) or two 4-bit codes per
    byte, low nibble first (qint4).  The codes depend only on the array and
    the numpy generator, so they equal the reference's.
    """

    lossy = True
    stochastic = True

    def __init__(self, bits: int):
        if bits not in (4, 8):
            raise ValueError(f"QuantCodec: bits must be 4 or 8, got {bits}")
        self.bits = bits
        self.qmax = (1 << (bits - 1)) - 1
        self.name = f"qint{bits}"
        self.wire_id = 3 if bits == 8 else 4

    def _codes(self, arr, rng) -> tuple[np.ndarray, np.float32]:
        x = np.ascontiguousarray(arr, dtype=np.float32).ravel()
        scale = quant_scale(np.max(np.abs(x), initial=0.0), self.qmax)
        u = rng.random(x.shape, dtype=np.float32) if rng is not None else 0.5
        q = np.clip(np.floor(x / scale + u), -self.qmax, self.qmax)
        return q.astype(np.int8), scale

    def encode(self, arr, *, rng=None, replay=None) -> bytes:
        q, scale = self._codes(arr, rng)
        if self.bits == 8:
            packed = q.tobytes()
        else:
            v = (q.astype(np.int16) + 8).astype(np.uint8)  # [0, 15]
            if v.size % 2:
                v = np.concatenate([v, np.zeros((1,), np.uint8)])
            packed = ((v[1::2] << 4) | v[0::2]).tobytes()
        return struct.pack("<f", float(scale)) + packed

    def decode(self, data, shape, dtype):
        (scale,) = struct.unpack_from("<f", data, 0)
        size = int(np.prod(shape, dtype=np.int64))
        if self.bits == 8:
            q = np.frombuffer(data, np.int8, count=size, offset=4)
        else:
            b = np.frombuffer(data, np.uint8, offset=4)
            v = np.empty((b.size * 2,), np.uint8)
            v[0::2] = b & 0x0F
            v[1::2] = b >> 4
            q = v[:size].astype(np.int16) - 8
        return (q.astype(np.float32) * scale).reshape(shape).astype(dtype)

    def nbytes(self, shape, dtype) -> int:
        size = int(np.prod(shape, dtype=np.int64))
        return 4 + (size if self.bits == 8 else (size + 1) // 2)

    def roundtrip(self, x, u=None):
        """K10 on the card (one launch for the stack, one scale per row);
        its plain version on the CPU.  ``u=None`` rounds half up."""
        return quantize.fake_quant_rows(x, u, bits=self.bits)


class TopKCodec(Codec):
    """Magnitude top-k sparsification: u32 k, k u32 flat indices, k f32 values.

    ``k`` is a kept fraction when the parameter is <= 1 (``topk:0.25``) and
    an absolute count otherwise (``topk:64``).
    """

    lossy = True
    wire_id = 5

    def __init__(self, param: float = 0.25):
        self.param = param
        self.name = f"topk:{param:g}"

    def k_of(self, size: int) -> int:
        k = int(round(self.param * size)) if self.param <= 1 else int(self.param)
        return max(1, min(k, size))

    def encode(self, arr, *, rng=None, replay=None) -> bytes:
        x = np.ascontiguousarray(arr, dtype=np.float32).ravel()
        k = self.k_of(x.size)
        idx = np.sort(np.argpartition(np.abs(x), x.size - k)[x.size - k :])
        return (
            struct.pack("<I", k)
            + idx.astype(np.uint32).tobytes()
            + x[idx].astype(np.float32).tobytes()
        )

    def decode(self, data, shape, dtype):
        (k,) = struct.unpack_from("<I", data, 0)
        idx = np.frombuffer(data, np.uint32, count=k, offset=4)
        val = np.frombuffer(data, np.float32, count=k, offset=4 + 4 * k)
        out = np.zeros(int(np.prod(shape, dtype=np.int64)), np.float32)
        out[idx] = val
        return out.reshape(shape).astype(dtype)

    def nbytes(self, shape, dtype) -> int:
        return 4 + 8 * self.k_of(int(np.prod(shape, dtype=np.int64)))

    def roundtrip(self, x, u=None):
        flat = x.to(torch.float32).reshape(x.shape[0], -1)
        idx = torch.topk(flat.abs(), self.k_of(flat.shape[1]), dim=1).indices
        out = torch.zeros_like(flat).scatter(1, idx, flat.gather(1, idx))
        return out.reshape(x.shape).to(x.dtype)


class SeedReplayCodec(Codec):
    """O(1) wire: a generator id + raw uint32[2] key replaces the array.

    The sender supplies ``replay=(generator_name, key_data)``; the receiver
    re-derives the payload through ``REPLAY_GENERATORS[name]``.  Decodes are
    memoized (a replayed payload is a pure function of its 9 bytes, shape and
    dtype); ``regenerations`` counts the generator calls.
    """

    wire_id = 6
    name = "seed_replay"

    _cache: dict[tuple, np.ndarray] = {}
    _CACHE_MAX = 64
    regenerations: int = 0

    def encode(self, arr, *, rng=None, replay=None) -> bytes:
        if replay is None:
            raise ValueError(
                "seed_replay codec needs replay=(generator, key_data); payload "
                f"of shape {getattr(arr, 'shape', None)} is not seed-derived"
            )
        gen, key_data = replay
        key = np.ascontiguousarray(key_data, dtype=np.uint32)
        if key.size != 2:
            raise ValueError(f"expected a raw (2,) uint32 key, got {key.shape}")
        return struct.pack("<B", _REPLAY_IDS[gen]) + key.tobytes()

    def decode(self, data, shape, dtype):
        cls = SeedReplayCodec
        cache_key = (bytes(data[:9]), tuple(shape), np.dtype(dtype).str)
        hit = cls._cache.get(cache_key)
        if hit is not None:
            return hit
        (gen_id,) = struct.unpack_from("<B", data, 0)
        key = np.frombuffer(data, np.uint32, count=2, offset=1)
        name = {v: k for k, v in _REPLAY_IDS.items()}[gen_id]
        arr = np.array(REPLAY_GENERATORS[name](key, shape, np.dtype(dtype)))
        arr.setflags(write=False)
        cls.regenerations += 1
        if len(cls._cache) >= cls._CACHE_MAX:
            cls._cache.pop(next(iter(cls._cache)))
        cls._cache[cache_key] = arr
        return arr

    def nbytes(self, shape, dtype) -> int:
        return 1 + 8  # generator id + raw uint32[2] key, shape-independent


_FACTORIES: dict[str, Callable[..., Codec]] = {
    "float32": Float32Codec,
    "float16": Float16Codec,
    "bfloat16": BFloat16Codec,
    "qint8": lambda: QuantCodec(8),
    "qint4": lambda: QuantCodec(4),
    "topk": TopKCodec,
    "seed_replay": SeedReplayCodec,
}
_WIRE_IDS = {0: "float32", 1: "float16", 2: "bfloat16", 3: "qint8", 4: "qint4",
             5: "topk", 6: "seed_replay"}


def get_codec(spec: str) -> Codec:
    """``get_codec("qint8")``, ``get_codec("topk:0.1")``: name[:param]."""
    name, _, param = spec.partition(":")
    if name not in _FACTORIES:
        raise ValueError(f"unknown codec {spec!r}; have {sorted(_FACTORIES)}")
    return _FACTORIES[name](float(param)) if param else _FACTORIES[name]()


def codec_names() -> list[str]:
    return sorted(_FACTORIES)


def codec_from_wire_id(wire_id: int) -> Codec:
    return get_codec(_WIRE_IDS[wire_id])
