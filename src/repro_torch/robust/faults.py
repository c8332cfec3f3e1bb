"""Fault injection for the federated protocol: the chaos half of ``robust``.

Port of ``repro.robust.faults``.  Three fault surfaces:

- **Value-level payload corruption** (the batched engine): a message that
  arrives may arrive wrong.  :func:`build_fault_plan` turns a
  :class:`FaultConfig` into per-kind corruptors applied to the stacked
  (K, ...) uplinks after the channel: bit flips (on an ``int32`` view, bit
  31 the sign), scaled payloads, sign flips, NaN injection and truncated
  (zero-tail) payloads, each firing per message with the kind's rate.
- **Byzantine clients**: persistent adversaries whose uplinks are replaced
  by crafted ones (sign-flipped, boosted, random or NaN).
- **Byte-level frame corruption** (the serial wire plane):
  :class:`ByteFaultInjector` (numpy, copied) corrupts serialized frames; the
  CRC32 envelope rejects them and the transport retransmits or drops.

Randomness: the reference draws from ``jax.random`` keys inside its compiled
round.  Here every draw of a plan (gates, element indices, bits, offsets,
Byzantine noise) comes from :meth:`FaultPlan.draws`, keyed by ``(seed,
chan_key, path)`` like ``BatchedRoundEngine.channel_uniforms``, on a CPU
generator moved to the device, so the card and the CPU see the same faults
and a test can put the reference's own draws in its place.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

VALUE_MODES = ("bit_flip", "scale", "sign_flip", "nan", "truncate")
BYZANTINE_MODES = ("sign_flip", "scale", "random", "nan")
BYTE_MODES = ("bit_flip", "truncate", "garbage")


@dataclass
class FaultConfig:
    """One knob set for every fault surface (zero rates and no Byzantine
    clients: no faults at all, and the trainer runs the fault-free round).

    ``corrupt_*`` are per-uplink corruption probabilities per payload kind;
    ``corruption`` picks the value-level model (``VALUE_MODES``).  On the
    serial wire plane the same rates drive :class:`ByteFaultInjector`
    (value-only modes become ``bit_flip``).  ``byzantine`` lists adversarial
    client ids whose uplinks are ``byzantine_mode``-crafted every round.
    """

    corrupt_moments: float = 0.0
    corrupt_w_rf: float = 0.0
    corrupt_classifier: float = 0.0
    corruption: str = "bit_flip"
    corruption_scale: float = 100.0  # factor for mode "scale"
    byzantine: tuple[int, ...] = ()
    byzantine_mode: str = "sign_flip"
    byzantine_scale: float = 10.0  # factor for byzantine "scale"/"random"
    max_retries: int = 8  # byte-plane retransmit budget
    seed: int = 0

    def __post_init__(self):
        if self.corruption not in VALUE_MODES:
            raise ValueError(f"unknown corruption mode {self.corruption!r}; have {VALUE_MODES}")
        if self.byzantine_mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown byzantine mode {self.byzantine_mode!r}; "
                             f"have {BYZANTINE_MODES}")
        for name in ("corrupt_moments", "corrupt_w_rf", "corrupt_classifier"):
            rate = getattr(self, name)
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")

    @property
    def rates(self) -> dict[str, float]:
        return {"moments": self.corrupt_moments, "w_rf": self.corrupt_w_rf,
                "classifier": self.corrupt_classifier}

    @property
    def is_noop(self) -> bool:
        return not self.byzantine and all(r == 0.0 for r in self.rates.values())


# ---------------------------------------------------------------------------
# value-level corruptors and Byzantine crafts, over stacked rows (K, ...)
# ---------------------------------------------------------------------------

# which per-row draws each corruption mode reads (besides the gate)
_MODE_DRAWS = {"bit_flip": ("index", "bit"), "nan": ("index",), "truncate": ("offset",),
               "scale": (), "sign_flip": ()}


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def _bit_flip(x, dr):
    """Flip bit ``bit[k]`` of element ``index[k]`` of row k (float32 as int32)."""
    flat = _rows(x).to(torch.float32).contiguous()
    ints = flat.view(torch.int32)
    mask = torch.bitwise_left_shift(torch.ones_like(dr["bit"]), dr["bit"])  # int64, up to 2^31
    mask = torch.where(mask >= 2**31, mask - 2**32, mask).to(torch.int32)
    idx = dr["index"][:, None]
    flipped = ints.scatter(1, idx, torch.bitwise_xor(ints.gather(1, idx), mask[:, None]))
    return flipped.view(torch.float32).reshape(x.shape).to(x.dtype)


def _nan_inject(x, dr):
    flat = _rows(x)
    return flat.scatter(1, dr["index"][:, None], float("nan")).reshape(x.shape)


def _truncate(x, dr):
    """Zero each row's tail from offset ``offset[k]`` (a frame cut mid-flight,
    decoded anyway because nobody checked integrity)."""
    flat = _rows(x)
    keep = torch.arange(flat.shape[1], device=x.device)[None, :] < dr["offset"][:, None]
    return torch.where(keep, flat, torch.zeros_like(flat)).reshape(x.shape)


@dataclass
class Corruptor:
    """``fn(rows (K, ...), draws) -> rows``: row k is corrupted by ``mode``
    where its gate (uniform < ``rate``) is open."""

    mode: str
    rate: float
    scale: float = 100.0

    def __post_init__(self):
        if self.mode not in VALUE_MODES:
            raise ValueError(f"unknown corruption mode {self.mode!r}")

    def hit(self, x, dr):
        if self.mode == "bit_flip":
            return _bit_flip(x, dr)
        if self.mode == "scale":
            return x * self.scale
        if self.mode == "sign_flip":
            return -x
        if self.mode == "nan":
            return _nan_inject(x, dr)
        return _truncate(x, dr)

    def __call__(self, x, dr):
        gate = (dr["gate"] < self.rate).reshape((-1,) + (1,) * (x.ndim - 1))
        return torch.where(gate, self.hit(x, dr), x)


def make_corruptor(mode: str, rate: float, scale: float) -> Corruptor:
    """``fn(rows, draws) -> rows`` corrupting each row with probability ``rate``."""
    return Corruptor(mode, rate, scale)


@dataclass
class ByzantineCraft:
    """``fn(rows (K, ...), draws) -> rows``: the adversary's crafted payloads
    in place of the honest ones."""

    mode: str
    scale: float = 10.0

    def __post_init__(self):
        if self.mode not in BYZANTINE_MODES:
            raise ValueError(f"unknown byzantine mode {self.mode!r}")

    def __call__(self, x, dr):
        if self.mode == "sign_flip":
            return -x  # the classic gradient-reversal attack
        if self.mode == "scale":
            return x * self.scale  # model boosting
        if self.mode == "nan":
            return torch.full_like(x, float("nan"))
        noise = dr["noise"]
        norm = torch.linalg.vector_norm(_rows(x), dim=1)
        noise_norm = torch.clamp_min(torch.linalg.vector_norm(_rows(noise), dim=1), 1e-12)
        return noise * (self.scale * norm / noise_norm).reshape((-1,) + (1,) * (x.ndim - 1))


def make_byzantine_craft(mode: str, scale: float) -> ByzantineCraft:
    return ByzantineCraft(mode, scale)


def _generator(seed: int, chan_key: int, path: tuple[int, ...]) -> torch.Generator:
    words = [seed & 0xFFFFFFFF, int(chan_key) & 0xFFFFFFFF, *path]
    state = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0]) >> 1
    return torch.Generator().manual_seed(state)


@dataclass
class FaultPlan:
    """The engine's fault surface: per-kind corruptors and the Byzantine
    mask and craft.  Built by :func:`build_fault_plan`; ``None`` when the
    config is a no-op."""

    corruptors: dict = field(default_factory=dict)  # kind -> Corruptor
    byz_mask: torch.Tensor | None = None  # (K,) 0/1 floats
    craft: ByzantineCraft | None = None
    seed: int = 0

    def draws(self, kind: str, chan_key: int, path: tuple[int, ...], n_rows: int,
              shape: tuple[int, ...], device) -> dict[str, torch.Tensor]:
        """Every random number of one fault pass over (n_rows, *shape), from a
        CPU generator seeded by (seed, chan_key, path), in this order: the
        gates (n_rows,) uniforms, then what the mode reads (element ``index``
        in [0, size), ``bit`` in [0, 32), ``offset`` in [1, size)), then the
        Byzantine ``noise`` (n_rows, *shape) standard normals.  The gates come
        first, so payloads of one message (classifier ``b`` and ``w``, one
        path) share them."""
        gen = _generator(self.seed, chan_key, path)
        size = int(np.prod(shape, dtype=np.int64))
        out = {}
        fn = self.corruptors.get(kind)
        if fn is not None:
            out["gate"] = torch.rand((n_rows,), generator=gen)
            for name in _MODE_DRAWS[fn.mode]:
                lo, hi = {"index": (0, size), "bit": (0, 32), "offset": (1, max(size, 2))}[name]
                out[name] = torch.randint(lo, hi, (n_rows,), generator=gen)
        if self.craft is not None and self.craft.mode == "random":
            out["noise"] = torch.randn((n_rows, *shape), generator=gen)
        return {k: v.to(device) for k, v in out.items()}

    def apply(self, kind: str, rows: torch.Tensor, chan_key: int,
              path: tuple[int, ...]) -> torch.Tensor:
        """The fault pass over stacked (K, ...) uplinks: Byzantine rows are
        replaced by crafted ones, then the kind's corruption fires per
        message."""
        fn = self.corruptors.get(kind)
        if self.byz_mask is None and fn is None:
            return rows
        dr = self.draws(kind, chan_key, path, rows.shape[0], tuple(rows.shape[1:]), rows.device)
        if self.byz_mask is not None:
            sel = self.byz_mask.to(rows.device).reshape((-1,) + (1,) * (rows.ndim - 1)) > 0
            rows = torch.where(sel, self.craft(rows, dr), rows)
        if fn is not None:
            rows = fn(rows, dr)
        return rows


def build_fault_plan(cfg: FaultConfig | None, k: int, *, seed: int = 0) -> FaultPlan | None:
    """FaultConfig -> FaultPlan for a K-client stacked engine (None if no-op);
    ``seed`` keys the plan's draws (the trainer passes its channel seed)."""
    if cfg is None or cfg.is_noop:
        return None
    bad = [i for i in cfg.byzantine if not 0 <= i < k]
    if bad:
        raise ValueError(f"byzantine ids {bad} out of range for K={k}")
    corruptors = {kind: make_corruptor(cfg.corruption, rate, cfg.corruption_scale)
                  for kind, rate in cfg.rates.items() if rate > 0.0}
    byz_mask, craft = None, None
    if cfg.byzantine:
        m = np.zeros((k,), np.float32)
        m[list(cfg.byzantine)] = 1.0
        byz_mask = torch.from_numpy(m)
        craft = make_byzantine_craft(cfg.byzantine_mode, cfg.byzantine_scale)
    return FaultPlan(corruptors=corruptors, byz_mask=byz_mask, craft=craft, seed=seed)


# ---------------------------------------------------------------------------
# byte-level frame corruption (the serial wire plane; numpy, copied)
# ---------------------------------------------------------------------------


@dataclass
class ByteFaultInjector:
    """Corrupts serialized frames between serialize and deserialize.

    ``rates`` maps payload kind -> per-frame corruption probability; every
    corrupted frame fails the CRC32 envelope check and surfaces as a typed
    ``WireDecodeError``, which the transport turns into reject -> retransmit
    -> (after ``max_retries``) drop.
    """

    rates: dict[str, float] = field(default_factory=dict)
    mode: str = "bit_flip"
    max_retries: int = 8
    seed: int = 0

    def __post_init__(self):
        if self.mode not in BYTE_MODES:
            raise ValueError(f"unknown byte mode {self.mode!r}; have {BYTE_MODES}")
        self._rng = np.random.default_rng(self.seed)

    @classmethod
    def from_config(cls, cfg: FaultConfig) -> "ByteFaultInjector":
        mode = cfg.corruption if cfg.corruption in BYTE_MODES else "bit_flip"
        return cls(rates=dict(cfg.rates), mode=mode, max_retries=cfg.max_retries,
                   seed=cfg.seed)

    def corrupt(self, kind: str, data: bytes) -> bytes:
        rate = self.rates.get(kind, 0.0)
        if rate <= 0.0 or self._rng.random() >= rate:
            return data
        buf = bytearray(data)
        if self.mode == "bit_flip":
            i = int(self._rng.integers(len(buf)))
            buf[i] ^= 1 << int(self._rng.integers(8))
            return bytes(buf)
        if self.mode == "truncate":
            return bytes(buf[: int(self._rng.integers(1, max(len(buf), 2)))])
        return self._rng.integers(0, 256, size=len(buf), dtype=np.uint8).tobytes()
