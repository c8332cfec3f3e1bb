"""One-shot codec auto-picker: cheapest codec meeting an accuracy budget.

A copy of ``repro.comm.autocodec``: it reads the same ``BENCH_comm.json``
record at the repository root and gives the same picks.

``BENCH_comm.json`` (written by ``benchmarks/run.py --only wire``) measures
the end-to-end accuracy and exact wire bytes of every codec through the real
protocol.  This module turns that record into a decision procedure:

    >>> pick_codec(0.02)          # cheapest codec losing <= 2% accuracy
    'seed_replay'

and wires it into the protocol as ``ProtocolConfig(codec="auto:<budget>")`` —
the trainer resolves the spec against the measured curves once, at
construction, and then runs with a concrete codec (``trainer.resolved_codec``
records the choice).  The accuracy gap is measured against the identity
transport baseline in the same record; candidates are ranked by total bytes
across the three payload kinds.  A negative-gap codec (one that *helped*,
like seed_replay's implicit W freeze often does) always qualifies.
"""
from __future__ import annotations

import json
from pathlib import Path

# repo root: src/repro_torch/comm/autocodec.py -> three parents up from src/
DEFAULT_RECORD_PATH = Path(__file__).resolve().parents[3] / "BENCH_comm.json"


def load_record(path=None) -> dict:
    p = Path(path) if path is not None else DEFAULT_RECORD_PATH
    if not p.exists():
        raise FileNotFoundError(
            f"no codec benchmark record at {p} — run "
            "`PYTHONPATH=src python -m benchmarks.run --only wire` first"
        )
    return json.loads(p.read_text())


def codec_table(record: dict) -> dict[str, dict]:
    """Per-codec {gap, bytes} from a BENCH_comm.json record (gap = identity
    accuracy minus codec accuracy; bytes = total on-wire bytes of its run).

    A record written by an older bench (missing keys, reshaped rows) raises
    a ``ValueError`` naming the rerun command — never a bare ``KeyError``
    deep in a trainer constructor.
    """
    try:
        base = float(record["identity"]["acc"])
        table = {}
        for name, row in record["accuracy_vs_codec"].items():
            table[name] = {
                "gap": base - float(row["acc"]),
                "bytes": int(sum(row["bytes"].values())),
            }
    except (KeyError, TypeError, AttributeError) as exc:
        raise ValueError(
            "BENCH_comm.json record does not match the current schema "
            f"(missing/reshaped field: {exc!r}) — regenerate it with "
            "`PYTHONPATH=src python -m benchmarks.run --only wire`"
        ) from exc
    if not table:
        raise ValueError(
            "BENCH_comm.json record measured no codecs — regenerate it with "
            "`PYTHONPATH=src python -m benchmarks.run --only wire`"
        )
    return table


def pick_codec(budget: float, *, record: dict | None = None, path=None) -> str:
    """Cheapest codec whose measured accuracy gap is within ``budget``.

    ``budget`` is an absolute accuracy allowance (0.02 = may lose up to two
    accuracy points vs the identity transport).  Raises when no measured
    codec fits — a budget below every measured gap is a configuration error,
    not a silent fallback to the most expensive codec.
    """
    if budget < 0:
        raise ValueError(f"accuracy budget must be >= 0, got {budget}")
    table = codec_table(record if record is not None else load_record(path))
    fits = [(row["bytes"], name) for name, row in table.items() if row["gap"] <= budget]
    if not fits:
        gaps = {name: round(row["gap"], 4) for name, row in table.items()}
        raise ValueError(f"no measured codec meets accuracy budget {budget}: gaps {gaps}")
    return min(fits)[1]


def resolve(spec: str, *, record: dict | None = None, path=None) -> str:
    """``"auto:<budget>"`` -> concrete codec name (identity on other specs)."""
    if not spec.startswith("auto:"):
        return spec
    try:
        budget = float(spec.split(":", 1)[1])
    except ValueError as exc:
        raise ValueError(f"bad auto-codec spec {spec!r}: want 'auto:<float budget>'") from exc
    return pick_codec(budget, record=record, path=path)
