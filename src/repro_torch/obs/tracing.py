"""Span tracing on virtual or wall-clock time, exported as Chrome trace JSON.

Port of ``repro.obs.tracing`` (pure Python; the same events and JSON).

The fedsim runtime's whole point is that *time itself* is simulated — a
churn-under-straggler run is a sequence of dispatch / uplink / flush /
crash / recovery episodes on the :class:`repro_torch.fedsim.clock.VirtualClock`.
This module turns those episodes into Chrome trace-event JSON (the
``{"traceEvents": [...]}`` format) viewable in Perfetto (https://ui.perfetto.dev)
or ``chrome://tracing``, so the timeline becomes *readable* instead of a list
of history rows.

Two time bases share one :class:`Tracer`:

- **virtual time** — the schedulers pass explicit ``ts`` seconds from their
  VirtualClock; these land in the ``pid=2`` ("virtual time") track.
- **wall clock** — :meth:`Tracer.span` (a context manager) stamps
  ``time.perf_counter`` relative to the tracer's birth; these land in
  ``pid=1`` ("wall clock").

Event vocabulary (all milliseconds-displayed, microsecond ``ts`` as the
format requires):

- ``begin``/``end`` — a ``ph: "B"``/``"E"`` span pair on one ``(pid, tid)``
  lane.  Pairs must nest per lane; :func:`validate_trace` enforces balance
  and per-pair monotone timestamps (the CI bench-smoke gate).
- ``complete`` — one ``ph: "X"`` event with an explicit duration (used for
  client compute/uplink episodes whose extent is known at emission).
- ``instant`` — ``ph: "i"`` markers (flush, checkpoint, crash, eval).

Determinism: a tracer fed only virtual-time events from the deterministic
fedsim event loop serializes to byte-identical JSON across runs — the
trace-determinism test pins that.
"""
from __future__ import annotations

import contextlib
import json
import time

PID_WALL = 1
PID_VIRTUAL = 2
_PROCESS_NAMES = {PID_WALL: "wall clock", PID_VIRTUAL: "virtual time"}


class Tracer:
    """Collects trace events; export with :meth:`to_json` / :meth:`write`."""

    def __init__(self):
        self.events: list[dict] = []
        self._wall0 = time.perf_counter()

    # -- low-level emission (explicit timestamps, virtual-time track) --------

    @staticmethod
    def _us(ts_seconds: float) -> float:
        return round(float(ts_seconds) * 1e6, 3)

    def _emit(self, ph: str, name: str, ts: float, *, pid: int, tid: int,
              args: dict | None = None, **extra) -> None:
        ev = {"name": name, "ph": ph, "ts": self._us(ts), "pid": pid, "tid": tid}
        if args:
            ev["args"] = args
        ev.update(extra)
        self.events.append(ev)

    def begin(self, name: str, ts: float, *, tid: int = 0, pid: int = PID_VIRTUAL,
              args: dict | None = None) -> None:
        self._emit("B", name, ts, pid=pid, tid=tid, args=args)

    def end(self, name: str, ts: float, *, tid: int = 0, pid: int = PID_VIRTUAL,
            args: dict | None = None) -> None:
        self._emit("E", name, ts, pid=pid, tid=tid, args=args)

    def complete(self, name: str, ts: float, dur: float, *, tid: int = 0,
                 pid: int = PID_VIRTUAL, args: dict | None = None) -> None:
        if dur < 0:
            raise ValueError(f"span {name!r}: negative duration {dur}")
        self._emit("X", name, ts, pid=pid, tid=tid, args=args, dur=self._us(dur))

    def instant(self, name: str, ts: float, *, tid: int = 0, pid: int = PID_VIRTUAL,
                args: dict | None = None) -> None:
        # scope "t": thread-local marker (renders as a tick on the lane)
        self._emit("i", name, ts, pid=pid, tid=tid, args=args, s="t")

    def wall_now(self) -> float:
        """Seconds since this tracer's birth — the wall-clock timestamp base
        explicit emitters (request tracing, admission legs) share with
        :meth:`span`."""
        return time.perf_counter() - self._wall0

    # -- wall-clock spans (context manager; benches / non-sim paths) ---------

    @contextlib.contextmanager
    def span(self, name: str, *, tid: int = 0, args: dict | None = None):
        """Wall-clock ``B``/``E`` pair around a ``with`` block."""
        self.begin(name, time.perf_counter() - self._wall0, tid=tid,
                   pid=PID_WALL, args=args)
        try:
            yield self
        finally:
            self.end(name, time.perf_counter() - self._wall0, tid=tid, pid=PID_WALL)

    # -- export --------------------------------------------------------------

    def trace_events(self) -> list[dict]:
        """All events plus process-name metadata for the two time tracks."""
        pids = {ev["pid"] for ev in self.events}
        meta = [
            {
                "name": "process_name", "ph": "M", "pid": pid, "tid": 0, "ts": 0,
                "args": {"name": _PROCESS_NAMES.get(pid, f"pid {pid}")},
            }
            for pid in sorted(pids)
        ]
        return meta + self.events

    def to_json(self) -> str:
        return json.dumps(
            {"traceEvents": self.trace_events(), "displayTimeUnit": "ms"}
        )

    def write(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


# -- the process-wide default tracer (None = tracing off) ---------------------

_TRACER: Tracer | None = None


def get_tracer() -> Tracer | None:
    return _TRACER


def set_tracer(tracer: Tracer | None) -> None:
    global _TRACER
    _TRACER = tracer


@contextlib.contextmanager
def use_tracer(tracer: Tracer | None = None):
    """Scoped tracing: installs ``tracer`` (a fresh one when None), yields
    it, restores the previous tracer on exit."""
    t = Tracer() if tracer is None else tracer
    prev = _TRACER
    set_tracer(t)
    try:
        yield t
    finally:
        set_tracer(prev)


# -- schema validation (the CI bench-smoke contract) --------------------------

_REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


def validate_trace(events: list[dict]) -> list[str]:
    """Chrome trace-event schema violations (empty list == valid).

    Checks the contract the CI smoke gates: every event carries
    ``name``/``ph``/``ts``/``pid``/``tid``; ``B``/``E`` pairs balance per
    ``(pid, tid)`` lane with monotone (end >= begin) timestamps and matching
    names; ``X`` events carry a non-negative ``dur``.
    """
    errors: list[str] = []
    stacks: dict[tuple, list[dict]] = {}
    for i, ev in enumerate(events):
        missing = [k for k in _REQUIRED_KEYS if k not in ev]
        if missing:
            errors.append(f"event {i}: missing keys {missing}")
            continue
        ph, lane = ev["ph"], (ev["pid"], ev["tid"])
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] != ev["ts"]:
            errors.append(f"event {i} ({ev['name']!r}): bad ts {ev['ts']!r}")
            continue
        if ph == "B":
            stacks.setdefault(lane, []).append(ev)
        elif ph == "E":
            stack = stacks.get(lane)
            if not stack:
                errors.append(f"event {i}: E {ev['name']!r} with no open B on {lane}")
                continue
            b = stack.pop()
            if b["name"] != ev["name"]:
                errors.append(
                    f"event {i}: E {ev['name']!r} closes B {b['name']!r} on {lane}"
                )
            if ev["ts"] < b["ts"]:
                errors.append(
                    f"event {i}: span {ev['name']!r} ends at {ev['ts']} before "
                    f"its begin {b['ts']} (non-monotone pair)"
                )
        elif ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or ev["dur"] < 0:
                errors.append(f"event {i}: X {ev['name']!r} bad dur {ev.get('dur')!r}")
    for lane, stack in stacks.items():
        for b in stack:
            errors.append(f"unclosed B {b['name']!r} on lane {lane}")
    return errors


_REQUEST_ROOT = "serve.request"
_REQUEST_LEGS = ("serve.queue_wait", "serve.batch_assembly", "serve.padded_dispatch")
_TREE_TOL_US = 0.5  # containment slack: ts are microseconds rounded to 3 dp


def count_request_trees(events: list[dict]) -> int:
    """Complete per-request span trees in ``events`` (the smoke gate).

    A tree is one ``(pid, tid, args.trace_id)`` lane holding a
    ``serve.request`` root ``X`` span plus all three serving legs
    (queue-wait, batch-assembly, padded-dispatch) as ``X`` spans contained
    in the root's interval — the shape the reference's ``repro.obs.reqtrace.
    RequestTracer`` emits on the virtual-time track.
    """
    groups: dict[tuple, list[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        trace_id = (ev.get("args") or {}).get("trace_id")
        if trace_id is None:
            continue
        groups.setdefault((ev.get("pid"), ev.get("tid"), trace_id), []).append(ev)
    trees = 0
    for evs in groups.values():
        roots = [e for e in evs if e.get("name") == _REQUEST_ROOT]
        if not roots:
            continue
        lo = roots[0]["ts"] - _TREE_TOL_US
        hi = roots[0]["ts"] + roots[0].get("dur", 0) + _TREE_TOL_US
        legs = {
            e["name"] for e in evs
            if e.get("name") in _REQUEST_LEGS
            and e["ts"] >= lo and e["ts"] + e.get("dur", 0) <= hi
        }
        if legs.issuperset(_REQUEST_LEGS):
            trees += 1
    return trees


def validate_trace_file(path, *, require_request_trees: int = 0) -> list[str]:
    """Validate an exported trace JSON file (shape + event schema).

    ``require_request_trees > 0`` additionally demands that many complete
    per-request span trees (:func:`count_request_trees`) — the serving
    observability gate on ``trace_obs.json``.
    """
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f"{path}: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list) or not events:
        return [f"{path}: no traceEvents array"]
    real = [ev for ev in events if ev.get("ph") != "M"]
    errors = [f"{path}: {msg}" for msg in validate_trace(real)]
    if require_request_trees > 0:
        trees = count_request_trees(real)
        if trees < require_request_trees:
            errors.append(
                f"{path}: {trees} complete request span tree(s), "
                f"need >= {require_request_trees}"
            )
    return errors
