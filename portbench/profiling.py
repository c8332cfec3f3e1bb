"""The traced window and what the metric readers take from it.

Follows the window and kernel grouping of the port's
``scripts/device_profile.py`` (``torch.profiler`` over CPU and CUDA activity,
kernels grouped by name), with two changes: the device's busy time is the
union of its operations' intervals, so kernels that overlap count once, and
the window is a ``record_function`` span of the benchmark's own, on the same
clock as the kernels.

A layer's device time counts every kernel in whose name one of the layer's
patterns (``layers/<name>.json``) is a part, whatever other layer claims it
too.  ``breakdown`` labels a kernel with the first of the cell's layers that
claims it, otherwise ``other``.  An idle gap is named by what the host was
doing across its midpoint: the innermost operation on the window's thread (a
CUDA runtime call with the operation it serves), or ``host`` between
operations.
"""
from __future__ import annotations

from portbench.spec import layer_patterns

WINDOW = "portbench.window"


class Tracer:
    """Starts and stops the profiler around a sub-window of the run.  Made in
    set-up: a first, empty profile there takes the profiler's own start-up
    (CUPTI's, seconds) out of the window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=activities):
            pass
        self._prof = profile(activities=activities)
        self._span = record_function(WINDOW)

    def start(self) -> None:
        self._prof.start()
        self._span.__enter__()

    def stop(self, layers: dict[str, list[str]]) -> "TraceView":
        self._span.__exit__(None, None, None)
        self._prof.stop()
        return TraceView.from_events(self._prof.events(), layers)


def _is_device(ev) -> bool:
    return str(ev.device_type).endswith("CUDA")


def union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Merge (start, end) intervals into disjoint ones, in order."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def layer_of(name: str, layers: dict[str, list[str]]) -> str:
    for layer, patterns in layers.items():
        if any(p in name for p in patterns):
            return layer
    return "other"


class TraceView:
    """Device operations and host operations of the traced window, in
    microseconds on the profiler's clock."""

    def __init__(self, window, device_ops, host_ops, layers):
        self.w0, self.w1 = window
        self.device_ops = device_ops  # (name, start, end), clipped to the window
        self.host_ops = host_ops  # (name, start, end) on the window's thread
        self.layers = layers
        self.busy = union([(s, e) for _, s, e in device_ops])
        self.work: dict = {}  # the loop's work in the window, set by the harness
        self.counts: dict = {}  # portbench.counts.for_config of the cell
        self.peak: dict | None = None  # portbench.counts.PEAKS' entry of the card

    @classmethod
    def from_events(cls, events, layers) -> "TraceView":
        spans = [e for e in events if e.name == WINDOW and not _is_device(e)]
        if not spans:
            raise RuntimeError("the profiler recorded no window span")
        win = spans[0]
        w0, w1 = win.time_range.start, win.time_range.end
        dev, host = [], []
        for e in events:
            s, t = e.time_range.start, e.time_range.end
            if _is_device(e):
                if e.name == WINDOW:  # the span's own mark on the device's timeline
                    continue
                s, t = max(s, w0), min(t, w1)
                if t > s:
                    dev.append((e.name, s, t))
            elif e is not win and e.thread == win.thread and t > w0 and s < w1:
                host.append((e.name, s, t))
        return cls((w0, w1), dev, host, layers)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def layer_seconds(self, layer: str) -> float:
        """Device seconds of the window's kernels that ``layers/<layer>.json``
        claims."""
        patterns = layer_patterns(layer)
        return sum(e - s for n, s, e in self.device_ops if any(p in n for p in patterns)) * 1e-6

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.w0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.w1 > t:
            out.append((t, self.w1))
        return out

    def host_labels(self, points: list[float]) -> list[str]:
        """What the host was doing at each of ``points`` (ascending)."""
        ops = sorted(self.host_ops, key=lambda o: (o[1], -o[2]))
        stack: list[tuple[str, float, float]] = []
        labels, i = [], 0
        for p in points:
            while i < len(ops) and ops[i][1] <= p:
                while stack and stack[-1][2] <= ops[i][1]:
                    stack.pop()
                stack.append(ops[i])
                i += 1
            while stack and stack[-1][2] < p:
                stack.pop()
            if not stack:
                labels.append("host")
                continue
            name = stack[-1][0]
            if name.startswith("cu") and len(stack) > 1:
                name = f"{stack[-2][0]} > {name}"
            labels.append(name)
        return labels

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time (by layer and kernel) and
        the idle time by what the host was doing, seconds in the window."""
        ops: dict[str, float] = {}
        for n, s, e in self.device_ops:
            short = n[:100]
            key = f"{layer_of(n, self.layers)}: {short}"
            ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
        gaps = self.gaps()
        idle: dict[str, float] = {}
        for (s, e), label in zip(gaps, self.host_labels([(s + e) / 2 for s, e in gaps])):
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
