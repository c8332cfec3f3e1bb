"""Domain-drift monitoring in RFF moment space, driving aligner refresh.

A copy of ``repro.obs.drift`` (numpy on host moments, as the reference).

The paper's central statistic doubles as the production drift signal: the
RF-approximated MMD between two distributions is the squared distance of
their mean RFF rows (``core.mmd.mmd_rff``), and the serving plane already
computes the live stream's batch moments *inside* the dispatch (the
probed transform planes — no second featurize pass, no raw data
retained anywhere).  This module watches those moments per domain pair:

- **Reference** — the fit-time target moment (``MomentStats.target_mean``),
  re-pinned after every refresh.
- **EWMA** — an exponentially-weighted moving average of the streamed batch
  moment vectors: smooth enough to reject single-batch noise, responsive
  enough to track a covariate shift within a few windows.
- **RF-MMD** — ``||reference - ewma||^2``, evaluated every ``window``
  batches.  The heavy half (the moments) is computed on the card by the probed
  planes; the distance between two host-resident (2N,) vectors is a plain
  numpy reduction — routing it through a kernel would pay launch
  overhead orders of magnitude above the compute, on the serving hot path.
- **Alerting** — the statistic must exceed the threshold for
  ``k_consecutive`` windows before the monitor fires (transient bursts do
  not trigger a re-solve).  The threshold is either given or *calibrated*
  from drift-free evaluations: after ``burnin_windows`` evaluations are
  discarded (the EWMA is still dominated by its first-batch seed there and
  reads far from its steady state), the next ``calibration_windows`` set it
  to ``max(mean + threshold_scale * std, threshold_ratio * mean)`` of the
  calm RF-MMD levels — the ratio floor guards against a lucky-quiet
  calibration run underestimating the calm spread.
- **Refresh input** — alongside the EWMA (the detector), the monitor keeps
  a short weighted window of recent ``(moment, n_cols)`` pairs;
  :meth:`recent_mean` pools them into the post-drift target moment the
  ``AlignerServer`` re-solves from (``refresh_from_moments``) — recency-
  correct where the full merged history would dilute the shift.

Every evaluation appends a typed :class:`DriftRecord` to :attr:`history`,
so the complete detection timeline (calibration, crossings, consecutive
counts, fires) reconstructs from the records alone — the bench contract.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from repro_torch.obs.records import Record
from repro_torch.obs.registry import get_registry

def _sq_mmd(a, b) -> float:
    d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
    return float(np.dot(d, d))


@dataclass(eq=True)
class DriftRecord(Record):
    """One evaluated drift window (JSON-ready via ``to_dict``)."""

    t: float  # caller time (virtual in the serving benches) of the window
    pair: str
    mmd: float  # RF-MMD between reference and live EWMA moments
    threshold: float | None = None  # None while still calibrating
    consecutive: int = 0  # windows above threshold so far (0 after a fire)
    fired: bool = False
    calibrating: bool = False


class _PairState:
    __slots__ = ("ref", "ewma", "recent", "seen", "windows", "consecutive",
                 "threshold", "calibration")

    def __init__(self, maxlen: int, threshold: float | None):
        self.ref: np.ndarray | None = None
        self.ewma: np.ndarray | None = None
        self.recent: deque = deque(maxlen=maxlen)  # (moment, n_cols)
        self.seen = 0  # batches observed since the last reference pin
        self.windows = 0  # evaluations since the last reference pin
        self.consecutive = 0
        self.threshold = threshold
        self.calibration: list[float] = []


class DriftMonitor:
    """Per-domain-pair RF-MMD drift detector over streamed batch moments."""

    def __init__(
        self,
        *,
        alpha: float = 0.3,
        window: int = 4,
        k_consecutive: int = 2,
        threshold: float | None = None,
        calibration_windows: int = 3,
        threshold_scale: float = 6.0,
        threshold_ratio: float = 1.8,
        burnin_windows: int = 1,
        recent_batches: int | None = None,
        on_alert=None,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if window < 1 or k_consecutive < 1:
            raise ValueError("window and k_consecutive must be >= 1")
        if threshold is None and calibration_windows < 1:
            raise ValueError("need calibration_windows >= 1 when threshold is None")
        if burnin_windows < 0:
            raise ValueError(f"burnin_windows must be >= 0, got {burnin_windows}")
        self.alpha = alpha
        self.window = window
        self.k_consecutive = k_consecutive
        self.threshold = threshold
        if threshold_ratio < 1.0:
            raise ValueError(f"threshold_ratio must be >= 1, got {threshold_ratio}")
        self.calibration_windows = calibration_windows
        self.threshold_scale = threshold_scale
        self.threshold_ratio = threshold_ratio
        self.burnin_windows = burnin_windows
        self.recent_batches = (
            recent_batches if recent_batches is not None
            else window * max(k_consecutive, 2)
        )
        self.on_alert = on_alert  # callable(pair, DriftRecord) at each fire
        self._pairs: dict = {}
        self.history: list[DriftRecord] = []
        self.fires = 0

    def _state(self, pair) -> _PairState:
        st = self._pairs.get(pair)
        if st is None:
            st = self._pairs[pair] = _PairState(self.recent_batches, self.threshold)
        return st

    def set_reference(self, pair, moment) -> None:
        """Pin the drift-free reference moment (fit time / after refresh).

        Resets the detector's live state: the EWMA re-seeds from the next
        batch, the consecutive counter clears, and the recent window empties
        (its content was just consumed by the refresh)."""
        st = self._state(pair)
        st.ref = np.asarray(moment, np.float32).reshape(-1)
        st.ewma = None
        st.recent.clear()
        st.seen = 0
        st.windows = 0
        st.consecutive = 0

    def pairs(self) -> list:
        return list(self._pairs)

    def observe(self, pair, t: float, moment, n_cols: int) -> DriftRecord | None:
        """Fold one dispatched batch's mean RFF row into the live state;
        evaluates (and possibly fires) every ``window`` batches.  Batches
        observed before :meth:`set_reference` are ignored."""
        st = self._pairs.get(pair)
        if st is None or st.ref is None:
            return None
        m = np.asarray(moment, np.float32).reshape(-1)
        st.ewma = m if st.ewma is None else self.alpha * m + (1 - self.alpha) * st.ewma
        st.recent.append((m, int(n_cols)))
        st.seen += 1
        if st.seen % self.window != 0:
            return None
        return self._evaluate(pair, st, float(t))

    def _evaluate(self, pair, st: _PairState, t: float) -> DriftRecord:
        mmd = _sq_mmd(st.ref, st.ewma)
        reg = get_registry()
        reg.gauge("drift.mmd").set(mmd, pair=str(pair))
        st.windows += 1
        in_burnin = st.windows <= self.burnin_windows
        calibrating = st.threshold is None
        fired = False
        if in_burnin:
            calibrating = True  # recorded as such; never alerts nor calibrates
        elif calibrating:
            st.calibration.append(mmd)
            if len(st.calibration) >= self.calibration_windows:
                lvl = np.asarray(st.calibration, np.float64)
                st.threshold = float(max(
                    lvl.mean() + self.threshold_scale * max(lvl.std(), 1e-12),
                    self.threshold_ratio * lvl.mean(),
                ))
                reg.gauge("drift.threshold").set(st.threshold, pair=str(pair))
        elif mmd > st.threshold:
            st.consecutive += 1
            if st.consecutive >= self.k_consecutive:
                fired = True
                st.consecutive = 0
                self.fires += 1
                reg.counter("drift.fires").inc(pair=str(pair))
        else:
            st.consecutive = 0
        record = DriftRecord(
            t=t, pair=str(pair), mmd=mmd, threshold=st.threshold,
            consecutive=st.consecutive, fired=fired, calibrating=calibrating,
        )
        self.history.append(record)
        if fired and self.on_alert is not None:
            self.on_alert(pair, record)
        return record

    def recent_mean(self, pair) -> tuple[np.ndarray, int]:
        """Column-weighted pooled moment over the recent window — the live
        target-side statistic a moment-space refresh re-solves from."""
        st = self._pairs.get(pair)
        if st is None or not st.recent:
            raise ValueError(f"no live moments observed for pair {pair!r}")
        total = sum(n for _, n in st.recent)
        pooled = sum(m * (n / total) for m, n in st.recent)
        return np.asarray(pooled, np.float32), int(total)

    def pair_threshold(self, pair) -> float | None:
        st = self._pairs.get(pair)
        return None if st is None else st.threshold

    def timeline(self) -> list[dict]:
        """The full detection story as plain dicts (bench/JSON-ready)."""
        return [r.to_dict() for r in self.history]
