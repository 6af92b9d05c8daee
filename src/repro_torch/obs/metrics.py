"""Process-wide metrics: counters, gauges, histograms, one registry.

A copy of ``repro.obs.metrics`` (the port imports nothing from ``repro``).

Zero-dependency (stdlib + numpy) observability floor for the serving
stack. Three design rules, all driven by the engine tick path:

  * **No per-observation allocation.** A histogram keeps one
    preallocated int64 count array per label-set; ``observe`` is a
    bisect + in-place increment. Counters add to a float slot. The only
    allocating operation is first-touch of a new label-set (engines
    touch their label-sets once, at activation).
  * **One taxonomy, many views.** Every layer (scheduler, engine,
    gateway, flywheel, kernels) records into the same
    ``MetricsRegistry``; ``throughput_stats`` and the exporters are
    views over it, so numbers cannot disagree between layers.
  * **Bitwise-invisible.** Nothing here touches tensors or device values —
    recording is host-side Python arithmetic only, so densities are
    identical with metrics on or off (asserted by tests and the
    ``--observe`` benchmark).

Instruments are keyed by ``(name, sorted label items)``. Reads
(``snapshot``, ``to_prometheus``, ``percentile``) take the instrument
lock briefly; writes are a lock + O(1) update. The module-level
``default_registry()`` is what the serving stack records into; tests
that need isolation construct their own ``MetricsRegistry``.
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "exponential_buckets", "default_registry", "set_default_registry",
]

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, object]) -> LabelKey:
    """Canonical hashable key for a label dict (values stringified the
    way the exporters will print them)."""
    if not labels:
        return ()
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def exponential_buckets(start: float, factor: float,
                        count: int) -> Tuple[float, ...]:
    """``count`` exponentially-spaced upper bounds starting at
    ``start``: start, start*factor, ... (the implicit +Inf bucket is
    always appended by Histogram)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# 100us .. ~105s in x2 steps: covers admission waits and tick latencies
# from sub-ms smoke meshes up to multi-minute soak completions.
DEFAULT_LATENCY_BUCKETS = exponential_buckets(1e-4, 2.0, 21)
# 1 .. 4096 in x2 steps: CG iteration counts.
DEFAULT_COUNT_BUCKETS = exponential_buckets(1.0, 2.0, 13)


class _Instrument:
    """Shared label-series bookkeeping. Subclasses define the per-series
    storage via ``_new_series`` and record into it."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[LabelKey, object] = {}

    def _get_series(self, labels: Dict[str, object]):
        key = _label_key(labels)
        s = self._series.get(key)
        if s is None:               # first touch only
            s = self._series.setdefault(key, self._new_series())
        return s

    def _new_series(self):
        raise NotImplementedError

    def labelsets(self) -> List[LabelKey]:
        with self._lock:
            return list(self._series)


class Counter(_Instrument):
    """Monotonically-increasing float per label-set."""

    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, n: float = 1.0, **labels):
        s = self._get_series(labels)
        with self._lock:
            s[0] += n

    def value(self, **labels) -> float:
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s[0] if s is not None else 0.0

    def total(self) -> float:
        """Sum over every label-set."""
        with self._lock:
            return sum(s[0] for s in self._series.values())


class Gauge(_Instrument):
    """Point-in-time value per label-set; either ``set()`` explicitly or
    constructed with ``callback=`` (sampled at read time — queue depth,
    live engine count — so the hot path records nothing at all)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 callback: Optional[Callable[[], float]] = None):
        super().__init__(name, help)
        self._callback = callback

    def _new_series(self):
        return [0.0]

    def set(self, v: float, **labels):
        s = self._get_series(labels)
        with self._lock:
            s[0] = float(v)

    def inc(self, n: float = 1.0, **labels):
        s = self._get_series(labels)
        with self._lock:
            s[0] += n

    def value(self, **labels) -> float:
        if self._callback is not None and not labels:
            try:
                return float(self._callback())
            except Exception:
                return float("nan")
        with self._lock:
            s = self._series.get(_label_key(labels))
            return s[0] if s is not None else 0.0


class Histogram(_Instrument):
    """Fixed-exponential-bucket histogram, one preallocated count array
    per label-set (+Inf bucket implicit at the end). ``observe`` is a
    bisect into the shared bound list plus an in-place increment —
    no allocation after the label-set's first touch. ``observe(v, n=k)``
    records ``k`` observations of the same value in one update (the
    engine uses it to flush a timing window of k equal steps)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        super().__init__(name, help)
        b = tuple(sorted(float(x) for x in buckets))
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"buckets must be strictly increasing: {b}")
        self.bounds: Tuple[float, ...] = b

    def _new_series(self):
        # [counts(int64, len(bounds)+1), sum, count]
        return [np.zeros(len(self.bounds) + 1, np.int64), 0.0, 0]

    def observe(self, v: float, n: int = 1, **labels):
        s = self._get_series(labels)
        i = bisect.bisect_left(self.bounds, v)   # first bound >= v
        with self._lock:
            s[0][i] += n
            s[1] += v * n
            s[2] += n

    def count(self, **labels) -> int:
        """Observation count; aggregates over ALL label-sets when called
        without labels (mirrors ``percentile``)."""
        with self._lock:
            if not labels:
                return int(sum(s[2] for s in self._series.values()))
            s = self._series.get(_label_key(labels))
            return int(s[2]) if s is not None else 0

    def sum(self, **labels) -> float:
        """Observation sum; aggregates over ALL label-sets when called
        without labels (mirrors ``percentile``)."""
        with self._lock:
            if not labels:
                return float(sum(s[1] for s in self._series.values()))
            s = self._series.get(_label_key(labels))
            return float(s[1]) if s is not None else 0.0

    def percentile(self, q: float, **labels) -> float:
        """Estimated q-th percentile (0..100) from bucket counts, with
        linear interpolation inside the straddling bucket. Aggregates
        over ALL label-sets when called without labels and more than one
        exists."""
        with self._lock:
            if labels or len(self._series) <= 1:
                s = self._series.get(_label_key(labels))
                if s is None and not labels and self._series:
                    s = next(iter(self._series.values()))
                if s is None or s[2] == 0:
                    return 0.0
                counts = s[0].copy()
            else:
                counts = np.zeros(len(self.bounds) + 1, np.int64)
                for s in self._series.values():
                    counts += s[0]
                if counts.sum() == 0:
                    return 0.0
        total = int(counts.sum())
        rank = max(1, int(np.ceil(q / 100.0 * total)))
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += int(c)
            if cum >= rank:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.bounds[-1])   # +Inf bucket: clamp to last
                if c == 0:
                    return hi
                frac = (rank - prev_cum) / c
                return lo + frac * (hi - lo)
        return self.bounds[-1]


class MetricsRegistry:
    """Named instruments, get-or-create. One process-wide default (see
    ``default_registry``); every serving layer records into it and every
    exporter/stats view reads from it."""

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self.created_t = time.time()

    def _get(self, name: str, factory: Callable[[], _Instrument],
             cls) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = factory()
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help), Counter)

    def gauge(self, name: str, help: str = "",
              callback: Optional[Callable[[], float]] = None) -> Gauge:
        g = self._get(name, lambda: Gauge(name, help, callback), Gauge)
        if callback is not None:
            g._callback = callback   # late-bound (engine built after gauge)
        return g

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        return self._get(name, lambda: Histogram(name, help, buckets),
                         Histogram)

    def instruments(self) -> Dict[str, _Instrument]:
        with self._lock:
            return dict(self._instruments)

    # ------------------------------------------------------------ views

    def snapshot(self) -> Dict[str, Dict]:
        """Nested plain-dict view of every instrument — the JSONL
        snapshot payload and the dashboard's data source."""
        out: Dict[str, Dict] = {}
        for name, inst in sorted(self.instruments().items()):
            entry: Dict[str, object] = {"kind": inst.kind,
                                        "help": inst.help}
            series = {}
            if isinstance(inst, Histogram):
                with inst._lock:
                    for key, s in inst._series.items():
                        series[_fmt_key(key)] = {
                            "buckets": [int(c) for c in s[0]],
                            "sum": float(s[1]), "count": int(s[2]),
                        }
                entry["bounds"] = list(inst.bounds)
            elif isinstance(inst, Gauge) and inst._callback is not None:
                series[""] = inst.value()
            else:
                with inst._lock:
                    for key, s in inst._series.items():
                        series[_fmt_key(key)] = float(s[0])
            entry["series"] = series
            out[name] = entry
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (counters as ``_total``-less
        names — scrapers don't care — histograms as the standard
        ``_bucket``/``_sum``/``_count`` triple)."""
        lines: List[str] = []
        for name, inst in sorted(self.instruments().items()):
            if inst.help:
                lines.append(f"# HELP {name} {inst.help}")
            lines.append(f"# TYPE {name} {inst.kind}")
            if isinstance(inst, Histogram):
                with inst._lock:
                    items = list(inst._series.items())
                for key, s in items:
                    cum = 0
                    for bound, c in zip(inst.bounds, s[0]):
                        cum += int(c)
                        lines.append(
                            f"{name}_bucket"
                            f"{_prom_labels(key, le=_fmt_f(bound))} {cum}")
                    cum += int(s[0][-1])
                    lines.append(
                        f"{name}_bucket{_prom_labels(key, le='+Inf')} "
                        f"{cum}")
                    lines.append(
                        f"{name}_sum{_prom_labels(key)} {_fmt_f(s[1])}")
                    lines.append(
                        f"{name}_count{_prom_labels(key)} {int(s[2])}")
            elif isinstance(inst, Gauge) and inst._callback is not None:
                lines.append(f"{name} {_fmt_f(inst.value())}")
            else:
                with inst._lock:
                    items = list(inst._series.items())
                for key, s in items:
                    lines.append(
                        f"{name}{_prom_labels(key)} {_fmt_f(s[0])}")
        return "\n".join(lines) + "\n"


def _fmt_key(key: LabelKey) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


def _fmt_f(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _prom_labels(key: LabelKey, **extra: str) -> str:
    items = list(key) + sorted(extra.items())
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


_default = MetricsRegistry()
_default_lock = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-wide registry the serving stack records into."""
    return _default


def set_default_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the process default (tests / benchmark isolation); returns
    the previous one so callers can restore it."""
    global _default
    with _default_lock:
        prev, _default = _default, reg
    return prev
