"""Per-request trace spans: where did this request's latency budget go?

A copy of ``repro.obs.trace`` (the port imports nothing from ``repro``).

A ``Trace`` rides on a sampled ``TopoRequest`` (``trace_every=N`` on the
engine/gateway; every Nth submission gets one) and is assembled
LOCK-FREE on the engine tick path: exactly one thread — the shard loop
that owns the request's lane — appends to it at any moment, and the
bounded span list / tick ring mean a long-running request can never grow
it without bound. Recording is host-side stamps only (``time.monotonic``
+ tiny host ints), so a traced request's density is bitwise-equal to an
untraced run — the structural contract the ``--observe`` benchmark and
tests enforce.

Phase spans tile the request's monotonic timeline contiguously::

    queued   submit_t            -> first admission (admitted_t)
    compute  admission           -> park OR completion, per episode
    parked   park                -> re-admission, per preemption cycle

Every boundary reuses the SAME stamp that closes the previous span, so
``sum(span durations) == completed_mono - submit_t`` exactly — which is
how the acceptance criterion ("phase durations sum to within 1% of
measured end-to-end latency") holds by construction rather than by
luck. Inside compute spans, the per-tick ring records (tick stamp,
rung width, slot iteration) at dispatch, and the engine's sync points
fill in the CRONet-accepted vs CG-fallback split with per-window
iteration counts (device counters are only READ at boundaries the
engine already synchronizes; tracing adds no extra device work).
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

__all__ = ["Span", "Trace"]

# span kinds, in canonical timeline order
QUEUED = "queued"
COMPUTE = "compute"
PARKED = "parked"


class Span:
    """One closed phase interval [t0, t1) on the monotonic clock."""

    __slots__ = ("name", "t0", "t1", "attrs")

    def __init__(self, name: str, t0: float, t1: float,
                 attrs: Optional[Dict] = None):
        self.name = name
        self.t0 = t0
        self.t1 = t1
        self.attrs = attrs or {}

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> Dict:
        d = {"name": self.name, "t0": self.t0, "t1": self.t1,
             "duration_s": self.duration_s}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        return d

    def __repr__(self):
        return (f"Span({self.name!r}, {self.duration_s * 1e3:.2f}ms"
                + (f", {self.attrs}" if self.attrs else "") + ")")


class Trace:
    """Bounded span timeline + per-tick ring for one request.

    Single-writer by construction (the owning shard loop); readers
    (``gateway.trace(uid)``, dashboards) only look after completion, or
    tolerate a torn-but-consistent in-progress view (appends only).
    """

    def __init__(self, uid: int, max_spans: int = 256,
                 tick_ring: int = 512):
        self.uid = uid
        self.spans: List[Span] = []
        self.max_spans = int(max_spans)
        self.dropped_spans = 0
        # (t_mono, rung_width, slot_iteration) per dispatched tick
        self.ticks: collections.deque = collections.deque(
            maxlen=int(tick_ring))
        # (t_mono, n_ticks, cronet_iters, fea_iters, cg_iters) per sync
        # window — the accepted-vs-fallback split, at the granularity
        # the engine already synchronizes at
        self.windows: collections.deque = collections.deque(
            maxlen=int(tick_ring))
        self.submit_t: Optional[float] = None
        self.completed_mono: Optional[float] = None
        self._open: Optional[Tuple[str, float, Dict]] = None

    # ---------------------------------------------------- span recording

    def begin(self, name: str, t: Optional[float] = None, **attrs):
        """Open phase ``name`` at ``t`` (monotonic; defaults to now),
        closing any still-open phase at the same stamp so the timeline
        stays contiguous."""
        t = time.monotonic() if t is None else t
        if self._open is not None:
            self.end(t)
        if self.submit_t is None:
            self.submit_t = t
        self._open = (name, t, dict(attrs))

    def end(self, t: Optional[float] = None, **attrs):
        """Close the open phase at ``t`` (monotonic; defaults to now)."""
        if self._open is None:
            return
        t = time.monotonic() if t is None else t
        name, t0, a = self._open
        self._open = None
        if attrs:
            a.update(attrs)
        if len(self.spans) < self.max_spans:
            self.spans.append(Span(name, t0, t, a))
        else:
            self.dropped_spans += 1

    def finish(self, t: Optional[float] = None, **attrs):
        """Close the open phase and stamp completion."""
        t = time.monotonic() if t is None else t
        self.end(t, **attrs)
        self.completed_mono = t

    # ---------------------------------------------------- tick recording

    def tick(self, t: float, rung: int, it: int):
        """One dispatched engine tick for this request's lane (appended
        from the owning shard loop only — lock-free)."""
        self.ticks.append((t, rung, it))

    def window(self, t: float, n_ticks: int, cronet_iters: int,
               fea_iters: int, cg_iters: int):
        """Accepted-vs-fallback split for the sync window ending at
        ``t``: how many of the window's NN proposals were accepted
        (cronet_iters), fell back to FEA (fea_iters), and how many CG
        iterations the fallbacks burned."""
        self.windows.append((t, n_ticks, cronet_iters, fea_iters,
                             cg_iters))

    # ----------------------------------------------------------- queries

    @property
    def complete(self) -> bool:
        return self.completed_mono is not None and self._open is None

    def phase_durations(self) -> Dict[str, float]:
        """Total seconds per phase name (e.g. queued/compute/parked)."""
        out: Dict[str, float] = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.duration_s
        return out

    def total_s(self) -> float:
        """Sum of all span durations — equals end-to-end latency on a
        complete, undropped timeline (spans tile the request's life)."""
        return sum(s.duration_s for s in self.spans)

    def end_to_end_s(self) -> float:
        if self.submit_t is None or self.completed_mono is None:
            return 0.0
        return self.completed_mono - self.submit_t

    def preemption_cycles(self) -> int:
        return sum(1 for s in self.spans if s.name == PARKED)

    def cronet_split(self) -> Dict[str, int]:
        """Aggregated accepted/fallback/CG-iteration counts over the
        recorded sync windows."""
        return {
            "cronet_iters": sum(w[2] for w in self.windows),
            "fea_iters": sum(w[3] for w in self.windows),
            "cg_iters": sum(w[4] for w in self.windows),
        }

    def to_dict(self) -> Dict:
        return {
            "uid": self.uid,
            "complete": self.complete,
            "submit_t": self.submit_t,
            "completed_mono": self.completed_mono,
            "end_to_end_s": self.end_to_end_s(),
            "phase_durations": self.phase_durations(),
            "preemption_cycles": self.preemption_cycles(),
            "spans": [s.to_dict() for s in self.spans],
            "dropped_spans": self.dropped_spans,
            "ticks": [list(t) for t in self.ticks],
            "windows": [list(w) for w in self.windows],
            "cronet_split": self.cronet_split(),
        }

    def render(self) -> str:
        """Human-readable one-request timeline (``--observe`` drill-down
        and debugging)."""
        lines = [f"trace uid={self.uid} "
                 f"e2e={self.end_to_end_s() * 1e3:.1f}ms "
                 f"spans={len(self.spans)} "
                 f"ticks={len(self.ticks)}"]
        for s in self.spans:
            rel = (s.t0 - self.submit_t) * 1e3 if self.submit_t else 0.0
            attrs = (" " + " ".join(f"{k}={v}"
                                    for k, v in sorted(s.attrs.items()))
                     if s.attrs else "")
            lines.append(f"  +{rel:9.2f}ms {s.name:<8} "
                         f"{s.duration_s * 1e3:9.2f}ms{attrs}")
        split = self.cronet_split()
        if any(split.values()):
            lines.append(f"  split: cronet={split['cronet_iters']} "
                         f"fea={split['fea_iters']} "
                         f"cg_iters={split['cg_iters']}")
        return "\n".join(lines)

    def __repr__(self):
        return (f"Trace(uid={self.uid}, spans={len(self.spans)}, "
                f"complete={self.complete})")
