"""Shared request/future/lifecycle/stats types for the topo serving stack.

A copy of ``repro.serve.types`` (the port imports nothing from ``repro``).

This module is the dependency floor of the ``repro.serve`` package: the
scheduler (policy), the per-mesh engine (mechanism), and the gateway
(routing + backpressure) all build on these types, so they live below
all three and import nothing from them.

  * ``TopoRequest`` / ``TopoFuture`` — the unit of work and its
    completion handle, shared verbatim between the gateway front door
    and the per-mesh engines (one future per request, end to end).
  * ``OverloadPolicy`` — what a bounded admission queue does when full:
    ``BLOCK`` (submit waits), ``REJECT`` (fail fast with ``QueueFull``),
    ``SHED_LATEST_DEADLINE`` (evict the least-urgent queued request so
    the rest keep their deadlines; the evictee's future fails with
    ``RequestShed``).
  * ``EngineState`` + ``EngineClosed`` — the explicit lifecycle state
    machine: submitting to a CLOSED engine/gateway raises instead of
    hanging or racing the tick loops.
  * ``throughput_view`` / ``pool_stats`` — ONE latency/throughput
    summary implementation. ``throughput_view`` is the generic core
    (count, rate, mean/p50/p99 over caller-supplied extractors);
    ``pool_stats`` is its topo-request specialization. The engine (one
    pool), the gateway (per-mesh pools + an aggregate) and the LM
    decode engine all report through it, so the three layers can never
    drift apart.
  * ``TagStats`` / ``FleetEvent`` — the fleet-operations floor: per-model-
    tag serving counters (the acceptance/deadline metrics a canary is
    judged on) and the typed control-plane event record the gateway
    emits for canary start / promote / rollback / evict / rebuild.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import threading
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np


# --------------------------------------------------------------- lifecycle


class EngineState(enum.Enum):
    """Explicit lifecycle for engines and the gateway.

    NEW -> RUNNING <-> STOPPED -> CLOSED, with FAILED terminal from any
    state. ``stop()`` is the restartable pause (the ``run()`` drain shim
    uses it between batches); ``shutdown()`` is terminal — submitting
    afterwards raises ``EngineClosed``.
    """
    NEW = "new"
    RUNNING = "running"
    STOPPED = "stopped"
    CLOSED = "closed"
    FAILED = "failed"


class EngineClosed(RuntimeError):
    """submit() on a shut-down (or shutting-down) engine/gateway."""


class GatewayOverloaded(RuntimeError):
    """Base of the typed backpressure failures."""


class QueueFull(GatewayOverloaded):
    """REJECT policy: the bounded admission queue is full."""


class RequestShed(GatewayOverloaded):
    """SHED_LATEST_DEADLINE policy: this request was evicted from the
    bounded queue in favour of more-urgent work; its future raises this."""


class WorkerLost(RuntimeError):
    """An engine-worker process died while this request was in flight on
    one of its ticks. Requests that had NOT yet been admitted to a slot
    when the worker died are transparently requeued (preserving their
    EDF rank) instead of raising this — only work that genuinely
    progressed on the lost worker fails typed, so the caller knows a
    retry re-runs iterations rather than resuming them."""

    def __init__(self, msg: str, worker_id: Optional[int] = None):
        super().__init__(msg)
        self.worker_id = worker_id


class OverloadPolicy(enum.Enum):
    """What a full bounded admission queue does with the next submit."""
    BLOCK = "block"
    REJECT = "reject"
    SHED_LATEST_DEADLINE = "shed-latest-deadline"

    @classmethod
    def coerce(cls, v: Union["OverloadPolicy", str]) -> "OverloadPolicy":
        if isinstance(v, cls):
            return v
        try:
            return cls(v)
        except ValueError:
            raise ValueError(
                f"unknown overload policy {v!r}; have "
                f"{[p.value for p in cls]}") from None


# ----------------------------------------------------------- request/future


@dataclasses.dataclass
class TopoRequest:
    uid: int
    problem: "object"                       # fea2d.Problem (kept untyped to
    n_iter: int = 60                        # keep this module tensor-free)
    deadline_s: Optional[float] = None      # freshness deadline, rel. submit
    priority: int = 0                       # higher = more urgent; outranks
    # filled on submit                      # deadline ordering entirely
    # submit_t/deadline are MONOTONIC-clock stamps (time.monotonic()):
    # deadline math must not move when NTP steps the wall clock. They are
    # comparable to each other and to other monotonic stamps only —
    # user-facing wall-clock time lives in completed_t / FleetEvent.t.
    submit_t: float = 0.0
    deadline: Optional[float] = None        # absolute monotonic deadline
    # filled at routing time (gateway shape-class dispatch): the original
    # (nelx, nely) when ``problem`` was padded onto a canonical shape
    # class — the engine crops the harvested density back to it.
    orig_mesh: Optional[tuple] = None
    # filled at first slot admission (monotonic): queue age on
    # completions is recoverable as ``admitted_t - submit_t`` (also
    # mirrored in ``queue_wait_s``), compute time as
    # ``latency_s`` — previously only end-to-end was recoverable.
    admitted_t: Optional[float] = None
    # optional per-request trace (repro.obs.trace.Trace) — attached by
    # the engine/gateway ``trace_every=N`` sampler; kept untyped so this
    # module stays the dependency floor (obs imports nothing from serve,
    # serve.types imports nothing from obs).
    trace: Optional[object] = None
    # filled on completion
    done: bool = False
    completed_t: float = 0.0                # wall-clock (time.time()) stamp
    density: Optional[np.ndarray] = None    # (nely, nelx) final design
    compliance: float = 0.0                 # last-iteration compliance
    cronet_iters: int = 0
    fea_iters: int = 0
    cg_iters: int = 0                       # CG iterations the FEA
    #                                         fallbacks burned (hybrid
    #                                         state carries the per-slot
    #                                         counter; no extra syncs)
    latency_s: float = 0.0                  # first slot admission -> completion
    queue_wait_s: float = 0.0               # submit -> first slot admission
    deadline_met: Optional[bool] = None     # None when no deadline was set
    preemptions: int = 0                    # times this request was parked
    model_tag: Optional[str] = None         # registry tag of the serving model
    # filled at routing time (gateway only): the tag of the engine the
    # dispatcher forwarded this request to. A completed request must
    # satisfy ``model_tag == routed_tag`` — the engine that served it is
    # the engine it was routed to (the fleet tests' mis-tag invariant).
    routed_tag: Optional[str] = None
    # filled on completion when served through a WorkerPool: the id of
    # the worker process whose engine ran the ticks (None for in-process
    # serving) — the label the obs layer splits per-worker metrics on.
    worker_id: Optional[int] = None

    @property
    def mesh(self) -> tuple:
        """(nelx, nely) routing key — what the gateway buckets on."""
        return (self.problem.nelx, self.problem.nely)


class TopoFuture:
    """Completion handle for a submitted request (threading.Event based).

    One future follows the request end to end: the gateway creates it at
    the front door and the per-mesh engine resolves it, so callers never
    see the routing hop. ``add_done_callback`` runs callbacks on the
    resolving thread (engine tick loop / gateway dispatcher) — keep them
    cheap and non-blocking.
    """

    def __init__(self, req: TopoRequest):
        self.request = req
        self._ev = threading.Event()
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["TopoFuture"], None]] = []
        self._cb_lock = threading.Lock()

    def done(self) -> bool:
        return self._ev.is_set()

    def exception(self) -> Optional[BaseException]:
        """The failure this future resolved with, if any (None while
        pending or on success)."""
        return self._exc

    def result(self, timeout: Optional[float] = None) -> TopoRequest:
        """Block until the request completes; returns it with the density
        filled. Raises TimeoutError on timeout, or the engine's failure
        (e.g. ``RequestShed``) if serving aborted."""
        if not self._ev.wait(timeout):
            raise TimeoutError(f"request {self.request.uid} not done "
                               f"after {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self.request

    def add_done_callback(self, fn: Callable[["TopoFuture"], None]):
        """Run ``fn(self)`` when the future resolves (immediately if it
        already has)."""
        with self._cb_lock:
            if not self._ev.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def _resolve(self, exc: Optional[BaseException] = None):
        with self._cb_lock:
            self._exc = exc
            self._ev.set()
            callbacks, self._callbacks = self._callbacks, []
        for fn in callbacks:
            fn(self)


# ------------------------------------------------------------------- stats


def throughput_view(done: Sequence, *,
                    latency: Callable[[object], float],
                    e2e: Optional[Callable[[object], float]] = None,
                    wall_s: Optional[float] = None,
                    units: Optional[Callable[[object], float]] = None,
                    ) -> Dict[str, float]:
    """The ONE latency/throughput summary core — counts, rate and
    mean/p50/p99 percentiles over completed work items.

    Extractors parameterize the work-item shape so the topo engine
    (``pool_stats``), the gateway aggregate and the LM decode engine
    all share this body instead of keeping three hand-rolled copies:

      * ``latency(item)`` — the compute latency the mean covers.
      * ``e2e(item)``     — the end-to-end latency percentiles cover
                            (defaults to ``latency``).
      * ``wall_s``        — throughput denominator; defaults to the
                            pool makespan ``max(e2e)`` (summing
                            concurrent latencies would understate
                            throughput ~slots-fold).
      * ``units(item)``   — optional work-unit extractor (tokens,
                            iterations); adds ``units``/``units_per_s``.
    """
    lat = [latency(r) for r in done]
    e2e_v = [e2e(r) for r in done] if e2e is not None else lat
    total = wall_s if wall_s is not None else max(e2e_v, default=0.0)
    out = {
        "requests": float(len(done)),
        "rate_per_s": len(done) / max(total, 1e-9),
        "mean_latency_s": float(np.mean(lat)) if lat else 0.0,
        "p50_latency_s": float(np.percentile(e2e_v, 50)
                               if e2e_v else 0.0),
        "p99_latency_s": float(np.percentile(e2e_v, 99)
                               if e2e_v else 0.0),
    }
    if units is not None:
        u = float(sum(units(r) for r in done))
        out["units"] = u
        out["units_per_s"] = u / max(total, 1e-9)
    return out


def pool_stats(pool: Sequence[TopoRequest],
               wall_s: Optional[float] = None) -> Dict[str, float]:
    """Serving stats over a pool of topo requests — the
    ``throughput_view`` specialization shared by engine and gateway
    ``throughput_stats``. Latency percentiles are end-to-end (submit ->
    completion); ``deadline_hit_rate`` covers deadline-carrying
    completed requests only (1.0 when there were none)."""
    done = [r for r in pool if r.done]
    iters = sum(r.cronet_iters + r.fea_iters for r in done)
    view = throughput_view(
        done, latency=lambda r: r.latency_s,
        e2e=lambda r: r.queue_wait_s + r.latency_s, wall_s=wall_s)
    with_dl = [r for r in done if r.deadline is not None]
    hits = sum(1 for r in with_dl if r.deadline_met)
    return {
        # which registry checkpoints served this pool (a hot swap mid-pool
        # legitimately shows more than one tag)
        "model_tags": sorted({r.model_tag for r in done
                              if r.model_tag is not None}),
        "requests": view["requests"],
        "problems_per_s": view["rate_per_s"],
        "mean_latency_s": view["mean_latency_s"],
        "p50_latency_s": view["p50_latency_s"],
        "p99_latency_s": view["p99_latency_s"],
        "deadline_hit_rate": (hits / len(with_dl)) if with_dl else 1.0,
        "cronet_hit_rate": (sum(r.cronet_iters for r in done)
                            / max(iters, 1)),
    }


# --------------------------------------------------------------- fleet ops


class TagStats:
    """Per-model-tag serving counters — the running half of
    ``pool_stats``, accumulated one completion at a time instead of over
    a retained pool (a canary window must not depend on ring-buffer
    retention). Metric definitions match ``pool_stats``:
    ``cronet_hit_rate`` is iteration-weighted and ``deadline_hit_rate``
    covers deadline-carrying completions only (1.0 when there were
    none). Callers serialize access (the gateway records under its
    queue lock).

    With ``window=N`` the stats additionally keep the last N
    completions in a deque, and the ``recent_*`` metrics cover that
    window only — the time-decayed view auto-rollback and flywheel
    promotion compare, so a long-lived canary (or a bucket whose
    traffic drifted) is judged on CURRENT behaviour instead of lifetime
    aggregates that an early phase dominates forever. Without a window
    the ``recent_*`` metrics alias the lifetime ones."""

    def __init__(self, window: Optional[int] = None):
        self.completed = 0
        self.cronet_iters = 0
        self.fea_iters = 0
        self.deadline_total = 0
        self.deadline_hits = 0
        self.latency_sum = 0.0
        self.window = window
        # (cronet_iters, fea_iters, had_deadline, deadline_met) per
        # completion; bounded, so a windowed TagStats never grows
        self._recent: Optional[collections.deque] = (
            collections.deque(maxlen=int(window)) if window else None)

    def record(self, req: TopoRequest):
        self.completed += 1
        self.cronet_iters += req.cronet_iters
        self.fea_iters += req.fea_iters
        self.latency_sum += req.latency_s   # engine latency, as pool_stats
        if req.deadline is not None:
            self.deadline_total += 1
            self.deadline_hits += int(bool(req.deadline_met))
        if self._recent is not None:
            self._recent.append((req.cronet_iters, req.fea_iters,
                                 req.deadline is not None,
                                 bool(req.deadline_met)))

    @property
    def cronet_hit_rate(self) -> float:
        return self.cronet_iters / max(self.cronet_iters
                                       + self.fea_iters, 1)

    @property
    def deadline_hit_rate(self) -> float:
        return (self.deadline_hits / self.deadline_total
                if self.deadline_total else 1.0)

    # ---- windowed (recent-traffic) view; lifetime alias when unwindowed

    @property
    def recent_completed(self) -> int:
        return (len(self._recent) if self._recent is not None
                else self.completed)

    @property
    def recent_cronet_hit_rate(self) -> float:
        if self._recent is None:
            return self.cronet_hit_rate
        cro = sum(r[0] for r in self._recent)
        fea = sum(r[1] for r in self._recent)
        return cro / max(cro + fea, 1)

    @property
    def recent_deadline_hit_rate(self) -> float:
        if self._recent is None:
            return self.deadline_hit_rate
        total = sum(1 for r in self._recent if r[2])
        hits = sum(1 for r in self._recent if r[2] and r[3])
        return hits / total if total else 1.0

    def snapshot(self) -> Dict[str, float]:
        return {
            "completed": float(self.completed),
            "cronet_hit_rate": self.cronet_hit_rate,
            "deadline_hit_rate": self.deadline_hit_rate,
            "mean_latency_s": (self.latency_sum / self.completed
                               if self.completed else 0.0),
            "recent_completed": float(self.recent_completed),
            "recent_cronet_hit_rate": self.recent_cronet_hit_rate,
            "recent_deadline_hit_rate": self.recent_deadline_hit_rate,
        }


@dataclasses.dataclass(frozen=True)
class FleetEvent:
    """One control-plane transition in the gateway's fleet-operations
    log: ``kind`` is ``canary-start`` / ``promote`` / ``rollback`` /
    ``evict`` / ``rebuild`` / ``swap`` / ``resize`` (a live ladder-rung
    target change) / ``callback-error`` (a user done-callback raised;
    recorded instead of silently swallowed so a broken callback cannot
    invisibly stall canary stat accumulation) / the flywheel
    controller's ``flywheel-*`` transitions (trigger / harvest / train /
    canary / promote / rollback / error — serve/flywheel.py records one
    per state-machine edge). ``details`` carries the
    kind-specific payload (e.g. the per-tag stats snapshots a rollback
    decision was based on). ``t`` is a user-facing wall-clock stamp
    (time.time()) — kept on purpose for humans reading the log —
    while ``t_mono`` is the matching ``time.monotonic()`` stamp, taken
    at the same instant, so events CAN be ordered against request
    stamps (submit_t/deadline/admitted_t live on the monotonic clock;
    wall-clock alone cannot be compared to them and can step backwards
    under NTP). Sorting and export order on ``t_mono``."""
    kind: str
    mesh: Optional[tuple]
    tag: Optional[str]
    t: float
    reason: str = ""
    details: Dict = dataclasses.field(default_factory=dict)
    t_mono: float = 0.0
