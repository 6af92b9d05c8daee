"""Mesh-agnostic serving gateway: one front door over per-mesh engines.
The counterpart of ``repro.serve.gateway``: the same admission, routing
and fleet operations in front of the port's ``TopoServingEngine``, which
runs on the card unless the caller passes ``device="cpu"``.

A `TopoServingEngine` serves exactly one discretization — its batched
step is shaped by ``(slots, nelx, nely)`` and rejects foreign meshes at
submit time. The paper's digital-twin fleet is the opposite shape: many
monitored structures, each with its own mesh, one stream of load events.
``TopoGateway`` closes that gap:

  * ``submit(req, deadline_s, priority)`` accepts a request for ANY
    mesh. Requests are bucketed by ``req.mesh == (nelx, nely)`` into
    per-mesh engines that are instantiated lazily on first sight of a
    mesh (CRONet's params are mesh-independent — adaptive pooling makes
    the network fully size-agnostic — so one trained parameter set
    serves every bucket).
  * All meshes share ONE admission queue: a
    ``scheduler.BoundedEDFScheduler`` ranks requests by (priority,
    effective deadline) across meshes, and a single dispatcher thread
    forwards the best ready entry to its engine. An engine at its depth
    limit (``engine_depth`` in-flight) makes its entries "not ready" —
    the dispatcher skips them without head-of-line blocking other
    meshes.
  * The queue is bounded (``max_pending``): when it is full, the
    ``overload`` policy decides — BLOCK (submit waits for room), REJECT
    (raise ``QueueFull``), or SHED_LATEST_DEADLINE (evict the
    least-urgent queued request, failing its future with
    ``RequestShed``, so the feasible subset keeps its deadlines under
    sustained overload).
  * One ``TopoFuture`` follows the request end to end: the gateway
    creates it at the front door and hands it to the engine
    (``TopoServingEngine.submit(..., _future=...)``), so callers never
    observe the routing hop — and the engine's bitwise-invariance
    contract (each density equal to a standalone single-mesh run) holds
    verbatim through the gateway.

Fleet operations — the per-bucket model lifecycle under live traffic:

  * PER-BUCKET MODEL RESOLUTION. A registry-backed gateway resolves
    each new bucket's checkpoint through a ``registry.ModelResolver``:
    an explicit per-bucket pin (``swap_model(tag, mesh=...)``) wins,
    then the newest MESH-SPECIALIZED registry version for that mesh
    (``register(..., mesh=...)`` — per-discretization fine-tunes, cf.
    FE-CNN), then the fleet default. ``swap_model(tag)`` with no mesh
    is the fleet rollout (moves every built bucket, clears pins, sets
    the default future buckets inherit); with an EMPTY pool it records
    the pending tag, applied on first bucket build. Completions and
    ``pool_stats`` carry ``model_tag`` per bucket.
  * CANARY ROUTING. ``canary(tag, fraction, mesh=...)`` deterministically
    routes ``fraction`` of a bucket's admissions (a rollover
    accumulator — exact to within one request, no RNG) to a canary
    engine serving ``tag``, SHARING the bucket's in-flight depth budget
    (the ready gate sums the pair). Per-tag ``TagStats`` accumulate on
    both sides of the split; ``promote()`` graduates the canary into
    the bucket's serving model (drain + swap, reusing the hot-swap
    machinery — zero dropped requests) and auto-ROLLBACK fires when the
    canary's CRONet acceptance rate or deadline hit rate regresses
    beyond ``margin`` vs the concurrent primary traffic: routing
    reverts instantly, the canary engine drains in the background, and
    nothing in flight is dropped or mis-tagged (every completion's
    ``model_tag`` equals its ``routed_tag``).
  * POOL ELASTICITY. With ``idle_evict_s`` set, a bucket that has been
    cold (no queued, in-flight, or arriving work) past the horizon is
    EVICTED — engine shut down (its device tensors freed), stats retired
    into the gateway's history — and lazily REBUILT on next sight of the
    mesh, bitwise contract intact (the mesh-template, step and param
    caches make the rebuild cheap). With ``autoscale=True`` a (re)built
    bucket's slot width follows its observed arrival rate
    (``scheduler.target_slots``), so hot meshes get wide engines and
    cold ones the minimum width — and with ``ladder=`` set the width
    follows the rate LIVE: buckets build wide, every maintenance pass
    snaps ``target_slots`` onto a ladder rung via
    ``engine.set_target_slots`` (a ``FleetEvent("resize")``), and the
    engine dispatches each tick at the smallest rung covering its
    occupancy. ``shape_classes=`` adds the same idea one level up:
    nearby meshes are padded onto canonical shape classes ahead of
    bucket lookup, bounding the fleet's batch shapes at
    ``len(ladder) x len(shape_classes)``. Control-plane transitions
    land in ``gateway.events`` as typed ``FleetEvent`` records.

Lifecycle mirrors the engine's explicit state machine: NEW -> RUNNING
(first submit) -> CLOSED (``shutdown()``, which drains the queue, then
closes every engine); ``submit()`` on a closed gateway raises
``EngineClosed``.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

from repro_torch.common import resolve_device
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.fea import fea2d
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.registry import (ModelResolver, NoModelError,
                                        check_device)
from repro_torch.serve.scheduler import (BoundedEDFScheduler,
                                         shape_class_for, target_slots)
from repro_torch.serve.topo_service import TopoServingEngine
from repro_torch.serve.types import (EngineClosed, EngineState, FleetEvent,
                                     OverloadPolicy, RequestShed, TagStats,
                                     TopoFuture, TopoRequest, pool_stats)

__all__ = ["TopoGateway"]

Mesh = Tuple[int, int]


def _mesh_str(mesh: Mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


@dataclasses.dataclass
class _Canary:
    """One bucket's live canary experiment: the candidate model, the
    deterministic traffic split, and the per-tag evidence the
    promote/rollback decision is based on."""
    mesh: Mesh
    tag: Optional[str]
    params: object
    u_scale: Optional[float]
    fraction: float
    min_requests: int
    margin: float
    auto_rollback: bool
    engine: Optional[object] = None      # lazily-built canary engine
    active: bool = True                  # False: no new canary routes
    acc: float = 0.0                     # fraction rollover accumulator
    routed_canary: int = 0               # ground-truth routing counts
    routed_primary: int = 0
    canary_stats: TagStats = dataclasses.field(default_factory=TagStats)
    primary_stats: TagStats = dataclasses.field(default_factory=TagStats)

    def regression(self) -> Optional[str]:
        """The auto-rollback decision: a human-readable reason when the
        canary's acceptance or deadline metric has regressed beyond
        ``margin`` vs the CONCURRENT primary traffic (same bucket, same
        window), or None. Requires ``min_requests`` completions on BOTH
        sides — a verdict needs evidence, not noise."""
        c, p = self.canary_stats, self.primary_stats
        if (c.recent_completed < self.min_requests
                or p.recent_completed < self.min_requests):
            return None
        if c.recent_cronet_hit_rate < p.recent_cronet_hit_rate - self.margin:
            return (f"CRONet hit rate regressed: canary "
                    f"{c.recent_cronet_hit_rate:.1%} < primary "
                    f"{p.recent_cronet_hit_rate:.1%} - margin "
                    f"{self.margin:g}")
        if (c.recent_deadline_hit_rate
                < p.recent_deadline_hit_rate - self.margin):
            return (f"deadline hit rate regressed: canary "
                    f"{c.recent_deadline_hit_rate:.1%} < primary "
                    f"{p.recent_deadline_hit_rate:.1%} - margin "
                    f"{self.margin:g}")
        return None

    def describe(self) -> Dict:
        return {"tag": self.tag, "fraction": self.fraction,
                "active": self.active,
                "routed_canary": self.routed_canary,
                "routed_primary": self.routed_primary,
                "canary": self.canary_stats.snapshot(),
                "primary": self.primary_stats.snapshot()}


class TopoGateway:
    """Mesh-agnostic front door over a lazily-grown pool of per-mesh
    ``TopoServingEngine``s behind one bounded (priority, EDF) queue.

    Parameters
    ----------
    cfg, params, u_scale : the trained CRONet surrogate. ``cfg``'s own
        ``(nelx, nely)`` is only a template — each engine is built with
        ``dataclasses.replace(cfg, nelx=..., nely=...)`` for its bucket.
    slots : batch slots per engine (every mesh bucket gets its own slot
        group; engines also accept ``**engine_kwargs`` passthrough —
        e.g. ``TopoGateway(..., error_threshold=0.1)`` sets every bucket
        engine's residual gate, canaries included).
    max_pending : admission queue capacity; ``None`` = unbounded (the
        baseline the SHED policy is measured against).
    overload : ``OverloadPolicy`` or its string value — what a full
        queue does with the next submit.
    engine_depth : max in-flight requests per BUCKET (a canaried
        bucket's primary + canary engines share it) before the
        dispatcher stops forwarding to it (default ``2 * slots`` of the
        bucket's engine: enough to keep every slot fed plus a re-fill
        margin, small enough that EDF ordering decisions stay at the
        gateway where all meshes are visible).
    block_timeout : BLOCK policy only — seconds a full-queue submit may
        wait before raising ``QueueFull`` (``None`` = wait forever).
    engine_factory : override engine construction entirely,
        ``(nelx, nely) -> TopoServingEngine`` (tests inject slow or
        pre-built engines through this). A factory-backed gateway skips
        registry resolution and autoscaling for primary buckets — the
        factory owns those decisions.
    registry, model_tag : resolve the served model from a
        ``serve.registry.ModelRegistry`` instead of passing params
        explicitly: ``cfg``/``params``/``u_scale`` may then be omitted
        (they come from the checkpoint record; ``model_tag=None`` means
        latest). A registry-backed gateway can ``swap_model(tag)``
        (fleet-wide or per bucket with ``mesh=``), run ``canary(...)``
        experiments, and leases every tag it serves so
        ``registry.prune()`` never deletes a live version.
        ``TopoGateway.from_registry`` is the concise spelling.
    idle_evict_s : cold-bucket horizon in seconds — a bucket idle (no
        queued/in-flight/arriving work) longer than this is evicted and
        lazily rebuilt on next sight. ``None`` (default) disables
        eviction (the pool only grows, the pre-fleet behaviour).
    autoscale, min_slots, max_slots, scale_rate : slot-width
        autoscaling for (re)built buckets: width follows the bucket's
        observed arrival rate via ``scheduler.target_slots(rate,
        scale_rate, min_slots, max_slots)``. ``max_slots`` defaults to
        ``slots``; with ``autoscale=False`` (default) every bucket gets
        exactly ``slots``.
    ladder : optional width ladder passed through to every gateway-built
        engine (e.g. ``(2, 4, 8, 16)``): engines dispatch each tick at
        the smallest rung >= occupancy. With
        ``autoscale=True`` buckets are built WIDE (``max_slots``) and
        scaled LIVE per maintenance pass (``engine.set_target_slots``,
        recorded as ``FleetEvent("resize")``) — autoscale stops waiting
        for a cold eviction to change a width.
    shape_classes : optional canonical ``(nelx, nely)`` mesh classes.
        A submitted mesh is padded (``fea2d.pad_problem``, passive
        border masked out of the physics) onto the smallest class that
        fits BEFORE bucketing, so nearby meshes share one engine and
        the fleet's batch shapes grow with ``len(ladder) x
        len(shape_classes)`` instead of with distinct request meshes.
        Harvested densities are cropped back to the submitted mesh.
        Meshes no class fits keep their own exact-mesh bucket.
    canary_slots : slot width for canary engines (default
        ``min_slots`` — a canary serves a fraction of the bucket's
        traffic and shares its depth budget, so it starts narrow).
    harvest : optional serving-data sink (any object with a cheap
        ``record(req)`` and optionally ``flush()`` — the reference's
        ``serve.flywheel.HarvestLog`` has both).
        Every successfully completed request is offered to it on the
        completion path, so fell-back-to-FEA traffic can be harvested
        into fine-tuning data; a raising sink is recorded as a
        ``harvest-error`` FleetEvent, never propagated.
    canary_window : completion window for canary/primary ``TagStats``
        (``None`` = lifetime aggregates, the pre-flywheel behaviour).
        Auto-rollback and promotion verdicts then compare RECENT
        traffic, so an early bad patch cannot permanently condemn a
        canary that has since warmed up — and vice versa.
    bucket_window : completion window for the per-bucket acceptance
        stats behind ``bucket_stats()`` (the flywheel's trigger
        signal).
    workers : move the engine pool into worker processes;
        ``serve/workers.py`` is not ported yet, so ``workers=`` raises
        ``NotImplementedError``.
    device : where every engine of the pool runs and where registry
        versions are loaded: ``"cuda"`` (default; raises here, at
        construction, without a GPU) or ``"cpu"``. Explicit params must
        already lie on it.
    """

    RETIRED_LIMIT = 4096       # completed requests kept from dead engines
    EVENT_LIMIT = 256          # FleetEvent ring depth
    TRACE_LIMIT = 512          # completed uid -> Trace map depth

    def __init__(self, cfg: Optional[CRONetConfig] = None, params=None,
                 u_scale: Optional[float] = None, *,
                 slots: int = 4, max_pending: Optional[int] = 64,
                 overload: Union[OverloadPolicy, str] = OverloadPolicy.BLOCK,
                 engine_depth: Optional[int] = None,
                 block_timeout: Optional[float] = None,
                 starvation_horizon: float = 60.0,
                 engine_factory: Optional[
                     Callable[[int, int], TopoServingEngine]] = None,
                 registry=None, model_tag: Optional[str] = None,
                 idle_evict_s: Optional[float] = None,
                 autoscale: bool = False, min_slots: int = 2,
                 max_slots: Optional[int] = None, scale_rate: float = 1.0,
                 canary_slots: Optional[int] = None,
                 ladder: Optional[Tuple[int, ...]] = None,
                 shape_classes: Optional[List] = None,
                 harvest=None,
                 canary_window: Optional[int] = 64,
                 bucket_window: Optional[int] = 256,
                 trace_every: int = 0,
                 workers: Optional[int] = None,
                 device="cuda",
                 **engine_kwargs):
        if workers is not None:
            raise NotImplementedError(
                "workers= needs serve/workers.py, which the port does not "
                "have yet (ROADMAP.md §A.4); serve in-process instead")
        # resolved here, in the caller's thread: a missing GPU raises now,
        # not later in the dispatcher thread at the first engine build
        self.device = resolve_device(device)
        self.registry = registry
        self.model_tag = model_tag
        self._resolver: Optional[ModelResolver] = None
        record = None
        if params is None and registry is not None:
            params, record = registry.load(model_tag, device=self.device)
            cfg = cfg if cfg is not None else record.cfg
            u_scale = u_scale if u_scale is not None else record.u_scale
            self.model_tag = record.tag
        elif engine_factory is None:
            check_device(params, self.device)
        if registry is not None:
            self._resolver = ModelResolver(registry,
                                           default_tag=self.model_tag,
                                           device=self.device)
            if record is not None:
                self._resolver.prime(record.tag, params, record)
        if engine_factory is None and (cfg is None or params is None
                                       or u_scale is None):
            # a caller-supplied factory owns engine construction, so the
            # gateway itself never needs a model; otherwise one must come
            # from (cfg, params, u_scale) or the registry
            raise ValueError(
                "TopoGateway needs (cfg, params, u_scale) or a registry "
                "to resolve them from")
        self.cfg = cfg
        self.params = params
        self.u_scale = u_scale
        self.slots = slots
        self._auto_depth = engine_depth is None
        self.engine_depth = (engine_depth if engine_depth is not None
                             else 2 * slots)
        if self.engine_depth < 1:
            raise ValueError(f"engine_depth must be >= 1, "
                             f"got {self.engine_depth}")
        self.block_timeout = block_timeout
        self.idle_evict_s = idle_evict_s
        self.autoscale = autoscale
        self.min_slots = min_slots
        self.max_slots = max_slots if max_slots is not None else slots
        self.scale_rate = scale_rate
        self.canary_slots = (canary_slots if canary_slots is not None
                             else min_slots)
        self.ladder = tuple(int(r) for r in ladder) if ladder else None
        self.shape_classes = ([self._mesh_arg(c) for c in shape_classes]
                              if shape_classes else None)
        self._shape_class_set = (set(self.shape_classes)
                                 if self.shape_classes else set())
        self._rung_targets: Dict[Mesh, int] = {}  # last applied resize
        self._engine_kwargs = dict(engine_kwargs, device=self.device)
        self._owns_engines = engine_factory is None
        self._engine_factory = engine_factory or self._default_factory
        self._queue = BoundedEDFScheduler(max_pending, overload,
                                          starvation_horizon)
        self._engines: Dict[Mesh, TopoServingEngine] = {}
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._stopping = False
        self._closed = False
        self._inflight = 0           # offered and not yet resolved/shed
        self._failure: Optional[BaseException] = None
        self._swapping = False       # control-plane ops gate forwarding
        self._dispatch_busy = False  # dispatcher holds a popped entry
        self._maintaining = False    # dispatcher is inside _maintain()
        self._swap_count = 0
        # ---- fleet-operations state (dispatcher-owned unless noted)
        self._bucket_models: Dict[Mesh, Tuple] = {}   # pin: (tag, p, us)
        self._bucket_tags: Dict[Mesh, Optional[str]] = {}
        self._canaries: Dict[Mesh, _Canary] = {}
        self._dissolving: List[_Canary] = []   # rolled back, draining
        self._arrivals: Dict[Mesh, collections.deque] = {}  # submit times
        self._last_seen: Dict[Mesh, float] = {}
        self._evicted_meshes = set()
        self._retired: collections.deque = collections.deque(
            maxlen=self.RETIRED_LIMIT)
        self._retired_preemptions = 0
        self._retired_steps = 0
        self._evictions = 0
        self._rebuilds = 0
        self._rollbacks = 0
        self._promotions = 0
        self._lease_counts: Dict[str, int] = {}
        self.harvest = harvest
        self.canary_window = canary_window
        self.bucket_window = bucket_window
        self._bucket_stats: Dict[Mesh, TagStats] = {}
        self.events: collections.deque = collections.deque(
            maxlen=self.EVENT_LIMIT)
        # ---- observability: front-door trace sampling (every Nth
        # admission carries a repro.obs Trace; completed traces land in
        # a bounded uid -> Trace map behind ``trace(uid)``) and the
        # fleet-event counter mirroring the typed event log into the
        # process metrics registry
        self.trace_every = int(trace_every)
        self._trace_n = 0
        self._traces: collections.OrderedDict = collections.OrderedDict()
        self.metrics = obs_metrics.default_registry()
        self._m_events = self.metrics.counter(
            "fleet_events_total",
            "typed control-plane fleet events by kind")
        self.metrics.gauge(
            "topo_engines", "live per-mesh engines in the gateway pool",
            callback=lambda: len(self._engines))
        self.metrics.gauge(
            "topo_gateway_inflight",
            "requests offered to the gateway and not yet resolved",
            callback=lambda: self._inflight)
        self._lease(self.model_tag)

    @classmethod
    def from_registry(cls, registry, tag: Optional[str] = None,
                      **kwargs) -> "TopoGateway":
        """Build a gateway serving a registry checkpoint (``tag=None``
        = latest); the registry stays attached for ``swap_model`` /
        ``canary`` and per-bucket resolution."""
        return cls(registry=registry, model_tag=tag, **kwargs)

    # ------------------------------------------------------------ leases

    def _lease(self, tag: Optional[str]):
        """Acquire a live-version lease so ``registry.prune`` defers the
        tag; no-op without a registry or for explicit-params models.
        The registry read stays outside the queue lock; only the
        refcount mirror is guarded (dispatcher and user threads both
        lease)."""
        if self.registry is None or not tag:
            return
        try:
            self.registry.acquire(tag)
        except NoModelError:
            return   # explicit params under an unregistered tag
        with self._queue.cond:
            self._lease_counts[tag] = self._lease_counts.get(tag, 0) + 1

    def _unlease(self, tag: Optional[str]):
        if self.registry is None or not tag:
            return
        with self._queue.cond:
            held = self._lease_counts.get(tag, 0) > 0
            if held:
                self._lease_counts[tag] -= 1
                if not self._lease_counts[tag]:
                    del self._lease_counts[tag]
        if held:
            self.registry.release(tag)

    def _release_all_leases(self):
        if self.registry is None:
            return
        with self._queue.cond:
            held, self._lease_counts = dict(self._lease_counts), {}
        for tag, n in held.items():
            for _ in range(n):
                self.registry.release(tag)

    # ------------------------------------------------------------ engines

    @staticmethod
    def _mesh_arg(mesh) -> Mesh:
        """Normalize a mesh argument: ``(nelx, nely)`` or ``"AxB"``."""
        if isinstance(mesh, str):
            a, b = mesh.lower().split("x")
            return (int(a), int(b))
        return (int(mesh[0]), int(mesh[1]))

    def _arch_compatible(self, other: CRONetConfig) -> bool:
        """May a checkpoint trained under ``other`` serve through this
        gateway's compiled steps? Mesh/name/dtype aside (those are
        per-bucket), the architectures must match."""
        want = dataclasses.replace(other, nelx=self.cfg.nelx,
                                   nely=self.cfg.nely, name=self.cfg.name,
                                   dtype=self.cfg.dtype)
        return want == self.cfg

    def _checkpoint_for(self, tag: Optional[str], params,
                        u_scale: Optional[float]):
        """Resolve a (tag, params, u_scale) triple for swap/canary: from
        explicit arrays, or from the registry — failing fast (BEFORE any
        bucket drains) on an architecture mismatch or, for explicit
        params, a tree on another device than the gateway's."""
        if params is not None:
            if self._owns_engines:
                check_device(params, self.device)
            return tag, params, u_scale
        if self.registry is None:
            raise ValueError("swap_model/canary need explicit params "
                             "when the gateway has no registry attached")
        rec = (self.registry.get(tag) if tag is not None
               else self.registry.latest())
        if rec is None:
            raise NoModelError(
                f"registry {self.registry.root} is empty — train a "
                f"surrogate and register() it first")
        if not self._arch_compatible(rec.cfg):
            raise ValueError(
                f"checkpoint {rec.tag!r} was trained under an "
                f"incompatible config ({rec.cfg.name}: e.g. "
                f"hist_len={rec.cfg.hist_len} vs "
                f"{self.cfg.hist_len}); build a new gateway for it")
        params, rec = self._resolver.load(rec.tag)
        return rec.tag, params, (u_scale if u_scale is not None
                                 else rec.u_scale)

    def _observed_rate(self, mesh: Mesh,
                       now: Optional[float] = None) -> float:
        """Observed arrival rate (requests/s) for a bucket over its
        recent submit window; 0.0 with fewer than two arrivals.
        N arrivals span N-1 inter-arrival intervals, so the estimator is
        ``(N - 1) / (now - first)`` — ``len(d) / span`` would report two
        arrivals 1 s apart as 2 req/s and bias every width decision
        high. The numerator is frozen while the denominator stretches to
        ``now`` (monotonic clock, like the stamps in ``d``), so a bucket
        that stopped arriving decays toward 0 instead of remembering its
        last burst."""
        d = self._arrivals.get(mesh)
        if not d or len(d) < 2:
            return 0.0
        now = time.monotonic() if now is None else now
        return (len(d) - 1) / max(now - d[0], 1e-9)

    def _slots_for(self, mesh: Mesh) -> int:
        if self.ladder is not None and self.autoscale:
            # ladder engines are built WIDE and scaled LIVE: the per-tick
            # rung (occupancy) and the maintenance-pass admission cap
            # (set_target_slots) do the narrowing, without a rebuild
            return self.max_slots
        if not self.autoscale:
            return self.slots
        return target_slots(self._observed_rate(mesh), self.scale_rate,
                            self.min_slots, self.max_slots)

    def _depth_for(self, mesh: Mesh) -> int:
        """Per-bucket in-flight budget: follows the bucket engine's
        actual slot width under the auto default (an autoscaled narrow
        bucket should not queue 2x the FLEET width into its engine)."""
        if self._auto_depth:
            eng = self._engines.get(mesh)
            if eng is not None:
                return 2 * getattr(eng, "slots", self.slots)
        return self.engine_depth

    def _resolve_bucket_model(self, mesh: Mesh):
        """(tag, params, u_scale) for a NEW primary engine of ``mesh``:
        explicit per-bucket pin > mesh-specialized registry version
        (architecture-compatible ones only) > fleet default."""
        pin = self._bucket_models.get(mesh)
        if pin is not None:
            tag, params, u_scale = pin
            if params is None:      # tag pinned before params were loaded
                params, rec = self._resolver.load(tag)
                u_scale = rec.u_scale if u_scale is None else u_scale
                self._bucket_models[mesh] = (tag, params, u_scale)
            if u_scale is None:
                # an explicit-params pin without u_scale: the live swap
                # kept the engine's old scale, so a rebuild must too —
                # the engine ctor needs a real float
                u_scale = self.u_scale
            return tag, params, u_scale
        if self._resolver is not None:
            try:
                rec = self._resolver.resolve(mesh)
            except NoModelError:
                rec = None
            if (rec is not None and rec.tag != self.model_tag
                    and self._arch_compatible(rec.cfg)):
                params, rec = self._resolver.load(rec.tag)
                return rec.tag, params, rec.u_scale
        return self.model_tag, self.params, self.u_scale

    def _engine_spec(self, cfg, mesh: Mesh, tag: Optional[str],
                     params, u_scale, *, slots: int) -> Dict:
        """Picklable build recipe for an engine built elsewhere (consumed
        by ``topo_service.engine_from_spec``, as a worker process does in
        the reference; its ``engine_kwargs`` carry the device). Ships a
        ``registry_root`` REFERENCE instead of the param tree only when
        the resolver cache proves these exact params came from the
        shared on-disk registry — an explicit-params pin (or an
        unregistered tag) must travel by value or the worker would
        silently serve different weights than the gateway promised
        (the bitwise contract)."""
        spec = {"cfg": cfg, "slots": slots, "model_tag": tag,
                "u_scale": u_scale,
                "ladder": self.ladder,
                "shape_padded": mesh in self._shape_class_set,
                "engine_kwargs": dict(self._engine_kwargs)}
        root = getattr(self.registry, "root", None)
        if (root is not None and self._resolver is not None
                and self._resolver.holds(tag, params)):
            spec["registry_root"] = root
        else:
            spec["params"] = params
        return spec

    def _default_factory(self, nelx: int, nely: int) -> TopoServingEngine:
        mesh = (nelx, nely)
        tag, params, u_scale = self._resolve_bucket_model(mesh)
        cfg = dataclasses.replace(self.cfg, nelx=nelx, nely=nely)
        return TopoServingEngine(cfg, params, u_scale,
                                 slots=self._slots_for(mesh),
                                 model_tag=tag,
                                 ladder=self.ladder,
                                 shape_padded=mesh in self._shape_class_set,
                                 **self._engine_kwargs)

    def _engine_for(self, mesh: Mesh) -> TopoServingEngine:
        """Lazy per-mesh engine creation (dispatcher thread only, so no
        lock is needed around construction; the dict write is atomic)."""
        eng = self._engines.get(mesh)
        if eng is None:
            eng = self._engine_factory(*mesh)
            if (eng.cfg.nelx, eng.cfg.nely) != mesh:
                raise ValueError(
                    f"engine_factory built a {eng.cfg.nelx}x{eng.cfg.nely} "
                    f"engine for mesh {_mesh_str(mesh)}")
            self._engines[mesh] = eng
            tag = getattr(eng, "model_tag", None)
            self._bucket_tags[mesh] = tag
            self._lease(tag)
            if mesh in self._evicted_meshes:
                # lazy rebuild after a cold eviction: same model (the
                # bucket pin / resolver reproduces it), possibly a new
                # autoscaled width — the bitwise contract is width-
                # independent, so densities stay equal either way
                self._evicted_meshes.discard(mesh)
                self._rebuilds += 1
                self._record_event(
                    "rebuild", mesh, tag,
                    details={"slots": getattr(eng, "slots", None)})
        return eng

    @property
    def engines(self) -> Dict[Mesh, TopoServingEngine]:
        """Live view of the per-mesh engine pool (read-only by contract)."""
        return self._engines

    def _record_event(self, kind: str, mesh: Optional[Mesh],
                      tag: Optional[str], reason: str = "",
                      details: Optional[Dict] = None):
        # dual stamps, taken at the same instant: wall-clock ``t`` for
        # humans, monotonic ``t_mono`` so events order against request
        # stamps (submit_t/admitted_t/deadline) — the log's sort key
        self.events.append(FleetEvent(kind=kind, mesh=mesh, tag=tag,
                                      t=time.time(), reason=reason,
                                      details=details or {},
                                      t_mono=time.monotonic()))
        self._m_events.inc(kind=kind)

    def fleet_events(self, kind: Optional[str] = None) -> List[FleetEvent]:
        """The typed fleet-event log, ordered on the monotonic stamp
        (``t_mono``) so it can be merged with request timelines;
        optionally filtered by ``kind``."""
        with self._queue.cond:
            evs = list(self.events)
        evs.sort(key=lambda e: e.t_mono)
        if kind is not None:
            evs = [e for e in evs if e.kind == kind]
        return evs

    def trace(self, uid: int):
        """Completed-request trace lookup (``repro.obs.trace.Trace`` or
        None when the request wasn't sampled / scrolled out of the
        bounded trace map)."""
        with self._queue.cond:
            return self._traces.get(uid)

    # ---------------------------------------------------------- lifecycle

    @property
    def state(self) -> EngineState:
        if self._failure is not None:
            return EngineState.FAILED
        if self._closed:
            return EngineState.CLOSED
        with self._lifecycle:
            if self._running and self._thread is not None \
                    and self._thread.is_alive():
                return EngineState.RUNNING
        return EngineState.NEW

    @property
    def running(self) -> bool:
        return self.state is EngineState.RUNNING

    @property
    def inflight(self) -> int:
        return self._inflight

    def start(self):
        """Spawn the dispatcher thread (idempotent; submit() calls it)."""
        with self._lifecycle:
            if self._closed:
                raise EngineClosed("gateway is shut down; build a new one")
            if self._failure is not None:
                raise RuntimeError("gateway failed; build a new one") \
                    from self._failure
            if self._running and self._thread is not None \
                    and self._thread.is_alive():
                return
            self._running = True
            self._thread = threading.Thread(target=self._dispatch_loop,
                                            name="topo-gateway-dispatch",
                                            daemon=True)
            self._thread.start()

    def _all_engines(self) -> List:
        """Every engine the gateway currently owns a handle to: the
        primary pool plus live/draining canary engines (snapshotted
        under the queue lock — the dispatcher's maintenance pass
        mutates these collections concurrently)."""
        with self._queue.cond:
            engines = list(self._engines.values())
            for ctrl in (list(self._canaries.values())
                         + list(self._dissolving)):
                if ctrl.engine is not None:
                    engines.append(ctrl.engine)
        return engines

    def shutdown(self, wait: bool = True):
        """Terminal: stop accepting submissions (later ``submit()``
        raises ``EngineClosed``), let the dispatcher drain the admission
        queue, then close the per-mesh engines (canary engines
        included). In-flight work completes; BLOCKed submitters are
        woken with ``EngineClosed``. With ``wait=False`` the drain
        happens asynchronously on the dispatcher thread, which then
        closes the engines the gateway built itself — engines from a
        caller-supplied ``engine_factory`` are only closed by a
        ``wait=True`` shutdown (the factory's owner may be sharing
        them)."""
        with self._lifecycle:
            if self._closed and self._thread is None:
                return
            self._closed = True
            with self._queue.cond:
                self._stopping = True
                self._queue.close()   # wakes + fails BLOCK-policy waiters
                self._queue.cond.notify_all()
            thread = self._thread
        if wait:
            if thread is not None:
                thread.join()
            for eng in self._all_engines():
                eng.shutdown(wait=True)
            # harvested-but-unflushed serving data must survive the
            # process exiting right after shutdown(): everything still
            # in the sink's in-memory buffer goes to the spool NOW
            self._flush_harvest("shutdown")
            self._release_all_leases()
            with self._lifecycle:
                self._running = False
                self._thread = None

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every accepted request has resolved (completed,
        shed, or failed)."""
        with self._queue.cond:
            return self._queue.cond.wait_for(
                lambda: self._inflight == 0 or self._failure is not None,
                timeout)

    # ------------------------------------------------------ control gate

    @contextlib.contextmanager
    def _gate(self, timeout: Optional[float]):
        """Quiesce the dispatcher for a control-plane operation (swap /
        promote / rollback / forced evict): gate forwarding (``_ready``
        goes False for everything — queued requests WAIT, none are
        dropped; the bounded queue and overload policy still apply to
        new submits), then wait out an entry the dispatcher may already
        hold and any maintenance pass in progress."""
        with self._queue.cond:
            if self._swapping:
                raise RuntimeError(
                    "another control-plane operation (swap/promote/"
                    "rollback/evict) is already in progress")
            self._swapping = True
            if not self._queue.cond.wait_for(
                    lambda: not (self._dispatch_busy or self._maintaining),
                    timeout):
                self._swapping = False
                self._queue.cond.notify_all()
                raise TimeoutError("dispatcher did not quiesce")
        try:
            yield
        finally:
            with self._queue.cond:
                self._swapping = False
                self._queue.cond.notify_all()   # resume forwarding

    # --------------------------------------------------------- model swap

    def _swap_bucket(self, mesh: Mesh, eng, params,
                     u_scale: Optional[float], new_tag: Optional[str],
                     timeout: Optional[float]):
        """Drain/stop/swap/restart one bucket (dispatcher quiesced by
        the caller's gate; the engine restarts lazily on next forward)."""
        if not eng.drain(timeout):
            raise TimeoutError(
                f"bucket {_mesh_str(mesh)} did not drain within "
                f"{timeout}s; old model still serving")
        eng.stop(wait=True)
        eng.swap_params(params, u_scale=u_scale, model_tag=new_tag)
        old = self._bucket_tags.get(mesh)
        if old != new_tag:
            self._unlease(old)
            self._lease(new_tag)
        self._bucket_tags[mesh] = new_tag

    def swap_model(self, tag: Optional[str] = None, *, mesh=None,
                   params=None, u_scale: Optional[float] = None,
                   timeout: Optional[float] = None) -> str:
        """Hot-swap bucket(s) to another checkpoint without dropping a
        single queued or in-flight request.

        The new model comes from the attached registry (``tag``; None =
        latest) or from explicit ``params``/``u_scale``. With
        ``mesh=None`` this is the FLEET rollout: every built bucket is
        moved, per-bucket pins are cleared, and the new tag becomes the
        fleet default future buckets inherit — on an EMPTY pool that is
        the whole effect: the pending tag is recorded and applied on
        first bucket build (nothing is silently ignored). With
        ``mesh=(nelx, nely)`` (or ``"AxB"``) only that bucket swaps and
        stays PINNED to the tag — built or not (an unbuilt bucket
        applies the pin when first sighted). A bucket with an active
        canary refuses to swap (``promote()`` or ``rollback()`` first).

        Sequence per bucket, per the engines' stop()-restartable
        lifecycle: gate the dispatcher, wait out the in-flight entry
        handshake, ``drain()`` (in-flight requests complete on the old
        model), ``stop()`` + ``swap_params()`` (params re-upload happens
        in the shard ``activate()`` on restart), un-gate — buckets
        restart lazily as the backlog forwards.

        Returns the new model tag. Raises ``TimeoutError`` if a bucket
        does not drain within ``timeout``; buckets swapped before the
        timeout keep the NEW model, the rest keep the old one — re-invoke
        ``swap_model`` to finish the rollout (already-swapped buckets
        just swap again)."""
        if self._closed:
            raise EngineClosed("gateway is shut down")
        new_tag, params, u_scale = self._checkpoint_for(tag, params,
                                                        u_scale)
        if mesh is not None:
            mesh = self._mesh_arg(mesh)
        with self._gate(timeout):
            conflicted = ([mesh] if mesh in self._canaries
                          else list(self._canaries) if mesh is None
                          else [])
            if conflicted:
                raise RuntimeError(
                    f"bucket(s) "
                    f"{', '.join(_mesh_str(m) for m in conflicted)} have "
                    f"an active canary; promote() or rollback() first")
            targets = [mesh] if mesh is not None else list(self._engines)
            for m in targets:
                eng = self._engines.get(m)
                if eng is None:
                    continue       # unbuilt bucket: the pin below covers it
                self._swap_bucket(m, eng, params, u_scale, new_tag,
                                  timeout)
            if mesh is None:
                self.params = params
                if u_scale is not None:
                    self.u_scale = u_scale
                old = self.model_tag
                self.model_tag = new_tag
                if self._resolver is not None:
                    self._resolver.default_tag = new_tag
                if old != new_tag:
                    self._unlease(old)
                    self._lease(new_tag)
                self._bucket_models.clear()
            else:
                self._bucket_models[mesh] = (new_tag, params, u_scale)
            self._swap_count += 1
            self._record_event("swap", mesh, new_tag)
        return new_tag

    # ------------------------------------------------------------- canary

    def canary(self, tag: Optional[str] = None, *, fraction: float = 0.1,
               mesh=None, params=None, u_scale: Optional[float] = None,
               min_requests: int = 8, margin: float = 0.05,
               auto_rollback: bool = True) -> List[Mesh]:
        """Start routing ``fraction`` of a bucket's admissions to a
        canary engine serving ``tag`` (from the registry, or explicit
        ``params``/``u_scale``). ``mesh=None`` canaries every CURRENT
        bucket (one controller each); ``mesh=(nelx, nely)`` targets one
        bucket, built or not. Returns the canaried meshes.

        The split is a deterministic rollover accumulator — over any
        window of N routed admissions the canary count is within one of
        ``fraction * N``. The canary engine shares the bucket's
        in-flight depth budget and is built lazily on the first canary
        route. Per-tag stats accumulate for both sides; with
        ``auto_rollback`` (default) the canary is rolled back the
        moment its CRONet acceptance rate or deadline hit rate falls
        more than ``margin`` below the concurrent primary traffic
        (``min_requests`` completions on each side first). End the
        experiment with ``promote()`` or ``rollback()``."""
        if self._closed:
            raise EngineClosed("gateway is shut down")
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        new_tag, params, u_scale = self._checkpoint_for(tag, params,
                                                        u_scale)
        if new_tag is None:
            # per-tag stats, completion stamping, and the rollback
            # verdict all key on the tag — an anonymous canary would be
            # unobservable (and unattributable) by design
            raise ValueError("canary needs a tag (explicit-params "
                             "canaries included)")
        if mesh is not None:
            meshes = [self._mesh_arg(mesh)]
        else:
            meshes = list(self._engines)
            if not meshes:
                raise RuntimeError(
                    "no buckets to canary (pool is empty); pass "
                    "mesh=(nelx, nely) to target a future bucket")
        with self._queue.cond:
            if self._swapping:
                # a swap/promote/rollback/evict is mid-flight: installing
                # a controller now would defeat its canary-conflict check
                raise RuntimeError(
                    "a control-plane operation (swap/promote/rollback/"
                    "evict) is in progress; retry canary() after it")
            taken = [m for m in meshes if m in self._canaries]
            if taken:
                raise RuntimeError(
                    f"bucket(s) {', '.join(_mesh_str(m) for m in taken)} "
                    f"already have an active canary")
            for m in meshes:
                self._canaries[m] = _Canary(
                    mesh=m, tag=new_tag, params=params, u_scale=u_scale,
                    fraction=fraction, min_requests=min_requests,
                    margin=margin, auto_rollback=auto_rollback,
                    canary_stats=TagStats(window=self.canary_window),
                    primary_stats=TagStats(window=self.canary_window))
                self._record_event("canary-start", m, new_tag,
                                   details={"fraction": fraction,
                                            "margin": margin})
        # the version is LIVE from canary start (prune must defer it even
        # before the canary engine first builds); the registry read in
        # acquire() stays OUTSIDE the queue lock so a slow registry disk
        # cannot stall admission/completion traffic
        for m in meshes:
            self._lease(new_tag)
        return meshes

    def _canary_engine_for(self, ctrl: _Canary):
        """Lazily build the canary engine (dispatcher thread only); on
        a dead or unbuildable canary engine the controller is rolled
        back (traffic reverts to primary) and None is returned."""
        ce = ctrl.engine
        if ce is None:
            try:
                if self._owns_engines:
                    cfg = dataclasses.replace(self.cfg,
                                              nelx=ctrl.mesh[0],
                                              nely=ctrl.mesh[1])
                    u_scale = (ctrl.u_scale if ctrl.u_scale is not None
                               else self.u_scale)
                    ce = TopoServingEngine(
                        cfg, ctrl.params, u_scale,
                        slots=self.canary_slots, model_tag=ctrl.tag,
                        ladder=self.ladder,
                        shape_padded=ctrl.mesh in self._shape_class_set,
                        **self._engine_kwargs)
                else:
                    ce = self._engine_factory(*ctrl.mesh)
                    if ce is self._engines.get(ctrl.mesh):
                        # a caching factory handed back the PRIMARY
                        # engine: swapping its params would corrupt the
                        # bucket, not canary it
                        raise RuntimeError(
                            "engine_factory returned the bucket's "
                            "primary engine for the canary; canarying "
                            "needs a factory that builds fresh engines")
                    ce.swap_params(ctrl.params, u_scale=ctrl.u_scale,
                                   model_tag=ctrl.tag)
            except BaseException as exc:
                self._auto_rollback(ctrl,
                                    f"canary engine build failed: {exc!r}")
                return None
            ctrl.engine = ce
        if getattr(ce, "_failure", None) is not None \
                or getattr(ce, "_closed", False):
            self._auto_rollback(ctrl, "canary engine died")
            return None
        return ce

    def _auto_rollback(self, ctrl: _Canary, reason: str):
        """Rollback decided off the dispatcher/completion path: revert
        routing NOW, defer the canary engine's drain + close to the
        dispatcher's maintenance pass (nothing in flight is dropped —
        the canary engine finishes what it holds)."""
        with self._queue.cond:
            if not ctrl.active and self._canaries.get(ctrl.mesh) is not ctrl:
                return   # already decided
            ctrl.active = False
            if self._canaries.get(ctrl.mesh) is ctrl:
                del self._canaries[ctrl.mesh]
            self._dissolving.append(ctrl)
            self._rollbacks += 1
            self._record_event("rollback", ctrl.mesh, ctrl.tag, reason,
                               details=ctrl.describe())
            self._queue.cond.notify_all()

    def rollback(self, mesh=None, reason: str = "manual",
                 timeout: Optional[float] = None) -> List[str]:
        """End canary experiment(s) and revert all traffic to the
        bucket's primary model. Synchronous: the canary engine drains
        (its in-flight requests complete, correctly tagged) and is
        closed before returning — zero dropped requests, reusing the
        swap drain machinery. ``mesh=None`` rolls back every active
        canary. Returns the rolled-back tags."""
        tags = []
        with self._gate(timeout):
            meshes = ([self._mesh_arg(mesh)] if mesh is not None
                      else list(self._canaries))
            for m in meshes:
                ctrl = self._canaries.get(m)
                if ctrl is None:
                    raise RuntimeError(
                        f"no active canary on bucket {_mesh_str(m)} "
                        f"(it may have auto-rolled back already — see "
                        f"gateway.events)")
                # drain FIRST: a timeout leaves the experiment intact
                # (the gate blocks new routes while we wait)
                if ctrl.engine is not None \
                        and not ctrl.engine.drain(timeout):
                    raise TimeoutError(
                        f"canary engine {_mesh_str(m)} did not drain "
                        f"within {timeout}s")
                with self._queue.cond:
                    if self._canaries.get(m) is not ctrl:
                        continue   # auto-rollback fired during the
                        #            drain: it already ended, honor it
                    ctrl.active = False
                    del self._canaries[m]
                self._rollbacks += 1
                self._record_event("rollback", m, ctrl.tag, reason,
                                   details=ctrl.describe())
                if ctrl.engine is not None:
                    self._retire_engine(ctrl.engine)
                    ctrl.engine.shutdown(wait=True)
                self._unlease(ctrl.tag)
                tags.append(ctrl.tag)
        return tags

    def promote(self, mesh=None,
                timeout: Optional[float] = None) -> List[str]:
        """Graduate canary experiment(s): the canary tag becomes the
        bucket's serving model (pinned), via the same drain/stop/swap
        machinery as ``swap_model`` — zero dropped requests. The canary
        engine is drained and closed; the registry (when attached)
        records ``promoted_at`` on the tag. ``mesh=None`` promotes
        every active canary. Returns the promoted tags."""
        tags = []
        with self._gate(timeout):
            meshes = ([self._mesh_arg(mesh)] if mesh is not None
                      else list(self._canaries))
            if not meshes:
                raise RuntimeError("no active canary to promote")
            for m in meshes:
                ctrl = self._canaries.get(m)
                if ctrl is None:
                    raise RuntimeError(
                        f"no active canary on bucket {_mesh_str(m)} "
                        f"(it may have auto-rolled back already — see "
                        f"gateway.events)")
                # drain the canary side FIRST — a timeout at any drain
                # leaves the experiment intact for a retry
                if ctrl.engine is not None \
                        and not ctrl.engine.drain(timeout):
                    raise TimeoutError(
                        f"canary engine {_mesh_str(m)} did not drain "
                        f"within {timeout}s")
                with self._queue.cond:
                    if self._canaries.get(m) is not ctrl:
                        continue   # auto-rollback fired during the
                        #            drain: a regressed canary must NOT
                        #            be promoted
                    # freeze the verdict: completions during the primary
                    # drain below must not auto-rollback a canary we are
                    # committing to (evaluation requires active=True and
                    # runs under this same lock)
                    ctrl.active = False
                u_scale = (ctrl.u_scale if ctrl.u_scale is not None
                           else self.u_scale)
                eng = self._engines.get(m)
                if eng is not None:
                    self._swap_bucket(m, eng, ctrl.params, u_scale,
                                      ctrl.tag, timeout)
                else:
                    self._bucket_tags[m] = ctrl.tag
                del self._canaries[m]
                self._bucket_models[m] = (ctrl.tag, ctrl.params, u_scale)
                if ctrl.engine is not None:
                    self._retire_engine(ctrl.engine)
                    ctrl.engine.shutdown(wait=True)
                self._unlease(ctrl.tag)
                if self.registry is not None and ctrl.tag:
                    try:
                        self.registry.promote(ctrl.tag)
                    except NoModelError:
                        pass   # explicit-params canary: nothing to stamp
                self._promotions += 1
                self._record_event("promote", m, ctrl.tag,
                                   details=ctrl.describe())
                tags.append(ctrl.tag)
        return tags

    def canary_stats(self, mesh=None) -> Dict:
        """Snapshot of the active canary controller(s): routing counts
        and per-tag stats, keyed by ``"AxB"`` (or the single bucket's
        snapshot when ``mesh`` is given)."""
        with self._queue.cond:
            if mesh is not None:
                ctrl = self._canaries.get(self._mesh_arg(mesh))
                if ctrl is None:
                    raise RuntimeError(
                        f"no active canary on bucket {mesh}")
                return ctrl.describe()
            return {_mesh_str(m): c.describe()
                    for m, c in self._canaries.items()}

    def serving_tag(self, mesh) -> Optional[str]:
        """The registry tag currently serving a bucket: its pinned
        per-bucket tag when one was swapped/promoted in, the fleet
        default otherwise (may be None on an explicit-params gateway).
        This is the flywheel's warm-start parent."""
        mesh = self._mesh_arg(mesh)
        with self._queue.cond:
            if mesh in self._bucket_tags:
                return self._bucket_tags[mesh]
        return self.model_tag

    def bucket_stats(self, mesh=None):
        """Windowed per-bucket serving stats (``TagStats.snapshot()``
        per mesh over the last ``bucket_window`` completions). With
        ``mesh=`` returns that one bucket's snapshot (or None before
        its first completion); otherwise a ``{"AxB": snapshot}`` dict.
        This is the flywheel trigger signal: ``recent_cronet_hit_rate``
        below threshold on a bucket means its serving model is losing
        to the residual gate on live traffic."""
        with self._queue.cond:
            if mesh is not None:
                st = self._bucket_stats.get(self._mesh_arg(mesh))
                return None if st is None else st.snapshot()
            return {_mesh_str(m): s.snapshot()
                    for m, s in self._bucket_stats.items()}

    def record_event(self, kind: str, mesh=None, tag: Optional[str] = None,
                     reason: str = "", details: Optional[Dict] = None):
        """Public FleetEvent append — the flywheel controller narrates
        its state machine (``flywheel-*`` kinds) into the same ring the
        gateway's own swap/canary/rollback events land in, so one
        ``gateway.events`` read tells the whole fleet story."""
        self._record_event(kind, self._mesh_arg(mesh)
                           if mesh is not None else None,
                           tag, reason, details)

    def _flush_harvest(self, reason: str = ""):
        """Push the harvest sink's in-memory buffer to its spool (a
        sink without ``flush`` — or without a buffer — is a no-op).
        Called on shutdown: records buffered when the gateway closes
        must not evaporate with the process. A raising sink is
        a ``harvest-error`` event, never a failed shutdown."""
        h = self.harvest
        flush = getattr(h, "flush", None)
        if flush is None:
            return
        try:
            flush()
        except Exception as exc:
            self._record_event("harvest-error", None, None,
                               reason=f"flush ({reason}) failed: {exc!r}")

    # --------------------------------------------------------- elasticity

    def _retire_engine(self, eng):
        """Fold a dying engine's history into the gateway's retired
        stats so eviction/rollback never loses completed-request
        accounting (the soak test's stats-balance invariant). Gateway
        state mutates under the queue lock — a concurrent
        ``throughput_stats`` reader snapshots under the same lock."""
        with eng._sched.cond:
            completed = list(eng._completed)
        preempt, steps = eng.preemptions, eng.total_steps
        with self._queue.cond:
            self._retired.extend(completed)
            self._retired_preemptions += preempt
            self._retired_steps += steps

    def _evict(self, mesh: Mesh, eng, reason: str, wait: bool = False):
        """Shut an idle bucket down and forget it (rebuilt lazily on
        next sight). Caller guarantees idleness (no queued/in-flight
        work for the mesh) and that no canary targets it."""
        self._retire_engine(eng)
        del self._engines[mesh]
        tag = self._bucket_tags.pop(mesh, None)
        self._rung_targets.pop(mesh, None)
        self._unlease(tag)
        self._evicted_meshes.add(mesh)
        self._evictions += 1
        eng.shutdown(wait=wait)
        self._record_event("evict", mesh, tag, reason)

    def _mesh_queued(self, mesh: Mesh) -> bool:
        with self._queue.cond:
            return any(e.payload[0].mesh == mesh
                       for e in self._queue._heap)

    def evict_bucket(self, mesh, timeout: Optional[float] = None) -> bool:
        """Forced cold eviction of one bucket (the timer-driven path
        uses ``idle_evict_s``): shut the engine down NOW and rebuild
        lazily on next sight. Returns False when the bucket does not
        exist; raises if it is not idle or has an active canary."""
        mesh = self._mesh_arg(mesh)
        with self._gate(timeout):
            eng = self._engines.get(mesh)
            if eng is None:
                return False
            if mesh in self._canaries:
                raise RuntimeError(
                    f"bucket {_mesh_str(mesh)} has an active canary; "
                    f"promote() or rollback() first")
            if eng.inflight or self._mesh_queued(mesh):
                raise RuntimeError(
                    f"bucket {_mesh_str(mesh)} is not idle")
            self._evict(mesh, eng, reason="forced", wait=True)
        return True

    def _maintain(self):
        """Dispatcher-thread housekeeping between forwards: finalize
        rolled-back canaries once their engine drains, apply live
        ladder-rung targets to autoscaled buckets, and evict cold
        buckets past the idle horizon."""
        if self._dissolving:
            # swap the list out and merge the survivors back under the
            # lock: _on_request_done appends rolled-back controllers
            # concurrently, and a plain reassign would drop them (leaked
            # tick-loop threads + a never-released lease)
            with self._queue.cond:
                pending, self._dissolving = self._dissolving, []
            keep = []
            for ctrl in pending:
                ce = ctrl.engine
                if ce is None:
                    self._unlease(ctrl.tag)   # never built: lease only
                elif (ce.inflight == 0
                      or getattr(ce, "_failure", None) is not None
                      or getattr(ce, "_closed", False)):
                    self._retire_engine(ce)
                    ce.shutdown(wait=False)
                    self._unlease(ctrl.tag)
                else:
                    keep.append(ctrl)
            if keep:
                with self._queue.cond:
                    self._dissolving.extend(keep)
        if self.autoscale and self.ladder is not None and self._owns_engines:
            # LIVE width targets: ladder engines consume target_slots per
            # tick (set_target_slots caps admissions at a rung), so
            # autoscale acts here — every maintenance pass — instead of
            # waiting for a cold eviction + rebuild to change a width
            now_m = time.monotonic()
            for mesh, eng in list(self._engines.items()):
                if getattr(eng, "ladder", None) is None:
                    continue
                rate = self._observed_rate(mesh, now_m)
                tgt = target_slots(rate, self.scale_rate, self.min_slots,
                                   getattr(eng, "slots", self.max_slots))
                applied = eng.set_target_slots(tgt)
                if self._rung_targets.get(mesh) != applied:
                    self._rung_targets[mesh] = applied
                    self._record_event(
                        "resize", mesh, self._bucket_tags.get(mesh),
                        details={"target_slots": applied,
                                 "rate": round(rate, 3)})
        if self.idle_evict_s is not None:
            # idle-eviction clock: monotonic, matching _last_seen — an
            # NTP step must not fabricate (or mask) a cold horizon
            now = time.monotonic()
            for mesh, eng in list(self._engines.items()):
                if mesh in self._canaries or eng.inflight:
                    continue
                seen = self._last_seen.get(mesh, now)
                if now - seen < self.idle_evict_s:
                    continue
                if self._mesh_queued(mesh):
                    continue
                self._evict(mesh, eng,
                            reason=f"idle > {self.idle_evict_s:g}s")

    def _needs_maintenance(self) -> bool:
        return bool(self._dissolving) or (
            self.idle_evict_s is not None and bool(self._engines)) or (
            self.autoscale and self.ladder is not None
            and bool(self._engines))

    # ---------------------------------------------------------- streaming

    def submit(self, req: TopoRequest, deadline_s: Optional[float] = None,
               priority: int = 0) -> TopoFuture:
        """Thread-safe mesh-agnostic admission: stamp the request, rank
        it (priority, EDF) in the shared bounded queue, and return its
        end-to-end future. Applies the overload policy when the queue is
        full; raises ``EngineClosed`` after ``shutdown()``."""
        if self._closed:
            raise EngineClosed("gateway is shut down")
        try:
            nelx, nely = req.mesh
            if int(nelx) < 1 or int(nely) < 1:
                raise ValueError
        except (AttributeError, TypeError, ValueError):
            # validate at the front door, in the caller's thread — a
            # malformed problem must fail ITS submit, not reach the
            # dispatcher and take every tenant's requests down with it
            raise ValueError(
                f"request {req.uid} problem must expose positive integer "
                f"nelx/nely (got {type(req.problem).__name__})") from None
        if self.shape_classes is not None and req.orig_mesh is None:
            # shape-class routing runs AHEAD of bucketing: pad the
            # problem onto the smallest canonical class that fits (in
            # the caller's thread — a malformed problem fails ITS
            # submit) so every later hop — arrival window, queue key,
            # engine — sees the class mesh. The engine crops the
            # harvested density back to orig_mesh.
            cls = shape_class_for(req.mesh, self.shape_classes)
            if cls is not None:
                orig = req.mesh
                req.problem = fea2d.pad_problem(req.problem, *cls)
                req.orig_mesh = orig
        self.start()   # no-op while the dispatcher is alive
        if deadline_s is not None:
            req.deadline_s = deadline_s
        if priority:
            req.priority = priority
        # monotonic stamps: deadline/arrival-rate/idle bookkeeping must
        # not move when NTP steps the wall clock (completed_t and
        # FleetEvent.t stay wall-clock for humans)
        now = time.monotonic()
        req.submit_t = now
        req.deadline = (now + req.deadline_s
                        if req.deadline_s is not None else None)
        fut = TopoFuture(req)
        fut.add_done_callback(self._on_request_done)
        mesh = req.mesh
        with self._queue.cond:
            self._inflight += 1
            # front-door trace sampling: the queued span opens at the
            # gateway stamp, so a routed request's timeline covers the
            # gateway queue, not just the engine-local wait
            self._trace_n += 1
            if (self.trace_every > 0 and req.trace is None
                    and self._trace_n % self.trace_every == 0):
                req.trace = obs_trace.Trace(req.uid)
                req.trace.begin(obs_trace.QUEUED, t=now)
            # elasticity signals: per-bucket arrival history (the
            # autoscaler's input) and cold-horizon freshness
            d = self._arrivals.get(mesh)
            if d is None:
                d = self._arrivals[mesh] = collections.deque(maxlen=32)
            d.append(now)
            self._last_seen[mesh] = now
        try:
            entry, shed = self._queue.offer(
                (req, fut), req.deadline, now, priority=req.priority,
                timeout=self.block_timeout)
        except RuntimeError as exc:
            with self._queue.cond:
                self._inflight -= 1
                self._queue.cond.notify_all()
            if self._closed and not isinstance(exc, EngineClosed):
                raise EngineClosed("gateway shut down during submit") \
                    from exc
            raise
        if shed is not None:
            if entry is None:
                # the incoming request itself ranked last: its future is
                # returned already failed (fail-fast, but uniformly
                # observable via result()/exception())
                fut._resolve(RequestShed(
                    f"request {req.uid} shed at admission: queue full and "
                    f"its deadline was the latest"))
            else:
                sreq, sfut = shed.payload
                sfut._resolve(RequestShed(
                    f"request {sreq.uid} shed by overload policy: queue "
                    f"full and its deadline was the latest"))
        return fut

    def _on_request_done(self, fut: TopoFuture):
        req = fut.request
        with self._queue.cond:
            # the in-flight decrement and the drain()/dispatcher wake-up
            # are unconditional: whatever the bookkeeping below does, a
            # resolved request must never be counted in flight forever
            self._inflight -= 1
            if req.trace is not None:
                # bounded completed-trace map behind gateway.trace(uid);
                # registered for failed/shed requests too (their partial
                # timeline is exactly what a postmortem wants)
                self._traces[req.uid] = req.trace
                while len(self._traces) > self.TRACE_LIMIT:
                    self._traces.popitem(last=False)
            try:
                mesh = req.mesh
                self._last_seen[mesh] = time.monotonic()
                if req.done and fut.exception() is None:
                    # per-bucket windowed acceptance — the flywheel's
                    # trigger signal (bucket_stats()); recorded for
                    # every successful completion, canaried or not
                    bs = self._bucket_stats.get(mesh)
                    if bs is None:
                        bs = self._bucket_stats[mesh] = TagStats(
                            window=self.bucket_window)
                    bs.record(req)
                    if self.harvest is not None:
                        # the harvest sink contract is a cheap in-memory
                        # record() (spooling happens on the harvester's
                        # own flush) — but it is foreign code on the
                        # completion path, so failures become events,
                        # not dropped completions
                        try:
                            self.harvest.record(req)
                        except Exception as exc:
                            self._record_event(
                                "harvest-error", mesh, req.routed_tag,
                                reason=f"uid {req.uid}: {exc!r}")
                ctrl = self._canaries.get(mesh)
                if (ctrl is not None and ctrl.active and req.done
                        and fut.exception() is None):
                    # canary tags are mandatory, so the attribution is
                    # total: a completion either carries the canary's
                    # tag or it served on the primary side (whose tag
                    # may legitimately be None on an explicit-params
                    # gateway — those completions still count)
                    side = (ctrl.canary_stats
                            if req.routed_tag == ctrl.tag
                            else ctrl.primary_stats)
                    side.record(req)
                    if ctrl.auto_rollback:
                        reason = ctrl.regression()
                        if reason:
                            # revert routing NOW (under the lock — the
                            # next pop sees no controller); the engine
                            # drains on the maintenance pass
                            ctrl.active = False
                            del self._canaries[mesh]
                            self._dissolving.append(ctrl)
                            self._rollbacks += 1
                            self._record_event("rollback", mesh, ctrl.tag,
                                               reason,
                                               details=ctrl.describe())
            except Exception as exc:
                # a malformed completion (e.g. a problem object whose
                # .mesh raises) used to be swallowed bare — which
                # silently stalled canary stat accumulation AND, had the
                # canary block thrown, would have propagated into the
                # resolving engine thread. Record the typed event so the
                # failure is observable in gateway.events
                self._record_event(
                    "callback-error", None,
                    getattr(req, "routed_tag", None),
                    reason=f"uid {getattr(req, 'uid', '?')}: {exc!r}")
            finally:
                self._queue.cond.notify_all()   # wake drain() + dispatcher

    # --------------------------------------------------------- dispatcher

    def _ready(self, payload) -> bool:
        """May this queued request be forwarded right now? Yes if its
        mesh has no engine yet (first sight instantiates one), its
        BUCKET — primary engine plus live canary engine, which share
        the depth budget — has in-flight room to spare, or its engine
        is failed or closed — forwarding to a dead engine raises at
        eng.submit and fails THAT future, which is the only way those
        entries ever resolve (gating them here would strand them in the
        queue and hang drain()/shutdown()). Plain attribute reads only —
        called under the queue lock, so no engine lock may be taken
        here. During a control-plane gate (swap/promote/rollback/evict)
        nothing is ready: queued requests wait at the gateway (none are
        dropped) until the operation finishes."""
        if self._swapping:
            return False
        mesh = payload[0].mesh
        inflight = 0
        alive = False
        eng = self._engines.get(mesh)
        if eng is not None:
            if eng._failure is not None or eng._closed:
                return True
            inflight += eng.inflight
            alive = True
        ctrl = self._canaries.get(mesh)
        if ctrl is not None and ctrl.engine is not None:
            ce = ctrl.engine
            if getattr(ce, "_failure", None) is None \
                    and not getattr(ce, "_closed", False):
                inflight += ce.inflight
                alive = True
        if not alive:
            return True   # nothing built yet: first sight instantiates
        return inflight < self._depth_for(mesh)

    @staticmethod
    def _bucket_key(payload):
        """pop_ready group key: readiness is a property of the mesh
        bucket, so a saturated bucket is tested once per scan."""
        return payload[0].mesh

    def _route(self, req: TopoRequest):
        """Pick the engine for a popped request (dispatcher thread):
        the bucket's canary engine for the controller's deterministic
        fraction of admissions, the primary engine otherwise."""
        mesh = req.mesh
        ctrl = self._canaries.get(mesh)
        eng = None
        if ctrl is not None and ctrl.active:
            ctrl.acc += ctrl.fraction
            if ctrl.acc >= 1.0 - 1e-9:
                ctrl.acc -= 1.0
                eng = self._canary_engine_for(ctrl)
                if eng is not None:
                    ctrl.routed_canary += 1
            if eng is None:
                ctrl.routed_primary += 1
        if eng is None:
            eng = self._engine_for(mesh)
        return eng

    def _dispatch_loop(self):
        """Single consumer of the shared queue: pop the highest-ranked
        ready entry, route it to (or lazily build) its mesh engine —
        canary split included — hand over the front-door future, then
        run a maintenance pass (canary dissolution, cold eviction).
        Engine backpressure is the ready predicate; queue backpressure
        is the overload policy in submit()."""
        q = self._queue
        try:
            while True:
                with q.cond:
                    entry = q.pop_ready(self._ready, key=self._bucket_key)
                    if entry is None:
                        if self._stopping and len(q._heap) == 0:
                            break
                    else:
                        # handshake with the control gate: between this
                        # flag and its clear, a popped entry is in
                        # flight to an engine — a swap must not observe
                        # the pool "drained" while the entry is still on
                        # its way
                        self._dispatch_busy = True
                if entry is not None:
                    req, fut = entry.payload
                    try:
                        eng = self._route(req)
                        req.routed_tag = getattr(eng, "model_tag", None)
                        eng.submit(req, priority=req.priority,
                                   _future=fut)
                    except BaseException as exc:
                        # a single bad request (or a failed engine) must
                        # not take the gateway down: fail its future and
                        # move on
                        fut._resolve(exc)
                    finally:
                        with q.cond:
                            self._dispatch_busy = False
                            q.cond.notify_all()
                if self._needs_maintenance():
                    with q.cond:
                        if self._swapping:   # gate holds the pool still
                            run = False
                        else:
                            run = self._maintaining = True
                    if run:
                        try:
                            self._maintain()
                        finally:
                            with q.cond:
                                self._maintaining = False
                                q.cond.notify_all()
                if entry is None:
                    with q.cond:
                        # woken by submit(), request completion, or
                        # shutdown; the timeout bounds engine-depth
                        # polling and the eviction clock
                        if not (self._stopping and len(q._heap) == 0):
                            q.cond.wait(timeout=0.05)
            # normal exit (shutdown drained the queue): an async
            # shutdown(wait=False) has nobody left to close the engine
            # pool, so the dispatcher does it for the engines the
            # gateway built itself (a caller-supplied factory owns its
            # engines' lifecycle; shutdown(wait=True) closes those too)
            if self._closed and self._owns_engines:
                for eng in self._all_engines():
                    eng.shutdown(wait=False)
            if self._closed:
                # the async shutdown(wait=False) path has nobody else to
                # flush the harvest buffer before the process may exit
                self._flush_harvest("shutdown")
                self._release_all_leases()
        except BaseException as exc:   # dispatcher died: fail every waiter
            with q.cond:
                self._failure = exc
                self._stopping = True
                q.close()   # BLOCKed submitters must error, not re-queue
                while True:
                    e = q.pop()
                    if e is None:
                        break
                    e.payload[1]._resolve(exc)
                q.cond.notify_all()
            raise

    # -------------------------------------------------------------- stats

    def throughput_stats(self, requests: Optional[List[TopoRequest]] = None,
                         wall_s: Optional[float] = None,
                         per_mesh: bool = False) -> Dict:
        """Aggregate serving stats across every engine — primary pool,
        canary engines, and the retired history of evicted/dissolved
        ones — or over an explicit request pool, plus gateway-level
        counters: ``shed`` and ``rejected`` admissions, ``pending``
        queue depth, ``engines`` in the pool, fleet-ops counters
        (``evictions``/``rebuilds``/``canaries``/``rollbacks``/
        ``promotions``) and the live ``bucket_tags`` map. With
        ``per_mesh=True`` the dict gains a ``"per_mesh"`` sub-dict keyed
        by ``"<nelx>x<nely>"`` with each engine's own
        ``throughput_stats()``."""
        # ONE lock acquisition for the whole snapshot: an engine is
        # either still in the pool snapshot or already folded into the
        # retired history — two separate acquisitions would let a
        # maintenance pass between them drop its whole history
        with self._queue.cond:
            engines = dict(self._engines)
            all_engines = list(engines.values())
            for ctrl in (list(self._canaries.values())
                         + list(self._dissolving)):
                if ctrl.engine is not None:
                    all_engines.append(ctrl.engine)
            retired = list(self._retired)
            retired_preempt = self._retired_preemptions
            retired_steps = self._retired_steps
        if requests is None:
            pool: List[TopoRequest] = []
            for eng in all_engines:
                with eng._sched.cond:
                    pool.extend(eng._completed)
            pool.extend(retired)
        else:
            pool = requests
        stats: Dict = pool_stats(pool, wall_s)
        stats.update({
            "preemptions": float(sum(e.preemptions for e in all_engines)
                                 + retired_preempt),
            "total_steps": float(sum(e.total_steps for e in all_engines)
                                 + retired_steps),
            "shed": float(self._queue.shed_count),
            "rejected": float(self._queue.rejected),
            "pending": float(len(self._queue)),
            "engines": float(len(engines)),
            "model_tag": self.model_tag,
            "model_swaps": float(self._swap_count),
            "evictions": float(self._evictions),
            "rebuilds": float(self._rebuilds),
            "canaries": float(len(self._canaries)),
            "rollbacks": float(self._rollbacks),
            "promotions": float(self._promotions),
            "bucket_tags": {_mesh_str(m): t
                            for m, t in self._bucket_tags.items()
                            if m in engines},
        })
        if per_mesh:
            stats["per_mesh"] = {
                _mesh_str(mesh): eng.throughput_stats(wall_s=wall_s)
                for mesh, eng in engines.items()}
        return stats
