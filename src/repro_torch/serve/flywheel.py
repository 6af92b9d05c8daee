"""Serving-data flywheel: harvest fallback traffic, fine-tune
per-bucket specialists, auto-canary to promotion (the counterpart of
``repro.serve.flywheel``).

The surrogate is trained offline on synthetic pure-FEA trajectories,
while the hybrid loop's residual gate sees the loop's own drifted
densities, where CRONet acceptance collapses off-distribution. This
module turns the correction into an unattended loop:

  traffic --> HarvestLog --> harvest_dataset --> finetune_from_tag
     ^                                                  |
     |                                                  v
  promote() <-- canary()/auto-rollback <-- mesh-specialized child

Three layers, one per class:

``HarvestLog``
    The gateway's serving-data sink (``TopoGateway(harvest=log)``):
    every completed request whose per-request CRONet acceptance fell
    below ``accept_below`` has its load case recovered
    (``LoadCase.from_problem``) and recorded into a bounded,
    deduplicated per-bucket ring. ``record()`` is deliberately cheap —
    it runs on the gateway's completion path — while ``flush()`` spools
    each bucket to a bounded JSONL file so harvested evidence survives
    the process.

``FlywheelController``
    The daemon closing the loop: an explicit per-bucket state machine
    IDLE -> HARVESTING -> TRAINING -> CANARY -> PROMOTED/ROLLED-BACK,
    narrated as ``flywheel-*`` ``FleetEvent``s in ``gateway.events``.
    A bucket whose windowed acceptance (``gateway.bucket_stats``)
    drops below ``trigger_below`` starts a cycle: harvested cases are
    regenerated into trajectories, ``finetune_from_tag`` warm-starts a
    mesh-specialized child from the bucket's serving checkpoint, and
    the child is canaried on its own bucket through the existing
    ``canary()``/auto-rollback machinery.  Promotion requires a
    SUSTAINED win on windowed stats; a regression is caught by the
    gateway's auto-rollback and the cycle ends ROLLED_BACK. At most
    one cycle is in flight per bucket, ever.

``RegistryRetention``
    The scheduled ``registry.sweep()`` keeping flywheel-generated
    children from growing the registry unboundedly: pinned, leased
    (serving/canarying), and the last-K per mesh lineage survive;
    everything else is pruned.

Everything here is driveable without threads (``tick()``, ``sweep()``)
— the tests run the whole loop deterministically — and the
``start()``/``stop()`` daemons are thin wrappers over the same entry
points. The spool files (``harvest_AxB.jsonl``) have the reference's
format, so either package reads the other's spool. Harvesting and
fine-tuning run on the controller's ``device``: the gateway's, so the
child's weights lie where the canary serves them.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.common import resolve_device

__all__ = ["HarvestLog", "FlywheelController", "FlywheelState",
           "FlywheelCycle", "RegistryRetention"]

Mesh = Tuple[int, int]


def _mesh_str(mesh: Mesh) -> str:
    return f"{mesh[0]}x{mesh[1]}"


def _parse_mesh(s: str) -> Mesh:
    a, b = s.split("x")
    return (int(a), int(b))


# -------------------------------------------------------------- harvester


class HarvestLog:
    """Bounded, deduplicated per-bucket log of fell-back serving
    traffic — the flywheel's training-data source.

    ``record(req)`` (the gateway completion-path hook) keeps the
    request only when its per-request CRONet acceptance
    ``cronet_iters / (cronet_iters + fea_iters)`` is below
    ``accept_below`` — a request the residual gate mostly accepted
    carries no new information, one it mostly rejected is exactly the
    off-distribution evidence fine-tuning needs. The load case is
    recovered from the (possibly shape-class-padded) problem via
    ``LoadCase.from_problem`` and deduplicated by ``LoadCase.key()``;
    each bucket keeps the newest ``capacity`` distinct cases.

    ``spool_dir`` enables bounded on-disk persistence: ``flush()``
    merges each bucket's ring into ``harvest_AxB.jsonl`` (newest
    ``spool_limit`` distinct cases), and ``rejected_cases()`` reads
    the spool back, so a restarted process keeps its evidence.
    ``record()`` itself NEVER touches the disk — it runs under the
    gateway's queue lock.
    """

    def __init__(self, capacity: int = 64, accept_below: float = 0.8,
                 spool_dir: Optional[str] = None, spool_limit: int = 256):
        if not (0.0 < accept_below <= 1.0):
            raise ValueError(
                f"accept_below must be in (0, 1], got {accept_below}")
        self.capacity = max(1, int(capacity))
        self.accept_below = float(accept_below)
        self.spool_dir = spool_dir
        self.spool_limit = max(1, int(spool_limit))
        self._lock = threading.Lock()
        # mesh -> OrderedDict[case.key()] = case-dict (insertion order =
        # recency; a re-seen key is refreshed to the back)
        self._buckets: Dict[Mesh, "collections.OrderedDict"] = {}
        self.recorded = 0        # completions offered
        self.harvested = 0       # kept (below the acceptance cutoff)
        self.duplicates = 0      # kept but already known

    # -- completion-path hook (cheap: numpy argmax + dict insert) --------

    def record(self, req) -> bool:
        """Offer one completed request; returns True when harvested.
        Called by the gateway under its queue lock — in-memory only."""
        from repro_torch.fea import dataset as ds_mod
        from repro_torch.obs import metrics as obs_metrics
        m_harvest = obs_metrics.default_registry().counter(
            "flywheel_harvest_total",
            "completions offered to the harvest sink, by outcome")
        total = req.cronet_iters + req.fea_iters
        with self._lock:
            self.recorded += 1
        if total <= 0:
            m_harvest.inc(outcome="no-iters")
            return False
        if req.cronet_iters / total >= self.accept_below:
            m_harvest.inc(outcome="accepted")
            return False
        m_harvest.inc(outcome="harvested")
        case = ds_mod.LoadCase.from_problem(req.problem)
        key = case.key()
        entry = dict(case.describe())
        entry["acceptance"] = req.cronet_iters / total
        with self._lock:
            self.harvested += 1
            bucket = self._buckets.get(req.mesh)
            if bucket is None:
                bucket = self._buckets[req.mesh] = collections.OrderedDict()
            if key in bucket:
                self.duplicates += 1
                del bucket[key]          # refresh recency
            bucket[key] = entry
            while len(bucket) > self.capacity:
                bucket.popitem(last=False)
        return True

    # -- reads -----------------------------------------------------------

    def meshes(self) -> List[Mesh]:
        with self._lock:
            return list(self._buckets)

    def rejected_cases(self, mesh: Mesh, include_spool: bool = True
                       ) -> List:
        """The bucket's harvested load cases, oldest -> newest, spool
        merged under the in-memory ring (memory wins on a duplicate
        key) — the shape ``fea.dataset.harvest_dataset`` consumes."""
        from repro_torch.fea import dataset as ds_mod
        mesh = (int(mesh[0]), int(mesh[1]))
        with self._lock:
            mem = dict(self._buckets.get(mesh, ()))
        merged = collections.OrderedDict()
        if include_spool and self.spool_dir is not None:
            for key, entry in self._read_spool(mesh):
                merged[key] = entry
        for key, entry in mem.items():
            merged.pop(key, None)
            merged[key] = entry
        return [ds_mod.LoadCase.from_dict(e) for e in merged.values()]

    def clear(self, mesh: Mesh):
        """Drop a bucket's harvested cases (ring AND spool) — called
        after a cycle's evidence has been consumed by a promotion."""
        mesh = (int(mesh[0]), int(mesh[1]))
        with self._lock:
            self._buckets.pop(mesh, None)
        path = self._spool_path(mesh)
        if path is not None and os.path.exists(path):
            os.remove(path)

    def snapshot(self) -> Dict:
        with self._lock:
            return {"recorded": self.recorded,
                    "harvested": self.harvested,
                    "duplicates": self.duplicates,
                    "buckets": {_mesh_str(m): len(b)
                                for m, b in self._buckets.items()}}

    # -- spooling (never on the completion path) -------------------------

    def _spool_path(self, mesh: Mesh) -> Optional[str]:
        if self.spool_dir is None:
            return None
        return os.path.join(self.spool_dir, f"harvest_{_mesh_str(mesh)}.jsonl")

    def _read_spool(self, mesh: Mesh):
        path = self._spool_path(mesh)
        if path is None or not os.path.exists(path):
            return []
        from repro_torch.fea import dataset as ds_mod
        out = []
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                    key = ds_mod.LoadCase.from_dict(entry).key()
                except (ValueError, KeyError, TypeError):
                    continue     # a torn tail line must not poison the spool
                out.append((key, entry))
        return out

    def flush(self):
        """Spool every bucket to disk: merge the ring over the existing
        file, keep the newest ``spool_limit`` distinct cases, rewrite
        atomically (tmp + rename). No-op without ``spool_dir``."""
        if self.spool_dir is None:
            return
        os.makedirs(self.spool_dir, exist_ok=True)
        with self._lock:
            buckets = {m: list(b.values()) for m, b in self._buckets.items()}
        for mesh, entries in buckets.items():
            merged = collections.OrderedDict()
            for key, entry in self._read_spool(mesh):
                merged[key] = entry
            from repro_torch.fea import dataset as ds_mod
            for entry in entries:
                key = ds_mod.LoadCase.from_dict(entry).key()
                merged.pop(key, None)
                merged[key] = entry
            keep = list(merged.values())[-self.spool_limit:]
            path = self._spool_path(mesh)
            tmp = path + ".tmp"
            with open(tmp, "w") as fh:
                for entry in keep:
                    fh.write(json.dumps(entry) + "\n")
            os.replace(tmp, path)


# -------------------------------------------------------------- retention


class RegistryRetention:
    """Scheduled ``registry.sweep()``: keep pinned + serving/leased +
    the newest ``keep_per_lineage`` per (mesh, lineage-root) group,
    prune the rest — the guard that keeps flywheel-generated children
    from growing the registry without bound.

    Drive it explicitly (``maybe_sweep()`` from the flywheel tick, or
    ``sweep()`` directly) or as its own daemon (``start()``/``stop()``).
    """

    def __init__(self, registry, keep_per_lineage: int = 2,
                 interval_s: float = 60.0):
        self.registry = registry
        self.keep_per_lineage = int(keep_per_lineage)
        self.interval_s = float(interval_s)
        self._last_sweep = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.sweeps = 0
        self.dropped: List[str] = []

    def sweep(self) -> List[str]:
        dropped = self.registry.sweep(keep_per_lineage=self.keep_per_lineage)
        self.sweeps += 1
        self.dropped.extend(dropped)
        self._last_sweep = time.monotonic()
        return dropped

    def maybe_sweep(self) -> List[str]:
        """Sweep if ``interval_s`` has elapsed since the last one."""
        if time.monotonic() - self._last_sweep < self.interval_s:
            return []
        return self.sweep()

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="registry-retention",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sweep()
            except Exception:
                pass     # a transient registry error must not kill retention


# ------------------------------------------------------------- controller


class FlywheelState(enum.Enum):
    IDLE = "idle"
    HARVESTING = "harvesting"
    TRAINING = "training"
    CANARY = "canary"
    PROMOTED = "promoted"
    ROLLED_BACK = "rolled-back"
    ERROR = "error"

    @property
    def terminal(self) -> bool:
        return self in (FlywheelState.PROMOTED, FlywheelState.ROLLED_BACK,
                        FlywheelState.ERROR)


@dataclasses.dataclass
class FlywheelCycle:
    """One bucket's pass through the state machine; ``history`` keeps
    the ``(state, t_wall, t_mono)`` trail for the property tests'
    lineage and single-cycle invariants. Stamps follow the
    ``FleetEvent`` idiom: ``started_t`` and the wall entry are
    user-facing (humans reading ``describe()``), while ``started_mono``
    and the monotonic entry are what ordering/elapsed math uses — the
    controller's cooldown and trigger scans run on ``time.monotonic()``
    and an NTP step must not reorder a cycle's trail against them."""
    mesh: Mesh
    base_tag: Optional[str]
    state: FlywheelState = FlywheelState.HARVESTING
    child_tag: Optional[str] = None
    n_cases: int = 0
    started_t: float = dataclasses.field(default_factory=time.time)
    started_mono: float = dataclasses.field(
        default_factory=time.monotonic)
    error: Optional[str] = None
    history: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)

    def advance(self, state: FlywheelState):
        self.state = state
        self.history.append((state.value, time.time(), time.monotonic()))

    def describe(self) -> Dict:
        return {"mesh": _mesh_str(self.mesh), "state": self.state.value,
                "base_tag": self.base_tag, "child_tag": self.child_tag,
                "n_cases": self.n_cases, "error": self.error,
                "history": list(self.history)}


class FlywheelController:
    """The daemon that closes the traffic -> train -> deploy loop.

    Each ``tick()``:

      1. optionally drives ``retention.maybe_sweep()`` and
         ``harvest.flush()`` (housekeeping piggybacks on the beat);
      2. advances every in-flight CANARY cycle: promoted on a
         sustained windowed win (both sides >= ``promote_after``
         recent completions and the canary's recent acceptance at
         least ``promote_margin`` above the primary's), detected as
         ROLLED_BACK when the gateway's auto-rollback already ended
         the experiment;
      3. scans ``gateway.bucket_stats()`` for trigger conditions: a
         bucket with >= ``min_completed`` recent completions whose
         recent CRONet acceptance is below ``trigger_below``, no cycle
         in flight, out of cooldown, and >= ``min_harvest`` distinct
         harvested cases starts HARVESTING -> TRAINING -> CANARY
         synchronously (fine-tuning runs on the caller's thread — the
         daemon's, normally).

    ``harvest_fn(cases, mesh, base_tag)`` and ``train_fn(base_tag,
    mesh, harvested)`` are injectable: the defaults run
    ``fea.dataset.harvest_dataset`` and
    ``train_cronet.finetune_from_tag``; tests substitute fakes to
    drive the full state machine in milliseconds. Every transition is
    a ``flywheel-*`` ``FleetEvent`` in ``gateway.events``.

    The one-cycle-per-bucket invariant is structural: ``_cycles`` maps
    each mesh to at most one live cycle, inserted under the controller
    lock before any work starts and removed only at a terminal state.
    """

    def __init__(self, gateway, harvest: HarvestLog, *,
                 registry=None,
                 trigger_below: float = 0.5, min_completed: int = 16,
                 min_harvest: int = 2, cooldown_s: float = 60.0,
                 canary_fraction: float = 0.3,
                 canary_min_requests: int = 8, canary_margin: float = 0.1,
                 promote_after: int = 8, promote_margin: float = 0.0,
                 promote_timeout: Optional[float] = 30.0,
                 finetune_steps: int = 200, finetune_lr: float = 5e-4,
                 replay_cases: int = 4, harvest_n_iter: int = 40,
                 harvest_max_cases: int = 16,
                 clear_on_promote: bool = True,
                 interval_s: float = 2.0,
                 retention: Optional[RegistryRetention] = None,
                 harvest_fn: Optional[Callable] = None,
                 train_fn: Optional[Callable] = None,
                 device=None):
        self.gateway = gateway
        # the default layers' device: the gateway's (the card unless it
        # was built for the CPU)
        self.device = resolve_device(
            device if device is not None
            else getattr(gateway, "device", None) or "cuda")
        self.harvest = harvest
        self.registry = registry if registry is not None \
            else getattr(gateway, "registry", None)
        if self.registry is None:
            raise ValueError(
                "FlywheelController needs a registry (the gateway's, or "
                "pass registry=) — fine-tuned children must be "
                "registered versions to canary and promote")
        self.trigger_below = float(trigger_below)
        self.min_completed = int(min_completed)
        self.min_harvest = int(min_harvest)
        self.cooldown_s = float(cooldown_s)
        self.canary_fraction = float(canary_fraction)
        self.canary_min_requests = int(canary_min_requests)
        self.canary_margin = float(canary_margin)
        self.promote_after = int(promote_after)
        self.promote_margin = float(promote_margin)
        self.promote_timeout = promote_timeout
        self.finetune_steps = int(finetune_steps)
        self.finetune_lr = float(finetune_lr)
        self.replay_cases = int(replay_cases)
        self.harvest_n_iter = int(harvest_n_iter)
        self.harvest_max_cases = int(harvest_max_cases)
        self.clear_on_promote = bool(clear_on_promote)
        self.interval_s = float(interval_s)
        self.retention = retention
        self._harvest_fn = harvest_fn or self._default_harvest
        self._train_fn = train_fn or self._default_train
        self._lock = threading.Lock()         # cycle-table + tick guard
        self._ticking = False
        self._cycles: Dict[Mesh, FlywheelCycle] = {}
        self._cooldown: Dict[Mesh, float] = {}   # mesh -> monotonic stamp
        self.history: List[FlywheelCycle] = []   # terminal cycles
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- default harvest/train layers ------------------------------------

    def _default_harvest(self, cases, mesh: Mesh, base_tag: Optional[str]):
        from repro_torch.fea import dataset as ds_mod
        record = self.registry.get(base_tag)
        return ds_mod.harvest_dataset(
            cases, mesh, cfg=record.cfg, n_iter=self.harvest_n_iter,
            max_cases=self.harvest_max_cases, device=self.device)

    def _default_train(self, base_tag: str, mesh: Mesh, harvested):
        from repro_torch.fea import train_cronet
        record, result = train_cronet.finetune_from_tag(
            self.registry, base_tag, mesh, harvested,
            steps=self.finetune_steps, lr=self.finetune_lr,
            replay_cases=self.replay_cases, device=self.device)
        return record.tag, result.params, result.u_scale

    # -- events ----------------------------------------------------------

    def _event(self, kind: str, cycle: FlywheelCycle, reason: str = "",
               **details):
        self.gateway.record_event(
            f"flywheel-{kind}", mesh=cycle.mesh,
            tag=cycle.child_tag or cycle.base_tag, reason=reason,
            details={**cycle.describe(), **details})

    # -- the beat --------------------------------------------------------

    def tick(self) -> bool:
        """One controller beat; returns False when another tick is
        already running (the daemon and a driven caller never
        interleave half-advanced state)."""
        with self._lock:
            if self._ticking:
                return False
            self._ticking = True
        try:
            if self.retention is not None:
                try:
                    self.retention.maybe_sweep()
                except Exception:
                    pass   # retention is best-effort housekeeping
            try:
                self.harvest.flush()
            except Exception:
                pass       # spooling is persistence, not correctness
            self._advance_canaries()
            self._scan_triggers()
            return True
        finally:
            with self._lock:
                self._ticking = False

    # -- CANARY advancement ----------------------------------------------

    def _finish(self, cycle: FlywheelCycle, state: FlywheelState,
                reason: str = ""):
        cycle.error = reason if state is FlywheelState.ERROR else cycle.error
        cycle.advance(state)
        self._event(state.value.replace("rolled-back", "rollback")
                    .replace("promoted", "promote"), cycle, reason)
        with self._lock:
            if self._cycles.get(cycle.mesh) is cycle:
                del self._cycles[cycle.mesh]
            self._cooldown[cycle.mesh] = time.monotonic()
            self.history.append(cycle)
        if state is FlywheelState.PROMOTED and self.clear_on_promote:
            try:
                self.harvest.clear(cycle.mesh)
            except OSError:
                pass

    def _advance_canaries(self):
        with self._lock:
            canarying = [c for c in self._cycles.values()
                         if c.state is FlywheelState.CANARY]
        for cycle in canarying:
            try:
                stats = self.gateway.canary_stats(mesh=cycle.mesh)
            except RuntimeError:
                # the experiment is gone and we did not end it: the
                # gateway's auto-rollback fired on a regression
                self._finish(cycle, FlywheelState.ROLLED_BACK,
                             "gateway auto-rollback ended the canary")
                continue
            if stats.get("tag") != cycle.child_tag:
                # not our experiment (an operator started their own
                # after ours ended) — treat ours as rolled back
                self._finish(cycle, FlywheelState.ROLLED_BACK,
                             "canary slot taken by another experiment")
                continue
            c, p = stats["canary"], stats["primary"]
            if (c["recent_completed"] < self.promote_after
                    or p["recent_completed"] < self.promote_after):
                continue    # verdict needs sustained evidence
            if (c["recent_cronet_hit_rate"]
                    < p["recent_cronet_hit_rate"] + self.promote_margin):
                continue    # not (yet) a win; auto-rollback guards the
                #             downside, so keep gathering
            try:
                promoted = self.gateway.promote(
                    mesh=cycle.mesh, timeout=self.promote_timeout)
            except TimeoutError:
                continue   # in-flight work did not drain in time; the
                #            experiment is intact — retry next tick
            except RuntimeError as exc:
                # vanished between stats and promote: the gateway's
                # auto-rollback raced us — not a promotion
                self._finish(cycle, FlywheelState.ROLLED_BACK,
                             f"promotion lost to rollback: {exc}")
                continue
            if cycle.child_tag in promoted:
                self._finish(cycle, FlywheelState.PROMOTED,
                             "sustained windowed win over primary")
            else:
                self._finish(cycle, FlywheelState.ROLLED_BACK,
                             "auto-rollback fired during promote drain")

    # -- trigger scan + cycle execution ----------------------------------

    def _scan_triggers(self):
        try:
            buckets = self.gateway.bucket_stats()
        except Exception:
            return
        now = time.monotonic()
        for key, snap in buckets.items():
            mesh = _parse_mesh(key)
            if snap.get("recent_completed", 0) < self.min_completed:
                continue
            if snap.get("recent_cronet_hit_rate", 1.0) >= self.trigger_below:
                continue
            with self._lock:
                if mesh in self._cycles:
                    continue           # one cycle per bucket, ever
                cd = self._cooldown.get(mesh)
                if cd is not None and now - cd < self.cooldown_s:
                    continue
                base_tag = self.gateway.serving_tag(mesh)
                if not base_tag:
                    continue   # explicit-params bucket: nothing to
                    #            warm-start from or canary against
                cycle = FlywheelCycle(mesh=mesh, base_tag=base_tag)
                self._cycles[mesh] = cycle
            self._event("trigger", cycle,
                        f"recent acceptance "
                        f"{snap['recent_cronet_hit_rate']:.1%} < "
                        f"{self.trigger_below:.1%}",
                        acceptance=snap["recent_cronet_hit_rate"])
            self._run_cycle(cycle)

    def _run_cycle(self, cycle: FlywheelCycle):
        """HARVESTING -> TRAINING -> CANARY, synchronously; any failure
        lands the cycle in ERROR (with cooldown) instead of leaking a
        half-started experiment."""
        mesh = cycle.mesh
        try:
            cases = self.harvest.rejected_cases(mesh)
            cycle.n_cases = len(cases)
            if len(cases) < self.min_harvest:
                self._finish(
                    cycle, FlywheelState.ERROR,
                    f"only {len(cases)} harvested case(s) < "
                    f"min_harvest {self.min_harvest}")
                return
            harvested = self._harvest_fn(cases, mesh, cycle.base_tag)
            if harvested is None:
                self._finish(cycle, FlywheelState.ERROR,
                             "harvest produced no trajectories")
                return
            self._event("harvest", cycle, f"{len(cases)} distinct cases")
            cycle.advance(FlywheelState.TRAINING)
            self._event("train", cycle)
            child_tag, params, u_scale = self._train_fn(
                cycle.base_tag, mesh, harvested)
            cycle.child_tag = child_tag
            cycle.advance(FlywheelState.CANARY)
            self.gateway.canary(
                tag=child_tag, mesh=mesh, params=params, u_scale=u_scale,
                fraction=self.canary_fraction,
                min_requests=self.canary_min_requests,
                margin=self.canary_margin, auto_rollback=True)
            self._event("canary", cycle,
                        f"fraction {self.canary_fraction:g}")
        except (Exception,) as exc:
            self._finish(cycle, FlywheelState.ERROR, repr(exc))

    # -- daemon ----------------------------------------------------------

    def start(self):
        """Spawn the flywheel beat thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="flywheel-controller",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as exc:
                try:
                    self.gateway.record_event("flywheel-error", reason=repr(exc))
                except Exception:
                    pass

    # -- introspection ---------------------------------------------------

    def cycles(self) -> Dict[str, Dict]:
        """Live cycles by bucket (``describe()`` dicts)."""
        with self._lock:
            return {_mesh_str(m): c.describe()
                    for m, c in self._cycles.items()}

    def status(self) -> Dict:
        with self._lock:
            live = {_mesh_str(m): c.describe()
                    for m, c in self._cycles.items()}
            hist = [c.describe() for c in self.history]
        out = {"live": live, "history": hist,
               "harvest": self.harvest.snapshot()}
        counts: Dict[str, int] = {}
        for c in hist:
            counts[c["state"]] = counts.get(c["state"], 0) + 1
        out["terminal_counts"] = counts
        return out
