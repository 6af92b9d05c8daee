"""Streaming slot-batched topology-optimization serving engine: the
counterpart of ``repro.serve.topo_service``.

Requests occupy fixed batch slots and every tick advances a slot group one
hybrid NN-FEA iteration (``fea/hybrid.make_hybrid_step``); admission is
live:

  * ``submit(req) -> TopoFuture`` is thread-safe and may be called while
    the tick loops run; the request is admitted at the next tick boundary.
  * Admission order is (priority, earliest-deadline-first) with
    deterministic tie-breaking and a starvation horizon for deadline-less
    requests (serve/scheduler.py).
  * A slot whose occupant has slack can be preempted for a request about
    to miss its deadline: the occupant's lane is parked on the host
    (fea/hybrid.park_slot), the lane is reseeded, and the parked request
    re-enters the queue with its original rank, resuming exactly on
    re-admission (fea/hybrid.restore_slot).
  * With ``ladder=``, slot width is a per-tick rung choice: every tick
    dispatches at the smallest rung >= live occupancy, padding lanes are
    idle problems the CG's ``need`` mask skips, and rung changes migrate
    live lanes with exact lane copies.
  * ``shape_padded=True`` marks an engine serving a canonical shape class:
    requests arrive padded onto the class mesh (fea2d.pad_problem) with a
    passive-border element mask, and harvested densities are cropped back
    to ``req.orig_mesh``.
  * Lifecycle is an explicit state machine (serve/types.EngineState):
    ``stop()`` is the restartable pause, ``shutdown()`` is terminal.
  * ``run(requests)`` is a thin submit+drain shim over the streaming core.

One engine serves ONE mesh. Shards are slot groups pinned to devices by
``shard_devices`` (CUDA devices, or the CPU when asked), each driven by its
own tick-loop thread pulling from the shared EDF queue.

The engine runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; on CUDA every tick's CRONet forward and FEA fallback run
the port's CUDA kernels. There is no compile step in PyTorch, so a ladder
engine precompiles nothing: the kernels build once, at the first
activation on a CUDA device. ``engine_from_spec`` builds an engine from a
picklable description (explicit params, or a tag of the shared on-disk
model registry).

Every op in the batched step is slot-invariant (fea/hybrid.py) and
park/restore is an exact lane copy, so the density a slot produces does
not depend on admission order, slot count or preemption cycles.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common import map_params, resolve_device
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.fea import fea2d, hybrid
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.scheduler import (INF, EDFScheduler, SlotView,
                                         ladder_rungs, preempt_victim,
                                         rung_for)
from repro_torch.serve.types import (EngineClosed, EngineState, TopoFuture,
                                     TopoRequest, pool_stats)

__all__ = ["TopoRequest", "TopoFuture", "TopoServingEngine", "auto_shards",
           "shard_devices", "engine_from_spec"]


@dataclasses.dataclass
class _Admission:
    """A queued unit of work: fresh submission or parked preemptee."""
    req: TopoRequest
    future: TopoFuture
    parked: Optional[hybrid.HybridState] = None  # host lane snapshot
    iters_done: int = 0
    first_admit_t: Optional[float] = None
    seq: int = -1                # original EDF rank, preserved across parks
    eff_deadline: float = INF
    # trace bookkeeping (traced requests only): (it, n_cronet, n_fea,
    # cg_iters) device-counter values already attributed to trace
    # windows, so each flush records only the delta since the last one.
    # Survives park/restore because the counters themselves do.
    tr_base: tuple = (0, 0, 0, 0)

    @property
    def iters_left(self) -> int:
        return self.req.n_iter - self.iters_done


@functools.lru_cache(maxsize=64)
def _mesh_template(nelx: int, nely: int):
    """Per-mesh slot constants (element DOF map, element stiffness,
    penalization), shared read-only by every engine built for the mesh."""
    template = fea2d.mbb_problem(nelx, nely)
    return template.edof, template.KE, template.penal, template.e_min


def local_devices(device="cuda") -> List[torch.device]:
    """The devices shards may be pinned to: every CUDA device for a CUDA
    engine, the one CPU device for a CPU engine."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def auto_shards(slots: int, device_count: int) -> int:
    """Largest shard count <= device_count that divides `slots` while
    keeping shard width >= 2 (the minimum slot-invariant batch)."""
    for s in range(min(device_count, slots // 2), 1, -1):
        if slots % s == 0:
            return s
    return 1


def shard_devices(slots: int, shards: Optional[int] = None,
                  devices: Optional[list] = None, device="cuda") -> list:
    """Resolve the shard count and pin each shard to a device — the ONE
    place that logic lives. Round-robin over ``devices`` (default:
    ``local_devices(device)``), so the assignment is a pure function of
    (slots, shards, device list)."""
    if devices is None:
        devices = local_devices(device)
    if shards is None:
        shards = auto_shards(slots, len(devices))
    if slots < 2:
        # 2 is the minimum width of the slot-invariance contract (as in
        # the reference, whose XLA lowers a unit batch dim differently)
        raise ValueError("TopoServingEngine needs slots >= 2")
    if slots % shards != 0 or slots // shards < 2:
        raise ValueError(f"slots={slots} not divisible into "
                         f"{shards} shards of width >= 2")
    if shards > len(devices):
        raise ValueError(f"{shards} shards > {len(devices)} devices")
    return [devices[i % len(devices)] for i in range(shards)]


class _Shard:
    """One slot group: host-side slot constants + device-resident state,
    driven by exactly one tick-loop thread (lane bookkeeping is therefore
    single-writer; only the EDF queue is shared)."""

    def __init__(self, engine: "TopoServingEngine", device):
        self.engine = engine
        self.device = device
        cfg = engine.cfg
        L = engine.shard_width
        ndof = 2 * (cfg.nelx + 1) * (cfg.nely + 1)
        # empty slots carry f == 0 so the masked CG treats them as
        # converged in zero iterations. Host arrays stay FULL width L;
        # _upload() slices [:width] for the current ladder rung.
        self.f = np.zeros((L, ndof), np.float32)
        self.free = np.zeros((L, ndof), np.float32)
        self.fixed_x = np.zeros((L, ndof), np.float32)
        self.volfrac = np.full((L,), 0.5, np.float32)
        # per-slot passive-border masks (shape-class engines only)
        self.elem = (np.ones((L, cfg.nely, cfg.nelx), np.float32)
                     if engine.shape_padded else None)
        self.slot_adm: List[Optional[_Admission]] = [None] * L
        self.slot_iters = [0] * L
        self.rungs = engine._rungs   # sorted widths, rungs[-1] == L
        self.width = self.rungs[-1]  # currently-dispatched batch width
        self.cap = L                 # live admission cap (set_target_slots)
        self.rung_steps = {r: 0 for r in self.rungs}
        self.rung_changes = 0
        self.migrations = 0          # device lane moves from rung shrinks
        self.params = None          # device copy, refreshed by activate()
        self.bp = None
        self.load_vol = None
        self.state = None
        self.steps = 0              # dispatched this activation
        self.busy_t0: Optional[float] = None   # sync-point timing window
        self.steps_in_window = 0
        self.trace_sync_n = 0       # traced sync boundaries seen (throttle)

    def activate(self):
        """Fresh idle state for a (re)started tick loop."""
        e = self.engine
        L = e.shard_width
        self.f[:] = 0.0
        self.free[:] = 0.0
        self.fixed_x[:] = 0.0
        self.volfrac[:] = 0.5
        if self.elem is not None:
            self.elem[:] = 1.0
        self.slot_adm = [None] * L
        self.slot_iters = [0] * L
        self.steps = 0
        self.busy_t0 = None
        self.steps_in_window = 0
        # params are re-put per activation: a swap_params() between
        # activations (hot model swap) takes effect on the next start
        self.params = map_params(lambda p: p.to(self.device), e.params)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)   # this thread's device
            e._build_kernels()
        # an idle shard starts on the smallest rung; occupancy pulls the
        # width up through _set_width as admissions land
        self.width = self.rungs[0]
        self.state = hybrid.init_state(e.cfg, self._idle_bp(self.width))
        self._upload()

    def _idle_bp(self, width: int) -> fea2d.BatchProblem:
        e = self.engine
        idle = fea2d.idle_problem(e.cfg.nelx, e.cfg.nely)
        if e.shape_padded:
            # all-ones mask: a shape-class engine always runs the masked
            # filter/OC path, idle lanes included
            idle = idle._replace(elem_mask=torch.ones(
                (e.cfg.nely, e.cfg.nelx)))
        return fea2d.stack_problems([idle] * width, device=self.device)

    def _upload(self):
        e = self.engine
        w = self.width
        self.bp = fea2d.BatchProblem(
            nelx=e.cfg.nelx, nely=e.cfg.nely, edof=e._edof, KE=e._KE,
            f=torch.from_numpy(self.f[:w].copy()),
            free_mask=torch.from_numpy(self.free[:w].copy()),
            fixed_x_mask=torch.from_numpy(self.fixed_x[:w].copy()),
            volfrac=torch.from_numpy(self.volfrac[:w].copy()),
            penal=e._penal, e_min=e._e_min,
            elem_mask=(torch.from_numpy(self.elem[:w].copy())
                       if self.elem is not None else None)).to(self.device)
        self.load_vol = fea2d.load_volume_b(self.bp)

    def fill(self, lane: int, adm: Optional[_Admission]):
        """Write lane HOST constants + bookkeeping for an admission (or
        clear them). Device-state seeding is a separate step (``seed``)
        because under ladder dispatch the lane's device state may not
        exist yet — the tick picks its rung (and resizes the state)
        after admissions land. Caller must _upload() afterwards."""
        if adm is None:
            self.f[lane] = 0.0
            self.free[lane] = 0.0
            self.fixed_x[lane] = 0.0
            self.volfrac[lane] = 0.5
            if self.elem is not None:
                self.elem[lane] = 1.0
        else:
            p = adm.req.problem
            self.f[lane] = np.asarray(p.f)
            self.free[lane] = np.asarray(p.free_mask)
            self.fixed_x[lane] = np.asarray(p.fixed_x_mask)
            self.volfrac[lane] = p.volfrac
            if self.elem is not None:
                self.elem[lane] = (np.asarray(p.elem_mask)
                                   if p.elem_mask is not None else 1.0)
        self.slot_adm[lane] = adm

    def seed(self, lane: int):
        """Seed lane device state: exact restore for a parked admission,
        fresh reset otherwise (also used to clear harvested lanes)."""
        adm = self.slot_adm[lane]
        if adm is not None and adm.parked is not None:
            self.state = hybrid.restore_slot(self.state, lane, adm.parked)
            self.slot_iters[lane] = adm.iters_done
            adm.parked = None
        else:
            mask = (torch.from_numpy(self.elem[lane].copy())
                    if self.elem is not None and adm is not None else None)
            self.state = hybrid.reset_slot(
                self.engine.cfg, self.state, lane, float(self.volfrac[lane]),
                mask)
            self.slot_iters[lane] = 0

    def move_lane(self, src: int, dst: int, live: bool):
        """Relocate a lane's occupant to a lower index (rung-shrink
        compaction). ``live=True`` also moves the device state (exact
        lane copy); pending admissions have no device state yet and only
        need their host constants + bookkeeping relabeled."""
        self.f[dst] = self.f[src]
        self.free[dst] = self.free[src]
        self.fixed_x[dst] = self.fixed_x[src]
        self.volfrac[dst] = self.volfrac[src]
        if self.elem is not None:
            self.elem[dst] = self.elem[src]
        self.slot_adm[dst] = self.slot_adm[src]
        self.slot_iters[dst] = self.slot_iters[src]
        self.slot_adm[src] = None
        self.slot_iters[src] = 0
        self.f[src] = 0.0
        self.free[src] = 0.0
        self.fixed_x[src] = 0.0
        self.volfrac[src] = 0.5
        if self.elem is not None:
            self.elem[src] = 1.0
        if live:
            self.state = hybrid.move_slot(self.state, src, dst)
            self.migrations += 1

    def _set_width(self, new_width: int, pending: List[int]) -> bool:
        """Re-rung the shard to ``new_width``: compact occupied lanes
        below the new width (device moves for live lanes, relabels for
        ``pending`` not-yet-seeded ones — ``pending`` is updated in
        place), then resize the device state. Returns True if the width
        changed (caller must _upload)."""
        if new_width == self.width:
            return False
        for src in range(len(self.slot_adm) - 1, new_width - 1, -1):
            if self.slot_adm[src] is None:
                continue
            dst = next(i for i in range(new_width)
                       if self.slot_adm[i] is None and i not in pending)
            self.move_lane(src, dst, live=src not in pending)
            if src in pending:
                pending[pending.index(src)] = dst
        self.state = hybrid.resize_state(self.state, new_width)
        self.width = new_width
        self.rung_changes += 1
        return True

    def park(self, lane: int) -> _Admission:
        """Evict the lane's occupant: lane-gather its state to host and
        return the admission carrying the snapshot (syncs the device)."""
        adm = self.slot_adm[lane]
        adm.parked = hybrid.park_slot(self.state, lane)
        adm.iters_done = self.slot_iters[lane]
        adm.req.preemptions += 1
        self.slot_adm[lane] = None
        return adm


class TopoServingEngine:
    """Serve TopoRequests sharing the engine's (nelx, nely) mesh over
    `slots` batch slots in `shards` device-pinned slot groups, with live
    streaming admission.

    Streaming API: ``submit(req) -> TopoFuture`` (starts the tick loops
    on first use), ``drain()`` to wait for quiescence, ``stop()`` to
    pause the worker threads (the engine restarts cleanly on the next
    submit), ``shutdown()`` to close the engine for good (``submit``
    afterwards raises ``EngineClosed``). ``run(requests)`` is a
    compatibility shim: submit all, wait for all, stop the loops if this
    call started them.

    Scheduling: (priority, EDF) admission with a `starvation_horizon`
    bound for deadline-less requests; `preempt=True` enables slack-safe
    slot preemption (see serve/scheduler.py). `tick_time_s` overrides the
    measured per-step time estimate the preemption test uses
    (deterministic tests set it; production leaves the EMA).

    completed_limit bounds the completed-request history ring
    (`throughput_stats` reports over it): a long-lived engine keeps the
    most recent `completed_limit` results instead of growing without
    bound.

    device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``. On
    CUDA the tick's forward and FEA fallback run the port's CUDA kernels;
    on the CPU their plain versions. (The JAX engine's ``backend`` and
    ``fea_backend`` knobs have no counterpart: the device decides.)
    shards: None = auto (one shard per available device while shard width
    stays >= 2); 1 = a single slot group.

    ladder: optional sorted width ladder (e.g. (2, 4, 8, 16), clamped to
    [2, shard_width]; shard_width is always a rung). When set, every
    tick dispatches at the smallest rung >= live occupancy.
    ``set_target_slots`` then caps live admissions per shard at a rung.
    ladder=None is one fixed width.

    shape_padded: the engine serves a canonical shape CLASS — requests
    arrive padded to (cfg.nelx, cfg.nely) by fea2d.pad_problem with a
    passive-border ``elem_mask``, and harvested densities are cropped
    back to ``req.orig_mesh``.
    """

    def __init__(self, cfg: CRONetConfig, params, u_scale: float,
                 slots: int = 8, precision: str = "fp32",
                 error_threshold: float = 0.05, verify_every: int = 3,
                 rmin: float = 1.5,
                 shards: Optional[int] = None, preempt: bool = True,
                 starvation_horizon: float = 60.0,
                 tick_time_s: Optional[float] = None,
                 completed_limit: int = 1024,
                 model_tag: Optional[str] = None,
                 ladder: Optional[Sequence[int]] = None,
                 shape_padded: bool = False,
                 trace_every: int = 0,
                 metrics: Optional[obs_metrics.MetricsRegistry] = None,
                 device="cuda"):
        self.device = resolve_device(device)
        self._devices = shard_devices(slots, shards, device=self.device)
        self.cfg = cfg
        self.slots = slots
        self.shards = len(self._devices)
        self.shard_width = slots // self.shards
        self.ladder = tuple(int(r) for r in ladder) if ladder else None
        self._rungs = (ladder_rungs(self.shard_width, self.ladder)
                       if self.ladder is not None else (self.shard_width,))
        self.shape_padded = shape_padded
        self.u_scale = u_scale
        self.precision = precision
        self.model_tag = model_tag
        self._error_threshold = error_threshold
        self._verify_every = verify_every
        self._rmin = rmin
        self.params = hybrid.cast_params(params, precision)
        self.step = hybrid.make_hybrid_step(
            cfg, u_scale, error_threshold, verify_every, rmin, precision)
        self.preempt = preempt
        self.tick_time_s = tick_time_s
        (self._edof, self._KE,
         self._penal, self._e_min) = _mesh_template(cfg.nelx, cfg.nely)
        self._shards = [_Shard(self, dev) for dev in self._devices]
        self._sched = EDFScheduler(starvation_horizon)
        self._threads: List[threading.Thread] = []
        self._running = False
        self._stopping = False
        self._closed = False
        self._ever_started = False
        self._inflight = 0
        self._failure: Optional[BaseException] = None
        self._completed: collections.deque = collections.deque(
            maxlen=completed_limit)
        self._lifecycle = threading.Lock()
        self._sec_per_step: Optional[float] = None
        # ---- observability (obs/): all recording is host-side
        # stamps/increments, so densities are bitwise-identical with
        # tracing on or off. trace_every=N samples every Nth submission
        # (0 = off); metrics default to the process-wide registry.
        self.trace_every = int(trace_every)
        self._trace_n = 0
        self.metrics = (metrics if metrics is not None
                        else obs_metrics.default_registry())
        self._mesh_label = f"{cfg.nelx}x{cfg.nely}"
        m = self.metrics
        self._m_wait = m.histogram(
            "topo_admission_wait_s",
            "submit -> first slot admission (queue age)")
        self._m_tick = m.histogram(
            "topo_tick_latency_s",
            "per-step latency by (mesh, rung, device)")
        self._m_cg = m.histogram(
            "topo_cg_iters",
            "CG iterations burned by a completed request's FEA fallbacks",
            buckets=obs_metrics.DEFAULT_COUNT_BUCKETS)
        self._m_done = m.counter(
            "topo_completions_total",
            "completed requests by (mesh, deadline outcome)")
        self._m_preempt = m.counter(
            "topo_preemptions_total",
            "slot evictions (park) in favour of more urgent work")
        self._m_iters = m.counter(
            "topo_iters_total",
            "hybrid iterations by path: CRONet-accepted vs FEA fallback")
        self._m_inflight = m.gauge(
            "topo_inflight",
            "accepted-but-unresolved requests per engine mesh")
        self.preemptions = 0        # engine lifetime eviction count
        self._steps_base = 0        # steps from finished activations
        self.last_run_steps = 0     # most recent run() only
        self._steps_lock = threading.Lock()

    @property
    def total_steps(self) -> int:
        """Engine-lifetime step count (live, includes the
        current activation's in-flight shard counters)."""
        with self._steps_lock:
            return self._steps_base + sum(sh.steps for sh in self._shards)

    # --------------------------------------------------------- lifecycle

    @property
    def running(self) -> bool:
        return self._running

    @property
    def inflight(self) -> int:
        """Requests accepted but not yet resolved (queued + in slots) —
        the gateway's per-engine depth signal."""
        return self._inflight

    @property
    def state(self) -> EngineState:
        if self._failure is not None:
            return EngineState.FAILED
        if self._closed:
            return EngineState.CLOSED
        with self._lifecycle:
            if self._running and any(t.is_alive() for t in self._threads):
                return EngineState.RUNNING
        return EngineState.STOPPED if self._ever_started else EngineState.NEW

    def start(self):
        """Spawn one tick-loop thread per shard (idempotent)."""
        with self._lifecycle:
            if self._closed:
                raise EngineClosed(
                    f"engine ({self.cfg.nelx}x{self.cfg.nely}) is shut "
                    f"down; build a new one")
            if self._running:
                if any(t.is_alive() for t in self._threads):
                    return
                # a stop(wait=False) left _running set after the workers
                # drained and exited: recover and restart
                self._threads = []
            if self._failure is not None:
                raise RuntimeError("engine failed; build a new one") \
                    from self._failure
            self._stopping = False
            self._running = True
            self._ever_started = True
            self._threads = [
                threading.Thread(target=self._shard_loop, args=(sh,),
                                 name=f"topo-shard-{i}", daemon=True)
                for i, sh in enumerate(self._shards)]
            for t in self._threads:
                t.start()

    def stop(self, wait: bool = True):
        """Pause serving: workers finish the queue and all occupied
        slots, then exit. With wait=True, joins the threads. The engine
        RESTARTS on the next submit()/start() — use ``shutdown()`` to
        close it for good."""
        with self._lifecycle:
            if not self._running and not self._threads:
                return
            with self._sched.cond:
                self._stopping = True
                self._sched.cond.notify_all()
            threads = list(self._threads)
        if wait:
            for t in threads:
                t.join()
            with self._lifecycle:
                self._running = False
                self._threads = []

    def shutdown(self, wait: bool = True):
        """Terminal stop: drain like ``stop()`` and transition to
        CLOSED — every later submit()/start() raises ``EngineClosed``
        (in-flight work still completes)."""
        self._closed = True
        self.stop(wait)

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Block until every submitted request has resolved."""
        with self._sched.cond:
            return self._sched.cond.wait_for(
                lambda: self._inflight == 0 or self._failure is not None,
                timeout)

    def swap_params(self, params, u_scale: Optional[float] = None, *,
                    model_tag: Optional[str] = None):
        """Replace the engine's model between activations (the hot-swap
        mechanism behind the reference's ``TopoGateway.swap_model``): new
        params, optionally a new deployed ``u_scale`` (the step comes from
        the ``make_hybrid_step`` cache), and the ``model_tag`` stamped on
        every subsequent completion.

        The engine must be quiescent: call ``drain()`` + ``stop()``
        first (the gateway's ``swap_model`` does exactly that). The next
        ``submit()``/``start()`` restarts the tick loops, and each
        shard's ``activate()`` re-uploads the new params to its device.
        """
        with self._lifecycle:
            if self._running and any(t.is_alive() for t in self._threads):
                raise RuntimeError(
                    "swap_params on a running engine: drain() and stop() "
                    "it first (TopoGateway.swap_model does this)")
            self.params = hybrid.cast_params(params, self.precision)
            if u_scale is not None and u_scale != self.u_scale:
                self.u_scale = u_scale
                self.step = hybrid.make_hybrid_step(
                    self.cfg, u_scale, self._error_threshold,
                    self._verify_every, self._rmin, self.precision)
            self.model_tag = model_tag

    # ------------------------------------------------------------ ladder

    @property
    def rungs(self) -> tuple:
        """Per-shard width ladder (single entry for ladder=None)."""
        return self._rungs

    def _build_kernels(self):
        """Build the CUDA kernels before the first tick (nvcc runs once per
        source per checkout; later calls find the libraries), so no
        serving tick pays for a build."""
        from repro_torch.kernels import build_all
        build_all()

    def set_target_slots(self, n: int) -> int:
        """Live autoscale lever (ladder engines only): cap concurrent
        occupancy at ``n`` total slots, snapped UP to a per-shard rung.
        Takes effect at the next tick boundary — queued requests above
        the cap simply wait; nothing is dropped or rebuilt. Returns the
        applied total (== ``slots`` for ladder=None engines, which only
        resize via rebuild)."""
        if self.ladder is None:
            return self.slots
        per = max(2, -(-int(n) // self.shards))   # ceil-divide across shards
        rung = rung_for(per, self._rungs)
        for sh in self._shards:
            sh.cap = rung
        return rung * self.shards

    # --------------------------------------------------------- streaming

    def submit(self, req: TopoRequest,
               deadline_s: Optional[float] = None, priority: int = 0,
               _future: Optional[TopoFuture] = None) -> TopoFuture:
        """Thread-safe live admission: enqueue `req` ((priority, EDF)
        rank) and return a completion future. Starts the tick loops if
        needed; the request is admitted at a tick boundary without
        recompiling the batched step.

        ``_future`` is the gateway hook: a pre-stamped request arriving
        with its front-door future keeps that future (and its original
        submit_t/deadline), so callers see one handle end to end.
        """
        p = req.problem
        if (p.nelx, p.nely) != (self.cfg.nelx, self.cfg.nely):
            raise ValueError(
                f"request {req.uid} mesh {p.nelx}x{p.nely} does not "
                f"match engine mesh {self.cfg.nelx}x{self.cfg.nely}")
        if deadline_s is not None:
            req.deadline_s = deadline_s
        if priority:
            req.priority = priority
        self.start()   # no-op while workers are alive; EngineClosed if shut
        # deadline/latency bookkeeping runs on the monotonic clock: an
        # NTP step must not fabricate deadline misses (wall-clock is used
        # only for the user-facing completed_t stamp at harvest)
        now = time.monotonic()
        if _future is None:
            fut = TopoFuture(req)
            req.submit_t = now
            req.deadline = (now + req.deadline_s
                            if req.deadline_s is not None else None)
        else:
            fut = _future   # gateway already stamped submit_t/deadline
        # trace sampling: every Nth submission rides with a Trace. The
        # queued span opens at the request's OWN submit stamp (gateway
        # front-door stamp when routed), so span sums tile the full
        # end-to-end latency, not just the engine-local part.
        if self.trace_every > 0 and req.trace is None:
            self._trace_n += 1
            if self._trace_n % self.trace_every == 0:
                req.trace = obs_trace.Trace(req.uid)
        if req.trace is not None and req.trace.submit_t is None:
            req.trace.begin(obs_trace.QUEUED, t=req.submit_t)
        adm = _Admission(req, fut)
        with self._sched.cond:
            if self._closed:
                raise EngineClosed("engine is shut down")
            if self._stopping:
                # a restartable stop() is still draining: this is a
                # transient pause, NOT the terminal CLOSED state — the
                # engine accepts again once the drain finishes
                raise RuntimeError(
                    "engine is stopping; retry once stop() completes")
            if self._failure is not None:
                raise RuntimeError("engine failed") from self._failure
            self._inflight += 1
            self._m_inflight.set(self._inflight, mesh=self._mesh_label)
            entry = self._sched.push(adm, req.deadline, now,
                                     priority=req.priority)
            adm.seq, adm.eff_deadline = entry.seq, entry.eff_deadline
        return fut

    def trace(self, uid: int) -> Optional[obs_trace.Trace]:
        """Look up a completed request's trace by uid (None when the
        request wasn't sampled or has scrolled out of the completed
        ring)."""
        with self._sched.cond:
            for r in self._completed:
                if r.uid == uid:
                    return r.trace
        return None

    # --------------------------------------------------------- tick loop

    def _estimate(self) -> float:
        if self.tick_time_s is not None:
            return self.tick_time_s
        est = self._sec_per_step
        return est if est is not None else 0.0

    def _trace_flush(self, adm: _Admission, t: float, it: int, cro: int,
                     fea: int, cg: int):
        """Append the accepted-vs-fallback delta since the last flush to
        the admission's trace window ring (traced requests only)."""
        b = adm.tr_base
        d_it, d_cro, d_fea, d_cg = it - b[0], cro - b[1], fea - b[2], cg - b[3]
        if d_it or d_cro or d_fea or d_cg:
            adm.req.trace.window(t, d_it, d_cro, d_fea, d_cg)
        adm.tr_base = (it, cro, fea, cg)

    def _trace_sync(self, shard: _Shard, every: int = 8):
        """Flush window deltas for traced live lanes at a boundary the
        tick loop ALREADY synchronized — one batched (B,)-host read, and
        only when a traced lane is live, so the untraced hot path runs
        the exact same code it did before tracing existed. Throttled to
        every ``every``-th traced sync boundary: the readback is tiny
        but not free, and park/harvest flush the SAME counters exactly
        at the span boundaries, so mid-span windows are a coarse
        progress signal, not the source of truth."""
        lanes = [i for i in range(shard.width)
                 if shard.slot_adm[i] is not None
                 and shard.slot_adm[i].req.trace is not None]
        if not lanes:
            return
        shard.trace_sync_n += 1
        if shard.trace_sync_n % every:
            return
        it, cro, fea, cg = (
            t.cpu().numpy() for t in (shard.state.it, shard.state.n_cronet,
                                      shard.state.n_fea, shard.state.cg_iters))
        t = time.monotonic()
        for i in lanes:
            self._trace_flush(shard.slot_adm[i], t, int(it[i]),
                              int(cro[i]), int(fea[i]), int(cg[i]))

    def _harvest_lane(self, shard: _Shard, lane: int, now: float):
        """Pull a finished lane's result (device sync) + resolve."""
        adm = shard.slot_adm[lane]
        req = adm.req
        req.density = shard.state.x[lane].cpu().numpy().copy()
        if req.orig_mesh is not None:
            # shape-class serving: crop the passive border back off so
            # the caller sees the mesh they submitted
            req.density = fea2d.crop_density(req.density, *req.orig_mesh)
        req.compliance = float(shard.state.compliance[lane])
        req.cronet_iters = int(shard.state.n_cronet[lane])
        req.fea_iters = int(shard.state.n_fea[lane])
        req.cg_iters = int(shard.state.cg_iters[lane])
        req.model_tag = self.model_tag
        t_done = time.monotonic()    # deadline math: monotonic, like submit
        req.completed_t = time.time()  # user-facing wall-clock stamp
        req.latency_s = t_done - adm.first_admit_t
        req.deadline_met = (None if req.deadline is None
                            else t_done <= req.deadline)
        req.done = True
        if req.trace is not None:
            # final window + completion BEFORE resolving, so done
            # callbacks (the gateway's trace registry) see it complete
            self._trace_flush(adm, t_done,
                              req.cronet_iters + req.fea_iters,
                              req.cronet_iters, req.fea_iters,
                              req.cg_iters)
            req.trace.finish(t=t_done, iters=req.cronet_iters
                             + req.fea_iters)
        shard.slot_adm[lane] = None
        with self._sched.cond:
            self._completed.append(req)
            self._inflight -= 1
            self._m_inflight.set(self._inflight, mesh=self._mesh_label)
            self._sched.cond.notify_all()
        adm.future._resolve()
        outcome = ("none" if req.deadline_met is None
                   else "met" if req.deadline_met else "missed")
        self._m_done.inc(mesh=self._mesh_label, outcome=outcome)
        if req.cronet_iters:
            self._m_iters.inc(req.cronet_iters, mesh=self._mesh_label,
                              path="cronet")
        if req.fea_iters:
            self._m_iters.inc(req.fea_iters, mesh=self._mesh_label,
                              path="fea")
        self._m_cg.observe(req.cg_iters, mesh=self._mesh_label)
        # the host read above synced through every dispatched step:
        # close the timing window and update the per-step estimate
        if shard.steps_in_window > 0 and shard.busy_t0 is not None:
            per = (t_done - shard.busy_t0) / shard.steps_in_window
            self._sec_per_step = (per if self._sec_per_step is None
                                  else 0.5 * self._sec_per_step + 0.5 * per)
            self._m_tick.observe(per, n=shard.steps_in_window,
                                 mesh=self._mesh_label, rung=shard.width,
                                 device=self.device.type)
        shard.busy_t0 = t_done
        shard.steps_in_window = 0

    def _admit_lane(self, shard: _Shard, lane: int, adm: _Admission,
                    now: float):
        if adm.first_admit_t is None:
            adm.first_admit_t = now
            adm.req.admitted_t = now
            adm.req.queue_wait_s = now - adm.req.submit_t
            self._m_wait.observe(adm.req.queue_wait_s,
                                 mesh=self._mesh_label)
        if adm.req.trace is not None:
            # closes the open queued/parked span at the same stamp, so
            # the phase timeline stays contiguous across preemptions
            adm.req.trace.begin(obs_trace.COMPUTE, t=now, lane=lane)
        shard.fill(lane, adm)

    def _shard_loop(self, shard: _Shard):
        """One shard's tick loop: harvest finished lanes, drain admissions
        (EDF pops + at most one slack-safe preemption), pick the ladder
        rung for the live occupancy (compact + resize when it changed),
        seed the lanes touched this tick, dispatch the next step. Besides
        harvest and park, the step itself syncs (its two skip decisions
        are made on the host), and the loop syncs every second tick."""
        sched = self._sched
        L = self.shard_width
        try:
            shard.activate()
            while True:
                now = time.monotonic()
                # -- harvest (single-writer lane bookkeeping, syncs device)
                harvested = False
                for i in range(L):
                    adm = shard.slot_adm[i]
                    if adm is not None and shard.slot_iters[i] >= adm.req.n_iter:
                        self._harvest_lane(shard, i, now)
                        harvested = True
                # -- admissions: atomic vs concurrent submit(). fill()
                # writes host constants only; device seeding waits until
                # the tick's rung is settled (seeds list below)
                dirty = harvested
                seeds: List[int] = []     # admitted lanes awaiting device seed
                cleared: List[int] = []   # harvested lanes left empty
                cap = shard.cap
                with sched.cond:
                    occupied_n = sum(a is not None for a in shard.slot_adm)
                    for i in range(L):
                        if shard.slot_adm[i] is not None:
                            continue
                        entry = sched.pop() if occupied_n < cap else None
                        if entry is None:
                            if harvested:
                                shard.fill(i, None)  # clear stale load
                                cleared.append(i)
                            continue
                        self._admit_lane(shard, i, entry.payload, now)
                        seeds.append(i)
                        occupied_n += 1
                        dirty = True
                    # preemption: queue head about to miss, no free lane.
                    # Decide and pop the head under the lock; the actual
                    # park (a device sync) happens after release so other
                    # shards and submit() are not stalled behind it.
                    # Popping the head BEFORE re-queueing the victim also
                    # matters: a long-waiting deadline-less victim can
                    # outrank the head (starvation horizon), and popping
                    # after the push would hand the lane straight back to
                    # the evictee. Preemption stays keyed to a TRULY full
                    # shard: a rung cap below full width pauses admission
                    # but never evicts (the cap is elasticity, not urgency).
                    victim = preempt_entry = None
                    head = sched.peek() if self.preempt else None
                    if head is not None and all(a is not None
                                                for a in shard.slot_adm):
                        views = [
                            None if a is None else SlotView(
                                deadline=(a.req.deadline if a.req.deadline
                                          is not None else INF),
                                iters_left=a.req.n_iter - shard.slot_iters[i],
                                preemptible=i not in seeds)
                            for i, a in enumerate(shard.slot_adm)]
                        victim = preempt_victim(
                            head.deadline, head.payload.iters_left,
                            views, now, self._estimate())
                        if victim is not None:
                            preempt_entry = sched.pop()
                    occupied = any(a is not None for a in shard.slot_adm)
                    if not occupied and preempt_entry is None:
                        if self._stopping and len(sched._heap) == 0:
                            break
                        shard.busy_t0 = None
                        shard.steps_in_window = 0
                        sched.cond.wait(timeout=0.1)
                        continue
                if preempt_entry is not None:
                    parked = shard.park(victim)   # device sync, lock-free
                    self.preemptions += 1
                    self._m_preempt.inc(mesh=self._mesh_label)
                    if parked.req.trace is not None:
                        # the parked snapshot is already on host: flush
                        # the window up to the park and open the parked
                        # span (closed again at re-admission)
                        t_park = time.monotonic()
                        self._trace_flush(
                            parked, t_park, int(parked.parked.it),
                            int(parked.parked.n_cronet),
                            int(parked.parked.n_fea),
                            int(parked.parked.cg_iters))
                        parked.req.trace.begin(obs_trace.PARKED, t=t_park,
                                               iters_done=parked.iters_done)
                    sched.push(parked, parked.req.deadline, now,
                               seq=parked.seq,
                               eff_deadline=parked.eff_deadline,
                               priority=parked.req.priority)
                    self._admit_lane(shard, victim, preempt_entry.payload,
                                     now)
                    seeds.append(victim)
                    dirty = True
                # -- ladder rung: smallest rung width >= occupancy.
                # Live lanes above the new width migrate down via exact
                # lane copies BEFORE the state is sliced, so a rung
                # shrink never touches a trajectory; seeds (admitted this
                # tick, no device state yet) are relabeled in place.
                occ = sum(a is not None for a in shard.slot_adm)
                if shard._set_width(rung_for(occ, shard.rungs), seeds):
                    dirty = True
                for i in seeds:
                    shard.seed(i)
                for i in cleared:     # reset harvested-but-idle lane state
                    # (unless a rung shrink sliced it off or compacted a
                    # live lane into it)
                    if i < shard.width and shard.slot_adm[i] is None:
                        shard.seed(i)
                if dirty:
                    shard._upload()
                # -- tick: one step, admissions drain before the
                # next one
                if shard.busy_t0 is None:
                    shard.busy_t0 = time.monotonic()
                shard.state = self.step(shard.params, shard.bp,
                                        shard.load_vol, shard.state)
                shard.steps += 1
                shard.rung_steps[shard.width] += 1
                shard.steps_in_window += 1
                t_tick = None    # stamped lazily, only if a lane is traced
                for i in range(L):
                    adm_i = shard.slot_adm[i]
                    if adm_i is not None:
                        shard.slot_iters[i] += 1
                        if adm_i.req.trace is not None:
                            if t_tick is None:
                                t_tick = time.monotonic()
                            adm_i.req.trace.tick(t_tick, shard.width,
                                                 shard.slot_iters[i])
                # bound the dispatch-ahead depth: waiting on the current
                # frontier every 2 dispatches keeps a newly admitted
                # request <= 2 ticks behind the device
                if shard.steps_in_window % 2 == 0:
                    if shard.device.type == "cuda":
                        torch.cuda.synchronize(shard.device)
                    self._trace_sync(shard)
        except BaseException as exc:  # fail every waiter, don't hang
            with sched.cond:
                self._failure = exc
                self._stopping = True
                while True:
                    entry = sched.pop()
                    if entry is None:
                        break
                    self._inflight -= 1
                    entry.payload.future._resolve(exc)
                for i, adm in enumerate(shard.slot_adm):
                    if adm is not None:
                        shard.slot_adm[i] = None
                        self._inflight -= 1
                        adm.future._resolve(exc)
                self._sched.cond.notify_all()
            raise
        finally:
            with self._steps_lock:
                self._steps_base += shard.steps
                shard.steps = 0
            if self._closed or self._failure is not None:
                # terminal: drop the shard's device tensors now, so an
                # evicted or rolled-back engine frees its memory without
                # waiting for the garbage collector to break the
                # engine <-> shard cycle (a restartable stop() keeps
                # them; activate() replaces them on restart anyway)
                shard.params = shard.bp = shard.load_vol = None
                shard.state = None

    # -------------------------------------------------------------- shim

    def run(self, requests: List[TopoRequest]) -> List[TopoRequest]:
        """Drain-mode compatibility shim over the streaming core: submit
        everything, wait for completion, and stop the tick loops if this
        call started them. Returns the requests with densities filled."""
        steps_before = self.total_steps
        was_running = self._running
        futs = [self.submit(r) for r in requests]
        for f in futs:
            f.result()
        if not was_running:
            self.stop()
        self.last_run_steps = self.total_steps - steps_before
        return requests

    # ------------------------------------------------------------- stats

    def throughput_stats(self, requests: Optional[List[TopoRequest]] = None,
                         wall_s: Optional[float] = None) -> Dict[str, float]:
        """Serving stats over `requests` (default: the completed-request
        ring, i.e. the most recent `completed_limit` completions). See
        types.pool_stats for the shared metric definitions."""
        if requests is None:
            with self._sched.cond:
                pool = list(self._completed)
        else:
            pool = requests
        stats = pool_stats(pool, wall_s)
        stats.update({
            "preemptions": float(self.preemptions),
            "batched_steps": float(self.last_run_steps),
            "total_steps": float(self.total_steps),
            "model_tag": self.model_tag,
            "device": str(self.device),
        })
        if self.ladder is not None:
            rung_steps: Dict[int, int] = {r: 0 for r in self._rungs}
            for sh in self._shards:
                for r, c in sh.rung_steps.items():
                    rung_steps[r] += c
            stats["ladder"] = {
                "rungs": list(self._rungs),
                "widths": [sh.width for sh in self._shards],
                "caps": [sh.cap for sh in self._shards],
                "rung_steps": {str(r): float(c)
                               for r, c in sorted(rung_steps.items())},
                "rung_changes": float(sum(sh.rung_changes
                                          for sh in self._shards)),
                "migrations": float(sum(sh.migrations
                                        for sh in self._shards)),
            }
        return stats


# ------------------------------------------------------------- worker build


def engine_from_spec(spec: Dict) -> "TopoServingEngine":
    """Build a ``TopoServingEngine`` from a picklable description — the
    engine factory the gateway's worker processes use in-worker (a spec
    crosses a process boundary; a live engine, with its threads, locks
    and device tensors, cannot).

    ``spec`` keys:

      * ``cfg`` — the bucket's ``CRONetConfig`` (already mesh-replaced).
      * ``params`` / ``u_scale`` — explicit model tensors; OR
      * ``registry_root`` + ``model_tag`` — load the params from the
        shared on-disk ``ModelRegistry`` (either package's) onto the
        engine's device instead of shipping the tree.
      * ``slots`` / ``model_tag`` / ``ladder`` / ``shape_padded`` —
        engine geometry, verbatim constructor kwargs.
      * ``engine_kwargs`` — remaining ``TopoServingEngine`` kwargs
        (``device``, ``precision``, ``error_threshold``, ...). The device
        defaults to the card. The JAX engine's ``backend`` and
        ``fea_backend`` have no counterpart here: a spec that names them
        raises ``TypeError``.

    Construction runs through the same constructor with the same params,
    so a spec-built engine's densities are bitwise-equal to an engine
    built directly for the same requests.
    """
    cfg = spec["cfg"]
    params = spec.get("params")
    u_scale = spec.get("u_scale")
    tag = spec.get("model_tag")
    kwargs = dict(spec.get("engine_kwargs") or {})
    if params is None:
        root = spec.get("registry_root")
        if root is None:
            raise ValueError("engine spec needs params or registry_root")
        from repro_torch.serve.registry import ModelRegistry
        params, rec = ModelRegistry(root).load(
            tag, device=kwargs.get("device", "cuda"))
        tag = rec.tag
        u_scale = u_scale if u_scale is not None else rec.u_scale
    return TopoServingEngine(
        cfg, params, u_scale,
        slots=int(spec.get("slots", 8)),
        model_tag=tag,
        ladder=spec.get("ladder"),
        shape_padded=bool(spec.get("shape_padded", False)),
        **kwargs)
