"""Multi-process engine workers: the gateway/engine seam across processes.
The counterpart of ``repro.serve.workers``, in front of the port's
``TopoServingEngine``.

Tick-loop THREADS in one Python process share one interpreter lock, and
on the card one process's ``torch.cuda.synchronize`` waits on every
stream of its context. This module splits the serving stack along the
seam that already exists: ``TopoGateway`` stays the front door
(admission queue + ModelResolver + fleet control plane, one process)
while the engine pools move into WORKER processes, one interpreter and
one CUDA context each.

Shape (cf. the saxml admin/location split):

  * ``WorkerPool`` (parent) spawns N ``EngineWorker`` processes and
    leases mesh buckets to them (least-loaded assignment). The
    gateway's engine factory asks the pool to ``build_engine(mesh,
    spec)`` and gets back a ``RemoteEngine`` — a proxy honouring the
    exact attribute surface the gateway already pokes on a local
    ``TopoServingEngine`` (``inflight``/``_completed``/``_sched.cond``/
    ``submit``/``drain``/``swap_params``/``throughput_stats``/...), so
    routing, canary auto-rollback and the obs layer keep working
    unchanged.
  * The wire protocol is a thin length-prefixed pickle RPC over
    ``multiprocessing`` pipes: ``build`` / ``submit`` / ``park`` /
    ``swap`` / ``stats`` / ``shutdown_engine`` / ``ping`` /
    ``shutdown`` request verbs, plus ``admitted`` / ``complete``
    notifications flowing back. Every frame carries its own length
    prefix inside the payload, so a torn or short frame is detected
    instead of unpickled.
  * Engines are built IN the worker from a picklable spec
    (``topo_service.engine_from_spec``) — from the shared on-disk
    ``ModelRegistry`` when the model is a registered version (each
    worker reads the checkpoint once; nothing large crosses the pipe),
    or from explicitly pickled params otherwise (a CUDA tensor pickles
    through host bytes and is restored on the same device index). Same
    ctor, same params, same request bytes: a worker-served density is
    BITWISE-EQUAL to the in-process engine's for the same request.
  * A worker loads the kernel libraries from ``build/kernels/`` at its
    engine's first tick (building any that are missing); the ``stats``
    verb reports the worker process's kernel launch counts, the only
    place they can be read.

Robustness is first-class, not bolted on:

  * Worker heartbeats (``ping`` on a daemon cadence) with
    deadline-aware RPC timeouts; a wedged worker is killed and treated
    as lost. A worker is pinged only once it has said ``ready`` (its
    loop reads the pipe): until then it is importing torch, seconds on
    a busy host, and a ping could only time out. A worker not ready
    within ``build_timeout_s`` of its spawn counts as wedged.
  * Crash detection (pipe EOF, dead pid, heartbeat timeout) fails
    in-flight futures with a typed ``WorkerLost`` — but ONLY for
    requests that had been admitted to a tick; requests still queued in
    the dead worker are REQUEUED onto a surviving or respawned worker
    in their original submission order, preserving priority + deadline
    (and therefore EDF rank). Every future resolves with a result or a
    typed error.
  * Lease reassignment: an orphaned bucket's proxy is rebound to a new
    worker-side engine; the gateway never notices (same proxy object).
  * No fallback: a worker that cannot build its engine fails the
    ``build`` call with its error, and nothing serves in-process in its
    place.
  * Every transition is a typed ``worker-*`` FleetEvent (``spawn`` /
    ``ready`` (with its start seconds) / ``lease`` / ``stale`` /
    ``lost`` / ``reassign`` / ``requeue`` / ``exit``)
    through the gateway's event log, and completions carry
    ``worker_id`` so the obs layer can split per-worker metrics.

Monotonic stamps (submit_t / deadline / admitted_t) transfer across the
RPC unchanged: CLOCK_MONOTONIC is system-wide on Linux, so deadline
math computed in the parent is valid in the worker and vice versa.
"""
from __future__ import annotations

import collections
import hashlib
import os
import pickle
import struct
import sys
import threading
import time
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.serve.types import (EngineClosed, TopoFuture, TopoRequest,
                                     WorkerLost, pool_stats)

__all__ = ["WorkerPool", "RemoteEngine", "EngineWorker", "WorkerLost",
           "params_digest"]

Mesh = Tuple[int, int]

_LEN = struct.Struct("!I")


# ------------------------------------------------------------------ framing


def _send_msg(conn, lock: threading.Lock, obj) -> None:
    """Length-prefixed pickle send: the payload is ``!I`` length +
    pickle bytes, so the receiver can detect a torn frame (a worker
    killed mid-send) instead of handing garbage to ``pickle.loads``.
    ``lock`` serializes writers — replies, completion notifications and
    heartbeats share one pipe end."""
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    frame = _LEN.pack(len(body)) + body
    with lock:
        conn.send_bytes(frame)


def _recv_msg(conn):
    """Receive one framed message; raises ``EOFError`` on a closed pipe
    and ``ValueError`` on a torn frame."""
    frame = conn.recv_bytes()
    if len(frame) < _LEN.size:
        raise ValueError(f"short frame: {len(frame)} bytes")
    (n,) = _LEN.unpack_from(frame)
    body = frame[_LEN.size:]
    if len(body) != n:
        raise ValueError(f"torn frame: prefix says {n} bytes, "
                         f"got {len(body)}")
    return pickle.loads(body)


def params_digest(params) -> str:
    """sha256 over a parameter tree's names, dtypes, shapes and bytes, in
    sorted key order: equal digests mean the same tree bit for bit,
    wherever each side holds it."""
    h = hashlib.sha256()
    for part in sorted(params):
        for name in sorted(params[part]):
            t = params[part][name].detach().cpu().contiguous().reshape(-1)
            h.update(f"{part}/{name}:{t.dtype}:"
                     f"{tuple(params[part][name].shape)}".encode())
            h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _portable(exc: Optional[BaseException]) -> Optional[BaseException]:
    """``exc``, or a ``RuntimeError`` naming it when it does not pickle: a
    worker's failure must reach the parent as an error, not as a call
    that times out and looks like a lost worker."""
    if exc is None:
        return None
    try:
        pickle.dumps(exc, protocol=pickle.HIGHEST_PROTOCOL)
        return exc
    except Exception as why:
        return RuntimeError(f"{exc!r} (did not pickle: {why!r})")


# ------------------------------------------------------------ worker (child)


class EngineWorker:
    """The child-process half: owns local ``TopoServingEngine``s and a
    recv-dispatch loop over the RPC pipe. Instantiated by
    ``_worker_main`` in the spawned process — never in the parent."""

    def __init__(self, conn, worker_id: int):
        self.conn = conn
        self.worker_id = worker_id
        self._send_lock = threading.Lock()
        self._engines: Dict[int, object] = {}       # engine_id -> engine
        self._watch_lock = threading.Lock()
        # submissions whose first-tick admission the parent has not been
        # told about yet: (engine_id, req) — the admitted monitor thread
        # polls req.admitted_t (stamped by the engine at first slot
        # admission) and sends one "admitted" notice per request. This
        # is the signal the parent's crash recovery splits on.
        self._watch: Dict[int, Tuple[int, TopoRequest]] = {}
        self._stop = threading.Event()

    # ------------------------------------------------------------- sends

    def _send(self, obj):
        try:
            _send_msg(self.conn, self._send_lock, obj)
        except (OSError, ValueError, BrokenPipeError):
            # parent is gone: nothing to report to; the shutdown verb
            # (or the parent's kill) ends the process
            self._stop.set()

    # ----------------------------------------------------- admitted poll

    def _monitor_loop(self):
        while not self._stop.wait(0.005):
            with self._watch_lock:
                items = list(self._watch.items())
            for uid, (eid, req) in items:
                t = req.admitted_t
                if t is not None:
                    with self._watch_lock:
                        self._watch.pop(uid, None)
                    self._send({"kind": "admitted", "engine_id": eid,
                                "uid": uid, "admitted_t": t})

    # ----------------------------------------------------------- verbs

    def _do_build(self, msg):
        from repro_torch.serve.topo_service import engine_from_spec
        eng = engine_from_spec(msg["spec"])
        self._engines[msg["engine_id"]] = eng
        devices = sorted({str(t.device) for leaves in eng.params.values()
                          for t in leaves.values()})
        return {"model_tag": eng.model_tag, "slots": eng.slots,
                "pid": os.getpid(), "device": str(eng.device),
                "params_devices": devices,
                "params_digest": params_digest(eng.params)}

    def _do_submit(self, msg):
        eid = msg["engine_id"]
        eng = self._engines[eid]
        req: TopoRequest = msg["req"]
        fut = TopoFuture(req)
        with self._watch_lock:
            self._watch[req.uid] = (eid, req)
        # _future=... keeps the parent's submit_t/deadline stamps (the
        # monotonic clock is system-wide, so they are valid here)
        try:
            eng.submit(req, priority=req.priority, _future=fut)
        except BaseException:
            with self._watch_lock:
                self._watch.pop(req.uid, None)
            raise

        def _on_done(f: TopoFuture, eid=eid, eng=eng):
            with self._watch_lock:
                self._watch.pop(f.request.uid, None)
            self._send({
                "kind": "complete", "engine_id": eid,
                "uid": f.request.uid, "req": f.request,
                "error": _portable(f.exception()),
                "counters": {"preemptions": eng.preemptions,
                             "total_steps": eng.total_steps},
            })

        fut.add_done_callback(_on_done)
        return True

    def _do_park(self, msg):
        self._engines[msg["engine_id"]].stop(wait=msg.get("wait", True))
        return True

    def _do_swap(self, msg):
        eng = self._engines[msg["engine_id"]]
        params = msg.get("params")
        if params is None:
            # registered version: read from the shared registry instead
            # of shipping the tree through the pipe
            from repro_torch.serve.registry import ModelRegistry
            params, rec = ModelRegistry(msg["registry_root"]).load(
                msg["model_tag"], device=eng.device)
        eng.swap_params(params, u_scale=msg.get("u_scale"),
                        model_tag=msg.get("model_tag"))
        return True

    def _do_stats(self, msg):
        """One engine's ``throughput_stats`` (``engine_id`` None: none),
        with this process's pid and kernel launch counts."""
        from repro_torch import kernels
        eid = msg.get("engine_id")
        stats = ({} if eid is None else
                 self._engines[eid].throughput_stats(wall_s=msg.get("wall_s")))
        stats.update(pid=os.getpid(), launch_counts=kernels.launch_counts())
        return stats

    def _do_shutdown_engine(self, msg):
        eng = self._engines.pop(msg["engine_id"], None)
        if eng is not None:
            eng.shutdown(wait=msg.get("wait", False))
        return True

    def _do_ping(self, msg):
        return {"pid": os.getpid(), "engines": len(self._engines),
                "inflight": sum(e.inflight
                                for e in self._engines.values())}

    def _do_shutdown(self, msg):
        for eng in self._engines.values():
            try:
                eng.shutdown(wait=False)
            except Exception:
                pass
        self._stop.set()
        return True

    # ------------------------------------------------------------- loop

    def _dispatch(self, fn, msg):
        rid = msg.get("id")
        try:
            value = fn(msg)
            reply = {"kind": "reply", "id": rid, "ok": True,
                     "value": value}
        except BaseException as exc:
            reply = {"kind": "reply", "id": rid, "ok": False,
                     "error": _portable(exc)}
        if rid is not None:
            self._send(reply)

    #: verbs answered inline on the recv loop — cheap and
    #: non-blocking, so a heartbeat ping is never starved
    _INLINE = ("ping", "shutdown")

    def run(self):
        threading.Thread(target=self._monitor_loop,
                         name="worker-admit-monitor", daemon=True).start()
        self._send({"kind": "ready", "pid": os.getpid()})
        verbs = {
            "build": self._do_build, "submit": self._do_submit,
            "park": self._do_park, "swap": self._do_swap,
            "stats": self._do_stats,
            "shutdown_engine": self._do_shutdown_engine,
            "ping": self._do_ping, "shutdown": self._do_shutdown,
        }
        while not self._stop.is_set():
            try:
                msg = _recv_msg(self.conn)
            except (EOFError, OSError):
                break            # parent gone: exit quietly
            except ValueError:
                continue         # torn inbound frame: unrecoverable loss
                #                  of ONE message; keep serving
            fn = verbs[msg["op"]]
            if msg["op"] in self._INLINE:
                self._dispatch(fn, msg)
            else:
                # slow verbs (a build reads a checkpoint and sets up the
                # engine; park/shutdown_engine drain) run off-loop so the
                # worker keeps answering heartbeats — a worker mid-build
                # must look BUSY, not WEDGED. The parent's RPC discipline
                # (await build before submit, etc.) provides ordering.
                threading.Thread(target=self._dispatch, args=(fn, msg),
                                 name=f"worker-{msg['op']}",
                                 daemon=True).start()


def _worker_main(conn, worker_id: int):
    """Spawned-process entry point (module-level for pickling under the
    spawn start method). Leaves with ``os._exit`` once the loop ends:
    the interpreter's own teardown can abort in the CUDA runtime's and
    torch's native threads (``terminate called ...``), which would turn a
    clean shutdown into a crashed worker."""
    EngineWorker(conn, worker_id).run()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


# ---------------------------------------------------------- proxy (parent)


class RemoteEngine:
    """Parent-side stand-in for one worker-resident engine.

    Honours the engine attribute surface the gateway relies on — the
    contract ``tests/test_torch_gateway.py``'s ``_FakeEngine`` documents:
    ``cfg``/``slots``/``model_tag``/``inflight``/``preemptions``/
    ``total_steps``/``_failure``/``_closed``/``_completed``/
    ``_sched.cond``, plus ``submit``/``drain``/``stop``/``swap_params``/
    ``shutdown``/``throughput_stats``. ``ladder`` is exposed as ``None``
    on purpose: live rung retargeting (``set_target_slots``) is a
    per-tick host-side lever that does not survive an RPC round-trip
    cheaply, so the gateway's maintenance pass skips worker-mode buckets
    (a documented worker-mode limitation, not silent breakage).

    Completion flow: the worker sends the fully-harvested request back;
    the proxy copies the result fields onto the PARENT's original
    request object (the one the caller's future wraps) and resolves the
    front-door future — callers cannot tell the engine ran elsewhere.
    ``density`` is a numpy array, so nothing of the card crosses back.
    """

    #: completion fields copied worker -> parent request object
    _COPY = ("done", "completed_t", "density", "compliance",
             "cronet_iters", "fea_iters", "cg_iters", "latency_s",
             "queue_wait_s", "deadline_met", "preemptions", "model_tag",
             "admitted_t", "trace")

    def __init__(self, pool: "WorkerPool", handle: "_WorkerHandle",
                 engine_id: int, mesh: Mesh, cfg, spec: Dict,
                 model_tag: Optional[str], slots: int,
                 completed_limit: int = 1024, build_info=None):
        self._pool = pool
        self._handle = handle
        self._engine_id = engine_id
        self.mesh = mesh
        self.cfg = cfg
        self.spec = spec                 # rebuild recipe for reassignment
        self.model_tag = model_tag
        self.slots = slots
        # the worker's build reply: pid, device, and where and what the
        # engine's params are (``params_devices``, ``params_digest``)
        self.build_info: Dict = dict(build_info or {})
        self.ladder = None               # gateway skips live resize
        self.shape_padded = bool(spec.get("shape_padded", False))
        self.inflight = 0
        self.preemptions = 0
        self.total_steps = 0
        self._failure: Optional[BaseException] = None
        self._closed = False
        # the gateway snapshots completions under eng._sched.cond — give
        # it the exact surface it expects
        self._sched = SimpleNamespace(cond=threading.Condition())
        self._completed: collections.deque = collections.deque(
            maxlen=completed_limit)
        # uid -> (req, fut, admitted) in submission order (an
        # OrderedDict, so crash requeue preserves original EDF order)
        self._pending: "collections.OrderedDict[int, list]" = \
            collections.OrderedDict()
        self._rebound = threading.Event()
        self._rebound.set()
        self._splits = 0                 # crash splits so far (under cond)

    @property
    def worker_id(self) -> int:
        return self._handle.worker_id

    # ------------------------------------------------------- submissions

    def _submit_rpc(self, req: TopoRequest, handle=None):
        # deadline-aware RPC timeout: a request with 2 s of slack must
        # not wait the full default on a wedged worker
        timeout = self._pool.rpc_timeout_s
        if req.deadline is not None:
            slack = req.deadline - time.monotonic()
            timeout = min(timeout, max(slack, 1.0))
        (handle or self._handle).call("submit", timeout=timeout,
                                      engine_id=self._engine_id, req=req)

    def submit(self, req: TopoRequest,
               deadline_s: Optional[float] = None, priority: int = 0,
               _future: Optional[TopoFuture] = None) -> TopoFuture:
        if self._closed:
            raise EngineClosed("remote engine is shut down")
        if self._failure is not None:
            raise RuntimeError("remote engine failed") from self._failure
        if deadline_s is not None:
            req.deadline_s = deadline_s
        if priority:
            req.priority = priority
        if _future is None:
            fut = TopoFuture(req)
            now = time.monotonic()
            req.submit_t = now
            req.deadline = (now + req.deadline_s
                            if req.deadline_s is not None else None)
        else:
            fut = _future
        while True:
            # a crash-rebind may be mid-flight: wait for the replacement
            # worker rather than failing a request the queue already
            # ranked
            self._rebound.wait(timeout=self._pool.rpc_timeout_s)
            handle = self._handle
            with self._sched.cond:
                self._pending[req.uid] = [req, fut, False]
                self.inflight += 1
                splits = self._splits
            try:
                self._submit_rpc(req, handle)
                return fut
            except WorkerLost:
                with self._sched.cond:
                    if (getattr(handle, "lost", False)
                            and self._splits == splits
                            and not getattr(self._pool, "_closing", False)):
                        # the worker died with this submit in flight, so
                        # the request never reached a tick: the loss path
                        # (which splits after failing pending calls)
                        # requeues it with the rest of the backlog
                        return fut
                    self._pending.pop(req.uid, None)
                    self.inflight -= 1
                    self._sched.cond.notify_all()
                if self._handle is handle and self._rebound.is_set():
                    raise
                # the backlog was split before this entry landed: submit
                # again once the bucket is rebound
            except BaseException:
                with self._sched.cond:
                    self._pending.pop(req.uid, None)
                    self.inflight -= 1
                    self._sched.cond.notify_all()
                raise

    # ------------------------------------------------- worker -> parent

    def _on_admitted(self, uid: int, admitted_t: float):
        with self._sched.cond:
            ent = self._pending.get(uid)
            if ent is None:
                return
            ent[2] = True
            ent[0].admitted_t = admitted_t

    def _on_complete(self, msg: Dict):
        with self._sched.cond:
            ent = self._pending.pop(msg["uid"], None)
            if ent is None:
                return           # stale completion from a pre-rebind era
            req, fut, _ = ent
            done: TopoRequest = msg["req"]
            for field in self._COPY:
                setattr(req, field, getattr(done, field))
            req.worker_id = self._handle.worker_id
            counters = msg.get("counters") or {}
            self.preemptions = int(counters.get("preemptions",
                                                self.preemptions))
            self.total_steps = int(counters.get("total_steps",
                                                self.total_steps))
            err = msg.get("error")
            if err is None:
                self._completed.append(req)
            self.inflight -= 1
            self._sched.cond.notify_all()
        self._pool._note_completion(self._handle.worker_id, self.mesh)
        fut._resolve(err)

    # ------------------------------------------------------ crash paths

    def _split_pending(self):
        """Under the proxy lock: detach all pending work, split into
        (admitted, queued) preserving submission order."""
        with self._sched.cond:
            self._splits += 1
            entries = list(self._pending.values())
            self._pending.clear()
            admitted = [(r, f) for r, f, a in entries if a]
            queued = [(r, f) for r, f, a in entries if not a]
            # the queued half stays counted in ``inflight`` until the
            # requeue below resolves one way or the other
            self.inflight = len(queued)
            self._sched.cond.notify_all()
        return admitted, queued

    def _fail_admitted(self, pairs, worker_id: int, reason: str):
        for req, fut in pairs:
            fut._resolve(WorkerLost(
                f"request {req.uid} was in a tick on worker "
                f"{worker_id} when it died ({reason})",
                worker_id=worker_id))

    def _rebind(self, handle: "_WorkerHandle", queued) -> int:
        """Point this proxy at a freshly-built engine on ``handle`` and
        resubmit the never-admitted backlog in original order (original
        request objects: priority + absolute monotonic deadline ride
        along, so EDF rank is preserved). Returns the requeued count."""
        self._handle = handle
        n = 0
        for req, fut in queued:
            with self._sched.cond:
                self._pending[req.uid] = [req, fut, False]
            try:
                self._submit_rpc(req)
                n += 1
            except BaseException as exc:
                with self._sched.cond:
                    self._pending.pop(req.uid, None)
                    self.inflight -= 1
                    self._sched.cond.notify_all()
                fut._resolve(WorkerLost(
                    f"request {req.uid} could not be requeued after "
                    f"worker loss: {exc!r}",
                    worker_id=handle.worker_id))
        return n

    def _fail_all(self, exc: BaseException):
        """Terminal: reassignment itself failed — every pending future
        resolves typed, and the gateway sees a failed engine (its
        dead-engine path fails later submits to the bucket)."""
        with self._sched.cond:
            entries = list(self._pending.values())
            self._pending.clear()
            self.inflight = 0
            self._failure = exc
            self._sched.cond.notify_all()
        for req, fut, _ in entries:
            fut._resolve(exc)

    # -------------------------------------------------- engine lifecycle

    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._sched.cond:
            return self._sched.cond.wait_for(
                lambda: self.inflight == 0 or self._failure is not None,
                timeout)

    def stop(self, wait: bool = True):
        try:
            self._handle.call("park", engine_id=self._engine_id,
                              wait=wait)
        except WorkerLost:
            pass                 # dead worker: nothing left to park

    def swap_params(self, params, u_scale: Optional[float] = None, *,
                    model_tag: Optional[str] = None):
        reg_root = self._pool.registry_root
        ship_ref = (params is None and reg_root is not None
                    and model_tag is not None)
        self._handle.call(
            "swap", engine_id=self._engine_id,
            params=None if ship_ref else params,
            registry_root=reg_root if ship_ref else None,
            u_scale=u_scale, model_tag=model_tag)
        self.model_tag = model_tag
        self.spec = dict(self.spec)
        self.spec["model_tag"] = model_tag
        if params is not None:
            self.spec["params"] = params
            self.spec["u_scale"] = (u_scale
                                    if u_scale is not None
                                    else self.spec.get("u_scale"))

    def shutdown(self, wait: bool = True):
        if self._closed:
            return
        self._closed = True
        try:
            self._handle.call("shutdown_engine",
                              engine_id=self._engine_id, wait=wait)
        except (WorkerLost, EngineClosed):
            pass
        self._pool._forget_engine(self)

    # -------------------------------------------------------------- stats

    def throughput_stats(self, requests: Optional[List[TopoRequest]] = None,
                         wall_s: Optional[float] = None) -> Dict:
        """Worker-side engine stats when the worker is reachable (the
        authoritative ring: counters, ladder, device, and the worker
        process's kernel launch counts), the parent-side completion
        mirror otherwise — a crashed worker must not take
        ``throughput_stats(per_mesh=True)`` down with it."""
        if requests is None:
            try:
                stats = self._handle.call("stats",
                                          engine_id=self._engine_id,
                                          wall_s=wall_s)
                stats["worker_id"] = self._handle.worker_id
                return stats
            except (WorkerLost, EngineClosed, OSError):
                with self._sched.cond:
                    requests = list(self._completed)
        stats = pool_stats(requests, wall_s)
        stats.update({"preemptions": float(self.preemptions),
                      "total_steps": float(self.total_steps),
                      "model_tag": self.model_tag,
                      "worker_id": self._handle.worker_id})
        return stats


# --------------------------------------------------------- handle (parent)


class _RPC:
    __slots__ = ("ev", "value", "error")

    def __init__(self):
        self.ev = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None


class _WorkerHandle:
    """Parent-side bookkeeping for one worker process: the pipe, the
    reply demultiplexer, and liveness state."""

    def __init__(self, pool: "WorkerPool", worker_id: int):
        self._pool = pool
        self.worker_id = worker_id
        ctx = pool._ctx
        self.conn, child_conn = ctx.Pipe(duplex=True)
        self._send_lock = threading.Lock()
        self._rpc_lock = threading.Lock()
        self._rpc_n = 0
        self._rpcs: Dict[int, _RPC] = {}
        self.lost = False
        # set by the worker's "ready" frame: its loop is reading the pipe
        self.ready = threading.Event()
        self.spawned_t = time.monotonic()
        self.engines: Dict[int, RemoteEngine] = {}   # engine_id -> proxy
        self.proc = ctx.Process(target=_worker_main,
                                args=(child_conn, worker_id),
                                name=f"topo-worker-{worker_id}",
                                daemon=True)
        self.proc.start()
        child_conn.close()       # parent keeps only its end
        self._reader = threading.Thread(
            target=self._read_loop, name=f"topo-worker-{worker_id}-rx",
            daemon=True)
        self._reader.start()

    # ---------------------------------------------------------- reading

    def _read_loop(self):
        while True:
            try:
                msg = _recv_msg(self.conn)
            except (EOFError, OSError):
                # pipe closed: the worker exited or was killed
                self._pool._on_worker_lost(self, "pipe closed")
                return
            except ValueError as exc:
                # torn frame: the worker died mid-send; anything after
                # it on the pipe is unreliable
                self._pool._on_worker_lost(self, f"torn frame: {exc}")
                return
            kind = msg.get("kind")
            if kind == "reply":
                with self._rpc_lock:
                    rpc = self._rpcs.pop(msg["id"], None)
                if rpc is not None:
                    if msg["ok"]:
                        rpc.value = msg.get("value")
                    else:
                        rpc.error = msg.get("error")
                    rpc.ev.set()
            elif kind == "ready":
                self.ready.set()
                self._pool._event(
                    "worker-ready",
                    details={"worker_id": self.worker_id,
                             "start_s": time.monotonic() - self.spawned_t})
            elif kind == "admitted":
                eng = self.engines.get(msg["engine_id"])
                if eng is not None:
                    eng._on_admitted(msg["uid"], msg["admitted_t"])
            elif kind == "complete":
                eng = self.engines.get(msg["engine_id"])
                if eng is not None:
                    eng._on_complete(msg)

    # ----------------------------------------------------------- calling

    def call(self, op: str, timeout: Optional[float] = None, **fields):
        """Synchronous RPC; raises the worker-side exception on a
        failed verb and ``WorkerLost`` on a dead/wedged worker."""
        if self.lost:
            raise WorkerLost(f"worker {self.worker_id} is lost",
                             worker_id=self.worker_id)
        rpc = _RPC()
        with self._rpc_lock:
            self._rpc_n += 1
            rid = self._rpc_n
            self._rpcs[rid] = rpc
        msg = {"op": op, "id": rid}
        msg.update(fields)
        try:
            _send_msg(self.conn, self._send_lock, msg)
        except (OSError, BrokenPipeError) as exc:
            with self._rpc_lock:
                self._rpcs.pop(rid, None)
            raise WorkerLost(
                f"worker {self.worker_id} pipe is down: {exc!r}",
                worker_id=self.worker_id) from exc
        timeout = timeout if timeout is not None else self._pool.rpc_timeout_s
        if not rpc.ev.wait(timeout):
            with self._rpc_lock:
                self._rpcs.pop(rid, None)
            raise WorkerLost(
                f"worker {self.worker_id} did not answer {op!r} within "
                f"{timeout:g}s", worker_id=self.worker_id)
        if rpc.error is not None:
            raise rpc.error
        return rpc.value

    def fail_pending_rpcs(self, reason: str):
        with self._rpc_lock:
            rpcs, self._rpcs = dict(self._rpcs), {}
        for rpc in rpcs.values():
            rpc.error = WorkerLost(
                f"worker {self.worker_id} lost mid-call: {reason}",
                worker_id=self.worker_id)
            rpc.ev.set()

    def kill(self):
        try:
            self.proc.kill()
        except Exception:
            pass


# -------------------------------------------------------------------- pool


class WorkerPool:
    """Spawn, lease to, monitor, and recover N engine-worker processes.

    Parameters
    ----------
    n_workers :        process count (the scaling knob).
    registry_root :    path of the shared on-disk ``ModelRegistry``;
                       when set, registered versions are loaded from
                       disk IN the worker instead of pickled across.
    events :           ``(kind, mesh=..., tag=..., reason=...,
                       details=...)`` callback — the gateway passes
                       ``record_event`` so ``worker-*`` transitions land
                       in its typed FleetEvent log.
    on_handoff :       called (mesh, worker_id) after a bucket is
                       reassigned off a lost worker — the gateway hooks
                       its harvest flush here so spooled-but-unflushed
                       serving data survives the churn.
    heartbeat_s :      ping cadence; ``0`` disables the monitor thread
                       (crash detection then rests on pipe EOF alone).
                       Only a worker that has said ``ready`` is pinged.
    rpc_timeout_s :    default synchronous-call timeout. Builds use
                       ``build_timeout_s`` (a first build may run nvcc
                       for a missing kernel library) and submits tighten
                       to the request's own deadline slack. A worker
                       not ready within ``build_timeout_s`` of its spawn
                       is killed as wedged.
    respawn :          keep the pool at ``n_workers`` by spawning a
                       replacement for each lost worker.
    metrics :          obs registry (defaults to the process-wide one);
                       gains ``topo_workers`` / ``topo_worker_restarts_
                       total`` / ``topo_worker_completions_total``.
    """

    def __init__(self, n_workers: int, *,
                 registry_root: Optional[str] = None,
                 events: Optional[Callable] = None,
                 on_handoff: Optional[Callable] = None,
                 heartbeat_s: float = 2.0,
                 heartbeat_timeout_s: float = 10.0,
                 rpc_timeout_s: float = 60.0,
                 build_timeout_s: float = 600.0,
                 respawn: bool = True,
                 metrics=None):
        if n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {n_workers}")
        import multiprocessing
        # spawn, not fork: a forked child would inherit the parent's CUDA
        # context and its threads in an unusable half-copied form
        self._ctx = multiprocessing.get_context("spawn")
        self.registry_root = registry_root
        self.rpc_timeout_s = float(rpc_timeout_s)
        self.build_timeout_s = float(build_timeout_s)
        self.heartbeat_s = float(heartbeat_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.respawn = respawn
        self._events = events
        self._on_handoff = on_handoff
        self._lock = threading.Lock()
        self._workers: List[_WorkerHandle] = []
        self._next_worker_id = 0
        self._next_engine_id = 0
        self._closing = False
        self.restarts = 0
        from repro_torch.obs import metrics as obs_metrics
        self.metrics = (metrics if metrics is not None
                        else obs_metrics.default_registry())
        self.metrics.gauge(
            "topo_workers", "live engine-worker processes",
            callback=lambda: len(self.live_workers()))
        self._m_restarts = self.metrics.counter(
            "topo_worker_restarts_total",
            "worker processes respawned after a loss")
        self._m_done = self.metrics.counter(
            "topo_worker_completions_total",
            "requests completed per worker process")
        for _ in range(int(n_workers)):
            self._spawn()
        self._hb_stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        if self.heartbeat_s > 0:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, name="topo-worker-heartbeat",
                daemon=True)
            self._hb_thread.start()

    # ------------------------------------------------------------ events

    def _event(self, kind: str, mesh: Optional[Mesh] = None,
               tag: Optional[str] = None, reason: str = "",
               details: Optional[Dict] = None):
        if self._events is not None:
            try:
                self._events(kind, mesh=mesh, tag=tag, reason=reason,
                             details=details or {})
            except Exception:
                pass             # a broken event sink must not break
                #                  crash recovery

    def _note_completion(self, worker_id: int, mesh: Mesh):
        self._m_done.inc(worker=str(worker_id),
                         mesh=f"{mesh[0]}x{mesh[1]}")

    # ---------------------------------------------------------- spawning

    def _spawn(self) -> _WorkerHandle:
        with self._lock:
            wid = self._next_worker_id
            self._next_worker_id += 1
        handle = _WorkerHandle(self, wid)
        with self._lock:
            self._workers.append(handle)
        self._event("worker-spawn", details={"worker_id": wid,
                                             "pid": handle.proc.pid})
        return handle

    def live_workers(self) -> List[_WorkerHandle]:
        with self._lock:
            return [w for w in self._workers
                    if not w.lost and w.proc.is_alive()]

    @property
    def worker_ids(self) -> List[int]:
        return [w.worker_id for w in self.live_workers()]

    def _least_loaded(self) -> _WorkerHandle:
        live = self.live_workers()
        if not live:
            if self._closing:
                raise EngineClosed("worker pool is shut down")
            if not self.respawn:
                raise WorkerLost("no live workers and respawn disabled")
            live = [self._spawn()]
        return min(live, key=lambda w: len(w.engines))

    # ----------------------------------------------------------- leasing

    def build_engine(self, mesh: Mesh, spec: Dict,
                     role: str = "primary") -> RemoteEngine:
        """Lease ``mesh`` to the least-loaded worker: build the engine
        there from ``spec`` (see ``topo_service.engine_from_spec``) and
        return the gateway-facing proxy. A build that fails in the
        worker raises its error here."""
        if self._closing:
            raise EngineClosed("worker pool is shut down")
        handle = self._least_loaded()
        with self._lock:
            eid = self._next_engine_id
            self._next_engine_id += 1
        info = handle.call("build", timeout=self.build_timeout_s,
                           engine_id=eid, spec=spec)
        proxy = RemoteEngine(self, handle, eid, mesh, spec["cfg"], spec,
                             model_tag=info.get("model_tag"),
                             slots=int(info.get("slots", 0) or
                                       spec.get("slots", 0)),
                             build_info=info)
        handle.engines[eid] = proxy
        self._event("worker-lease", mesh=mesh, tag=proxy.model_tag,
                    details={"worker_id": handle.worker_id,
                             "role": role})
        return proxy

    def _forget_engine(self, proxy: RemoteEngine):
        for w in list(self._workers):
            w.engines.pop(proxy._engine_id, None)

    # ------------------------------------------------------ crash paths

    def _on_worker_lost(self, handle: _WorkerHandle, reason: str):
        with self._lock:
            if handle.lost:
                return
            handle.lost = True
            self._workers = [w for w in self._workers if w is not handle]
            closing = self._closing
        handle.fail_pending_rpcs(reason)
        handle.kill()
        if closing:
            return               # shutdown tears workers down on purpose
        self._event("worker-lost", reason=reason,
                    details={"worker_id": handle.worker_id,
                             "engines": len(handle.engines)})
        orphans = list(handle.engines.values())
        handle.engines.clear()
        replacement: Optional[_WorkerHandle] = None
        # keep the pool at its configured width: an idle worker's death
        # must not silently shrink serving capacity for the next burst
        if self.respawn:
            replacement = self._spawn()
            self.restarts += 1
            self._m_restarts.inc()
        for proxy in orphans:
            self._reassign(proxy, handle, reason,
                           prefer=replacement)

    def _reassign(self, proxy: RemoteEngine, dead: _WorkerHandle,
                  reason: str, prefer: Optional[_WorkerHandle] = None):
        """Move an orphaned bucket to a surviving (or freshly spawned)
        worker: admitted in-flight requests fail typed ``WorkerLost``
        (their tick state died with the process), never-admitted ones
        requeue in original EDF order, and the proxy is rebound so the
        gateway keeps routing to the same object."""
        proxy._rebound.clear()
        admitted, queued = proxy._split_pending()
        proxy._fail_admitted(admitted, dead.worker_id, reason)
        try:
            target = (prefer if prefer is not None and not prefer.lost
                      else self._least_loaded())
            with self._lock:
                eid = self._next_engine_id
                self._next_engine_id += 1
            info = target.call("build", timeout=self.build_timeout_s,
                               engine_id=eid, spec=proxy.spec)
            proxy._engine_id = eid
            proxy.build_info = dict(info)
            target.engines[eid] = proxy
            requeued = proxy._rebind(target, queued)
            self._event(
                "worker-reassign", mesh=proxy.mesh, tag=proxy.model_tag,
                reason=reason,
                details={"from_worker": dead.worker_id,
                         "to_worker": target.worker_id,
                         "failed_inflight": len(admitted),
                         "requeued": requeued})
            if requeued:
                self._event("worker-requeue", mesh=proxy.mesh,
                            tag=proxy.model_tag,
                            details={"requeued": requeued,
                                     "worker_id": target.worker_id})
        except BaseException as exc:
            proxy._fail_all(WorkerLost(
                f"bucket {proxy.mesh} could not be reassigned after "
                f"worker {dead.worker_id} died: {exc!r}",
                worker_id=dead.worker_id))
            self._event("worker-reassign-failed", mesh=proxy.mesh,
                        tag=proxy.model_tag, reason=repr(exc),
                        details={"from_worker": dead.worker_id})
        finally:
            proxy._rebound.set()
        if self._on_handoff is not None:
            try:
                self._on_handoff(proxy.mesh, dead.worker_id)
            except Exception:
                pass

    # --------------------------------------------------------- heartbeat

    def _heartbeat_loop(self):
        while not self._hb_stop.wait(self.heartbeat_s):
            for w in self.live_workers():
                if not w.proc.is_alive():
                    self._on_worker_lost(w, "process died")
                    continue
                if not w.ready.is_set():
                    # still starting: its pipe is not read yet, so a
                    # ping would time out on a worker that is not wedged
                    if time.monotonic() - w.spawned_t > self.build_timeout_s:
                        self._event("worker-stale",
                                    details={"worker_id": w.worker_id,
                                             "starting": True})
                        w.kill()
                    continue
                try:
                    w.call("ping", timeout=self.heartbeat_timeout_s)
                except WorkerLost:
                    if w.lost:
                        continue     # died during the ping: not stale
                    # wedged (alive but unresponsive past the deadline):
                    # kill it so the loss path runs exactly once, off
                    # the pipe-EOF signal
                    self._event("worker-stale",
                                details={"worker_id": w.worker_id})
                    w.kill()
                except Exception:
                    pass

    # ---------------------------------------------------------- shutdown

    def stats(self) -> Dict:
        """Pool-level snapshot: live worker ids, per-worker engine
        counts, restarts."""
        live = self.live_workers()
        return {
            "workers": len(live),
            "worker_ids": [w.worker_id for w in live],
            "engines": {w.worker_id: len(w.engines) for w in live},
            "restarts": self.restarts,
        }

    def launch_counts(self) -> Dict[int, Dict[str, int]]:
        """Each live worker process's kernel launch counts (its ``stats``
        reply), by worker id: kernels launched in a worker are counted
        there and nowhere else."""
        return {w.worker_id: w.call("stats", engine_id=None)["launch_counts"]
                for w in self.live_workers()}

    def shutdown(self, timeout: float = 10.0):
        with self._lock:
            if self._closing:
                return
            self._closing = True
            workers = list(self._workers)
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=self.heartbeat_s + 1.0)
        for w in workers:
            try:
                w.call("shutdown", timeout=timeout)
            except (WorkerLost, Exception):
                pass
        deadline = time.monotonic() + timeout
        for w in workers:
            w.proc.join(timeout=max(0.1, deadline - time.monotonic()))
            if w.proc.is_alive():
                w.kill()
                w.proc.join(timeout=1.0)
            self._event("worker-exit",
                        details={"worker_id": w.worker_id,
                                 "exitcode": w.proc.exitcode})
        with self._lock:
            self._workers = []
