"""The port's engine worker processes (repro_torch/serve/workers.py) and
the gateway's ``workers=``, mirroring tests/test_workers.py.

  * device-free units: the length-prefixed pickle framing (round trip,
    torn-frame detection) and the ``RemoteEngine`` crash split against a
    stub handle — admitted in-flight work fails typed ``WorkerLost``,
    never-admitted work requeues in ORIGINAL submission order (priority
    and absolute deadline ride along, so EDF rank is preserved);
  * real spawned processes on the CPU: ``kill -9`` mid-tick (the admitted
    requests fail with ``WorkerLost`` naming the dead worker, the queued
    ones complete on the respawned worker, ``worker-*`` FleetEvents
    narrate it); a registry-backed two-worker interleaving sweep (every
    future resolves, no mis-tags, leases balance to zero); a
    worker-served density bitwise equal to an in-process port engine's,
    by registry reference and by explicit params; a worker whose engine
    build fails hands the caller its error, and nothing serves
    in-process in its place;
  * beside the JAX package: a ``workers=1`` port gateway against the JAX
    in-process gateway on one registry version;
  * on the card (marked ``cuda``, skipped without one): card params
    cross by value, bit for bit, onto the spec's device.

A spawned child starts with torch's default intra-op thread count, so
every test pins one thread on both sides (an autouse fixture):
``OMP_NUM_THREADS=1`` in the environment the pool spawns under,
``torch.set_num_threads(1)`` around the in-process run. Each spawn imports torch (~3 s), so worker
counts and respawn rounds stay small. JAX is imported only inside the
test that compares against it, so the ``cuda`` case runs on a machine
without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_workers.py
"""
import dataclasses
import multiprocessing
import os
import random
import signal
import struct
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.common import init_params
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.fea import fea2d
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import (ModelRegistry, TopoGateway, TopoRequest,
                               TopoServingEngine, WorkerLost)
from repro_torch.serve.workers import (RemoteEngine, WorkerPool, _recv_msg,
                                       _send_msg, params_digest)

U_SCALE = 50.0
CFG = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                          hist_len=3)
MESHES = [(12, 4), (10, 6)]
THRESHOLD = 1e9     # the surrogate's path and the forced FEA ticks both run


def wait_until(cond, timeout=10.0, interval=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            return False
        time.sleep(interval)
    return True


# ------------------------------------------------------------- framing


def test_framing_roundtrip_and_torn_frame_detection():
    a, b = multiprocessing.get_context("spawn").Pipe(duplex=True)
    lock = threading.Lock()
    msg = {"op": "submit", "payload": np.arange(6).reshape(2, 3),
           "tensor": torch.arange(4.0), "nested": {"deadline": 12.5}}
    _send_msg(a, lock, msg)
    got = _recv_msg(b)
    assert got["op"] == "submit"
    np.testing.assert_array_equal(got["payload"], msg["payload"])
    assert torch.equal(got["tensor"], msg["tensor"])

    # a frame whose prefix disagrees with its body is a torn write
    # (worker killed mid-send): typed error, not a pickle explosion
    a.send_bytes(struct.pack("!I", 999) + b"\x80\x04short")
    with pytest.raises(ValueError, match="torn frame"):
        _recv_msg(b)
    a.send_bytes(b"\x00\x01")
    with pytest.raises(ValueError, match="short frame"):
        _recv_msg(b)
    a.close()
    with pytest.raises((EOFError, OSError)):
        _recv_msg(b)
    b.close()


# ----------------------------------- crash-split units (stub pool/handle)


class _StubHandle:
    """Records submit RPCs instead of crossing a pipe."""

    def __init__(self, worker_id=7, fail=False):
        self.worker_id = worker_id
        self.fail = fail
        self.submitted = []          # uids, arrival order

    def call(self, op, timeout=None, **fields):
        if self.fail:
            raise WorkerLost("stub worker down", worker_id=self.worker_id)
        if op == "submit":
            self.submitted.append(fields["req"].uid)
        return True


def _stub_proxy(handle):
    pool = SimpleNamespace(rpc_timeout_s=5.0, registry_root=None,
                           _note_completion=lambda *a, **k: None,
                           _forget_engine=lambda p: None)
    cfg = SimpleNamespace(nelx=12, nely=4)
    return RemoteEngine(pool, handle, engine_id=0, mesh=(12, 4), cfg=cfg,
                        spec={"cfg": cfg}, model_tag="m", slots=2)


def _preq(uid, priority=0, deadline_s=None):
    return TopoRequest(uid=uid, problem=SimpleNamespace(nelx=12, nely=4),
                       n_iter=4, deadline_s=deadline_s, priority=priority)


def test_crash_split_fails_admitted_typed_and_requeues_in_edf_order():
    h0 = _StubHandle(worker_id=0)
    eng = _stub_proxy(h0)
    futs = [eng.submit(_preq(i, priority=i % 2, deadline_s=30.0 + i))
            for i in range(5)]
    assert h0.submitted == [0, 1, 2, 3, 4]
    # uids 0 and 2 reached a tick on the (about to die) worker
    eng._on_admitted(0, time.monotonic())
    eng._on_admitted(2, time.monotonic())

    admitted, queued = eng._split_pending()
    assert [r.uid for r, _ in admitted] == [0, 2]
    assert [r.uid for r, _ in queued] == [1, 3, 4]   # original order
    eng._fail_admitted(admitted, worker_id=0, reason="kill -9")
    for f in (futs[0], futs[2]):
        exc = f.exception()
        assert isinstance(exc, WorkerLost) and exc.worker_id == 0

    h1 = _StubHandle(worker_id=1)
    assert eng._rebind(h1, queued) == 3
    # resubmitted on the replacement in ORIGINAL submission order, on
    # the ORIGINAL request objects — priority and the absolute
    # monotonic deadline ride along, so the engine-side EDF scheduler
    # reconstructs the exact rank the dead worker saw
    assert h1.submitted == [1, 3, 4]
    assert eng.inflight == 3
    with eng._sched.cond:
        pend = [ent[0] for ent in eng._pending.values()]
    assert [r.priority for r in pend] == [1, 1, 0]
    assert all(r.deadline is not None for r in pend)
    for uid in (1, 3, 4):
        assert not futs[uid].done()


def test_rebind_onto_dead_replacement_fails_every_future_typed():
    eng = _stub_proxy(_StubHandle(worker_id=0))
    futs = [eng.submit(_preq(i)) for i in range(3)]
    _, queued = eng._split_pending()
    eng._rebind(_StubHandle(worker_id=1, fail=True), queued)
    for f in futs:
        assert isinstance(f.exception(), WorkerLost)
    assert eng.inflight == 0


class _DyingHandle(_StubHandle):
    """A worker that dies while a submit is on its way: the call fails
    ``WorkerLost`` with the handle marked lost (``lost=False``: the call
    timed out on a live, wedged worker instead)."""

    def __init__(self, lost=True):
        super().__init__(worker_id=3)
        self.dies_lost = lost
        self.lost = False

    def call(self, op, timeout=None, **fields):
        self.lost = self.dies_lost
        raise WorkerLost("died mid-call", worker_id=self.worker_id)


def test_submit_in_flight_to_a_dying_worker_is_requeued_not_failed():
    """A request whose submit call was on the pipe when the worker died
    never reached a tick: it stays pending for the loss path's split,
    which counts it as queued (requeued), not admitted. A call that
    timed out on a live worker still raises."""
    eng = _stub_proxy(_DyingHandle())
    fut = eng.submit(_preq(0, deadline_s=30.0))
    assert not fut.done() and eng.inflight == 1
    admitted, queued = eng._split_pending()
    assert admitted == [] and [r.uid for r, _ in queued] == [0]
    h1 = _StubHandle(worker_id=4)
    assert eng._rebind(h1, queued) == 1 and h1.submitted == [0]

    wedged = _stub_proxy(_DyingHandle(lost=False))
    with pytest.raises(WorkerLost):
        wedged.submit(_preq(1))
    assert wedged.inflight == 0 and not wedged._pending


# --------------------------------------------- real processes on the CPU


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    """One intra-op thread in the test process and in every worker a test
    spawns: a spawned child does not inherit torch.set_num_threads, and
    reduction order follows the thread count (the bitwise cases); it
    also keeps the workers from oversubscribing the cores under xdist."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, seed=0, device="cpu", dtype="float32")


def _problems(n, nelx=12, nely=4):
    return [fea2d.point_load_problem(nelx, nely,
                                     load_node=(i % (nelx - 1), 0),
                                     load=(0.0, -1.0 - 0.1 * i))
            for i in range(n)]


def _dedicated(params, mesh, reqs, slots=2):
    """The same requests on a dedicated single-mesh port engine, in this
    process."""
    eng = TopoServingEngine(
        dataclasses.replace(CFG, nelx=mesh[0], nely=mesh[1]), params,
        U_SCALE, slots=slots, error_threshold=THRESHOLD, device="cpu",
        metrics=MetricsRegistry())
    refs = eng.run([TopoRequest(uid=r.uid, problem=r.problem,
                                n_iter=r.n_iter) for r in reqs])
    eng.shutdown()
    return refs


def test_kill9_mid_tick_fails_admitted_typed_and_requeues_rest(params):
    """THE crash contract: kill -9 a worker while two requests are in a
    tick and two are queued behind them. The admitted ones fail with a
    typed ``WorkerLost`` naming the dead worker; the queued ones are
    requeued onto the respawned worker and complete; the fleet-event
    log narrates every transition; nothing is dropped."""
    probs = _problems(4)
    gw = TopoGateway(CFG, params, U_SCALE, slots=2, max_pending=16,
                     device="cpu", workers=1,
                     worker_pool_kwargs={"heartbeat_s": 0.5})
    try:
        # uids 0-1 run long (they will be mid-tick at the kill); uids
        # 2-3 queue behind the two slots and never reach a tick
        futs = [gw.submit(TopoRequest(uid=i, problem=p,
                                      n_iter=400 if i < 2 else 4))
                for i, p in enumerate(probs)]
        assert wait_until(
            lambda: gw.engines.get((12, 4)) is not None, timeout=120)
        proxy = gw.engines[(12, 4)]
        assert isinstance(proxy, RemoteEngine)

        def _admitted(uid):
            with proxy._sched.cond:
                ent = proxy._pending.get(uid)
                return ent is not None and ent[2]
        assert wait_until(lambda: _admitted(0) and _admitted(1),
                          timeout=120)
        victim = gw._pool.live_workers()[0]
        os.kill(victim.proc.pid, signal.SIGKILL)

        results = {}
        for i, f in enumerate(futs):
            try:
                results[i] = f.result(timeout=120)
            except WorkerLost as exc:
                results[i] = exc
        for i in (0, 1):
            assert isinstance(results[i], WorkerLost)
            assert results[i].worker_id == victim.worker_id
        for i in (2, 3):
            assert not isinstance(results[i], BaseException)
            assert results[i].done and results[i].density is not None
            assert results[i].worker_id not in (None, victim.worker_id)
        kinds = [e.kind for e in gw.fleet_events()]
        for k in ("worker-spawn", "worker-lost", "worker-reassign",
                  "worker-requeue"):
            assert k in kinds, f"missing {k} in {kinds}"
        assert gw._pool.stats()["restarts"] >= 1
        assert gw.metrics.counter("topo_worker_restarts_total").total() >= 1
    finally:
        gw.shutdown()
    assert not victim.proc.is_alive()


def test_worker_interleaving_sweep_no_drops_no_mistags(params, tmp_path):
    """Random rounds of traffic and worker kills through a
    registry-backed two-worker gateway on two meshes. After every round
    every future resolved with a density or a typed ``WorkerLost``;
    completions carry the tag they were routed under and a worker id.
    After shutdown: leases balance to zero, no worker is left."""
    reg = ModelRegistry(str(tmp_path))
    reg.register(params, CFG, U_SCALE, tag="prod")
    gw = TopoGateway.from_registry(
        reg, tag="prod", slots=2, max_pending=64, workers=2, device="cpu",
        worker_pool_kwargs={"heartbeat_s": 0.5})
    rng = random.Random(20260808)
    probs = _problems(3) + _problems(3, *MESHES[1])
    uid = 0
    try:
        for rnd in range(3):
            futs = []
            for _ in range(rng.randint(3, 6)):
                futs.append(gw.submit(TopoRequest(
                    uid=uid, problem=probs[uid % len(probs)],
                    n_iter=rng.randint(3, 8),
                    deadline_s=600.0 if rng.random() < 0.5 else None,
                    priority=rng.randint(0, 2))))
                uid += 1
            if rnd == 1:
                victim = rng.choice(gw._pool.live_workers())
                os.kill(victim.proc.pid, signal.SIGKILL)
            completed = lost = 0
            for f in futs:
                try:
                    r = f.result(timeout=120)
                    assert r.density is not None
                    assert r.model_tag == r.routed_tag == "prod"
                    assert r.worker_id is not None
                    completed += 1
                except WorkerLost:
                    lost += 1
            assert completed + lost == len(futs)
        assert gw._pool.stats()["restarts"] >= 1
        pool = gw._pool
    finally:
        gw.shutdown()
    assert reg.leased() == {}
    assert pool.live_workers() == []


@pytest.mark.parametrize("source", ["registry", "explicit"])
def test_worker_serves_bitwise_equal_to_in_process_engine(
        source, params, tmp_path):
    """Two meshes through one worker: by registry reference (the spec
    carries ``registry_root``, the worker reads the checkpoint) or by
    explicit params (the tree crosses by value). The worker's build
    reply shows the tree it built from bit for bit; every density and
    iteration count equals a dedicated in-process engine's."""
    if source == "registry":
        reg = ModelRegistry(str(tmp_path))
        reg.register(params, CFG, U_SCALE, tag="v1")
        gw = TopoGateway.from_registry(reg, "v1", slots=2, workers=1,
                                       device="cpu",
                                       error_threshold=THRESHOLD)
    else:
        gw = TopoGateway(CFG, params, U_SCALE, slots=2, workers=1,
                         device="cpu", error_threshold=THRESHOLD)
    per_mesh = {m: _problems(3, *m) for m in MESHES}
    try:
        futs = [gw.submit(TopoRequest(uid=10 * k + i, problem=p, n_iter=5))
                for k, m in enumerate(MESHES)
                for i, p in enumerate(per_mesh[m])]
        done = [f.result(timeout=120) for f in futs]
        infos = {m: (gw.engines[m].spec, gw.engines[m].build_info)
                 for m in MESHES}
        counts = gw._pool.launch_counts()
        stats = gw.throughput_stats(per_mesh=True)
    finally:
        gw.shutdown()
    # the worker left on its own at shutdown, not by the pool's kill
    assert [e.details["exitcode"]
            for e in gw.fleet_events("worker-exit")] == [0]
    for spec, info in infos.values():
        assert ("registry_root" in spec) == (source == "registry")
        assert ("params" in spec) == (source == "explicit")
        assert info["params_digest"] == params_digest(params)
        assert info["params_devices"] == ["cpu"]
        assert info["pid"] != os.getpid()
    # on the CPU the wrappers run their plain versions: nothing launches
    assert list(counts) == [0] and not any(counts[0].values())
    assert {st["device"] for st in stats["per_mesh"].values()} == {"cpu"}
    assert sum(r.cronet_iters for r in done) > 0
    for m in MESHES:
        mine = [r for r in done if r.mesh == m]
        for r, ref in zip(mine, _dedicated(params, m, mine)):
            assert r.worker_id == 0
            assert r.model_tag == ("v1" if source == "registry" else None)
            np.testing.assert_array_equal(r.density, ref.density,
                                          err_msg=f"uid {r.uid}")
            assert (r.cronet_iters, r.fea_iters, r.cg_iters) == (
                ref.cronet_iters, ref.fea_iters, ref.cg_iters)


def test_failed_worker_build_reaches_the_caller(params):
    """A worker that cannot build its engine fails the build call; the
    bucket's futures fail with the worker's own error and no engine is
    built in-process in its place."""
    gw = TopoGateway(CFG, params, U_SCALE, slots=2, workers=1,
                     device="cpu", backend="pallas")
    try:
        futs = [gw.submit(TopoRequest(uid=i, problem=p, n_iter=3))
                for i, p in enumerate(_problems(2))]
        for f in futs:
            with pytest.raises(TypeError, match="backend"):
                f.result(timeout=120)
        assert gw.engines == {}
        assert gw._pool.stats()["workers"] == 1     # the worker lives on
    finally:
        gw.shutdown()
    with pytest.raises(ValueError, match="engine_factory"):
        TopoGateway(CFG, params, U_SCALE, device="cpu", workers=1,
                    engine_factory=lambda nx, ny: None)


def test_a_starting_worker_is_not_pinged_to_death():
    """A worker still importing torch does not read its pipe, so a ping
    in that window can only time out. The heartbeat waits for the
    worker's ``ready`` frame: with a ping timeout far below the start
    time, the worker is neither killed nor respawned, and answers once
    it has started."""
    events = []
    pool = WorkerPool(1, heartbeat_s=0.05, heartbeat_timeout_s=0.3,
                      metrics=MetricsRegistry(),
                      events=lambda kind, **kw: events.append(kind))
    try:
        handle = pool.live_workers()[0]
        assert wait_until(handle.ready.is_set, timeout=120), events
        t_ready = time.monotonic() - handle.spawned_t
        assert handle.call("ping", timeout=30)["pid"] == handle.proc.pid
        time.sleep(0.5)                 # ten heartbeats after the start
        # the first ping went out at 0.05 s and would have timed out
        assert t_ready > 0.35
        assert pool.stats()["restarts"] == 0, events
        assert pool.worker_ids == [handle.worker_id]
        assert "worker-stale" not in events, events
        assert events.count("worker-ready") == 1, events
    finally:
        pool.shutdown()


# ---------------------------------------- beside the JAX gateway itself


# tests/test_torch_gateway.py's bar for this mix: over these 5 iterations
# (two of them FEA ticks) the densities part by at most 3.5e-4 on the CPU
# (the CG stop points differ between the frameworks)
DENSITY_ATOL = 2e-3


def test_workers_gateway_matches_jax_gateway_on_one_registry_version(
        tmp_path):
    """JAX registers a version; the JAX gateway serves it in-process and
    the port's ``workers=1`` gateway through a worker, from the one
    registry on two meshes. Per request the CRONet and FEA iteration
    counts are exact and the densities agree within ``DENSITY_ATOL``."""
    import jax

    import repro.serve as jserve
    from repro.common import materialize
    from repro.configs.cronet import get_cronet_config as jget
    from repro.core import cronet as jcronet
    from repro.fea import fea2d as jfea

    jcfg = dataclasses.replace(jget("small"), nelx=12, nely=4, hist_len=3)
    jparams = jax.device_get(materialize(jcronet.param_specs(
        dataclasses.replace(jcfg, dtype="float32")), jax.random.key(0)))
    jserve.ModelRegistry(str(tmp_path)).register(jparams, jcfg, U_SCALE,
                                                 tag="v1")
    n = {(12, 4): 3, (10, 6): 2}
    spec = [(m, i) for m in MESHES for i in range(n[m])]

    def probs(m, fea):
        return [fea.point_load_problem(*m, load_node=(i % (m[0] - 1), 0),
                                       load=(0.0, -1.0 - 0.1 * i))
                for i in range(n[m])]

    jgw = jserve.TopoGateway.from_registry(
        jserve.ModelRegistry(str(tmp_path)), "v1", slots=2,
        error_threshold=THRESHOLD)
    jdone = [f.result(timeout=600) for f in [
        jgw.submit(jserve.TopoRequest(uid=k, problem=probs(m, jfea)[i],
                                      n_iter=5))
        for k, (m, i) in enumerate(spec)]]
    jgw.shutdown()
    tgw = TopoGateway.from_registry(ModelRegistry(str(tmp_path)), "v1",
                                    slots=2, device="cpu", workers=1,
                                    error_threshold=THRESHOLD)
    try:
        tdone = [f.result(timeout=120) for f in [
            tgw.submit(TopoRequest(uid=k, problem=probs(m, fea2d)[i],
                                   n_iter=5))
            for k, (m, i) in enumerate(spec)]]
    finally:
        tgw.shutdown()
    assert sum(t.cronet_iters for t in tdone) > 0
    for j, t in zip(jdone, tdone):
        assert t.worker_id == 0 and j.worker_id is None
        assert t.mesh == j.mesh and t.model_tag == j.model_tag == "v1"
        assert (t.cronet_iters, t.fea_iters) == (j.cronet_iters,
                                                 j.fea_iters)
        np.testing.assert_allclose(t.density, np.asarray(j.density),
                                   rtol=0, atol=DENSITY_ATOL)


# ------------------------------------------------------------- the card


@pytest.mark.cuda
def test_card_params_cross_bitwise_onto_the_spec_device():
    """Unregistered card params travel by value (a CUDA tensor pickles
    through host bytes and is restored on its device index): the worker's
    tree is the parent's bit for bit, on the spec's device, and its
    serving launches both kernels there and equals an in-process engine's
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", torch.cuda.current_device())
    cparams = init_params(CFG, seed=0, device=dev, dtype="float32")
    gw = TopoGateway(CFG, cparams, U_SCALE, slots=2, workers=1, device=dev,
                     error_threshold=THRESHOLD)
    try:
        done = [f.result(timeout=600) for f in [
            gw.submit(TopoRequest(uid=i, problem=p, n_iter=6))
            for i, p in enumerate(_problems(2))]]
        proxy = gw.engines[(12, 4)]
        counts = gw._pool.launch_counts()
    finally:
        gw.shutdown()
    assert "params" in proxy.spec
    assert proxy.spec["engine_kwargs"]["device"] == dev
    assert proxy.build_info["params_digest"] == params_digest(cparams)
    assert proxy.build_info["params_devices"] == [str(dev)]
    assert counts[0]["cronet_fused"] > 0 and counts[0]["solve_b_fused"] > 0
    eng = TopoServingEngine(CFG, cparams, U_SCALE, slots=2,
                            error_threshold=THRESHOLD, device=dev)
    refs = eng.run([TopoRequest(uid=r.uid, problem=r.problem, n_iter=6)
                    for r in done])
    eng.shutdown()
    for r, ref in zip(done, refs):
        np.testing.assert_array_equal(r.density, ref.density)
