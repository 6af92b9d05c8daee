"""The port's gateway (repro_torch/serve/gateway.py) against the
reference's (repro/serve/gateway.py).

Three layers, as in tests/test_gateway.py:
  * the reference's fake-engine mechanics, run against BOTH packages'
    gateways under one scripted submit/complete sequence each: the same
    forwarding order, shed and reject decisions, fleet-event kinds and
    tags stamped on completions (depth gating, cross-mesh EDF order, the
    three overload policies, lifecycle, canary / promote / rollback /
    auto-rollback, eviction / rebuild, autoscale widths), plus the
    random-interleaving invariants on each;
  * real port engines on the CPU at 12x4 and 10x6: every density bitwise
    equal to a dedicated single-mesh port engine's, also through
    evict-then-rebuild and canary-promote, registry resolution included;
  * the port's gateway beside the JAX gateway serving the same registry
    version: per-request iteration counts exact, densities within a
    stated tolerance (never whole-trajectory equality), and the exporters
    and dashboard over the metrics the gateway fills.
"""
import collections
import dataclasses
import random
import threading
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import repro.obs as jobs
import repro.serve as jserve
import repro_torch.obs as tobs
import repro_torch.serve as tserve
from repro.common import materialize
from repro.configs.cronet import get_cronet_config as jget_cronet_config
from repro.core import cronet as jcronet
from repro.fea import fea2d as jfea
from repro_torch.common import params_from_jax
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.fea import fea2d
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import (ModelRegistry, TopoGateway, TopoRequest,
                               TopoServingEngine)

U_SCALE = 50.0
PKGS = {"jax": jserve, "torch": tserve}


def wait_until(cond, timeout=10.0, interval=0.005):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > timeout:
            return False
        time.sleep(interval)
    return True


# ------------------------------------------------------------ fake engine


class _FakeEngine:
    """The reference test's in-memory stand-in (tests/test_gateway.py):
    requests park in ``submitted`` until the script calls ``complete()``;
    completions carry the fake's ``model_tag`` and ``cronet_frac`` of
    their iterations on the NN path. ``closed_exc`` is the package's own
    ``EngineClosed``."""

    def __init__(self, nelx, nely, closed_exc, model_tag=None,
                 cronet_frac=0.0):
        self.cfg = SimpleNamespace(nelx=nelx, nely=nely)
        self._closed_exc = closed_exc
        self._failure = None
        self.inflight = 0
        self.preemptions = 0
        self.total_steps = 0
        self.slots = 2
        self.model_tag = model_tag
        self.cronet_frac = cronet_frac
        self._sched = SimpleNamespace(cond=threading.Condition())
        self._completed = []
        self.submitted = []          # (req, fut), forwarding order
        self.forwarded = []          # every uid ever forwarded, in order
        self._closed = False
        self._stopped = False
        self._lock = threading.Lock()

    def submit(self, req, deadline_s=None, priority=0, _future=None):
        with self._lock:
            if self._failure is not None:   # mirrors the real engine
                raise RuntimeError("engine failed") from self._failure
            if self._closed:
                raise self._closed_exc("fake engine closed")
            self.inflight += 1
            self.submitted.append((req, _future))
            self.forwarded.append(req.uid)
        return _future

    def complete(self):
        with self._lock:
            req, fut = self.submitted.pop(0)
            req.done = True
            req.model_tag = self.model_tag
            req.cronet_iters = int(round(self.cronet_frac * req.n_iter))
            req.fea_iters = req.n_iter - req.cronet_iters
            req.deadline_met = (None if req.deadline is None
                                else time.monotonic() <= req.deadline)
            self._completed.append(req)
            self.inflight -= 1
            self.total_steps += req.n_iter
        fut._resolve()
        return req

    def drain(self, timeout=None):
        t0 = time.time()
        while self.inflight:
            if timeout is not None and time.time() - t0 > timeout:
                return False
            time.sleep(0.002)
        return True

    def swap_params(self, params, u_scale=None, model_tag=None):
        self.model_tag = model_tag
        if isinstance(params, dict) and "cronet_frac" in params:
            self.cronet_frac = params["cronet_frac"]

    def throughput_stats(self, requests=None, wall_s=None):
        return {"requests": float(len(self._completed))}

    def shutdown(self, wait=True):
        self._closed = True

    def stop(self, wait=True):
        self._stopped = True


def _fake_gateway(m, fleet=False, tag=None, frac=0.0, **kw):
    """Fake-engine gateway of package ``m``; ``built`` keeps every engine
    ever built per mesh (canary and rebuild paths build more than one)."""
    built = collections.defaultdict(list)

    def factory(nelx, nely):
        e = _FakeEngine(nelx, nely, m.EngineClosed,
                        model_tag=("prod" if fleet else tag),
                        cronet_frac=(0.5 if fleet else frac))
        built[(nelx, nely)].append(e)
        return e

    if m is tserve:
        kw["device"] = "cpu"
    gw = m.TopoGateway(SimpleNamespace(nelx=0, nely=0), params=None,
                       u_scale=U_SCALE, engine_factory=factory, **kw)
    return gw, built


def _eng(built, mesh):
    return built[mesh][-1]


def _req(m, uid, nelx=12, nely=4, n_iter=5):
    return m.TopoRequest(uid=uid, problem=SimpleNamespace(nelx=nelx,
                                                          nely=nely),
                         n_iter=n_iter)


def _complete_all(built, mesh=None):
    for mm, engs in list(built.items()):
        if mesh is not None and mm != mesh:
            continue
        for e in engs:
            while e.submitted:
                e.complete()


def _pump(gw, built, timeout=10):
    t0 = time.time()
    while not gw.drain(timeout=0.05):
        assert time.time() - t0 < timeout, "gateway did not drain"
        _complete_all(built)


def _forwarded(built):
    return {f"{k[0]}x{k[1]}": [e.forwarded for e in v]
            for k, v in sorted(built.items())}


def _tags(futs):
    out = []
    for f in futs:
        r = f.result(timeout=10)
        assert r.model_tag == r.routed_tag
        out.append((r.uid, r.model_tag))
    return out


def _kinds(gw):
    return [(e.kind, e.mesh, e.tag) for e in gw.fleet_events()]


# --------------------------------- scripted scenarios, one per mechanism
#
# Each returns a transcript of what the script observed; the test runs it
# on both packages and requires equal transcripts.


def scn_lazy_instantiation(m):
    gw, built = _fake_gateway(m, max_pending=None)
    assert gw.state is m.EngineState.NEW and not gw.engines
    gw.submit(_req(m, 0, 12, 4))
    assert wait_until(lambda: (12, 4) in built)
    assert (10, 6) not in built
    gw.submit(_req(m, 1, 10, 6))
    gw.submit(_req(m, 2, 12, 4))
    assert wait_until(lambda: (10, 6) in built
                      and len(_eng(built, (12, 4)).submitted) == 2)
    state = gw.state.name
    _pump(gw, built)
    gw.shutdown()
    assert all(e._closed for v in built.values() for e in v)
    return {"forwarded": _forwarded(built), "state": state,
            "engines": len(gw.engines)}


def scn_depth_gating(m):
    gw, built = _fake_gateway(m, max_pending=None, engine_depth=2)
    futs = [gw.submit(_req(m, k, 12, 4), deadline_s=10.0 + k)
            for k in range(5)]
    assert wait_until(lambda: (12, 4) in built
                      and len(_eng(built, (12, 4)).submitted) == 2)
    time.sleep(0.1)   # the dispatcher must NOT forward past the depth
    held = (_eng(built, (12, 4)).inflight, gw.inflight)
    gw.submit(_req(m, 9, 10, 6), deadline_s=999.0)   # not HOL-blocked
    assert wait_until(lambda: (10, 6) in built
                      and len(_eng(built, (10, 6)).submitted) == 1)
    _eng(built, (12, 4)).complete()
    assert wait_until(lambda: len(_eng(built, (12, 4)).submitted) == 2)
    after = [r.uid for r, _ in _eng(built, (12, 4)).submitted]
    _pump(gw, built)
    assert all(f.result(timeout=10).done for f in futs)
    gw.shutdown()
    return {"held": held, "after_one": after, "forwarded": _forwarded(built)}


def scn_cross_mesh_edf(m):
    gw, built = _fake_gateway(m, max_pending=None, engine_depth=1)
    gw.submit(_req(m, 100, 12, 4), priority=5)
    gw.submit(_req(m, 101, 10, 6), priority=5)
    assert wait_until(lambda: len(built) == 2 and all(
        _eng(built, k).inflight == 1 for k in built))
    plan = [(0, (12, 4), 30.0), (1, (10, 6), 10.0), (2, (12, 4), 5.0),
            (3, (10, 6), 40.0), (4, (12, 4), 20.0)]
    for uid, mesh, dl in plan:
        gw.submit(_req(m, uid, *mesh), deadline_s=dl)
    time.sleep(0.1)
    for k in list(built):
        _eng(built, k).complete()
    n = 0
    while n < len(plan):
        assert wait_until(lambda: any(_eng(built, k).submitted
                                      for k in built))
        for k in list(built):
            e = _eng(built, k)
            while e.submitted:
                e.complete()
                n += 1
    assert gw.drain(timeout=10)
    gw.shutdown()
    fw = _forwarded(built)
    assert fw == {"12x4": [[100, 2, 4, 0]], "10x6": [[101, 1, 3]]}
    return {"forwarded": fw}


def scn_priority(m):
    gw, built = _fake_gateway(m, max_pending=None, engine_depth=1)
    gw.submit(_req(m, 100, 12, 4), priority=9)
    assert wait_until(lambda: (12, 4) in built
                      and _eng(built, (12, 4)).inflight == 1)
    gw.submit(_req(m, 0, 12, 4), deadline_s=1.0)
    gw.submit(_req(m, 1, 12, 4), deadline_s=500.0, priority=3)
    time.sleep(0.05)
    e = _eng(built, (12, 4))
    e.complete()
    assert wait_until(lambda: len(e.submitted) == 1)
    prio = e.submitted[0][0].priority
    _pump(gw, built)
    gw.shutdown()
    assert e.forwarded == [100, 1, 0] and prio == 3
    return {"forwarded": _forwarded(built), "priority": prio}


def _saturated(m, policy, max_pending=2, **kw):
    gw, built = _fake_gateway(m, max_pending=max_pending, overload=policy,
                              engine_depth=1, **kw)
    gw.submit(_req(m, 100, 12, 4), priority=9)
    assert wait_until(lambda: (12, 4) in built
                      and _eng(built, (12, 4)).inflight == 1)
    return gw, built, _eng(built, (12, 4))


def scn_reject_policy(m):
    gw, built, eng = _saturated(m, m.OverloadPolicy.REJECT)
    f1 = gw.submit(_req(m, 0, 12, 4), deadline_s=5.0)
    f2 = gw.submit(_req(m, 1, 12, 4), deadline_s=6.0)
    rejected = []
    try:
        gw.submit(_req(m, 2, 12, 4), deadline_s=1.0)
    except m.QueueFull:
        rejected.append(2)
    stats = gw.throughput_stats()
    _pump(gw, built)
    assert f1.result(timeout=10).done and f2.result(timeout=10).done
    gw.shutdown()
    return {"rejected": rejected, "stat": stats["rejected"],
            "forwarded": _forwarded(built)}


def scn_shed_policy(m):
    gw, built, eng = _saturated(m, "shed-latest-deadline")
    f_keep = gw.submit(_req(m, 0, 12, 4), deadline_s=5.0)
    f_shed = gw.submit(_req(m, 1, 12, 4), deadline_s=600.0)
    f_self = gw.submit(_req(m, 2, 12, 4), deadline_s=900.0)
    self_shed_at_once = f_self.done()
    f_tight = gw.submit(_req(m, 3, 12, 4), deadline_s=2.0)
    assert wait_until(f_shed.done, timeout=5)
    shed = sorted(f.request.uid for f in (f_keep, f_shed, f_self, f_tight)
                  if f.done() and isinstance(f.exception(), m.RequestShed))
    stat = gw.throughput_stats()["shed"]
    _pump(gw, built)
    assert f_keep.result(timeout=10).done and f_tight.result(timeout=10).done
    gw.shutdown()
    assert shed == [1, 2] and self_shed_at_once
    return {"shed": shed, "stat": stat, "forwarded": _forwarded(built)}


def scn_block_policy(m):
    gw, built, eng = _saturated(m, "block", max_pending=1)
    gw.submit(_req(m, 0, 12, 4), deadline_s=5.0)
    admitted = []
    t = threading.Thread(target=lambda: admitted.append(
        gw.submit(_req(m, 1, 12, 4), deadline_s=6.0)))
    t.start()
    time.sleep(0.15)
    waited = not admitted
    eng.complete()
    t.join(timeout=10)
    _pump(gw, built)
    gw.shutdown()
    return {"waited": waited, "admitted": len(admitted),
            "forwarded": _forwarded(built)}


def scn_block_timeout(m):
    gw, built, eng = _saturated(m, "block", max_pending=1,
                                block_timeout=0.1)
    gw.submit(_req(m, 0, 12, 4), deadline_s=5.0)
    rejected = []
    try:
        gw.submit(_req(m, 1, 12, 4), deadline_s=6.0)
    except m.QueueFull:
        rejected.append(1)
    _pump(gw, built)
    gw.shutdown()
    return {"rejected": rejected, "forwarded": _forwarded(built)}


def scn_failed_engine(m):
    gw, built, eng = _saturated(m, "block", max_pending=8)
    f1 = gw.submit(_req(m, 0, 12, 4), deadline_s=5.0)
    f2 = gw.submit(_req(m, 1, 12, 4), deadline_s=6.0)
    boom = RuntimeError("device exploded")
    eng._failure = boom
    causes = []
    for f in (f1, f2):
        with pytest.raises(RuntimeError):
            f.result(timeout=10)
        causes.append(f.exception().__cause__ is boom)
    eng.submitted.pop(0)[1]._resolve(boom)
    assert gw.drain(timeout=10)
    state = gw.state.name
    gw.shutdown()
    return {"causes": causes, "state": state, "forwarded": _forwarded(built)}


def scn_malformed_problem(m):
    gw, built = _fake_gateway(m, max_pending=4)
    ok = gw.submit(_req(m, 0, 12, 4))
    errors = []
    for bad in (m.TopoRequest(uid=1, problem=object(), n_iter=3),
                _req(m, 2, 0, 4)):
        with pytest.raises(ValueError, match="nelx/nely"):
            gw.submit(bad)
        errors.append(bad.uid)
    _pump(gw, built)
    assert ok.result(timeout=10).done
    state = gw.state.name
    gw.shutdown()
    return {"errors": errors, "state": state, "forwarded": _forwarded(built)}


def scn_lifecycle(m):
    gw, built = _fake_gateway(m, max_pending=4)
    states = [gw.state.name]
    fut = gw.submit(_req(m, 0, 12, 4))
    states.append(gw.state.name)
    _pump(gw, built)
    assert fut.result(timeout=10).done
    gw.shutdown()
    states.append(gw.state.name)
    raised = []
    for call in (lambda: gw.submit(_req(m, 1, 12, 4)), gw.start):
        try:
            call()
        except m.EngineClosed:
            raised.append("EngineClosed")
    gw.shutdown()    # idempotent
    return {"states": states, "raised": raised,
            "closed": all(e._closed for v in built.values() for e in v)}


def scn_shutdown_wakes_blocked(m):
    gw, built, eng = _saturated(m, "block", max_pending=1)
    gw.submit(_req(m, 0, 12, 4), deadline_s=5.0)
    errors = []

    def submitter():
        try:
            gw.submit(_req(m, 1, 12, 4), deadline_s=6.0)
        except m.EngineClosed as e:
            errors.append(type(e).__name__)

    t = threading.Thread(target=submitter)
    t.start()
    time.sleep(0.1)
    st_ = threading.Thread(target=gw.shutdown)
    st_.start()
    t.join(timeout=10)
    woken = not t.is_alive()
    eng.complete()
    assert wait_until(lambda: eng.submitted)
    eng.complete()
    st_.join(timeout=10)
    return {"woken": woken, "errors": errors, "state": gw.state.name,
            "forwarded": _forwarded(built)}


def scn_canary_promote(m):
    gw, built = _fake_gateway(m, fleet=True, max_pending=None)
    futs = [gw.submit(_req(m, i, 12, 4)) for i in range(2)]
    _pump(gw, built)
    gw.canary("cand", fraction=0.25, mesh=(12, 4), params=object(),
              auto_rollback=False)
    futs += [gw.submit(_req(m, 10 + i, 12, 4)) for i in range(8)]
    _pump(gw, built)
    info = gw.canary_stats((12, 4))
    routed = (info["routed_canary"], info["routed_primary"])
    assert gw.promote(mesh=(12, 4), timeout=10) == ["cand"]
    primary, canary = built[(12, 4)]
    post = gw.submit(_req(m, 99, 12, 4))
    _pump(gw, built)
    futs.append(post)
    out = {"routed": routed, "tags": _tags(futs),
           "forwarded": _forwarded(built), "events": _kinds(gw),
           "promotions": gw.throughput_stats()["promotions"],
           "swapped": (primary.model_tag, canary._closed)}
    gw.shutdown()
    assert routed == (2, 6) and out["swapped"] == ("cand", True)
    return out


def scn_canary_pair_depth(m):
    gw, built = _fake_gateway(m, fleet=True, max_pending=None,
                              engine_depth=2)
    gw.submit(_req(m, 0, 12, 4))
    _pump(gw, built)
    gw.canary("cand", fraction=0.5, mesh=(12, 4), params=object(),
              auto_rollback=False)
    futs = [gw.submit(_req(m, 1 + i, 12, 4)) for i in range(6)]
    assert wait_until(
        lambda: sum(e.inflight for e in built[(12, 4)]) == 2)
    time.sleep(0.1)   # no forwarding past the SHARED limit
    held = sum(e.inflight for e in built[(12, 4)])
    _pump(gw, built)
    info = gw.canary_stats((12, 4))
    out = {"held": held, "tags": _tags(futs), "forwarded": _forwarded(built),
           "routed": (info["routed_canary"], info["routed_primary"])}
    gw.shutdown()
    assert held == 2 and out["routed"] == (3, 3)
    return out


def scn_manual_rollback(m):
    gw, built = _fake_gateway(m, fleet=True, max_pending=None)
    gw.submit(_req(m, 0, 12, 4))
    _pump(gw, built)
    gw.canary("cand", fraction=1.0, mesh=(12, 4), params=object(),
              auto_rollback=False)
    futs = [gw.submit(_req(m, 1 + i, 12, 4)) for i in range(3)]
    _pump(gw, built)
    assert gw.rollback(mesh=(12, 4), timeout=10) == ["cand"]
    post = gw.submit(_req(m, 50, 12, 4))
    _pump(gw, built)
    stats = gw.throughput_stats()
    out = {"tags": _tags(futs + [post]), "forwarded": _forwarded(built),
           "events": _kinds(gw), "closed": built[(12, 4)][1]._closed,
           "stats": (stats["rollbacks"], stats["canaries"],
                     stats["requests"])}
    gw.shutdown()
    assert out["stats"] == (1.0, 0.0, 5.0)
    return out


def _auto_rollback(m, fleet, tag):
    gw, built = _fake_gateway(m, fleet=fleet, tag=tag, frac=0.5,
                              max_pending=None)
    gw.submit(_req(m, 0, 12, 4))
    _pump(gw, built)
    if not fleet:
        with pytest.raises(ValueError, match="canary needs a tag"):
            gw.canary(None, fraction=0.5, mesh=(12, 4), params=object())
    gw.canary("bad", fraction=0.5, mesh=(12, 4),
              params={"cronet_frac": 0.0}, min_requests=2, margin=0.0,
              auto_rollback=True)
    futs = [gw.submit(_req(m, 1 + i, 12, 4)) for i in range(8)]
    _pump(gw, built)
    assert wait_until(lambda: gw.throughput_stats()["rollbacks"] == 1.0)
    canary = built[(12, 4)][1]
    assert wait_until(lambda: canary._closed), "canary engine leaked"
    post = [gw.submit(_req(m, 100 + i, 12, 4)) for i in range(3)]
    _pump(gw, built)
    rb = [e for e in gw.fleet_events() if e.kind == "rollback"]
    out = {"tags": _tags(futs + post), "forwarded": _forwarded(built),
           "events": _kinds(gw), "reason": rb[0].reason.split(":")[0],
           "canaries": gw.throughput_stats()["canaries"]}
    gw.shutdown()
    assert out["reason"] == "CRONet hit rate regressed"
    return out


def scn_auto_rollback(m):
    return _auto_rollback(m, fleet=True, tag=None)


def scn_auto_rollback_tagless_primary(m):
    return _auto_rollback(m, fleet=False, tag=None)


def scn_canary_blocks_swap_and_evict(m):
    gw, built = _fake_gateway(m, fleet=True, max_pending=None)
    gw.submit(_req(m, 0, 12, 4))
    _pump(gw, built)
    gw.canary("cand", fraction=0.5, mesh=(12, 4), params=object(),
              auto_rollback=False)
    refused = []
    for name, call in (
            ("swap", lambda: gw.swap_model("x", params=object())),
            ("swap-mesh", lambda: gw.swap_model("x", params=object(),
                                                mesh=(12, 4))),
            ("evict", lambda: gw.evict_bucket((12, 4)))):
        with pytest.raises(RuntimeError, match="active canary"):
            call()
        refused.append(name)
    gw.rollback(mesh=(12, 4), timeout=10)
    swapped = gw.swap_model("x", params=object())
    out = {"refused": refused, "swapped": swapped, "events": _kinds(gw)}
    gw.shutdown()
    return out


def scn_idle_evict_rebuild(m):
    gw, built = _fake_gateway(m, fleet=True, max_pending=None,
                              idle_evict_s=0.2)
    cold = gw.submit(_req(m, 0, 12, 4))
    warm = gw.submit(_req(m, 1, 10, 6))
    _pump(gw, built)
    assert cold.result(timeout=5).done and warm.result(timeout=5).done
    t0 = time.time()
    while (12, 4) in gw.engines:
        assert time.time() - t0 < 10, "cold bucket never evicted"
        f = gw.submit(_req(m, 100, 10, 6))
        while not f.done():
            _complete_all(built)
            time.sleep(0.005)
        time.sleep(0.03)
    warm_alive = (10, 6) in gw.engines
    back = gw.submit(_req(m, 200, 12, 4))
    _pump(gw, built)
    stats = gw.throughput_stats()
    out = {"warm_alive": warm_alive, "first_closed": built[(12, 4)][0]._closed,
           "built_12x4": len(built[(12, 4)]), "back": _tags([back]),
           "events": [k for k in _kinds(gw) if k[1] == (12, 4)],
           "counts": (stats["evictions"], stats["rebuilds"])}
    gw.shutdown()
    assert out["counts"] == (1.0, 1.0) and out["built_12x4"] == 2
    return out


def scn_autoscale_widths(m):
    gw, built = _fake_gateway(m, max_pending=None, autoscale=True,
                              min_slots=2, max_slots=8, scale_rate=1.0)
    now = time.monotonic()
    widths = [gw._slots_for((12, 4))]
    gw._arrivals[(12, 4)] = collections.deque(
        [now - 1.0 + 0.1 * i for i in range(10)], maxlen=32)   # ~10 req/s
    gw._arrivals[(10, 6)] = collections.deque(
        [now - 8.0, now - 0.1], maxlen=32)                     # ~0.25 req/s
    widths += [gw._slots_for((12, 4)), gw._slots_for((10, 6))]
    decayed = (gw._observed_rate((12, 4), now=now + 60.0)
               < gw._observed_rate((12, 4)) / 10)
    gw.shutdown()
    assert widths == [2, 8, 2] and decayed
    return {"widths": widths, "decayed": decayed}


class _Sink:
    """A duck-typed harvest sink (``record`` and ``flush``), as the
    reference's ``HarvestLog`` is; ``fail_on`` makes one record raise."""

    def __init__(self, fail_on=None):
        self.records, self.flushes, self.fail_on = [], 0, fail_on

    def record(self, req):
        if req.uid == self.fail_on:
            raise ValueError("sink full")
        self.records.append(req.uid)

    def flush(self):
        self.flushes += 1


def scn_harvest_sink(m):
    sink = _Sink(fail_on=2)
    gw, built = _fake_gateway(m, fleet=True, max_pending=None, harvest=sink)
    futs = [gw.submit(_req(m, i, *mesh)) for i, mesh in
            enumerate([(12, 4), (10, 6), (12, 4), (10, 6)])]
    _pump(gw, built)
    tags = _tags(futs)        # a raising sink never drops a completion
    gw.shutdown()
    errors = [e for e in gw.fleet_events() if e.kind == "harvest-error"]
    assert sink.flushes >= 1 and len(errors) == 1
    return {"records": sorted(sink.records), "flushes": sink.flushes,
            "errors": [(e.mesh, e.tag) for e in errors], "tags": tags}


def scn_traces_and_bucket_stats(m):
    gw, built = _fake_gateway(m, fleet=True, max_pending=None,
                              trace_every=2, bucket_window=8)
    futs = [gw.submit(_req(m, i, 12, 4)) for i in range(4)]
    _pump(gw, built)
    traced = [f.request.uid for f in futs if gw.trace(f.request.uid)]
    tr = gw.trace(traced[0])
    # the gateway opens the queued span at its own front-door stamp
    spans = (tr.uid, tr._open[0], tr.submit_t == futs[1].request.submit_t)
    bstats = gw.bucket_stats((12, 4))
    out = {"traced": traced, "spans": spans,
           "bucket": (bstats["recent_completed"],
                      bstats["recent_cronet_hit_rate"]),
           "serving_tag": gw.serving_tag((12, 4)),
           "all_buckets": sorted(gw.bucket_stats())}
    gw.shutdown()
    assert traced == [1, 3] and spans == (1, "queued", True)
    return out


SCENARIOS = {name[4:]: fn for name, fn in sorted(globals().items())
             if name.startswith("scn_")}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_fake_engine_gateways_agree(name):
    """One scripted sequence against both packages' gateways (fake
    engines): the same transcript of forwarding order, shed / reject
    decisions, fleet-event kinds and completion tags."""
    got = {pkg: SCENARIOS[name](m) for pkg, m in PKGS.items()}
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
@settings(max_examples=5, deadline=None)
@given(st.integers(min_value=0, max_value=10**9))
def test_fleet_ops_random_interleavings_preserve_invariants(pkg, seed):
    """The reference's property test, on each package: random
    interleavings of submit / complete / canary / promote / rollback /
    evict drop no request, stamp every completion with the tag that
    served it, honour the canary fraction within one request, and keep
    completed-request accounting balanced across evictions."""
    m = PKGS[pkg]
    rng = random.Random(seed)
    gw, built = _fake_gateway(m, fleet=True, max_pending=None)
    meshes = [(12, 4), (10, 6), (8, 4)]
    futs, windows = [], []
    uid = 0

    def settle(op, timeout=10):
        t0 = time.time()
        while True:
            try:
                return op()
            except TimeoutError:
                assert time.time() - t0 < timeout
                _complete_all(built)

    for _ in range(30):
        op = rng.randrange(6)
        mesh = meshes[rng.randrange(len(meshes))]
        if op <= 2:
            futs.append(gw.submit(_req(m, uid, *mesh, n_iter=4),
                                  deadline_s=rng.choice([None, 30.0])))
            uid += 1
        elif op == 3:
            _complete_all(built, mesh if rng.random() < 0.5 else None)
        elif op == 4:
            if mesh not in gw._canaries:
                gw.canary(f"cand-{uid}",
                          fraction=rng.choice([0.25, 0.5, 1.0]),
                          mesh=mesh, params=object(), auto_rollback=False)
            else:
                windows.append(gw.canary_stats(mesh))
                end = gw.promote if rng.random() < 0.5 else gw.rollback
                settle(lambda: end(mesh=mesh, timeout=0.2))
        else:
            _complete_all(built, mesh)
            try:
                gw.evict_bucket(mesh, timeout=0.2)
            except (RuntimeError, TimeoutError):
                pass
    for mm in list(gw._canaries):
        windows.append(gw.canary_stats(mm))
        settle(lambda mm=mm: gw.rollback(mesh=mm, timeout=0.2))
    _pump(gw, built, timeout=15)
    assert all(f.done() and f.exception() is None for f in futs)
    done = [f.request for f in futs]
    assert all(r.done and r.model_tag == r.routed_tag for r in done)
    for w in windows:
        total = w["routed_canary"] + w["routed_primary"]
        assert abs(w["routed_canary"] - w["fraction"] * total) <= 1.0, w
    assert gw.throughput_stats()["requests"] == float(len(done))
    gw.shutdown()


# ------------------------------------------- real port engines on the CPU


CFG = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                          hist_len=3)
JCFG = dataclasses.replace(jget_cronet_config("small"), nelx=12, nely=4,
                           hist_len=3)
MESHES = [(12, 4), (10, 6)]
THRESHOLD = 1e9     # the surrogate's path and the forced FEA ticks both run


def _jparams(seed):
    return jax.device_get(materialize(jcronet.param_specs(
        dataclasses.replace(JCFG, dtype="float32")), jax.random.key(seed)))


@pytest.fixture(scope="module")
def jparams():
    return {s: _jparams(s) for s in (0, 1)}


@pytest.fixture(scope="module")
def tparams(jparams):
    return {s: params_from_jax(p, device="cpu") for s, p in jparams.items()}


def _mesh_problems(n, nelx, nely, fea=fea2d):
    return [fea.point_load_problem(nelx, nely, load_node=(i % (nelx - 1), 0),
                                   load=(0.0, -1.0 - 0.1 * i))
            for i in range(n)]


def _dedicated(params, mesh, reqs, slots=2):
    """The same requests on a dedicated single-mesh port engine."""
    eng = TopoServingEngine(
        dataclasses.replace(CFG, nelx=mesh[0], nely=mesh[1]), params,
        U_SCALE, slots=slots, error_threshold=THRESHOLD, device="cpu",
        metrics=MetricsRegistry())
    refs = eng.run([TopoRequest(uid=r.uid, problem=r.problem,
                                n_iter=r.n_iter) for r in reqs])
    eng.shutdown()
    return refs


def _assert_same(done, refs):
    for r, ref in zip(done, refs):
        np.testing.assert_array_equal(r.density, ref.density,
                                      err_msg=f"uid {r.uid}")
        assert (r.cronet_iters, r.fea_iters) == (ref.cronet_iters,
                                                 ref.fea_iters)


def test_gateway_serves_two_meshes_bitwise_equal_to_single_mesh_engines(
        tparams):
    per_mesh = {m: _mesh_problems(3, *m) for m in MESHES}
    gw = TopoGateway(CFG, tparams[0], U_SCALE, slots=2, max_pending=32,
                     device="cpu", error_threshold=THRESHOLD)
    futs = []
    for i in range(3):
        for m in MESHES:
            futs.append(gw.submit(TopoRequest(
                uid=len(futs), problem=per_mesh[m][i], n_iter=4 + i)))
    done = [f.result(timeout=300) for f in futs]
    stats = gw.throughput_stats(per_mesh=True)
    assert stats["engines"] == 2.0
    assert set(stats["per_mesh"]) == {"12x4", "10x6"}
    assert all(s["device"] == "cpu" for s in stats["per_mesh"].values())
    gw.shutdown()
    assert sum(r.cronet_iters for r in done) > 0
    for m in MESHES:
        mine = [r for r in done if r.mesh == m]
        _assert_same(mine, _dedicated(tparams[0], m, mine))


def test_evicted_bucket_rebuilds_bitwise_equal_to_dedicated_engine(tparams):
    probs = _mesh_problems(2, 12, 4)
    gw = TopoGateway(CFG, tparams[0], U_SCALE, slots=2, max_pending=32,
                     device="cpu", error_threshold=THRESHOLD)
    first = [f.result(timeout=300) for f in
             [gw.submit(TopoRequest(uid=i, problem=p, n_iter=5))
              for i, p in enumerate(probs)]]
    assert gw.drain(timeout=60)
    old = gw.engines[(12, 4)]
    assert gw.evict_bucket((12, 4), timeout=60)
    assert not gw.engines
    assert all(sh.state is None and sh.params is None for sh in old._shards)
    again = [f.result(timeout=300) for f in
             [gw.submit(TopoRequest(uid=10 + i, problem=p, n_iter=5))
              for i, p in enumerate(probs)]]
    stats = gw.throughput_stats()
    assert (stats["evictions"], stats["rebuilds"], stats["requests"]) == \
        (1.0, 1.0, 4.0)
    gw.shutdown()
    refs = _dedicated(tparams[0], (12, 4), first)
    _assert_same(first, refs)
    _assert_same(again, refs)


def test_canary_promote_with_real_engines_serves_bitwise(tmp_path, tparams):
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams[0], CFG, U_SCALE, tag="prod")
    reg.register(tparams[1], CFG, U_SCALE, tag="cand")
    gw = TopoGateway.from_registry(reg, "prod", slots=2, device="cpu",
                                   error_threshold=THRESHOLD)
    probs = _mesh_problems(4, 12, 4)
    gw.submit(TopoRequest(uid=-1, problem=probs[0], n_iter=2)).result(
        timeout=300)
    gw.canary("cand", fraction=0.5, mesh=(12, 4), auto_rollback=False)
    futs = [gw.submit(TopoRequest(uid=i, problem=p, n_iter=4))
            for i, p in enumerate(probs)]
    done = [f.result(timeout=300) for f in futs]
    assert {r.model_tag for r in done} == {"prod", "cand"}
    assert all(r.model_tag == r.routed_tag for r in done)
    info = gw.canary_stats((12, 4))
    assert (info["routed_canary"], info["routed_primary"]) == (2, 2)
    assert gw.promote(mesh=(12, 4), timeout=120) == ["cand"]
    assert reg.get("cand").promoted_at
    post = gw.submit(TopoRequest(uid=9, problem=probs[0], n_iter=4)).result(
        timeout=300)
    assert post.model_tag == "cand"
    gw.shutdown()
    assert reg.leased() == {}
    for tag, seed in (("prod", 0), ("cand", 1)):
        mine = [r for r in done if r.model_tag == tag]
        _assert_same(mine, _dedicated(tparams[seed], (12, 4), mine))
    _assert_same([post], _dedicated(tparams[1], (12, 4), [post]))


def test_swap_model_on_empty_pool_and_mesh_specialized_resolution(
        tmp_path, tparams):
    """A swap before any bucket exists applies on the first build; a
    mesh-specialized version wins for its bucket only; a per-bucket swap
    moves one bucket."""
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams[0], CFG, U_SCALE, tag="fleet")
    reg.register(tparams[1], CFG, U_SCALE, tag="spec", mesh=(10, 6))
    reg.register(tparams[1], CFG, U_SCALE, tag="fleet2")
    gw = TopoGateway.from_registry(reg, "fleet2", slots=2, device="cpu",
                                   error_threshold=THRESHOLD)
    assert gw.swap_model("fleet") == "fleet" and not gw.engines
    probs = {m: _mesh_problems(1, *m)[0] for m in MESHES}
    r1 = gw.submit(TopoRequest(uid=0, problem=probs[(12, 4)],
                               n_iter=4)).result(timeout=300)
    r2 = gw.submit(TopoRequest(uid=1, problem=probs[(10, 6)],
                               n_iter=4)).result(timeout=300)
    assert (r1.model_tag, r2.model_tag) == ("fleet", "spec")
    assert gw.throughput_stats()["bucket_tags"] == {"12x4": "fleet",
                                                    "10x6": "spec"}
    _assert_same([r1], _dedicated(tparams[0], (12, 4), [r1]))
    _assert_same([r2], _dedicated(tparams[1], (10, 6), [r2]))
    assert gw.swap_model("fleet2", mesh=(12, 4), timeout=60) == "fleet2"
    r3 = gw.submit(TopoRequest(uid=2, problem=probs[(12, 4)],
                               n_iter=4)).result(timeout=300)
    assert r3.model_tag == "fleet2" and gw.model_tag == "fleet"
    gw.shutdown()
    _assert_same([r3], _dedicated(tparams[1], (12, 4), [r3]))


def test_shape_classes_and_live_ladder_serve_bitwise(tparams):
    """Shape-class routing pads a 10x4 request onto the 12x4 class and
    crops it back; with a ladder and autoscale the bucket is built wide
    and resized live (``set_target_slots``, a ``resize`` event). Each
    density equals a dedicated engine's (shape-padded for the class)."""
    gw = TopoGateway(CFG, tparams[0], U_SCALE, slots=4, device="cpu",
                     error_threshold=THRESHOLD, shape_classes=["12x4"],
                     ladder=(2, 4), autoscale=True, min_slots=2,
                     max_slots=4)
    raw = fea2d.point_load_problem(10, 4, load_node=(3, 0))
    exact = _mesh_problems(1, 12, 4)[0]
    futs = [gw.submit(TopoRequest(uid=0, problem=raw, n_iter=5)),
            gw.submit(TopoRequest(uid=1, problem=exact, n_iter=5))]
    done = [f.result(timeout=300) for f in futs]
    assert gw.drain(timeout=60)
    assert wait_until(lambda: gw.fleet_events("resize"))
    assert list(gw.engines) == [(12, 4)]
    eng = gw.engines[(12, 4)]
    assert eng.shape_padded and eng.slots == 4 and eng.ladder == (2, 4)
    gw.shutdown()
    assert done[0].density.shape == (4, 10) and done[0].orig_mesh == (10, 4)
    ref_eng = TopoServingEngine(CFG, tparams[0], U_SCALE, slots=2,
                                shape_padded=True, device="cpu",
                                error_threshold=THRESHOLD,
                                metrics=MetricsRegistry())
    refs = ref_eng.run([
        TopoRequest(uid=0, problem=fea2d.pad_problem(raw, 12, 4), n_iter=5,
                    orig_mesh=(10, 4)),
        TopoRequest(uid=1, problem=exact, n_iter=5)])
    ref_eng.shutdown()
    _assert_same(done, refs)


def test_engine_hooks_the_gateway_uses_match_the_reference(jparams,
                                                           tparams):
    """The engine surface the gateway drives behaves as the JAX engine's:
    ``set_target_slots`` snaps to the same rungs, ``swap_params`` refuses
    a running engine, and ``submit(_future=...)`` keeps the caller's
    future and stamps."""
    engines = {
        "jax": jserve.TopoServingEngine(JCFG, jparams[0], U_SCALE, slots=4,
                                        ladder=(2, 4),
                                        error_threshold=THRESHOLD),
        "torch": TopoServingEngine(CFG, tparams[0], U_SCALE, slots=4,
                                   ladder=(2, 4), error_threshold=THRESHOLD,
                                   device="cpu", metrics=MetricsRegistry())}
    got = {}
    for pkg, eng in engines.items():
        m, fea = PKGS[pkg], (jfea if pkg == "jax" else fea2d)
        caps = [eng.set_target_slots(n) for n in range(0, 7)]
        req = m.TopoRequest(uid=0, problem=fea.point_load_problem(12, 4),
                            n_iter=3)
        req.submit_t, req.deadline = 123.0, None
        fut = m.TopoFuture(req)
        assert eng.submit(req, _future=fut) is fut
        with pytest.raises(RuntimeError, match="drain"):
            eng.swap_params(eng.params, model_tag="x")
        done = fut.result(timeout=300)
        eng.shutdown()
        got[pkg] = (caps, done.submit_t, done.model_tag, eng.inflight,
                    eng.total_steps > 0)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [2, 2, 2, 4, 4, 4, 4]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_failed_engine_fails_its_futures_and_never_hangs(tparams):
    """A real engine whose tick raises (a kernel that failed to build or
    launch does this on the card) fails its queued and in-flight futures
    with that error; nothing hangs and nothing falls back. (The tick
    thread re-raises after failing its waiters, as the reference's does.)"""
    gw = TopoGateway(CFG, tparams[0], U_SCALE, slots=2, device="cpu",
                     error_threshold=THRESHOLD)
    boom = RuntimeError("kernel launch failed")

    def factory_step(*a, **k):
        raise boom

    orig = gw._engine_factory

    def factory(nelx, nely):
        eng = orig(nelx, nely)
        eng.step = factory_step
        return eng

    gw._engine_factory = factory
    futs = [gw.submit(TopoRequest(uid=i, problem=p, n_iter=3))
            for i, p in enumerate(_mesh_problems(4, 12, 4))]
    for f in futs:
        with pytest.raises(RuntimeError):
            f.result(timeout=60)
        exc = f.exception()
        assert exc is boom or exc.__cause__ is boom
    assert gw.drain(timeout=10)
    gw.shutdown()


def test_gateway_needs_a_gpu_unless_asked_for_the_cpu_and_has_no_workers(
        tparams):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TopoGateway(CFG, tparams[0], U_SCALE)
    with pytest.raises(NotImplementedError, match="§A.4"):
        TopoGateway(CFG, tparams[0], U_SCALE, device="cpu", workers=2)
    gw = TopoGateway(CFG, tparams[0], U_SCALE, device="cpu")
    assert gw.device == torch.device("cpu")
    assert gw._engine_kwargs["device"] == torch.device("cpu")
    gw.shutdown()


# ---------------------------------------- beside the JAX gateway itself


# ROADMAP §C's bar for one forced-FEA tick; over these 5 iterations (two
# of them FEA ticks) the densities part by at most 3.5e-4 on the CPU
DENSITY_ATOL = 2e-3


def test_port_gateway_matches_jax_gateway_on_one_registry_version(
        tmp_path, jparams):
    """JAX registers a version; both gateways serve it from the one
    registry on two meshes at threshold 1e9. Per request, the CRONet and
    FEA iteration counts are exact; densities agree within
    ``DENSITY_ATOL`` (the CG stop points differ between the frameworks, so
    an FEA tick moves x by up to 2e-3), never bitwise."""
    jserve.ModelRegistry(str(tmp_path)).register(jparams[0], JCFG, U_SCALE,
                                                 tag="v1")
    n = {(12, 4): 3, (10, 6): 2}
    spec = [(m, i) for m in MESHES for i in range(n[m])]
    jgw = jserve.TopoGateway.from_registry(
        jserve.ModelRegistry(str(tmp_path)), "v1", slots=2,
        error_threshold=THRESHOLD)
    jfuts = [jgw.submit(jserve.TopoRequest(
        uid=k, problem=_mesh_problems(n[m], *m, fea=jfea)[i], n_iter=5))
        for k, (m, i) in enumerate(spec)]
    jdone = [f.result(timeout=600) for f in jfuts]
    jgw.shutdown()
    tgw = TopoGateway.from_registry(ModelRegistry(str(tmp_path)), "v1",
                                    slots=2, device="cpu",
                                    error_threshold=THRESHOLD)
    tfuts = [tgw.submit(TopoRequest(
        uid=k, problem=_mesh_problems(n[m], *m)[i], n_iter=5))
        for k, (m, i) in enumerate(spec)]
    tdone = [f.result(timeout=300) for f in tfuts]
    tgw.shutdown()
    assert sum(t.cronet_iters for t in tdone) > 0
    for j, t in zip(jdone, tdone):
        assert t.mesh == j.mesh and t.model_tag == j.model_tag == "v1"
        assert (t.cronet_iters, t.fea_iters) == (j.cronet_iters,
                                                 j.fea_iters)
        np.testing.assert_allclose(t.density, np.asarray(j.density),
                                   rtol=0, atol=DENSITY_ATOL)


def test_exporters_and_dashboard_read_the_port_gateway_metrics(tmp_path):
    """The ported TelemetrySnapshotter and dashboard over the metrics the
    port's gateway fills: the same fleet-event counts and instrument kinds
    as the reference's exporter over the JAX gateway's metrics, for one
    scripted canary / rollback sequence."""
    snaps = {}
    for pkg, m, obs in (("jax", jserve, jobs), ("torch", tserve, tobs)):
        old = obs.default_registry()
        reg = obs.MetricsRegistry()
        obs.set_default_registry(reg)
        try:
            gw, built = _fake_gateway(m, fleet=True, max_pending=None)
            gw.submit(_req(m, 0, 12, 4))
            _pump(gw, built)
            gw.canary("cand", fraction=1.0, mesh=(12, 4), params=object(),
                      auto_rollback=False)
            gw.submit(_req(m, 1, 12, 4))
            _pump(gw, built)
            gw.rollback(mesh=(12, 4), timeout=10)
            path = str(tmp_path / f"{pkg}.jsonl")
            snap = obs.TelemetrySnapshotter(path, registry=reg,
                                            extra=gw.throughput_stats)
            snap.snapshot_once()
            frame = obs.render(registry=reg, stats=gw.throughput_stats())
            gw.shutdown()
        finally:
            obs.set_default_registry(old)
        (rec,) = obs.read_snapshots(path)
        with open(snap.prom_path) as f:
            prom = f.read()
        assert "fleet_events_total" in frame and "topo_engines" in frame
        assert "# TYPE fleet_events_total counter" in prom
        snaps[pkg] = ({k: v["kind"] for k, v in rec["metrics"].items()},
                      rec["metrics"]["fleet_events_total"],
                      rec["extra"]["rollbacks"])
    assert snaps["torch"] == snaps["jax"]
