"""The port's serving-data flywheel (repro_torch.serve.flywheel) against
the reference's (repro.serve.flywheel), on the CPU.

The reference's tests (tests/test_flywheel.py), run on the port:
windowed ``TagStats``, ``LoadCase.from_problem``, ``HarvestLog``
cutoff / dedup / bounds / spooling, the registry's sweep keep-policy and
``RegistryRetention``, and the controller's state machine against the
port's fake-engine gateway (tests/test_torch_gateway.py) — promote,
rollback, sequential cycles after cooldown, too little harvest, a healthy
bucket, the daemon, random interleavings and the harvest flush on
shutdown. Beside the reference:
  * a spool written by either package is read by the other;
  * one scripted fake-traffic run of both packages' controllers gives
    the same transcript (events, cycle trails, completion tags);
  * a ``workers=1`` gateway harvests the same cases as the threaded one;
  * one cycle through the default harvest and fine-tune layers with
    real port engines, trigger to promotion: the canary's completions
    bitwise equal to a dedicated engine's with the child's weights, and
    the base weights untouched.
"""
import collections
import dataclasses
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st
from test_torch_gateway import _FakeEngine, wait_until

import repro.serve as jserve
import repro_torch.serve as tserve
from repro_torch.common import init_params
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.fea import dataset as td
from repro_torch.fea import fea2d
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import (FlywheelController, FlywheelState, HarvestLog,
                               ModelRegistry, RegistryRetention, TagStats,
                               TopoGateway, TopoRequest, TopoServingEngine)

U_SCALE = 50.0
CFG = CRONetConfig(nelx=12, nely=4, hist_len=3)
PKGS = {"jax": jserve, "torch": tserve}


def _sreq(cronet_iters, fea_iters, deadline=None, met=None):
    return SimpleNamespace(cronet_iters=cronet_iters, fea_iters=fea_iters,
                           deadline=deadline, deadline_met=met,
                           latency_s=0.01)


# ----------------------------------------------------- windowed TagStats


def test_tagstats_window_tracks_recent_traffic():
    ts = TagStats(window=3)
    for _ in range(4):
        ts.record(_sreq(0, 10))         # old, all-FEA traffic
    for _ in range(3):
        ts.record(_sreq(10, 0))         # recent, all-NN traffic
    assert ts.completed == 7
    assert ts.recent_completed == 3
    assert ts.cronet_hit_rate == pytest.approx(30 / 70)
    assert ts.recent_cronet_hit_rate == pytest.approx(1.0)
    snap = ts.snapshot()
    assert snap["recent_completed"] == 3
    assert snap["recent_cronet_hit_rate"] == pytest.approx(1.0)


def test_tagstats_unwindowed_recent_aliases_lifetime():
    ts = TagStats()
    ts.record(_sreq(3, 1, deadline=1.0, met=True))
    ts.record(_sreq(1, 3, deadline=1.0, met=False))
    assert ts.recent_completed == ts.completed == 2
    assert ts.recent_cronet_hit_rate == ts.cronet_hit_rate
    assert ts.recent_deadline_hit_rate == ts.deadline_hit_rate == 0.5


# ------------------------------------------------- LoadCase.from_problem


def test_loadcase_from_problem_roundtrip():
    case = td.LoadCase(load_frac=0.3, load=(0.25, -0.9), volfrac=0.42)
    back = td.LoadCase.from_problem(case.problem(12, 4))
    assert back.kind == "harvest"
    requant = dataclasses.replace(
        case, load_frac=case.load_node(12)[0] / 12)
    assert back.key() == dataclasses.replace(requant,
                                             kind="harvest").key()
    assert back.load == pytest.approx(case.load)
    assert back.volfrac == pytest.approx(case.volfrac)


# ------------------------------------------------------------ HarvestLog


def _hreq(uid, nelx=12, nely=4, n_iter=10, load_frac=None,
          cronet_iters=None, fea_iters=None, m=tserve):
    """A completed-request stand-in carrying a point-load vector the
    harvester can invert."""
    lf = load_frac if load_frac is not None else (uid % 7) / 10
    f = np.zeros(2 * (nelx + 1) * (nely + 1))
    node = min(int(round(lf * nelx)), nelx - 1) * (nely + 1)
    f[2 * node + 1] = -1.0
    prob = SimpleNamespace(nelx=nelx, nely=nely, f=f, volfrac=0.4)
    req = m.TopoRequest(uid=uid, problem=prob, n_iter=n_iter)
    if cronet_iters is not None:
        req.cronet_iters, req.fea_iters = cronet_iters, fea_iters
    return req


def test_harvest_log_cutoff_dedup_and_bounds():
    log = HarvestLog(capacity=3, accept_below=0.8)
    assert not log.record(_hreq(0, cronet_iters=9, fea_iters=1))
    assert not log.record(_hreq(1, cronet_iters=0, fea_iters=0))
    assert log.record(_hreq(2, load_frac=0.1, cronet_iters=1, fea_iters=9))
    assert log.record(_hreq(3, load_frac=0.1, cronet_iters=2, fea_iters=8))
    assert len(log.rejected_cases((12, 4))) == 1
    assert log.duplicates == 1
    for i, lf in enumerate((0.2, 0.3, 0.4, 0.5)):
        log.record(_hreq(10 + i, load_frac=lf, cronet_iters=0,
                         fea_iters=10))
    cases = log.rejected_cases((12, 4))
    assert len(cases) == 3
    assert [int(round(c.load_frac * 12)) for c in cases] == [4, 5, 6]
    assert log.snapshot()["buckets"] == {"12x4": 3}
    with pytest.raises(ValueError, match="accept_below"):
        HarvestLog(accept_below=0.0)


def test_harvest_log_spool_roundtrip_and_bounds(tmp_path):
    spool = str(tmp_path / "spool")
    log = HarvestLog(capacity=8, spool_dir=spool, spool_limit=3)
    for i, lf in enumerate((0.1, 0.2, 0.3, 0.4, 0.5)):
        log.record(_hreq(i, load_frac=lf, cronet_iters=0, fea_iters=10))
    log.flush()
    log2 = HarvestLog(capacity=8, spool_dir=spool, spool_limit=3)
    cases = log2.rejected_cases((12, 4))
    assert [int(round(c.load_frac * 12)) for c in cases] == [4, 5, 6]
    log2.record(_hreq(9, load_frac=0.4, cronet_iters=0, fea_iters=10))
    assert len(log2.rejected_cases((12, 4))) == 3
    log2.clear((12, 4))
    assert log2.rejected_cases((12, 4)) == []
    assert log.rejected_cases((12, 4), include_spool=False) != []


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_spool_crosses_between_the_packages(tmp_path, writer, reader):
    """The spool format is shared: a torn tail line is skipped by both,
    and the reader's merged view equals the writer's."""
    w = PKGS[writer].HarvestLog(capacity=8, spool_dir=str(tmp_path))
    for i, lf in enumerate((0.1, 0.3, 0.3, 0.6)):
        w.record(_hreq(i, load_frac=lf, cronet_iters=1, fea_iters=9,
                       m=PKGS[writer]))
    w.flush()
    with open(tmp_path / "harvest_12x4.jsonl", "a") as fh:
        fh.write('{"kind": "harvest", "load_fr')      # a torn write
    r = PKGS[reader].HarvestLog(capacity=8, spool_dir=str(tmp_path))
    got = [c.describe() for c in r.rejected_cases((12, 4))]
    assert got == [c.describe() for c in w.rejected_cases((12, 4))]
    assert len(got) == 3
    # the reader's flush rewrites the file in the same format
    r.record(_hreq(9, load_frac=0.8, cronet_iters=0, fea_iters=5,
                   m=PKGS[reader]))
    r.flush()
    again = PKGS[writer].HarvestLog(spool_dir=str(tmp_path))
    assert [c.describe() for c in again.rejected_cases((12, 4))] == \
        [c.describe() for c in r.rejected_cases((12, 4))]


# ------------------------------------------------- registry sweep policy


def test_registry_sweep_keep_policy(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    p = {"w": np.float32(1.0)}
    reg.register(p, CFG, U_SCALE, tag="base")
    for i in range(4):
        reg.register(p, CFG, U_SCALE, tag=f"base-ft{i}", mesh=(12, 4),
                     parent="base")
    reg.register(p, CFG, U_SCALE, tag="pinned-old", mesh=(12, 4),
                 parent="base", pin=True)
    reg.register(p, CFG, U_SCALE, tag="other", mesh=(16, 8))
    reg.acquire("base-ft0")
    assert set(reg.sweep(keep_per_lineage=2)) == {"base-ft1"}
    assert set(reg.tags()) == {"base", "base-ft0", "base-ft2", "base-ft3",
                               "pinned-old", "other"}
    reg.release("base-ft0")
    assert set(reg.sweep(keep_per_lineage=1)) == {"base-ft0", "base-ft2"}
    from repro_torch.checkpoint import manager as ckpt
    rec = reg.get("base-ft3")
    assert rec.parent == "base" and rec.mesh == (12, 4)
    tree, _ = ckpt.restore(reg.ckpt_dir,
                           {"params": {"w": torch.zeros(())}},
                           step=rec.version, device="cpu")
    assert float(tree["params"]["w"]) == 1.0


def test_registry_retention_sweeps_on_its_interval(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    p = {"w": np.float32(1.0)}
    for i in range(3):
        reg.register(p, CFG, U_SCALE, tag=f"v{i}", mesh=(12, 4),
                     parent=f"v{i - 1}" if i else None)
    ret = RegistryRetention(reg, keep_per_lineage=1, interval_s=3600.0)
    assert set(ret.sweep()) == {"v0", "v1"}
    assert ret.maybe_sweep() == []
    assert ret.sweeps == 1 and ret.dropped == ["v0", "v1"]
    ret.interval_s = 0.01
    ret.start()
    assert wait_until(lambda: ret.sweeps >= 2, timeout=10)
    ret.stop()


# ----------------------------------------- controller with fake engines


def _fly_stack(tmp_path, *, primary_frac=0.2, child_frac=0.9,
               harvest_kw=None, m=tserve, **ctl_kw):
    """Registry + fake-engine gateway + harvest log + controller of
    package ``m`` with injected harvest/train layers."""
    reg = m.ModelRegistry(str(tmp_path / "reg"))
    reg.register({"cronet_frac": np.float32(primary_frac)}, CFG, U_SCALE,
                 tag="prod")
    built = collections.defaultdict(list)

    def factory(nelx, nely):
        e = _FakeEngine(nelx, nely, m.EngineClosed, model_tag="prod",
                        cronet_frac=primary_frac)
        built[(nelx, nely)].append(e)
        return e

    log = m.HarvestLog(**(harvest_kw or {"capacity": 16}))
    kw = {"device": "cpu"} if m is tserve else {}
    gw = m.TopoGateway(SimpleNamespace(nelx=0, nely=0),
                       params={"cronet_frac": np.float32(primary_frac)},
                       u_scale=U_SCALE, engine_factory=factory,
                       registry=reg, model_tag="prod", max_pending=None,
                       harvest=log, **kw)

    def train_fn(base_tag, mesh, harvested):
        base = f"{base_tag}-ft{mesh[0]}x{mesh[1]}"
        taken, tag, k = set(reg.tags()), base, 2
        while tag in taken:
            tag, k = f"{base}.{k}", k + 1
        frac = child_frac() if callable(child_frac) else child_frac
        reg.register({"cronet_frac": np.float32(frac)}, CFG, U_SCALE,
                     tag=tag, mesh=mesh, parent=base_tag)
        return tag, {"cronet_frac": frac}, U_SCALE

    kw = dict(trigger_below=0.5, min_completed=8, min_harvest=2,
              cooldown_s=3600.0, canary_fraction=0.5,
              canary_min_requests=4, canary_margin=0.05,
              promote_after=4, promote_timeout=10.0,
              harvest_fn=lambda cases, mesh, base: cases,
              train_fn=train_fn)
    kw.update(ctl_kw)
    fly = m.FlywheelController(gw, log, **kw)
    return reg, gw, built, log, fly


def _complete_all(built):
    for engs in list(built.values()):
        for e in engs:
            while e.submitted:
                e.complete()


def _pump(gw, built, timeout=10):
    t0 = time.time()
    while not gw.drain(timeout=0.05):
        assert time.time() - t0 < timeout, "gateway did not drain"
        _complete_all(built)


def _forwarded(built) -> int:
    return sum(len(e.forwarded) for engs in built.values() for e in engs)


def _script_full_cycle(tmp_path, m, child_frac):
    """The reference's promote / rollback script: 10 requests, a tick
    (trigger -> canary), a tick mid-canary, 16 canary requests, a tick
    (verdict). The canary requests go in waves of 4, each routed in full
    before any of it completes, so an auto-rollback fires at the same
    point of the script whatever the threads' timing. Returns the stack
    and every future."""
    reg, gw, built, log, fly = _fly_stack(tmp_path, m=m,
                                          child_frac=child_frac)
    futs = [gw.submit(_hreq(i, m=m)) for i in range(10)]
    _pump(gw, built)
    assert fly.tick()
    live = fly.cycles()
    assert live["12x4"]["state"] == "canary"
    assert live["12x4"]["base_tag"] == "prod"
    child = live["12x4"]["child_tag"]
    assert reg.get(child).parent == "prod"
    fly.tick()
    assert len(fly.cycles()) == 1 and len(fly.history) == 0
    for wave in range(4):
        sent = _forwarded(built) + 4
        futs += [gw.submit(_hreq(100 + 4 * wave + i, m=m)) for i in range(4)]
        assert wait_until(lambda: _forwarded(built) == sent, timeout=10)
        _pump(gw, built)
    fly.tick()
    return reg, gw, log, fly, child, futs


def test_flywheel_full_cycle_promotes(tmp_path):
    reg, gw, log, fly, child, futs = _script_full_cycle(tmp_path, tserve,
                                                        0.9)
    assert fly.cycles() == {}
    assert [c.state for c in fly.history] == [FlywheelState.PROMOTED]
    assert gw.serving_tag((12, 4)) == child
    assert reg.get(child).promoted_at is not None
    kinds = [e.kind for e in gw.events]
    for k in ("flywheel-trigger", "flywheel-harvest", "flywheel-train",
              "flywheel-canary", "canary-start", "promote",
              "flywheel-promote"):
        assert k in kinds, k
    for f in futs:
        r = f.result(timeout=5)
        assert r.done and r.model_tag == r.routed_tag
    assert log.snapshot()["buckets"] == {}   # cleared on promotion
    st_ = fly.status()
    assert st_["terminal_counts"] == {"promoted": 1} and st_["live"] == {}
    gw.shutdown()
    assert reg.leased() == {}


def test_flywheel_regressing_child_rolls_back(tmp_path):
    reg, gw, log, fly, child, futs = _script_full_cycle(tmp_path, tserve,
                                                        0.0)
    assert [c.state for c in fly.history] == [FlywheelState.ROLLED_BACK]
    assert gw.serving_tag((12, 4)) == "prod"
    assert child in reg.tags()
    kinds = [e.kind for e in gw.events]
    assert "rollback" in kinds and "flywheel-rollback" in kinds
    for f in futs:
        r = f.result(timeout=5)
        assert r.done and r.model_tag == r.routed_tag
    gw.shutdown()
    assert reg.leased() == {}


def _transcript(tmp_path, m, child_frac):
    reg, gw, log, fly, child, futs = _script_full_cycle(tmp_path, m,
                                                        child_frac)
    tags = [(f.result(timeout=5).uid, f.result(timeout=5).model_tag)
            for f in futs]
    out = {"events": [(e.kind, e.mesh, e.tag) for e in gw.fleet_events()],
           "trails": [[s for s, _, _ in c.history] for c in fly.history],
           "tags": tags, "harvest": log.snapshot(),
           "registry": sorted((r.tag, r.parent, r.mesh)
                              for r in reg.records())}
    gw.shutdown()
    return out


@pytest.mark.parametrize("child_frac", [0.9, 0.0])
def test_both_controllers_give_the_same_transcript(tmp_path, child_frac):
    """One scripted fake-traffic run (promoted, or rolled back) through
    each package's gateway and controller: the same fleet events, cycle
    trails, completion tags, harvest counters and registry lineage."""
    got = {name: _transcript(tmp_path / name, m, child_frac)
           for name, m in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert any(k == "flywheel-canary" for k, _, _ in got["torch"]["events"])


def test_flywheel_sequential_cycles_after_cooldown(tmp_path):
    reg, gw, built, log, fly = _fly_stack(tmp_path, child_frac=0.0,
                                          cooldown_s=0.0)
    [gw.submit(_hreq(i)) for i in range(10)]
    _pump(gw, built)
    fly.tick()
    first = fly.cycles()["12x4"]["child_tag"]
    [gw.submit(_hreq(100 + i)) for i in range(16)]
    _pump(gw, built)
    fly.tick()
    assert fly.history[0].state is FlywheelState.ROLLED_BACK
    second = fly.cycles()["12x4"]["child_tag"]
    assert second != first
    assert reg.get(second).parent == "prod"
    gw.shutdown()
    assert reg.leased() == {}


def test_flywheel_too_few_harvested_cases_is_error_not_canary(tmp_path):
    reg, gw, built, log, fly = _fly_stack(tmp_path, min_harvest=5)
    [gw.submit(_hreq(i, load_frac=0.3)) for i in range(10)]
    _pump(gw, built)
    fly.tick()
    assert [c.state for c in fly.history] == [FlywheelState.ERROR]
    assert "min_harvest" in fly.history[0].error
    assert set(reg.tags()) == {"prod"}
    gw.shutdown()
    assert reg.leased() == {}


def test_flywheel_failing_train_layer_is_error_with_cooldown(tmp_path):
    def boom(base_tag, mesh, harvested):
        raise RuntimeError("fine-tune diverged")

    reg, gw, built, log, fly = _fly_stack(tmp_path, train_fn=boom)
    [gw.submit(_hreq(i)) for i in range(10)]
    _pump(gw, built)
    fly.tick()
    (cycle,) = fly.history
    assert cycle.state is FlywheelState.ERROR
    assert "fine-tune diverged" in cycle.error
    assert [s for s, _, _ in cycle.history] == ["training", "error"]
    fly.tick()                              # inside the cooldown
    assert len(fly.history) == 1 and fly.cycles() == {}
    gw.shutdown()
    assert reg.leased() == {}


def test_flywheel_acceptable_bucket_never_triggers(tmp_path):
    reg, gw, built, log, fly = _fly_stack(tmp_path, primary_frac=0.9)
    [gw.submit(_hreq(i)) for i in range(12)]
    _pump(gw, built)
    fly.tick()
    assert fly.cycles() == {} and fly.history == []
    gw.shutdown()


def test_flywheel_needs_a_registry():
    gw = SimpleNamespace(registry=None, device="cpu")
    with pytest.raises(ValueError, match="registry"):
        FlywheelController(gw, HarvestLog())


def test_flywheel_daemon_runs_unattended(tmp_path):
    reg, gw, built, log, fly = _fly_stack(tmp_path, interval_s=0.02)
    fly.start()
    try:
        [gw.submit(_hreq(i)) for i in range(10)]
        _pump(gw, built)
        assert wait_until(lambda: "12x4" in fly.cycles(), timeout=10)
        deadline = time.time() + 10
        while time.time() < deadline and not fly.history:
            [gw.submit(_hreq(1000 + random.randrange(10 ** 6)))
             for _ in range(4)]
            _pump(gw, built)
        assert fly.history and fly.history[0].state in (
            FlywheelState.PROMOTED, FlywheelState.ROLLED_BACK)
    finally:
        fly.stop()
        gw.shutdown()
    assert reg.leased() == {}


@settings(max_examples=5, deadline=None)
@given(st.integers(min_value=0, max_value=10 ** 6))
def test_flywheel_random_interleavings_hold_invariants(seed):
    """Random interleavings of traffic / completion / tick / sweep across
    two buckets, the child randomly good or regressing: nothing dropped
    or mis-tagged, lineage consistent, at most one cycle in flight per
    bucket, every lease returned after shutdown."""
    import pathlib
    import tempfile
    rng = random.Random(seed)
    tmp_path = pathlib.Path(tempfile.mkdtemp(prefix=f"tfly{seed}-"))
    reg, gw, built, log, fly = _fly_stack(
        tmp_path, child_frac=lambda: rng.choice((0.0, 0.9)),
        cooldown_s=0.0, promote_timeout=0.2)
    ret = RegistryRetention(reg, keep_per_lineage=2, interval_s=0.0)
    meshes = [(12, 4), (16, 8)]
    futs, uid = [], 0
    for _ in range(70):
        op = rng.randrange(10)
        if op < 5:
            mesh = rng.choice(meshes)
            futs.append(gw.submit(_hreq(uid, nelx=mesh[0], nely=mesh[1])))
            uid += 1
        elif op < 8:
            engs = [e for el in built.values() for e in el if e.submitted]
            if engs:
                rng.choice(engs).complete()
        elif op < 9:
            fly.tick()
            assert len(fly.cycles()) <= len(meshes)
        else:
            ret.sweep()
    _pump(gw, built)
    for _ in range(6):
        fly.tick()
        _pump(gw, built)
    assert len(futs) == uid
    for f in futs:
        r = f.result(timeout=5)
        assert r.done and r.model_tag == r.routed_tag
    for cycle in fly.history:
        assert cycle.state.terminal
        if cycle.child_tag and cycle.child_tag in reg.tags():
            assert reg.get(cycle.child_tag).parent == cycle.base_tag
    gw.shutdown()
    assert reg.leased() == {}


# --------------------------------------- harvest flush on gateway shutdown


def _spooling_stack(tmp_path):
    built = collections.defaultdict(list)

    def factory(nelx, nely):
        e = _FakeEngine(nelx, nely, tserve.EngineClosed, model_tag="prod",
                        cronet_frac=0.2)
        built[(nelx, nely)].append(e)
        return e

    log = HarvestLog(capacity=16, accept_below=0.8,
                     spool_dir=str(tmp_path))
    gw = TopoGateway(SimpleNamespace(nelx=0, nely=0), params=None,
                     u_scale=U_SCALE, engine_factory=factory,
                     max_pending=None, harvest=log, device="cpu")
    return gw, built, log


@pytest.mark.parametrize("wait", [True, False])
def test_gateway_shutdown_flushes_harvest_spool(tmp_path, wait):
    """``record()`` never spools; shutdown does, on the caller's thread
    (``wait=True``) or the dispatcher's (``wait=False``)."""
    gw, built, log = _spooling_stack(tmp_path)
    futs = [gw.submit(_hreq(i, load_frac=i / 10)) for i in range(3)]
    _pump(gw, built)
    assert all(f.result(timeout=5).done for f in futs)
    assert log.snapshot()["harvested"] == 3
    assert not list(tmp_path.glob("harvest_*.jsonl"))
    gw.shutdown(wait=wait)
    assert wait_until(lambda: list(tmp_path.glob("harvest_*.jsonl")),
                      timeout=10)
    reborn = HarvestLog(capacity=16, accept_below=0.8,
                        spool_dir=str(tmp_path))
    assert wait_until(lambda: len(reborn.rejected_cases((12, 4))) == 3,
                      timeout=10)


# ------------------------------------------------ real engines on the CPU


def _problems(n, mesh=(12, 4)):
    return [fea2d.point_load_problem(*mesh, load_node=(i % (mesh[0] - 1), 0),
                                     load=(0.0, -1.0 - 0.1 * i))
            for i in range(n)]


def test_workers_gateway_harvests_like_the_threaded_one(tmp_path):
    """The harvest hook sees a worker's completions as it sees an
    in-process engine's: the same cases, in the same order."""
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.register(init_params(CFG, seed=0, device="cpu", dtype="float32"),
                 CFG, U_SCALE, tag="v1")
    cases = {}
    for name, kw in (("threaded", {}), ("workers", {"workers": 1})):
        log = HarvestLog(accept_below=1.0)
        gw = TopoGateway.from_registry(reg, "v1", slots=2, device="cpu",
                                       error_threshold=0.1, harvest=log,
                                       **kw)
        try:
            for i, p in enumerate(_problems(4)):
                gw.submit(TopoRequest(uid=i, problem=p,
                                      n_iter=4)).result(timeout=120)
        finally:
            gw.shutdown()
        cases[name] = [c.describe() for c in log.rejected_cases((12, 4))]
    assert len(cases["threaded"]) == 4
    assert cases["workers"] == cases["threaded"]


def test_one_cycle_through_the_default_layers_with_real_engines(tmp_path):
    """trigger -> harvest (SIMP trajectories of the harvested cases) ->
    fine-tune (``finetune_from_tag`` with one replayed case) -> canary ->
    promote, at 12x4 on the CPU, as chip_smoke's flywheel phase drives
    it on the card: the canary's completions carry the child's tag and
    are bitwise a dedicated engine's with the child's weights; the base
    weights the gateway serves are bitwise what they were."""
    torch.set_num_threads(1)
    reg = ModelRegistry(str(tmp_path / "reg"))
    base = init_params(CFG, seed=0, device="cpu", dtype="float32")
    reg.register(base, CFG, U_SCALE, tag="base",
                 load_cases=[td.MBB_CASE.describe()])
    log = HarvestLog(accept_below=1.0)
    gw = TopoGateway.from_registry(reg, "base", slots=2, device="cpu",
                                   error_threshold=0.05, harvest=log,
                                   metrics=MetricsRegistry())
    served = gw.params
    before = {p: {k: w.clone() for k, w in ws.items()}
              for p, ws in served.items()}
    fly = FlywheelController(
        gw, log, trigger_below=1.01, min_completed=4, min_harvest=2,
        finetune_steps=2, replay_cases=1, harvest_n_iter=6,
        canary_fraction=0.5, promote_after=2, promote_margin=-1.0)
    assert fly.device == torch.device("cpu")
    probs = _problems(8)
    try:
        for i, p in enumerate(probs[:4]):
            gw.submit(TopoRequest(uid=i, problem=p,
                                  n_iter=4)).result(timeout=120)
        fly.tick()
        cyc = fly.cycles()["12x4"]
        assert cyc["state"] == "canary"
        child = cyc["child_tag"]
        canary_done = []
        for rnd in range(4):
            futs = [gw.submit(TopoRequest(uid=100 * (rnd + 1) + i,
                                          problem=p, n_iter=4))
                    for i, p in enumerate(probs[4:])]
            canary_done += [f.result(timeout=120) for f in futs]
            fly.tick()
            if fly.history:
                break
    finally:
        gw.shutdown()
    assert [c.state for c in fly.history] == [FlywheelState.PROMOTED]
    kinds = [e.kind for e in gw.fleet_events() if e.kind.startswith("fly")]
    assert kinds == ["flywheel-trigger", "flywheel-harvest",
                     "flywheel-train", "flywheel-canary", "flywheel-promote"]
    rec = reg.get(child)
    assert rec.parent == "base" and rec.mesh == (12, 4)
    assert rec.metrics["harvested_trajectories"] >= 2
    mine = [r for r in canary_done if r.model_tag == child]
    assert mine and all(r.routed_tag == r.model_tag for r in canary_done)
    child_params, _ = reg.load(child, device="cpu")
    eng = TopoServingEngine(CFG, child_params, U_SCALE, slots=2,
                            error_threshold=0.05, device="cpu",
                            metrics=MetricsRegistry())
    refs = eng.run([TopoRequest(uid=r.uid, problem=r.problem, n_iter=4)
                    for r in mine])
    eng.shutdown()
    for r, ref in zip(mine, refs):
        np.testing.assert_array_equal(r.density, ref.density)
    assert all(torch.equal(served[p][k], w)
               for p, ws in before.items() for k, w in ws.items())
    assert reg.leased() == {}
