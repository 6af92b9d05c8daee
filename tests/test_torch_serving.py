"""The slice as a whole: the port's TopoServingEngine against the JAX
engine on the same requests, plus the port engine's own serving contracts,
on the CPU (12x4 mesh, 3-step history).

Whole trajectories cannot be compared for equality across frameworks: the
gate compares ``err < error_threshold`` (hybrid.py:243), so one ulp near
the threshold would fork a run. The thresholds here sit far from every
measured ``err`` (0.05 against errors of order 1, and 1e9), the gate
decisions are compared as counts (zero flips allowed), and compliances are
held to a stated tolerance.
"""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.common import materialize
from repro.configs.cronet import get_cronet_config
from repro.core import cronet as jcronet
from repro.fea import fea2d as jfea
from repro.serve.topo_service import TopoRequest as JRequest
from repro.serve.topo_service import TopoServingEngine as JEngine
from repro_torch.common import params_from_jax
from repro_torch.fea import fea2d as tfea
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.topo_service import (TopoRequest, TopoServingEngine,
                                            shard_devices)
from repro_torch.serve.types import EngineClosed, EngineState

CFG = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                          hist_len=3, dtype="float32")
U_SCALE = 50.0
REQS = [(dict(load_node=(0, 0), load=(0.0, -1.0)), 6),
        (dict(load_node=(5, 0), load=(0.0, -0.7)), 8),
        (dict(load_node=(8, 0), load=(0.0, -1.3)), 7),
        (dict(load_node=(3, 0), load=(0.1, -0.9)), 6)]


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(materialize(jcronet.param_specs(CFG),
                                      jax.random.key(0)))


def _serve_port(params, threshold, slots=2, reqs=REQS, **kw):
    eng = TopoServingEngine(CFG, params, U_SCALE, slots=slots,
                            error_threshold=threshold, device="cpu",
                            metrics=MetricsRegistry(), **kw)
    done = eng.run([TopoRequest(uid=i, problem=tfea.point_load_problem(
        12, 4, **spec), n_iter=n) for i, (spec, n) in enumerate(reqs)])
    eng.shutdown()
    return eng, done


@pytest.mark.parametrize("threshold", [0.05, 1e9])
def test_engines_agree_on_the_same_requests(jparams, threshold):
    """Both engines serve the same 4 requests on 2 slots. Zero gate flips
    (per-request CRONet/FEA counts equal); compliances within 1e-2
    relative (threshold 0.05: FEA every tick, CG at tol 1e-6 through up to
    8 OC updates; threshold 1e9: the surrogate's random-weight field,
    forward parity 1e-4, through the same updates); densities within 2e-2
    absolute."""
    jeng = JEngine(CFG, jparams, U_SCALE, slots=2, error_threshold=threshold)
    jdone = jeng.run([JRequest(uid=i, problem=jfea.point_load_problem(
        12, 4, **spec), n_iter=n) for i, (spec, n) in enumerate(REQS)])
    jeng.shutdown()
    _, tdone = _serve_port(params_from_jax(jparams, device="cpu"), threshold)
    for j, t in zip(jdone, tdone):
        assert (t.cronet_iters, t.fea_iters) == (j.cronet_iters, j.fea_iters)
        assert np.isfinite(t.compliance)
        np.testing.assert_allclose(t.compliance, j.compliance, rtol=1e-2)
        np.testing.assert_allclose(t.density, np.asarray(j.density),
                                   rtol=0, atol=2e-2)
    if threshold > 1:
        assert sum(t.cronet_iters for t in tdone) > 0


def test_engine_densities_are_slot_invariant(jparams):
    """Bitwise: the same requests served on 2 and on 4 slots, with and
    without tracing, give identical densities and counters."""
    params = params_from_jax(jparams, device="cpu")
    _, a = _serve_port(params, 1e9, slots=2)
    eng, b = _serve_port(params, 1e9, slots=4, trace_every=1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.density, y.density)
        assert (x.compliance, x.cronet_iters, x.cg_iters) == \
            (y.compliance, y.cronet_iters, y.cg_iters)
        assert y.trace is not None and y.trace.complete
    stats = eng.throughput_stats()
    assert stats["requests"] == len(REQS) and stats["device"] == "cpu"


def test_engine_preemption_and_ladder_keep_results(jparams):
    """A tight-deadline request preempts a slack occupant (park/restore)
    on a ladder engine; every density equals the unpreempted run's. The
    occupants run 12 iterations, so each still has more than the 2 ticks
    left that make waiting too slow for the urgent request."""
    params = params_from_jax(jparams, device="cpu")
    long_reqs = [(spec, 12) for spec, _ in REQS]
    _, base = _serve_port(params, 1e9, slots=2, reqs=long_reqs)
    _, base_u = _serve_port(params, 1e9, slots=2, reqs=REQS[:1])
    eng = TopoServingEngine(CFG, params, U_SCALE, slots=4, ladder=(2, 4),
                            error_threshold=1e9, device="cpu",
                            tick_time_s=1.0, metrics=MetricsRegistry())
    futs = [eng.submit(TopoRequest(uid=i, problem=tfea.point_load_problem(
        12, 4, **spec), n_iter=n), deadline_s=1000.0)
        for i, (spec, n) in enumerate(long_reqs)]
    t0 = time.monotonic()       # wait until all four occupy the slots
    while (any(f.request.admitted_t is None for f in futs)
           and time.monotonic() - t0 < 60):
        time.sleep(0.001)
    spec, n = REQS[0]
    urgent = eng.submit(TopoRequest(uid=99, problem=tfea.point_load_problem(
        12, 4, **spec), n_iter=n), deadline_s=1.0 * (n + 2))
    done = [f.result(timeout=120) for f in futs]
    u = urgent.result(timeout=120)
    assert eng.drain(timeout=60)
    eng.shutdown()
    assert eng.state is EngineState.CLOSED
    with pytest.raises(EngineClosed):
        eng.submit(TopoRequest(uid=7, problem=tfea.mbb_problem(12, 4)))
    for x, y in zip(base, done):
        np.testing.assert_array_equal(x.density, y.density)
    np.testing.assert_array_equal(u.density, base_u[0].density)
    assert eng.preemptions >= 1 and u.preemptions == 0
    assert sum(r.preemptions for r in done) == eng.preemptions
    assert eng.throughput_stats()["ladder"]["rungs"] == [2, 4]


def test_shape_padded_engine_and_param_swap(jparams):
    """A shape-class engine serves a 10x4 request padded onto 12x4 and
    crops the density back; swap_params between activations stamps the
    new model tag and serves with the new weights."""
    params = params_from_jax(jparams, device="cpu")
    eng = TopoServingEngine(CFG, params, U_SCALE, slots=2, device="cpu",
                            shape_padded=True, error_threshold=1e9,
                            model_tag="a", metrics=MetricsRegistry())
    raw = tfea.point_load_problem(10, 4, load_node=(4, 0))
    req = TopoRequest(uid=0, problem=tfea.pad_problem(raw, 12, 4),
                      n_iter=5, orig_mesh=(10, 4))
    (done,) = eng.run([req])
    assert done.density.shape == (4, 10) and done.model_tag == "a"
    assert np.isfinite(done.compliance) and done.cronet_iters > 0
    eng.swap_params({k: {n: w * 0.5 for n, w in v.items()}
                     for k, v in params.items()}, model_tag="b")
    (again,) = eng.run([TopoRequest(uid=1, problem=tfea.pad_problem(
        raw, 12, 4), n_iter=5, orig_mesh=(10, 4))])
    eng.shutdown()
    assert again.model_tag == "b"
    assert not np.array_equal(again.density, done.density)


def test_engine_rejects_other_meshes_and_missing_gpu():
    params = params_from_jax(jax.device_get(materialize(
        jcronet.param_specs(CFG), jax.random.key(0))), device="cpu")
    eng = TopoServingEngine(CFG, params, U_SCALE, slots=2, device="cpu",
                            metrics=MetricsRegistry())
    with pytest.raises(ValueError, match="mesh"):
        eng.submit(TopoRequest(uid=0, problem=tfea.mbb_problem(10, 4)))
    eng.shutdown()
    assert shard_devices(4, device="cpu") == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TopoServingEngine(CFG, params, U_SCALE, slots=2)
