"""Port parity and internal contracts of the hybrid tick
(repro_torch.fea.hybrid), on the CPU at a 12x4 mesh with a 3-step history.

  * One tick from a shared HybridState, port vs JAX: every field within
    its stated tolerance (the gate reads the shared ``err``, so both sides
    take the same branch).
  * The port's own contracts, bitwise: a slot stepped at width 4 equals the
    same slot stepped at width 2, and park/restore/move of a lane are
    exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import materialize
from repro.configs.cronet import get_cronet_config
from repro.core import cronet as jcronet
from repro.fea import fea2d as jfea
from repro.fea import hybrid as jhybrid
from repro_torch.common import params_from_jax
from repro_torch.fea import fea2d as tfea
from repro_torch.fea import hybrid as thybrid

CFG = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                          hist_len=3, dtype="float32")
U_SCALE = 50.0


def _specs(n):
    return [dict(load_node=(i % 11, 0), load=(0.05 * i, -1.0 - 0.1 * i))
            for i in range(n)]


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(materialize(jcronet.param_specs(CFG),
                                      jax.random.key(0)))


def _tstate(js):
    return thybrid.HybridState(*[torch.from_numpy(np.array(leaf))
                                 for leaf in js])


@pytest.mark.parametrize("n_before", [4, 6])
def test_one_tick_matches_jax_from_shared_state(jparams, n_before):
    """After ``n_before`` JAX ticks (it=4: surrogate accepted, FEA skipped;
    it=6: forced FEA verification, prediction scored), one tick of each
    framework from the same state. Tolerances: counters and history exact;
    u relative L2 1e-3 and compliance 1e-3 relative (the forward agrees to
    1e-4, the CG to 1e-5, both amplified by u_scale and the energy sum);
    densities 1e-3 absolute (OC bisection on a perturbed sensitivity);
    err 1e-3 relative."""
    probs = [jfea.point_load_problem(12, 4, **s) for s in _specs(4)]
    jb = jfea.stack_problems(probs)
    lv = jfea.load_volume_b(jb)
    jstep = jhybrid.make_hybrid_step(CFG, U_SCALE, 1e9, 3, 1.5, "fp32")
    jp = jhybrid.cast_params(jparams, "fp32")
    js = jhybrid.init_state(CFG, jb)
    for _ in range(n_before):
        js = jstep(jp, jb, lv, js)
    js = jax.device_get(js)
    tstate = _tstate(js)
    jnext = jax.device_get(jstep(jp, jb, lv, jax.tree.map(jnp.asarray, js)))

    tb = tfea.stack_problems([tfea.point_load_problem(12, 4, **s)
                              for s in _specs(4)], device="cpu")
    tstep = thybrid.make_hybrid_step(CFG, U_SCALE, 1e9, 3, 1.5, "fp32")
    tparams = thybrid.cast_params(params_from_jax(jparams, device="cpu"),
                                  "fp32")
    tnext = tstep(tparams, tb,
                  tfea.load_volume_b(tb), tstate)

    for name in ("it", "n_cronet", "n_fea", "hist"):
        np.testing.assert_array_equal(getattr(tnext, name).numpy(),
                                      np.asarray(getattr(jnext, name)),
                                      err_msg=name)
    # CG iteration counts at the default tol are chaotic across frameworks
    # (test_torch_fea.py); only "FEA ran" vs "skipped" must agree
    np.testing.assert_array_equal(
        tnext.cg_iters.numpy() > np.asarray(js.cg_iters),
        np.asarray(jnext.cg_iters) > np.asarray(js.cg_iters))
    ju, tu = np.asarray(jnext.u), tnext.u.numpy()
    assert np.all(np.linalg.norm(tu - ju, axis=1)
                  <= 1e-3 * np.linalg.norm(ju, axis=1))
    np.testing.assert_allclose(tnext.compliance.numpy(),
                               np.asarray(jnext.compliance), rtol=1e-3)
    np.testing.assert_allclose(tnext.x.numpy(), np.asarray(jnext.x),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(tnext.err.numpy(), np.asarray(jnext.err),
                               rtol=1e-3)


def _port_setup(n=4, threshold=1e9):
    params = thybrid.cast_params(params_from_jax(jax.device_get(materialize(
        jcronet.param_specs(CFG), jax.random.key(1))), device="cpu"), "fp32")
    probs = [tfea.point_load_problem(12, 4, **s) for s in _specs(n)]
    step = thybrid.make_hybrid_step(CFG, U_SCALE, threshold, 3, 1.5, "fp32")
    return params, probs, step


def _run(step, params, probs, n_ticks, state=None):
    bp = tfea.stack_problems(probs, device="cpu")
    lv = tfea.load_volume_b(bp)
    state = thybrid.init_state(CFG, bp) if state is None else state
    for _ in range(n_ticks):
        state = step(params, bp, lv, state)
    return state


def _assert_lanes_equal(a, b, lanes_a, lanes_b):
    for name, la, lb in zip(thybrid.HybridState._fields, a, b):
        np.testing.assert_array_equal(la[lanes_a].numpy(), lb[lanes_b].numpy(),
                                      err_msg=name)


def test_slot_invariance_width4_vs_width2():
    """Bitwise: ticks 4..8 (surrogate and FEA ticks) of slots 0-1 stepped
    at width 4 equal the same slots stepped at width 2 from the same
    state."""
    params, probs, step = _port_setup(4)
    s4 = _run(step, params, probs, 3)
    s2 = thybrid.HybridState(*[leaf[:2].clone() for leaf in s4])
    b4 = tfea.stack_problems(probs, device="cpu")
    b2 = tfea.stack_problems(probs[:2], device="cpu")
    for _ in range(5):
        s4 = step(params, b4, tfea.load_volume_b(b4), s4)
        s2 = step(params, b2, tfea.load_volume_b(b2), s2)
        _assert_lanes_equal(s4, s2, slice(0, 2), slice(0, 2))
    assert int(s4.n_cronet[0]) > 0 and int(s4.n_fea[0]) > 3


def test_park_restore_move_are_exact():
    """park -> reset -> restore -> step equals an uninterrupted step, and a
    lane moved to another index continues its trajectory bitwise."""
    params, probs, step = _port_setup(4)
    bp = tfea.stack_problems(probs, device="cpu")
    lv = tfea.load_volume_b(bp)
    s = _run(step, params, probs, 4)
    ref = step(params, bp, lv, thybrid.HybridState(*[t.clone() for t in s]))
    parked = thybrid.park_slot(s, 1)
    thybrid.reset_slot(CFG, s, 1, 0.5)
    assert int(s.it[1]) == 0
    thybrid.restore_slot(s, 1, parked)
    _assert_lanes_equal(step(params, bp, lv, s), ref, slice(None),
                        slice(None))
    # move lane 3 onto lane 0 of a batch whose lane 0 holds lane 3's problem
    moved = _run(step, params, probs, 4)
    thybrid.move_slot(moved, 3, 0)
    bp_m = tfea.stack_problems([probs[3]] + probs[1:], device="cpu")
    out = step(params, bp_m, tfea.load_volume_b(bp_m), moved)
    _assert_lanes_equal(out, ref, slice(0, 1), slice(3, 4))


def test_resize_state_keeps_live_lanes():
    params, probs, step = _port_setup(4)
    s = _run(step, params, probs, 2)
    grown = thybrid.resize_state(s, 6)
    assert grown.x.shape[0] == 6 and float(grown.x[5, 0, 0]) == 0.5
    assert float(grown.err[5]) == float("inf")
    _assert_lanes_equal(grown, s, slice(0, 4), slice(0, 4))
    shrunk = thybrid.resize_state(grown, 2)
    _assert_lanes_equal(shrunk, s, slice(0, 2), slice(0, 2))


def test_run_hybrid_pads_to_width_two():
    """run_hybrid pads one problem to width 2 (hybrid.py:332-336): its
    density equals lane 0 of a width-2 batch of the problem plus an idle
    slot, bitwise; metrics are finite."""
    params, probs, step = _port_setup(1)
    res = thybrid.run_hybrid(CFG, params, U_SCALE, n_iter=5,
                             error_threshold=1e9, precision="fp32",
                             problem=probs[0], device="cpu")
    idle = tfea.idle_problem(12, 4)
    s = _run(step, params, [probs[0], idle], 5)
    np.testing.assert_array_equal(res.density, s.x[0].numpy())
    assert res.cronet_invocations + res.fea_invocations == 5
    assert np.isfinite(res.final_compliance) and res.solution_accuracy >= 0


def _masked_specs(n):
    return [dict(load_node=(2 * i % 9, 0), load=(0.05 * i, -1.0 - 0.1 * i))
            for i in range(n)]


@pytest.mark.parametrize("n_before", [4, 6])
def test_masked_tick_matches_jax_from_shared_state(jparams, n_before):
    """The shape-class tick (``elem_mask`` set): 4 slots of 10x3 problems
    padded onto the 12x4 mesh, threshold 1e9, one tick of each framework
    from the same JAX state after ``n_before`` JAX ticks. It runs the
    masked filter and the OC update with the per-slot gradient
    ``dv = 1/active``.

    it=4 (surrogate tick, no CG): counters and history exact; densities
    within 1e-5 absolute, float rounding of the same OC bisection on a
    sensitivity that agrees to ~1e-6 relative.

    it=6 (forced FEA): counters exact and "FEA ran" equal; u within 1e-3
    relative L2 and compliance within 1e-3 relative, as the unmasked test;
    densities within 2e-3 absolute. The densities' bar is the CG stop
    point's: both frameworks stop fp32 Jacobi-PCG near a 1e-6 recursive
    residual at iterations that differ with the last ulp (here 142 against
    141 and 128 against 142 on two slots), so u differs by 2e-5 to 4e-4
    relative, the sensitivity with it, and the OC bisection turns that into
    7.1e-4 in x at it=6 and 1.6e-3 at the next FEA tick (it=9) of this same
    setup; the surrogate ticks read 9e-7."""
    probs = [jfea.pad_problem(jfea.point_load_problem(10, 3, **s), 12, 4)
             for s in _masked_specs(4)]
    jb = jfea.stack_problems(probs)
    assert jb.elem_mask is not None
    lv = jfea.load_volume_b(jb)
    jstep = jhybrid.make_hybrid_step(CFG, U_SCALE, 1e9, 3, 1.5, "fp32")
    jp = jhybrid.cast_params(jparams, "fp32")
    js = jhybrid.init_state(CFG, jb)
    for _ in range(n_before):
        js = jstep(jp, jb, lv, js)
    js = jax.device_get(js)
    tstate = _tstate(js)
    jnext = jax.device_get(jstep(jp, jb, lv, jax.tree.map(jnp.asarray, js)))

    tb = tfea.stack_problems(
        [tfea.pad_problem(tfea.point_load_problem(10, 3, **s), 12, 4)
         for s in _masked_specs(4)], device="cpu")
    tstep = thybrid.make_hybrid_step(CFG, U_SCALE, 1e9, 3, 1.5, "fp32")
    tparams = thybrid.cast_params(params_from_jax(jparams, device="cpu"),
                                  "fp32")
    tnext = tstep(tparams, tb, tfea.load_volume_b(tb), tstate)

    for name in ("it", "n_cronet", "n_fea", "hist"):
        np.testing.assert_array_equal(getattr(tnext, name).numpy(),
                                      np.asarray(getattr(jnext, name)),
                                      err_msg=name)
    fea_ran = np.asarray(jnext.cg_iters) > np.asarray(js.cg_iters)
    np.testing.assert_array_equal(
        tnext.cg_iters.numpy() > np.asarray(js.cg_iters), fea_ran)
    # the padded border stays at 0 in both
    passive = np.asarray(jb.elem_mask) == 0
    assert not tnext.x.numpy()[passive].any()
    if n_before == 4:
        assert not fea_ran.any()
        np.testing.assert_allclose(tnext.x.numpy(), np.asarray(jnext.x),
                                   rtol=0, atol=1e-5)
        return
    assert fea_ran.all()
    ju, tu = np.asarray(jnext.u), tnext.u.numpy()
    assert np.all(np.linalg.norm(tu - ju, axis=1)
                  <= 1e-3 * np.linalg.norm(ju, axis=1))
    np.testing.assert_allclose(tnext.compliance.numpy(),
                               np.asarray(jnext.compliance), rtol=1e-3)
    np.testing.assert_allclose(tnext.x.numpy(), np.asarray(jnext.x),
                               rtol=0, atol=2e-3)
