"""Port parity: FEA, CG solve, filter and OC update
(repro_torch.fea.fea2d, repro_torch.kernels.cg_fused, repro_torch.fea.simp)
against the JAX package, on the CPU, on the 12x4 mesh of
test_cg_fused.py:41-44.

The JAX solves run under jit, the domain of the reference's own
fused == reference contract (test_cg_fused.py). Across frameworks the
arithmetic order differs in the last ulp, so U is held to a relative L2
tolerance (1e-4; measured differences are <= 1.1e-5) and per-slot
iteration counts to +-1 at ``tol=1e-5``. At the default ``tol=1e-6`` the
fp32 recursive residual is at its stagnation floor on these meshes, and
the iteration at which it crosses the tolerance is chaotic: the two
frameworks stop up to ~30 iterations apart with U still within 1.1e-5
(measured at width 4), so there only U and convergence are asserted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fea import fea2d as jfea
from repro.fea import simp as jsimp
from repro_torch.fea import fea2d as tfea
from repro_torch.fea import simp as tsimp
from repro_torch.kernels.cg_fused import solve_b_fused

U_RTOL = 1e-4     # relative L2 of U
TOL = 1e-5        # CG tolerance where iteration counts are comparable


def _specs(n, nelx=12, nely=4):
    return [dict(load_node=(i % (nelx - 1), 0), load=(0.05 * i, -1.0 - 0.1 * i))
            for i in range(n)]


def _pair(n, nelx=12, nely=4, pad_to=None):
    """The same n problems built by both packages, stacked."""
    jp = [jfea.point_load_problem(nelx, nely, **s) for s in _specs(n, nelx)]
    tp = [tfea.point_load_problem(nelx, nely, **s) for s in _specs(n, nelx)]
    if pad_to is not None:
        jp = [jfea.pad_problem(p, *pad_to) for p in jp]
        tp = [tfea.pad_problem(p, *pad_to) for p in tp]
    return jfea.stack_problems(jp), tfea.stack_problems(tp, device="cpu")


def _jsolve(bp, X, U0=None, need=None, backend="reference", tol=TOL):
    fn = jax.jit(lambda b, x, u, n: jfea.solve_b(b, x, tol=tol, U0=u,
                                                 need=n, backend=backend))
    U, its = fn(bp, X, U0, need)
    return np.asarray(U), np.asarray(its)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _check(U, its, Uref, itsref, its_tol=1):
    its, itsref = np.asarray(its), np.asarray(itsref)
    if its_tol is not None:
        assert np.all(np.abs(its - itsref) <= its_tol), (its, itsref)
    num = np.linalg.norm(U - Uref, axis=1)
    den = np.maximum(np.linalg.norm(Uref, axis=1), 1e-30)
    assert np.all(num <= U_RTOL * den + 1e-12), num / den


def test_builders_are_float32_and_match():
    """The float64 numpy constants are cast: every tensor is float32 and
    equal to the JAX (x64-off) arrays; edof and load volume agree."""
    jb, tb = _pair(3)
    for name in ("f", "free_mask", "fixed_x_mask", "volfrac", "KE"):
        t = getattr(tb, name)
        assert t.dtype == torch.float32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(jb, name)))
    np.testing.assert_array_equal(tb.edof.numpy(), np.asarray(jb.edof))
    np.testing.assert_array_equal(tfea.load_volume_b(tb).numpy(),
                                  np.asarray(jfea.load_volume_b(jb)))


def test_pad_and_crop_match_reference():
    jb, tb = _pair(2, nelx=10, pad_to=(12, 6))
    for name in ("f", "free_mask", "fixed_x_mask", "elem_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    x = np.random.default_rng(0).random((6, 12)).astype(np.float32)
    np.testing.assert_array_equal(tfea.crop_density(x, 10, 4),
                                  np.asarray(jfea.crop_density(x, 10, 4)))


def test_stencil_and_compliance_match_reference():
    """K(x) u and compliance/sensitivity: 1e-5 relative (one stencil pass,
    reassociated sums)."""
    jb, tb = _pair(3)
    rng = np.random.default_rng(1)
    X = rng.uniform(0.1, 1.0, (3, 4, 12)).astype(np.float32)
    U = rng.standard_normal((3, jb.f.shape[1])).astype(np.float32)
    ku = tfea.stiffness_apply_b(tb, _t(X), _t(U)).numpy()
    np.testing.assert_allclose(
        ku, np.asarray(jfea.stiffness_apply_b(jb, jnp.asarray(X),
                                              jnp.asarray(U))),
        rtol=1e-5, atol=1e-5)
    c, dc = tfea.compliance_and_sens_b(tb, _t(X), _t(U))
    jc, jdc = jfea.compliance_and_sens_b(jb, jnp.asarray(X), jnp.asarray(U))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-5)
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("width", [2, 4])
def test_solve_b_cold_matches_reference_and_fused(width):
    """Cold solves at widths 2 and 4: the port's plain version vs the JAX
    reference and vs the Pallas fused kernel (interpret, under jit)."""
    jb, tb = _pair(width)
    X = np.stack([np.full((4, 12), 0.3 + 0.1 * i, np.float32)
                  for i in range(width)])
    Ur, ir = _jsolve(jb, jnp.asarray(X))
    Uf, if_ = _jsolve(jb, jnp.asarray(X), backend="fused")
    U, its = tfea.solve_b(tb, _t(X), tol=TOL)
    assert U.dtype == torch.float32 and its.dtype == torch.int32
    _check(U.numpy(), its.numpy(), Ur, ir)
    _check(U.numpy(), its.numpy(), Uf, if_)
    assert solve_b_fused.launches == 0        # CPU: plain version only


def test_solve_b_default_tol_u_matches():
    """At the default tol=1e-6 the stopping iteration is chaotic across
    frameworks (module docstring): U within U_RTOL, every slot converged
    before max_iter."""
    jb, tb = _pair(4)
    X = np.stack([np.full((4, 12), 0.3 + 0.1 * i, np.float32)
                  for i in range(4)])
    Ur, ir = _jsolve(jb, jnp.asarray(X), tol=1e-6)
    U, its = tfea.solve_b(tb, _t(X))
    _check(U.numpy(), its.numpy(), Ur, ir, its_tol=None)
    assert np.all((its.numpy() > 0) & (its.numpy() < 2000))


def test_solve_b_warm_start_and_need_mask():
    """Warm starts and a partial need mask; the need=False slot keeps its
    (masked) warm start exactly and burns zero iterations."""
    jb, tb = _pair(4)
    X = np.full((4, 4, 12), 0.5, np.float32)
    U0 = np.asarray(jfea.solve_b(jb, jnp.asarray(X), max_iter=5)[0])
    need = np.array([True, False, True, True])
    Ur, ir = _jsolve(jb, jnp.asarray(X), jnp.asarray(U0), jnp.asarray(need))
    U, its = tfea.solve_b(tb, _t(X), tol=TOL, U0=_t(U0),
                          need=torch.from_numpy(need))
    _check(U.numpy(), its.numpy(), Ur, ir)
    np.testing.assert_array_equal(U.numpy()[1],
                                  (U0 * np.asarray(jb.free_mask))[1])
    assert int(its[1]) == 0


def test_solve_b_elem_mask_and_idle_slot():
    """Shape-class padding (elem_mask) plus an idle zero-load slot with a
    stale warm start: the idle slot converges in zero iterations."""
    jb, tb = _pair(2, nelx=10, pad_to=(12, 6))
    jidle = jfea.idle_problem(12, 6)._replace(elem_mask=jnp.ones((6, 12)))
    tidle = tfea.idle_problem(12, 6)._replace(elem_mask=torch.ones((6, 12)))
    jraw = [jfea.pad_problem(jfea.point_load_problem(10, 4, **s), 12, 6)
            for s in _specs(2, 10)]
    traw = [tfea.pad_problem(tfea.point_load_problem(10, 4, **s), 12, 6)
            for s in _specs(2, 10)]
    jb = jfea.stack_problems(jraw + [jidle])
    tb = tfea.stack_problems(traw + [tidle], device="cpu")
    X = np.asarray(jb.elem_mask) * 0.5
    U0 = np.zeros((3, jb.f.shape[1]), np.float32)
    U0[2] = 0.37
    Ur, ir = _jsolve(jb, jnp.asarray(X), jnp.asarray(U0))
    U, its = tfea.solve_b(tb, _t(X), tol=TOL, U0=_t(U0))
    _check(U.numpy(), its.numpy(), Ur, ir)
    assert int(its[2]) == 0 and int(ir[2]) == 0


def test_single_problem_solve_matches_reference():
    """fea2d.solve / compliance_and_sens (width-2 padded in the port)."""
    jp = jfea.point_load_problem(12, 4, load_node=(3, 0))
    tp = tfea.point_load_problem(12, 4, load_node=(3, 0))
    x = np.full((4, 12), 0.4, np.float32)
    ju, jits = jfea.solve(jp, jnp.asarray(x), tol=TOL)
    u, its = tfea.solve(tp, _t(x), tol=TOL)
    _check(u.numpy()[None], its.numpy()[None], np.asarray(ju)[None],
           np.asarray(jits)[None])
    jc, jdc = jfea.compliance_and_sens(jp, jnp.asarray(x), ju)
    c, dc = tfea.compliance_and_sens(tp, _t(x), _t(ju))
    # same u on both sides: only the reduction order differs
    np.testing.assert_allclose(float(c), float(jc), rtol=1e-5)
    # the per-element energy u_e^T KE u_e cancels heavily on a converged
    # field and XLA contracts its multiply-adds: elementwise bar is 2e-4
    # of max |dc| (measured 1.1e-4)
    jdc = np.asarray(jdc)
    np.testing.assert_allclose(dc.numpy(), jdc, rtol=0,
                               atol=2e-4 * np.abs(jdc).max())


@pytest.mark.parametrize("masked", [False, True])
def test_filter_and_oc_match_reference(masked):
    """Sensitivity filter (1e-5 relative: shifted adds vs XLA conv) and
    the OC update (1e-5 absolute on densities in [0.001, 1])."""
    rng = np.random.default_rng(2)
    B, nely, nelx = 3, 4, 12
    X = rng.uniform(0.05, 1.0, (B, nely, nelx)).astype(np.float32)
    DC = -rng.uniform(0.1, 5.0, (B, nely, nelx)).astype(np.float32)
    vf = np.array([0.4, 0.5, 0.3], np.float32)
    mask = None
    if masked:
        mask = np.ones((B, nely, nelx), np.float32)
        mask[:, :, -2:] = 0.0
        X = X * mask
    jf = jsimp.make_filter_b(nelx, nely, masked=masked)
    tf = tsimp.make_filter_b(nelx, nely, masked=masked)
    jargs = [jnp.asarray(X), jnp.asarray(DC)] + (
        [jnp.asarray(mask)] if masked else [])
    targs = [_t(X), _t(DC)] + ([_t(mask)] if masked else [])
    jdc = np.asarray(jf(*jargs))
    tdc = tf(*targs).numpy()
    np.testing.assert_allclose(tdc, jdc, rtol=1e-5, atol=1e-6)
    if masked:
        active = mask.reshape(B, -1).sum(1)
        dv = np.ones_like(X) / active[:, None, None]
        jx = jsimp.oc_update_b(jnp.asarray(X), jnp.asarray(jdc),
                               jnp.asarray(dv), jnp.asarray(vf),
                               mask=jnp.asarray(mask))
        tx = tsimp.oc_update_b(_t(X), _t(jdc), _t(dv), _t(vf),
                               mask=_t(mask))
    else:
        dv = np.ones((nely, nelx), np.float32) / (nely * nelx)
        jx = jsimp.oc_update_b(jnp.asarray(X), jnp.asarray(jdc),
                               jnp.asarray(dv), jnp.asarray(vf))
        tx = tsimp.oc_update_b(_t(X), _t(jdc), _t(dv), _t(vf))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=1e-5)


def test_run_simp_matches_reference():
    """Five SIMP iterations on the 12x4 MBB beam: compliance history within
    1e-3 relative (CG tolerance 1e-6 compounds through the OC updates)."""
    jp = jfea.mbb_problem(12, 4)
    tp = tfea.mbb_problem(12, 4)
    _, jh = jsimp.run_simp(jp, n_iter=5)
    _, th = tsimp.run_simp(tp, n_iter=5, device="cpu")
    np.testing.assert_allclose(th["c"], jh["c"], rtol=1e-3)
    np.testing.assert_allclose(th["x"], jh["x"], rtol=0, atol=1e-3)


def test_stack_problems_and_params_from_jax_default_to_the_card(monkeypatch):
    """Both functions follow the port's device rule: the card unless the
    caller asks for the CPU, and an error, never a move to the CPU, when
    no GPU is present (the check is forced off here, so the test runs on
    any machine)."""
    from repro_torch.common import params_from_jax
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    probs = [tfea.point_load_problem(12, 4, **s) for s in _specs(2)]
    tree = {"trunk": {"fc1": np.ones((3, 2), np.float32)}}
    for call in (lambda **kw: tfea.stack_problems(probs, **kw),
                 lambda **kw: params_from_jax(tree, **kw)):
        for kw in ({}, {"device": "cuda"}, {"device": "cuda:0"}):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call(**kw)
    assert tfea.stack_problems(probs, device="cpu").f.device.type == "cpu"
    assert params_from_jax(tree, device="cpu")["trunk"]["fc1"].device.type \
        == "cpu"
