"""The port's training data layer (repro_torch.fea.dataset and
fea2d.load_volume) against the JAX package's, on the CPU.

Pure data movement and numpy sampling are bitwise: ``load_volume``, the
``LoadCase`` family, ``sample_load_cases``, ``window_trajectory``,
``split_by_trajectory`` and ``concat_datasets``. SIMP trajectories run
two frameworks' FEA and agree within the hybrid tick's bars
(tests/test_torch_hybrid.py): U and compliance 1e-3 relative, densities
1e-3 absolute. CG stopping counts at tol=1e-6 are chaotic (ROADMAP §C),
so an OC bisection may land on another multiplier: such iterations are
counted as flips, never hidden.
"""
import numpy as np
import pytest
import torch

from repro.configs.cronet import CRONetConfig as JCFG
from repro.fea import dataset as jd
from repro.fea import fea2d as jf
from repro_torch.configs.cronet import CRONetConfig as TCFG
from repro_torch.fea import dataset as td
from repro_torch.fea import fea2d as tf

JCFG_S = JCFG(nelx=12, nely=4, hist_len=3, dtype="float32")
TCFG_S = TCFG(nelx=12, nely=4, hist_len=3, dtype="float32")
U_TOL = 1e-3          # relative L2, per trajectory and iteration
C_TOL = 1e-3          # relative
X_TOL = 1e-3          # absolute
MAX_FLIPS = 2         # of the 3 x 8 (trajectory, iteration) pairs


def _cases(pkg):
    return [pkg.MBB_CASE,
            pkg.LoadCase(load_frac=0.3, load=(0.25, -0.9), volfrac=0.42),
            pkg.LoadCase(load_frac=0.75, load=(-0.4, -1.2), volfrac=0.5),
            pkg.LoadCase(load_frac=0.999, load=(1.0, 0.0), volfrac=0.35)]


def _same_case(a, b):
    return (a.describe() == b.describe() and a.key() == b.key()
            and a.load_node(12) == b.load_node(12))


# ------------------------------------------------------------ bitwise


@pytest.mark.parametrize("mesh", [(12, 4), (10, 6), (30, 20)])
def test_load_volume_bitwise(mesh):
    for jc, tc in zip(_cases(jd), _cases(td)):
        want = np.asarray(jf.load_volume(jc.problem(*mesh)))
        got = tf.load_volume(tc.problem(*mesh))
        assert got.dtype == torch.float32
        assert got.shape == (4, mesh[1] + 1, mesh[0] + 1, 1)
        np.testing.assert_array_equal(got.numpy(), want)
    # the batched form, stacked: the reference's batched load volume
    np.testing.assert_array_equal(
        tf.load_volume_b(tf.stack_problems(
            [c.problem(*mesh) for c in _cases(td)], device="cpu")).numpy(),
        np.asarray(jf.load_volume_b(jf.stack_problems(
            [c.problem(*mesh) for c in _cases(jd)]))))


def test_load_case_round_trips_and_keys_match_reference():
    for jc, tc in zip(_cases(jd), _cases(td)):
        assert _same_case(jc, tc)
        # describe() dicts cross between the packages both ways
        assert _same_case(td.LoadCase.from_dict(jc.describe()), jc)
        assert _same_case(jd.LoadCase.from_dict(tc.describe()), tc)
        for mesh in ((12, 4), (10, 6)):
            jb = jd.LoadCase.from_problem(jc.problem(*mesh))
            tb = td.LoadCase.from_problem(tc.problem(*mesh))
            assert tb.kind == "harvest"
            assert tb.describe() == jb.describe() and tb.key() == jb.key()
    # the key rounds, so near-identical loads dedupe together
    a = td.LoadCase(load_frac=0.3, load=(0.1, -1.0))
    b = td.LoadCase(load_frac=0.30000001, load=(0.10000001, -1.0))
    assert a.key() == b.key() and a.key(ndigits=8) != b.key(ndigits=8)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("include_mbb", [True, False])
def test_sample_load_cases_bitwise(seed, include_mbb):
    kw = dict(seed=seed, include_mbb=include_mbb)
    want = jd.sample_load_cases(9, **kw)
    got = td.sample_load_cases(9, **kw)
    assert len(got) == 9 and (got[0].kind == "mbb") == include_mbb
    assert all(_same_case(a, b) for a, b in zip(want, got))
    got = td.sample_load_cases(4, max_angle_deg=20.0, mag_range=(1.0, 2.0),
                               **kw)
    want = jd.sample_load_cases(4, max_angle_deg=20.0, mag_range=(1.0, 2.0),
                                **kw)
    assert all(_same_case(a, b) for a, b in zip(want, got))


def test_window_trajectory_bitwise():
    rng = np.random.default_rng(3)
    hist = {"x": rng.random((9, 4, 12)), "u": rng.standard_normal((9, 130)),
            "c": rng.random(9)}
    for hist_len in (1, 3, 8):
        for a, b in zip(jd.window_trajectory(hist, hist_len),
                        td.window_trajectory(hist, hist_len)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def _synthetic(pkg, n_traj, seed, u_scale):
    """A dataset of ``n_traj`` trajectories of 1-4 windows each, numpy
    arrays from ``seed`` (the same arrays for either package)."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 5, size=n_traj)
    n = int(sizes.sum())
    cases = tuple(pkg.LoadCase(load_frac=float(f), kind="harvest")
                  for f in rng.random(n_traj))
    return pkg.TrajectoryDataset(
        load_vol=rng.random((n, 4, 5, 13, 1)).astype(np.float32),
        windows=rng.random((n, 3, 4, 12, 1)).astype(np.float32),
        targets=rng.standard_normal((n, 130)).astype(np.float32),
        u_scale=u_scale,
        traj_id=np.repeat(np.arange(n_traj, dtype=np.int32), sizes),
        cases=cases, ref={"c": rng.random(3)})


@pytest.mark.parametrize("n_traj", [1, 2, 3, 5, 8, 13])
def test_split_by_trajectory_bitwise(n_traj):
    for frac in (0.0, 0.1, 0.25, 0.5, 0.9):
        for seed in (0, 5):
            a = jd.split_by_trajectory(_synthetic(jd, n_traj, 1, 2.0),
                                       frac, seed)
            b = td.split_by_trajectory(_synthetic(td, n_traj, 1, 2.0),
                                       frac, seed)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
            assert 0 in b[0]


def test_concat_datasets_bitwise():
    ja, jb = _synthetic(jd, 3, 11, 7.5), _synthetic(jd, 2, 12, 3.25)
    ta, tb = _synthetic(td, 3, 11, 7.5), _synthetic(td, 2, 12, 3.25)
    for (x, y), (p, q) in (((ja, jb), (ta, tb)), ((jb, ja), (tb, ta))):
        want, got = jd.concat_datasets(x, y), td.concat_datasets(p, q)
        for field in ("load_vol", "windows", "targets", "traj_id"):
            w, g = getattr(want, field), getattr(got, field)
            assert w.dtype == g.dtype
            np.testing.assert_array_equal(w, g)
        assert got.u_scale == want.u_scale
        assert [c.describe() for c in got.cases] == \
            [c.describe() for c in want.cases]
        assert got.ref is p.ref
        assert got.n_trajectories == p.n_trajectories + q.n_trajectories
    with pytest.raises(ValueError, match="window shapes"):
        td.concat_datasets(ta, ta._replace(windows=ta.windows[:, :2]))


# --------------------------------------------------- SIMP trajectories


def _u_rel(a, b):
    return np.linalg.norm(a - b, axis=-1) / np.linalg.norm(a, axis=-1)


@pytest.mark.parametrize("n_before", [0, 3, 6])
def test_one_simp_step_from_shared_state(n_before):
    """One ``run_simp_b`` iteration of each package from the same state
    (the JAX trajectory after ``n_before`` iterations): U and compliance
    within 1e-3 relative, the new densities within 1e-3 absolute."""
    jcases, tcases = _cases(jd)[:3], _cases(td)[:3]
    jprobs = [c.problem(12, 4) for c in jcases]
    jbp = jf.stack_problems(jprobs)
    tbp = tf.stack_problems([c.problem(12, 4) for c in tcases], device="cpu")
    if n_before:
        hists = jd.run_simp_b(jprobs, n_iter=n_before)
        X = np.stack([h["x"][-1] for h in hists])
        U = np.stack([h["u"][-1] for h in hists])
    else:
        X = np.broadcast_to(np.asarray(jbp.volfrac)[:, None, None],
                            (3, 4, 12)).astype(np.float32)
        U = np.zeros((3, 130), np.float32)
    jX, jU, jc = (np.asarray(a) for a in
                  jd._make_simp_step_b(12, 4, 1.5)(jbp, X, U))
    tX, tU, tc = (a.numpy() for a in td._make_simp_step_b(12, 4, 1.5)(
        tbp, torch.from_numpy(np.array(X)), torch.from_numpy(np.array(U))))
    assert _u_rel(jU, tU).max() <= U_TOL
    np.testing.assert_allclose(tc, jc, rtol=C_TOL)
    np.testing.assert_allclose(tX, jX, rtol=0, atol=X_TOL)


def test_build_dataset_matches_reference():
    """A 3-case, 8-iteration ``build_dataset`` (MBB first, the sampler's
    seed-0 cases) in both packages: the cases, load volumes and
    trajectory ids bitwise, every (trajectory, iteration) within the
    bars above or counted as an OC-bisection flip (at most
    ``MAX_FLIPS``; the first flip ends the comparison of its
    trajectory, whose design has forked)."""
    want = jd.build_dataset(JCFG_S, n_cases=3, n_iter=8)
    got = td.build_dataset(TCFG_S, n_cases=3, n_iter=8, device="cpu")
    assert all(_same_case(a, b) for a, b in zip(want.cases, got.cases))
    np.testing.assert_array_equal(got.load_vol, want.load_vol)
    np.testing.assert_array_equal(got.traj_id, want.traj_id)
    assert got.windows.shape == want.windows.shape == (15, 3, 4, 12, 1)
    assert got.targets.shape == want.targets.shape == (15, 130)
    assert abs(got.u_scale - want.u_scale) <= C_TOL * want.u_scale
    flips = 0
    for t in range(3):
        wr, gr = want.rows_of(t), got.rows_of(t)
        np.testing.assert_array_equal(wr, gr)
        # window w holds the densities of iterations w..w+2 and its
        # target the displacement of iteration w+3: iterations 0-6 of X
        # and 3-7 of U
        wx = np.concatenate([want.windows[wr[0], :-1, ..., 0],
                             want.windows[wr, -1, ..., 0]])
        gx = np.concatenate([got.windows[gr[0], :-1, ..., 0],
                             got.windows[gr, -1, ..., 0]])
        wu = want.targets[wr] * want.u_scale
        gu = got.targets[gr] * got.u_scale
        for i in range(8):
            if i >= 3:
                assert _u_rel(wu[i - 3], gu[i - 3]) <= U_TOL, (t, i)
            if i < len(wx) and np.abs(gx[i] - wx[i]).max() > X_TOL:
                flips += 1
                break
    print(f"build_dataset: {flips} OC-bisection flips, windows within "
          f"{np.abs(got.windows - want.windows).max():.3g}")
    assert flips <= MAX_FLIPS, flips
    np.testing.assert_allclose(got.ref["c"], want.ref["c"], rtol=C_TOL)


def test_harvest_dataset_regenerates_like_the_reference():
    """Deduplication and newest-first truncation choose the same cases;
    the trajectories land on the bucket's mesh within the bars."""
    raw = [dict(jd.LoadCase(load_frac=f / 10, volfrac=0.4,
                            kind="harvest").describe())
           for f in (2, 3, 3, 5, 6)]
    want = jd.harvest_dataset(raw, (10, 4), cfg=JCFG_S, n_iter=7,
                              max_cases=3)
    got = td.harvest_dataset(raw, (10, 4), cfg=TCFG_S, n_iter=7,
                             max_cases=3, device="cpu")
    assert [c.describe() for c in got.cases] == \
        [c.describe() for c in want.cases]
    assert got.n_trajectories == 3 and got.windows.shape[2:] == (4, 10, 1)
    np.testing.assert_allclose(got.windows, want.windows, rtol=0,
                               atol=X_TOL)
    assert _u_rel(want.targets, got.targets * got.u_scale
                  / want.u_scale).max() <= U_TOL
    assert td.harvest_dataset([], (10, 4), cfg=TCFG_S, device="cpu") is None


def test_dataset_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.build_dataset(TCFG_S, n_cases=2, n_iter=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.run_simp_b([td.MBB_CASE.problem(12, 4)], n_iter=1)
    # the CPU, asked for, runs: the MBB case in a 1-wide batch
    (h,) = td.run_simp_b([td.MBB_CASE.problem(12, 4)], n_iter=2,
                         device="cpu")
    assert h["x"].shape == (2, 4, 12) and h["u"].shape == (2, 130)


def test_default_medium_dataset_turns_nan_in_both_packages():
    """A fault of the reference the port shares (ROADMAP §C): among the
    sampler's seed-0 cases, the default cases of ``build_dataset`` for
    CRONet medium, case 5 (load (-0.894, -0.844) at top node 26 of
    30x20) turns NaN at SIMP iteration 9 in both packages: fp32
    Jacobi-PCG stagnates at max_iter on iteration 8 and its residual
    overflows on iteration 9. The densities stay finite through
    iteration 8 in both. (The card's run turns at iteration 9 too;
    chip_smoke's flywheel phase reports it and trains on the finite
    trajectories.)"""
    jcase = jd.sample_load_cases(6, seed=0)[5]
    tcase = td.sample_load_cases(6, seed=0)[5]
    assert _same_case(jcase, tcase) and tcase.load_node(30) == (26, 0)
    first = {}
    # beside the MBB case: a batch of width 2, as in the dataset (XLA
    # lowers a width-1 batch differently, and its run stays finite)
    for name, hist in (
            ("jax", jd.run_simp_b([jcase.problem(30, 20),
                                   jd.MBB_CASE.problem(30, 20)],
                                  n_iter=10)[0]),
            ("torch", td.run_simp_b([tcase.problem(30, 20),
                                     td.MBB_CASE.problem(30, 20)],
                                    n_iter=10, device="cpu")[0])):
        bad = [i for i in range(10) if not np.all(np.isfinite(hist["x"][i]))]
        first[name] = bad[0] if bad else None
    assert first == {"jax": 9, "torch": 9}, first
