"""The port's training stack (core.cronet's batched forward,
optim.adamw, fea.train_cronet) against the JAX package's, on the CPU, at
a 12x4 mesh with a 3-step history in fp32.

The JAX weights cross with ``params_from_jax``; data are numpy arrays that
both packages read unchanged. Tolerances sit beside each assert:
  * the batched forward 1e-4 against JAX's ``invariant=False`` forward
    (the serving bar) and 1e-5 against the port's per-slot forward;
  * the loss gradient per leaf within 1e-4 of the leaf's norm;
  * ``apply_updates`` 1e-6 relative (plus 1e-9 absolute) on identical
    gradients, through warmup, clipping and the cosine tail;
  * five training steps: losses within 1e-4 relative;
  * ``evaluate``: eval MSE within 1e-3 relative, acceptance flips
    counted, and only where a window's error sits at the threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
from repro.common import materialize
from repro.configs.cronet import CRONetConfig as JCFG
from repro.core import cronet as jcronet
from repro.fea import dataset as jd
from repro.fea import train_cronet as jt
from repro.optim import adamw as ja
from repro_torch.checkpoint import manager as tckpt
from repro_torch.common import init_params, params_from_jax
from repro_torch.configs.cronet import CRONetConfig as TCFG
from repro_torch.core import cronet as tcronet
from repro_torch.fea import dataset as td
from repro_torch.fea import train_cronet as tt
from repro_torch.kernels import ref
from repro_torch.optim import adamw as ta
from repro_torch.serve import ModelRegistry

JCFG_S = JCFG(nelx=12, nely=4, hist_len=3, dtype="float32")
TCFG_S = TCFG(nelx=12, nely=4, hist_len=3, dtype="float32")
FWD_TOL = 1e-4        # vs JAX's batched forward
SLOT_TOL = 1e-5       # vs the port's per-slot forward
GRAD_TOL = 1e-4       # per leaf, relative to the leaf's norm
ADAM_RTOL, ADAM_ATOL = 1e-6, 1e-9
LOSS_TOL = 1e-4       # five steps, relative
EVAL_TOL = 1e-3       # eval_mse, relative


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(materialize(jcronet.param_specs(JCFG_S),
                                      jax.random.key(0)))


@pytest.fixture(scope="module")
def jdata():
    """4 load cases, 10 SIMP iterations: 28 windows, MBB first."""
    return jd.build_dataset(JCFG_S, n_cases=4, n_iter=10)


def _batch(seed, B=4, plateaus=False):
    rng = np.random.default_rng(seed)
    lv = np.stack([np.asarray(jd.fea2d.load_volume(c.problem(12, 4)))
                   for c in jd.sample_load_cases(B, seed=seed)])
    if plateaus:
        # clipped histories as training makes them (train_cronet's noise
        # then np.clip to [0.001, 1]): solid and void plateaus, so the
        # branch's max pool sees tied windows
        hist = np.clip(rng.normal(0.5, 2.0, (B, 3, 4, 12, 1)), 0.001, 1.0)
        hist[:, :, :, :6] = 1.0
        hist[:, :, :, 8:] = 0.001
    else:
        hist = rng.random((B, 3, 4, 12, 1))
    tgt = rng.standard_normal((B, 130)) * 0.3
    return (lv.astype(np.float32), hist.astype(np.float32),
            tgt.astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("B", [1, 3, 8])
def test_batched_forward_matches_jax_and_per_slot(jparams, B):
    lv, hist, _ = _batch(B, B=B)
    want = np.asarray(jcronet.forward(JCFG_S, jparams, jnp.asarray(lv),
                                      jnp.asarray(hist), invariant=False))
    tp = params_from_jax(jparams, device="cpu")
    got = tcronet.forward(TCFG_S, tp, *_t(lv, hist), invariant=False)
    slot = tcronet.forward(TCFG_S, tp, *_t(lv, hist))
    print(f"B={B}: vs JAX {np.abs(got.numpy() - want).max():.3g}, vs per "
          f"slot {np.abs(got.numpy() - slot.numpy()).max():.3g}")
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(got.numpy(), slot.numpy(), rtol=SLOT_TOL,
                               atol=SLOT_TOL)
    # the tie-splitting pool gives F.max_pool2d's values, bit for bit
    x = torch.from_numpy(np.clip(hist[:, 0], 0.3, 0.6))
    assert torch.equal(tcronet.maxpool2d_ties(x), ref.maxpool2d(x))


def _jloss(p, lv, hist, tgt):
    pred = jcronet.forward(JCFG_S, p, lv, hist, invariant=False)
    u = jcronet.decode_to_dofs(JCFG_S, pred)
    return jnp.mean(jnp.square(u - tgt))


@pytest.mark.parametrize("plateaus", [False, True])
def test_loss_gradient_matches_jax_grad(jparams, plateaus):
    """Every leaf's gradient within 1e-4 of that leaf's norm, also on
    clipped histories with plateaus, where the max pool sees ties. There
    the weight gradients do not depend on how ties split (tied windows
    share their receptive field); the gradient on the history does, so
    it is checked too: the tie-splitting pool matches ``jnp.max``'s
    even split and ``F.max_pool2d``'s one-index rule does not."""
    lv, hist, tgt = _batch(11, plateaus=plateaus)
    jl, jg = jax.value_and_grad(_jloss)(jparams, jnp.asarray(lv),
                                        jnp.asarray(hist), jnp.asarray(tgt))
    tp = params_from_jax(jparams, device="cpu")
    tl, tg = tt.loss_and_grad(TCFG_S, tp, *_t(lv, hist, tgt))
    assert abs(float(tl) - float(jl)) <= GRAD_TOL * float(jl)
    worst = 0.0
    for part in jg:
        for k, g in jg[part].items():
            g = np.asarray(g)
            err = np.linalg.norm(tg[part][k].numpy() - g)
            worst = max(worst, err / np.linalg.norm(g))
            assert err <= GRAD_TOL * np.linalg.norm(g), (part, k, err)
    # the caller's tensors stay leaves without gradients
    assert all(not t.requires_grad for w in tp.values() for t in w.values())

    jh = np.asarray(jax.grad(_jloss, argnums=2)(
        jparams, jnp.asarray(lv), jnp.asarray(hist), jnp.asarray(tgt)))

    def hist_grad():
        h = torch.from_numpy(hist).requires_grad_(True)
        loss = tt.loss_fn(TCFG_S, tp, torch.from_numpy(lv), h,
                          torch.from_numpy(tgt))
        return torch.autograd.grad(loss, h)[0].numpy()

    rel = np.linalg.norm(hist_grad() - jh) / np.linalg.norm(jh)
    print(f"plateaus={plateaus}: worst leaf {worst:.3g}, history {rel:.3g}")
    assert rel <= GRAD_TOL, rel
    if plateaus:
        orig = tcronet.maxpool2d_ties
        tcronet.maxpool2d_ties = lambda x, k=2: ref.maxpool2d(x, k)
        try:
            one_index = hist_grad()
        finally:
            tcronet.maxpool2d_ties = orig
        parted = np.linalg.norm(one_index - jh) / np.linalg.norm(jh)
        print(f"history gradient with F.max_pool2d: {parted:.3g}")
        assert parted > 100 * GRAD_TOL


@pytest.mark.parametrize("master_fp32", [False, True])
def test_apply_updates_matches_jax(master_fp32):
    """30 steps on identical numpy gradients: 5 of warmup, gradients
    both above and below the clip, the cosine tail to ``min_lr_frac``
    and weight decay. Params, moments and metrics within 1e-6 relative
    (1e-9 absolute) at every step."""
    cfg_kw = dict(lr=1e-2, warmup_steps=5, total_steps=30, grad_clip=1.0,
                  weight_decay=0.05, min_lr_frac=0.1, master_fp32=master_fp32)
    jcfg, tcfg = ja.AdamWConfig(**cfg_kw), ta.AdamWConfig(**cfg_kw)
    rng = np.random.default_rng(4)
    shapes = {"b": {"w": (3, 5), "a": (7,)}, "a": {"z": (2, 2, 2)}}
    p0 = {g: {k: rng.standard_normal(s).astype(np.float32)
              for k, s in leaves.items()} for g, leaves in shapes.items()}
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {g: {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
          for g, leaves in p0.items()}
    js, tsn = ja.init_state(jcfg, jp), ta.init_state(tcfg, tp)
    clipped = 0
    for i in range(30):
        scale = 3.0 if i % 3 == 0 else 0.05      # above / below the clip
        g = {gr: {k: (rng.standard_normal(s) * scale).astype(np.float32)
                  for k, s in leaves.items()} for gr, leaves in shapes.items()}
        jp, js, jm = ja.apply_updates(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                      js)
        tg = {gr: {k: torch.from_numpy(v) for k, v in w.items()}
              for gr, w in g.items()}
        tp, tsn, tm = ta.apply_updates(tcfg, tp, tg, tsn)
        clipped += float(jm["grad_norm"]) > 1.0
        assert int(tsn.step) == int(js.step) == i + 1
        for name in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=ADAM_RTOL)
        for tree_j, tree_t in ((jp, tp), (js.mu, tsn.mu), (js.nu, tsn.nu)):
            for gr in shapes:
                for k in shapes[gr]:
                    np.testing.assert_allclose(
                        tree_t[gr][k].numpy(), np.asarray(tree_j[gr][k]),
                        rtol=ADAM_RTOL, atol=ADAM_ATOL)
    assert 0 < clipped < 30
    print(f"AdamW: {clipped} of 30 steps clipped")
    # the schedule at its corners: warmup, peak, the floor at the end
    for step in (0, 1, 5, 17, 30, 45):
        np.testing.assert_allclose(float(ta.schedule(tcfg, step)),
                                   float(ja.schedule(jcfg, jnp.int32(step))),
                                   rtol=ADAM_RTOL)
    # the leaves are walked in sorted key order, as jax.tree.leaves does
    assert [t.shape for t in ta.leaves(tp)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]


def _tdata(jdata):
    """The JAX dataset as the port's: the same numpy arrays."""
    return td.TrajectoryDataset(*jdata)._replace(cases=tuple(
        td.LoadCase.from_dict(c.describe()) for c in jdata.cases))


def test_five_training_steps_match_jax(jparams, jdata):
    """The same initial weights and data, seed 0: the same minibatches
    and noise in both packages, losses within 1e-4 relative."""
    kw = dict(steps=5, batch=4, seed=0, verbose=False)
    want = jt.train(JCFG_S, data=jdata, init_params=jparams, **kw)
    got = tt.train(TCFG_S, data=_tdata(jdata),
                   init_params=params_from_jax(jparams, device="cpu"),
                   device="cpu", **kw)
    rel = np.abs(np.subtract(got.losses, want.losses)) / np.abs(want.losses)
    print(f"five steps: loss rel err max {rel.max():.3g}")
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_TOL)
    np.testing.assert_array_equal(got.heldout_traj, want.heldout_traj)
    assert got.u_scale == want.u_scale and len(got.step_s) == 5
    for part in want.params:
        for k, w in want.params[part].items():
            w = np.asarray(w)
            assert np.linalg.norm(got.params[part][k].numpy() - w) <= \
                1e-3 * np.linalg.norm(w), (part, k)


def test_evaluate_matches_jax(jparams, jdata):
    """Per-window errors at a threshold set at the JAX errors' median,
    so about half the windows are accepted: eval MSE and mean relative
    error within 1e-3 relative in every case; acceptance flips are
    counted per case and allowed only for windows whose JAX error lies
    within 1e-4 (relative) of the threshold."""
    fn = jt._make_eval_fn(JCFG_S)
    _, errs = fn(jparams, jnp.asarray(jdata.load_vol),
                 jnp.asarray(jdata.windows), jnp.asarray(jdata.targets))
    errs = np.asarray(errs)
    thr = float(np.median(errs))
    at_edge = int(np.sum(np.abs(errs - thr) <= 1e-4 * thr))
    want = jt.evaluate(JCFG_S, jparams, jdata, error_threshold=thr, chunk=8)
    got = tt.evaluate(TCFG_S, params_from_jax(jparams, device="cpu"),
                      _tdata(jdata), error_threshold=thr, chunk=8)
    assert 0.2 < want["acceptance"] < 0.8
    flips = 0
    assert set(got["per_case"]) == set(want["per_case"])
    for name, w in want["per_case"].items():
        g = got["per_case"][name]
        assert g["windows"] == w["windows"] and g["case"] == w["case"]
        for key in ("eval_mse", "mean_rel_err"):
            np.testing.assert_allclose(g[key], w[key], rtol=EVAL_TOL)
        flips += round(abs(g["acceptance"] - w["acceptance"]) * w["windows"])
    print(f"evaluate: {flips} acceptance flips, {at_edge} windows at the "
          f"threshold")
    assert flips <= at_edge, (flips, at_edge)
    np.testing.assert_allclose(got["eval_mse"], want["eval_mse"],
                               rtol=EVAL_TOL)


def test_legacy_five_tuple_path():
    data = tt.build_dataset(TCFG_S, n_iter=6, device="cpu")
    load_vol, windows, targets, u_scale, hist = data
    assert load_vol.shape == (1, 4, 5, 13, 1) and windows.shape[0] == 3
    assert np.abs(targets).max() == pytest.approx(1.0)
    res = tt.train(TCFG_S, steps=3, batch=2, data=data, verbose=False,
                   device="cpu")
    params, us, losses, ref_hist = res          # the legacy 4-tuple
    assert us == u_scale and ref_hist is hist and len(losses) == 3
    assert np.all(np.isfinite(losses))
    assert res.cases == (td.MBB_CASE,) and len(res.heldout_traj) == 0
    assert res.eval_metrics["heldout"] is False


def test_zero_steps_is_a_bitwise_warm_start_on_fresh_tensors():
    base = init_params(TCFG_S, seed=3, device="cpu")
    data = td.build_dataset(TCFG_S, n_cases=2, n_iter=5, device="cpu")
    res = tt.train(TCFG_S, steps=0, data=data, init_params=base,
                   verbose=False, device="cpu")
    for part in base:
        for k, w in base[part].items():
            assert torch.equal(res.params[part][k], w)
            assert res.params[part][k].data_ptr() != w.data_ptr()
    assert res.losses == [] and np.isfinite(res.eval_metrics["eval_mse"])


def test_train_and_register_loads_bitwise_in_the_jax_registry(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    data = td.build_dataset(TCFG_S, n_cases=2, n_iter=5, device="cpu")
    rec, res = tt.train_and_register(
        TCFG_S, reg, tag="v1", steps=3, batch=2, data=data, verbose=False,
        device="cpu", ckpt_dir=str(tmp_path / "ckpt"))
    assert rec.tag == "v1" and rec.u_scale == res.u_scale
    jparams, jrec = jserve.ModelRegistry(str(tmp_path / "reg")).load("v1")
    assert jrec.load_cases == [c.describe() for c in data.cases]
    assert jrec.metrics["eval_mse"] == res.eval_metrics["eval_mse"]
    for part in res.params:
        for k, w in res.params[part].items():
            np.testing.assert_array_equal(np.asarray(jparams[part][k]),
                                          w.numpy())
    # ckpt_dir= saves the same tree through the port's checkpoint manager
    tree, extras = tckpt.restore(str(tmp_path / "ckpt"),
                                 {"params": res.params}, device="cpu")
    assert extras["u_scale"] == res.u_scale
    assert all(torch.equal(tree["params"][p][k], w)
               for p, ws in res.params.items() for k, w in ws.items())


class _LiveRegistry:
    """A registry whose ``load`` hands out one live tree, as a
    ``ModelResolver`` cache or a serving engine holds it."""

    def __init__(self, reg, tag):
        self.reg = reg
        self.live = reg.load(tag, device="cpu")

    def load(self, tag, device="cuda"):
        return self.live

    def __getattr__(self, name):
        return getattr(self.reg, name)


def test_finetune_from_tag_lineage_replay_and_base_untouched(tmp_path):
    reg = ModelRegistry(str(tmp_path / "reg"))
    base = init_params(TCFG_S, seed=7, device="cpu", dtype="float32")
    reg.register(base, TCFG_S, 50.0, tag="base",
                 load_cases=[td.LoadCase(load_frac=0.4).describe(),
                             td.MBB_CASE.describe()])
    harvested = td.harvest_dataset(
        [td.LoadCase(load_frac=0.25, volfrac=0.4, kind="harvest"),
         td.LoadCase(load_frac=0.6, load=(0.3, -0.8), kind="harvest")],
        (10, 4), cfg=TCFG_S, n_iter=7, device="cpu")
    live = _LiveRegistry(reg, "base")
    snapshot = {p: {k: w.clone() for k, w in ws.items()}
                for p, ws in live.live[0].items()}
    record, result = tt.finetune_from_tag(
        live, "base", (10, 4), harvested, steps=2, replay_cases=1,
        replay_n_iter=7, device="cpu")
    # the live base tree is bitwise what it was: train copied it
    assert all(torch.equal(live.live[0][p][k], w)
               for p, ws in snapshot.items() for k, w in ws.items())
    assert any(not torch.equal(result.params[p][k], w)
               for p, ws in snapshot.items() for k, w in ws.items())
    # 2 harvested trajectories + 1 replayed from the base's cases
    assert [c.kind for c in result.cases] == ["harvest", "harvest", "point"]
    assert record.tag == "base-ft10x4" and record.parent == "base"
    assert record.mesh == (10, 4) and record.cfg.nelx == 10
    assert record.metrics["finetuned_from"] == "base"
    assert record.metrics["harvested_trajectories"] == 2
    assert reg.latest(mesh=(10, 4)).tag == "base-ft10x4"
    assert reg.latest().tag == "base"
    record2, _ = tt.finetune_from_tag(reg, "base", (10, 4), harvested,
                                      steps=0, replay_cases=0, device="cpu")
    assert record2.tag == "base-ft10x4.2"
    with pytest.raises(ValueError, match="non-empty harvested"):
        tt.finetune_from_tag(reg, "base", (10, 4), None, device="cpu")


def test_training_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    data = td.build_dataset(TCFG_S, n_cases=2, n_iter=5, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.train(TCFG_S, steps=1, data=data, verbose=False)
