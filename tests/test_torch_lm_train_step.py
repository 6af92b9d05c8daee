"""Port parity for the LM train step: repro_torch.train.steps against
repro.train.steps on the CPU, in fp32 at ``reduce()``.

Both packages start from the JAX package's seed-0 weights
(``params_from_jax``) and take the port's numpy batch of B 2, S 32 (the
pipelines are bitwise equal, tests/test_torch_lm_train.py), at the
reference's smoke recipe (lr 1e-3, one warmup step, 10 total).

Bars. Every quantity is also measured against the reference's own fp32
error: the JAX step run again on float64 weights (its explicit fp32 casts
kept, ``jax.enable_x64``). At ``reduce()`` every "normal" weight is drawn
at std 1/sqrt(layers), so the layers amplify rounding: the reference's
own fp32 gradients part from float64 by up to 2.1e-4 of a leaf's max |g|
(granite-moe's token embedding; qwen's 1.0e-4), and deepseek's MTP block,
a one-layer stack at std 1, moves its loss by 1e-4 or more.
- loss, ce, aux, mtp: within 1e-4 of max(1, |value|) (deepseek's MTP
  loss at std 1 is ~1.3e3), or twice the reference's own error where that
  is larger; grad_norm the same relative to its value; lr within 1e-6
  relative.
- gradients, leaf by leaf: within 1e-4 of the leaf's max |g|, or four
  times the reference's own error on that leaf where that is larger.
  Measured: the port lies 0.4x-3.8x as far from float64 as the reference
  does (worst: granite-moe-3b-a800m's embedding gradient, which sums dL/dx
  of the repeated Zipf tokens after the backward pass through every
  layer); twice would not hold on qwen2.5 / qwen2 and granite-moe.
- mu and nu after the step: the same rule on each leaf.
- updated params: AdamW's first step moves each weight by about lr times
  the sign of its gradient. A weight whose gradient is at rounding level
  (within its leaf's gradient bar of zero) may move the other way, by up
  to 2 lr; those are counted and reported, and every other weight is held
  within 1e-4.
- moe: the routing is recorded in both packages (forward and the
  gradients' forward): no token's experts differ at these seeds.

This file takes the dense, vlm and audio configurations;
tests/test_torch_lm_train_step_moe.py the moe and recurrent ones, with
these helpers.

Then two microbatches and EF-int8 against the JAX step on granite-8b and
granite-moe-3b-a800m at the same bars, the returned error state included.
Under EF-int8 a gradient within its bar of an int8 code's half-way point
may round to the neighbouring code in the other package: those elements
are counted and held to one quantisation step, and the moments are
compared with each run's clip factor divided out (the flips move
grad_norm, by up to 8.7e-4 at granite-moe's 567 flips of 281,152).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import materialize as jmaterialize
from repro.configs.all import ASSIGNED
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import compress as JC
from repro.train import steps as JS
from repro_torch.common import params_from_jax, tree_leaves
from repro_torch.configs.base import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC
from repro_torch.train import steps as TS

from test_torch_lm_model import record_routes, route_flips

B, S = 2, 32
F32_ATOL = 1e-4
GRAD_REL = 1e-4
SPREAD_X = {"scalar": 2.0, "leaf": 4.0}
RECIPE = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@functools.lru_cache(maxsize=None)
def setup(name: str):
    jc = dataclasses.replace(jget_config(name).reduce(), dtype="float32")
    tc = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    jp = jmaterialize(JM.param_specs(jc), jax.random.key(0))
    return jc, tc, jp


def port_params(jp):
    return params_from_jax(jax.device_get(jp), device="cpu")


def configs(microbatches=1, compress=False):
    jtc = JS.TrainConfig(microbatches=microbatches,
                         compress_pod_grads=compress,
                         optimizer=JA.AdamWConfig(**RECIPE))
    ttc = TS.TrainConfig(microbatches=microbatches,
                         compress_pod_grads=compress,
                         optimizer=TA.AdamWConfig(**RECIPE))
    return jtc, ttc


def f64(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                        tree)


def flat(tree) -> dict:
    """path -> numpy leaf (float64), for either package's tree."""
    return {k: (v.double().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v).astype(np.float64))
            for k, v in tree_leaves(tree)}


def jax_runs(jc, jtc, jp, batch, error=None):
    """The JAX step (``make_train_step``) and the full batch's gradient in
    fp32, and the same arithmetic on float64 weights (``make_train_step``'s
    scan carries fp32 sums, so there the microbatches are summed here)."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.value_and_grad(lambda p, b: JS.loss_fn(jc, jtc, p, b),
                            has_aux=True)
    step = JS.make_train_step(jc, jtc)
    n = jtc.microbatches

    def step64(p, b, *extra):
        rows = [vg(p, jax.tree.map(lambda x: x.reshape(
            n, x.shape[0] // n, *x.shape[1:])[i], b)) for i in range(n)]
        grads = jax.tree.map(lambda *g: sum(g) / n, *[r[1] for r in rows])
        metrics = jax.tree.map(lambda *m: sum(m) / n,
                               *[{"loss": r[0][0], **r[0][1]} for r in rows])
        err = ()
        if extra:
            grads, e = JC.ef_compress_grads(grads, extra[0])
            err = (e,)
        p2, o2, om = JA.apply_updates(jtc.optimizer, p, grads,
                                      JA.init_state(jtc.optimizer, p))
        return (p2, o2, {**metrics, **om}) + err

    def both(fn):
        return jax.jit(lambda p, b, *extra: (
            fn(p, b, *extra), vg(p, b)[1]))

    extra = () if error is None else (error,)
    out, g = both(lambda p, b, *e: step(
        p, JA.init_state(jtc.optimizer, p), b, *e))(jp, jb, *extra)
    with jax.enable_x64(True):
        extra64 = () if error is None else (f64(error),)
        out64, g64 = jax.device_get(both(step64)(f64(jp), jb, *extra64))
    return out, g, out64, g64


def leaf_bar(want, want64) -> float:
    return max(GRAD_REL * float(np.abs(want).max()),
               SPREAD_X["leaf"] * float(np.abs(want - want64).max()))


def check_leaves(got: dict, want: dict, want64: dict, what: str,
                 skip=None) -> dict:
    """Hold every leaf (but the elements ``skip`` masks); return
    {path: bar}."""
    assert sorted(got) == sorted(want), what
    bars = {}
    for k in want:
        bars[k] = leaf_bar(want[k], want64[k])
        err = np.abs(got[k] - want[k])
        if skip is not None:
            err = err[~skip[k]]
        assert err.size == 0 or float(err.max()) <= bars[k], (
            what, k, float(err.max()), bars[k])
    return bars


def check_moments(got, want, want64, skip=None, norms=None):
    """mu at the gradients' rule, and sqrt(nu) too: after one step it is
    sqrt(1 - b2) |g| (nu itself doubles g's relative error). ``norms``:
    each run's grad_norm, whose clip factor is divided out first (EF-int8's
    flipped codes move grad_norm, and the clip scales every moment by
    it)."""
    runs = (got, want, want64)
    unclip = [1.0] * 3 if norms is None else [
        max(1.0, float(n) / TA.AdamWConfig().grad_clip) for n in norms]
    check_leaves(*({k: v * u for k, v in flat(t.mu).items()}
                   for t, u in zip(runs, unclip)), "mu", skip)
    check_leaves(*({k: np.sqrt(v) * u for k, v in flat(t.nu).items()}
                   for t, u in zip(runs, unclip)), "sqrt(nu)", skip)


def check_scalars(got: dict, want: dict, want64: dict, norm_extra=0.0):
    """``norm_extra``: what EF-int8's flipped codes may add to grad_norm's
    relative bar."""
    assert sorted(got) == sorted(want)
    for k in want:
        g, w, w64 = float(got[k]), float(want[k]), float(want64[k])
        if k == "lr":
            assert g == pytest.approx(w, rel=1e-6)
        elif k == "grad_norm":      # a function of the gradients: their rule
            bar = max(GRAD_REL, SPREAD_X["leaf"] * abs(w - w64) / abs(w))
            assert abs(g - w) / abs(w) <= bar + norm_extra, (k, g, w, w64)
        else:
            bar = max(F32_ATOL * max(1.0, abs(w)),
                      SPREAD_X["scalar"] * abs(w - w64))
            assert abs(g - w) <= bar, (k, g, w, w64)


def check_params(got: dict, want: dict, grads: dict, grad_bars: dict) -> int:
    """Weights whose gradient is at rounding level are counted; every other
    weight within 1e-4. Returns that count."""
    loose = 0
    for k in want:
        err = np.abs(got[k] - want[k])
        rounding = np.abs(grads[k]) <= grad_bars[k]
        loose += int((rounding & (err > F32_ATOL)).sum())
        held = err[~rounding]
        assert held.size == 0 or float(held.max()) <= F32_ATOL, (
            k, float(held.max()))
    return loose


DENSE = [n for n in ASSIGNED
         if jget_config(n).family in ("dense", "vlm", "audio")]


@pytest.mark.parametrize("name", DENSE)
def test_one_step_matches_reference_fp32(name, monkeypatch):
    one_step_matches_reference(name, monkeypatch)


def one_step_matches_reference(name, monkeypatch):
    jc, tc, jp = setup(name)
    jtc, ttc = configs()
    batch = TokenPipeline(tc, B, S).next_batch()
    rec = record_routes(monkeypatch)
    (jp2, jo2, jm), jg, (_, o64, m64), g64 = jax_runs(jc, jtc, jp, batch)
    tp = port_params(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tp2, to2, tm = TS.make_train_step(tc, ttc)(
        tp, TA.init_state(ttc.optimizer, tp), tb)
    (_, _), tg = TS._value_and_grad(tc, ttc, tp, tb)
    if tc.family == "moe":       # the routing of each package's first forward
        n = tc.num_layers - tc.num_dense_layers
        assert route_flips({k: v[:n] for k, v in rec.items()}) == 0
    assert isinstance(to2, TA.AdamWState) and int(to2.step) == 1
    check_scalars(tm, jm, m64)
    grads = flat(tg)
    bars = check_leaves(grads, flat(jg), flat(g64), "grad")
    check_moments(to2, jo2, o64)
    loose = check_params(flat(tp2), flat(jp2), flat(jg), bars)
    n = sum(v.size for v in grads.values())
    print(f"{name}: {loose} of {n} weights with a rounding-level gradient "
          f"moved apart by more than {F32_ATOL}")
    # nothing the step was given is written
    np.testing.assert_array_equal(flat(tp)["final_norm"],
                                  flat(jp)["final_norm"])


@pytest.mark.parametrize("name", ["granite-8b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("mode", ["microbatches2", "ef_int8"])
def test_microbatches_and_ef_int8_match_reference(name, mode, monkeypatch):
    jc, tc, jp = setup(name)
    mb, comp = (2, False) if mode == "microbatches2" else (1, True)
    jtc, ttc = configs(mb, comp)
    batch = TokenPipeline(tc, 2 * B, S, seed=1).next_batch()
    rec = record_routes(monkeypatch)
    tp = port_params(jp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    n_route = mb * (tc.num_layers - tc.num_dense_layers)
    # a carried error state drawn from numpy: the residuals of a step
    rng = np.random.default_rng(5)
    err_np = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in flat(jp).items()} if comp else None
    jerr = _nest(err_np, jnp.asarray) if comp else None
    out, jg, out64, jg64 = jax_runs(jc, jtc, jp, batch, jerr)
    terr = _nest(err_np, torch.from_numpy) if comp else None
    extra = (terr,) if comp else ()
    got = TS.make_train_step(tc, ttc)(
        tp, TA.init_state(ttc.optimizer, tp), tb, *extra)
    if tc.family == "moe":
        assert route_flips({k: v[:n_route] for k, v in rec.items()}) == 0
    if not comp:
        assert len(got) == 3
        check_scalars(got[2], out[2], out64[2])
        check_moments(got[1], out[1], out64[1])
        return
    # EF-int8: a gradient within its bar of a code's half-way point may
    # round to the neighbouring int8 code in the other package; its
    # residual then differs by one quantisation step (less the gradients'
    # own difference). Those elements are counted and held to one step;
    # the rest at the bars.
    assert len(got) == 4
    g, g64 = flat(jg), flat(jg64)
    steps = {k: np.abs(g[k] + err_np[k]).max() / 127.0 for k in g}
    e_got, e_want = flat(got[3]), flat(out[3])
    flips = {k: np.abs(e_got[k] - e_want[k]) > steps[k] / 2 for k in g}
    n_flips = sum(int(f.sum()) for f in flips.values())
    for k, f in flips.items():
        d = np.abs(e_got[k] - e_want[k])[f]
        assert d.size == 0 or np.abs(d - steps[k]).max() <= leaf_bar(
            g[k], g64[k]), (k, d[:5], steps[k])
    norm = float(out[2]["grad_norm"])
    deq = {k: g[k] + err_np[k] - e_want[k] for k in g}
    norm_extra = sum(float((2 * np.abs(deq[k][f]) * steps[k]
                            + steps[k] ** 2).sum())
                     for k, f in flips.items()) / (2 * norm ** 2)
    print(f"{name} EF-int8: {n_flips} of "
          f"{sum(f.size for f in flips.values())} int8 codes differ")
    check_scalars(got[2], out[2], out64[2], norm_extra)
    check_moments(got[1], out[1], out64[1], skip=flips,
                  norms=[m[2]["grad_norm"] for m in (got, out, out64)])
    check_leaves(e_got, e_want, flat(out64[3]), "error", skip=flips)


def _nest(flat_dict: dict, fn) -> dict:
    """A "/"-path dict as a nested dict of fn(leaf)."""
    out: dict = {}
    for path, v in flat_dict.items():
        node = out
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = fn(v)
    return out


def test_ef_int8_matches_reference_bitwise():
    """``ef_compress_grads`` on the same gradients and carried error: the
    dequantised gradients and the new error equal the JAX package's bit
    for bit (round half to even in both; the fp32 division by scale
    kept), in fp32 and for bf16 gradients."""
    rng = np.random.default_rng(0)
    g = {"a": (3 * rng.standard_normal((64, 33))).astype(np.float32),
         "b": {"c": rng.standard_normal(257).astype(np.float32)},
         "half": np.arange(-4, 5, dtype=np.float32) * 0.5}
    e = jax.tree.map(lambda a: (0.01 * rng.standard_normal(a.shape))
                     .astype(np.float32), g)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jd, je = JC.ef_compress_grads(
            jax.tree.map(lambda a: jnp.asarray(a, jdt), g),
            jax.tree.map(jnp.asarray, e))
        td, te = TC.ef_compress_grads(
            jax.tree.map(lambda a: torch.from_numpy(a).to(dt), g),
            jax.tree.map(torch.from_numpy, e))
        for k, v in tree_leaves(td):
            assert v.dtype == dt
            np.testing.assert_array_equal(
                v.float().numpy(), flat(jd)[k].astype(np.float32))
        for k, v in tree_leaves(te):
            np.testing.assert_array_equal(v.numpy(),
                                          flat(je)[k].astype(np.float32))
