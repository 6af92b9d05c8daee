"""Port parity for the recurrent blocks: repro_torch.models.recurrent
against repro.models.recurrent on the CPU.

Each block gets the same numpy-seeded inputs and the JAX package's seed-0
weights (``params_from_jax``), at ``reduce()`` widths and at one wider
case, with and without a carried state. Tolerances:

- ``_causal_conv1d`` in bf16: bitwise. The reference sums its taps with
  a Python ``sum``, so every product and partial sum rounds to bf16; an
  fp32-accumulating stand-in (``F.conv1d``, one rounding) must fail.
- fp32: within 1e-4 of max(1, max |out|) (1e-4 absolute on O(1)
  values, as for the logits), or twice the reference's own fp32 error
  where that is larger: the JAX block run again on float64 weights and
  inputs (its explicit fp32 casts kept), measured in each test. At
  ``reduce()``'s init scale (every "normal" weight at std 1, since
  ``fan_in = shape[0]`` is the layer count) the blocks' outputs reach
  1e3-1e4, where an fp32 ulp is 6e-5 to 1e-3, and the exponential gates
  amplify rounding: that spread is 1e-4 to 2 in absolute terms (up to
  1e-4 of max |out|). The port's error against the JAX fp32 run is
  bounded by its own and the reference's, each within that spread.
- bf16: within 2^-6 of max |out|, the layer bar of
  tests/test_torch_lm_layers.py. The mLSTM holds it only with
  ``jax.nn.silu``'s bf16 expansion (``_silu``): ``F.silu`` stands in and
  fails.

Stand-ins that must fail: the fp32-accumulating conv, the sLSTM without
the per-head gate transpose, ``F.silu`` in the bf16 mLSTM.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.common import materialize as jmaterialize
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.models import recurrent as JR
from repro_torch.common import params_from_jax
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR

F32_ATOL = 1e-4
BF16_REL = 2.0 ** -6
# reduce() and one wider case (mLSTM heads of 128, an LRU of 256)
WIDTHS = {"reduce": {}, "wide": {"d_model": 256, "lru_width": 256}}
# layers of each kind in the full models: recurrentgemma-2b's superblocks
# stack 8 of each pattern slot; xlstm-1.3b has 6 sLSTM and 42 mLSTM
FULL_LAYERS = {"rglru": 8, "mlstm": 42, "slstm": 6}
BLOCKS = {"rglru": ("recurrentgemma-2b", "rglru_specs", "apply_rglru_block"),
          "mlstm": ("xlstm-1.3b", "mlstm_specs", "apply_mlstm_block"),
          "slstm": ("xlstm-1.3b", "slstm_specs", "apply_slstm_block")}


def cfgs(name: str, dtype: str, width: str = "reduce"):
    over = dict(WIDTHS[width], dtype=dtype)
    if "lru_width" in over and not get_config(name).lru_width:
        over.pop("lru_width")
    return (dataclasses.replace(jget_config(name).reduce(), **over),
            dataclasses.replace(get_config(name).reduce(), **over))


def block(kind: str, dtype: str, width: str = "reduce"):
    """(jax cfg, port cfg, jax fn, port fn, jax params, port params) of one
    layer of ``kind``: the JAX package's seed-0 draw of one layer, carried
    over. At ``reduce()`` a one-layer stack (std 1 for every "normal"
    leaf); the wide case at the full model's layer scale (std
    1/sqrt(n), n the full model's layers of that kind)."""
    name, specs, apply = BLOCKS[kind]
    jc, tc = cfgs(name, dtype, width)
    spec = getattr(JR, specs)(jc, 1)
    if width == "wide":
        n = FULL_LAYERS[kind]
        spec = jax.tree.map(
            lambda sp: dataclasses.replace(sp, init=("scaled", n))
            if sp.init == "normal" else sp, spec,
            is_leaf=lambda sp: hasattr(sp, "init"))
    jp = jax.tree.map(lambda a: a[0], jmaterialize(spec, jax.random.key(0)))
    return (jc, tc, getattr(JR, apply), getattr(TR, apply), jp,
            params_from_jax(jax.device_get(jp), device="cpu"))


def inputs(cfg, s: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)


def state_for(kind: str, cfg, seed: int = 1) -> dict:
    """A carried state of the block's keys: numpy draws of its shapes (the
    conv state in the configuration's dtype, the rest fp32)."""
    rng = np.random.default_rng(seed)
    b, k = 2, cfg.conv1d_width
    if kind == "rglru":
        shapes = {"h": (b, cfg.lru_width), "conv": (b, k - 1, cfg.lru_width)}
    elif kind == "mlstm":
        h, dh = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
        shapes = {"C": (b, h, dh, dh), "n": (b, h, dh), "m": (b, h),
                  "conv": (b, k - 1, 2 * cfg.d_model)}
    else:
        shapes = {key: (b, cfg.d_model) for key in ("h", "c", "n", "m")}
    return {key: rng.standard_normal(s).astype(np.float32)
            for key, s in shapes.items()}


def jax_state(st, cfg, dtype=None):
    return {k: jnp.asarray(v, dtype or (cfg.jnp_dtype if k == "conv"
                                        else jnp.float32))
            for k, v in st.items()}


def torch_state(st, cfg):
    return {k: torch.from_numpy(v.copy()).to(
        cfg.torch_dtype if k == "conv" else torch.float32)
        for k, v in st.items()}


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def reference_f64(fn, jc, jp, x, st):
    """The JAX block on float64 weights, input and state (its own fp32
    casts kept): the reference's fp32 spread is its fp32 run against
    this."""
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(
            a.astype(jnp.float32)), jnp.float64), jp)
        s64 = None if st is None else jax_state(st, jc, jnp.float64)
        out, nst = fn(jc, p64, jnp.asarray(x, jnp.float64), state=s64)
        return (np.asarray(out),
                None if nst is None else {k: np.asarray(v)
                                          for k, v in nst.items()})


def run_both(kind, dtype, s, with_state, width="reduce"):
    jc, tc, jfn, tfn, jp, tp = block(kind, dtype, width)
    x = inputs(jc, s)
    st = state_for(kind, jc) if with_state else None
    jx = jnp.asarray(x, jc.jnp_dtype)
    want, jst = jfn(jc, jp, jx, state=None if st is None else
                    jax_state(st, jc))
    got, tst = tfn(tc, tp, torch.from_numpy(x).to(tc.torch_dtype),
                   state=None if st is None else torch_state(st, tc))
    return (jc, tc, jp, tp, x, st), (want, jst), (got, tst)


def assert_fp32_close(got, want, want64, what=""):
    """|port - JAX fp32| within 1e-4 of max(1, max |out|) or twice the
    reference's own fp32 spread against float64, whichever is larger."""
    got, want = as_np(got), as_np(want)
    spread = float(np.abs(want - want64).max())
    err = float(np.abs(got - want).max())
    scale = max(1.0, float(np.abs(want64).max()))
    assert err <= max(F32_ATOL * scale, 2 * spread), (what, err, spread,
                                                      scale)
    return err, spread


def assert_bf16_close(got, want, what=""):
    got, want = as_np(got), as_np(want)
    bar = BF16_REL * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= bar, (what, err, bar)


# ---------------------------------------------------------------------------
# The causal conv: bitwise in bf16
# ---------------------------------------------------------------------------


def conv_stand_in(x, w, b, state=None):
    """F.conv1d: one fp32 sum of the K taps, rounded once."""
    k = w.shape[0]
    pad = (torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype)
           if state is None else state)
    xp = torch.cat([pad, x], dim=1)
    out = F.conv1d(xp.float().transpose(1, 2), w.float().T[:, None, :],
                   groups=x.shape[2]).transpose(1, 2)
    return (out + b.float()).to(x.dtype), xp[:, -(k - 1):]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("width", [64, 2560])
def test_causal_conv1d_is_bitwise_in_bf16(width, with_state):
    """The taps summed one product at a time in bf16 give the reference's
    bits, output and new state; F.conv1d's fp32 sum does not."""
    rng = np.random.default_rng(width)
    x = rng.standard_normal((2, 16, width)).astype(np.float32) * 4
    w = rng.standard_normal((4, width)).astype(np.float32)
    b = rng.standard_normal(width).astype(np.float32)
    st = (rng.standard_normal((2, 3, width)).astype(np.float32)
          if with_state else None)
    bf = jnp.bfloat16
    want, wst = JR._causal_conv1d(jnp.asarray(x, bf), jnp.asarray(w, bf),
                                  jnp.asarray(b, bf),
                                  None if st is None else jnp.asarray(st, bf))
    tb = [None if a is None else torch.from_numpy(a).bfloat16()
          for a in (x, w, b, st)]
    got, gst = TR._causal_conv1d(*tb)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(as_np(got), as_np(want))
    assert np.array_equal(as_np(gst), as_np(wst))
    bad, _ = conv_stand_in(*tb)
    assert (as_np(bad) != as_np(want)).sum() > 0.05 * bad.numel()


def test_causal_conv1d_fp32_and_one_tap_state():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal((4, 32)).astype(np.float32)
    b = rng.standard_normal(32).astype(np.float32)
    want, wst = JR._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  jnp.asarray(b))
    got, gst = TR._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b))
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(as_np(gst), x[:, -3:])
    _, none = TR._causal_conv1d(torch.from_numpy(x),
                                torch.from_numpy(w[:1]), torch.from_numpy(b))
    assert none is None


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def test_rglru_core_matches_associative_scan_at_1024():
    """The doubling scan against lax.associative_scan's result and a
    float64 sequential loop, S 1024, W 256, with a carried h0."""
    rng = np.random.default_rng(4)
    b, s, w = 2, 1024, 256
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    r = 1 / (1 + np.exp(-rng.standard_normal((b, s, w)))).astype(np.float32)
    i = 1 / (1 + np.exp(-rng.standard_normal((b, s, w)))).astype(np.float32)
    lam = rng.uniform(-1, 1, w).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    want, wlast = JR._rglru_core(*map(jnp.asarray, (x, r, i, lam, h0)))
    got, glast = TR._rglru_core(*map(torch.from_numpy, (x, r, i, lam, h0)))
    np.testing.assert_allclose(as_np(got), as_np(want), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(as_np(glast), as_np(got)[:, -1])
    # float64 sequential loop
    log_a = -8.0 * np.log1p(np.exp(lam.astype(np.float64)))[None, None] * r
    a = np.exp(log_a)
    g = np.sqrt(np.maximum(1 - np.exp(2 * log_a), 1e-12)) * (i * x)
    h, ys = h0.astype(np.float64), []
    for t in range(s):
        h = a[:, t] * h + g[:, t]
        ys.append(h)
    ref = np.stack(ys, 1)
    assert np.abs(as_np(got) - ref).max() <= 1e-5 * np.abs(ref).max()
    assert np.abs(as_np(want) - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 8, 128])
def test_rglru_block_matches_reference_fp32(s, with_state, width):
    (jc, _, jp, _, x, st), (want, jst), (got, tst) = run_both(
        "rglru", "float32", s, with_state, width)
    want64, jst64 = reference_f64(JR.apply_rglru_block, jc, jp, x, st)
    assert_fp32_close(got, want, want64, "out")
    if with_state:
        for key in ("h", "conv"):
            assert_fp32_close(tst[key], jst[key], jst64[key], key)
    else:
        assert tst is None


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_block_matches_reference_bf16(with_state):
    _, (want, jst), (got, tst) = run_both("rglru", "bfloat16", 32,
                                          with_state)
    assert got.dtype == torch.bfloat16
    assert_bf16_close(got, want, "out")
    if with_state:
        assert tst["h"].dtype == torch.float32
        assert tst["conv"].dtype == torch.bfloat16
        np.testing.assert_array_equal(as_np(tst["conv"]), as_np(jst["conv"]))
        assert_bf16_close(tst["h"], jst["h"], "h")


# ---------------------------------------------------------------------------
# mLSTM: the sequential scan and the chunkwise form
# ---------------------------------------------------------------------------


def count_forms(monkeypatch) -> dict:
    calls = {"chunkwise": 0, "sequential": 0}
    for form in calls:
        fn = getattr(TR, f"_mlstm_{form}")

        def counting(*a, fn=fn, form=form):
            calls[form] += 1
            return fn(*a)

        monkeypatch.setattr(TR, f"_mlstm_{form}", counting)
    return calls


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s,width", [(1, "reduce"), (32, "reduce"),
                                     (64, "reduce"), (128, "reduce"),
                                     (192, "reduce"), (1, "wide"),
                                     (64, "wide"), (128, "wide")])
def test_mlstm_block_matches_reference_fp32(s, width, with_state,
                                            monkeypatch):
    """S 1, 32 and 64 take the sequential scan (the rule is S % 64 == 0
    and S > 64), 128 and 192 the chunkwise form, as in the reference;
    output and every state leaf held."""
    forms = count_forms(monkeypatch)
    (jc, _, jp, _, x, st), (want, jst), (got, tst) = run_both(
        "mlstm", "float32", s, with_state, width)
    chunked = s % 64 == 0 and s > 64
    assert forms == {"chunkwise": int(chunked), "sequential": int(not chunked)}
    want64, jst64 = reference_f64(JR.apply_mlstm_block, jc, jp, x, st)
    assert_fp32_close(got, want, want64, "out")
    if with_state:
        for key in ("C", "n", "m", "conv"):
            assert_fp32_close(tst[key], jst[key], jst64[key], key)


@pytest.mark.parametrize("s", [8, 64, 128])
def test_mlstm_block_matches_reference_bf16(s, monkeypatch):
    """Within 2^-6 of max |out| with jax.nn.silu's bf16 expansion; with
    F.silu (one rounding) the exponential gates carry the ulp to a large
    fraction of max |out| at S 64."""
    _, (want, _), (got, _) = run_both("mlstm", "bfloat16", s, True)
    assert_bf16_close(got, want, "out")
    if s == 64:
        monkeypatch.setattr(TR, "_silu", F.silu)
        _, (want, _), (bad, _) = run_both("mlstm", "bfloat16", s, True)
        with pytest.raises(AssertionError):
            assert_bf16_close(bad, want, "F.silu stand-in")


def test_mlstm_state_updated_in_place():
    """A given C is the returned C (the cache's tensor, written in place)
    in both forms; n, m and conv come back new."""
    jc, tc, _, tfn, _, tp = block("mlstm", "float32")
    for s in (3, 128):
        st = torch_state(state_for("mlstm", jc), tc)
        before = {k: v.clone() for k, v in st.items()}
        _, nst = tfn(tc, tp, torch.from_numpy(inputs(jc, s)), state=st)
        assert nst["C"] is st["C"] and not torch.equal(st["C"], before["C"])
        assert all(nst[k] is not st[k] and torch.equal(st[k], before[k])
                   for k in ("n", "m", "conv"))


def test_mlstm_chunkwise_matches_sequential_at_dh_1024():
    """The two forms on the same q, k, v and gates at xlstm-1.3b's head
    width (dh 1024, one head), S 128, from a carried state: within 1e-4
    of max |h|."""
    rng = np.random.default_rng(5)
    b, s, h, dh = 1, 128, 1, 1024
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (b, s, h, dh)).astype(np.float32)) for _ in range(3))
    k = k * dh ** -0.5
    i_pre, f_pre = (torch.from_numpy(rng.standard_normal(
        (b, s, h)).astype(np.float32) * 2) for _ in range(2))
    C0 = torch.from_numpy(rng.standard_normal((b, h, dh, dh)).astype(
        np.float32)) * 0.1
    n0 = torch.from_numpy(rng.standard_normal((b, h, dh)).astype(np.float32))
    m0 = torch.zeros((b, h))
    hc, (Cc, nc, mc) = TR._mlstm_chunkwise(q, k, v, i_pre, f_pre, C0.clone(),
                                           n0, m0, TR.MLSTM_CHUNK)
    hs, (Cs, ns, ms) = TR._mlstm_sequential(q, k, v, i_pre, f_pre,
                                            C0.clone(), n0, m0)
    for got, want in ((hc, hs), (Cc, Cs), (nc, ns), (mc, ms)):
        assert float((got - want).abs().max()) <= 1e-4 * float(
            want.abs().max())


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def per_head_gates(rh):
    """A stand-in that splits the per-head product [z|i|f|o] per head
    instead of regrouping it to the global layout."""
    return rh.reshape(rh.shape[0], -1)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("s", [1, 8, 64])
def test_slstm_block_matches_reference_fp32(s, with_state, width):
    (jc, tc, jp, tp, x, st), (want, jst), (got, tst) = run_both(
        "slstm", "float32", s, with_state, width)
    want64, jst64 = reference_f64(JR.apply_slstm_block, jc, jp, x, st)
    assert_fp32_close(got, want, want64, "out")
    if with_state:
        for key in ("h", "c", "n", "m"):
            assert_fp32_close(tst[key], jst[key], jst64[key], key)
    if s == 8 and not with_state:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(TR, "_global_gates", per_head_gates)
            bad, _ = TR.apply_slstm_block(tc, tp, torch.from_numpy(x))
        with pytest.raises(AssertionError):
            assert_fp32_close(bad, want, want64, "un-transposed gates")


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block_matches_reference_bf16(with_state):
    _, (want, jst), (got, tst) = run_both("slstm", "bfloat16", 16,
                                          with_state)
    assert_bf16_close(got, want, "out")
    if with_state:
        assert all(t.dtype == torch.float32 for t in tst.values())


# ---------------------------------------------------------------------------
# The recurrent parameter trees cross with params_from_jax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_params_from_jax_carries_recurrent_trees(name):
    """The hybrid and ssm trees in bf16 cross leaf for leaf: same paths,
    shapes, values and dtypes, the fp32 ``lam`` leaf staying fp32."""
    from repro_torch.common import tree_leaves
    jc, tc = cfgs(name, "bfloat16")
    jp = jmaterialize(JM.param_specs(jc), jax.random.key(0))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    specs = dict(tree_leaves(TM.param_specs(tc)))
    got = dict(tree_leaves(tp))
    want = dict(tree_leaves(jax.device_get(jp)))
    assert sorted(got) == sorted(want) == sorted(specs)
    for path, t in got.items():
        assert t.dtype == specs[path].dtype, path
        assert tuple(t.shape) == tuple(want[path].shape), path
        np.testing.assert_array_equal(as_np(t), as_np(want[path]))
    lams = [p for p in got if p.endswith("lam")]
    assert (len(lams) > 0) == (name == "recurrentgemma-2b")
    assert all(got[p].dtype == torch.float32 for p in lams)
