"""The LM training path's parts in the port against the JAX package, on
the CPU: the mLSTM's gradient, checkpoints of an ``AdamWState``, EF-int8,
the data pipeline and rematerialization.

- mLSTM gradient: ``apply_mlstm_block``'s vjp (a fixed numpy cotangent)
  with respect to every param and to x, in both forms (S 32 sequential,
  S 128 chunkwise) at ``reduce()`` in fp32, against ``jax.vjp`` of
  ``repro.models.recurrent.apply_mlstm_block`` on shared params: each leaf
  within 1e-4 of its max |g|, or four times the reference's own
  fp32-vs-float64 error on that leaf where that is larger (the gradient
  rule of tests/test_torch_lm_train_step.py). At ``reduce()``'s std-1
  weights these gradients reach 1e4-3e6 and both packages part from
  float64 by up to 1e-3 of a leaf's max |g|; the port lies 0.3x-2.3x as
  far from float64 as the reference (S 32's wq: port against JAX 12.2,
  the reference against float64 4.7, of a max |g| of 1.0e4). The forward
  with autograd recording (C updated out of place) is bitwise the forward
  without it (C updated in place), in both forms and both dtypes, and a
  serving engine's decode still writes the state in place. The sLSTM's
  gradient overflows fp32 with the sequence in both packages.
- The mLSTM's SiLU: its gradient is finite where the expansion's
  autograd would multiply inf by 0 (the vjp tests reach it).
- Checkpoints: ``{"params", "opt": AdamWState}`` saved by either package
  after one of its steps restores in the other bitwise, as an
  ``AdamWState`` (its step on the CPU in the port), under equal manifest
  keys; members of a MiB or more restore memory-mapped, their hashes
  checked.
- EF-int8: the reference's three properties (tests/test_placement_optim.py).
- Data: the port's batches are bitwise the reference's for the dense, vlm
  and audio families over several steps and after ``from_state``.
- Remat: ``"full"``, ``"dots"`` and ``"none"`` give bitwise-equal loss and
  gradients for one configuration of each family (one thread), and a
  counting dispatch mode shows what each recomputes.
"""
import dataclasses
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import manager as jckpt
from repro.common import materialize as jmaterialize
from repro.configs.base import get_config as jget_config
from repro.data import pipeline as JP
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.train import steps as JS
from repro_torch.checkpoint import manager as ckpt
from repro_torch.common import materialize, params_from_jax, tree_leaves
from repro_torch.configs.base import ShapeConfig, get_config
from repro_torch.data import pipeline as TP
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.optim import adamw as TA
from repro_torch.optim import compress as TC
from repro_torch.serve.server import ServingEngine
from repro_torch.train import steps as TS

from test_torch_lm_recurrent import block, inputs, reference_f64

F32_REL = 1e-4


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def as_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a).astype(np.float64)


# ---------------------------------------------------------------------------
# The mLSTM's gradient (both forms) and its in-place serving write
# ---------------------------------------------------------------------------


def mlstm_vjp_port(tc, tp, x, ct):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, _ = TR.apply_mlstm_block(tc, leaves, xt)
    grads = torch.autograd.grad(out, list(leaves.values()) + [xt],
                                torch.from_numpy(ct))
    return out, dict(zip(list(leaves) + ["x"], grads))


def mlstm_vjp_jax(jc, jp, x, ct):
    out, vjp = jax.vjp(lambda p, xv: JR_block(jc, p, xv), jp, jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(ct))
    return out, {**gp, "x": gx}


def JR_block(jc, p, x):
    from repro.models import recurrent as JR
    return JR.apply_mlstm_block(jc, p, x)[0]


@pytest.mark.parametrize("s", [32, 128], ids=["sequential", "chunkwise"])
def test_mlstm_gradient_matches_jax_vjp(s):
    jc, tc, _, _, jp, tp = block("mlstm", "float32")
    x = inputs(jc, s)
    ct = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    got_out, got = mlstm_vjp_port(tc, tp, x, ct)
    want_out, want = mlstm_vjp_jax(jc, jp, x, ct)
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(a), jnp.float64),
                           jp)
        _, want64 = mlstm_vjp_jax(jc, p64, x.astype(np.float64),
                                  ct.astype(np.float64))
    want64_out, _ = reference_f64(
        lambda c, p, xv, state=None: (JR_block(c, p, xv), None), jc, jp, x,
        None)
    spread = float(np.abs(as_np(want_out) - want64_out).max())
    assert float(np.abs(as_np(got_out) - as_np(want_out)).max()) <= max(
        F32_REL * max(1.0, float(np.abs(want64_out).max())), 2 * spread)
    assert sorted(got) == sorted(want)
    for k in want:
        g, w, w64 = as_np(got[k]), as_np(want[k]), as_np(want64[k])
        bar = max(F32_REL * float(np.abs(w).max()),
                  4 * float(np.abs(w - w64).max()))
        err = float(np.abs(g - w).max())
        assert err <= bar, (k, err, bar)


def test_slstm_gradient_overflows_with_length_in_both_packages():
    """The sLSTM's backward through its recurrence grows exponentially
    with the sequence at xlstm-1.3b's init scale (std 1/sqrt(6), one head
    of its per-head width 512): finite at 64 steps, non-finite at 256, in
    both packages. At the full width (4 heads, d 2048) one block's dL/dx
    reaches ~1e15 at 128 steps, ~1e25 at 256 and overflows at 512 in both
    (measured on the CPU), which is why the card trains xlstm-1.3b at seq
    256, not 512."""
    from repro.models import recurrent as JR
    over = dict(d_model=512, num_heads=1, dtype="float32")
    jc = dataclasses.replace(jget_config("xlstm-1.3b"), **over)
    tc = dataclasses.replace(get_config("xlstm-1.3b"), **over)
    spec = jax.tree.map(
        lambda sp: dataclasses.replace(sp, init=("scaled", 6))
        if sp.init == "normal" else sp, JR.slstm_specs(jc, 1),
        is_leaf=lambda sp: hasattr(sp, "init"))
    jp = jax.tree.map(lambda a: a[0], jmaterialize(spec, jax.random.key(0)))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    finite = {}
    for s in (64, 256):
        rng = np.random.default_rng(s)
        x = rng.standard_normal((1, s, 512)).astype(np.float32)
        ct = rng.standard_normal(x.shape).astype(np.float32)
        gj = jax.grad(lambda xv: jnp.sum(
            JR.apply_slstm_block(jc, jp, xv)[0] * ct))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        gt = torch.autograd.grad(TR.apply_slstm_block(tc, tp, xt)[0], xt,
                                 torch.from_numpy(ct))[0]
        finite[s] = (bool(jnp.isfinite(gj).all()),
                     bool(torch.isfinite(gt).all()))
    assert finite == {64: (True, True), 256: (False, False)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [32, 128], ids=["sequential", "chunkwise"])
def test_mlstm_forward_is_bitwise_with_and_without_autograd(s, dtype):
    """The out-of-place update (autograd recording) computes the in-place
    one's bits: output and every state leaf, from a carried state."""
    _, tc, _, _, _, tp = block("mlstm", dtype)
    x = torch.from_numpy(inputs(tc, s)).to(tc.torch_dtype)
    h, dh = tc.num_heads, 2 * tc.d_model // tc.num_heads
    gen = torch.Generator().manual_seed(3)
    st = {"C": 0.1 * torch.randn((2, h, dh, dh), generator=gen),
          "n": torch.randn((2, h, dh), generator=gen),
          "m": torch.zeros((2, h)),
          "conv": torch.randn((2, tc.conv1d_width - 1, 2 * tc.d_model),
                              generator=gen).to(tc.torch_dtype)}
    with torch.no_grad():
        c_in = {k: v.clone() for k, v in st.items()}
        want, wst = TR.apply_mlstm_block(tc, tp, x, state=c_in)
    assert wst["C"] is c_in["C"]                     # written in place
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    c_in = {k: v.clone() for k, v in st.items()}
    got, gst = TR.apply_mlstm_block(tc, leaves, x, state=c_in)
    assert gst["C"] is not c_in["C"] and torch.equal(c_in["C"], st["C"])
    assert torch.equal(got.detach(), want)
    for k in wst:
        assert torch.equal(gst[k].detach(), wst[k]), k


def test_serving_decode_writes_the_mlstm_state_in_place(monkeypatch):
    """Under ``ServingEngine`` (inference mode) every mLSTM call of a
    decode step returns the cache's own matrix memory, updated in place."""
    from repro_torch.launch.serve import make_requests
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduce(),
                              dtype="float32")
    params = materialize(TM.param_specs(cfg), seed=0, device="cpu")
    seen = []
    fn = TR.apply_mlstm_block

    def recording(c, p, x, *, state=None):
        ptr = None if state is None else state["C"].data_ptr()
        out = fn(c, p, x, state=state)
        if state is not None:
            seen.append((x.shape[1], out[1]["C"] is state["C"],
                         out[1]["C"].data_ptr() == ptr))
        return out

    monkeypatch.setattr(TR, "apply_mlstm_block", recording)
    done = ServingEngine(cfg, params, slots=2, max_len=64,
                         device="cpu").run(make_requests(cfg, 2, 4))
    assert [len(r.output) for r in done] == [4, 4]
    decode = [row for row in seen if row[0] == 1]
    assert decode and all(same and ptr for _, same, ptr in seen)


# ---------------------------------------------------------------------------
# Checkpoints of an AdamWState, across the packages
# ---------------------------------------------------------------------------


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_trainer_checkpoint_restores_in_the_port(tmp_path, dtype):
    jc = dataclasses.replace(jget_config("granite-8b").reduce(), dtype=dtype)
    jtc = JS.TrainConfig()
    jp = jmaterialize(JM.param_specs(jc), jax.random.key(0))
    batch = {k: jnp.asarray(v)
             for k, v in JP.TokenPipeline(jc, 2, 16).next_batch().items()}
    jp2, jo2, _ = jax.jit(JS.make_train_step(jc, jtc))(
        jp, JA.init_state(jtc.optimizer, jp), batch)
    jpath = jckpt.save(str(tmp_path / "jax"), 1, {"params": jp2, "opt": jo2},
                       extras={"step": 1})
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    like = {"params": tp, "opt": TA.init_state(TA.AdamWConfig(), tp)}
    got, extras = ckpt.restore(str(tmp_path / "jax"), like, device="cpu")
    assert extras == {"step": 1}
    opt = got["opt"]
    assert type(opt) is TA.AdamWState
    assert opt.step.device.type == "cpu" and opt.step.dtype == torch.int32
    assert int(opt.step) == 1
    want = {"params": jax.device_get(jp2), "opt": jax.device_get(jo2)}
    assert sorted(ckpt._flatten_with_paths(got)) == sorted(
        jckpt._flatten_with_paths(want))
    for k, leaf in ckpt._flatten_with_paths(got).items():
        w = np.asarray(jckpt._flatten_with_paths(want)[k])
        assert str(leaf.dtype).replace("torch.", "") == str(w.dtype), k
        np.testing.assert_array_equal(as_np(leaf), w.astype(np.float64),
                                      err_msg=k)
    # the port writes the same keys for its own state
    tpath = ckpt.save(str(tmp_path / "port"), 1, got, extras={"step": 1})
    assert _manifest(tpath)["keys"] == _manifest(jpath)["keys"]
    assert "opt/.step" in _manifest(jpath)["keys"]
    assert _manifest(tpath)["hashes"] == _manifest(jpath)["hashes"]


def test_port_trainer_checkpoint_restores_in_the_reference(tmp_path):
    jc = dataclasses.replace(jget_config("granite-8b").reduce(),
                             dtype="float32")
    tc = dataclasses.replace(get_config("granite-8b").reduce(),
                             dtype="float32")
    jp = jmaterialize(JM.param_specs(jc), jax.random.key(0))
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    ttc = TS.TrainConfig()
    batch = {k: torch.from_numpy(v)
             for k, v in TP.TokenPipeline(tc, 2, 16).next_batch().items()}
    tp2, to2, _ = TS.make_train_step(tc, ttc)(
        tp, TA.init_state(ttc.optimizer, tp), batch)
    ckpt.save(str(tmp_path), 1, {"params": tp2, "opt": to2})
    like = {"params": jp, "opt": JA.init_state(JA.AdamWConfig(), jp)}
    got, _ = jckpt.restore(str(tmp_path), like)
    assert type(got["opt"]) is JA.AdamWState and int(got["opt"].step) == 1
    mine = ckpt._flatten_with_paths({"params": tp2, "opt": to2})
    theirs = jckpt._flatten_with_paths(got)
    assert sorted(mine) == sorted(theirs)
    for k, leaf in mine.items():
        np.testing.assert_array_equal(np.asarray(theirs[k]), leaf.numpy(),
                                      err_msg=k)


def test_plain_tuples_keep_index_keys(tmp_path):
    """Only NamedTuples key their fields by name: a plain tuple and a list
    keep their indices, as JAX's ``SequenceKey`` renders them."""
    tree = {"t": (torch.ones(2), torch.zeros(3)), "l": [torch.ones(1)],
            "o": TA.AdamWState(torch.zeros((), dtype=torch.int32),
                               {"w": torch.ones(2)}, {"w": torch.ones(2)}, ())}
    assert [k for k, _ in ckpt._flatten_with_paths(tree).items()] == [
        "l/0", "o/.step", "o/.mu/w", "o/.nu/w", "t/0", "t/1"]
    ckpt.save(str(tmp_path), 1, tree)
    got, _ = ckpt.restore(str(tmp_path), tree, device="cpu")
    assert type(got["t"]) is tuple and type(got["l"]) is list
    assert type(got["o"]) is TA.AdamWState and got["o"].master == ()


def test_large_members_round_trip_and_corruption_is_caught(tmp_path):
    """Leaves of a MiB and more, a bfloat16 like and a 0-d leaf: the JAX
    package's checkpoint restores bitwise in the port and the port's in the
    JAX package, and a flipped byte inside a member is caught."""
    rng = np.random.default_rng(0)
    big = rng.standard_normal((512, 1024)).astype(np.float32)     # 2 MiB
    tree = {"w": big, "b": {"v": rng.standard_normal(700_000).astype(
        np.float32)}, "s": np.int32(3)}
    jckpt.save(str(tmp_path / "j"), 1, jax.tree.map(jnp.asarray, tree))
    like = {"w": torch.empty(big.shape, device="meta"),
            "b": {"v": torch.empty(700_000, dtype=torch.bfloat16,
                                   device="meta")},
            "s": torch.zeros((), dtype=torch.int32)}
    got, _ = ckpt.restore(str(tmp_path / "j"), like, device="cpu")
    np.testing.assert_array_equal(got["w"].numpy(), big)
    assert got["b"]["v"].dtype == torch.bfloat16
    assert torch.equal(got["b"]["v"], torch.from_numpy(
        tree["b"]["v"]).to(torch.bfloat16))
    ckpt.save(str(tmp_path / "t"), 1, got)
    back, _ = jckpt.restore(str(tmp_path / "t"), jax.tree.map(
        jnp.asarray, tree))
    np.testing.assert_array_equal(np.asarray(back["w"]), big)
    path = tmp_path / "t" / "step_00000001" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    at = raw.find(big[100].tobytes())
    assert at > 0
    raw[at] ^= 1
    path.write_bytes(bytes(raw))
    # the zip member's CRC catches it before the manifest's hash does, in
    # both packages
    with pytest.raises(zipfile.BadZipFile, match="CRC"):
        ckpt.restore(str(tmp_path / "t"), like, device="cpu")


# ---------------------------------------------------------------------------
# EF-int8 (tests/test_placement_optim.py's properties)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_ef_int8_identity_property(seed):
    """deq + residual == compensated input (error feedback loses nothing)."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        64).astype(np.float32))
    deq, e1 = TC.ef_compress_grads({"g": x}, {"g": torch.zeros_like(x)})
    np.testing.assert_allclose((deq["g"] + e1["g"]).numpy(), x.numpy(),
                               rtol=1e-5, atol=1e-6)


def test_ef_int8_error_bounded():
    x = torch.from_numpy(3 * np.random.default_rng(0).standard_normal(
        1024).astype(np.float32))
    deq, e = TC.ef_compress_grads({"g": x}, {"g": torch.zeros_like(x)})
    assert float(e["g"].abs().max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_ef_accumulates_small_signals():
    """A gradient below one quantization step is carried until it crosses
    a step."""
    small = torch.tensor([127.0] + [0.3] * 7)
    e = TC.init_error_state({"g": small})
    total = torch.zeros(8)
    for _ in range(10):
        deq, e = TC.ef_compress_grads({"g": small}, e)
        total = total + deq["g"]
    assert float(total[1]) > 0.3 * 10 * 0.5
    assert TC.POD_WIRE_BYTES_SCALE == 0.25


# ---------------------------------------------------------------------------
# The data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["granite-8b", "internvl2-1b",
                                  "hubert-xlarge"])
def test_pipeline_batches_are_bitwise_the_reference(name):
    jc, tc = jget_config(name).reduce(), get_config(name).reduce()
    a, b = JP.TokenPipeline(jc, 3, 24, seed=4), TP.TokenPipeline(tc, 3, 24,
                                                                 seed=4)
    for _ in range(4):
        want, got = a.next_batch(), b.next_batch()
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert b.state() == a.state() == {"seed": 4, "step": 4}
    resumed = TP.TokenPipeline.from_state(tc, 3, 24, b.state())
    want = JP.TokenPipeline.from_state(jc, 3, 24, a.state()).next_batch()
    for k, v in resumed.next_batch().items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    shape = ShapeConfig("t", 24, 3, "train")
    np.testing.assert_array_equal(TP.build_batch(tc, shape, 4)["labels"],
                                  JP.build_batch(jc, shape, 4)["labels"])


def test_data_pipeline_resume_identical():
    cfg = get_config("granite-8b").reduce()
    a = TP.TokenPipeline(cfg, 2, 16, seed=9)
    for _ in range(3):
        a.next_batch()
    state = a.state()
    nxt = a.next_batch()
    b = TP.TokenPipeline.from_state(cfg, 2, 16, state)
    np.testing.assert_array_equal(nxt["tokens"], b.next_batch()["tokens"])


def test_prefetching_loader_keeps_order_and_stops():
    cfg = get_config("granite-8b").reduce()
    loader = TP.PrefetchingLoader(TP.TokenPipeline(cfg, 2, 8, seed=1),
                                  buffer=2)
    try:
        got = [next(loader)["tokens"] for _ in range(3)]
    finally:
        loader.stop()
    loader.thread.join(timeout=5)
    assert not loader.thread.is_alive()
    ref = TP.TokenPipeline(cfg, 2, 8, seed=1)
    for g in got:
        np.testing.assert_array_equal(g, ref.next_batch()["tokens"])


# ---------------------------------------------------------------------------
# Remat
# ---------------------------------------------------------------------------

FAMILIES = ["granite-8b", "internvl2-1b", "hubert-xlarge",
            "granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-1.3b"]


def loss_and_grads(cfg, params, batch):
    (lv, _), grads = TS._value_and_grad(cfg, TS.TrainConfig(), params, batch)
    return lv, grads


@pytest.mark.parametrize("name", FAMILIES)
def test_remat_policies_give_the_same_bits(name, one_thread):
    base = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    params = materialize(TM.param_specs(base), seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             TP.TokenPipeline(base, 2, 16, seed=2).next_batch().items()}
    runs = {mode: loss_and_grads(dataclasses.replace(base, remat=mode),
                                 params, batch)
            for mode in ("none", "full", "dots")}
    lv0, g0 = runs["none"]
    for mode in ("full", "dots"):
        lv, g = runs[mode]
        assert torch.equal(lv, lv0), mode
        for (k, a), (_, b) in zip(tree_leaves(g), tree_leaves(g0)):
            assert torch.equal(a, b), (mode, k)


class CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ["granite-8b", "xlstm-1.3b"])
def test_remat_dots_recomputes_no_matmul_and_full_does(name, one_thread):
    """aten.mm calls in the backward pass: "none" makes only the
    gradients' products; "dots" the same (the forward's mm outputs were
    saved); "full" also recomputes the forward's."""
    base = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    params = materialize(TM.param_specs(base), seed=0, device="cpu")
    leaves = [p.requires_grad_(True) for _, p in tree_leaves(params)]
    batch = {k: torch.from_numpy(v) for k, v in
             TP.TokenPipeline(base, 2, 16, seed=2).next_batch().items()}
    counts = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        fwd, bwd = CountMM(), CountMM()
        with fwd:
            loss, _ = TS.loss_fn(cfg, TS.TrainConfig(), params, batch)
        with bwd:
            torch.autograd.grad(loss, leaves)
        counts[mode] = (fwd.n, bwd.n)
    assert counts["none"][0] == counts["dots"][0] == counts["full"][0]
    assert counts["dots"][1] == counts["none"][1], counts
    # every forward mm inside a unit again (the unembedding's is outside
    # any), but each unit's last, whose output no backward reads: the
    # non-reentrant checkpoint stops recomputing there
    units = {"granite-8b": 4, "xlstm-1.3b": 2}[name]
    assert counts["full"][1] == (counts["none"][1] + counts["none"][0] - 1
                                 - units), counts
