"""Port parity for the LM model assembly: repro_torch.models.model against
repro.models.model on the CPU.

``param_specs`` of all ten configurations at full size (nothing is
allocated: the trees hold ParamSpecs only), and ``forward`` of every
configuration at ``reduce()``. The JAX weights cross with
``params_from_jax``; inputs come from numpy seeds.

Tolerances: fp32 logits within 1e-4 absolute (tests/test_decode.py's
bar; logits here are O(1), max |logit| 3-4). For the recurrent families
(hybrid, ssm) the bar is twice the reference's own fp32 error where that
is larger: the JAX forward on float64 weights against its fp32 one, on
the same tokens (at reduce()'s init scale 9e-5 to 2e-3 of the logits,
measured in the test). bf16 within 2^-4 of max
|logit| (16 bf16 ulps): the residual stream is rounded to bf16 after
every sub-layer, four layers deep, and a one-ulp parting of a GEMM output
(the packages sum in other orders) is carried forward, not corrected.
For the moe configurations the routing is recorded in both packages and
the tokens whose experts differ are counted (fp32: none at these seeds).
In bf16 the flips' positions (and those a later layer's attention
carries them to) are counted and the rest held. granite-moe's softmax
routing weights are steep in the residual stream at reduce()'s init
scale: the JAX package's own bf16 logits part from its fp32 ones on the
same weights by 0.16 of max |logit|, more than 2^-4; there the bar is
that reference error. The recurrent families' bf16 logits are held to
the reference's fp32 ones within the reference's own bf16 error (0.16 of
max |logit| for recurrentgemma-2b, ~1.0 for xlstm-1.3b, whose
exponential gates at reduce()'s std-1 weights make bf16 a coin toss).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import materialize as jmaterialize
from repro.common import param_bytes as jparam_bytes
from repro.common import param_count as jparam_count
from repro.configs.all import ASSIGNED
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch.common import (ParamSpec, param_bytes, param_count,
                                params_from_jax, tree_leaves)
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE

MOES = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
RECURRENT = ["recurrentgemma-2b", "xlstm-1.3b"]
RUNS = ["qwen2.5-32b", "qwen2-72b", "granite-3-8b", "granite-8b",
        "internvl2-1b", "hubert-xlarge"] + MOES + RECURRENT
F32_ATOL = 1e-4
BF16_REL = 2.0 ** -4


@functools.lru_cache(maxsize=None)
def pair(name: str, dtype: str = "float32"):
    """(jax cfg, port cfg, jax params, port params) at reduce(), the JAX
    package's seed-0 weights carried over."""
    jc = dataclasses.replace(jget_config(name).reduce(), dtype=dtype)
    tc = dataclasses.replace(get_config(name).reduce(), dtype=dtype)
    jp = jmaterialize(JM.param_specs(jc), jax.random.key(0))
    return jc, tc, jp, params_from_jax(jax.device_get(jp), device="cpu")


def batch_for(cfg, b: int, s: int, seed: int = 0) -> dict:
    """numpy inputs of the family: tokens, (vlm) patch embeddings, (audio)
    frame embeddings."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        return {"frames": rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)
    return out


def record_routes(monkeypatch) -> dict:
    """Patch both packages' ``moe.route`` to record each call's ids
    (the JAX side through a debug callback, inside its layer scan)."""
    rec = {"jax": [], "port": []}
    jroute, troute = JMOE.route, TMOE.route

    def jwrap(cfg, x, w):
        out = jroute(cfg, x, w)
        jax.debug.callback(lambda i: rec["jax"].append(np.asarray(i)),
                           out[0])
        return out

    def twrap(cfg, x, w):
        out = troute(cfg, x, w)
        rec["port"].append(out[0].cpu().numpy())
        return out

    monkeypatch.setattr(JMOE, "route", jwrap)
    monkeypatch.setattr(TMOE, "route", twrap)
    return rec


def route_flips(rec) -> int:
    """Tokens whose experts differ between the packages, over every
    recorded call."""
    assert len(rec["jax"]) == len(rec["port"]) > 0
    return sum(int((a != b).any(-1).sum())
               for a, b in zip(rec["jax"], rec["port"]))


def unrouted_positions(rec, b: int) -> np.ndarray:
    """(B, S) mask of the positions no routing flip can reach: a token
    routed differently in the two packages taints itself, and the next
    layer's (causal) attention carries the taint to the later positions
    of its sequence."""
    tainted = np.zeros((b, rec["port"][0].shape[0] // b), bool)
    for a, c in zip(rec["jax"], rec["port"]):
        tainted = (np.maximum.accumulate(tainted, axis=1)
                   | (a != c).any(-1).reshape(b, -1))
    return ~tainted


def reference_f64(fn, jp, *args):
    """``fn(params, *args)`` of the JAX package on float64 weights (its own
    fp32 casts kept), as numpy: the reference's fp32 error is its fp32
    run against this."""
    with jax.enable_x64(True):
        p64 = jax.tree.map(lambda a: jnp.asarray(np.asarray(
            a.astype(jnp.float32)), jnp.float64), jp)
        return np.asarray(fn(p64, *args))


def recurrent_bar(cfg, want, want64) -> float:
    """1e-4 absolute, or for the recurrent families twice the reference's
    own fp32 error where that is larger."""
    if cfg.family not in ("hybrid", "ssm"):
        return F32_ATOL
    return max(F32_ATOL, 2 * float(np.abs(to_np(want) - want64).max()))


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _spec_row(spec):
    dtype = str(spec.dtype).replace("torch.", "") \
        if isinstance(spec.dtype, torch.dtype) else str(jnp.dtype(spec.dtype))
    return (tuple(spec.shape), dtype, tuple(spec.logical_axes), spec.init)


@pytest.mark.parametrize("name", ASSIGNED)
def test_param_specs_match_reference_at_full_size(name):
    mine = TM.param_specs(get_config(name))
    theirs = JM.param_specs(jget_config(name))
    rows = {path: _spec_row(s) for path, s in tree_leaves(mine)}
    want = {path: _spec_row(s) for path, s in tree_leaves(theirs)}
    assert rows == want
    assert all(isinstance(s, ParamSpec) for _, s in tree_leaves(mine))
    assert param_count(mine) == jparam_count(theirs)
    assert param_bytes(mine) == jparam_bytes(theirs)


def test_granite_3_8b_holds_8_37_billion_weights():
    """40 layers x 199,237,632 + untied embed and unembed of 49,408 x
    4,096: 16.75 GB in bf16, what one H100 holds whole."""
    specs = TM.param_specs(get_config("granite-3-8b"))
    per_layer = param_count(specs["blocks"]) // 40
    assert per_layer == 199_237_632
    assert param_count(specs) == 8_374_259_712
    assert param_bytes(specs) == 2 * 8_374_259_712


@pytest.mark.parametrize("name", RUNS)
def test_forward_matches_reference_fp32(name, monkeypatch):
    jc, tc, jp, tp = pair(name)
    batch = batch_for(jc, 2, 8)
    rec = record_routes(monkeypatch)
    want, jaux = JM.forward(jc, jp, as_jax(batch))
    got, aux = TM.forward(tc, tp, as_torch(batch))
    assert got.shape == want.shape and got.dtype == torch.float32
    bar = F32_ATOL
    if tc.family in ("hybrid", "ssm"):
        want64 = reference_f64(lambda p, b: JM.forward(jc, p, b)[0], jp,
                               as_jax(batch))
        bar = recurrent_bar(jc, want, want64)
    np.testing.assert_allclose(to_np(got), to_np(want), atol=bar, rtol=0)
    if tc.family == "moe":
        assert route_flips(rec) == 0
        assert len(rec["port"]) == tc.num_layers - tc.num_dense_layers
        assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
        assert float(aux) > 0
    else:
        assert float(aux) == float(jaux) == 0.0
    hid, _ = TM.forward(tc, tp, as_torch(batch), return_hidden=True)
    jhid, _ = JM.forward(jc, jp, as_jax(batch), return_hidden=True)
    np.testing.assert_allclose(to_np(hid), to_np(jhid), atol=bar, rtol=0)


def test_forward_matches_reference_bf16():
    jc, tc, jp, tp = pair("granite-3-8b", "bfloat16")
    batch = batch_for(jc, 2, 8)
    want, _ = JM.forward(jc, jp, as_jax(batch))
    got, _ = TM.forward(tc, tp, as_torch(batch))
    assert got.dtype == torch.bfloat16
    v = jc.vocab_size
    want, got = to_np(want)[..., :v], to_np(got)[..., :v]
    assert np.abs(got - want).max() <= BF16_REL * np.abs(want).max()


@pytest.mark.parametrize("name", MOES)
def test_moe_forward_matches_reference_bf16(name, monkeypatch):
    """bf16 logits within 2^-4 of max |logit|, or within the reference's
    own bf16 error (its bf16 logits against its fp32 ones on the same
    weights) where that is larger, at the positions no routing flip
    reaches (the flips counted); the port's bf16 logits no further from
    the reference's fp32 ones than that bar everywhere."""
    jc, tc, jp, tp = pair(name, "bfloat16")
    batch = batch_for(jc, 2, 8)
    rec = record_routes(monkeypatch)
    want, _ = JM.forward(jc, jp, as_jax(batch))
    got, aux = TM.forward(tc, tp, as_torch(batch))
    flips = route_flips(rec)
    held = unrouted_positions(rec, 2)
    assert got.dtype == torch.bfloat16 and float(aux) > 0
    jc32 = dataclasses.replace(jc, dtype="float32")
    f32, _ = JM.forward(jc32, jax.tree.map(lambda a: a.astype(jnp.float32),
                                           jp), as_jax(batch))
    v = jc.vocab_size
    want, got, f32 = (to_np(a)[..., :v] for a in (want, got, f32))
    scale = np.abs(want).max()
    bar = max(BF16_REL, np.abs(want - f32).max() / scale)
    assert held.sum() >= held.size // 2, (flips, held)
    assert np.abs(got - want)[held].max() / scale <= bar, (flips, bar)
    assert np.abs(got - f32).max() / scale <= bar


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_forward_matches_reference_bf16(name):
    """bf16 logits no further from the reference's fp32 ones (same
    weights) than the reference's own bf16 logits are, or 2^-4 of max
    |logit| where that is larger."""
    jc, tc, jp, tp = pair(name, "bfloat16")
    batch = batch_for(jc, 2, 8)
    want, _ = JM.forward(jc, jp, as_jax(batch))
    got, _ = TM.forward(tc, tp, as_torch(batch))
    assert got.dtype == torch.bfloat16
    jc32 = dataclasses.replace(jc, dtype="float32")
    f32, _ = JM.forward(jc32, jax.tree.map(lambda a: a.astype(jnp.float32),
                                           jp), as_jax(batch))
    v = jc.vocab_size
    want, got, f32 = (to_np(a)[..., :v] for a in (want, got, f32))
    scale = np.abs(f32).max()
    bar = max(BF16_REL, np.abs(want - f32).max() / scale)
    assert np.abs(got - f32).max() / scale <= bar


@pytest.mark.parametrize("name", ["granite-3-8b", "internvl2-1b"] + MOES
                         + RECURRENT)
def test_cache_shapes_match_reference(name):
    jc, tc, _, _ = pair(name)
    want = JM.init_cache_shapes(jc, 3, 40)
    got = TM.init_cache_shapes(tc, 3, 40)
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        assert str(got[key].dtype).replace("torch.", "") == \
            str(want[key].dtype), key
        assert got[key].device.type == "meta"
    cache = TM.init_cache(tc, 3, 40, device="cpu")
    assert cache["index"] == 0
    assert sorted(cache) == sorted(want)
    zeros = JM.init_cache(jc, 3, 40)
    for key in (k for k in want if k != "index"):
        assert cache[key].dtype == got[key].dtype, key
        np.testing.assert_array_equal(to_np(cache[key]), to_np(zeros[key]))
    if "slot_pos" in cache:         # the hybrid's rolling window: 8 slots
        assert cache["slot_pos"].shape == (8,)
        assert bool((cache["slot_pos"] == -1).all())
