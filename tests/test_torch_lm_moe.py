"""Port parity for the MoE FFN: repro_torch.models.moe against
repro.models.moe (the single-device path, ``mesh=None``) on the CPU.

The JAX package's seed-0 weights of one MoE layer at ``reduce()`` cross
with ``params_from_jax``; inputs come from numpy seeds. Bars: ids and
dispatch indices equal; routing weights and aux within 1e-6; the layer's
fp32 output within 1e-4 of its max |value| (expert outputs reach O(100)
at reduce()'s init scale, std 1/sqrt(4)), bf16 within 2^-6 of it.

Three reference behaviours decide the result and each has a stand-in
that must fail: ``lax.top_k`` puts the lower index first among equal
scores (``torch.topk`` does not), ``jnp.repeat`` repeats each row in a row
(not a tiling), and the dispatch's argsort is stable (a sort that breaks
ties the other way drops other assignments).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import moe as JMOE
from repro_torch.configs.base import get_config
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as T

from test_torch_lm_model import pair, to_np

MOES = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
DROPPING = 1.25                 # the published capacity factor


def layer(name: str, dtype: str = "float32", **overrides):
    """(jax cfg, port cfg, jax weights, port weights) of MoE layer 0."""
    jc, tc, jp, tp = pair(name, dtype)
    jc = dataclasses.replace(jc, **overrides)
    tc = dataclasses.replace(tc, **overrides)
    return (jc, tc, jax.tree.map(lambda a: a[0], jp["moe_blocks"]["moe"]),
            T.layer_params(tp["moe_blocks"]["moe"], 0))


def tokens(shape, seed: int, dtype=np.float32) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def jax_in(x: np.ndarray, dtype: str):
    return jnp.asarray(x).astype(jnp.dtype(dtype))


def torch_in(x: np.ndarray, dtype: str):
    return torch.from_numpy(x).to(getattr(torch, dtype))


@pytest.mark.parametrize("name", MOES)
def test_route_matches_reference(name):
    """Softmax (granite-moe) and sigmoid (deepseek, by its name's prefix,
    ``-smoke`` included) scoring: ids, weights and aux."""
    jc, tc, jw, tw = layer(name)
    assert tc.name.endswith("-smoke")
    x = tokens((64, tc.d_model), 0)
    jids, jwt, jaux = JMOE.route(jc, jnp.asarray(x), jw["router"])
    ids, wt, aux = TMOE.route(tc, torch.from_numpy(x), tw["router"])
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(wt.numpy(), np.asarray(jwt), atol=1e-6, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    np.testing.assert_allclose(wt.sum(-1).numpy(), 1.0, rtol=1e-6)


def _saturated_router(scale: float, t: int = 4):
    """deepseek-v3's router at full width (d 7168, 256 experts): unit-RMS
    tokens and N(0, scale^2) weights, so sigmoid rounds to exactly 1.0 for
    many experts a token."""
    cfg = jget_config("deepseek-v3-671b")
    x = tokens((t, cfg.d_model), 1)
    w = tokens((cfg.d_model, cfg.num_experts), 2) * np.float32(scale)
    return cfg, get_config("deepseek-v3-671b"), x, w


def _route_ids_equal(jc, tc, x, w) -> bool:
    jids, _, _ = JMOE.route(jc, jnp.asarray(x), jnp.asarray(w))
    ids, _, _ = TMOE.route(tc, torch.from_numpy(x), torch.from_numpy(w))
    return np.array_equal(ids.numpy(), np.asarray(jids))


@pytest.mark.parametrize("layers", [1, 58])
def test_route_breaks_ties_as_lax_top_k_at_deepseek_width(layers,
                                                          monkeypatch):
    """At the depth cut's scale (one MoE layer: std 1) and the full
    model's (58 MoE layers: std 1/sqrt(58)) every token's top 8 are all
    exactly 1.0, so the tie order picks the experts: the port's ids equal
    ``lax.top_k``'s, and a ``torch.topk`` stand-in fails."""
    jc, tc, x, w = _saturated_router(layers ** -0.5)
    scores = torch.sigmoid(torch.from_numpy(x) @ torch.from_numpy(w))
    saturated = (scores == 1.0).sum(-1)
    assert bool((saturated > tc.top_k).all()), saturated
    assert _route_ids_equal(jc, tc, x, w)
    # lax.top_k on the same scores: the lower index first among ties
    _, jids = jax.lax.top_k(jnp.asarray(scores.numpy()), tc.top_k)
    _, ids = TMOE.top_k(scores, tc.top_k)
    assert np.array_equal(ids.numpy(), np.asarray(jids))

    monkeypatch.setattr(TMOE, "top_k",
                        lambda s, k: torch.topk(s, k, dim=-1))
    assert not _route_ids_equal(jc, tc, x, w)


def test_top_k_tie_order_on_a_small_row():
    row = torch.tensor([[.5, 1, 1, .2, 1, 1, .9, 1]])
    _, ids = TMOE.top_k(row, 3)
    _, jids = jax.lax.top_k(jnp.asarray(row.numpy()), 3)
    assert ids.tolist() == np.asarray(jids).tolist() == [[1, 2, 4]]


def _reversed_ties_dispatch(ids, num_experts, capacity):
    """A stand-in: the same dispatch with a sort that puts the later
    assignment first among equal experts (as an unstable sort may)."""
    flat = ids.reshape(-1)
    n = flat.numel()
    order = torch.argsort(flat * n + (n - 1 - torch.arange(n)), stable=True)
    sorted_e = flat[order]
    counts = torch.bincount(flat, minlength=num_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n) - starts[sorted_e]
    return order, torch.where(pos < capacity, sorted_e * capacity + pos,
                              num_experts * capacity)


@pytest.mark.parametrize("name", MOES)
def test_dispatch_indices_match_reference_with_drops(name):
    """At the published factor 1.25, 64 tokens overflow some experts'
    buffers: the order, each buffer row and the trash index equal the
    reference's, and assignments were dropped."""
    jc, tc, jw, tw = layer(name)
    x = tokens((64, tc.d_model), 3)
    ids, _, _ = TMOE.route(tc, torch.from_numpy(x), tw["router"])
    e, k = tc.num_experts, tc.top_k
    cap = max(4, int(np.ceil(64 * k * DROPPING / e)))
    order, buf_idx = TMOE._dispatch_indices(ids, e, cap)
    jorder, jbuf = JMOE._dispatch_indices(jnp.asarray(ids.numpy()), e, cap)
    assert np.array_equal(order.numpy(), np.asarray(jorder))
    assert np.array_equal(buf_idx.numpy(), np.asarray(jbuf))
    dropped = int((buf_idx == e * cap).sum())
    assert dropped > 0
    kept = buf_idx[buf_idx < e * cap]
    assert kept.unique().numel() == kept.numel() == ids.numel() - dropped


def _moe_pair(name, dtype, factor, seed=4, shape=(4, 16)):
    jc, tc, jw, tw = layer(name, dtype, moe_capacity_factor=factor)
    x = tokens(shape + (tc.d_model,), seed)
    want, jaux = JMOE.apply_moe(jc, jw, jax_in(x, dtype), None)
    got, aux = TMOE.apply_moe(tc, tw, torch_in(x, dtype))
    return tc, x, to_np(got), to_np(want), float(aux), float(jaux)


def _dropped(tc, x) -> int:
    """Assignments past capacity when ``x`` goes through one layer."""
    t = x.shape[0] * x.shape[1]
    _, _, _, tw = layer(tc.name.replace("-smoke", ""))
    ids, _, _ = TMOE.route(tc, torch.from_numpy(x).reshape(t, -1),
                           tw["router"])
    e = tc.num_experts
    cap = max(4, int(np.ceil(t * tc.top_k * tc.moe_capacity_factor / e)))
    _, buf_idx = TMOE._dispatch_indices(ids, e, cap)
    return int((buf_idx == e * cap).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [DROPPING, 8.0])
@pytest.mark.parametrize("name", MOES)
def test_apply_moe_matches_reference(name, factor, dtype):
    """apply_moe on 4 x 16 tokens at the published factor (drops) and at
    reduce()'s 8.0 (none): the layer's output and aux."""
    tc, x, got, want, aux, jaux = _moe_pair(name, dtype, factor)
    bar = (1e-4 if dtype == "float32" else 2.0 ** -6) * np.abs(want).max()
    assert np.abs(got - want).max() <= bar
    assert aux == pytest.approx(jaux, rel=1e-5)
    if dtype == "float32":
        assert (_dropped(tc, x) > 0) == (factor == DROPPING)


@pytest.mark.parametrize("stand_in", ["tiled rows", "reversed ties"])
def test_stand_ins_part_from_reference(stand_in, monkeypatch):
    """Tiling rows in place of repeat_interleave, or a dispatch sort that
    breaks ties the other way, parts from the reference at the published
    factor (the tie order decides which assignments are dropped)."""
    name = "granite-moe-3b-a800m"
    tc, x, got, want, _, _ = _moe_pair(name, "float32", DROPPING)
    bar = 1e-4 * np.abs(want).max()
    assert np.abs(got - want).max() <= bar
    if stand_in == "tiled rows":
        monkeypatch.setattr(TMOE, "_repeat_rows", lambda x, k: x.repeat(k, 1))
    else:
        monkeypatch.setattr(TMOE, "_dispatch_indices", _reversed_ties_dispatch)
    _, _, got, want, _, _ = _moe_pair(name, "float32", DROPPING)
    assert np.abs(got - want).max() > 100 * bar


def test_capacity_counts_every_token_of_the_call():
    """A token's output depends on its batch at the published factor:
    the same 16 tokens alone and beside 48 others route alike, but the
    buffer is sized by the call's 64 tokens and the fill order is the
    batch's, so some of their assignments are kept or dropped
    differently; both packages agree on each."""
    name = "granite-moe-3b-a800m"
    jc, tc, jw, tw = layer(name, moe_capacity_factor=DROPPING)
    x = tokens((4, 16, tc.d_model), 5)
    alone, _ = TMOE.apply_moe(tc, tw, torch.from_numpy(x[3:]))
    jalone, _ = JMOE.apply_moe(jc, jw, jnp.asarray(x[3:]), None)
    batched, _ = TMOE.apply_moe(tc, tw, torch.from_numpy(x))
    jbatched, _ = JMOE.apply_moe(jc, jw, jnp.asarray(x), None)
    bar = 1e-4 * np.abs(to_np(jbatched)).max()
    assert np.abs(to_np(alone) - to_np(jalone)).max() <= bar
    assert np.abs(to_np(batched) - to_np(jbatched)).max() <= bar
    assert np.abs(to_np(batched)[3:] - to_np(alone)).max() > 100 * bar
