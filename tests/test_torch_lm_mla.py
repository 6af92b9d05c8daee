"""Port parity for Multi-head Latent Attention: repro_torch.models.mla
against repro.models.mla on the CPU, at deepseek-v3's ``reduce()`` widths.

Both forms: the materialized one (forward, and prefill into the latent
cache) and the absorbed one (a one-token call with a cache: W_uk folded
into q, scores on the latents, W_uv after). Bars: fp32 outputs and cache
leaves within 1e-4 of their max |value|; bf16 outputs within 2^-5 of it.
Within the port, the absorbed decode after a prefill of S-1 tokens gives
the materialized forward's output at position S-1 within 1e-4 of its max
|value|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget_config
from repro.models import mla as JMLA
from repro_torch.configs.base import get_config
from repro_torch.models import mla as TMLA
from repro_torch.models import transformer as T

from test_torch_lm_model import pair, to_np

NAME = "deepseek-v3-671b"
REL = 1e-4


def layer(dtype: str = "float32"):
    """(jax cfg, port cfg, jax weights, port weights) of MoE layer 0's
    attention."""
    jc, tc, jp, tp = pair(NAME, dtype)
    return (jc, tc, jax.tree.map(lambda a: a[0], jp["moe_blocks"]["attn"]),
            T.layer_params(tp["moe_blocks"]["attn"], 0))


def inputs(cfg, b, s, seed, dtype="float32"):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return (jnp.asarray(x).astype(jnp.dtype(dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def positions(b, s, start=0):
    pos = np.broadcast_to(np.arange(start, start + s, dtype=np.int32), (b, s))
    return jnp.asarray(pos), torch.from_numpy(pos.copy())


def empty_caches(cfg, b, max_len, dtype="float32"):
    shapes = {"ckv": (b, max_len, cfg.kv_lora_rank),
              "krope": (b, max_len, cfg.qk_rope_head_dim)}
    return ({k: jnp.zeros(v, jnp.dtype(dtype)) for k, v in shapes.items()},
            {k: torch.zeros(v, dtype=getattr(torch, dtype))
             for k, v in shapes.items()})


def close(got, want, rel=REL):
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_materialized_forward_matches_reference(dtype):
    jc, tc, jw, tw = layer(dtype)
    jx, tx = inputs(tc, 2, 8, 0, dtype)
    jpos, tpos = positions(2, 8)
    want, jcache = JMLA.apply_mla(jc, jw, jx, jpos)
    got, cache = TMLA.apply_mla(tc, tw, tx, tpos)
    assert cache is None and jcache is None
    assert got.dtype == getattr(torch, dtype)
    close(got, want, REL if dtype == "float32" else 2.0 ** -5)


@pytest.mark.parametrize("prompt", [7, 1])
def test_prefill_then_absorbed_decode_match_reference(prompt):
    """A materialized prefill of ``prompt`` tokens into the latent cache
    (a one-token prompt takes the absorbed form at index 0, as in the
    reference), then three absorbed decode steps: outputs and both cache
    leaves after each call."""
    jc, tc, jw, tw = layer()
    max_len = prompt + 5
    jcache, cache = empty_caches(tc, 2, max_len)
    jx, tx = inputs(tc, 2, prompt, 1)
    jpos, tpos = positions(2, prompt)
    want, jcache = JMLA.apply_mla(jc, jw, jx, jpos, kv_cache=jcache,
                                  cache_index=0)
    got, cache = TMLA.apply_mla(tc, tw, tx, tpos, kv_cache=cache,
                                cache_index=0)
    close(got, want)
    for key in ("ckv", "krope"):
        close(cache[key], jcache[key])
    for i in range(3):
        jx, tx = inputs(tc, 2, 1, 2 + i)
        jpos, tpos = positions(2, 1, prompt + i)
        want, jcache = JMLA.apply_mla(jc, jw, jx, jpos, kv_cache=jcache,
                                      cache_index=prompt + i)
        got, cache = TMLA.apply_mla(tc, tw, tx, tpos, kv_cache=cache,
                                    cache_index=prompt + i)
        close(got, want)
        for key in ("ckv", "krope"):
            close(cache[key], jcache[key])


def test_absorbed_decode_past_max_len_masks_on_the_unclamped_index():
    """Past max_len the latent write lands on the last slot (JAX clamps
    dynamic_update_slice) while the mask ``t <= index`` keeps every slot:
    the port writes and masks where the reference does."""
    jc, tc, jw, tw = layer()
    jcache, cache = empty_caches(tc, 2, 6)
    jx, tx = inputs(tc, 2, 5, 6)
    jpos, tpos = positions(2, 5)
    _, jcache = JMLA.apply_mla(jc, jw, jx, jpos, kv_cache=jcache,
                               cache_index=0)
    TMLA.apply_mla(tc, tw, tx, tpos, kv_cache=cache, cache_index=0)
    lasts = []
    for i in range(4):                       # indices 5 fits; 6, 7, 8 clamp
        jx, tx = inputs(tc, 2, 1, 7 + i)
        jpos, tpos = positions(2, 1, 5 + i)
        want, jcache = JMLA.apply_mla(jc, jw, jx, jpos, kv_cache=jcache,
                                      cache_index=5 + i)
        got, cache = TMLA.apply_mla(tc, tw, tx, tpos, kv_cache=cache,
                                    cache_index=5 + i)
        close(got, want)
        for key in ("ckv", "krope"):
            close(cache[key], jcache[key])
        lasts.append(cache["ckv"][:, -1].clone())
    assert all(not torch.equal(a, b) for a, b in zip(lasts, lasts[1:]))


def test_absorbed_decode_matches_materialized_forward():
    """The two forms agree: prefill(S-1) then one absorbed step gives the
    materialized forward's output at the last position."""
    _, tc, _, tw = layer()
    _, tx = inputs(tc, 2, 8, 11)
    _, tpos = positions(2, 8)
    full, _ = TMLA.apply_mla(tc, tw, tx, tpos)
    _, cache = empty_caches(tc, 2, 12)
    TMLA.apply_mla(tc, tw, tx[:, :-1], tpos[:, :-1], kv_cache=cache,
                   cache_index=0)
    step, _ = TMLA.apply_mla(tc, tw, tx[:, -1:], tpos[:, -1:],
                             kv_cache=cache, cache_index=7)
    close(step[:, 0], full[:, -1])


def test_mla_specs_match_reference_at_full_size():
    mine = TMLA.mla_specs(get_config(NAME), 61)
    theirs = JMLA.mla_specs(jget_config(NAME), 61)
    assert sorted(mine) == sorted(theirs)
    for key in mine:
        assert mine[key].shape == theirs[key].shape
        assert mine[key].logical_axes == theirs[key].logical_axes
    # 187M weights a layer: what chip_smoke's full-width check draws
    assert sum(int(np.prod(s.shape)) for s in mine.values()) == \
        61 * 187_107_328
