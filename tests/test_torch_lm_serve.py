"""Port parity for LM serving: repro_torch.serve.{decode,server} and
repro_torch.launch.serve against repro.serve.{decode,server} on the CPU.

The JAX package's seed-0 weights cross with ``params_from_jax``; prompts
come from numpy seeds. Tolerances (fp32): logits within 1e-4 absolute
(tests/test_decode.py's bar; logits are O(1)); cache leaves within 1e-4
of their largest |value| (the init rule puts K and V at O(10)). Greedy
tokens must be equal: the flips (tokens that differ) are counted and
must be zero at these seeds.

Reference behaviours reproduced, each with a test: the cache write past
``max_len`` lands on the last slot (JAX clamps ``dynamic_update_slice``'s
start); a group's prompts are left-padded with token 0 and the padding is
attended, so a request's tokens depend on its group's longest prompt. For
the moe configurations decode against forward keeps the reference's own
moe bar (2e-3, tests/test_decode.py), and at the published capacity
factor (1.25) the engine's padding and pad slots count toward each
expert's capacity, so assignments are dropped as in the reference.

The recurrent families (hybrid, ssm) hold prefill and decode to the
reference's own bar for their decode (2e-3, tests/test_decode.py): the
logits absolute, each cache leaf of its largest |value|. Their states
accumulate fp32 rounding over the steps (at reduce()'s std-1 init they
reach 1e2-1e3, and the two packages' states part by up to 1.5e-4 of max
|value| after eight steps); a wrong slot, gate order or carried state
parts by O(1). Each block is held tighter in test_torch_lm_recurrent.py.
Decode against forward keeps the same bar, and their left padding runs
through the conv and recurrent states as in the reference. The hybrid's
rolling cache decodes past its window, overwriting its oldest slot.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import decode as JD
from repro.serve import server as JS
from repro_torch.configs.base import get_config
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.serve import decode as TD
from repro_torch.serve import server as TS

from test_torch_lm_model import (as_jax, as_torch, batch_for, pair, to_np)

MOES = ["granite-moe-3b-a800m", "deepseek-v3-671b"]
RECURRENT = ["recurrentgemma-2b", "xlstm-1.3b"]
DECODERS = ["qwen2.5-32b", "qwen2-72b", "granite-3-8b", "granite-8b",
            "internvl2-1b"] + MOES + RECURRENT
ATOL = 1e-4
REF_DECODE_ATOL = 2e-3      # tests/test_decode.py's bar for moe, hybrid, ssm


def close_logits(got, want):
    np.testing.assert_allclose(to_np(got), to_np(want), atol=ATOL, rtol=0)


def close_cache(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    assert got["index"] == int(want["index"])
    for key in (k for k in want if k != "index"):
        w = to_np(want[key])
        np.testing.assert_allclose(to_np(got[key]), w, rtol=0,
                                   atol=ATOL * np.abs(w).max())


def close_step(cfg, tl, tcache, jl, jcache):
    """close_logits and close_cache; for the recurrent families within the
    reference's own decode bar for them (REF_DECODE_ATOL: the logits
    absolute, each cache leaf of its largest |value|)."""
    if cfg.family not in ("hybrid", "ssm"):
        close_logits(tl, jl)
        close_cache(tcache, jcache)
        return
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=0,
                               atol=REF_DECODE_ATOL)
    assert sorted(tcache) == sorted(jcache)
    assert tcache["index"] == int(jcache["index"])
    for key in (k for k in jcache if k != "index"):
        w = to_np(jcache[key])
        np.testing.assert_allclose(to_np(tcache[key]), w, rtol=0,
                                   atol=REF_DECODE_ATOL * np.abs(w).max(),
                                   err_msg=key)


def prompt_len(cfg, s):
    return cfg.frontend_tokens + s if cfg.family == "vlm" else s


@pytest.mark.parametrize("name", DECODERS)
def test_prefill_and_decode_match_reference(name):
    """Logits and every cache leaf after prefill and after each of three
    decode steps, fed the same tokens."""
    jc, tc, jp, tp = pair(name)
    batch = batch_for(jc, 2, 7, seed=1)
    max_len = prompt_len(jc, 7) + 5
    jl, jcache = JD.prefill(jc, jp, as_jax(batch), max_len=max_len)
    tl, tcache = TD.prefill(tc, tp, as_torch(batch), max_len=max_len)
    close_step(tc, tl, tcache, jl, jcache)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (3, 2, 1))
    for tok in toks.astype(np.int32):
        jl, jcache = JD.decode_step(jc, jp, jnp.asarray(tok), jcache)
        tl, tcache = TD.decode_step(tc, tp, torch.from_numpy(tok), tcache)
        close_step(tc, tl, tcache, jl, jcache)
    assert tcache["index"] == prompt_len(jc, 7) + 3


@pytest.mark.parametrize("name", DECODERS)
def test_decode_matches_forward(name):
    """tests/test_decode.py's contract on the port: prefill(S-1) then one
    decode_step gives forward's logits at the last position."""
    from repro_torch.models import model as TM
    _, tc, _, tp = pair(name)
    batch = as_torch(batch_for(tc, 2, 8, seed=3))
    full, _ = TM.forward(tc, tp, batch)
    pre = dict(batch, tokens=batch["tokens"][:, :-1])
    s = prompt_len(tc, 8)
    _, cache = TD.prefill(tc, tp, pre, max_len=s + 4)
    lg, cache = TD.decode_step(tc, tp, batch["tokens"][:, -1:], cache)
    bar = (REF_DECODE_ATOL if tc.family in ("moe", "hybrid", "ssm")
           else ATOL)
    assert float((full[:, -1] - lg[:, 0]).abs().max()) < bar
    assert cache["index"] == s


def test_chunked_prefill_matches_reference(monkeypatch):
    """A 2,100-token prompt at max_len 3072 takes the online-softmax
    chunked path (Sk 3072 > 2 x 1024), then decodes on the direct path.

    The reference runs op by op (``jax.disable_jit``): compiled, its layer
    scan fuses RoPE, and XLA's fused fp32 sin/cos on the CPU part from
    float64 by ~6e-6 of |k| at positions near 2,100 (1.0e-4 on a k of
    16), where op-by-op JAX and the port stay within 1.2e-6
    (test_torch_lm_layers.py::test_rope_is_accurate_at_long_positions)."""
    jc, tc, jp, tp = pair("granite-3-8b")
    calls = []
    chunked = TL._chunked_attention

    def counting(*args, **kwargs):
        calls.append(args[1].shape[1])
        return chunked(*args, **kwargs)

    monkeypatch.setattr(TL, "_chunked_attention", counting)
    batch = batch_for(jc, 1, 2100, seed=4)
    tok = np.full((1, 1), 7, np.int32)
    with jax.disable_jit():
        jl, jcache = JD.prefill(jc, jp, as_jax(batch), max_len=3072)
        jl2, jcache2 = JD.decode_step(jc, jp, jnp.asarray(tok), jcache)
    tl, tcache = TD.prefill(tc, tp, as_torch(batch), max_len=3072)
    assert calls == [3072] * tc.num_layers
    close_logits(tl, jl)
    close_cache(tcache, jcache)
    jl, jcache = jl2, jcache2
    tl, tcache = TD.decode_step(tc, tp, torch.from_numpy(tok), tcache)
    assert calls == [3072] * tc.num_layers
    close_logits(tl, jl)
    close_cache(tcache, jcache)


def test_decode_past_max_len_clamps_as_jax():
    """Past max_len JAX's dynamic_update_slice clamps its start, so each
    new K/V lands on the last slot, overwriting it; the port writes where
    JAX does and gives the same logits and caches."""
    jc, tc, jp, tp = pair("granite-3-8b")
    batch = batch_for(jc, 2, 6, seed=5)
    jl, jcache = JD.prefill(jc, jp, as_jax(batch), max_len=8)
    tl, tcache = TD.prefill(tc, tp, as_torch(batch), max_len=8)
    rng = np.random.default_rng(6)
    last = []
    for _ in range(5):                 # indices 6, 7 fit; 8, 9, 10 clamp
        tok = rng.integers(0, jc.vocab_size, (2, 1)).astype(np.int32)
        jl, jcache = JD.decode_step(jc, jp, jnp.asarray(tok), jcache)
        tl, tcache = TD.decode_step(tc, tp, torch.from_numpy(tok), tcache)
        close_logits(tl, jl)
        close_cache(tcache, jcache)
        last.append(tcache["k"][:, :, -1].clone())
    assert tcache["index"] == 11
    assert all(not torch.equal(a, b) for a, b in zip(last[1:], last[2:]))
    assert bool(torch.isfinite(tl).all())


def test_rolling_window_decode_past_the_window_matches_reference():
    """tests/test_decode.py's long-decode setup (window 4, six prompt
    tokens at max_len 6, eight steps): the cache stays window-sized, each
    step writes slot index % 4, overwriting the oldest position, and the
    logits and every cache leaf follow the reference's."""
    jc, tc, jp, tp = pair("recurrentgemma-2b")
    jc = dataclasses.replace(jc, attn_window=4)
    tc = dataclasses.replace(tc, attn_window=4)
    batch = {"tokens": np.ones((1, 6), np.int32)}
    tok = np.ones((1, 1), np.int32)
    jl, jcache = JD.prefill(jc, jp, as_jax(batch), max_len=6)
    tl, tcache = TD.prefill(tc, tp, as_torch(batch), max_len=6)
    assert tcache["k"].shape[2] == 4
    assert tcache["slot_pos"].tolist() == [4, 5, 2, 3]
    close_step(tc, tl, tcache, jl, jcache)
    for idx in range(6, 14):
        jl, jcache = JD.decode_step(jc, jp, jnp.asarray(tok), jcache)
        tl, tcache = TD.decode_step(tc, tp, torch.from_numpy(tok), tcache)
        close_step(tc, tl, tcache, jl, jcache)
        assert sorted(tcache["slot_pos"].tolist()) == list(range(idx - 3,
                                                                 idx + 1))
        assert tcache["slot_pos"][idx % 4] == idx
    assert tcache["index"] == 14 and bool(torch.isfinite(tl).all())


@pytest.mark.parametrize("s", [3, 4, 7])
def test_fill_rolling_cache_matches_reference(s):
    """Fewer prompt positions than slots, as many, and more: the last
    min(S, w) positions at slot p % w, the rest -1 and zeros; bitwise."""
    rng = np.random.default_rng(s)
    k = rng.standard_normal((2, s, 1, 16)).astype(np.float32)
    v = rng.standard_normal((2, s, 1, 16)).astype(np.float32)
    want = JD._fill_rolling_cache(jnp.asarray(k), jnp.asarray(v), 4)
    got = TD._fill_rolling_cache(torch.from_numpy(k), torch.from_numpy(v), 4)
    for g, w in zip(got, want):
        assert g.dtype == (torch.int32 if g.dim() == 1 else torch.float32)
        np.testing.assert_array_equal(to_np(g), to_np(w))
    assert int((got[2] >= 0).sum()) == min(s, 4)


def _requests(cls, prompts, max_new):
    return [cls(uid=i, prompt=p, max_new=max_new)
            for i, p in enumerate(prompts)]


def _serve_both(name, prompts, max_new, slots=4, max_len=64, **overrides):
    jc, tc, jp, tp = pair(name)
    jc = dataclasses.replace(jc, **overrides)
    tc = dataclasses.replace(tc, **overrides)
    jreqs = JS.ServingEngine(jc, jp, slots=slots, max_len=max_len).run(
        _requests(JS.Request, prompts, max_new))
    eng = TS.ServingEngine(tc, tp, slots=slots, max_len=max_len,
                           device="cpu")
    treqs = eng.run(_requests(TS.Request, prompts, max_new))
    return eng, jreqs, treqs


@pytest.mark.parametrize("name", ["granite-3-8b", "qwen2.5-32b"] + MOES
                         + RECURRENT)
def test_serving_engine_tokens_equal_reference(name):
    """launch/serve.py's requests (seed-0 prompts of 4-31 tokens), two
    groups of four: every greedy token equal to the JAX engine's."""
    cfg = get_config(name).reduce()
    prompts = [r.prompt for r in launch_serve.make_requests(cfg, 8, 8)]
    eng, jreqs, treqs = _serve_both(name, prompts, max_new=8)
    flips = sum(int(np.sum(t.output != j.output))
                for t, j in zip(treqs, jreqs))
    assert flips == 0
    assert all(t.done and t.output.dtype == np.int32 and len(t.output) == 8
               and t.group_size == 4 for t in treqs)
    stats = eng.throughput_stats(treqs)
    assert stats["total_new_tokens"] == 64
    assert sorted(stats) == sorted(JS.ServingEngine(
        *pair(name)[0::2]).throughput_stats(jreqs))


@pytest.mark.parametrize("name", MOES)
def test_moe_engine_tokens_equal_reference_at_published_capacity(
        name, monkeypatch):
    """launch/serve.py's requests at moe_capacity_factor 1.25: the
    prefill of each group (its left padding included) overflows some
    experts' buffers, in both packages alike, and every greedy token
    equals the JAX engine's."""
    calls = []
    dispatch = TMOE._dispatch_indices

    def counting(ids, e, cap):
        order, buf_idx = dispatch(ids, e, cap)
        calls.append(int((buf_idx == e * cap).sum()))
        return order, buf_idx

    monkeypatch.setattr(TMOE, "_dispatch_indices", counting)
    cfg = get_config(name).reduce()
    prompts = [r.prompt for r in launch_serve.make_requests(cfg, 8, 6)]
    _, jreqs, treqs = _serve_both(name, prompts, max_new=6,
                                  moe_capacity_factor=1.25)
    flips = sum(int(np.sum(t.output != j.output))
                for t, j in zip(treqs, jreqs))
    assert flips == 0
    assert sum(calls) > 0, calls


def test_left_padding_is_attended_as_in_reference():
    """A request's tokens depend on its group's longest prompt: the
    left padding (token 0) is not masked, in either package. A partial
    last group pads its slots with its last prompt."""
    cfg = get_config("granite-3-8b").reduce()
    rng = np.random.default_rng(7)
    short = rng.integers(1, cfg.vocab_size, 5).astype(np.int32)
    other = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
    long = rng.integers(1, cfg.vocab_size, 20).astype(np.int32)
    _, ja, ta = _serve_both("granite-3-8b", [short, other], 6, slots=2)
    _, jb, tb = _serve_both("granite-3-8b", [short, long, other], 6,
                            slots=2)
    assert np.array_equal(ta[0].output, ja[0].output)
    assert np.array_equal(tb[0].output, jb[0].output)
    assert np.array_equal(tb[2].output, jb[2].output)
    assert tb[2].group_size == 1
    assert not np.array_equal(ta[0].output, tb[0].output)


@pytest.mark.parametrize("name", RECURRENT)
def test_left_padding_enters_the_recurrent_state(name):
    """In the recurrent families the left padding (token 0) runs through
    the conv and recurrent states, not only the attention: a request's
    tokens depend on its group's longest prompt, as in the reference."""
    cfg = get_config(name).reduce()
    rng = np.random.default_rng(8)
    short = rng.integers(1, cfg.vocab_size, 5).astype(np.int32)
    other = rng.integers(1, cfg.vocab_size, 6).astype(np.int32)
    long = rng.integers(1, cfg.vocab_size, 20).astype(np.int32)
    _, ja, ta = _serve_both(name, [short, other], 6, slots=2)
    _, jb, tb = _serve_both(name, [short, long], 6, slots=2)
    assert np.array_equal(ta[0].output, ja[0].output)
    assert np.array_equal(tb[0].output, jb[0].output)
    assert not np.array_equal(ta[0].output, tb[0].output)


@pytest.mark.parametrize("name", RECURRENT)
def test_launch_serve_recurrent_smoke_on_cpu(name, capsys):
    done = launch_serve.main(["--arch", name, "--smoke", "--device", "cpu",
                              "--requests", "3", "--max-new", "4"])
    assert [len(r.output) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "req 0:" in out and "tokens_per_s" in out


def test_launch_serve_smoke_on_cpu(capsys):
    done = launch_serve.main(["--arch", "granite-3-8b", "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--max-new", "4"])
    assert [len(r.output) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "req 0:" in out and "tokens_per_s" in out


def test_launch_serve_moe_smoke_on_cpu(capsys):
    done = launch_serve.main(["--arch", "granite-moe-3b-a800m", "--smoke",
                              "--device", "cpu", "--requests", "3",
                              "--max-new", "4"])
    assert [len(r.output) for r in done] == [4, 4, 4]
    out = capsys.readouterr().out
    assert "req 0:" in out and "tokens_per_s" in out


def test_engine_refuses_encoders_and_defaults_to_the_card(monkeypatch):
    _, tc, _, tp = pair("granite-3-8b")
    with pytest.raises(ValueError, match="encoder-only"):
        TS.ServingEngine(get_config("hubert-xlarge").reduce(), {},
                         device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.ServingEngine(tc, tp)
