"""Port parity for the LM layers, configurations and parameter creation:
repro_torch.models.layers against repro.models.layers, the port's
registry against repro.configs, and repro_torch.common.materialize's
rules, on the CPU.

Inputs come from numpy seeds and reach both packages as the same values.
Tolerances: fp32 1e-5 absolute on O(1) values (a few ulps of the largest
term: the two packages sum in other orders); bf16 four bf16 ulps of the
largest value (2^-6): an intermediate rounded to bf16 may land one ulp
apart (the reference rounds silu(x W_g) and its product with x W_u
separately), and a later product sums such ulps. The traps
of the port are checked where they part: the tanh GELU, the -1e30 vocab
mask, RoPE's halves at positions up to 4096, the norms' fp32 interior.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as JB
from repro.configs.all import ASSIGNED
from repro.models import layers as JL
from repro_torch.common import (ParamSpec, cast_tree, map_params,
                                materialize, param_bytes, param_count,
                                tree_bytes, tree_leaves)
from repro_torch.configs import base as TB
from repro_torch.configs.lm import get_lm_config
from repro_torch.models import layers as TL

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -6


def _pair(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor in ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    t = torch.from_numpy(a)
    return j, (t.bfloat16() if dtype == "bfloat16" else t)


def _close(port: torch.Tensor, want, dtype: str, scale: float = 1.0):
    assert port.dtype == (torch.bfloat16 if dtype == "bfloat16"
                          else torch.float32)
    got = port.float().numpy()
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_TOL * scale, rtol=0)
    else:
        bar = BF16_RTOL * max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(got, want, atol=bar, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 64)) * 30).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(a, dtype) for a in (x, w, b))
    _close(TL.rms_norm(tx, tw, 1e-6), JL.rms_norm(jx, jw, 1e-6), dtype)
    _close(TL.layer_norm(tx, tw, tb), JL.layer_norm(jx, jw, jb), dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference_up_to_4096(dtype, d, theta):
    """Half-split rotation, fp32 angles positions x 1/theta^(2i/d), at
    positions up to 4096 (an fp32 angle there is good to ~2.4e-4 rad;
    both packages round the same product, so they agree far closer)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4097, size=(2, 64)).astype(np.int32)
    pos[0, :2] = (0, 4096)
    jx, tx = _pair(x, dtype)
    want = JL.apply_rope(jx, jnp.asarray(pos), theta)
    got = TL.apply_rope(tx, torch.from_numpy(pos), theta)
    _close(got, want, dtype)
    np.testing.assert_allclose(TL.rope_freqs(d, theta).numpy(),
                               np.asarray(JL.rope_freqs(d, theta)),
                               rtol=2e-7, atol=0)
    # an interleaved-pairs rotation would part from the reference
    if dtype == "float32":
        x1, x2 = tx[..., 0::2], tx[..., 1::2]
        ang = torch.from_numpy(pos)[..., None, None].float() \
            * TL.rope_freqs(d, theta)
        inter = torch.stack([x1 * ang.cos() - x2 * ang.sin(),
                             x2 * ang.cos() + x1 * ang.sin()], -1).flatten(-2)
        assert np.abs(inter.numpy() - np.asarray(want)).max() > 1e-2


def test_rope_is_accurate_at_long_positions():
    """Over every position of a 2,100-token prompt the port's RoPE stays
    within a few fp32 ulps of a float64 rotation of the same fp32 angles
    (1.2e-6 on values up to ~16; so does the reference called op by op,
    while its compiled form, with XLA's fused sin/cos, parts by 1.0e-4)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((1, 2100, 2, 16)) * 4).astype(np.float32)
    pos = np.arange(2100, dtype=np.int32)[None]
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    ang = (pos[..., None].astype(np.float32)
           * TL.rope_freqs(16, 1e4).numpy()).astype(np.float64)
    cos, sin = np.cos(ang)[:, :, None], np.sin(ang)[:, :, None]
    x1, x2 = x[..., :8].astype(np.float64), x[..., 8:].astype(np.float64)
    truth = np.concatenate([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    assert np.abs(got.numpy() - truth).max() <= 1e-7 * np.abs(truth).max()
    eager = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    assert np.abs(np.asarray(eager) - truth).max() <= \
        1e-7 * np.abs(truth).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlps_match_reference_and_gelu_is_tanh(dtype):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 6, 32)) * 2).astype(np.float32)
    ws = [(rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
          for s in ((32, 48), (32, 48), (48, 32))]
    bs = [rng.standard_normal(n).astype(np.float32) for n in (48, 32)]
    (jx, tx), = [_pair(x, dtype)]
    jw, tw = zip(*(_pair(w, dtype) for w in ws))
    jb, tb = zip(*(_pair(b, dtype) for b in bs))
    _close(TL.swiglu_mlp(tx, *tw), JL.swiglu_mlp(jx, *jw), dtype)
    want = JL.gelu_mlp(jx, jw[0], jb[0], jw[2], jb[1])
    _close(TL.gelu_mlp(tx, tw[0], tb[0], tw[2], tb[1]), want, dtype)
    if dtype == "float32":
        # PyTorch's default GELU (erf) parts from jax.nn.gelu's tanh form
        erf = torch.nn.functional.gelu(tx @ tw[0] + tb[0]) @ tw[2] + tb[1]
        assert np.abs(erf.numpy() - np.asarray(want)).max() > 10 * F32_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_logits_mask_and_loss_match_reference(dtype):
    """Padded vocab columns are -1e30 (not -inf) in both packages, and the
    greedy token over the real vocab is the same (first maximum)."""
    rng = np.random.default_rng(3)
    vocab, vpad, d = 250, 256, 32
    table = rng.standard_normal((vpad, d)).astype(np.float32)
    unembed = rng.standard_normal((d, vpad)).astype(np.float32)
    tokens = rng.integers(0, vocab, (2, 7)).astype(np.int32)
    (jt, tt), (ju, tu) = _pair(table, dtype), _pair(unembed, dtype)
    je = JL.embed(jnp.asarray(tokens), jt)
    te = TL.embed(torch.from_numpy(tokens), tt)
    assert np.array_equal(te.float().numpy(),
                          np.asarray(je.astype(jnp.float32)))
    jlg = JL.logits(je, ju, vocab)
    tlg = TL.logits(te, tu, vocab)
    _close(tlg[..., :vocab], jlg[..., :vocab], dtype, scale=10)
    pad_j = np.asarray(jlg[..., vocab:].astype(jnp.float32))
    pad_t = tlg[..., vocab:].float().numpy()
    assert np.array_equal(pad_t, pad_j)
    assert np.all(np.isfinite(pad_t))
    assert float(pad_t.max()) == float(np.float32(
        torch.tensor(-1e30, dtype=tlg.dtype).float()))
    np.testing.assert_array_equal(
        tlg[..., :vocab].argmax(-1).numpy(),
        np.asarray(jnp.argmax(jlg[..., :vocab], axis=-1)))
    labels = tokens.copy()
    labels[0, :3] = -1
    jl = JL.cross_entropy_loss(jlg, jnp.asarray(labels), vocab)
    tl = TL.cross_entropy_loss(tlg, torch.from_numpy(labels), vocab)
    assert tl.dtype == torch.float32
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ASSIGNED)
def test_config_registry_matches_reference(name):
    mine, theirs = TB.get_config(name), JB.get_config(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for prop in ("hd", "padded_vocab", "subquadratic", "has_decode"):
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert dataclasses.asdict(mine.reduce()) == \
        dataclasses.asdict(theirs.reduce())
    assert str(mine.torch_dtype) == "torch." + str(theirs.jnp_dtype)
    assert [s.name for s in TB.applicable_shapes(mine)] == \
        [s.name for s in JB.applicable_shapes(theirs)]


def test_registry_lists_the_same_configurations_and_shapes():
    assert sorted(TB.list_configs()) == sorted(JB.list_configs())
    assert {k: dataclasses.asdict(v) for k, v in TB.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JB.SHAPES.items()}
    with pytest.raises(KeyError):
        TB.get_config("no-such-model")


def test_lm_widths_come_from_the_registry():
    """configs/lm.py reads the ported registry and gives the widths it
    held as its own table before."""
    q, x = get_lm_config("qwen2.5-32b"), get_lm_config("xlstm-1.3b")
    assert (q.d_model, q.num_heads, q.num_kv_heads, q.head_dim, q.dtype) \
        == (5120, 40, 8, 128, "bfloat16")
    assert (x.d_model, x.num_heads, x.num_kv_heads, x.head_dim, x.dtype) \
        == (2048, 4, 4, 512, "bfloat16")
    g = get_lm_config("granite-3-8b")
    assert (g.d_model, g.num_heads, g.num_kv_heads, g.head_dim) == \
        (4096, 32, 8, 128)


# ---------------------------------------------------------- materialize


def test_materialize_moments_and_the_shape0_rule():
    """"normal" takes fan_in = shape[0]: on a stacked (layers, d, k)
    weight that is the layer count (std 1/sqrt(4) here, not 1/sqrt(256)),
    as the reference's _resolve_init does."""
    specs = {
        "stacked": ParamSpec((4, 256, 512), ("layers", None, None),
                             "normal", torch.float32),
        "flat": ParamSpec((1024, 256), (None, None), "normal", torch.float32),
        "scaled": ParamSpec((256, 512), (None, None), ("scaled", 64),
                            torch.float32),
        "uni": ParamSpec((512, 256), (None, None), ("uniform", 0.5),
                         torch.float32),
        "ones": ParamSpec((8,), (None,), "ones", torch.bfloat16),
        "zeros": ParamSpec((8,), (None,), "zeros", torch.bfloat16),
        "const": ParamSpec((3,), (None,), ("constant", 2.5), torch.float32),
        "bf": ParamSpec((2, 64, 64), ("layers", None, None)),
    }
    p = materialize(specs, seed=0, device="cpu")
    for key, std in (("stacked", 0.5), ("flat", 1 / 32), ("scaled", 1 / 8),
                     ("bf", 2 ** -0.5)):
        t = p[key].float()
        assert abs(float(t.std()) / std - 1) < 0.02, key
        assert abs(float(t.mean())) < 0.02 * std, key
    u = p["uni"]
    assert float(u.min()) >= -0.5 and float(u.max()) <= 0.5
    assert abs(float(u.var()) - 0.25 / 3) < 0.002
    assert torch.equal(p["ones"], torch.ones(8, dtype=torch.bfloat16))
    assert torch.equal(p["zeros"], torch.zeros(8, dtype=torch.bfloat16))
    assert torch.equal(p["const"], torch.full((3,), 2.5))
    assert p["bf"].dtype == torch.bfloat16
    assert param_count(specs) == sum(t.numel() for _, t in tree_leaves(p))
    assert param_bytes(specs) == tree_bytes(p)
    # one seed, one tree whatever the dict order; another seed differs
    again = materialize(dict(reversed(list(specs.items()))), seed=0,
                        device="cpu")
    assert all(torch.equal(p[k], again[k]) for k in specs)
    other = materialize(specs, seed=1, device="cpu")
    assert not torch.equal(p["flat"], other["flat"])


def test_tree_helpers_walk_any_depth():
    tree = {"b": {"y": torch.ones(2), "x": {"z": torch.zeros(3)}},
            "a": torch.ones(1, dtype=torch.bfloat16)}
    assert [k for k, _ in tree_leaves(tree)] == ["a", "b/x/z", "b/y"]
    doubled = map_params(lambda t: t * 2, tree)
    assert torch.equal(doubled["b"]["x"]["z"], torch.zeros(3))
    assert list(doubled["b"]) == ["y", "x"]
    cast = cast_tree(tree, torch.float32)
    assert cast["a"].dtype == torch.float32
    assert tree_bytes(tree) == 2 * 4 + 3 * 4 + 2


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"w": ParamSpec((2, 2), (None, None))}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        materialize(spec, seed=0)
