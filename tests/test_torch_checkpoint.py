"""The port's checkpoint manager (repro_torch/checkpoint/manager.py)
against the reference's (repro/checkpoint/manager.py): the same on-disk
layout, manifest and hashes for the same tree, and a checkpoint written by
either package restores bitwise in the other, in fp32 and through the
bf16 deploy cast. Then the reference's own checkpoint cases, mirrored on
the port (tests/test_checkpoint.py)."""
import dataclasses
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as jckpt
from repro.common import materialize
from repro.configs.cronet import get_cronet_config as jget_cronet_config
from repro.core import cronet as jcronet
from repro_torch.checkpoint import manager as ckpt
from repro_torch.common import map_params, params_from_jax
from repro_torch.fea import hybrid


def _jtree():
    return {"a": jnp.arange(12.0).reshape(3, 4),
            "b": {"c": jnp.ones((5,), jnp.bfloat16) * 1.5,
                  "d": jnp.asarray(3)},
            "e": [jnp.asarray([1.0, -2.0]), jnp.asarray([7], jnp.int32)]}


def _ttree():
    """The same tree in the port: tensors, a bf16 leaf, an int scalar and
    a list."""
    return {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16) * 1.5,
                  "d": torch.tensor(3, dtype=torch.int32)},
            "e": [torch.tensor([1.0, -2.0]),
                  torch.tensor([7], dtype=torch.int32)]}


def _leaves(tree):
    return [leaf for _, leaf in ckpt._items(tree)]


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def _jcronet_params(seed=0):
    cfg = dataclasses.replace(jget_cronet_config("small"), nelx=12, nely=4,
                              hist_len=3, dtype="float32")
    return jax.device_get(materialize(jcronet.param_specs(cfg),
                                      jax.random.key(seed)))


# --------------------------------------------------- across the packages


def test_manifest_and_hashes_match_the_reference(tmp_path):
    """The same values saved by either package: equal keys (the reference's
    path joins, dicts in sorted order, list indices), shapes, dtypes (bf16
    upcast to float32) and content hashes, and the same npz members."""
    jpath = jckpt.save(str(tmp_path / "jax"), 3, _jtree(), extras={"x": 1})
    tpath = ckpt.save(str(tmp_path / "torch"), 3, _ttree(), extras={"x": 1})
    jm, tm = _manifest(jpath), _manifest(tpath)
    assert tm == jm
    assert tm["keys"] == ["a", "b/c", "b/d", "e/0", "e/1"]
    assert tm["dtypes"]["b/c"] == "float32"
    with np.load(os.path.join(jpath, "arrays.npz")) as a, \
            np.load(os.path.join(tpath, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    with open(os.path.join(jpath, "extras.json")) as f, \
            open(os.path.join(tpath, "extras.json")) as g:
        assert json.load(f) == json.load(g)
    assert sorted(os.listdir(jpath)) == sorted(os.listdir(tpath))
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(
        os.listdir(tmp_path / "jax"))     # step dir + LATEST


def test_cronet_manifest_matches_the_reference(tmp_path):
    """The registry's own tree, ``{"params": params}``: keys
    ``params/branch/conv1`` and so on, hashes equal to the reference's."""
    jp = _jcronet_params()
    jm = _manifest(jckpt.save(str(tmp_path / "j"), 1, {"params": jp}))
    tm = _manifest(ckpt.save(str(tmp_path / "t"), 1,
                             {"params": params_from_jax(jp, device="cpu")}))
    assert tm == jm
    assert "params/branch/conv1" in tm["keys"]
    assert "params/trunk/fc2" in tm["keys"]


@pytest.mark.parametrize("like_dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_bitwise_in_the_port(tmp_path,
                                                           like_dtype):
    """JAX saves, the port restores: fp32 bitwise equal to
    ``params_from_jax``; into a bf16 like-tree bitwise equal to JAX's
    ``astype(bfloat16)`` (round to nearest even in both)."""
    jp = _jcronet_params()
    jckpt.save(str(tmp_path), 1, {"params": jp})
    want_dt = getattr(torch, like_dtype)
    like = {"params": map_params(
        lambda t: torch.empty(t.shape, dtype=want_dt, device="meta"),
        params_from_jax(jp, device="cpu"))}
    got, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    for part, leaves in jp.items():
        for name, a in leaves.items():
            t = got["params"][part][name]
            assert t.dtype == want_dt and t.device.type == "cpu"
            want = np.asarray(jnp.asarray(a).astype(like_dtype)
                              .astype(jnp.float32))
            np.testing.assert_array_equal(t.float().numpy(), want)


@pytest.mark.parametrize("like_dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_bitwise_in_the_reference(tmp_path,
                                                           like_dtype):
    """The port saves (fp32 and bf16 tensors), JAX restores bitwise."""
    jp = _jcronet_params(1)
    tp = params_from_jax(jp, device="cpu")
    tp["branch"]["fc2"] = tp["branch"]["fc2"].bfloat16()   # upcast on save
    ckpt.save(str(tmp_path), 2, {"params": tp}, extras={"u_scale": 5.0})
    like = {"params": jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, jnp.dtype(like_dtype)), jp)}
    got, extras = jckpt.restore(str(tmp_path), like)
    assert extras == {"u_scale": 5.0}
    for part, leaves in tp.items():
        for name, t in leaves.items():
            a = got["params"][part][name]
            assert a.dtype == jnp.dtype(like_dtype)
            want = t.float().to(getattr(torch, like_dtype)).float()
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                          want.numpy())


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax"),
                                           ("torch", "torch")])
def test_corruption_detected_in_either_direction(tmp_path, writer, reader):
    save = jckpt.save if writer == "jax" else ckpt.save
    path = save(str(tmp_path), 1, _jtree() if writer == "jax" else _ttree())
    npz = os.path.join(path, "arrays.npz")
    data = dict(np.load(npz))
    data["a"] = data["a"] + 1.0           # silent bit-flip
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        if reader == "jax":
            jckpt.restore(str(tmp_path), _jtree())
        else:
            ckpt.restore(str(tmp_path), _ttree(), device="cpu")


def test_non_contiguous_views_hash_their_logical_contents(tmp_path):
    """A transposed view saves and hashes what it shows, not its storage
    order: the hash equals the reference's for the same values."""
    base = torch.arange(12.0).reshape(3, 4)
    path = ckpt.save(str(tmp_path / "t"), 1, {"w": base.t()})
    m = _manifest(path)
    want = hashlib.sha256(np.ascontiguousarray(base.numpy().T).tobytes()
                          ).hexdigest()[:16]
    assert m["hashes"]["w"] == want and m["shapes"]["w"] == [4, 3]
    jm = _manifest(jckpt.save(str(tmp_path / "j"), 1,
                              {"w": jnp.asarray(base.numpy().T)}))
    assert jm["hashes"] == m["hashes"]
    got, _ = ckpt.restore(str(tmp_path / "t"), {"w": base.t()},
                          device="cpu")
    assert torch.equal(got["w"], base.t())


def test_restore_defaults_to_the_card(tmp_path):
    ckpt.save(str(tmp_path), 1, _ttree())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ckpt.restore(str(tmp_path), _ttree())


def test_restore_missing_key_raises(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(str(tmp_path), {"a": torch.zeros(2),
                                     "b": torch.zeros(1)}, device="cpu")


# ------------------------------- the reference's cases, on the port


def test_roundtrip(tmp_path):
    t = _ttree()
    ckpt.save(str(tmp_path), 7, t, extras={"note": "hi"})
    restored, extras = ckpt.restore(str(tmp_path), t, device="cpu")
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert isinstance(restored["e"], list)
    assert extras["note"] == "hi"
    assert ckpt.latest_step(str(tmp_path)) == 7


def test_latest_pointer_and_prune(tmp_path):
    t = _ttree()
    for s in (1, 2, 3, 4):
        ckpt.save(str(tmp_path), s, t)
    assert ckpt.latest_step(str(tmp_path)) == 4
    ckpt.prune_old(str(tmp_path), keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]


def test_restore_into_bf16_like(tmp_path):
    t = _ttree()
    ckpt.save(str(tmp_path), 1, t)
    like = {"a": torch.empty((3, 4), dtype=torch.bfloat16, device="meta"),
            "b": {"c": torch.empty(5, dtype=torch.bfloat16, device="meta"),
                  "d": torch.empty((), dtype=torch.int32, device="meta")}}
    restored, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    assert restored["a"].dtype == torch.bfloat16
    assert torch.equal(restored["a"], t["a"].bfloat16())
    assert torch.equal(restored["b"]["c"], t["b"]["c"])
    assert set(restored) == {"a", "b"}     # the like tree's structure


def test_atomic_no_partial_checkpoint(tmp_path):
    """A leftover .tmp dir from a crashed save must not be visible as a
    checkpoint."""
    t = _ttree()
    ckpt.save(str(tmp_path), 1, t)
    os.makedirs(os.path.join(tmp_path, "step_00000002.tmp"))
    assert ckpt.latest_step(str(tmp_path)) == 1
    restored, _ = ckpt.restore(str(tmp_path), t, device="cpu")
    assert torch.equal(restored["a"], t["a"])


def test_cronet_params_roundtrip_and_bf16_deploy_cast(tmp_path):
    """The CRONet tree survives save -> restore bitwise, and restoring the
    fp32 master weights into a bf16 like-tree equals the serving stack's
    own deploy cast (hybrid.cast_params) exactly."""
    params = params_from_jax(_jcronet_params(), device="cpu")
    ckpt.save(str(tmp_path), 1, {"params": params},
              extras={"u_scale": 50.0})
    restored, extras = ckpt.restore(str(tmp_path), {"params": params},
                                    device="cpu")
    assert extras["u_scale"] == 50.0
    for a, b in zip(_leaves(params), _leaves(restored["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    like = {"params": map_params(
        lambda t: torch.empty(t.shape, dtype=torch.bfloat16, device="meta"),
        params)}
    cast, _ = ckpt.restore(str(tmp_path), like, device="cpu")
    want = hybrid.cast_params(params, "bf16")
    for a, b in zip(_leaves(want), _leaves(cast["params"])):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b)


def test_prune_old_keeps_pinned_versions(tmp_path):
    t = _ttree()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, t)
    removed = ckpt.prune_old(str(tmp_path), keep=2, pinned=(1, 3))
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    assert steps == [1, 3, 4, 5]          # pinned 1,3 + newest 2 unpinned
    assert removed == [2]
    restored, _ = ckpt.restore(str(tmp_path), t, step=3, device="cpu")
    assert torch.equal(restored["a"], t["a"])
