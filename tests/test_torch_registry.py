"""The port's model registry (repro_torch/serve/registry.py) on one on-disk
registry shared with the JAX package: a version either package registers
loads bitwise into the other (fp32 and the bf16 deploy cast), the index
entries and manifests agree, corruption is caught in either direction, and
a lease held by a live process of one package makes the other's ``prune``
and ``sweep`` defer the tag. Then the reference's own registry cases,
mirrored on the port (tests/test_surrogate_lifecycle.py), and
``engine_from_spec`` in both spec forms."""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import materialize
from repro.configs.cronet import get_cronet_config as jget_cronet_config
from repro.core import cronet as jcronet
from repro.serve.registry import ModelRegistry as JRegistry
from repro_torch.common import map_params, params_from_jax
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.fea import fea2d
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import (ModelRegistry, ModelResolver, NoModelError,
                               TopoGateway, TopoRequest, TopoServingEngine)
from repro_torch.serve.registry import cfg_from_dict, cfg_to_dict
from repro_torch.serve.topo_service import engine_from_spec

ROOT = Path(__file__).resolve().parents[1]
CFG = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                          hist_len=3)
JCFG = dataclasses.replace(jget_cronet_config("small"), nelx=12, nely=4,
                           hist_len=3)
U_SCALE = 50.0


@pytest.fixture(scope="module")
def jparams():
    return jax.device_get(materialize(jcronet.param_specs(
        dataclasses.replace(JCFG, dtype="float32")), jax.random.key(0)))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_jax(jparams, device="cpu")


def _plus(params, c):
    return map_params(lambda t: t + c, params)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _problem(i=0):
    return fea2d.point_load_problem(12, 4, load_node=(i, 0),
                                    load=(0.0, -1.0 - 0.1 * i))


# --------------------------------------------------- across the packages


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_registered_version_loads_bitwise_in_the_port(tmp_path, jparams,
                                                          dtype):
    JRegistry(str(tmp_path)).register(jparams, JCFG, U_SCALE, tag="j")
    got, rec = ModelRegistry(str(tmp_path)).load("j", dtype=dtype,
                                                 device="cpu")
    assert rec.cfg == CFG and rec.u_scale == U_SCALE
    want = params_from_jax(jax.tree.map(
        lambda a: jnp.asarray(a).astype(dtype), jparams), device="cpu")
    for part, leaves in want.items():
        for name, w in leaves.items():
            t = got[part][name]
            assert t.dtype == getattr(torch, dtype)
            np.testing.assert_array_equal(_bits(t), _bits(w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_registered_version_loads_bitwise_in_the_reference(
        tmp_path, tparams, dtype):
    ModelRegistry(str(tmp_path)).register(tparams, CFG, U_SCALE, tag="t")
    got, rec = JRegistry(str(tmp_path)).load("t", dtype=dtype)
    assert rec.cfg == JCFG
    for part, leaves in tparams.items():
        for name, t in leaves.items():
            a = got[part][name]
            assert a.dtype == jnp.dtype(dtype)
            np.testing.assert_array_equal(
                np.asarray(a.astype(jnp.float32)),
                _bits(t.to(getattr(torch, dtype))))


def test_index_manifest_and_lease_files_match_the_reference(tmp_path,
                                                            jparams,
                                                            tparams):
    """The same registration in either package writes the same index entry
    (``created_at`` aside), the same manifest and the same lease file."""
    jreg = JRegistry(str(tmp_path / "j"))
    treg = ModelRegistry(str(tmp_path / "t"))
    kw = dict(tag="m", metrics={"acceptance": 0.5},
              load_cases=[{"kind": "mbb"}], mesh=(12, 4), parent=None)
    jreg.register(jparams, JCFG, U_SCALE, **kw)
    treg.register(tparams, CFG, U_SCALE, **kw)
    jreg.promote("m"), treg.promote("m")
    jreg.pin("m"), treg.pin("m")

    def entries(root):
        with open(os.path.join(root, "registry.json")) as f:
            text = f.read()
        idx = json.loads(text)
        for e in idx["versions"]:
            e.pop("created_at"), e.pop("promoted_at")
        return idx, text.count("\n")

    assert entries(tmp_path / "t") == entries(tmp_path / "j")   # indent=1
    for sub in ("ckpts/step_00000001/manifest.json",
                "ckpts/step_00000001/extras.json"):
        with open(tmp_path / "j" / sub) as f, open(tmp_path / "t" / sub) as g:
            assert json.load(g) == json.load(f)
    jreg.acquire("m"), treg.acquire("m")
    jl, tl = (sorted(os.listdir(tmp_path / s / "leases")) for s in "jt")
    assert jl == tl and len(tl) == 1 and tl[0].endswith(f".{os.getpid()}.json")
    with open(tmp_path / "j" / "leases" / jl[0]) as f, \
            open(tmp_path / "t" / "leases" / tl[0]) as g:
        assert json.load(g) == json.load(f)
    jreg.release("m"), treg.release("m")
    assert os.listdir(tmp_path / "t" / "leases") == []


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_corruption_detected_across_packages(tmp_path, jparams, tparams,
                                             writer):
    if writer == "jax":
        JRegistry(str(tmp_path)).register(jparams, JCFG, U_SCALE, tag="x")
    else:
        ModelRegistry(str(tmp_path)).register(tparams, CFG, U_SCALE, tag="x")
    npz = tmp_path / "ckpts" / "step_00000001" / "arrays.npz"
    data = dict(np.load(npz))
    data["params/trunk/fc2"] = data["params/trunk/fc2"] * 1.0001
    np.savez(npz, **data)
    with pytest.raises(IOError, match="corruption"):
        if writer == "jax":
            ModelRegistry(str(tmp_path)).load("x", device="cpu")
        else:
            JRegistry(str(tmp_path)).load("x")


_HOLDER = """
import sys
sys.path.insert(0, {src!r})
from {module} import ModelRegistry
reg = ModelRegistry({root!r})
reg.acquire("m1")
print("held", flush=True)
sys.stdin.readline()       # hold the lease until the parent kills us
"""


@pytest.mark.parametrize("holder", ["jax", "torch"])
def test_foreign_lease_defers_prune_and_sweep(tmp_path, jparams, tparams,
                                              holder):
    """A live process of the other package leases m1: this package's
    prune and sweep defer it. Killed without releasing, its lease file is
    stale and the next scan reaps it, after which m1 is reclaimable."""
    if holder == "jax":       # the port prunes what JAX serves
        mine, module = ModelRegistry(str(tmp_path)), "repro.serve.registry"
        params, cfg = tparams, CFG
    else:                     # JAX prunes what the port serves
        mine, module = JRegistry(str(tmp_path)), "repro_torch.serve.registry"
        params, cfg = jparams, JCFG
    for i in range(4):        # one lineage, so sweep groups them together
        mine.register(params, cfg, float(i), tag=f"m{i}",
                      parent=f"m{i - 1}" if i else None)
    code = _HOLDER.format(src=str(ROOT / "src"), module=module,
                          root=str(tmp_path))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    child = subprocess.Popen([sys.executable, "-c", code], env=env,
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True)
    try:
        assert child.stdout.readline().strip() == "held"
        assert mine.foreign_leases() == {"m1": 1}
        assert mine.leased() == {}
        assert mine.sweep(keep_per_lineage=1) == ["m0", "m2"]
        assert mine.tags() == ["m1", "m3"]
        assert mine.prune(keep=0) == ["m3"]        # m1 deferred
        assert mine.tags() == ["m1"]
    finally:
        child.kill()
        child.wait(timeout=30)
        child.stdout.close()
        child.stdin.close()
    assert len(os.listdir(tmp_path / "leases")) == 1   # stale, not reaped yet
    assert mine.foreign_leases() == {}                  # the scan reaps it
    assert os.listdir(tmp_path / "leases") == []
    assert mine.prune(keep=0) == ["m1"]


# ------------------------------- the reference's cases, on the port


def test_registry_register_get_load_roundtrip(tmp_path, tparams):
    reg = ModelRegistry(str(tmp_path))
    with pytest.raises(NoModelError):
        reg.load(device="cpu")
    reg.register(tparams, CFG, 42.0, tag="a", metrics={"acceptance": 0.5})
    reg.register(tparams, CFG, 43.0)            # auto tag v2
    assert reg.tags() == ["a", "v2"] and len(reg) == 2
    assert reg.latest().tag == "v2"
    got = reg.get("a")
    assert got.u_scale == 42.0 and got.version == 1
    assert got.metrics["acceptance"] == 0.5
    assert got.cfg == CFG                       # tuples survive the json
    assert isinstance(got.cfg.t_pool, tuple)
    assert cfg_from_dict(json.loads(json.dumps(cfg_to_dict(CFG)))) == CFG
    params, rec2 = reg.load("a", device="cpu")
    assert rec2.tag == "a"
    for part, leaves in tparams.items():
        for name, t in leaves.items():
            assert torch.equal(params[part][name], t)
    with pytest.raises(ValueError, match="already registered"):
        reg.register(tparams, CFG, 1.0, tag="a")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            reg.load("a")                       # the card by default


def test_registry_prune_respects_pins(tmp_path, tparams):
    reg = ModelRegistry(str(tmp_path))
    for i in range(5):
        reg.register(tparams, CFG, float(i), tag=f"m{i}", pin=(i == 1))
    dropped = reg.prune(keep=2)
    assert dropped == ["m0", "m2"]              # m1 pinned, m3/m4 newest
    assert reg.tags() == ["m1", "m3", "m4"]
    reg.load("m1", device="cpu")                # pinned stays restorable
    reg.pin("m1", pinned=False)
    assert reg.prune(keep=2) == ["m1"]


def test_registry_latest_tie_breaks_mesh_specialized_tags(tmp_path,
                                                          tparams):
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams, CFG, 1.0, tag="fleet1")
    reg.register(tparams, CFG, 2.0, tag="spec-a", mesh=(12, 4))
    assert reg.latest().tag == "fleet1"       # specialized did not win
    assert reg.latest(mesh=(12, 4)).tag == "spec-a"
    assert reg.latest(mesh=(10, 6)) is None
    reg.register(tparams, CFG, 3.0, tag="spec-b", mesh=(12, 4))
    reg.register(tparams, CFG, 4.0, tag="fleet2")
    assert reg.latest().tag == "fleet2"
    assert reg.latest(mesh=(12, 4)).tag == "spec-b"   # newest of ITS mesh
    assert reg.get("spec-a").mesh == (12, 4)          # json round-trips
    res = ModelResolver(reg, default_tag="fleet1", device="cpu")
    assert res.resolve((12, 4)).tag == "spec-b"
    assert res.resolve((10, 6)).tag == "fleet1"
    res.default_tag = None
    assert res.resolve((10, 6)).tag == "fleet2"       # falls to latest()


def test_registry_prune_defers_served_and_canaried_versions(tmp_path,
                                                            tparams):
    reg = ModelRegistry(str(tmp_path))
    for i in range(4):
        reg.register(tparams, CFG, float(i), tag=f"m{i}")
    reg.acquire("m1")                             # direct lease
    dropped = reg.prune(keep=1)
    assert set(dropped) == {"m0", "m2"}           # m1 live, m3 newest
    reg.load("m1", device="cpu")                  # still restorable
    gw = TopoGateway.from_registry(reg, tag="m1", device="cpu",
                                   engine_factory=lambda x, y: None)
    gw.canary("m3", fraction=0.5, mesh=(12, 4), auto_rollback=False)
    assert reg.leased() == {"m1": 2, "m3": 1}
    assert reg.prune(keep=0) == []                # everything live
    gw.rollback(mesh=(12, 4), timeout=10)         # canary lease released
    assert reg.leased() == {"m1": 2}
    assert reg.prune(keep=0) == ["m3"]            # m1 still deferred
    gw.shutdown()                                 # gateway lease released
    assert reg.leased() == {"m1": 1}
    reg.release("m1")
    assert reg.leased() == {}
    assert reg.prune(keep=0) == ["m1"]
    with pytest.raises(NoModelError):
        reg.load("m1", device="cpu")


def test_registry_promote_stamps_promotion_metadata(tmp_path, tparams):
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams, CFG, 1.0, tag="a")
    assert reg.get("a").promoted_at is None
    first = reg.promote("a").promoted_at
    assert first
    assert reg.promote("a").promoted_at == first   # idempotent
    with pytest.raises(NoModelError):
        reg.promote("ghost")


def test_registry_sweep_keeps_newest_per_lineage(tmp_path, tparams):
    """Within each (mesh, lineage root) group the newest K survive; pinned
    and leased versions ride on top."""
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams, CFG, 1.0, tag="root")
    for i in range(3):
        reg.register(tparams, CFG, 1.0, tag=f"c{i}", mesh=(12, 4),
                     parent="root" if i == 0 else f"c{i - 1}")
    reg.register(tparams, CFG, 1.0, tag="fleet2", parent="root")
    reg.pin("c0")
    # groups: (None, root) = root, fleet2; ((12, 4), root) = c0..c2
    assert reg.sweep(keep_per_lineage=1) == ["root", "c1"]
    assert reg.tags() == ["c0", "c2", "fleet2"]


def test_resolver_cache_invalidated_on_reregister(tmp_path, tparams):
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams, CFG, 1.0, tag="a")
    res = ModelResolver(reg, device="cpu")
    p1, rec1 = res.load("a")
    assert rec1.u_scale == 1.0 and res.holds("a", p1)
    assert reg.prune(keep=0) == ["a"]
    params2 = _plus(tparams, 1.0)
    reg.register(params2, CFG, 2.0, tag="a")       # same tag, new params
    p2, rec2 = res.load("a")
    assert rec2.u_scale == 2.0 and not res.holds("a", p1)
    for part, leaves in params2.items():
        for name, t in leaves.items():
            assert torch.equal(p2[part][name], t)
    assert res.load("a")[1] is rec2                # no thrash
    other = ModelRegistry(str(tmp_path))           # generation: per process
    assert other.generation == 0 and reg.generation == 3


def test_resolver_and_gateway_refuse_a_tree_on_another_device(tmp_path,
                                                              tparams):
    """The resolver and the gateway load onto one device; a tree on
    another is an error, not a silent copy (meta stands in for the card
    here)."""
    reg = ModelRegistry(str(tmp_path))
    rec = reg.register(tparams, CFG, 1.0, tag="a")
    elsewhere = map_params(lambda t: t.to("meta"), tparams)
    res = ModelResolver(reg, device="cpu")
    with pytest.raises(ValueError, match="serving device"):
        res.prime("a", elsewhere, rec)
    with pytest.raises(ValueError, match="serving device"):
        TopoGateway(CFG, elsewhere, U_SCALE, device="cpu")
    gw = TopoGateway.from_registry(reg, "a", device="cpu")
    with pytest.raises(ValueError, match="serving device"):
        gw.swap_model("b", params=elsewhere)
    gw.shutdown()


def test_cached_tree_is_never_written_by_serving(tmp_path, tparams):
    """Torch tensors are mutable and the resolver's cached tree is shared
    by every engine of a tag: after serving two meshes from it, through a
    canary and a promotion, it still equals a fresh load."""
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams, CFG, U_SCALE, tag="a")
    reg.register(_plus(tparams, 0.01), CFG, U_SCALE, tag="b")
    gw = TopoGateway.from_registry(reg, "a", slots=2, device="cpu",
                                   error_threshold=1e9)
    gw.canary("b", fraction=0.5, mesh=(12, 4), auto_rollback=False)
    futs = [gw.submit(TopoRequest(uid=i, problem=p, n_iter=5))
            for i, p in enumerate([_problem(0), _problem(3),
                                   fea2d.point_load_problem(10, 6)])]
    assert all(f.result(timeout=120).done for f in futs)
    gw.promote(mesh=(12, 4), timeout=60)
    cached = {t: gw._resolver.load(t)[0] for t in ("a", "b")}
    gw.shutdown()
    for tag, tree in cached.items():
        fresh, _ = reg.load(tag, device="cpu")
        for part, leaves in fresh.items():
            for name, t in leaves.items():
                assert torch.equal(tree[part][name], t), (tag, part, name)


# ------------------------------------------------------- engine_from_spec


def _run(eng, n=2):
    done = eng.run([TopoRequest(uid=i, problem=_problem(i), n_iter=5)
                    for i in range(n)])
    eng.shutdown()
    return done


def test_engine_from_spec_params_and_registry_forms(tmp_path, tparams):
    """Both spec forms build an engine whose densities equal a directly
    built engine's bitwise; the registry form takes tag and u_scale from
    the record. The gateway's ``_engine_spec`` ships a registry reference
    only for params its resolver provably read, else the tree."""
    kw = dict(device="cpu", error_threshold=1e9, metrics=MetricsRegistry())
    reg = ModelRegistry(str(tmp_path))
    reg.register(tparams, CFG, U_SCALE, tag="a")
    ref = _run(TopoServingEngine(CFG, tparams, U_SCALE, slots=2,
                                 model_tag="a", **kw))
    by_params = _run(engine_from_spec(
        {"cfg": CFG, "params": tparams, "u_scale": U_SCALE, "slots": 2,
         "model_tag": "a", "engine_kwargs": kw}))
    by_registry = _run(engine_from_spec(
        {"cfg": CFG, "registry_root": str(tmp_path), "model_tag": "a",
         "slots": 2, "engine_kwargs": kw}))
    for r, a, b in zip(ref, by_params, by_registry):
        np.testing.assert_array_equal(a.density, r.density)
        np.testing.assert_array_equal(b.density, r.density)
        assert a.model_tag == b.model_tag == "a"
    gw = TopoGateway.from_registry(reg, "a", slots=2, device="cpu")
    spec = gw._engine_spec(CFG, (12, 4), "a", gw.params, U_SCALE, slots=2)
    assert spec["registry_root"] == str(tmp_path) and "params" not in spec
    assert spec["engine_kwargs"]["device"] == torch.device("cpu")
    pinned = gw._engine_spec(CFG, (12, 4), "a", _plus(tparams, 0.0),
                             U_SCALE, slots=2)
    assert "registry_root" not in pinned and "params" in pinned
    gw.shutdown()
    with pytest.raises(ValueError, match="params or registry_root"):
        engine_from_spec({"cfg": CFG, "slots": 2})


@pytest.mark.parametrize("knob", ["fea_backend", "backend"])
def test_engine_from_spec_rejects_the_jax_backends(tparams, knob):
    """The port's engine has no backend knobs: the device decides. A spec
    that names one is an error, not ignored."""
    with pytest.raises(TypeError, match=knob):
        engine_from_spec({"cfg": CFG, "params": tparams, "u_scale": U_SCALE,
                          "slots": 2, "engine_kwargs": {
                              "device": "cpu", knob: "fused"}})
