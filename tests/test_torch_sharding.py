"""``repro_torch.parallel.sharding`` and ``launch.mesh`` against the JAX
package, without a mesh of devices.

- The spec of every leaf of ``param_specs`` of the ten configurations at
  full size equals ``repro.parallel.sharding._trim_indivisible(
  logical_to_pspec(...))`` on a JAX ``AbstractMesh`` (no devices) of both
  production shapes, 16x16 and 2x16x16; and its placements shard each
  tensor dim on the mesh dims its spec names (pod major).
- ``rules_without_pod``, ``use_rules`` nesting, and a stand-in mapping
  without the trim, which must fail.
- ``constrain`` / ``gathered`` return a plain tensor as it is; a mesh
  without a process group raises, and so does a production mesh on a
  smaller world; a one-rank group builds a (1, 1) mesh whose shardings
  carry the same specs.
"""
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro.parallel import sharding as JS
from repro_torch.common import tree_leaves
from repro_torch.configs.all import ASSIGNED
from repro_torch.configs.base import get_config
from repro_torch.launch import mesh as LM
from repro_torch.models import model as TM
from repro_torch.parallel import sharding as SH

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _ref_spec(spec, mesh):
    return tuple(JS._trim_indivisible(
        JS.logical_to_pspec(spec.logical_axes, JS.DEFAULT_RULES, mesh),
        spec.shape, mesh))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", ASSIGNED)
def test_param_specs_match_reference(name, mesh):
    from torch.distributed.tensor import Replicate, Shard

    sizes = MESHES[mesh]
    jm = _abstract(sizes)
    mine = dict(tree_leaves(TM.param_specs(get_config(name))))
    theirs = dict(tree_leaves(JM.param_specs(jget_config(name))))
    assert sorted(mine) == sorted(theirs)
    order = list(sizes)
    for path, spec in mine.items():
        got = SH._trim_indivisible(
            SH.logical_to_pspec(spec.logical_axes, SH.DEFAULT_RULES, sizes),
            spec.shape, sizes)
        assert got == _ref_spec(theirs[path], jm), path
        want = [Replicate()] * len(order)
        for dim, part in enumerate(got):
            for axis in (part,) if isinstance(part, str) else part or ():
                want[order.index(axis)] = Shard(dim)
        assert SH.placements(got, sizes) == tuple(want), path


def test_untrimmed_stand_in_fails():
    """Without ``_trim_indivisible`` some leaf would shard a dim its mesh
    axes do not divide (qwen2.5-32b's 40 heads, odd vocabularies)."""
    sizes = MESHES["16x16"]
    jm = _abstract(sizes)
    parted = 0
    for name in ASSIGNED:
        for path, spec in tree_leaves(JM.param_specs(jget_config(name))):
            got = SH.logical_to_pspec(spec.logical_axes, SH.DEFAULT_RULES,
                                      sizes)
            parted += got != _ref_spec(spec, jm)
    assert parted > 0


def test_rules_without_pod_and_use_rules_nesting():
    assert SH.rules_without_pod(SH.DEFAULT_RULES) == \
        JS.rules_without_pod(JS.DEFAULT_RULES)
    assert SH.DEFAULT_RULES == JS.DEFAULT_RULES
    a, b = SH.rules_without_pod(SH.DEFAULT_RULES), {"fsdp": ()}
    assert SH.active_rules() is SH.DEFAULT_RULES
    with SH.use_rules(a) as ra:
        assert ra is a and SH.active_rules() is a
        with SH.use_rules(b):
            assert SH.active_rules() is b
        assert SH.active_rules() is a
    assert SH.active_rules() is SH.DEFAULT_RULES


def test_pod_major_placements():
    from torch.distributed.tensor import Replicate, Shard

    sizes = MESHES["2x16x16"]
    spec = SH.logical_to_pspec(("batch", None, "act_tp"), SH.DEFAULT_RULES,
                               sizes)
    assert spec == (("pod", "data"), None, "model")
    assert SH.placements(spec, sizes) == (Shard(0), Shard(0), Shard(2))
    assert SH.placements((), sizes) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        SH.placements((("data", "pod"),), sizes)


def test_constrain_and_gathered_leave_plain_tensors():
    t = torch.ones(4, 8)
    assert SH.constrain(t, ("batch", "act_tp")) is t
    assert SH.gathered(t, ("fsdp", "tp")) is t


def test_mesh_without_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        LM.make_debug_mesh((1, 1), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        LM.make_production_mesh(device="cpu")


def test_one_rank_mesh(tmp_path):
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        with pytest.raises(RuntimeError, match="256 ranks"):
            LM.make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="512 ranks"):
            LM.make_production_mesh(multi_pod=True, device="cpu")
        mesh = LM.make_debug_mesh((1, 1), device="cpu")
        assert LM.batch_axes(mesh) == ("data",) and LM.dp_degree(mesh) == 1
        specs = TM.param_specs(get_config("granite-8b").reduce())
        shardings = SH.spec_tree_to_shardings(specs, mesh)
        for (path, s), (_, spec) in zip(tree_leaves(shardings),
                                        tree_leaves(specs)):
            assert s.spec == SH._trim_indivisible(SH.logical_to_pspec(
                spec.logical_axes, SH.DEFAULT_RULES, mesh), spec.shape,
                mesh), path
        assert SH.named_sharding(mesh, "data", None).spec == ("data", None)
    finally:
        dist.destroy_process_group()
