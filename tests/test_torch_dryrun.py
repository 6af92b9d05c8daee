"""The port's dry-run (``repro_torch.launch.{specs,dryrun}``) against the
JAX package's ``repro.launch.{specs,dryrun}`` and on a fake 16x16 mesh.

- ``input_specs`` of the 31 applicable (arch x shape) cells: shapes and
  dtypes equal to the reference's ``ShapeDtypeStruct``s, nothing
  allocated (every leaf a "meta" tensor).
- ``batch_shardings`` specs equal to the reference's ``NamedSharding``s
  on JAX ``AbstractMesh``es of 16x16 and 2x16x16 (no devices), and
  ``cache_logical_axes``, ``active_params`` and ``model_flops`` equal
  for all ten configurations.
- ``SH.split_heads`` splits heads the model axis does not divide, where
  the plain view raises (the fault that stopped every configuration's
  trace at ``reduce()`` and granite-8b's and granite-moe's at full
  width); the loss on the mesh moves no logits, where gathering the
  vocab first moves each rank's full-vocab logits (the fault that gave
  train cells TBs a device).
- Every configuration's train, prefill and decode step at ``reduce()``
  traced on a fake 256-rank 16x16 mesh (a "fake" process group, meta
  shards), with the cache's per-device bytes under both layouts.
- The counterpart of ``tests/test_distributed.py::test_dryrun_cell_subprocess``:
  granite-moe-3b-a800m ``decode_32k`` at full width through
  ``python -m repro_torch.launch.dryrun --device cpu``.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import applicable_shapes as japplicable
from repro.configs.base import get_config as jget_config
from repro.launch import specs as JSP
from repro.models import model as JM
from repro_torch.configs.all import ASSIGNED
from repro_torch.configs.base import SHAPES, ShapeConfig, applicable_shapes
from repro_torch.configs.base import get_config
from repro_torch.launch import dryrun as DR
from repro_torch.launch import specs as SP
from repro_torch.models import model as TM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
CELLS = [(a, s.name) for a in ASSIGNED for s in applicable_shapes(
    get_config(a))]


def _reference_dryrun():
    """``repro.launch.dryrun``, imported with ``XLA_FLAGS`` restored: the
    module sets a 512-device host platform at import."""
    jax.devices()           # the backend exists before the import
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return dryrun


def test_cells_are_the_reference_31():
    theirs = [(a, s.name) for a in ASSIGNED
              for s in japplicable(jget_config(a))]
    assert CELLS == theirs and len(CELLS) == 31


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    mine = SP.input_specs(get_config(arch), SHAPES[shape])
    theirs = JSP.input_specs(jget_config(arch), JSHAPES[shape])
    flat_m = dict(jax.tree_util.tree_leaves_with_path(mine))
    flat_t = dict(jax.tree_util.tree_leaves_with_path(theirs))
    assert sorted(map(str, flat_m)) == sorted(map(str, flat_t))
    theirs_by = {str(k): v for k, v in flat_t.items()}
    for k, t in flat_m.items():
        ref = theirs_by[str(k)]
        assert isinstance(t, torch.Tensor) and t.is_meta, k
        assert tuple(t.shape) == tuple(ref.shape), k
        assert str(t.dtype).split(".")[-1] == np.dtype(ref.dtype).name, k


def _pspec(named):
    return tuple(named.spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_shardings_match_reference(arch, shape, mesh):
    sizes = MESHES[mesh]
    jm = AbstractMesh(tuple(sizes.values()), tuple(sizes))
    mine = SP.batch_shardings(get_config(arch), SHAPES[shape], sizes)
    theirs = JSP.batch_shardings(jget_config(arch), JSHAPES[shape], jm)
    flat_t = {str(k): _pspec(v) for k, v in
              jax.tree_util.tree_leaves_with_path(
                  theirs, is_leaf=lambda x: hasattr(x, "spec"))}
    flat_m = {str(k): v for k, v in jax.tree_util.tree_leaves_with_path(
        mine, is_leaf=lambda x: isinstance(x, tuple))}
    assert flat_m == flat_t


@pytest.mark.parametrize("name", ASSIGNED)
def test_cache_axes_params_and_model_flops_match_reference(name):
    ref = _reference_dryrun()
    cfg, jcfg = get_config(name), jget_config(name)
    assert TM.cache_logical_axes(cfg) == JM.cache_logical_axes(jcfg)
    assert DR.active_params(cfg) == ref.active_params(jcfg)
    for s in SHAPES:
        assert DR.model_flops(cfg, SHAPES[s]) == ref.model_flops(
            jcfg, JSHAPES[s])


def test_split_heads_where_the_view_fails():
    """granite-8b's 8 kv heads of 128 on a 16-way model axis: the view
    of the projection sharded over model raises ("Cannot unflatten
    unevenly sharded tensor"); ``split_heads`` gathers it first."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as SH

    with DR.fake_world(256):
        mesh = make_production_mesh(device="cuda")
        k = SH.meta_dtensor((256, 16, 8 * 128), torch.bfloat16, mesh,
                            (Shard(0), Shard(2)))
        with pytest.raises(RuntimeError, match="unevenly sharded"):
            k.reshape(256, 16, 8, 128)
        got = SH.split_heads(k, 8, 128, "act_kv_seq", 32, 8)
        assert tuple(got.shape) == (256, 16, 8, 128)
        assert tuple(got.placements) == (Shard(0), Replicate())
        # 32 q heads alone divide: the view keeps its heads sharded
        q = SH.meta_dtensor((256, 16, 32 * 128), torch.bfloat16, mesh,
                            (Shard(0), Shard(2)))
        assert tuple(SH.split_heads(q, 32, 128, "act_q_seq", 32).placements
                     ) == (Shard(0), Shard(2))


#: small stand-ins for the assigned shapes: the production batch widths
#: (divisible by the mesh) at 16 positions (one a model rank in the cache)
SMALL = {"train": ShapeConfig("train_4k", 16, 256, "train"),
         "prefill": ShapeConfig("prefill_32k", 16, 32, "prefill"),
         "decode": ShapeConfig("decode_32k", 16, 128, "decode")}


@pytest.mark.parametrize("name", ASSIGNED)
def test_every_step_traces_on_the_fake_16x16_mesh(name):
    """(Under the smoke config's own name: one microbatch, not the full
    model's ``DRYRUN_TRAIN_OVERRIDES``.)"""
    cfg = get_config(name).reduce()
    for kind, shape in SMALL.items():
        out = DR.trace_cell(cfg.name, shape.name, cfg=cfg, shape=shape)
        if kind == "decode" and not cfg.decoder:
            assert out["skipped"]
            continue
        assert out["mesh"] == "16x16" and out["chips"] == 256
        assert out["flops_per_device"] > 0, kind
        assert out["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        mem = out["memory_analysis"]
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0, kind
        assert sum(out["collectives"]["counts"].values()) > 0, kind
        if kind == "train":
            # the loss moves per-row statistics, not logits
            rows = shape.global_batch // 16 * shape.seq_len
            loss = [b for site, b in out["collectives"][
                "largest_result_bytes_by_site"].items() if "_ce" in site]
            assert loss and max(loss) <= 4 * rows, loss
        if kind == "decode":
            cache = out["cache_bytes_per_device"]
            leaves = cache["by_leaf"]
            for key, b in leaves.items():
                # K/V and latents lie as the reference's; the recurrent
                # states keep the batch-only layout (whole over model)
                seq = key.split("_")[-1] in TM.SEQ_SHARDED \
                    and cfg.family != "hybrid"
                if seq or cfg.family in ("dense", "vlm", "moe"):
                    assert b["port"] == b["reference"], key
                else:
                    assert b["port"] >= b["reference"], key


def test_loss_on_the_mesh_moves_no_logits():
    """The cross-entropy on a 16x16 mesh reduces each rank's share of the
    vocab (one ``pmax`` and ``psum`` of per-row statistics); the stand-in
    that gathers the vocab first, the port's loss before this check,
    moves every rank's full-vocab logits (the fault that put 1.3 TB a
    device into recurrentgemma-2b's train_4k)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch import op_analysis as OA
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as SH

    b, s, v = 256, 64, 1024
    local_logits = (b // 16) * s * v * 4        # one rank's rows, fp32
    with DR.fake_world(256):
        mesh = make_production_mesh(device="cuda")
        lg = SH.meta_dtensor((b, s, v), torch.bfloat16, mesh,
                             (Shard(0), Shard(2)))
        lab = SH.meta_dtensor((b, s), torch.int32, mesh,
                              (Shard(0), Replicate()))
        with SH.replicate_plain():
            loss, mine = OA.analyze(lambda: L.cross_entropy_loss(
                lg, lab, 1000))
            _, gathered = OA.analyze(lambda: L._gathered_ce(lg, lab))
    assert loss.shape == ()
    assert max(mine.site_result_bytes.values()) <= (b // 16) * s * 4
    assert max(gathered.site_result_bytes.values()) >= local_logits // 2


def test_dryrun_cell_subprocess_torch():
    """One real cell end to end at full width in its own process, as the
    reference's test runs its dry-run."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-moe-3b-a800m", "--shape", "decode_32k", "--device",
         "cpu"], env=env, capture_output=True, text=True, timeout=420,
        cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2500:]
    d = json.loads(proc.stdout[proc.stdout.index("{"):])
    assert d["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert d["flops_per_device"] > 0
    assert d["device"] == "cpu" and d["chips"] == 256
    cache = d["cache_bytes_per_device"]
    assert cache["port"] == cache["reference"] > 0
