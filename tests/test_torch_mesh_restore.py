"""Elastic restore across mesh shapes, and the ``Trainer`` on a mesh, on
four CPU ranks (a 2x2 ("data", "model") mesh).

- A checkpoint written unsharded, by either package, restores onto the
  2x2 mesh (``restore(..., shardings=)``) bitwise: every leaf a DTensor
  on its sharding whose full value is the saved array. (The reference's
  tests/test_distributed.py::test_elastic_restore_across_mesh_shapes.)
- A tree of DTensors saved on the mesh (rank 0 writes the full tensors)
  restores unsharded, by either package, bitwise.
- ``Trainer(mesh=)`` trains granite-8b at ``reduce()`` in fp32 for 2
  steps from the same seed as an unsharded ``Trainer``, checkpointing at
  step 2: the losses within 2e-4 of the unsharded run's, and its
  checkpoint resumes unsharded in both packages.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro.checkpoint import manager as jckpt
from repro.common import materialize as jmaterialize
from repro.configs.base import get_config as jget_config
from repro.models import model as JM
from repro_torch.checkpoint import manager as ckpt
from repro_torch.common import materialize, tree_leaves
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.train.steps import TrainConfig
from repro_torch.train.trainer import RunConfig, Trainer

from test_torch_mesh_train import run_ranks

BODY = '''
import dataclasses
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import manager as ckpt
from repro_torch.common import materialize, tree_leaves
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train.steps import TrainConfig
from repro_torch.train.trainer import RunConfig, Trainer

cfg = get_config("granite-8b").reduce()
specs = M.param_specs(cfg)
like = {"params": materialize(specs, 0, device="cpu")}
shardings = {"params": SH.spec_tree_to_shardings(specs, mesh)}
out = {}
for who in ("jax", "port"):
    restored, _ = ckpt.restore(os.path.join(DIR, who), like, device="cpu",
                               shardings=shardings)
    for (k, a), (_, s) in zip(tree_leaves(restored),
                              tree_leaves(shardings)):
        assert isinstance(a, DTensor) and tuple(a.placements) == s.placements
    out.update(gathered(who + "/", restored))
# a sharded tree saved on the mesh: rank 0 writes full tensors
placed = SH.shard_tree(materialize(specs, 1, device="cpu"),
                       shardings["params"])
ckpt.save(os.path.join(DIR, "mesh"), 3, {"params": placed})

# the Trainer on the mesh
cfg32 = dataclasses.replace(cfg, dtype="float32")
tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                             total_steps=2))
rc = RunConfig(steps=2, batch=4, seq=16, ckpt_dir=os.path.join(DIR, "run"),
               ckpt_every=2, log_every=1)
_, _, hist = Trainer(cfg32, tc, rc, mesh=mesh).run()
out["losses"] = np.asarray([h["loss"] for h in hist])
save(**out)
'''


def test_elastic_restore_and_trainer_across_mesh_shapes(tmp_path):
    cfg = get_config("granite-8b").reduce()
    specs = TM.param_specs(cfg)
    like = {"params": materialize(specs, 0, device="cpu")}
    # unsharded checkpoints of different weights from each package
    jp = jmaterialize(JM.param_specs(jget_config("granite-8b").reduce()),
                      jax.random.key(3))
    jckpt.save(str(tmp_path / "jax"), 1, {"params": jp})
    port = materialize(specs, 2, device="cpu")
    ckpt.save(str(tmp_path / "port"), 1, {"params": port})
    out = run_ranks(tmp_path, BODY)

    saved = {"jax": {k: np.asarray(v, np.float32) for k, v in tree_leaves(
        jax.device_get(jp))},
             "port": {k: v.float().numpy() for k, v in tree_leaves(port)}}
    for who, want in saved.items():
        for k, v in want.items():
            np.testing.assert_array_equal(out[f"{who}/params/{k}"], v)

    # the mesh's checkpoint, unsharded, in both packages
    mine = materialize(specs, 1, device="cpu")
    back, _ = ckpt.restore(str(tmp_path / "mesh"), {"params": like["params"]},
                           device="cpu")
    jback, _ = jckpt.restore(str(tmp_path / "mesh"), {"params": jp})
    jflat = dict(tree_leaves(jax.device_get(jback)))
    for k, v in tree_leaves({"params": mine}):
        assert torch.equal(dict(tree_leaves(back))[k], v)
        np.testing.assert_array_equal(
            np.asarray(jflat[k], np.float32), v.float().numpy())

    # the mesh Trainer against the unsharded one, and its checkpoint
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tc = TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                 total_steps=2))
    rc = RunConfig(steps=2, batch=4, seq=16, log_every=1)
    _, _, hist = Trainer(cfg32, tc, rc, device="cpu").run()
    want = np.asarray([h["loss"] for h in hist])
    print("losses on the mesh", out["losses"], "unsharded", want)
    assert np.abs(out["losses"] - want).max() < 2e-4
    p0 = materialize(TM.param_specs(cfg32), 0, device="cpu")
    state, extras = ckpt.restore(str(tmp_path / "run"), {
        "params": p0, "opt": adamw.init_state(tc.optimizer, p0)},
        device="cpu")
    assert extras["step"] == 2 and int(state["opt"].step) == 2
    assert ckpt.latest_step(str(tmp_path / "run")) == 2
