"""The recurrent families' forward on a 2x2 ("data", "model") mesh of four
CPU ranks, in fp32 at ``reduce()`` on the JAX package's seed-0 weights:
recurrentgemma-2b (RG-LRU blocks, the convolution and the doubling scan
on each rank's batch rows, local attention) and xlstm-1.3b at S 128 (the
mLSTM's chunkwise form and the sLSTM's step loop on each rank's rows).

The sharded logits against the port's unsharded ones and the JAX
package's, within tests/test_torch_lm_model.py's recurrent bar: 1e-4, or
twice the reference's own fp32 error (its run on float64 weights) where
that is larger. At ``reduce()`` every "normal" weight is std 1 and the
blocks' outputs reach 1e3-1e4, so the order of the sharded sums shows.
"""
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.models import model as TM

from test_torch_lm_model import (as_jax, as_torch, batch_for, pair,
                                 recurrent_bar, reference_f64, to_np)
from test_torch_mesh_train import flat_inputs, run_ranks

SHAPES = {"recurrentgemma-2b": (4, 16), "xlstm-1.3b": (4, 128)}

BODY = '''
import dataclasses
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
cfg = dataclasses.replace(get_config(%r).reduce(), dtype="float32")
params = SH.shard_tree(inputs("p/"),
                       SH.spec_tree_to_shardings(M.param_specs(cfg), mesh))
with torch.no_grad():
    logits, _ = M.forward(cfg, params, inputs("b/"), mesh)
save(logits=SH.full(logits).numpy())
'''


@pytest.mark.parametrize("name", list(SHAPES))
def test_recurrent_forward_on_mesh_matches_unsharded(name, tmp_path):
    jc, tc, jp, tp = pair(name)
    batch = batch_for(jc, *SHAPES[name])
    want, _ = JM.forward(jc, jp, as_jax(batch))
    want64 = reference_f64(lambda p, b: JM.forward(jc, p, b)[0], jp,
                           as_jax(batch))
    bar = recurrent_bar(jc, want, want64)
    with torch.no_grad():
        single, _ = TM.forward(tc, tp, as_torch(batch))
    out = run_ranks(tmp_path, BODY % name,
                    inputs={**flat_inputs("p/", jp),
                            **{"b/" + k: v for k, v in batch.items()}})
    got = out["logits"]
    err_single = float(np.abs(got - to_np(single)).max())
    err_ref = float(np.abs(got - to_np(want)).max())
    print(f"{name}: mesh vs unsharded {err_single:.3g}, vs JAX "
          f"{err_ref:.3g}, bar {bar:.3g}")
    assert got.shape == tuple(single.shape) and np.isfinite(got).all()
    assert err_single <= bar and err_ref <= bar
