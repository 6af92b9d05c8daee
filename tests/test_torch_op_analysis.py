"""The port's op analyzer (``repro_torch.launch.op_analysis``) against the
JAX package's HLO analyzer (``repro.launch.hlo_analysis.analyze`` on the
compiled step, one CPU device).

- A loop of 5 matmuls counts exactly (the counterpart of
  ``tests/test_system.py::test_hlo_analyzer_scan_exact``).
- Matmul flops at ``reduce()``, batch 2 x 64, equal the reference's for
  the forward of granite-8b, granite-moe-3b-a800m and xlstm-1.3b and for
  granite-8b's train step (remat, AdamW: 50,331,648 / 126,353,408 /
  46,727,168 / 188,743,680).
- xlstm-1.3b's train step counts 178,487,296 against the reference's
  176,291,840 (+1.25%). The difference is found and held exactly: the
  port counts the products whose contracted dim is 1 (the backward of
  the mLSTM readout ``einsum("bhkv,bhk->bhv")``'s outer product and of
  its normaliser ``"bhk,bhk->bh"``), which XLA rewrites into multiplies;
  and the reference counts one product the port skips, the gradient
  into the sLSTM's zero initial state at step 0 (autograd needs none;
  ``lax.scan``'s transpose runs every step alike).
- On a fake 16x16 mesh a DTensor product counts rank 0's local product
  (7.75e9 flops), not the global one (1.98e12) that ``FlopCounterMode``
  reports.
- Ring-model wire bytes of an all-reduce, all-gather and all-to-all of a
  16-rank group equal the reference's formula on the same result.
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.common import materialize as jmaterialize
from repro.configs.base import get_config as jget_config
from repro.launch import hlo_analysis as H
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.train import steps as JS
from repro_torch.common import map_params
from repro_torch.configs.base import get_config
from repro_torch.launch import op_analysis as OA
from repro_torch.models import model as TM
from repro_torch.optim import adamw
from repro_torch.train.steps import TrainConfig, make_train_step

B, S = 2, 64

#: the reference's counts (``hlo_analysis.analyze`` on the compiled HLO)
REFERENCE = {("granite-8b", "forward"): 50_331_648,
             ("granite-moe-3b-a800m", "forward"): 126_353_408,
             ("xlstm-1.3b", "forward"): 46_727_168,
             ("granite-8b", "train"): 188_743_680,
             ("xlstm-1.3b", "train"): 176_291_840}


def test_op_analyzer_loop_exact():
    L = 5
    ws = torch.empty((L, 64, 64), device="meta")
    x = torch.empty((8, 64), device="meta")

    def f():
        y = x
        for i in range(L):
            y = y @ ws[i]
        return y

    _, costs = OA.analyze(f)
    assert costs.flops == 2 * L * 8 * 64 * 64
    assert costs.launches == L


def _jax_flops(name, kind):
    cfg = jget_config(name).reduce()
    params = jax.eval_shape(
        lambda: jmaterialize(JM.param_specs(cfg), jax.random.PRNGKey(0)))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    if kind == "forward":
        fn, args = (lambda p, b: JM.forward(cfg, p, b)), (params, batch)
    else:
        tc = JS.TrainConfig()
        opt = jax.eval_shape(lambda p: JA.init_state(tc.optimizer, p),
                             params)
        fn, args = JS.make_train_step(cfg, tc), (params, opt, batch)
    return H.analyze(jax.jit(fn).lower(*args).compile().as_text()).flops


def _port_costs(name, kind):
    cfg = get_config(name).reduce()
    params = map_params(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                              device="meta"),
                        TM.param_specs(cfg))
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    if kind == "forward":
        with torch.no_grad():
            return OA.analyze(lambda: TM.forward(cfg, params, batch))[1]
    tc = TrainConfig()
    opt = adamw.init_state(tc.optimizer, params)
    return OA.analyze(lambda: make_train_step(cfg, tc)(params, opt,
                                                       batch))[1]


@pytest.mark.parametrize("name,kind", [k for k in REFERENCE
                                       if k != ("xlstm-1.3b", "train")])
def test_matmul_flops_equal_hlo_analysis(name, kind):
    assert _jax_flops(name, kind) == REFERENCE[(name, kind)]
    assert _port_costs(name, kind).flops == REFERENCE[(name, kind)]


def test_xlstm_train_step_difference_is_found_and_held():
    cfg = get_config("xlstm-1.3b").reduce()
    assert _jax_flops("xlstm-1.3b", "train") == REFERENCE[("xlstm-1.3b",
                                                         "train")]
    costs = _port_costs("xlstm-1.3b", "train")
    assert costs.flops == 178_487_296
    # the outer products: mLSTM readout dC (B*H*dh*dh a step) and the
    # normaliser's two gradients (B*H*dh each), 2 mLSTM layers x 64 steps
    n_m, dh, h = 2, 2 * cfg.d_model // cfg.num_heads, cfg.num_heads
    outer = 2 * n_m * S * (B * h * dh * dh + 2 * B * h * dh)
    assert costs.outer_flops == outer
    # the sLSTM's step-0 gradient into h0: (B, nh, dh) x (nh, dh, 4dh)
    n_s, sdh = 2, cfg.d_model // cfg.num_heads
    step0 = n_s * 2 * B * cfg.num_heads * sdh * 4 * sdh
    assert costs.flops - outer + step0 == REFERENCE[("xlstm-1.3b", "train")]


def test_local_shard_flops_on_the_fake_mesh():
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as SH

    with fake_world(256):
        mesh = make_production_mesh(device="cuda")
        a = SH.meta_dtensor((4096, 8192), torch.bfloat16, mesh,
                            (Shard(0), Replicate()))
        w = SH.meta_dtensor((8192, 29568), torch.bfloat16, mesh,
                            (Replicate(), Shard(1)))
        out, costs = OA.analyze(lambda: a @ w)
        with FlopCounterMode(display=False) as fc:
            a @ w
    assert tuple(out.placements) == (Shard(0), Shard(1))
    assert costs.flops == 2 * (4096 // 16) * 8192 * (29568 // 16) \
        == 7_751_073_792
    assert fc.get_total_flops() == 2 * 4096 * 8192 * 29568


def _hlo_wire(kind, shape, group):
    """The reference analyzer's wire bytes of one collective (its result
    of ``shape`` in f32) in a one-op HLO module."""
    dims = ",".join(map(str, shape))
    groups = "{{" + ",".join(map(str, range(group))) + "}}"
    hlo = (f"HloModule m\n\nENTRY %main (p: f32[{dims}]) -> f32[{dims}] {{\n"
           f"  %p = f32[{dims}]{{1,0}} parameter(0)\n"
           f"  ROOT %c = f32[{dims}]{{1,0}} {kind}(f32[{dims}]{{1,0}} %p), "
           f"replica_groups={groups}\n}}\n")
    return H.analyze(hlo).collective_wire_bytes


@pytest.mark.parametrize("kind", ["all-reduce", "all-gather", "all-to-all"])
def test_wire_bytes_equal_reference_formula(kind):
    import torch.distributed.nn.functional as DF
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as SH

    with fake_world(256):
        mesh = make_production_mesh(device="cuda")
        group = mesh.get_group("model")
        t = torch.empty((16, 1024), device="meta")
        if kind == "all-reduce":
            fn = lambda: DF.all_reduce(t, group=group)           # noqa: E731
        elif kind == "all-to-all":
            fn = lambda: DF.all_to_all_single(                   # noqa: E731
                torch.empty_like(t), t, group=group)
        else:
            d = SH.meta_dtensor((16, 16 * 1024), torch.float32, mesh,
                                (Replicate(), Shard(1)))
            fn = lambda: d.redistribute(                         # noqa: E731
                mesh, (Replicate(), Replicate()))
        _, costs = OA.analyze(fn)
    shape = (16, 16 * 1024) if kind == "all-gather" else (16, 1024)
    assert costs.collective_counts == {kind: 1}
    assert costs.collective_groups == {f"{kind} g16": 1}
    assert costs.collective_wire_bytes == _hlo_wire(kind, shape, 16)
    assert costs.collective_wire_bytes == OA.wire_bytes(
        kind, 4 * shape[0] * shape[1], 16)
