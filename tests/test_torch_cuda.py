"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test here skips (the decision is made
inside the fixture, never at import). On a machine with one:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Kernels build from src/repro_torch/csrc with nvcc at first use.
"""
import dataclasses

import pytest
import torch

from repro_torch.common import init_params
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.fea import fea2d, hybrid
from repro_torch.kernels import cg_fused, cronet_pipeline
from repro_torch.serve.topo_service import TopoServingEngine
from repro_torch.serve.types import TopoRequest

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(cfg, dev, B=3):
    gen = torch.Generator().manual_seed(0)
    probs = [fea2d.point_load_problem(cfg.nelx, cfg.nely,
                                      load_node=(2 * i, 0)) for i in range(B)]
    bp = fea2d.stack_problems(probs, device=dev)
    hist = torch.rand((B, cfg.hist_len, cfg.nely, cfg.nelx, 1),
                      generator=gen).to(dev)
    return bp, fea2d.load_volume_b(bp), hist


@pytest.mark.parametrize("size", ["small", "medium", "large"])
def test_cronet_fused_matches_plain(dev, size):
    """fp32 kernel vs core.cronet.forward on the card, rtol = atol = 1e-4;
    slot b is independent of the batch width (bitwise)."""
    cfg = get_cronet_config(size)
    params = hybrid.cast_params(init_params(cfg, 0, device=dev), "fp32")
    _, lv, hist = _inputs(cfg, dev)
    before = cronet_pipeline.cronet_fused.launches
    out = cronet_pipeline.cronet_fused(cfg, params, lv, hist)
    assert cronet_pipeline.cronet_fused.launches == before + 1
    ref = cronet_pipeline.cronet_fused_plain(cfg, params, lv, hist)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    two = cronet_pipeline.cronet_fused(cfg, params, lv[:2], hist[:2])
    assert torch.equal(two, out[:2])


def test_cronet_fused_bf16(dev):
    """bf16 weights and inputs: the kernel computes in fp32 on the bf16
    values, so it matches the fp32 plain version on those values at 1e-4."""
    cfg = get_cronet_config("medium")
    p16 = hybrid.cast_params(init_params(cfg, 0, device=dev), "bf16")
    _, lv, hist = _inputs(cfg, dev)
    out = cronet_pipeline.cronet_fused(cfg, p16, lv.bfloat16(),
                                       hist.bfloat16())
    ref = cronet_pipeline.cronet_fused_plain(
        cfg, hybrid.cast_params(p16, "fp32"), lv.bfloat16().float(),
        hist.bfloat16().float())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_solve_b_fused_matches_plain(dev, masked):
    """The CG kernel vs the plain loop on the card: U within 1e-4 relative
    L2 and iteration counts within +-1, with a need=False slot and (masked)
    shape-class padding."""
    cfg = get_cronet_config("medium")
    if masked:     # a 28x18 mesh padded onto the 30x20 shape class
        probs = [fea2d.pad_problem(fea2d.point_load_problem(
            cfg.nelx - 2, cfg.nely - 2, load_node=(3 * i, 0)),
            cfg.nelx, cfg.nely) for i in range(3)]
    else:
        probs = [fea2d.point_load_problem(cfg.nelx, cfg.nely,
                                          load_node=(3 * i, 0))
                 for i in range(3)]
    bp = fea2d.stack_problems(probs, device=dev)
    X = torch.full((3, cfg.nely, cfg.nelx), 0.5, device=dev)
    if masked:
        X = X * bp.elem_mask
    need = torch.tensor([True, False, True], device=dev)
    U, its = cg_fused.solve_b_fused(bp, X, need=need)
    Ur, itr = cg_fused.solve_b_plain(bp, X, need=need)
    rel = (U - Ur).norm(dim=1) / Ur.norm(dim=1).clamp_min(1e-30)
    assert bool((rel <= 1e-4).all()), rel
    assert bool(((its - itr).abs() <= 1).all()), (its, itr)
    assert int(its[1]) == 0


def test_engine_serves_on_the_card(dev):
    cfg = dataclasses.replace(get_cronet_config("small"), hist_len=3)
    eng = TopoServingEngine(cfg, init_params(cfg, 0, device=dev), 50.0,
                            slots=2, error_threshold=1e9, device=dev)
    done = eng.run([TopoRequest(uid=i, problem=fea2d.point_load_problem(
        cfg.nelx, cfg.nely, load_node=(4 * i, 0)), n_iter=6)
        for i in range(2)])
    eng.shutdown()
    assert all(r.done and r.cronet_iters > 0 for r in done)
