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
from repro_torch.core import cronet, fusion
from repro_torch.fea import fea2d, hybrid
from repro_torch.kernels import cg_fused, conv, cronet_pipeline, gemm, pool
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


# the per-op kernels at CRONet medium's layer shapes (kernel, plain, args)
MEDIUM_OPS = {
    "conv3d_trunk1": (conv.conv3d, conv.conv3d_plain,
                      [(1, 4, 21, 31, 1), (2, 3, 3, 1, 16)],
                      dict(depth_padding="causal_same", fuse_silu=True)),
    "conv3d_trunk2": (conv.conv3d, conv.conv3d_plain,
                      [(1, 4, 21, 31, 16), (1, 3, 3, 16, 64)],
                      dict(depth_padding="same", fuse_silu=False)),
    "conv2d_branch1": (conv.conv2d, conv.conv2d_plain,
                       [(10, 20, 30, 1), (3, 3, 1, 16)],
                       dict(fuse_silu=True)),
    "conv2d_branch2": (conv.conv2d, conv.conv2d_plain,
                       [(10, 20, 30, 16), (3, 3, 16, 32)],
                       dict(fuse_silu=False)),
    "conv2d_odd": (conv.conv2d, conv.conv2d_plain,
                   [(2, 7, 9, 3), (3, 3, 3, 5)], dict(fuse_silu=True)),
    "gemm_trunk_fc1": (gemm.gemm, gemm.gemm_plain, [(1, 4800), (4800, 40)],
                       dict(activation="silu")),
    "gemm_fc2": (gemm.gemm, gemm.gemm_plain, [(1, 40), (40, 2560)], {}),
    "gemm_rnn": (gemm.gemm, gemm.gemm_plain, [(1, 64), (64, 64)], {}),
    "gemm_odd": (gemm.gemm, gemm.gemm_plain, [(33, 70), (70, 9)],
                 dict(activation="tanh")),
    "maxpool2d_branch": (pool.maxpool2d, pool.maxpool2d_plain,
                         [(10, 20, 30, 32)], {}),
    "maxpool2d_odd": (pool.maxpool2d, pool.maxpool2d_plain,
                      [(3, 7, 9, 8)], {}),
    "aap2d_branch": (pool.adaptive_avg_pool2d,
                     pool.adaptive_avg_pool2d_plain, [(10, 10, 15, 32)],
                     dict(out_hw=(1, 1))),
    "aap2d_odd": (pool.adaptive_avg_pool2d, pool.adaptive_avg_pool2d_plain,
                  [(2, 7, 9, 6)], dict(out_hw=(3, 4))),
    "aap3d_trunk": (pool.adaptive_avg_pool3d,
                    pool.adaptive_avg_pool3d_plain, [(1, 4, 21, 31, 64)],
                    dict(out_dhw=(3, 5, 5))),
}


@pytest.mark.parametrize("op", list(MEDIUM_OPS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_op_kernel_matches_plain(dev, op, dtype):
    """Each per-op kernel vs its plain version on the card, with the
    tolerances of tests/test_kernels.py; exactly one launch counted."""
    kern, plain, shapes, kw = MEDIUM_OPS[op]
    gen = torch.Generator().manual_seed(len(op))
    args = [(torch.randn(s, generator=gen) * 0.4).to(dtype).to(dev)
            for s in shapes]
    before = kern.launches
    out = kern(*args, **kw)
    assert kern.launches == before + 1
    ref = plain(*args, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("op", ["conv2d_odd", "gemm_odd"])
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_mixed_dtype_kernels_match_plain(dev, op, x_dtype, w_dtype):
    """One fp32 and one bf16 operand: the kernel reads both as fp32 and
    writes x's dtype, as the plain version does."""
    kern, plain, (xs, ws), kw = MEDIUM_OPS[op]
    gen = torch.Generator().manual_seed(3)
    x = (torch.randn(xs, generator=gen) * 0.4).to(x_dtype).to(dev)
    w = (torch.randn(ws, generator=gen) * 0.4).to(w_dtype).to(dev)
    out, ref = kern(x, w, **kw), plain(x, w, **kw)
    assert out.dtype == x_dtype
    tol = 2e-5 if x_dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol,
                               atol=tol * 10)


@pytest.mark.parametrize("path", [(False, False, False), (True, False, False),
                                  (True, True, True)],
                         ids=["none", "l1", "l2l3"])
def test_fusion_path_on_the_card(dev, path):
    """fusion.infer on the card vs the plain forward at 1e-4, fp32."""
    cfg = dataclasses.replace(get_cronet_config("medium"), dtype="float32")
    params = init_params(cfg, 0, device=dev)
    _, lv, hist = _inputs(cfg, dev, B=1)
    counts = {fn: fn.launches for fn in (conv.conv3d, gemm.gemm,
                                          cronet_pipeline.cronet_fused)}
    out = fusion.infer(cfg, params, lv[0], hist[0],
                       fusion.FusionConfig(*path))
    ref = cronet.forward(cfg, params, lv, hist)[0]
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    moved = {fn.__name__ for fn, n in counts.items() if fn.launches > n}
    assert moved == ({"cronet_fused"} if path[1] else {"conv3d", "gemm"})
