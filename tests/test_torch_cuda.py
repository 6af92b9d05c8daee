"""The port's CUDA kernels against their plain versions, on an NVIDIA GPU.

Marked ``cuda``: without a GPU every test here skips (the decision is made
inside the fixture, never at import). On a machine with one:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Kernels build from src/repro_torch/csrc with nvcc at first use.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the SiLU edge cases, the bf16 flash test)
from repro_torch import layer_breakdown
from repro_torch.common import init_params
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.core import cronet, fusion
from repro_torch.fea import fea2d, hybrid
from repro_torch.kernels import (cg_fused, conv, cronet_pipeline, gemm, pool,
                                 ref, silu, slstm)
from repro_torch.kernels import flash_attention as flash
from repro_torch.serve import ModelRegistry, TopoGateway
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


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("size", ["small", "medium", "large"])
def test_cronet_fused_bitwise_across_widths(dev, size, dtype):
    """Slot b's output at widths 1, 2, 3, 4 and 8 is bitwise the same, and
    so are two calls; within 1e-4 of fp32 arithmetic on the same values."""
    cfg = get_cronet_config(size)
    params = hybrid.cast_params(init_params(cfg, 0, device=dev), dtype)
    _, lv, hist = _inputs(cfg, dev, B=8)
    dt = torch.float32 if dtype == "fp32" else torch.bfloat16
    lv, hist = lv.to(dt), hist.to(dt)
    out = cronet_pipeline.cronet_fused(cfg, params, lv, hist)
    assert torch.equal(out, cronet_pipeline.cronet_fused(cfg, params, lv,
                                                         hist))
    for width in (1, 2, 3, 4):
        assert torch.equal(cronet_pipeline.cronet_fused(
            cfg, params, lv[:width], hist[:width]), out[:width]), width
    ref = cronet_pipeline.cronet_fused_plain(
        cfg, hybrid.cast_params(params, "fp32"), lv.float(), hist.float())
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


def test_cronet_fused_is_at_most_three_kernels_per_call(dev):
    """torch.profiler sees at most three device kernels per cronet_fused
    call (two: conv_kernel and head_kernel) at medium, widths 1 and 4, fp32
    and bf16. Counted in a process of its own (kernel_probe
    --cronet-kernels): a profile in this process would cost the later gemm
    profile kernel records (see kernel_probe.cronet_kernels_per_call)."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernel_probe", "--cronet-kernels"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-2000:]
    report = json.loads(run.stdout.strip().splitlines()[-1])
    for case, names in report["cronet_kernels_per_call"].items():
        assert set(names) == {"conv_kernel", "head_kernel"}, (case, names)
        assert sum(names.values()) == 2.0, (case, names)


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


@pytest.mark.parametrize("size", ["medium", "large"])
@pytest.mark.parametrize("width", [1, 4, 8])
def test_solve_b_fused_bitwise_equals_plain(dev, size, width):
    """U and iteration counts bitwise equal to the plain loop at 30x20 and
    60x20 and widths 1, 4 and 8: the fold keeps fea2d.tree_sum's tree and
    the build keeps --fmad=false. The batch mixes need flags, an idle
    (zero-load) slot and a warm start; then the same slots shape-padded
    (elem_mask) from cold."""
    cfg = get_cronet_config(size)
    gen = torch.Generator().manual_seed(width)
    probs = [fea2d.point_load_problem(
        cfg.nelx, cfg.nely, load_node=((5 * i) % (cfg.nelx - 1), 0),
        load=(0.0, -1.0 - 0.1 * i)) for i in range(width)]
    if width > 2:
        probs[2] = fea2d.idle_problem(cfg.nelx, cfg.nely)
    bp = fea2d.stack_problems(probs, device=dev)
    X = (0.2 + 0.8 * torch.rand((width, cfg.nely, cfg.nelx),
                                generator=gen)).to(dev)
    U0, _ = cg_fused.solve_b_plain(bp, X, max_iter=5)
    need = torch.tensor([i % 4 != 1 for i in range(width)], device=dev)
    U, its = cg_fused.solve_b_fused(bp, X, U0=U0, need=need)
    Ur, itr = cg_fused.solve_b_plain(bp, X, U0=U0, need=need)
    assert torch.equal(U, Ur) and torch.equal(its, itr), (its, itr)
    assert int(its.max()) > 50
    small = [fea2d.pad_problem(fea2d.point_load_problem(
        cfg.nelx - 2, cfg.nely - 2, load_node=((3 * i) % (cfg.nelx - 3), 0)),
        cfg.nelx, cfg.nely) for i in range(width)]
    bpm = fea2d.stack_problems(small, device=dev)
    Xm = bpm.elem_mask * X
    U, its = cg_fused.solve_b_fused(bpm, Xm)
    Ur, itr = cg_fused.solve_b_plain(bpm, Xm)
    assert torch.equal(U, Ur) and torch.equal(its, itr), (its, itr)


GEMM_SHAPES = {name: (m, k, n, act) for name, (m, k, n, act) in {
    "trunk_fc1": (1, 4800, 40, "silu"), "fc2": (1, 40, 2560, None),
    "rnn_wx": (1, 32, 64, None), "rnn_wh": (1, 64, 64, None),
    "branch_fc1": (1, 64, 40, "silu"), "odd_33x70x9": (33, 70, 9, "tanh"),
}.items()}
GEMM_DTYPES = {"f32": (torch.float32, torch.float32),
               "bf16": (torch.bfloat16, torch.bfloat16),
               "x32_w16": (torch.float32, torch.bfloat16),
               "x16_w32": (torch.bfloat16, torch.float32)}


@pytest.mark.parametrize("act", [None, "silu", "tanh"])
@pytest.mark.parametrize("dtypes", list(GEMM_DTYPES))
@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
def test_gemm_cluster_kernel_matches_plain(dev, shape, dtypes, act):
    """Every fusion shape, fp32 / bf16 / mixed, each activation: within
    chip_smoke.FUSION_TOL of gemm_plain (x's dtype sets the bar); the same
    bits over two calls; each call adds exactly 1 to gemm.launches."""
    M, K, N, _ = GEMM_SHAPES[shape]
    x_dt, w_dt = GEMM_DTYPES[dtypes]
    gen = torch.Generator().manual_seed(K + N)
    x = (torch.randn((M, K), generator=gen) * 0.3).to(x_dt).to(dev)
    w = (torch.randn((K, N), generator=gen) * 0.3).to(w_dt).to(dev)
    before = gemm.gemm.launches
    out = gemm.gemm(x, w, activation=act)
    assert gemm.gemm.launches == before + 1
    again = gemm.gemm(x, w, activation=act)
    assert gemm.gemm.launches == before + 2
    assert torch.equal(out, again)
    ref_ = gemm.gemm_plain(x, w, act)
    assert out.dtype == x_dt and out.shape == ref_.shape
    rtol, atol = chip_smoke.FUSION_TOL[str(x_dt).split(".")[-1]]
    torch.testing.assert_close(out.float(), ref_.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape", list(GEMM_SHAPES))
def test_gemm_is_one_kernel_per_call(dev, shape):
    """torch.profiler sees exactly one device kernel per gemm call, trunk
    fc1's long K included (no second reduction kernel, no memset)."""
    M, K, N, act = GEMM_SHAPES[shape]
    x = torch.randn((M, K), device=dev)
    w = torch.randn((K, N), device=dev)
    gemm.gemm(x, w, activation=act)         # build and load first
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            gemm.gemm(x, w, activation=act)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "gemm_kernel" in e.name]
    others = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and "gemm_kernel" not in e.name]
    assert len(kernels) == 3, [e.name for e in kernels]
    assert not others, others


def test_engine_serves_on_the_card(dev):
    cfg = dataclasses.replace(get_cronet_config("small"), hist_len=3)
    eng = TopoServingEngine(cfg, init_params(cfg, 0, device=dev), 50.0,
                            slots=2, error_threshold=1e9, device=dev)
    done = eng.run([TopoRequest(uid=i, problem=fea2d.point_load_problem(
        cfg.nelx, cfg.nely, load_node=(4 * i, 0)), n_iter=6)
        for i in range(2)])
    eng.shutdown()
    assert all(r.done and r.cronet_iters > 0 for r in done)


def test_gateway_serves_from_the_registry_on_the_card(dev, tmp_path):
    """A registered version loads onto the card bitwise; the gateway serves
    two meshes through both serving kernels, each density bitwise equal to
    a dedicated engine's; an evicted bucket frees its tensors and rebuilds
    to the same bits."""
    cfg = dataclasses.replace(get_cronet_config("small"), hist_len=3)
    params = init_params(cfg, 0, device=dev, dtype="float32")
    reg = ModelRegistry(str(tmp_path))
    reg.register(params, cfg, 50.0, tag="v1")
    loaded, _ = reg.load("v1", device=dev)
    assert all(torch.equal(loaded[p][n], params[p][n])
               for p in params for n in params[p])
    before = (cronet_pipeline.cronet_fused.launches,
              cg_fused.solve_b_fused.launches)
    gw = TopoGateway.from_registry(reg, "v1", slots=2, device=dev,
                                   error_threshold=1e9)
    meshes = [(cfg.nelx, cfg.nely), (cfg.nelx - 6, cfg.nely)]
    futs = [gw.submit(TopoRequest(uid=i, problem=fea2d.point_load_problem(
        *meshes[i % 2], load_node=(2 * i, 0)), n_iter=6)) for i in range(4)]
    done = [f.result(timeout=300) for f in futs]
    assert gw.drain(timeout=60)
    freed = torch.cuda.memory_allocated(dev)
    assert gw.evict_bucket(meshes[1], timeout=60)
    assert torch.cuda.memory_allocated(dev) < freed
    again = gw.submit(TopoRequest(uid=9, problem=done[1].problem,
                                  n_iter=6)).result(timeout=300)
    gw.shutdown()
    assert cronet_pipeline.cronet_fused.launches > before[0]
    assert cg_fused.solve_b_fused.launches > before[1]
    np.testing.assert_array_equal(again.density, done[1].density)
    for mesh in meshes:
        mine = [r for r in done if r.mesh == mesh]
        eng = TopoServingEngine(
            dataclasses.replace(cfg, nelx=mesh[0], nely=mesh[1]), loaded,
            50.0, slots=2, error_threshold=1e9, device=dev)
        refs = eng.run([TopoRequest(uid=r.uid, problem=r.problem,
                                    n_iter=6) for r in mine])
        eng.shutdown()
        for r, ref in zip(mine, refs):
            assert r.model_tag == "v1" and r.cronet_iters > 0
            np.testing.assert_array_equal(r.density, ref.density)


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


def _bits(t):
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int16)


@pytest.mark.parametrize("shape,k", [
    ((10, 20, 30, 32), 2), ((2, 7, 9, 8), 2), ((2, 6, 10, 5), 2),
    ((3, 9, 11, 16), 3), ((1, 9, 13, 4), 4)],
    ids=["medium_branch", "odd_hw", "ragged_c", "k3", "k4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool2d_bitwise_with_nan_and_signed_zero_ties(dev, shape, k,
                                                         dtype):
    """maxpool2d equals F.max_pool2d bit for bit: NaNs stick, ties of +0
    and -0 keep the first in row-major window order, the odd edge is
    dropped; 16-byte vectors (C a multiple of 4 or 8), the scalar path
    (ragged C), and k = 2 unrolled or other k read at run time."""
    gen = torch.Generator().manual_seed(sum(shape) + k)
    x = torch.randn(shape, generator=gen)
    flat = x.view(-1)
    idx = torch.randperm(flat.numel(), generator=gen)
    flat[idx[:7]] = float("nan")
    flat[idx[7:40]] = 0.0
    flat[idx[40:80]] = -0.0
    x[0, :k, :k] = 0.0                  # a window of +0 after -0 ...
    x[0, 0, 0] = -0.0                   # ... and its first value -0
    x = x.to(dtype).to(dev)
    before = pool.maxpool2d.launches
    out = pool.maxpool2d(x, k)
    assert pool.maxpool2d.launches == before + 1
    want = pool.maxpool2d_plain(x, k)
    assert out.shape == want.shape and out.dtype == dtype
    assert torch.isnan(out).any() and bool((_bits(out) == _bits(want)).all())


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


# conv cases: (wrapper, plain, x shape, w shape, kwargs, the kernel a bf16
# call must launch; every fp32 call launches the SIMT kernel)
CONV_CASES = {
    "trunk1": (conv.conv3d, conv.conv3d_plain, (1, 4, 21, 31, 1),
               (2, 3, 3, 1, 16),
               dict(depth_padding="causal_same", fuse_silu=True), "simt"),
    "trunk2": (conv.conv3d, conv.conv3d_plain, (1, 4, 21, 31, 16),
               (1, 3, 3, 16, 64), dict(depth_padding="same"), "tc"),
    "branch1": (conv.conv2d, conv.conv2d_plain, (10, 20, 30, 1),
                (3, 3, 1, 16), dict(fuse_silu=True), "simt"),
    "branch2": (conv.conv2d, conv.conv2d_plain, (10, 20, 30, 16),
                (3, 3, 16, 32), {}, "tc"),
    "odd": (conv.conv2d, conv.conv2d_plain, (2, 7, 9, 3), (3, 3, 3, 5),
            dict(fuse_silu=True), "simt"),
    # a ragged channel tile: the last of 40 channels' tiles is part-empty
    "cout40": (conv.conv2d, conv.conv2d_plain, (10, 20, 30, 16),
               (3, 3, 16, 40), dict(fuse_silu=True), "tc"),
    "one_row": (conv.conv2d, conv.conv2d_plain, (4, 1, 37, 16),
                (3, 3, 16, 32), {}, "tc"),
    "causal_d4": (conv.conv3d, conv.conv3d_plain, (2, 4, 9, 11, 16),
                  (2, 3, 3, 16, 16),
                  dict(depth_padding="causal_same", fuse_silu=True), "tc"),
    "noncontiguous": (conv.conv3d, conv.conv3d_plain, (1, 4, 21, 31, 16),
                      (1, 3, 3, 16, 64), dict(fuse_silu=True), "tc"),
    "large_branch2": (conv.conv2d, conv.conv2d_plain, (10, 20, 60, 16),
                      (3, 3, 16, 32), dict(fuse_silu=True), "tc"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_choice_counts_and_bits(dev, case, dtype):
    """Each convolution case launches the kernel kernel_for names (bf16 at
    Cin 16 on the tensor cores, fp32 on the SIMT kernel) and counts it
    there; agrees with its plain version within chip_smoke.FUSION_TOL;
    two calls give the same bits. ``noncontiguous`` reads every other
    channel of a wider tensor."""
    kern, plain, xs, ws, kw, bf16_kernel = CONV_CASES[case]
    gen = torch.Generator().manual_seed(len(case))
    if case == "noncontiguous":
        wide = torch.randn(xs[:-1] + (2 * xs[-1],), generator=gen)
        x = (wide * 0.4).to(dtype).to(dev)[..., ::2]
        assert not x.is_contiguous()
    else:
        x = (torch.randn(xs, generator=gen) * 0.4).to(dtype).to(dev)
    w = (torch.randn(ws, generator=gen) * 0.4).to(dtype).to(dev)
    want = bf16_kernel if dtype == torch.bfloat16 else "simt"
    assert conv.kernel_for(dtype, ws[-2], ws[-1]) == want
    before = (kern.launches, kern.tc_launches, kern.simt_launches)
    out = kern(x, w, **kw)
    again = kern(x, w, **kw)
    moved = (kern.launches - before[0], kern.tc_launches - before[1],
             kern.simt_launches - before[2])
    assert moved == ((2, 2, 0) if want == "tc" else (2, 0, 2))
    assert torch.equal(out, again)
    ref = plain(x, w, **kw)
    assert out.dtype == dtype and out.shape == ref.shape
    rtol, atol = chip_smoke.FUSION_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("shape,out_hw", [
    ((10, 10, 15, 40), (1, 1)), ((3, 6, 5, 40), (6, 5)),
    ((10, 10, 15, 32), (1, 1))],
    ids=["ragged_c40", "window_of_1", "branch"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aap2d_block_reduction(dev, shape, out_hw, dtype):
    """The window reduction at 40 channels (a ragged 32-channel tile), at
    windows of one pixel (each output is its input, exactly) and at the
    branch shape: within the fusion tolerances of the plain version, and
    two calls bitwise equal."""
    gen = torch.Generator().manual_seed(shape[-1])
    x = torch.randn(shape, generator=gen).to(dtype).to(dev)
    before = pool.adaptive_avg_pool2d.launches
    out = pool.adaptive_avg_pool2d(x, out_hw)
    again = pool.adaptive_avg_pool2d(x, out_hw)
    assert pool.adaptive_avg_pool2d.launches == before + 2
    assert torch.equal(out, again)
    want = pool.adaptive_avg_pool2d_plain(x, out_hw)
    assert out.dtype == dtype and out.shape == want.shape
    rtol, atol = chip_smoke.FUSION_TOL[str(dtype).split(".")[-1]]
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=atol)
    if out_hw == tuple(shape[1:3]):
        assert torch.equal(out, x)


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


@pytest.mark.parametrize("name", ["silu_lut", "silu_exact"])
@pytest.mark.parametrize("n", [6000, 768000, (1 << 14) + 3])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_silu_kernels_match_plain(dev, name, n, offset, dtype):
    """Bitwise equal to the plain version (the same fp32 arithmetic; the
    table built the same way on the same device), NaN where it has NaN, on
    a view ``offset`` elements into its buffer (off a 16-byte boundary at
    1) and at n off a multiple of the 16-byte vector; one launch
    counted."""
    kern = getattr(silu, name)
    plain = getattr(silu, f"{name}_plain")
    x = chip_smoke.silu_case(
        chip_smoke.silu_inputs(n, torch.Generator().manual_seed(n)), offset,
        dtype, dev)
    if n % 60 == 0:
        x = x.reshape(60, -1)
    assert x.data_ptr() % 16 == (offset * x.element_size()) % 16
    before = kern.launches
    out = kern(x)
    assert kern.launches == before + 1
    ref_ = plain(x)
    assert out.dtype == dtype and out.shape == x.shape
    assert chip_smoke.same_bits(out, ref_)


FLASH_CASES = {   # (B, Sq, Sk, Hq, Hkv, D, dtype, input scale)
    "sweep_256": (2, 256, 256, 4, 4, 32, torch.float32, 0.5),
    "sweep_512_gqa": (2, 512, 512, 8, 2, 16, torch.float32, 0.5),
    "sweep_256x512": (2, 256, 512, 2, 2, 64, torch.float32, 0.5),
    "bf16_256": (1, 256, 256, 2, 2, 32, torch.bfloat16, 0.5),
    "ragged_200": (1, 200, 200, 4, 2, 64, torch.float32, 0.5),
    "qwen_S4096_bf16": (1, 4096, 4096, 40, 8, 128, torch.bfloat16, 1.0),
    # the tensor-core kernel: both widths, qwen's group of 5, ragged tiles,
    # Sq < Sk (non-causal only), and two batches
    "tc_bf16_d64": (2, 256, 256, 4, 4, 64, torch.bfloat16, 1.0),
    "tc_bf16_d128": (2, 256, 256, 4, 4, 128, torch.bfloat16, 1.0),
    "tc_bf16_gqa5": (1, 512, 512, 10, 2, 128, torch.bfloat16, 1.0),
    "tc_bf16_ragged_200": (1, 200, 200, 10, 2, 128, torch.bfloat16, 1.0),
    "tc_bf16_256x512": (1, 256, 512, 4, 2, 128, torch.bfloat16, 1.0),
    # the SIMT kernel at the configurations' other widths: hubert-xlarge's
    # 80, recurrentgemma-2b's 256 (one kv head), deepseek-v3's MLA D 192
    # with Dv 128, and a ragged S at 256; fp32 and bf16
    "simt_d80": (1, 256, 256, 4, 4, 80, torch.float32, 0.5),
    "simt_d80_bf16": (1, 256, 256, 4, 4, 80, torch.bfloat16, 1.0),
    "simt_d256_gqa": (1, 256, 256, 4, 1, 256, torch.float32, 0.5),
    "simt_d256_bf16": (1, 256, 256, 4, 1, 256, torch.bfloat16, 1.0),
    "simt_d256_ragged_200": (1, 200, 200, 4, 2, 256, torch.float32, 0.5),
    "simt_mla_d192": (1, 256, 256, 4, 4, 192, torch.float32, 0.5),
    "simt_mla_d192_bf16": (1, 256, 256, 4, 4, 192, torch.bfloat16, 1.0),
}
FLASH_DV = {"simt_mla_d192": 128, "simt_mla_d192_bf16": 128}  # else Dv = D
# The tensor-core cases hold the kernel to the reference's online-softmax
# path in these chunks (p rounded to bf16 before it is normalised, as in
# the kernel): the direct path rounds the normalised p, which parts from
# the kernel by more than the bf16 test allows in causal rows with few keys
# (tests/test_torch_flash_tc.py).
FLASH_REF_CHUNK = {"tc_bf16_d64": 64, "tc_bf16_d128": 64,
                   "tc_bf16_gqa5": 128, "tc_bf16_ragged_200": 40,
                   "tc_bf16_256x512": 128, "simt_d80_bf16": 32,
                   "simt_d256_bf16": 32, "simt_mla_d192_bf16": 32}


@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_plain(dev, case):
    """Non-causal (flash_attention) and causal (flash_attention_causal_gqa)
    against models.layers.attention: atol 2e-5 fp32; 3e-2 bf16 and, element
    by element, 2e-3 + 1e-2 |ref| (chip_smoke.flash_excess); one launch per
    call, on the kernel that flash.kernel_for names."""
    b, sq, sk, hq, hkv, d, dt, scale = FLASH_CASES[case]
    dv = FLASH_DV.get(case, d)
    gen = torch.Generator().manual_seed(sq + hq)
    q, k, v = ((torch.randn(shape, generator=gen) * scale).to(dt).to(dev)
               for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                             (b, sk, hkv, dv)))
    tol = 2e-5 if dt == torch.float32 else 3e-2
    # JAX's default blocks where 128 does not divide the sequence
    blocks = dict(block_q=128, block_k=128) if sq % 128 == sk % 128 == 0 \
        else {}
    calls = [(lambda: flash.flash_attention(q, k, v, causal=False, **blocks),
              False)]
    if sq == sk:
        calls.append((lambda: flash.flash_attention_causal_gqa(
            q, k, v, **blocks), True))
    kernel = flash.kernel_for(dt, d, dv)
    assert kernel == ("tc" if case.startswith("tc_") or case.startswith(
        "qwen") else "simt")
    for call, causal in calls:
        before = flash.flash_attention.launches
        before_k = getattr(flash.flash_attention, f"{kernel}_launches")
        out = call()
        assert flash.flash_attention.launches == before + 1
        assert getattr(flash.flash_attention,
                       f"{kernel}_launches") == before_k + 1
        want = ref.attention(q, k, v, causal=causal,
                             chunk=FLASH_REF_CHUNK.get(case, 1024))
        assert out.dtype == dt and out.shape == want.shape
        torch.testing.assert_close(out.float(), want.float(), rtol=0,
                                   atol=tol)
        if dt == torch.bfloat16:
            assert chip_smoke.flash_excess(out, want) <= 1.0


def test_flash_attention_simt_takes_unaligned_views(dev):
    """An fp32 q that starts 4 bytes into its storage (the SIMT kernel
    copies 16 bytes at a time) is copied first, and matches."""
    gen = torch.Generator().manual_seed(10)
    base = torch.randn((1 + 1 * 96 * 4 * 80,), generator=gen) * 0.5
    q = base.to(dev)[1:].view(1, 96, 4, 80)
    k, v = ((torch.randn((1, 96, 2, 80), generator=gen) * 0.5).to(dev)
            for _ in range(2))
    assert q.data_ptr() % 16 != 0
    before = flash.flash_attention.simt_launches
    out = flash.flash_attention_causal_gqa(q, k, v, block_q=32, block_k=32)
    assert flash.flash_attention.simt_launches == before + 1
    torch.testing.assert_close(out, ref.attention(q, k, v, causal=True),
                               rtol=0, atol=2e-5)


def test_flash_attention_tc_takes_unaligned_views(dev):
    """A q that starts 2 bytes into its storage (TMA needs 16) still goes
    through the tensor-core kernel and matches the plain version."""
    gen = torch.Generator().manual_seed(9)
    base = torch.randn((1 + 1 * 128 * 4 * 64,), generator=gen)
    q = base.bfloat16().to(dev)[1:].view(1, 128, 4, 64)
    k, v = (torch.randn((1, 128, 2, 64), generator=gen).bfloat16().to(dev)
            for _ in range(2))
    assert q.data_ptr() % 16 != 0
    before = flash.flash_attention.tc_launches
    out = flash.flash_attention(q, k, v, causal=False)
    assert flash.flash_attention.tc_launches == before + 1
    assert chip_smoke.flash_excess(
        out, ref.attention(q, k, v, causal=False, chunk=32)) <= 1.0


@pytest.mark.parametrize("shape,tiling", [
    ((2, 64, 2, 8), (16, 2)), ((2, 64, 2, 8), (64, 1)),
    ((3, 50, 2, 12), (25, 3)), ((2, 40, 3, 6), (20, 2)),
    ((16, 32, 2, 64), (32, 8)), ((8, 256, 4, 512), (256, 8))],
    ids=["small_tb16_bt2", "small_tb64_bt1", "odd", "scalar_slices",
         "two_batch_chunks", "xlstm_widths_S256"])
def test_slstm_fused_matches_plain(dev, shape, tiling):
    """The cooperative kernel against ref.slstm_sequential within 1e-4
    (R scaled by 1/sqrt(dh) at xlstm-1.3b's widths; tests/test_torch_slstm.py
    says why); one launch."""
    b, s, nh, dh = shape
    gen = torch.Generator().manual_seed(b * s)
    wx = torch.randn((b, s, 4 * nh * dh), generator=gen).to(dev)
    r = (torch.randn((nh, dh, 4 * dh), generator=gen)
         * (0.3 if dh < 64 else dh ** -0.5)).to(dev)
    before = slstm.slstm_fused.launches
    out = slstm.slstm_fused(wx, r, time_block=tiling[0], batch_tile=tiling[1])
    assert slstm.slstm_fused.launches == before + 1
    torch.testing.assert_close(out, ref.slstm_sequential(wx, r), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("nh", [1, 2, 3, 4])
def test_slstm_fused_bitwise_across_tilings_and_heads(dev, nh):
    """time_block and batch_tile do not change a bit; the first rows of a
    batch are bitwise the narrower batch's; each head's units are bitwise
    that head run alone (a step waits only for its own head, and no sum
    crosses heads); within 1e-4 of the plain version."""
    b, s, dh = 4, 48, 64
    gen = torch.Generator().manual_seed(nh)
    wx = torch.randn((b, s, 4 * nh * dh), generator=gen).to(dev)
    r = (torch.randn((nh, dh, 4 * dh), generator=gen) * dh ** -0.5).to(dev)
    out = slstm.slstm_fused(wx, r)
    for tb, bt in ((16, 2), (48, 1), (8, 4)):
        assert torch.equal(slstm.slstm_fused(wx, r, time_block=tb,
                                             batch_tile=bt), out)
    assert torch.equal(slstm.slstm_fused(wx[:2].contiguous(), r), out[:2])
    d = nh * dh
    for h in range(nh):
        cols = torch.cat([torch.arange(g * d + h * dh, g * d + (h + 1) * dh)
                          for g in range(4)]).to(dev)
        alone = slstm.slstm_fused(wx[..., cols].contiguous(),
                                  r[h:h + 1].contiguous())
        assert torch.equal(alone, out[..., h * dh:(h + 1) * dh]), h
    torch.testing.assert_close(out, ref.slstm_sequential(wx, r), rtol=0,
                               atol=1e-4)


def test_slstm_fused_at_jax_init_scale(dev):
    """xlstm-1.3b's widths with R ~ N(0, 1/6), the JAX package's init, where
    fp32 is chaotic: within 1e-4 of the plain version over the first 4
    steps, and over 64 steps never more than 4x the fp32 plain version's
    own error against float64 until that reaches 0.1 (chip_smoke.py holds
    B 8 to the same)."""
    gen = torch.Generator().manual_seed(11)
    wx = torch.randn((2, 64, 4 * 2048), generator=gen).to(dev)
    r = (torch.randn((4, 512, 2048), generator=gen) * 6 ** -0.5).to(dev)
    out = slstm.slstm_fused(wx, r)
    p32 = ref.slstm_sequential(wx, r)
    p64 = ref.slstm_sequential(wx.double(), r.double())
    assert float((out - p32)[:, :4].abs().max()) <= 1e-4
    e_k = (out.double() - p64).abs().amax(dim=(0, 2))
    e_p = (p32.double() - p64).abs().amax(dim=(0, 2))
    live = e_p < 0.1
    assert int(live.sum()) >= 8
    assert bool((e_k[live] <= 4 * e_p[live] + 1e-6).all())


def test_slstm_fused_bf16_matches_plain(dev):
    """bf16 wx: fp32 state, only h rounded to bf16 on output, as the plain
    version does; within one bf16 ulp of |h| <= 1."""
    gen = torch.Generator().manual_seed(7)
    wx = torch.randn((2, 64, 4 * 2 * 8), generator=gen).bfloat16().to(dev)
    r = (torch.randn((2, 8, 32), generator=gen) * 0.3).to(dev)
    out = slstm.slstm_fused(wx, r)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(),
                               ref.slstm_sequential(wx, r).float(), rtol=0,
                               atol=2 ** -8)


def test_slstm_fused_raises_when_not_coresident(dev):
    """8192 heads of 16 units need 8192 resident blocks: the cooperative
    launch is refused and the wrapper raises instead of degrading."""
    wx = torch.zeros((1, 2, 4 * 8192 * 16), device=dev)
    r = torch.zeros((8192, 16, 64), device=dev)
    assert slstm.launch_plan(1, 8192, 16)["blocks"] == 8192
    before = slstm.slstm_fused.launches
    with pytest.raises(RuntimeError, match="resident"):
        slstm.slstm_fused(wx, r)
    assert slstm.slstm_fused.launches == before


def test_layer_breakdown_on_the_card(dev):
    """Fig 7 at small on the card: the JAX rows, both SiLU kernels
    launched."""
    before = (silu.silu_lut.launches, silu.silu_exact.launches)
    rows = layer_breakdown.run("small", device=dev)
    assert [r[0] for r in rows][-1] == "fig7/silu_lut" and len(rows) == 9
    assert silu.silu_lut.launches > before[0]
    assert silu.silu_exact.launches > before[1]
