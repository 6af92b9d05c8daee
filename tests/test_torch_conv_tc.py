"""The convolution wrapper's choice of kernel, its tile plan, and the
tensor-core kernel's arithmetic, on the CPU.

``kernel_for`` is a fixed rule on dtype and channels, checked here as a
pure function. ``tile_plan`` is computed in Python and passed to
csrc/conv.cu, so its cover of the output is checked here too: the blocks
(decoded by ``tile_of`` as the kernel decodes ``blockIdx``) and, inside a
block, the SIMT kernel's slots of 2 pixels x 4 channels or the tensor-core
kernel's 16-pixel warp tiles must reach every output (pixel, channel)
exactly once, at CRONet's medium and large layer shapes and at odd ones.

The tensor-core kernel cannot run here, so ``_tc_emulated`` repeats its
arithmetic in PyTorch: bf16 operands, fp32 products summed one k16 step
(one filter tap of 16 input channels) at a time in the kernel's tap order,
SiLU in fp32, one rounding to bf16. It is held against
``repro.kernels.conv.conv2d``/``conv3d`` in interpret mode within the bf16
tolerance the card holds the kernel to (``chip_smoke.FUSION_TOL``), and a
stand-in that drops the last tap must fail the same test.
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import conv as jconv
from repro_torch import kernels
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.kernels import conv

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card's tolerances and layer shapes)


@pytest.fixture(autouse=True)
def no_launches():
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype,cin,cout,kernel", [
    (torch.float32, 16, 64, "simt"), (torch.float32, 16, 32, "simt"),
    (torch.float32, 1, 16, "simt"), (torch.bfloat16, 1, 16, "simt"),
    (torch.bfloat16, 3, 5, "simt"), (torch.bfloat16, 3, 32, "simt"),
    (torch.bfloat16, 16, 64, "tc"), (torch.bfloat16, 16, 32, "tc"),
    (torch.bfloat16, 32, 32, "tc"), (torch.bfloat16, 32, 64, "tc"),
    (torch.bfloat16, 16, 5, "simt"), (torch.bfloat16, 32, 5, "simt"),
    (torch.float16, 16, 32, "simt")])
def test_kernel_for_is_a_rule_on_dtype_and_channels(dtype, cin, cout, kernel):
    assert conv.kernel_for(dtype, cin, cout) == kernel


def _dims(x, w):
    """(B, D, H, W, Cin, KD, KH, KW, Cout) of a conv2d or conv3d call."""
    if len(x) == 4:
        x, w = (x[0], 1) + tuple(x[1:]), (1,) + tuple(w)
    return tuple(x) + tuple(w[:3]) + (w[4],)


def _layer_shapes(size):
    """CRONet's four convolution layers at ``size`` (chip_smoke's cases)."""
    cases = chip_smoke.fusion_cases(get_cronet_config(size))
    return {label: _dims(args["x"], args["w"])
            for name in ("conv3d", "conv2d")
            for label, per_fwd, args in cases[name] if per_fwd}


ODD = {"odd_7x9_cin3_cout5": _dims((2, 7, 9, 3), (3, 3, 3, 5)),
       "cout40": _dims((10, 20, 30, 16), (3, 3, 16, 40)),
       "one_row": _dims((4, 1, 37, 16), (3, 3, 16, 32)),
       "d4_causal_kd2": _dims((2, 4, 9, 11, 16), (2, 3, 3, 16, 16)),
       "wide_bands": _dims((3, 12, 300, 32), (3, 3, 32, 40))}
SHAPES = {**{f"medium/{k}": v for k, v in _layer_shapes("medium").items()},
          **{f"large/{k}": v for k, v in _layer_shapes("large").items()},
          **ODD}


def _cover(plan, dims):
    """How often each output (b, d, y, x, co) is written: by block, and by
    the kernel's thread slots (SIMT) or warp tiles (tensor cores)."""
    B, D, H, W, _, KD, KH, KW, cout = dims
    count = np.zeros((B, D, H, W, cout), np.int32)
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            b, d, y0, y1, x0, x1, c0, c1 = conv.tile_of(plan, dims, bx, by)
            nc, P = x1 - x0, (y1 - y0) * (x1 - x0)
            if plan.kernel == "simt":
                px, co = conv.SIMT_PX, conv.SIMT_CO
                ngc = plan.ct // co
                units = [([g // ngc * px + u for u in range(px)],
                          [c0 + g % ngc * co + v for v in range(co)])
                         for g in range(math.ceil(P / px) * ngc)]
            else:
                units = [([m * 16 + r for r in range(16)],
                          [c0 + c for c in range(plan.ct)])
                         for m in range(math.ceil(P / 16))]
            for pixels, chans in units:
                p = np.array([q for q in pixels if q < P], np.int64)
                c = np.array([q for q in chans if q < cout], np.int64)
                np.add.at(count, (b, d, (y0 + p // nc)[:, None],
                                  (x0 + p % nc)[:, None], c[None, :]), 1)
    return count


@pytest.mark.parametrize("kernel", ["simt", "tc"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_tile_plan_covers_every_output_once(shape, kernel):
    dims = SHAPES[shape]
    plan = conv.tile_plan(kernel, dims)
    assert plan.ct in (8, 16, 32)
    assert plan.threads % 32 == 0 and plan.smem <= conv.SMEM_BUDGET
    assert plan.threads <= (conv.MAX_THREADS if kernel == "simt"
                            else conv.MAX_SLOT_THREADS)
    # the split groups share the block's threads and divide its taps
    taps = dims[5] * dims[6] * dims[7]
    assert plan.threads % plan.split == 0 and 1 <= plan.split <= taps
    assert sorted(q for g in range(plan.split)
                  for q in range(g, taps, plan.split)) == list(range(taps))
    count = _cover(plan, dims)
    assert count.min() == 1 and count.max() == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layer", list(_layer_shapes("medium")))
def test_medium_layers_fill_the_card(layer, dtype):
    """Each of CRONet medium's four layers launches >= 132 blocks (one per
    SM of an H100) with the kernel it runs on."""
    dims = _layer_shapes("medium")[layer]
    plan = conv.tile_plan(conv.kernel_for(dtype, dims[4], dims[8]), dims)
    assert plan.grid[0] * plan.grid[1] >= conv.TARGET_BLOCKS


def _tc_emulated(x, w, *, depth_padding="same", fuse_silu=False,
                 drop_last_tap=False):
    """The tensor-core kernel's arithmetic on bf16 x (B, D, H, W, Cin) and
    w (KD, KH, KW, Cin, Cout): per tap (d, i, j), per 16 input channels,
    the fp32 sum of exact bf16 products added to an fp32 accumulator; SiLU
    in fp32; one rounding to bf16."""
    B, D, H, W, cin = x.shape
    kd, kh, kw, _, cout = w.shape
    pad_d = kd - 1 if depth_padding == "causal_same" else 0
    xp = F.pad(x.float(), (0, 0, kw // 2, kw // 2, kh // 2, kh // 2,
                           0, pad_d))
    acc = torch.zeros((B, D, H, W, cout))
    taps = [(d, i, j) for d in range(kd) for i in range(kh)
            for j in range(kw)]
    for d, i, j in taps[:-1] if drop_last_tap else taps:
        for k in range(0, cin, 16):
            a = xp[:, d:d + D, i:i + H, j:j + W, k:k + 16]
            acc = acc + torch.einsum("bdhwc,cn->bdhwn", a,
                                     w[d, i, j, k:k + 16].float())
    if fuse_silu:
        acc = acc / (1.0 + torch.exp(-acc))
    return acc.bfloat16()


TC_CASES = {
    "conv2d_16to8": ((2, 6, 7, 16), (3, 3, 16, 8), None),
    "conv2d_32to16": ((1, 5, 9, 32), (3, 3, 32, 16), None),
    "conv3d_causal": ((1, 4, 5, 6, 16), (2, 3, 3, 16, 8), "causal_same"),
    "conv3d_same_24": ((2, 3, 4, 5, 16), (1, 3, 3, 16, 24), "same"),
}


def _tc_inputs(case, seed):
    xs, ws, dp = TC_CASES[case]
    rng = np.random.default_rng(seed)
    xa = rng.standard_normal(xs).astype(np.float32)
    wa = (rng.standard_normal(ws) * 0.5).astype(np.float32)
    jx, jw = jnp.asarray(xa, jnp.bfloat16), jnp.asarray(wa, jnp.bfloat16)
    tx, tw = torch.from_numpy(xa).bfloat16(), torch.from_numpy(wa).bfloat16()
    return jx, jw, tx, tw, dp


def _jax(jx, jw, dp, fuse_silu):
    if dp is None:
        out = jconv.conv2d(jx, jw, fuse_silu=fuse_silu, interpret=True)
    else:
        out = jconv.conv3d(jx, jw, depth_padding=dp, fuse_silu=fuse_silu,
                           interpret=True)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def _emulate(tx, tw, dp, **kw):
    if dp is None:
        return _tc_emulated(tx[:, None], tw[None], **kw)[:, 0]
    return _tc_emulated(tx, tw, depth_padding=dp, **kw)


@pytest.mark.parametrize("fuse_silu", [False, True])
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_arithmetic_matches_pallas(case, fuse_silu):
    jx, jw, tx, tw, dp = _tc_inputs(case, seed=len(case))
    assert conv.kernel_for(torch.bfloat16, tx.shape[-1], tw.shape[-1]) == "tc"
    want = _jax(jx, jw, dp, fuse_silu)
    got = _emulate(tx, tw, dp, fuse_silu=fuse_silu)
    rtol, atol = chip_smoke.FUSION_TOL["bfloat16"]
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)
    # and the port's plain version, which the card compares with
    plain = (conv.conv2d_plain(tx, tw, fuse_silu=fuse_silu) if dp is None
             else conv.conv3d_plain(tx, tw, depth_padding=dp,
                                    fuse_silu=fuse_silu))
    torch.testing.assert_close(got.float(), plain.float(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("case", list(TC_CASES))
def test_tc_test_fails_a_kernel_that_drops_the_last_tap(case):
    jx, jw, tx, tw, dp = _tc_inputs(case, seed=len(case))
    want = _jax(jx, jw, dp, False)
    dropped = _emulate(tx, tw, dp, drop_last_tap=True)
    rtol, atol = chip_smoke.FUSION_TOL["bfloat16"]
    assert not torch.allclose(dropped.float(), want, rtol=rtol, atol=atol)
