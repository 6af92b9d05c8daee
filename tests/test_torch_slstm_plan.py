"""The launch plan and the order of sums of the fused sLSTM kernel
(csrc/slstm.cu), on the CPU, where no kernel can run.

  * ``slstm.slstm_plan`` gives every (head, k, gate column) of R to
    exactly one thread of one block, and every (batch row, gate column)
    pre-activation of a step to exactly one reduction, at xlstm-1.3b's
    widths (4 heads of 512) and at the card tests' widths. The enumeration
    repeats the kernel's index arithmetic (block = per_head blocks a head,
    U units; thread (tid % U, tid / U) owns 4 gate columns and the k of one
    slice).
  * The fields that order a sum (units, slices, slice_len, threads, blocks
    a head) are the same for every B, and xlstm-1.3b's block fits 227 KB.
  * An emulation of the kernel's order of sums (per output, each slice's
    chain in k order, the slices in order after wx) agrees with
    ``ref.slstm_sequential`` within 1e-4, and gives bitwise the same rows
    at any batch width.
  * Stand-in plans that drop or repeat a piece fail the cover test.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.lm import get_lm_config
from repro_torch.kernels import ref, slstm

_X = get_lm_config("xlstm-1.3b")
XLSTM = (_X.num_heads, _X.d_model // _X.num_heads)
# (nh, dh) of tests/test_torch_cuda.py's sLSTM cases, and xlstm-1.3b's
WIDTHS = {"xlstm_1_3b": XLSTM, "small": (2, 8), "odd": (2, 12),
          "scalar_slices": (3, 6), "two_batch_chunks": (2, 64),
          "ragged_slices": (2, 20), "one_unit": (2, 7)}
MAX_SMEM = 232448


def r_cover(plan, nh, dh, stride=None):
    """count[h, k, j]: how often the kernel multiplies R[h, k, j] (j the
    gate column g * dh + unit) into a pre-activation of one batch row.
    ``stride`` other than the plan's slices is a stand-in k stride."""
    count = np.zeros((nh, dh, 4 * dh), np.int64)
    U = plan.units
    for blk in range(plan.blocks):
        hh, u0 = blk // plan.per_head, (blk % plan.per_head) * U
        for tid in range(plan.threads):
            cq, sl = tid % U, tid // U
            ks = list(range(sl, dh, stride or plan.slices))
            assert len(ks) <= plan.slice_len
            for q in range(cq * slstm.TILE_Q, (cq + 1) * slstm.TILE_Q):
                g, u = divmod(q, U)
                count[hh, ks, g * dh + u0 + u] += 1
    return count


def pre_cover(plan, batch, nh, dh):
    """count[b, j]: how often a pre-activation (batch row b, global gate
    column j) is summed by a gate update (thread idx = b * U + u of each
    block, its four gates)."""
    count = np.zeros((batch, 4 * nh * dh), np.int64)
    U = plan.units
    for blk in range(plan.blocks):
        hh, u0 = blk // plan.per_head, (blk % plan.per_head) * U
        for idx in range(batch * U):
            b, u = divmod(idx, U)
            for g in range(4):
                count[b, g * nh * dh + hh * dh + u0 + u] += 1
    return count


@pytest.mark.parametrize("width", list(WIDTHS))
def test_slstm_plan_covers_r_once(width):
    nh, dh = WIDTHS[width]
    for batch in (1, 3, 8, 16):
        plan = slstm.slstm_plan(batch, nh, dh)
        assert plan.threads == plan.units * plan.slices <= slstm.MAX_THREADS
        assert plan.blocks == nh * plan.per_head
        assert plan.bpad % slstm.TILE_B == 0 and plan.bpad >= batch
        assert 1 <= plan.slices <= dh      # every slice holds a k
        np.testing.assert_array_equal(r_cover(plan, nh, dh), 1)
        np.testing.assert_array_equal(pre_cover(plan, batch, nh, dh), 1)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_slstm_plan_order_does_not_depend_on_batch(width):
    nh, dh = WIDTHS[width]
    order = lambda p: (p.units, p.slices, p.slice_len, p.threads,  # noqa
                       p.blocks, p.per_head)
    base = order(slstm.slstm_plan(1, nh, dh))
    for batch in (2, 5, 8, 9, 16):
        assert order(slstm.slstm_plan(batch, nh, dh)) == base


def test_slstm_plan_at_xlstm_widths():
    """128 blocks of 256 threads, 32 a head (the group a step waits for),
    16 slices of 32 k each; 189,952 shared bytes at B 8, inside 227 KB."""
    nh, dh = XLSTM
    plan = slstm.slstm_plan(8, nh, dh)
    assert (plan.units, plan.slices, plan.slice_len, plan.threads,
            plan.blocks, plan.per_head) == (16, 16, 32, 256, 128, 32)
    assert plan.smem == 189952 <= MAX_SMEM
    info = slstm.launch_plan(8, nh, dh)
    assert info["blocks"] == 128 and info["blocks_per_head"] == 32
    assert info["smem_bytes"] == plan.smem
    # the card test that must not fit: 8192 heads of 16 units
    assert slstm.launch_plan(1, 8192, 16)["blocks"] == 8192


@pytest.mark.parametrize("fault", ["stride_long", "stride_short",
                                   "units_short"])
def test_cover_check_fails_a_wrong_plan(fault):
    nh, dh = XLSTM
    plan = slstm.slstm_plan(8, nh, dh)
    with pytest.raises(AssertionError):
        if fault == "stride_long":      # a k of some slices skipped
            np.testing.assert_array_equal(
                r_cover(plan, nh, dh, stride=plan.slices + 1), 1)
        elif fault == "stride_short":   # slices read some k twice
            np.testing.assert_array_equal(
                r_cover(plan, nh, dh, stride=plan.slices - 1), 1)
        else:                           # a unit of every block dropped
            bad = plan._replace(units=plan.units - 1, threads=(
                plan.units - 1) * plan.slices)
            np.testing.assert_array_equal(r_cover(bad, nh, dh), 1)


def emulate(wx, r, plan):
    """csrc/slstm.cu's recurrence in fp32, in its order of sums: each
    pre-activation is wx plus the slices' partial sums in slice order,
    slice s's partial sum its chain over k = s, s + KS, ... in order."""
    b, s, _ = wx.shape
    nh, dh, _ = r.shape
    d = nh * dh
    KS = plan.slices
    h = torch.zeros((b, nh, dh))
    c, n, m = (torch.zeros((b, d)) for _ in range(3))
    out = torch.empty((b, s, d))
    for t in range(s):
        parts = []
        for sl in range(KS):
            acc = torch.zeros((b, nh, 4 * dh))
            for k in range(sl, dh, KS):
                acc = acc + h[:, :, k, None] * r[None, :, k, :]
            parts.append(acc)
        rh = parts[0]
        for p in parts[1:]:
            rh = rh + p
        rh = rh.reshape(b, nh, 4, dh).transpose(1, 2).reshape(b, 4 * d)
        pre = wx[:, t] + rh
        z, i_pre, f_pre, o = pre.split(d, dim=-1)
        z, o = torch.tanh(z), torch.sigmoid(o)
        log_f = torch.nn.functional.logsigmoid(f_pre)
        m_new = torch.maximum(log_f + m, i_pre)
        i_g, f_g = torch.exp(i_pre - m_new), torch.exp(log_f + m - m_new)
        c, n = f_g * c + i_g * z, f_g * n + i_g
        hv = o * c / torch.clamp(n.abs(), min=1.0)
        m = m_new
        out[:, t] = hv
        h = hv.reshape(b, nh, dh)
    return out


@pytest.mark.parametrize("shape", [(3, 24, 2, 64), (2, 6, 4, 512),
                                   (3, 20, 2, 20)],
                         ids=["dh64", "xlstm_widths_S6",
                              "ragged_slices"])
def test_kernel_arithmetic_matches_plain(shape):
    """The emulated kernel vs ref.slstm_sequential within 1e-4 (R scaled by
    1/sqrt(dh), as the card's comparison at xlstm-1.3b's widths); the first
    rows of a wider batch are bitwise the narrow batch's."""
    b, s, nh, dh = shape
    rng = np.random.default_rng(b * s + dh)
    wx = torch.from_numpy(rng.standard_normal((b, s, 4 * nh * dh))
                          .astype(np.float32))
    r = torch.from_numpy((rng.standard_normal((nh, dh, 4 * dh))
                          * dh ** -0.5).astype(np.float32))
    got = emulate(wx, r, slstm.slstm_plan(b, nh, dh))
    torch.testing.assert_close(got, ref.slstm_sequential(wx, r), rtol=0,
                               atol=1e-4)
    narrow = emulate(wx[:1], r, slstm.slstm_plan(1, nh, dh))
    assert torch.equal(narrow, got[:1])
