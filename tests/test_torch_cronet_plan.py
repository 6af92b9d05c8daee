"""The launch plan and the order of sums of the CRONet kernels
(csrc/cronet_fused.cu: conv_kernel and the clustered head_kernel), on the
CPU, where no kernel can run.

  * ``cronet_pipeline.cronet_plan`` covers every conv2 output of both
    stages, every AAP3D window's pixels, every time step's pooled pixels,
    every fc1 K row and every fc2 column exactly once, at small, medium and
    large, in fp32 and bf16. The enumerations below repeat the kernels'
    index arithmetic (conv_kernel: trunk tile (d, band), branch tile (t,
    band), thread (input-channel group, channel group, pixel run) owning
    RUN pixels of one row; head_kernel: rank r's K chunk and columns,
    thread (g, q) lanes).
  * The plan is the same for every B (only ``batch`` moves) and fits the
    227 KB of shared memory a block may have.
  * An emulation of the kernels' arithmetic in that plan, in PyTorch fp32
    (each sum in the kernels' order), agrees with the JAX oracle
    ``repro.core.cronet.forward`` within rtol = atol = 1e-4.
  * Stand-in plans and index maps that drop or repeat one piece fail the
    cover tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import materialize
from repro.configs.cronet import get_cronet_config as jget_config
from repro.core import cronet as jcronet
from repro_torch.common import params_from_jax
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.kernels import cronet_pipeline as cp

SIZES = ("small", "medium", "large")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _win(i, n_in, n_out):
    """An adaptive pool window [start, end), PyTorch's rule, written
    independently of the kernel's helpers."""
    return (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)


def conv2_cover(cfg, plan, band_stride=None):
    """How often conv_kernel computes each conv2 output's share of each
    input-channel group: trunk (D, H, W, 64, SPLIT) and branch (T, ny, nx,
    32, SPLIT). ``band_stride`` other than the plan's rows is a stand-in
    index map."""
    H, W = cfg.nodes
    D, T, ny, nx = cfg.t_depth, cfg.hist_len, cfg.nely, cfg.nelx
    trunk = np.zeros((D, H, W, cp.TRUNK_C2, cp.SPLIT), np.int64)
    branch = np.zeros((T, ny, nx, cp.BRANCH_C2, cp.SPLIT), np.int64)
    n_trunk = D * plan.t_bands
    for bx in range(plan.conv_blocks):
        if bx < n_trunk:
            z, band = divmod(bx, plan.t_bands)
            rows, runs, c2, himg, wimg, out = (plan.t_rows, plan.t_runs,
                                               cp.TRUNK_C2, H, W, trunk)
        else:
            z, band = divmod(bx - n_trunk, plan.b_bands)
            rows, runs, c2, himg, wimg, out = (plan.b_rows, plan.b_runs,
                                               cp.BRANCH_C2, ny, nx, branch)
        y0 = band * (band_stride or rows)
        n_pg = cp.GROUP_THREADS // (c2 // cp.CHAN)
        for tid in range(cp.THREADS):
            g, rt = divmod(tid, cp.GROUP_THREADS)
            cgp, pg = divmod(rt, n_pg)
            r, x0 = pg // runs, (pg % runs) * cp.RUN
            if r >= rows or y0 + r >= himg:
                continue
            for x in range(x0, x0 + cp.RUN):
                if x < wimg:   # the run's pixels past the image are padding
                    out[z, y0 + r, x, cgp * cp.CHAN:(cgp + 1) * cp.CHAN,
                        g] += 1
    return trunk, branch


def window_cover(cfg, plan):
    """count[k, i, j, d, y, x]: how often pixel (d, y, x) of the trunk's
    conv2 output enters AAP3D feature (k, i, j) through conv_kernel's row
    sums (rowsum) and head_kernel's depth/row sums; and how often each
    rowsum (d, y, j) is written."""
    H, W = cfg.nodes
    D = cfg.t_depth
    PD, PH, PW = cfg.t_pool
    writes = np.zeros((D, H, PW), np.int64)
    # conv_kernel's reduction: (r, j) of each trunk tile, x over window j
    row_px = {}
    for bx in range(D * plan.t_bands):
        d, band = divmod(bx, plan.t_bands)
        y0 = band * plan.t_rows
        for r in range(plan.t_rows):
            y = y0 + r
            if y >= H:
                continue
            for j in range(PW):
                ws, we = _kernel_win(j, W, PW)
                writes[d, y, j] += 1
                row_px[(d, y, j)] = list(range(ws, we))
    count = np.zeros((PD, PH, PW, D, H, W), np.int64)
    F = PD * PH * PW * cp.TRUNK_C2
    for rank in range(plan.cluster):
        k0 = rank * plan.k_chunk
        for f in range(max(0, min(F - k0, plan.k_chunk))):
            idx = k0 + f
            if idx % cp.TRUNK_C2:          # one channel stands for all
                continue
            rest = idx // cp.TRUNK_C2
            j, rest = rest % PW, rest // PW
            i, k = rest % PH, rest // PH
            for dz in range(*_kernel_win(k, D, PD)):
                for y in range(*_kernel_win(i, H, PH)):
                    for x in row_px[(dz, y, j)]:
                        count[k, i, j, dz, y, x] += 1
    return count, writes


def _kernel_win(i, n_in, n_out):
    """csrc/cronet_fused.cu's win_start / win_end."""
    return (i * n_in) // n_out, ((i + 1) * n_in + n_out - 1) // n_out


def pool_cover(cfg, plan, group_step=cp.POOL_GROUPS):
    """How often each 2x2-pooled pixel (t, pr, pc) of the branch enters its
    band's sum (conv_kernel: group g takes pooled pixels g, g + 8, ...)."""
    T, ny, nx = cfg.hist_len, cfg.nely, cfg.nelx
    pw, prow = nx // 2, plan.b_rows // 2
    count = np.zeros((T, ny // 2, pw), np.int64)
    for t in range(T):
        for band in range(plan.b_bands):
            y0 = band * plan.b_rows
            for g in range(cp.POOL_GROUPS):
                for q in range(g, prow * pw, group_step):
                    lr, pc = divmod(q, pw)
                    if y0 + 2 * lr + 1 >= ny:
                        break
                    count[t, y0 // 2 + lr, pc] += 1
    return count


def fc_cover(cfg, plan, dtype, k_step=None):
    """How often head_kernel multiplies each fc1 row k (K = 4,800) and
    computes each fc2 column n (P = 2,560): rank r's K chunk over lanes q
    (k = q, q + kl, ...), rank r's columns by 16-byte vectors. ``k_step``
    other than kl is a stand-in index map."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    F, mid, P = cfg.trunk_features, cfg.mid, cfg.p
    krows = np.zeros(F, np.int64)
    cols = np.zeros(P, np.int64)
    kl1 = cp.THREADS // (mid // vec)
    nv = plan.col_chunk // vec
    for rank in range(plan.cluster):
        k0 = rank * plan.k_chunk
        nk = max(0, min(F - k0, plan.k_chunk))
        for q in range(kl1):
            for k in range(q, nk, k_step or kl1):
                krows[k0 + k] += 1
        c0 = rank * plan.col_chunk
        nc = max(0, min(P - c0, plan.col_chunk))
        for vi in range(nv):
            if vi * vec < nc:
                cols[c0 + vi * vec:c0 + (vi + 1) * vec] += 1
    return krows, cols


def check_plan(cfg, plan, dtype):
    trunk, branch = conv2_cover(cfg, plan)
    np.testing.assert_array_equal(trunk, 1)
    np.testing.assert_array_equal(branch, 1)
    count, writes = window_cover(cfg, plan)
    np.testing.assert_array_equal(writes, 1)
    H, W = cfg.nodes
    PD, PH, PW = cfg.t_pool
    want = np.zeros_like(count)
    for k in range(PD):
        for i in range(PH):
            for j in range(PW):
                d0, d1 = _win(k, cfg.t_depth, PD)
                y0, y1 = _win(i, H, PH)
                x0, x1 = _win(j, W, PW)
                want[k, i, j, d0:d1, y0:y1, x0:x1] = 1
    np.testing.assert_array_equal(count, want)
    np.testing.assert_array_equal(pool_cover(cfg, plan), 1)
    krows, cols = fc_cover(cfg, plan, dtype)
    np.testing.assert_array_equal(krows, 1)
    np.testing.assert_array_equal(cols, 1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("size", SIZES)
def test_cronet_plan_covers_every_piece_once(size, dtype):
    cfg = get_cronet_config(size)
    check_plan(cfg, cp.cronet_plan(cfg, 4, DTYPES[dtype]), DTYPES[dtype])


@pytest.mark.parametrize("size", SIZES)
def test_cronet_plan_is_the_same_for_every_batch_and_fits(size):
    """Only ``batch`` depends on B, so slot b's sums do not; every block
    fits 227 KB of shared memory; medium fills the card at one slot."""
    cfg = get_cronet_config(size)
    for dt in DTYPES.values():
        base = cp.cronet_plan(cfg, 1, dt)._replace(batch=0)
        for B in (2, 3, 4, 8, 64):
            plan = cp.cronet_plan(cfg, B, dt)
            assert plan.batch == B and plan._replace(batch=0) == base
            assert max(plan.conv_smem, plan.head_smem) <= cp.MAX_SMEM
            assert plan.cluster <= 8          # the portable cluster size
    plan = cp.cronet_plan(get_cronet_config("medium"), 1)
    assert (plan.t_rows, plan.t_bands, plan.b_rows, plan.b_bands) == (
        2, 11, 4, 5)
    assert plan.conv_blocks == 94 and plan.cluster == 8


def test_cronet_plan_rejects_what_the_kernels_do_not_take():
    cfg = get_cronet_config("medium")
    with pytest.raises(ValueError):
        cp.cronet_plan(dataclasses.replace(cfg, t_c2=48), 1)
    with pytest.raises(ValueError):
        cp.cronet_plan(dataclasses.replace(cfg, b_pool=(2, 2)), 1)
    with pytest.raises(ValueError):
        cp.cronet_plan(dataclasses.replace(cfg, nelx=200), 1)
    with pytest.raises(TypeError):
        cp.cronet_plan(cfg, 1, torch.float16)


@pytest.mark.parametrize("fault", ["rows_short", "band_dropped",
                                   "bands_overlap", "k_chunk_short",
                                   "columns_short", "k_lanes_repeat",
                                   "pool_groups_repeat"])
def test_cover_check_fails_a_wrong_plan(fault):
    """The cover tests are not vacuous: each stand-in drops or repeats a
    piece and is caught."""
    cfg = get_cronet_config("medium")
    plan = cp.cronet_plan(cfg, 1)
    with pytest.raises(AssertionError):
        if fault == "rows_short":
            trunk, _ = conv2_cover(cfg, plan._replace(t_rows=plan.t_rows - 1))
            np.testing.assert_array_equal(trunk, 1)
        elif fault == "band_dropped":
            bad = plan._replace(b_bands=plan.b_bands - 1,
                                conv_blocks=plan.conv_blocks - cfg.hist_len)
            _, branch = conv2_cover(cfg, bad)
            np.testing.assert_array_equal(branch, 1)
        elif fault == "bands_overlap":
            trunk, _ = conv2_cover(cfg, plan, band_stride=plan.t_rows - 1)
            np.testing.assert_array_equal(trunk, 1)
        elif fault == "k_chunk_short":
            krows, _ = fc_cover(cfg, plan._replace(k_chunk=plan.k_chunk - 1),
                                torch.float32)
            np.testing.assert_array_equal(krows, 1)
        elif fault == "columns_short":
            _, cols = fc_cover(cfg, plan._replace(
                col_chunk=plan.col_chunk - 4), torch.float32)
            np.testing.assert_array_equal(cols, 1)
        elif fault == "k_lanes_repeat":
            krows, _ = fc_cover(cfg, plan, torch.float32, k_step=12)
            np.testing.assert_array_equal(krows, 1)
        else:
            np.testing.assert_array_equal(pool_cover(cfg, plan, 4), 1)


# ------------------------------------------------ the kernels' arithmetic


def _silu(x):
    return x / (1 + torch.exp(-x))


def _conv1(planes, w1):
    """conv1 + SiLU over a (KD, H, W) stack: taps in (depth, row, col)
    order; w1 (KD, 3, 3, 1, 16) -> (H, W, 16)."""
    kd, H, W = planes.shape
    x = torch.nn.functional.pad(planes, (1, 1, 1, 1))
    acc = torch.zeros((H, W, cp.C1))
    for dd in range(kd):
        for ki in range(3):
            for kj in range(3):
                acc = acc + x[dd, ki:ki + H, kj:kj + W, None] * w1[dd, ki, kj, 0]
    return _silu(acc)


def _conv2(x1, w2):
    """conv2 + SiLU: each input-channel group's sum in (row tap, input
    channel, column tap) order, then the groups in order; x1 (H, W, 16),
    w2 (3, 3, 16, C2) -> (H, W, C2)."""
    H, W, _ = x1.shape
    x = torch.nn.functional.pad(x1, (0, 0, 1, 1, 1, 1))
    ci_n = cp.C1 // cp.SPLIT
    groups = []
    for g in range(cp.SPLIT):
        acc = torch.zeros((H, W, w2.shape[-1]))
        for ki in range(3):
            for ci in range(g * ci_n, (g + 1) * ci_n):
                for kj in range(3):
                    acc = acc + x[ki:ki + H, kj:kj + W, ci, None] * w2[ki, kj, ci]
        groups.append(acc)
    acc = groups[0]
    for a in groups[1:]:
        acc = acc + a
    return _silu(acc)


def _lanes(x, w, kl):
    """Sum over k of x[k] * w[k] as the head's lanes do: lane q's chain over
    k = q, q + kl, ... in k order, then the lanes in order. x (K,), w (K,
    N) -> (N,)."""
    K = x.shape[0]
    part = torch.zeros((kl, w.shape[1]))
    for j in range(-(-K // kl)):
        k = torch.arange(kl) + j * kl
        ok = k < K
        kk = torch.where(ok, k, 0)
        part = part + torch.where(ok[:, None], x[kk, None] * w[kk], 0.0)
    s = part[0]
    for q in range(1, kl):
        s = s + part[q]
    return s


def emulate(cfg, p, lv, hist, plan):
    """csrc/cronet_fused.cu's result in fp32, in its order of sums (fp32
    inputs: 16-byte vectors of 4 columns)."""
    H, W = cfg.nodes
    D, T, ny, nx = cfg.t_depth, cfg.hist_len, cfg.nely, cfg.nelx
    PD, PH, PW = cfg.t_pool
    tr, br = p["trunk"], p["branch"]
    vec, mid, P = 4, cfg.mid, cfg.p
    outs = []
    for b in range(lv.shape[0]):
        # trunk: conv tiles, row sums over each column window
        vol = lv[b, ..., 0]
        rowsum = torch.zeros((D, H, PW, cp.TRUNK_C2))
        for d in range(D):
            planes = torch.stack([vol[d + dd] if d + dd < D
                                  else torch.zeros((H, W))
                                  for dd in range(tr["conv1"].shape[0])])
            v = _conv2(_conv1(planes, tr["conv1"]), tr["conv2"][0])
            for j in range(PW):
                ws, we = _kernel_win(j, W, PW)
                s = v[:, ws]
                for x in range(ws + 1, we):
                    s = s + v[:, x]
                rowsum[d, :, j] = s
        feats = torch.zeros(PD, PH, PW, cp.TRUNK_C2)
        for k in range(PD):
            for i in range(PH):
                (d0, d1), (y0, y1) = _kernel_win(k, D, PD), _kernel_win(i, H, PH)
                for j in range(PW):
                    x0, x1 = _kernel_win(j, W, PW)
                    s = torch.zeros(cp.TRUNK_C2)
                    for dz in range(d0, d1):
                        for y in range(y0, y1):
                            s = s + rowsum[dz, y, j]
                    feats[k, i, j] = s / float((d1 - d0) * (y1 - y0) * (x1 - x0))
        feats = feats.reshape(-1)
        kl1 = cp.THREADS // (mid // vec)
        ranks = [_lanes(feats[r * plan.k_chunk:(r + 1) * plan.k_chunk],
                        tr["fc1"][r * plan.k_chunk:(r + 1) * plan.k_chunk],
                        kl1) for r in range(plan.cluster)]
        s = ranks[0]
        for r in ranks[1:]:
            s = s + r
        tmid = _silu(s)
        # branch: conv tiles, the floor 2x2 max pool, band sums by groups
        pw, prow = nx // 2, plan.b_rows // 2
        bfe = torch.zeros((T, cp.BRANCH_C2))
        for t in range(T):
            v = _conv2(_conv1(hist[b, t, None, :, :, 0], br["conv1"][None]),
                       br["conv2"])
            pooled = torch.maximum(
                torch.maximum(v[0:2 * (ny // 2):2, 0:2 * pw:2],
                              v[0:2 * (ny // 2):2, 1:2 * pw:2]),
                torch.maximum(v[1:2 * (ny // 2):2, 0:2 * pw:2],
                              v[1:2 * (ny // 2):2, 1:2 * pw:2]))
            total = torch.zeros(cp.BRANCH_C2)
            for band in range(plan.b_bands):
                lrows = pooled[band * prow:(band + 1) * prow].reshape(
                    -1, cp.BRANCH_C2)
                groups = []
                for g in range(cp.POOL_GROUPS):
                    s = torch.zeros(cp.BRANCH_C2)
                    for q in range(g, lrows.shape[0], cp.POOL_GROUPS):
                        s = s + lrows[q]
                    groups.append(s)
                bs = groups[0]
                for g in groups[1:]:
                    bs = bs + g
                total = total + bs
            bfe[t] = total * (1.0 / float((ny // 2) * pw))
        xw = torch.zeros((T, cp.HID))
        for k in range(cp.BRANCH_C2):
            xw = xw + bfe[:, k, None] * br["rnn_wx"][k]
        h = torch.zeros(cp.HID)
        for t in range(T):
            quarters = []
            for qq in range(4):
                c = torch.zeros(cp.HID)
                for i in range(16):
                    c = c + h[qq * 16 + i] * br["rnn_wh"][qq * 16 + i]
                quarters.append(c)
            c = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
            h = torch.tanh(xw[t] + c)
        s = torch.zeros(mid)
        for k in range(cp.HID):
            s = s + h[k] * br["fc1"][k]
        bmid = _silu(s)
        kl2 = cp.THREADS // (plan.col_chunk // vec)
        st = torch.cat([_lanes(tmid, tr["fc2"][:, r * plan.col_chunk:
                                                 (r + 1) * plan.col_chunk], kl2)
                        for r in range(plan.cluster)])
        sb = torch.cat([_lanes(bmid, br["fc2"][:, r * plan.col_chunk:
                                                 (r + 1) * plan.col_chunk], kl2)
                        for r in range(plan.cluster)])
        outs.append(sb[:P] * st[:P])
    return torch.stack(outs)


@pytest.mark.parametrize("size", ["small", "medium"])
def test_kernel_arithmetic_matches_jax_oracle(size):
    """The emulated kernels vs repro.core.cronet.forward (jit, fp32) at
    rtol = atol = 1e-4, the bar the card holds the kernel to."""
    cfg = dataclasses.replace(jget_config(size), dtype="float32")
    params = jax.device_get(materialize(jcronet.param_specs(cfg),
                                        jax.random.key(3)))
    rng = np.random.default_rng(3)
    lv = (rng.standard_normal((2, 4, cfg.nely + 1, cfg.nelx + 1, 1))
          * 0.3).astype(np.float32)
    hist = rng.random((2, cfg.hist_len, cfg.nely, cfg.nelx, 1),
                      dtype=np.float32)
    want = np.asarray(jax.jit(lambda p, a, b: jcronet.forward(cfg, p, a, b))(
        params, jnp.asarray(lv), jnp.asarray(hist)))
    tcfg = dataclasses.replace(get_cronet_config(size), dtype="float32")
    tp = params_from_jax(params, device="cpu")
    tp = {part: {k: v.float() for k, v in leaves.items()}
          for part, leaves in tp.items()}
    got = emulate(tcfg, tp, torch.from_numpy(lv), torch.from_numpy(hist),
                  cp.cronet_plan(tcfg, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
