"""The SIMT flash kernel's launch plan and order of operations
(csrc/flash_attention.cu, namespace simt), on the CPU, where no kernel can
run.

  * ``flash_attention.simt_plan`` fits every width the kernel takes (D a
    multiple of 16 up to 256, Dv in ``SIMT_DV``, fp32 and bf16) inside the
    227 KB a block may have, with the blocks an SM it promises (at least
    two at D 128 fp32); its layout is recomputed here from the kernel's
    description, and the strides keep the warps' 16- and 8-byte shared
    loads free of bank conflicts.
  * The kernel's index maps (block y -> q tile, longest first; thread
    (ty, tx) -> rows ty + 16 r and keys tx + 8 i of each 32-key tile) cover
    every (q row, key) pair exactly once, and causal calls skip only tiles
    that lie wholly above the diagonal. Stand-in maps that drop or repeat a
    piece fail the same test.
  * A numpy emulation of the kernel's arithmetic in that plan (32-key
    tiles, unscaled fp32 scores, masks of -1e30 and -inf, p = 2^(s c - m c)
    with c = scale log2(e), p rounded to v's dtype for P.V while each lane
    sums its own share of l, the lanes' shares added in the shuffles'
    order, acc * (1 / max(l, 1e-30))) agrees with
    ``repro.kernels.flash_attention`` (JAX, interpret mode) within 2e-5 in
    fp32 and 3e-2 in bf16, at every attention width of the repository's
    configurations.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
WIDTHS = [(d, dv) for d in range(16, fa.MAX_D + 1, 16) for dv in fa.SIMT_DV]
CONFIG_WIDTHS = [(16, 16), (32, 32), (64, 64), (80, 80), (128, 128),
                 (256, 256), (192, 128)]
LOG2E = np.float32(1.4426950408889634)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plan_fits_every_width(dtype):
    es = 4 if dtype == "float32" else 2
    for d, dv in WIDTHS:
        p = fa.simt_plan(d, dv, DTYPES[dtype])
        assert p.threads == 128 and p.keys == 32
        assert p.rows_per_thread == (4 if dv <= 128 else 2)
        assert p.rows == 16 * p.rows_per_thread
        lay = fa.simt_layout(d, dv, p.rows, es)
        assert p.smem == lay["bytes"] <= fa.SMEM_BLOCK_MAX
        # the blocks it promises fit the SM's shared memory and threads
        assert p.blocks_per_sm >= 1
        assert p.blocks_per_sm * (p.smem + fa.SMEM_RESERVED) <= fa.SMEM_SM
        assert p.blocks_per_sm * p.threads <= 2048
        assert all(lay[a] % 16 == 0 for a in ("k", "v", "p"))
    assert fa.simt_plan(128, 128, torch.float32).blocks_per_sm >= 2
    assert fa.simt_plan(256, 256, torch.float32).blocks_per_sm >= 1


def _banks(stride_bytes, rows, width):
    """The 4-byte banks a warp touches when 8 lanes read ``width`` bytes at
    the same column of 8 consecutive rows."""
    return [((r * stride_bytes + w) // 4) % 32 for r in range(rows)
            for w in range(0, width, 4)]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_shared_loads_are_conflict_free(dtype):
    """The score loop's 16-byte Q loads (4 consecutive rows a warp) and K
    loads (8 consecutive keys; 8 bytes in bf16) touch distinct banks."""
    es = 4 if dtype == "float32" else 2
    for d in range(16, fa.MAX_D + 1, 16):
        q_stride = (d + 4) * 4
        k_stride = d * es + 16
        qb = _banks(q_stride, 4, 16)
        kb = _banks(k_stride, 8, 4 * es)
        assert len(set(qb)) == len(qb), (d, "q")
        assert len(set(kb)) == len(kb), (d, "k")


def _cover(sq, sk, rows, causal, k_end_of=None, row_of=None):
    """How often the kernel scores each (q row, key) pair, from its index
    maps; also the skipped tiles' (q0, k0). ``k_end_of`` and ``row_of``
    replace the kernel's maps (stand-ins)."""
    tr = rows // 16
    n_qt = -(-sq // rows)
    count = np.zeros((sq, sk), np.int64)
    skipped = []
    ty, r = np.meshgrid(np.arange(16), np.arange(tr), indexing="ij")
    tx, i = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    for by in range(n_qt):
        q0 = (n_qt - 1 - by) * rows
        k_end = min(sk, q0 + rows) if causal else sk
        if k_end_of is not None:
            k_end = k_end_of(q0, rows, sk)
        qrow = (q0 + (row_of(ty, r) if row_of else ty + 16 * r)).ravel()
        for k0 in range(0, -(-sk // 32) * 32, 32):
            if k0 >= k_end:
                skipped.append((q0, k0))
                continue
            keys = (k0 + tx + 8 * i).ravel()
            qq, kk = np.meshgrid(qrow[qrow < sq], keys[keys < sk],
                                 indexing="ij")
            np.add.at(count, (qq.ravel(), kk.ravel()), 1)
    return count, skipped


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("sq,sk", [(200, 200), (256, 256), (96, 160),
                                   (33, 33)])
def test_tiles_cover_each_pair_once(rows, sq, sk):
    count, skipped = _cover(sq, sk, rows, causal=False)
    assert (count == 1).all() and not skipped
    if sq != sk:
        return
    count, skipped = _cover(sq, sk, rows, causal=True)
    lower = np.tril(np.ones((sq, sk), bool))
    assert (count[lower] == 1).all()            # every key <= row, once
    assert count.max() == 1
    for q0, k0 in skipped:                       # wholly above the diagonal
        assert k0 > min(q0 + rows, sq) - 1


@pytest.mark.parametrize("stand_in", ["k_end_q0", "k_end_minus_tile",
                                      "rows_15_apart", "rows_repeat"])
def test_cover_stand_ins_fail(stand_in):
    """A causal walk that stops at the block's first row (or one tile
    early), and row maps that leave or repeat rows, fail the cover."""
    kw = {"k_end_q0": dict(k_end_of=lambda q0, rows, sk: min(sk, q0 + 1)),
          "k_end_minus_tile": dict(
              k_end_of=lambda q0, rows, sk: min(sk, q0 + rows) - 32),
          "rows_15_apart": dict(row_of=lambda ty, r: ty + 15 * r),
          "rows_repeat": dict(row_of=lambda ty, r: ty + 8 * r)}[stand_in]
    count, _ = _cover(256, 256, 64, causal=True, **kw)
    lower = np.tril(np.ones((256, 256), bool))
    assert not ((count[lower] == 1).all() and count.max() == 1)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16() \
        .float().numpy()


def emulate(q, k, v, causal, dtype):
    """The SIMT kernel's arithmetic on (B, S, H, D) float32 arrays holding
    q/k/v's values; returns float32 (B, Sq, Hq, Dv) before the final
    rounding to q's dtype."""
    b_, sq, hq, d = q.shape
    _, sk, hkv, dv = v.shape
    g = hq // hkv
    plan = fa.simt_plan(d, dv, DTYPES[dtype])
    rows = plan.rows
    c = np.float32(1.0 / math.sqrt(d)) * LOG2E
    n_qt = -(-sq // rows)
    out = np.zeros((b_, sq, hq, dv), np.float32)
    with np.errstate(over="ignore", invalid="ignore"):
        for b in range(b_):
            for h in range(hq):
                hk = h // g
                for by in range(n_qt):
                    q0 = (n_qt - 1 - by) * rows
                    ridx = q0 + np.arange(rows)
                    qt = np.zeros((rows, d), np.float32)
                    qt[ridx < sq] = q[b, ridx[ridx < sq], h]
                    k_end = min(sk, q0 + rows) if causal else sk
                    m = np.full(rows, -1e30, np.float32)
                    l = np.zeros((rows, 8), np.float32)
                    acc = np.zeros((rows, dv), np.float32)
                    for k0 in range(0, k_end, 32):
                        keys = k0 + np.arange(32)
                        ok = keys < sk
                        kt = np.zeros((32, d), np.float32)
                        vt = np.zeros((32, dv), np.float32)
                        kt[ok] = k[b, keys[ok], hk]
                        vt[ok] = v[b, keys[ok], hk]
                        s = qt @ kt.T
                        if causal:
                            s[keys[None, :] > ridx[:, None]] = -1e30
                        s[:, ~ok] = -np.inf
                        m_new = np.maximum(m, s.max(1))
                        alpha = np.exp2((m - m_new) * c).astype(np.float32)
                        mc = (m_new * c).astype(np.float32)
                        p = np.exp2(s * c - mc[:, None]).astype(np.float32)
                        part = p[:, 0:8].copy()  # lane tx: keys tx + 8 i
                        for i in range(1, 4):
                            part += p[:, 8 * i:8 * i + 8]
                        l = l * alpha[:, None] + part
                        pr = _bf16(p) if dtype == "bfloat16" else p
                        acc = acc * alpha[:, None] + pr @ vt
                        m = m_new
                    # the lanes' shares in the shuffles' order (xor 1, 2, 4)
                    for o in (1, 2, 4):
                        l = l + l[:, np.arange(8) ^ o]
                    inv = (1.0 / np.maximum(l[:, 0], 1e-30)).astype(
                        np.float32)
                    keep = ridx < sq
                    out[b, ridx[keep], h] = (acc * inv[:, None])[keep]
    return out


@pytest.mark.parametrize("d,dv", CONFIG_WIDTHS,
                         ids=[f"d{d}-dv{dv}" for d, dv in CONFIG_WIDTHS])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_emulation_matches_jax_kernel(d, dv, dtype):
    """Non-causal with 2 q heads on 1 kv head and causal GQA, S 96 (three
    32-key tiles; a ragged q tile at 64 rows), against the Pallas kernel in
    interpret mode."""
    rng = np.random.default_rng(d + dv)
    sq = sk = 96
    arrays = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
              for shape in ((1, sq, 2, d), (1, sk, 1, d), (1, sk, 1, dv))]
    if dtype == "bfloat16":
        arrays = [_bf16(a) for a in arrays]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tol = 2e-5 if dtype == "float32" else 3e-2
    for causal in (False, True):
        if causal:
            want = jflash.flash_attention_causal_gqa(
                *jx, block_q=32, block_k=32, interpret=True)
        else:
            want = jflash.flash_attention(*jx, causal=False, block_q=32,
                                          block_k=32, interpret=True)
        got = emulate(*arrays, causal, dtype)
        if dtype == "bfloat16":
            got = _bf16(got)
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=0)


def test_emulation_stand_in_fails():
    """The emulation with the last kv tile dropped misses the JAX kernel
    by far more than 2e-5, so the comparison can see a lost tile."""
    rng = np.random.default_rng(0)
    arrays = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
              for shape in ((1, 96, 2, 64), (1, 96, 1, 64), (1, 96, 1, 64))]
    want = np.asarray(jflash.flash_attention(
        *[jnp.asarray(a) for a in arrays], causal=False, block_q=32,
        block_k=32, interpret=True))
    q, k, v = arrays
    got = emulate(q, k[:, :64], v[:, :64], False, "float32")
    assert np.abs(got - want).max() > 1e-2
