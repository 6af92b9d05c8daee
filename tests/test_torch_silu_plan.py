"""The SiLU kernels' launch plan (repro_torch.kernels.silu.silu_plan), on
the CPU: it covers every element exactly once (a scalar head up to the
first 16-byte boundary, 16-byte vectors, a scalar tail, none of them
overlapping), the vectors sit on 16-byte boundaries, the grid is one wave
while n fits it, and an emulation of the kernel's index walk
(csrc/silu.cu: thread t of block b takes vectors b * threads * vpt + t +
j * threads, j < vpt, in one pass; block 0's first head + tail threads
take the scalars) reproduces silu_lut_plain and silu_exact_plain bitwise.
Stand-in plans and walks that drop the tail or repeat a vector are shown
to fail the cover test.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import silu

N_VALUES = [1, 3, 4095, 1 << 14, (1 << 14) + 3, 768000, 1 << 26]
OFFSETS = {torch.float32: [0, 4, 8, 12], torch.bfloat16: list(range(0, 16, 2))}
SM_COUNTS = [132, 8]
CASES = [(n, dt, off, sms) for n in N_VALUES for dt in OFFSETS
         for off in OFFSETS[dt] for sms in SM_COUNTS]


def _ids(case):
    n, dt, off, sms = case
    return f"n{n}-{str(dt).split('.')[-1]}-off{off}-sm{sms}"


def walk(plan, n, block_vpt=True):
    """Every element index the kernel writes, once per write: block 0's
    scalars, then each thread's vectors below nvec. ``block_vpt=False`` is
    a stand-in walk whose block offset leaves out the vectors a thread."""
    tid = np.arange(plan.head + plan.tail)
    edge = np.where(tid < plan.head, tid,
                    plan.head + plan.nvec * plan.vec + tid - plan.head)
    b = np.arange(plan.blocks)[:, None, None]
    j = np.arange(plan.vpt)[None, :, None]
    t = np.arange(plan.threads)[None, None, :]
    per_block = plan.threads * (plan.vpt if block_vpt else 1)
    vecs = (b * per_block + j * plan.threads + t).ravel()
    vecs = vecs[vecs < plan.nvec]
    elems = (plan.head + vecs[:, None] * plan.vec
             + np.arange(plan.vec)[None, :]).ravel()
    return np.concatenate([edge, elems])


def covered_once(plan, n, block_vpt=True) -> bool:
    idx = walk(plan, n, block_vpt)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        return False
    return bool((np.bincount(idx, minlength=n) == 1).all())


def check_arithmetic(plan, n, dtype, off, sms):
    """What the kernel's launch check and the one-wave rule require."""
    esize = 4 if dtype == torch.float32 else 2
    assert plan.vec * esize == 16
    assert 0 <= plan.head < plan.vec and 0 <= plan.tail < plan.vec
    assert plan.head + plan.nvec * plan.vec + plan.tail == n
    if plan.nvec:
        assert (off + plan.head * esize) % 16 == 0     # aligned vectors
    assert plan.head + plan.tail <= plan.threads       # block 0 holds them
    assert plan.threads % 32 == 0 and plan.threads <= 256
    assert plan.vpt in silu.VPTS
    per_block = plan.threads * plan.vpt
    assert plan.blocks >= 1
    assert (plan.blocks - 1) * per_block < max(plan.nvec, 1)   # none idle
    assert plan.blocks * per_block >= plan.nvec                # one pass
    assert plan.threads * plan.vec == silu.BLOCK_ELEMS
    wave = sms * silu.SM_THREADS // plan.threads           # blocks of a wave
    if plan.nvec <= wave * plan.threads * silu.VPTS[-1]:
        assert plan.blocks <= wave                             # one wave
        assert plan.vpt == min(v for v in silu.VPTS
                               if plan.nvec <= wave * plan.threads * v)
    else:
        assert plan.vpt == 1


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plan_covers_every_element_once(case):
    n, dt, off, sms = case
    plan = silu.silu_plan(n, dt, sms, off)
    check_arithmetic(plan, n, dt, off, sms)
    if n > 1 << 20:     # plan arithmetic only (check_arithmetic's cover)
        return
    assert covered_once(plan, n)


def test_plan_is_one_wave_at_the_layer_breakdown_size():
    """2^14 at 132 SMs: one wave, one vector a thread, 16 blocks in fp32
    and bf16; 2^26: one vector a thread over as many blocks as they
    fill."""
    for dt in (torch.float32, torch.bfloat16):
        plan = silu.silu_plan(1 << 14, dt, 132, 0)
        assert plan.blocks * plan.threads <= 132 * silu.SM_THREADS
        assert plan.vpt == 1 and plan.blocks == 16
    big = silu.silu_plan(1 << 26, torch.float32, 132, 0)
    assert big.vpt == 1 and big.blocks == (1 << 24) // 256


@pytest.mark.parametrize("n", [3, 4095, (1 << 14) + 3, 100003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sms", SM_COUNTS)
@pytest.mark.parametrize("name", ["silu_lut", "silu_exact"])
def test_walk_reproduces_plain_bitwise(n, dtype, sms, name):
    """Gather x in the walk's order, run the plain version on what each
    write reads, scatter: the plain version's bits, on a view one element
    into its buffer."""
    x = chip_smoke.silu_case(
        chip_smoke.silu_inputs(max(n, 4000), torch.Generator().manual_seed(
            n))[:n], 1, dtype, "cpu")
    plan = silu.silu_plan(n, dtype, sms, x.data_ptr() % 16)
    plain = getattr(silu, f"{name}_plain")
    idx = torch.from_numpy(walk(plan, n))
    out = torch.full_like(x, 12345.0)      # no input maps to it
    out[idx] = plain(x[idx])
    assert chip_smoke.same_bits(out, plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stand_in_plans_fail_the_cover(dtype):
    n = (1 << 14) + 3
    plan = silu.silu_plan(n, dtype, 132, 0)
    assert plan.tail > 0 and covered_once(plan, n)
    assert not covered_once(plan._replace(tail=0), n)          # drops it
    assert not covered_once(plan._replace(nvec=plan.nvec + 1), n)  # overlap
    n = 1_500_000       # 2 (bf16) or 4 (fp32) vectors a thread
    big = silu.silu_plan(n, dtype, 132, 0)
    assert big.vpt > 1 and covered_once(big, n)
    assert not covered_once(big, n, block_vpt=False)    # a vector twice
