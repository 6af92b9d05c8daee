"""The flash-attention wrapper's choice of kernel, and the tensor-core
kernel's arithmetic, on the CPU.

``kernel_for`` is a fixed rule on dtype and head widths, checked here as a
pure function. The tensor-core kernel (csrc/flash_attention.cu) cannot run
here, so ``_tc_emulated`` repeats its arithmetic in PyTorch: kv tiles of
64 or 128 keys, fp32 scores, ``p = 2^(s c - m c)`` with the scale and
log2(e) folded into one fp32 constant c, p rounded to bf16 per tile for the
PV product while l sums the fp32 p, and the output
``acc * (1 / max(l, 1e-30))`` rounded to bf16. It is held with the card's
bf16 test, ``chip_smoke.flash_excess`` <= 1 (|err| <= 2e-3 + 1e-2 |ref| at
every element), at qwen2.5-32b's group of 5 q heads per kv head, head
width 128 and S 1024, against ``repro.models.layers.attention`` (JAX, CPU)
on its online-softmax path in chunks of the kernel's tile (p rounded to
bf16 before it is normalised, as in the Pallas kernel), and against
float64 attention. The share of that limit it uses is what the card should
read.

Against the reference's direct path (its default at S 1024), which rounds
the normalised p to bf16, the non-causal call passes but causal rows with
few keys do not: there each p carries a large share of the row's weight,
the two roundings part by up to 1.6x the limit, and the direct path is
itself further from the float64 answer (1.15x the limit) than the
emulation is (0.83x).
"""
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch import kernels
from repro_torch.kernels import flash_attention as tflash

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the bf16 elementwise test)

NEG_INF = -1e30


@pytest.fixture(autouse=True)
def no_launches():
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("dtype,d,dv,kernel", [
    (torch.bfloat16, 128, 128, "tc"), (torch.bfloat16, 64, 64, "tc"),
    (torch.bfloat16, 32, 32, "simt"), (torch.bfloat16, 16, 16, "simt"),
    (torch.bfloat16, 128, 64, "simt"), (torch.bfloat16, 96, 96, "simt"),
    (torch.float32, 128, 128, "simt"), (torch.float32, 64, 64, "simt"),
    (torch.float16, 128, 128, "simt")])
def test_kernel_for_is_a_rule_on_dtype_and_widths(dtype, d, dv, kernel):
    assert tflash.kernel_for(dtype, d, dv) == kernel


def _tc_emulated(q, k, v, *, causal: bool, block_k: int):
    """The tensor-core kernel's arithmetic on (B, S, H, D) bf16 tensors,
    q head h on kv head h // g; returns bf16 (B, Sq, Hq, D)."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    c = (torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
         * torch.tensor(1.4426950408889634, dtype=torch.float32))
    qf = q.float().permute(0, 2, 1, 3)                       # (B, Hq, Sq, D)
    kf = k.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    vf = v.float().permute(0, 2, 1, 3).repeat_interleave(g, dim=1)
    m = torch.full((b, hq, sq, 1), NEG_INF)
    l = torch.zeros((b, hq, sq, 1))
    acc = torch.zeros((b, hq, sq, v.shape[-1]))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, sk, block_k):
        kpos = k0 + torch.arange(block_k)[None, :]
        kt = torch.nn.functional.pad(kf[:, :, k0:k0 + block_k],
                                     (0, 0, 0, max(0, k0 + block_k - sk)))
        vt = torch.nn.functional.pad(vf[:, :, k0:k0 + block_k],
                                     (0, 0, 0, max(0, k0 + block_k - sk)))
        s = qf @ kt.transpose(-1, -2)
        if causal:
            s = torch.where(kpos <= qpos, s, NEG_INF)
        s = torch.where(kpos < sk, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp2((m - m_new) * c)
        p = torch.exp2(s * c - m_new * c)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vt
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))
    return out.permute(0, 2, 1, 3).bfloat16()


def _qkv(sq, sk, hq, hkv, d, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((1, sq, hq, d), (1, sk, hkv, d), (1, sk, hkv, d))]
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    tx = [torch.from_numpy(a).bfloat16() for a in arrays]
    return jx, tx


def _jax_bf16(out):
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


@pytest.mark.parametrize("causal", [False, True], ids=["noncausal", "causal"])
@pytest.mark.parametrize("block_k", [64, 128])
def test_tc_arithmetic_matches_jax_attention(causal, block_k):
    """qwen's g = 5 (10 q heads on 2), D 128, S 1024, bf16: the emulated
    kernel within the card's elementwise bf16 test of the JAX attention in
    chunks of block_k keys and of float64 attention; a reference with the
    last 64 keys dropped fails the same test. Non-causal, it also passes
    against the JAX direct path."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1024, 1024, 10, 2, 128, seed=14)
    want = _jax_bf16(JL.attention(jq, jk, jv, causal=causal, chunk=block_k))
    got = _tc_emulated(tq, tk, tv, causal=causal, block_k=block_k)
    exact = _float64_attention(tq, tk, tv, causal=causal)
    excess = chip_smoke.flash_excess(got, want)
    print(f"tc emulation, block_k {block_k}, causal {causal}: {excess:.3f} "
          f"of the bf16 limit, {chip_smoke.flash_excess(got, exact):.3f} "
          f"against float64")
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert excess <= 1.0
    assert chip_smoke.flash_excess(got, exact) <= 1.0
    if not causal:
        direct = _jax_bf16(JL.attention(jq, jk, jv, causal=False))
        assert chip_smoke.flash_excess(got, direct) <= 1.0
    dropped = _jax_bf16(JL.attention(jq, jk, jv, causal=causal,
                                     kv_len=jnp.asarray([1024 - 64]),
                                     chunk=block_k))
    assert chip_smoke.flash_excess(dropped, want) > 1.0


def _float64_attention(q, k, v, *, causal: bool):
    """Attention on the bf16 values in float64, nothing rounded."""
    g = q.shape[2] // k.shape[2]
    qf, kf, vf = (t.double() for t in (q, k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf.repeat_interleave(g, 2))
    s = s / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        s = s.masked_fill(torch.arange(sk)[None, :]
                          > torch.arange(sq)[:, None], -math.inf)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                        vf.repeat_interleave(g, 2))


@pytest.mark.parametrize("sq,sk,causal,chunk", [
    (200, 200, True, 40), (200, 200, False, 40), (256, 512, False, 128)],
    ids=["ragged_200_causal", "ragged_200", "256x512"])
def test_tc_arithmetic_ragged_and_sq_below_sk(sq, sk, causal, chunk):
    """Keys past Sk in the last tile (S 200) and Sq < Sk (256 on 512,
    non-causal) through the emulation, against the JAX attention in chunks
    (the reference's online-softmax path needs Sk a multiple of them)."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(sq, sk, 10, 2, 128, seed=sq + sk)
    want = _jax_bf16(JL.attention(jq, jk, jv, causal=causal, chunk=chunk))
    got = _tc_emulated(tq, tk, tv, causal=causal, block_k=128)
    assert chip_smoke.flash_excess(got, want) <= 1.0
