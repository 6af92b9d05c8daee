"""Port parity: the flash-attention wrappers of repro_torch.kernels and the
port's models.layers.attention against repro.kernels.flash_attention (in
interpret mode) and repro.models.layers.attention, on the CPU, where each
wrapper runs its plain version.

The cases are tests/test_kernels_extra.py's (the three shapes of
test_flash_attention_sweep and its bf16 case) with its tolerances (atol
2e-5 at fp32, 3e-2 at bf16), the head widths of the repository's other LM
configurations (hubert-xlarge's 80, recurrentgemma-2b's 256, deepseek-v3's
MLA D 192 with Dv 128: non-causal, causal and causal GQA, fp32 and bf16),
plus the chunked, windowed and kv_len paths of attention. Inputs come from
numpy seeds and reach both packages as the same values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config, list_configs
from repro.kernels import flash_attention as jflash
from repro.models import layers as JL
from repro_torch import kernels
from repro_torch.configs.lm import get_lm_config
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ref
from repro_torch.models import layers as TL

TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# (sq, sk, hq, hkv, d, dv, dtype); the first three keep their old ids
SWEEP = [pytest.param(256, 256, 4, 4, 32, 32, "float32", id="256-256-4-4-32"),
         pytest.param(512, 512, 8, 2, 16, 16, "float32", id="512-512-8-2-16"),
         pytest.param(256, 512, 2, 2, 64, 64, "float32", id="256-512-2-2-64")]
# the other configurations' widths: Hq == Hkv (the causal call is plain
# causal) and Hq == 2 Hkv (causal GQA), in both dtypes
SWEEP += [pytest.param(128, 128, hq, 2, d, dv, dt,
                       id=f"d{d}-dv{dv}-hq{hq}-{dt}")
          for d, dv in ((80, 80), (256, 256), (192, 128))
          for hq in (2, 4) for dt in ("float32", "bfloat16")]


def _qkv(b, sq, sk, hq, hkv, d, seed, dtype="float32", dv=None):
    """The same q, k, v as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    dv = d if dv is None else dv
    arrays = [(rng.standard_normal(shape) * 0.5).astype(np.float32)
              for shape in ((b, sq, hq, d), (b, sk, hkv, d),
                            (b, sk, hkv, dv))]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrays]
    tx = [torch.from_numpy(a) for a in arrays]
    if dtype == "bfloat16":
        tx = [t.bfloat16() for t in tx]
    return jx, tx


def _close(port, want, dtype):
    assert port.dtype == (torch.bfloat16 if dtype == "bfloat16"
                          else torch.float32)
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.fixture(autouse=True)
def no_launches():
    before = kernels.launch_counts()
    yield
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("sq,sk,hq,hkv,d,dv,dtype", SWEEP)
def test_flash_attention_matches_pallas(sq, sk, hq, hkv, d, dv, dtype):
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, sq, sk, hq, hkv, d, seed=sq + d,
                                      dtype=dtype, dv=dv)
    blocks = dict(block_q=min(128, sq // 2), block_k=min(128, sk // 2))
    want = jflash.flash_attention(jq, jk, jv, causal=False, interpret=True,
                                  **blocks)
    got = tflash.flash_attention(tq, tk, tv, causal=False, **blocks)
    _close(got, want, dtype)
    if sq == sk:
        want = jflash.flash_attention_causal_gqa(jq, jk, jv, interpret=True,
                                                 **blocks)
        got = tflash.flash_attention_causal_gqa(tq, tk, tv, **blocks)
        _close(got, want, dtype)


def test_flash_attention_bf16():
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 256, 256, 2, 2, 32, seed=5,
                                      dtype="bfloat16")
    want = jflash.flash_attention(jq, jk, jv, causal=True, block_q=128,
                                  block_k=128, interpret=True)
    got = tflash.flash_attention(tq, tk, tv, causal=True, block_q=128,
                                 block_k=128)
    _close(got, want, "bfloat16")


def test_flash_attention_rejects_what_jax_rejects():
    """Causal attention with grouped q heads through flash_attention, and
    blocks that do not divide the sequence, fail in both packages."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 256, 256, 4, 2, 16, seed=6)
    with pytest.raises(AssertionError):
        jflash.flash_attention(jq, jk, jv, causal=True, block_q=128,
                               block_k=128, interpret=True)
    with pytest.raises(ValueError, match="causal_gqa"):
        tflash.flash_attention(tq, tk, tv, causal=True)
    with pytest.raises(AssertionError):
        jflash.flash_attention(jq, jk, jv, causal=False, block_q=128,
                               block_k=96, interpret=True)
    with pytest.raises(ValueError, match="do not divide"):
        tflash.flash_attention(tq, tk, tv, causal=False, block_q=128,
                               block_k=96)


# (causal, window, q_offset, kv_len, chunk, sq, sk): the direct path, the
# chunked path (Sk > 2 * chunk), a sliding window, decode offsets and
# per-row valid prefixes on both paths
ATTN_CASES = {
    "direct_causal": (True, None, 0, None, 1024, 64, 64),
    "chunked_causal": (True, None, 0, None, 32, 128, 128),
    "chunked_noncausal": (False, None, 0, None, 32, 96, 128),
    "window": (True, 24, 0, None, 1024, 64, 64),
    "window_chunked": (True, 24, 0, None, 16, 64, 64),
    "kv_len_decode": (True, None, 40, (17, 48), 1024, 1, 48),
    "kv_len_chunked": (True, None, 32, (50, 96), 16, 64, 96),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_matches_jax(case, dtype):
    causal, window, q_offset, kv_len, chunk, sq, sk = ATTN_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _qkv(2, sq, sk, 4, 2, 16, seed=len(case),
                                      dtype=dtype)
    jlen = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tlen = None if kv_len is None else torch.tensor(kv_len)
    want = JL.attention(jq, jk, jv, causal=causal, window=window,
                        q_offset=q_offset, kv_len=jlen, chunk=chunk)
    got = TL.attention(tq, tk, tv, causal=causal, window=window,
                       q_offset=q_offset, kv_len=tlen, chunk=chunk)
    _close(got, want, dtype)
    assert ref.attention is TL.attention


def _attention_widths():
    """(name, D, Dv) of every LM configuration of the JAX package that
    calls attention (xlstm-1.3b's ssm family has none): MLA's q/k carry
    the nope and rope parts, its v the value width."""
    out = []
    for name, cfg in sorted(list_configs().items()):
        if cfg.family == "ssm":
            continue
        if cfg.use_mla:
            out.append((name, cfg.qk_nope_head_dim + cfg.qk_rope_head_dim,
                        cfg.v_head_dim))
        else:
            out.append((name, cfg.hd, cfg.hd))
    return out


def test_width_check_takes_every_configuration():
    """The kernels take the attention widths of every LM configuration
    (the SIMT plan fits, in both dtypes), and still name and reject the
    widths they are not built for."""
    widths = _attention_widths()
    assert {(d, dv) for _, d, dv in widths} >= {(80, 80), (256, 256),
                                                (192, 128), (128, 128),
                                                (64, 64)}
    for name, d, dv in widths:
        tflash.check_widths(d, dv)
        for dt in (torch.float32, torch.bfloat16):
            plan = tflash.simt_plan(d, dv, dt)
            assert plan.smem <= tflash.SMEM_BLOCK_MAX and \
                plan.blocks_per_sm >= 1, (name, dt, plan)
    for d, dv in ((288, 288), (256, 96), (200, 128), (8, 8)):
        with pytest.raises(ValueError, match=f"D {d}, Dv {dv}"):
            tflash.check_widths(d, dv)


def test_qwen_widths_match_reference_config():
    mine, theirs = get_lm_config("qwen2.5-32b"), get_config("qwen2.5-32b")
    assert (mine.d_model, mine.num_heads, mine.num_kv_heads, mine.head_dim,
            mine.dtype) == (theirs.d_model, theirs.num_heads,
                            theirs.num_kv_heads, theirs.hd, theirs.dtype)
