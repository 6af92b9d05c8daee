"""Port parity: CRONet forward, decoder and parameter casts
(repro_torch.core.cronet, repro_torch.kernels.cronet_pipeline) against the
JAX package on the same inputs, on the CPU.

Inputs are made with numpy from fixed seeds and the JAX weights are carried
over with ``params_from_jax``. Tolerances sit beside each assert.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import materialize
from repro.configs.cronet import get_cronet_config
from repro.core import cronet as jcronet
from repro.fea import hybrid as jhybrid
from repro.kernels.cronet_pipeline import cronet_fused as jcronet_fused
from repro_torch.common import init_params, param_shapes, params_from_jax
from repro_torch.configs.cronet import get_cronet_config as tget_config
from repro_torch.core import cronet as tcronet
from repro_torch.fea import hybrid as thybrid
from repro_torch.kernels.cronet_pipeline import cronet_fused


def _setup(cfg, B=2, seed=0):
    params = jax.device_get(materialize(jcronet.param_specs(cfg),
                                        jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    lv = (rng.standard_normal((B, 4, cfg.nely + 1, cfg.nelx + 1, 1))
          * 0.3).astype(np.float32)
    hist = rng.random((B, cfg.hist_len, cfg.nely, cfg.nelx, 1),
                      dtype=np.float32)
    return params, lv, hist


def test_config_copy_matches_reference():
    for size in ("small", "medium", "large"):
        a, b = get_cronet_config(size), tget_config(size)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.param_count() == b.param_count()
        shapes = param_shapes(b)
        specs = jcronet.param_specs(a)
        for part in specs:
            for k, spec in specs[part].items():
                assert tuple(spec.shape) == shapes[part][k]


def test_forward_matches_jax_oracle():
    """fp32 forward at the `small` size: port vs the JAX oracle,
    rtol = atol = 1e-4 (the bar of test_kernels_extra.py:38)."""
    cfg = dataclasses.replace(get_cronet_config("small"), dtype="float32")
    params, lv, hist = _setup(cfg, B=2)
    ref = np.asarray(jax.jit(lambda p, a, b: jcronet.forward(cfg, p, a, b))(
        params, jnp.asarray(lv), jnp.asarray(hist)))
    tp = params_from_jax(params, device="cpu")
    out = tcronet.forward(cfg, tp, torch.from_numpy(lv),
                          torch.from_numpy(hist)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    # the wrapper runs its plain version on CPU tensors, as float32
    w = cronet_fused(cfg, tp, torch.from_numpy(lv), torch.from_numpy(hist))
    assert w.dtype == torch.float32
    np.testing.assert_array_equal(w.numpy(), out)
    assert cronet_fused.launches == 0          # no kernel launched on CPU
    # the nn.Module form computes the same
    net = tcronet.CRONet(cfg, tp)
    np.testing.assert_array_equal(
        net(torch.from_numpy(lv), torch.from_numpy(hist)).numpy(), out)


def test_forward_matches_jax_megakernel():
    """The port's kernel wrapper (plain version on CPU tensors) vs the
    Pallas megakernel in interpret mode, on a 12x4 mesh with a 3-step
    history (interpret mode is slow at full width), rtol = atol = 1e-4."""
    cfg = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                              hist_len=3, dtype="float32")
    params, lv, hist = _setup(cfg, B=2, seed=2)
    mk = np.asarray(jcronet_fused(cfg, params, jnp.asarray(lv),
                                  jnp.asarray(hist), interpret=True))
    tp = params_from_jax(params, device="cpu")
    w = cronet_fused(cfg, tp, torch.from_numpy(lv), torch.from_numpy(hist))
    assert w.dtype == torch.float32 and w.shape == (2, cfg.p)
    np.testing.assert_allclose(w.numpy(), mk, rtol=1e-4, atol=1e-4)
    # on CPU tensors the wrapper runs its plain version: no launch counted
    assert cronet_fused.launches == 0
    np.testing.assert_array_equal(
        w.numpy(), tcronet.forward(cfg, tp, torch.from_numpy(lv),
                                   torch.from_numpy(hist)).numpy())
    # the nn.Module form computes the same
    net = tcronet.CRONet(cfg, tp)
    np.testing.assert_array_equal(
        net(torch.from_numpy(lv), torch.from_numpy(hist)).numpy(), w.numpy())


def test_forward_bf16_matches_jax_oracle():
    """bf16 weights and inputs: both frameworks round at different places
    (XLA CPU vs oneDNN bf16 kernels), so the bar is 5% of the output's
    largest magnitude."""
    cfg = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                              hist_len=3, dtype="bfloat16")
    params, lv, hist = _setup(cfg, B=2, seed=1)
    ref = np.asarray(jcronet.forward(
        cfg, params, jnp.asarray(lv, jnp.bfloat16),
        jnp.asarray(hist, jnp.bfloat16)).astype(jnp.float32))
    tp = params_from_jax(params, device="cpu")
    assert tp["trunk"]["fc1"].dtype == torch.bfloat16
    out = tcronet.forward(cfg, tp, torch.from_numpy(lv).bfloat16(),
                          torch.from_numpy(hist).bfloat16()).float().numpy()
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 0.05 * scale


@pytest.mark.parametrize("nodes", [(11, 31), (21, 31), (21, 61), (5, 13)])
def test_decoder_matches_jax_resize(nodes):
    """decode_to_dofs: the antialiased bilinear resize matches
    jax.image.resize within 1e-5 at the small/medium/large/test meshes."""
    ny, nx = nodes
    cfg = dataclasses.replace(get_cronet_config("small"), nely=ny - 1,
                              nelx=nx - 1)
    u = np.random.default_rng(7).standard_normal((3, cfg.p)).astype(
        np.float32)
    ref = np.asarray(jcronet.decode_to_dofs(cfg, jnp.asarray(u)))
    out = tcronet.decode_to_dofs(cfg, torch.from_numpy(u)).numpy()
    assert out.shape == ref.shape == (3, 2 * ny * nx)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("precision", ["fp32", "bf16", "int8"])
def test_cast_params_matches_jax(precision):
    """cast_params: fp32/bf16 casts are exact; int8 fake-quant within one
    float32 ulp of the weight scale (1e-6 relative to max |w|)."""
    cfg = dataclasses.replace(get_cronet_config("small"), dtype="float32")
    params = jax.device_get(materialize(jcronet.param_specs(cfg),
                                        jax.random.key(3)))
    ref = jax.device_get(jhybrid.cast_params(params, precision))
    out = thybrid.cast_params(params_from_jax(params, device="cpu"), precision)
    for part in ref:
        for k, r in ref[part].items():
            o = out[part][k].float().numpy()
            r = np.asarray(r, np.float32)
            np.testing.assert_allclose(o, r, rtol=0,
                                       atol=1e-6 * np.abs(r).max())


def test_init_params_rule_and_device_rule():
    """init_params: the reference's rule (std 1/sqrt(shape[0]), cfg.dtype),
    seeded and reproducible; device="cuda" without a GPU raises."""
    cfg = get_cronet_config("medium")
    a = init_params(cfg, seed=0, device="cpu")
    b = init_params(cfg, seed=0, device="cpu")
    c = init_params(cfg, seed=1, device="cpu")
    fc1 = a["trunk"]["fc1"].float()
    assert a["trunk"]["fc1"].dtype == torch.bfloat16
    assert torch.equal(a["trunk"]["fc1"], b["trunk"]["fc1"])
    assert not torch.equal(a["trunk"]["fc1"], c["trunk"]["fc1"])
    # 4800 x 40 draws: sample std within 2% of 1/sqrt(4800)
    assert abs(float(fc1.std()) * np.sqrt(4800) - 1.0) < 0.02
    n = sum(v.numel() for part in a.values() for v in part.values())
    assert n == cfg.param_count() == 419760
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_params(cfg, seed=0)
