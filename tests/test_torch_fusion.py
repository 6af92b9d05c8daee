"""Port parity: repro_torch.core.fusion.infer against repro.core.fusion.infer
(Pallas kernels in interpret mode) on all three paths, on the CPU.

A 12x4 mesh with a 3-step history keeps interpret mode fast. Weights are
the JAX package's, carried over with params_from_jax; inputs are numpy
arrays from fixed seeds. Tolerances sit beside each assert.
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
from repro.core import fusion as jfusion
from repro_torch import kernels
from repro_torch.common import params_from_jax
from repro_torch.core import cronet as tcronet
from repro_torch.core import fusion as tfusion

PATHS = {"l2l3": (True, True, True), "l1": (True, False, False),
         "none": (False, False, False)}


def _setup(dtype, seed=0):
    cfg = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                              hist_len=3, dtype=dtype)
    params = jax.device_get(materialize(jcronet.param_specs(cfg),
                                        jax.random.key(seed)))
    rng = np.random.default_rng(seed)
    lv = (rng.standard_normal((4, cfg.nely + 1, cfg.nelx + 1, 1))
          * 0.3).astype(np.float32)
    hist = rng.random((cfg.hist_len, cfg.nely, cfg.nelx, 1),
                      dtype=np.float32)
    return cfg, params, lv, hist


def _both(cfg, params, lv, hist, path, dtype):
    """(port output, JAX output) of one path on the same inputs in dtype."""
    fc = tfusion.FusionConfig(*PATHS[path])
    assert fc.path == path
    jdt = getattr(jnp, dtype)
    ref = jfusion.infer(cfg, params, jnp.asarray(lv, jdt),
                        jnp.asarray(hist, jdt),
                        jfusion.FusionConfig(*PATHS[path]), interpret=True)
    tdt = getattr(torch, dtype)
    before = kernels.launch_counts()
    out = tfusion.infer(cfg, params_from_jax(params, device="cpu"),
                        torch.from_numpy(lv).to(tdt),
                        torch.from_numpy(hist).to(tdt), fc)
    assert kernels.launch_counts() == before     # plain versions on CPU
    return out, ref


@pytest.mark.parametrize("path", list(PATHS))
def test_fusion_path_matches_jax_fp32(path):
    """fp32: the port's path vs the JAX path and vs the port's plain
    forward, rtol = atol = 1e-4 (the bar of tests/test_cronet.py:48)."""
    cfg, params, lv, hist = _setup("float32")
    out, ref = _both(cfg, params, lv, hist, path, "float32")
    assert out.shape == (cfg.p,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)
    plain = tcronet.forward(cfg, params_from_jax(params, device="cpu"),
                            torch.from_numpy(lv)[None],
                            torch.from_numpy(hist)[None])[0]
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("path", list(PATHS))
def test_fusion_path_matches_jax_bf16(path):
    """bf16 weights and inputs: the frameworks round at different places,
    so the bar is rtol = atol = 0.1 (the bar of test_megakernel_bf16)."""
    cfg, params, lv, hist = _setup("bfloat16", seed=1)
    out, ref = _both(cfg, params, lv, hist, path, "bfloat16")
    assert out.shape == (cfg.p,) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=0.1,
                               atol=0.1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l2l3_returns_cfg_dtype_in_both_packages(dtype):
    """l2l3 casts fp32 inputs to cfg.dtype and returns cfg.dtype, in the
    reference and in the port."""
    cfg, params, lv, hist = _setup(dtype, seed=2)
    ref = jfusion.infer(cfg, params, jnp.asarray(lv), jnp.asarray(hist),
                        interpret=True)
    out = tfusion.infer(cfg, params_from_jax(params, device="cpu"),
                        torch.from_numpy(lv),
                        torch.from_numpy(hist))
    assert str(ref.dtype) == dtype
    assert out.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32),
                               rtol=0.1 if dtype == "bfloat16" else 1e-4,
                               atol=0.1 if dtype == "bfloat16" else 1e-4)


def test_infer_rejects_weights_off_cfg_dtype_and_bad_shapes():
    cfg, params, lv, hist = _setup("bfloat16")
    tp = {part: {k: v.float() for k, v in leaves.items()}
          for part, leaves in params_from_jax(params, device="cpu").items()}
    with pytest.raises(TypeError, match="cfg.dtype"):
        tfusion.infer(cfg, tp, torch.from_numpy(lv), torch.from_numpy(hist))
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with pytest.raises(ValueError, match="do not match"):
        tfusion.infer(cfg32, tp, torch.from_numpy(lv)[None],
                      torch.from_numpy(hist))
