"""Fusion strategy (paper §IV-C) and the CRONet inference paths it selects:
the counterpart of ``repro.core.fusion``.

Paths, in increasing fusion level:
  none : layer by layer, one kernel per op, every intermediate in device
         memory, each SiLU its own pass (``F.silu``) — the conventional
         baseline the paper compares against;
  l1   : the same per-op kernels with SiLU fused into the convolutions and
         GEMMs;
  l2l3 : the whole network in one wrapper (``cronet_pipeline.cronet_fused``).

On CUDA tensors every op of ``none`` and ``l1`` is a hand-written kernel of
``kernels/`` (conv, gemm, pool); the RNN's ``tanh(xh + hh)`` and the final
product stay plain tensor ops, as they are plain ``jnp`` in the JAX package.
On CPU tensors the same wrappers run their plain versions.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.common import Params, torch_dtype
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.kernels import conv, gemm, pool
from repro_torch.kernels.cronet_pipeline import cronet_fused


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    l1: bool = True     # element-wise ops fused into compute kernels
    l2: bool = True     # layer->layer streaming (no device memory between)
    l3: bool = True     # oversized/reshaped intermediates kept on chip

    @property
    def path(self) -> str:
        if self.l2 and self.l3:
            return "l2l3"
        if self.l1:
            return "l1"
        return "none"


def infer(cfg: CRONetConfig, params: Params, load_vol: torch.Tensor,
          hist: torch.Tensor, fusion: FusionConfig = FusionConfig()
          ) -> torch.Tensor:
    """CRONet inference under a fusion config. load_vol (4, ny+1, nx+1, 1),
    hist (T, ny, nx, 1) -> (p,).

    The weights must be in ``cfg.dtype``. ``l2l3`` casts the inputs to
    ``cfg.dtype`` and returns ``cfg.dtype``, as the JAX megakernel does;
    ``none`` and ``l1`` keep the inputs' dtype through every op, each op
    rounding its output to it, as the JAX per-op kernels do.
    """
    dt = torch_dtype(cfg.dtype)
    bad = [f"{part}/{k}: {v.dtype}" for part, leaves in params.items()
           for k, v in leaves.items() if v.dtype != dt]
    if bad:
        raise TypeError(f"fusion.infer: weights must be in cfg.dtype "
                        f"({cfg.dtype}); got {', '.join(bad)}")
    H, W = cfg.nodes
    if (tuple(load_vol.shape) != (cfg.t_depth, H, W, 1)
            or tuple(hist.shape) != (cfg.hist_len, cfg.nely, cfg.nelx, 1)):
        raise ValueError(f"fusion.infer: shapes {tuple(load_vol.shape)}, "
                         f"{tuple(hist.shape)} do not match {cfg.name}")
    if fusion.path == "l2l3":
        out = cronet_fused(cfg, params, load_vol[None].to(dt),
                           hist[None].to(dt))
        return out[0].to(dt)
    return _layerwise(cfg, params, load_vol, hist, l1=fusion.l1)


def _layerwise(cfg: CRONetConfig, params: Params, load_vol, hist, l1: bool):
    """Per-op kernels (repro/core/fusion.py:58-108); with l1=False each
    SiLU is a separate pass over the tensor."""
    tr, br = params["trunk"], params["branch"]

    def separate(x):        # SiLU as its own pass unless fused
        return x if l1 else F.silu(x)

    silu = "silu" if l1 else None

    # Trunk
    t = separate(conv.conv3d(load_vol[None], tr["conv1"],
                             depth_padding="causal_same", fuse_silu=l1))
    t = separate(conv.conv3d(t, tr["conv2"], depth_padding="same",
                             fuse_silu=l1))
    t = pool.adaptive_avg_pool3d(t, cfg.t_pool)
    tf = separate(gemm.gemm(t.reshape(1, -1), tr["fc1"], activation=silu))
    trunk_out = gemm.gemm(tf, tr["fc2"])

    # Branch: the T history frames ride the kernels' batch dimension
    T = cfg.hist_len
    x = separate(conv.conv2d(hist, br["conv1"], fuse_silu=l1))
    x = separate(conv.conv2d(x, br["conv2"], fuse_silu=l1))
    x = pool.maxpool2d(x, 2)
    x = pool.adaptive_avg_pool2d(x, cfg.b_pool)
    feats = x.reshape(T, -1)                            # (T, 32)

    h = torch.zeros((1, cfg.rnn_hidden), dtype=feats.dtype,
                    device=feats.device)
    for i in range(T):                                  # RNN on GEMM (§IV-D3)
        xh = gemm.gemm(feats[i:i + 1], br["rnn_wx"])
        hh = gemm.gemm(h, br["rnn_wh"])
        h = torch.tanh(xh + hh)
    bf = separate(gemm.gemm(h, br["fc1"], activation=silu))
    branch_out = gemm.gemm(bf, br["fc2"])

    return (branch_out * trunk_out)[0]
