"""CRONet in plain PyTorch: the counterpart of ``repro.core.cronet``.

Architecture (paper Table I, see ``configs/cronet.py``):

  TrunkNet(F):  Conv3D(2,3,3) 1->16 +SiLU -> Conv3D(1,3,3) 16->64 +SiLU
                -> AAP3D(3,5,5) -> FC 4800->40 +SiLU -> FC 40->2560
  BranchNet(X_hist): per-timestep [Conv2D 1->16 +SiLU -> Conv2D 16->32
                +SiLU -> MaxPool2 -> AAP2D(1,1)] -> RNN(32->64, tanh, 10
                steps) -> FC 64->40 +SiLU -> FC 40->2560
  U = branch * trunk   (element-wise, p=2560)

Public functions keep the JAX layouts: load volume (B, 4, ny+1, nx+1, 1)
and density history (B, T, ny, nx, 1) channels-last, DHWIO/HWIO conv
weights, (K, N) FC weights. ``forward`` here is the plain version of the
``cronet_fused`` kernel (``kernels/cronet_pipeline.py``); ``CRONet``
dispatches to that kernel, which runs plain on CPU tensors.

Slot invariance: ``forward`` runs the network one slot at a time, so every
slot sees the same tensor shapes whatever the batch width, and slot b of
a B-wide call is bitwise the slot computed alone (the JAX oracle gets the
same property from its per-row GEMV map, cronet.py:128-139).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.common import Params, param_shapes
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.kernels import ref


def _trunk_one(cfg: CRONetConfig, p, load_vol):
    x = F.silu(ref.conv3d(load_vol, p["conv1"], "causal_same"))
    x = F.silu(ref.conv3d(x, p["conv2"], "same"))       # (1, D, H, W, 64)
    x = ref.adaptive_avg_pool3d(x, cfg.t_pool)
    x = x.reshape(1, -1)                                # (d, h, w, c) order
    x = F.silu(x @ p["fc1"])
    return x @ p["fc2"]


def _branch_one(cfg: CRONetConfig, p, hist):
    t = hist.shape[1]
    x = hist.reshape(t, *hist.shape[2:])                # (T, ny, nx, 1)
    x = F.silu(ref.conv2d_same(x, p["conv1"]))
    x = F.silu(ref.conv2d_same(x, p["conv2"]))
    x = ref.maxpool2d(x, 2)                             # floor: edge dropped
    x = ref.adaptive_avg_pool2d(x, cfg.b_pool)
    feats = x.reshape(1, t, -1)                         # (1, T, 32)
    h = torch.zeros((1, cfg.rnn_hidden), dtype=feats.dtype,
                    device=feats.device)
    for i in range(t):
        h = torch.tanh(feats[:, i] @ p["rnn_wx"] + h @ p["rnn_wh"])
    x = F.silu(h @ p["fc1"])
    return x @ p["fc2"]


def trunk_forward(cfg: CRONetConfig, p, load_vol):
    """load_vol: (B, 4, ny+1, nx+1, 1) -> (B, p)."""
    return torch.cat([_trunk_one(cfg, p, load_vol[b:b + 1])
                      for b in range(load_vol.shape[0])])


def branch_forward(cfg: CRONetConfig, p, hist):
    """hist: (B, T, ny, nx, 1) -> (B, p)."""
    return torch.cat([_branch_one(cfg, p, hist[b:b + 1])
                      for b in range(hist.shape[0])])


def forward(cfg: CRONetConfig, params: Params, load_vol, hist):
    """The p-dim Mul output (B, p), in the inputs' dtype."""
    return (branch_forward(cfg, params["branch"], hist)
            * trunk_forward(cfg, params["trunk"], load_vol))


def decode_displacement(cfg: CRONetConfig, u_vec):
    """(B, p=2560) -> (B, ny+1, nx+1, 2) nodal displacement field:
    reshape to (32, 40, 2) and bilinear resize. ``antialias=True`` is what
    ``jax.image.resize(..., "bilinear")`` does when it downsamples; without
    it the two differ by up to ~2 on random grids."""
    b = u_vec.shape[0]
    grid = u_vec.reshape(b, 32, 40, 2).float().permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=cfg.nodes, mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


def decode_to_dofs(cfg: CRONetConfig, u_vec):
    """(B, p) -> (B, ndof) in the 88-line dof layout (node n =
    x*(nely+1)+y, dofs [2n, 2n+1])."""
    grid = decode_displacement(cfg, u_vec)              # (B, ny+1, nx+1, 2)
    return grid.permute(0, 2, 1, 3).reshape(u_vec.shape[0], -1)


def count_macs(cfg: CRONetConfig) -> Dict[str, int]:
    """Analytic MAC counts reproducing paper Table I (cronet.py:210)."""
    c = cfg
    H, W = c.nely + 1, c.nelx + 1
    macs = {
        "trunk/conv3d1": 3 * H * W * (2 * 3 * 3 * 1 * c.t_c1),
        "trunk/conv3d2": 4 * H * W * (1 * 3 * 3 * c.t_c1 * c.t_c2),
        "trunk/fc1": c.trunk_features * c.mid,
        "trunk/fc2": c.mid * c.p,
        "branch/conv2d1": c.hist_len * c.nely * c.nelx * (3 * 3 * 1 * c.b_c1),
        "branch/conv2d2": c.hist_len * c.nely * c.nelx * (3 * 3 * c.b_c1 * c.b_c2),
        "branch/rnn": c.hist_len * (c.rnn_hidden * (c.branch_features + c.rnn_hidden)),
        "branch/fc1": c.rnn_hidden * c.mid,
        "branch/fc2": c.mid * c.p,
    }
    macs["total"] = sum(macs.values())
    return macs


class CRONet(nn.Module):
    """CRONet as a module: the weights as parameters, in the JAX layouts.

    ``forward(load_vol, hist)`` runs ``kernels.cronet_pipeline
    .cronet_fused`` — the CUDA kernel for CUDA tensors, the plain
    ``forward`` above for CPU tensors — and returns (B, p) float32.
    """

    def __init__(self, cfg: CRONetConfig, params: Optional[Params] = None):
        super().__init__()
        self.cfg = cfg
        shapes = param_shapes(cfg)
        self.nets = nn.ModuleDict()
        for part, leaves in shapes.items():
            self.nets[part] = nn.ParameterDict({
                k: nn.Parameter(params[part][k].detach().clone()
                                if params is not None
                                else torch.zeros(shape),
                                requires_grad=False)
                for k, shape in leaves.items()})

    def params(self) -> Params:
        return {part: {k: v for k, v in pd.items()}
                for part, pd in self.nets.items()}

    def forward(self, load_vol, hist):
        from repro_torch.kernels.cronet_pipeline import cronet_fused
        return cronet_fused(self.cfg, self.params(), load_vol, hist)
