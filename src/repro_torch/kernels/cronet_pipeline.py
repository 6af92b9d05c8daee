"""``cronet_fused``: the whole CRONet forward as one CUDA wrapper.

Replaces the Pallas megakernel ``repro/kernels/cronet_pipeline.py::
cronet_fused`` (one ``pallas_call`` for the whole network). On Hopper the
per-slot intermediates do not fit one SM, so the wrapper launches three
kernels from ``csrc/cronet_fused.cu`` — trunk convolutions reduced straight
into the AAP3D windows, branch convolutions reduced straight into the
pooled features, and a per-slot head (FCs, RNN, product); see that file for
the design and what bounds it. The three launches count as one.

Plain version: ``core.cronet.forward`` at the inputs' precision, returned
as float32. It runs only for CPU tensors.

Unlike the JAX megakernel, the wrapper does not cast its inputs or output
to ``cfg.dtype`` (cronet_pipeline.py:156-158, 171): the inputs keep the
step's precision (fp32 or bf16), accumulation is fp32, and the output is
fp32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import Params
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.core import cronet
from repro_torch.kernels import _build

_WEIGHTS = [("trunk", "conv1"), ("trunk", "conv2"), ("trunk", "fc1"),
            ("trunk", "fc2"), ("branch", "conv1"), ("branch", "conv2"),
            ("branch", "rnn_wx"), ("branch", "rnn_wh"), ("branch", "fc1"),
            ("branch", "fc2")]


def cronet_fused_plain(cfg: CRONetConfig, params: Params, load_vol, hist):
    """The plain PyTorch version: ``core.cronet.forward``, as float32."""
    return cronet.forward(cfg, params, load_vol, hist).float()


def _lib():
    return _build.function(
        "cronet_fused", "cronet_fused_forward", ctypes.c_int,
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p])


def cronet_fused(cfg: CRONetConfig, params: Params, load_vol: torch.Tensor,
                 hist: torch.Tensor) -> torch.Tensor:
    """load_vol (B, 4, ny+1, nx+1, 1), hist (B, T, ny, nx, 1) -> (B, p)
    float32. CUDA tensors launch the kernel (or raise); CPU tensors run
    ``cronet_fused_plain``."""
    if load_vol.device.type == "cpu":
        return cronet_fused_plain(cfg, params, load_vol, hist)
    if load_vol.device.type != "cuda":
        raise ValueError(f"cronet_fused: unsupported device {load_vol.device}")
    dt, code = load_vol.dtype, _build.dtype_code(load_vol)
    ws = [params[a][b] for a, b in _WEIGHTS]
    for t in [hist, *ws]:
        if t.dtype != dt or t.device != load_vol.device:
            raise TypeError("cronet_fused: inputs and weights must share one "
                            f"dtype and device; got {t.dtype} on {t.device}")
    B = load_vol.shape[0]
    H, W = cfg.nodes
    T, ny, nx = cfg.hist_len, cfg.nely, cfg.nelx
    if (tuple(load_vol.shape) != (B, cfg.t_depth, H, W, 1)
            or tuple(hist.shape) != (B, T, ny, nx, 1)):
        raise ValueError(f"cronet_fused: shapes {tuple(load_vol.shape)}, "
                         f"{tuple(hist.shape)} do not match {cfg.name}")
    if cfg.b_pool != (1, 1) or ws[1].shape[0] != 1:
        raise ValueError("cronet_fused: kernel assumes b_pool == (1, 1) and "
                         "a depth-1 trunk conv2")
    lv, hi = load_vol.contiguous(), hist.contiguous()
    ws = [w.contiguous() for w in ws]
    PD, PH, PW = cfg.t_pool
    dev = load_vol.device
    S = torch.empty((B, cfg.t_depth, PH, PW, cfg.t_c2), dtype=torch.float32,
                    device=dev)
    feats = torch.empty((B, T, cfg.b_c2), dtype=torch.float32, device=dev)
    out = torch.empty((B, cfg.p), dtype=torch.float32, device=dev)
    dims = [B, cfg.t_depth, H, W, ws[0].shape[0], T, ny, nx, cfg.t_c1,
            cfg.t_c2, cfg.b_c1, cfg.b_c2, PD, PH, PW, cfg.rnn_hidden,
            cfg.mid, cfg.p]
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_ws = (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])
    lib, fn = _lib()
    err = fn(code, lv.data_ptr(), hi.data_ptr(), c_ws,
             S.data_ptr(), feats.data_ptr(), out.data_ptr(), c_dims,
             *_build.device_stream(dev))
    _build.check(lib, "cronet_fused", err)
    cronet_fused.launches += 1
    return out


cronet_fused.launches = 0
