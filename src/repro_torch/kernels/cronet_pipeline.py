"""``cronet_fused``: the whole CRONet forward as one CUDA wrapper.

Replaces the Pallas megakernel ``repro/kernels/cronet_pipeline.py::
cronet_fused`` (one ``pallas_call`` for the whole network). On Hopper the
per-slot intermediates do not fit one SM, so the wrapper launches two
kernels from ``csrc/cronet_fused.cu``: one for both stages' convolutions,
cut into row bands of equal work (trunk tiles reduced into per-row AAP
column-window sums, branch tiles through the max pool into per-band sums),
and a head with a thread-block cluster per slot (AAP3D, both FC stacks,
the RNN, the product); see that file for the design and what bounds it. ``cronet_plan`` computes the launch plan the
wrapper passes to the kernels. The two launches count as one.

Plain version: ``core.cronet.forward`` at the inputs' precision, returned
as float32. It runs only for CPU tensors.

Unlike the JAX megakernel, the wrapper does not cast its inputs or output
to ``cfg.dtype`` (cronet_pipeline.py:156-158, 171): the inputs keep the
step's precision (fp32 or bf16), accumulation is fp32, and the output is
fp32.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.common import Params
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.core import cronet
from repro_torch.kernels import _build

_WEIGHTS = [("trunk", "conv1"), ("trunk", "conv2"), ("trunk", "fc1"),
            ("trunk", "fc2"), ("branch", "conv1"), ("branch", "conv2"),
            ("branch", "rnn_wx"), ("branch", "rnn_wh"), ("branch", "fc1"),
            ("branch", "fc2")]

# csrc/cronet_fused.cu's constants: threads a block (both kernels), the
# fixed channel widths, conv2's register tile (8 channels x RUN adjacent
# pixels a thread) and its SPLIT input-channel groups, the pool-sum groups,
# the largest (portable) cluster, the head's limits (window, bands,
# features a thread, windows a rank) and the bytes a block may have of
# shared memory
THREADS, C1, TRUNK_C2, BRANCH_C2, KD, HID = 256, 16, 64, 32, 2, 64
CHAN, RUN, SPLIT, POOL_GROUPS, CLUSTER = 8, 4, 2, 8, 8
GROUP_THREADS = THREADS // SPLIT
MAX_WIN_D, MAX_WIN_H, MAX_BANDS, MAX_FEAT, MAX_BFE, MAX_TAB = 2, 5, 10, 3, 2, 16
MAX_SMEM = 232448
_ELEMENT_BYTES = {torch.float32: 4, torch.bfloat16: 2}


class CronetPlan(NamedTuple):
    """The launch plan of ``csrc/cronet_fused.cu`` (its ``Plan``, field for
    field). conv_kernel: grid (``conv_blocks``, ``batch``); trunk tiles are
    (depth, band of ``t_rows`` rows), ``t_bands`` of them a depth, each row
    ``t_runs`` runs of RUN pixels; branch tiles (time step, band of
    ``b_rows`` rows), likewise. head_kernel: grid (``cluster``, ``batch``),
    rank r owning fc1 rows [r * k_chunk, ..) and fc2 columns
    [r * col_chunk, ..). Shared bytes a block: ``conv_smem``,
    ``head_smem``. Only ``batch`` depends on B."""
    batch: int
    t_rows: int
    t_bands: int
    t_runs: int
    b_rows: int
    b_bands: int
    b_runs: int
    conv_blocks: int
    conv_smem: int
    cluster: int
    k_chunk: int
    col_chunk: int
    head_smem: int


def _round4(n: int) -> int:
    return (n + 3) & ~3


def tile_floats(c2: int, kd: int, rows: int, runs: int) -> int:
    """Shared floats of a conv tile (csrc/cronet_fused.cu, tile_layout):
    conv2's filter, conv1's, the input halo, conv1's output tile, the
    pool-sum groups and the second input-channel group's sums."""
    hw, xw = _round4(runs * RUN + 4), _round4(runs * RUN + 2)
    return (9 * C1 * c2 + _round4(kd * 9 * C1) + kd * (rows + 4) * hw
            + C1 * (rows + 2) * xw + POOL_GROUPS * c2
            + CHAN * RUN * GROUP_THREADS)


def head_floats(t: int, mid: int, vec: int, k_chunk: int,
                col_chunk: int) -> int:
    """Shared floats of a head block (csrc/cronet_fused.cu, head_layout):
    the staged weights (fc1's rows and both fc2s' columns of a rank, rwx)
    in their own type, then the fp32 work areas and the window table."""
    es = 16 // vec
    kl1, kl2 = THREADS // (mid // vec), THREADS // (col_chunk // vec)
    staged = (_round4(k_chunk * mid * es // 4)
              + 2 * _round4(mid * col_chunk * es // 4)
              + _round4(BRANCH_C2 * HID * es // 4))
    fixed = (_round4(k_chunk) + _round4(t * BRANCH_C2) + _round4(t * HID)
             + 2 * HID + 2 * _round4(mid) + CLUSTER * _round4(mid))
    return (staged + fixed + _round4(max(kl1 * mid, 2 * kl2 * col_chunk))
            + 4 * MAX_TAB)


def cronet_plan(cfg: CRONetConfig, batch: int,
                dtype: torch.dtype = torch.float32) -> CronetPlan:
    """The launch plan of ``csrc/cronet_fused.cu`` for ``batch`` slots of
    ``cfg`` in ``dtype`` (the inputs' and weights').

    * Conv tiles are bands of whole rows, as many rows as an input-channel
      group's pixel runs hold (16 runs of 4 pixels for the trunk's 64
      channels, 32 for the branch's 32; an even number of branch rows, for
      the 2x2 pool): at medium a trunk tile is 2 rows x 31 pixels x 64
      channels and a branch tile 4 rows x 30 x 32, ~0.55 M multiply-adds
      each, 94 tiles a slot.
    * The head is a cluster of 8 blocks a slot; fc1's K (4,800) and fc2's
      columns (2,560) are cut into 8 chunks, columns by whole 16-byte
      vectors.
    Raises ValueError for a configuration the kernels were not written for
    (other channel widths, an AAP2D target other than (1, 1), a mesh too
    wide for one row of a tile, windows or bands past the head's limits).
    """
    if dtype not in _ELEMENT_BYTES:
        raise TypeError(f"cronet_plan: dtype {dtype}: float32 or bfloat16")
    if batch < 1 or batch > 65535:
        raise ValueError(f"cronet_plan: batch {batch}")
    if (cfg.t_c1, cfg.t_c2, cfg.b_c1, cfg.b_c2, cfg.rnn_hidden) != (
            C1, TRUNK_C2, C1, BRANCH_C2, HID) or cfg.b_pool != (1, 1):
        raise ValueError(f"cronet_plan: {cfg.name}: the kernels take conv "
                         "widths 16/64 and 16/32, an RNN of 64 and b_pool "
                         "(1, 1)")
    vec = 16 // _ELEMENT_BYTES[dtype]
    H, W = cfg.nodes
    ny, nx, T = cfg.nely, cfg.nelx, cfg.hist_len
    t_runs, b_runs = -(-W // RUN), -(-nx // RUN)
    t_rows = (GROUP_THREADS // (TRUNK_C2 // CHAN)) // t_runs
    b_rows = ((GROUP_THREADS // (BRANCH_C2 // CHAN)) // b_runs) // 2 * 2
    if t_rows < 1 or b_rows < 2:
        raise ValueError(f"cronet_plan: {cfg.name}: a mesh row is wider "
                         "than a conv tile holds")
    t_bands, b_bands = -(-H // t_rows), -(-ny // b_rows)
    # the head loads a feature's depth x row window (at most 2 x 5 row
    # sums) and a time step's bands (at most 10) all at once
    win = lambda n, o: max(-(-((i + 1) * n) // o) - (i * n) // o  # noqa
                           for i in range(o))
    if (win(cfg.t_depth, cfg.t_pool[0]) > MAX_WIN_D
            or win(H, cfg.t_pool[1]) > MAX_WIN_H or b_bands > MAX_BANDS):
        raise ValueError(f"cronet_plan: {cfg.name}: an AAP3D window or the "
                         "branch bands exceed what the head loads at once")
    conv_smem = 4 * max(tile_floats(TRUNK_C2, KD, t_rows, t_runs),
                        tile_floats(BRANCH_C2, 1, b_rows, b_runs))
    feats = cfg.trunk_features
    k_chunk = -(-feats // CLUSTER)
    col_chunk = -(-cfg.p // (CLUSTER * vec)) * vec
    if (cfg.mid % vec or cfg.p % vec or col_chunk // vec > THREADS
            or k_chunk > MAX_FEAT * THREADS or T * BRANCH_C2 > MAX_BFE * THREADS
            or k_chunk // TRUNK_C2 + 2 > MAX_TAB):
        raise ValueError(f"cronet_plan: {cfg.name}: mid {cfg.mid}, p "
                         f"{cfg.p}, {feats} features or hist_len {T} do "
                         "not fit the head")
    head_smem = 4 * head_floats(T, cfg.mid, vec, k_chunk, col_chunk)
    if max(conv_smem, head_smem) > MAX_SMEM:
        raise ValueError(f"cronet_plan: {cfg.name}: {conv_smem} / "
                         f"{head_smem} shared bytes exceed {MAX_SMEM}")
    return CronetPlan(
        batch=batch, t_rows=t_rows, t_bands=t_bands, t_runs=t_runs,
        b_rows=b_rows, b_bands=b_bands, b_runs=b_runs,
        conv_blocks=cfg.t_depth * t_bands + T * b_bands,
        conv_smem=conv_smem, cluster=CLUSTER, k_chunk=k_chunk,
        col_chunk=col_chunk, head_smem=head_smem)


def cronet_fused_plain(cfg: CRONetConfig, params: Params, load_vol, hist):
    """The plain PyTorch version: ``core.cronet.forward``, as float32."""
    return cronet.forward(cfg, params, load_vol, hist).float()


# cronet_fused_forward's C signature
ARGTYPES = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]


def _lib():
    return _build.function("cronet_fused", "cronet_fused_forward",
                           ctypes.c_int, ARGTYPES)


def launch_args(cfg: CRONetConfig, params: Params, load_vol: torch.Tensor,
                hist: torch.Tensor):
    """``(args, out, keep)``: the arguments of ``cronet_fused_forward`` for
    CUDA inputs (checked as the wrapper checks them), the output they
    write, and the tensors that must outlive the launch."""
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
    if cfg.b_pool != (1, 1) or ws[1].shape[0] != 1 or ws[0].shape[0] != KD:
        raise ValueError("cronet_fused: kernel assumes b_pool == (1, 1), a "
                         "depth-2 trunk conv1 and a depth-1 trunk conv2")
    plan = cronet_plan(cfg, B, dt)
    lv, hi = load_vol.contiguous(), hist.contiguous()
    # the head reads weights 16 bytes at a time: an unaligned view is copied
    ws = [w.contiguous() for w in ws]
    ws = [w if w.data_ptr() % 16 == 0 else w.clone() for w in ws]
    PD, PH, PW = cfg.t_pool
    dev = load_vol.device
    rowsum = torch.empty((B, cfg.t_depth, H, PW, TRUNK_C2),
                         dtype=torch.float32, device=dev)
    bpart = torch.empty((B, T, plan.b_bands, BRANCH_C2), dtype=torch.float32,
                        device=dev)
    out = torch.empty((B, cfg.p), dtype=torch.float32, device=dev)
    dims = [B, cfg.t_depth, H, W, T, ny, nx, PD, PH, PW, cfg.mid, cfg.p]
    c_dims = (ctypes.c_int * len(dims))(*dims)
    c_plan = (ctypes.c_int * len(plan))(*plan)
    c_ws = (ctypes.c_void_p * len(ws))(*[w.data_ptr() for w in ws])
    args = (code, lv.data_ptr(), hi.data_ptr(), c_ws, rowsum.data_ptr(),
            bpart.data_ptr(), out.data_ptr(), c_dims, c_plan,
            *_build.device_stream(dev))
    return args, out, (lv, hi, ws, rowsum, bpart, c_dims, c_plan, c_ws)


def cronet_fused(cfg: CRONetConfig, params: Params, load_vol: torch.Tensor,
                 hist: torch.Tensor) -> torch.Tensor:
    """load_vol (B, 4, ny+1, nx+1, 1), hist (B, T, ny, nx, 1) -> (B, p)
    float32. CUDA tensors launch the kernel (or raise); CPU tensors run
    ``cronet_fused_plain``."""
    if load_vol.device.type == "cpu":
        return cronet_fused_plain(cfg, params, load_vol, hist)
    args, out, keep = launch_args(cfg, params, load_vol, hist)
    lib, fn = _lib()
    err = fn(*args)
    _build.check(lib, "cronet_fused", err)
    cronet_fused.launches += 1
    return out


cronet_fused.launches = 0
