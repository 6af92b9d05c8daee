"""Hand-written Hopper kernels of the port, one wrapper each.

  * ``cronet_pipeline.cronet_fused`` — the whole CRONet forward
    (``csrc/cronet_fused.cu``), replacing the Pallas megakernel
    ``repro/kernels/cronet_pipeline.py::cronet_fused``;
  * ``cg_fused.solve_b_fused`` — the whole batched Jacobi-PCG solve
    (``csrc/cg_fused.cu``), replacing
    ``repro/kernels/cg_fused.py::solve_b_fused``;
  * ``conv.conv2d``, ``conv.conv3d`` — SAME convolutions with optional
    fused SiLU (``csrc/conv.cu``), replacing ``repro/kernels/conv.py``;
  * ``gemm.gemm`` — GEMM with an fp32 accumulator and a silu/tanh epilogue
    (``csrc/gemm.cu``), replacing ``repro/kernels/gemm.py``;
  * ``pool.maxpool2d``, ``pool.adaptive_avg_pool2d``,
    ``pool.adaptive_avg_pool3d`` (``csrc/pool.cu``), replacing
    ``repro/kernels/pool.py``;
  * ``silu.silu_lut``, ``silu.silu_exact`` (``csrc/silu.cu``), replacing
    ``repro/kernels/silu.py``;
  * ``flash_attention.flash_attention`` (and ``flash_attention_causal_gqa``,
    which launches the same kernels and counts on it): a tensor-core kernel
    for bf16 at head widths 64 and 128, a SIMT kernel otherwise
    (``csrc/flash_attention.cu``), replacing
    ``repro/kernels/flash_attention.py``;
  * ``slstm.slstm_fused`` (``csrc/slstm.cu``, one cooperative launch),
    replacing ``repro/kernels/slstm.py``.

``ref`` holds the plain PyTorch versions of the per-op and LM-side
functions, in the JAX package's layouts.

Dispatch is by device, with no switch: a wrapper given CUDA tensors
launches its kernel (built from ``csrc/`` with nvcc at first use, see
``_build``) or raises; given CPU tensors it runs its plain PyTorch version.
Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, bumped only where the kernel is launched; a wrapper
with two kernels also counts each one's (``flash_attention.tc_launches``,
``.simt_launches``).
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels import conv, gemm, pool, silu
    from repro_torch.kernels.cg_fused import solve_b_fused
    from repro_torch.kernels.cronet_pipeline import cronet_fused
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.slstm import slstm_fused
    fns = [cronet_fused, solve_b_fused, conv.conv2d, conv.conv3d, gemm.gemm,
           pool.maxpool2d, pool.adaptive_avg_pool2d, pool.adaptive_avg_pool3d,
           silu.silu_lut, silu.silu_exact, flash_attention, slstm_fused]
    return {fn.__name__: fn for fn in fns}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        for attr in list(vars(fn)):
            if attr.endswith("launches"):
                setattr(fn, attr, 0)


def build_all() -> float:
    """Build every kernel library (one nvcc per source, in parallel);
    returns the wall seconds. Requires nvcc."""
    from repro_torch.kernels import _build
    return _build.build_all()
