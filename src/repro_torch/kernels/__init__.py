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
    ``repro/kernels/pool.py``.

``ref`` holds the plain PyTorch versions of the per-op functions, in the JAX
package's layouts.

Dispatch is by device, with no switch: a wrapper given CUDA tensors
launches its kernel (built from ``csrc/`` with nvcc at first use, see
``_build``) or raises; given CPU tensors it runs its plain PyTorch version.
Each wrapper counts its kernel launches in a plain integer attribute,
``<wrapper>.launches``, bumped only where the kernel is launched.
"""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from repro_torch.kernels import conv, gemm, pool
    from repro_torch.kernels.cg_fused import solve_b_fused
    from repro_torch.kernels.cronet_pipeline import cronet_fused
    fns = [cronet_fused, solve_b_fused, conv.conv2d, conv.conv3d, gemm.gemm,
           pool.maxpool2d, pool.adaptive_avg_pool2d, pool.adaptive_avg_pool3d]
    return {fn.__name__: fn for fn in fns}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def build_all() -> float:
    """Build every kernel library (one nvcc per source, in parallel);
    returns the wall seconds. Requires nvcc."""
    from repro_torch.kernels import _build
    return _build.build_all()
