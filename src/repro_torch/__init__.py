"""PyTorch/CUDA port of ``repro``: the topology-optimization serving path.

Mirrors the module names of the JAX package (``configs``, ``core``,
``fea``, ``kernels``, ``obs``, ``serve``, ``optim``) and keeps its public
layouts (NHWC/NDHWC activations, HWIO/DHWIO conv weights, ``(K, N)`` FC
weights, the 88-line dof order). Imports ``torch`` and ``numpy`` only —
never ``jax`` and never ``repro``.

Entry points (``init_params``, ``run_hybrid``, ``TopoServingEngine``)
default to ``device="cuda"`` and raise without a GPU; they run on the CPU
only when the caller passes ``device="cpu"``. On a CUDA device the two
kernels of the serving tick always run as hand-written CUDA
(``kernels/cronet_pipeline.py``, ``kernels/cg_fused.py``); on the CPU the
same wrappers run their plain PyTorch versions.
"""
