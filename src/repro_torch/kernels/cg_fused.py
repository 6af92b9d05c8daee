"""``solve_b_fused``: the whole batched Jacobi-PCG solve as one CUDA kernel.

Replaces the Pallas kernel ``repro/kernels/cg_fused.py::solve_b_fused``
(``_make_solve_kernel``, one ``pallas_call`` for the whole convergence
loop). ``csrc/cg_fused.cu`` runs every slot's solve in one launch, the
setup included (Jacobi diagonal, initial residual, RZ, fnorm, rnorm, which
the JAX package and ``_setup`` compute as tensor ops): one thread block per
slot with its Krylov state in registers and shared memory, each reduction
folded in ``fea2d.tree_sum``'s order in two barriers (see that file for
the design, what bounds it and why the fold is the same tree).

Plain version: ``solve_b_plain``, the reference loop of
``repro.fea.fea2d.solve_b`` in PyTorch (a host-synchronised while loop
that freezes finished slots). It runs only for CPU tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.fea import fea2d
from repro_torch.kernels import _build


def _setup(bp: "fea2d.BatchProblem", X, U0, need):
    B = X.shape[0]
    F = bp.f * bp.free_mask
    diag = fea2d.jacobi_diag(bp, X)
    if need is None:
        need = torch.ones((B,), dtype=torch.bool, device=X.device)
    U = torch.zeros_like(F) if U0 is None else U0 * bp.free_mask
    R = F - fea2d.stiffness_apply_b(bp, X, U)
    Z = R / diag * bp.free_mask
    RZ = fea2d.tree_dot(R, Z)
    fnorm = fea2d.tree_norm(F)
    return diag, need, U, R, Z, RZ, fnorm


def solve_b_plain(bp: "fea2d.BatchProblem", X, tol: float = 1e-6,
                  max_iter: int = 2000, U0=None, need=None):
    """The plain PyTorch version: the reference per-slot-masked loop."""
    diag, need, U, R, P, RZ, fnorm = _setup(bp, X, U0, need)

    def active_of(R, its):
        # fnorm > 0: a zero-load slot is converged by definition
        return (need & (fea2d.tree_norm(R) > tol * fnorm) & (fnorm > 0)
                & (its < max_iter))

    its = torch.zeros((X.shape[0],), dtype=torch.int32, device=X.device)
    act = active_of(R, its)
    while bool(act.any()):
        KP = fea2d.stiffness_apply_b(bp, X, P)
        alpha = RZ / torch.clamp_min(fea2d.tree_dot(P, KP), 1e-30)
        U_n = U + alpha[:, None] * P
        R_n = R - alpha[:, None] * KP
        Z = R_n / diag * bp.free_mask
        RZ_n = fea2d.tree_dot(R_n, Z)
        P_n = Z + (RZ_n / torch.clamp_min(RZ, 1e-30))[:, None] * P
        m = act[:, None]
        U, R, P = (torch.where(m, U_n, U), torch.where(m, R_n, R),
                   torch.where(m, P_n, P))
        RZ = torch.where(act, RZ_n, RZ)
        its = its + act.to(torch.int32)
        act = active_of(R, its)
    return U, its


MAX_NODES = 2048        # csrc/cg_fused.cu: kMaxNodes


def block_threads(pn: int) -> int:
    """Threads a block for a mesh whose node count rounds up to ``pn``: a
    quarter of ``pn`` (at least a warp), so a thread owns four nodes and
    keeps their state in registers (30x20: 256 threads; 60x20: 512)."""
    return max(32, pn // 4)


def _host_ke(KE: torch.Tensor):
    """KE's 64 floats in host memory, for the kernel's by-value parameter.
    Kept on the tensor with its version counter, so a tick's problems, which
    share one KE tensor, copy it to the host once."""
    hit = getattr(KE, "_cg_host_ke", None)
    if hit is None or hit[0] != KE._version:
        vals = KE.detach().to("cpu", torch.float32).reshape(-1).tolist()
        if len(vals) != 64:
            raise ValueError(f"solve_b_fused: KE {tuple(KE.shape)}, need "
                             "(8, 8)")
        hit = (KE._version, (ctypes.c_float * 64)(*vals))
        KE._cg_host_ke = hit
    return hit[1]


def _lib():
    return _build.function(
        "cg_fused", "cg_fused_solve", ctypes.c_int,
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def solve_b_fused(bp: "fea2d.BatchProblem", X, tol: float = 1e-6,
                  max_iter: int = 2000, U0=None, need=None):
    """Batched Jacobi-PCG: (U (B, ndof) float32, iterations (B,) int32).
    CUDA tensors launch the kernel (or raise); CPU tensors run
    ``solve_b_plain``."""
    if X.device.type == "cpu":
        return solve_b_plain(bp, X, tol=tol, max_iter=max_iter, U0=U0,
                             need=need)
    if X.device.type != "cuda":
        raise ValueError(f"solve_b_fused: unsupported device {X.device}")
    if X.dtype != torch.float32 or bp.f.dtype != torch.float32:
        raise TypeError("solve_b_fused: float32 densities and loads only")
    if bp.penal != 3.0:
        raise ValueError(f"solve_b_fused: kernel computes x**3, got penal "
                         f"{bp.penal}")
    B, nely, nelx = X.shape
    ndof = 2 * (nelx + 1) * (nely + 1)
    if tuple(bp.f.shape) != (B, ndof):
        raise ValueError(f"solve_b_fused: loads {tuple(bp.f.shape)} do not "
                         f"match densities {tuple(X.shape)}")
    nnode = ndof // 2
    pn = 1 << max(nnode - 1, 0).bit_length()
    if pn > MAX_NODES:
        raise ValueError(f"solve_b_fused: {nnode} nodes; the kernel takes "
                         f"up to {MAX_NODES}")
    if U0 is not None and tuple(U0.shape) != (B, ndof):
        raise ValueError(f"solve_b_fused: warm start {tuple(U0.shape)}, "
                         f"need {(B, ndof)}")
    dev = X.device
    ke = _host_ke(bp.KE)
    if need is None:
        need = torch.ones((B,), dtype=torch.bool, device=dev)
    ins = [X, bp.elem_mask, bp.f, bp.free_mask, need.to(torch.float32), U0]
    ins = [None if t is None else t.to(torch.float32).contiguous()
           for t in ins]
    for t in ins:
        if t is not None and t.device != dev:
            raise ValueError(f"solve_b_fused: tensor on {t.device}, "
                             f"densities on {dev}")
    U_out = torch.empty((B, ndof), dtype=torch.float32, device=dev)
    its = torch.empty((B,), dtype=torch.int32, device=dev)
    lib, fn = _lib()
    ptrs = [None if t is None else t.data_ptr() for t in ins]
    err = fn(*ptrs[:4], ctypes.cast(ke, ctypes.c_void_p), *ptrs[4:],
             U_out.data_ptr(), its.data_ptr(), B, nelx, nely, pn,
             block_threads(pn), float(bp.e_min), float(1 - bp.e_min), float(tol), int(max_iter),
             *_build.device_stream(dev))
    _build.check(lib, "cg_fused", err)
    solve_b_fused.launches += 1
    return U_out, its


solve_b_fused.launches = 0
