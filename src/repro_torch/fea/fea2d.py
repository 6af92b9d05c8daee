"""2D plane-stress FEA for SIMP topology optimization, in PyTorch.

The counterpart of ``repro.fea.fea2d``: the 88-line formulation
(Andreassen et al. 2011), bilinear quads, E0 = 1, nu = 0.3, matrix-free
Jacobi-preconditioned CG. Problem builders return float32 CPU tensors —
the numpy constants are float64 and are cast explicitly, or the CPU path
would silently run the FEA in float64 (JAX with x64 off casts them for
free). The batched functions run on whatever device their tensors are on.

Element indexing follows the reference exactly: the (B, nely, nelx)
density buffer is reinterpreted, not transposed, as the (B, nelx, nely)
element grid (``_e_grid``, ``pad_problem``), while ``load_volume_b``
transposes the nodal fields to (ny+1, nx+1) images.

Every batched op is elementwise or a fixed-order ``tree_sum``, so slot b of
a B-wide call does not depend on B. ``solve_b`` dispatches to the
``solve_b_fused`` CUDA kernel for CUDA tensors and to its plain version for
CPU tensors (``kernels/cg_fused.py``); there is no backend knob. The
single-problem ``solve`` and ``compliance_and_sens`` pad the problem to a
width-2 batch and go through the batched path, as ``run_hybrid`` does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common import resolve_device


def element_stiffness(nu: float = 0.3) -> np.ndarray:
    """Standard 8x8 bilinear quad KE (E=1, unit thickness), float64."""
    k = np.array([
        1 / 2 - nu / 6, 1 / 8 + nu / 8, -1 / 4 - nu / 12, -1 / 8 + 3 * nu / 8,
        -1 / 4 + nu / 12, -1 / 8 - nu / 8, nu / 6, 1 / 8 - 3 * nu / 8,
    ])
    KE = 1 / (1 - nu ** 2) * np.array([
        [k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]],
        [k[1], k[0], k[7], k[6], k[5], k[4], k[3], k[2]],
        [k[2], k[7], k[0], k[5], k[6], k[3], k[4], k[1]],
        [k[3], k[6], k[5], k[0], k[7], k[2], k[1], k[4]],
        [k[4], k[5], k[6], k[7], k[0], k[1], k[2], k[3]],
        [k[5], k[4], k[3], k[2], k[1], k[0], k[7], k[6]],
        [k[6], k[3], k[4], k[1], k[2], k[7], k[0], k[5]],
        [k[7], k[2], k[1], k[4], k[3], k[6], k[5], k[0]],
    ])
    return KE


def _f32(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32)


class Problem(NamedTuple):
    nelx: int
    nely: int
    edof: torch.Tensor         # (ne, 8) int64 global dof indices per element
    free_mask: torch.Tensor    # (ndof,) 1.0 on free dofs, 0.0 on fixed
    f: torch.Tensor            # (ndof,) load vector
    KE: torch.Tensor           # (8, 8)
    volfrac: float
    fixed_x_mask: torch.Tensor  # (ndof,) bookkeeping for the load volume
    penal: float = 3.0
    e_min: float = 1e-9
    # shape-class padding: 1.0 on active elements, 0.0 on the passive
    # border pad_problem adds; None means every element is active
    elem_mask: Optional[torch.Tensor] = None   # (nely, nelx) or None


def _edof_matrix(nelx: int, nely: int) -> np.ndarray:
    """Node id n = x*(nely+1) + y, 2 dofs per node (88-line layout)."""
    edof = np.zeros((nelx * nely, 8), dtype=np.int64)
    for ex in range(nelx):
        for ey in range(nely):
            el = ex * nely + ey
            n1 = (nely + 1) * ex + ey
            n2 = (nely + 1) * (ex + 1) + ey
            edof[el] = [2 * n1, 2 * n1 + 1, 2 * n2, 2 * n2 + 1,
                        2 * n2 + 2, 2 * n2 + 3, 2 * n1 + 2, 2 * n1 + 3]
    return edof


def mbb_problem(nelx: int, nely: int, volfrac: float = 0.5) -> Problem:
    """MBB half-beam: unit downward load at the top-left node."""
    return point_load_problem(nelx, nely, volfrac=volfrac)


def point_load_problem(nelx: int, nely: int, load_node=(0, 0),
                       load=(0.0, -1.0), volfrac: float = 0.5) -> Problem:
    """MBB boundary conditions with a point load (Fx, Fy) at grid node
    ``load_node`` = (x, y); the default reproduces ``mbb_problem``."""
    xn, yn = load_node
    if not (0 <= xn <= nelx and 0 <= yn <= nely):
        raise ValueError(f"load node {load_node} outside {nelx}x{nely} grid")
    ndof = 2 * (nelx + 1) * (nely + 1)
    node = xn * (nely + 1) + yn
    f = np.zeros(ndof)
    f[2 * node] = load[0]
    f[2 * node + 1] = load[1]
    fixed = list(range(0, 2 * (nely + 1), 2))      # left edge x-dofs
    fixed.append(2 * (nelx + 1) * (nely + 1) - 1)  # bottom-right y
    free_mask = np.ones(ndof)
    free_mask[fixed] = 0.0
    fixed_x = np.zeros(ndof)
    fixed_x[fixed] = 1.0
    if not np.any(f * free_mask):
        raise ValueError(
            f"load {load} at node {load_node} acts only on fixed dofs — "
            "the problem would be all-zero (use idle_problem for padding)")
    return Problem(
        nelx=nelx, nely=nely, edof=torch.from_numpy(_edof_matrix(nelx, nely)),
        free_mask=_f32(free_mask), f=_f32(f * free_mask),
        KE=_f32(element_stiffness()), volfrac=volfrac,
        fixed_x_mask=_f32(fixed_x))


def idle_problem(nelx: int, nely: int, volfrac: float = 0.5) -> Problem:
    """Zero-load, fully-fixed padding problem for empty serving slots: the
    masked CG treats it as converged in zero iterations."""
    ndof = 2 * (nelx + 1) * (nely + 1)
    zeros = torch.zeros(ndof)
    return Problem(
        nelx=nelx, nely=nely, edof=torch.from_numpy(_edof_matrix(nelx, nely)),
        free_mask=zeros, f=zeros, KE=_f32(element_stiffness()),
        volfrac=volfrac, fixed_x_mask=zeros)


def pad_problem(prob: Problem, nelx: int, nely: int) -> Problem:
    """Embed ``prob`` into a larger ``(nelx, nely)`` shape-class mesh with a
    passive border (elem_mask 0, fixed zero-load dofs); see
    ``repro.fea.fea2d.pad_problem``. An exact fit returns the problem with
    an all-ones mask attached."""
    ox, oy = prob.nelx, prob.nely
    if nelx < ox or nely < oy:
        raise ValueError(f"cannot pad {ox}x{oy} onto smaller shape "
                         f"class {nelx}x{nely}")
    # element grid [ex, ey] read as the (nely, nelx) density buffer
    # (reshape, not transpose: flat el = ex*nely + ey)
    mask_g = np.zeros((nelx, nely), np.float32)
    mask_g[:ox, :oy] = 1.0
    elem_mask = _f32(mask_g.reshape(nely, nelx))
    if (nelx, nely) == (ox, oy):
        return prob._replace(elem_mask=elem_mask)

    def embed(vec, fill):
        g = np.full((nelx + 1, nely + 1, 2), fill, np.float64)
        g[:ox + 1, :oy + 1] = np.asarray(vec).reshape(ox + 1, oy + 1, 2)
        return _f32(g.reshape(-1))

    return Problem(
        nelx=nelx, nely=nely, edof=torch.from_numpy(_edof_matrix(nelx, nely)),
        free_mask=embed(prob.free_mask, 0.0), f=embed(prob.f, 0.0),
        KE=prob.KE, volfrac=prob.volfrac,
        # the padding reads as supported in the TrunkNet load volume
        fixed_x_mask=embed(prob.fixed_x_mask, 1.0),
        penal=prob.penal, e_min=prob.e_min, elem_mask=elem_mask)


def crop_density(x, orig_nelx: int, orig_nely: int) -> np.ndarray:
    """Crop a padded-mesh density field back to the original mesh's
    density layout (the inverse of ``pad_problem`` on the design field)."""
    x = np.asarray(x)
    nely, nelx = x.shape
    if (nelx, nely) == (orig_nelx, orig_nely):
        return x
    if nelx < orig_nelx or nely < orig_nely:
        raise ValueError(f"density {nelx}x{nely} smaller than original "
                         f"mesh {orig_nelx}x{orig_nely}")
    g = x.reshape(nelx, nely)[:orig_nelx, :orig_nely]
    return g.reshape(orig_nely, orig_nelx)


class BatchProblem(NamedTuple):
    """B load cases stacked on one (nelx, nely) mesh. edof/KE/penalty are
    mesh properties and stay unbatched; loads and supports are per slot."""
    nelx: int
    nely: int
    edof: torch.Tensor         # (ne, 8) shared
    KE: torch.Tensor           # (8, 8) shared
    f: torch.Tensor            # (B, ndof)
    free_mask: torch.Tensor    # (B, ndof)
    fixed_x_mask: torch.Tensor  # (B, ndof)
    volfrac: torch.Tensor      # (B,)
    penal: float = 3.0
    e_min: float = 1e-9
    elem_mask: Optional[torch.Tensor] = None   # (B, nely, nelx) or None

    @property
    def batch(self) -> int:
        return self.f.shape[0]

    def to(self, device) -> "BatchProblem":
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})


def stack_problems(probs, device="cuda") -> BatchProblem:
    """Stack same-mesh Problems (slot order kept) onto ``device`` (the card
    unless the caller asks for the CPU). If any problem carries an
    elem_mask, every slot gets one (all-ones for the others)."""
    dev = resolve_device(device)
    p0 = probs[0]
    for p in probs[1:]:
        if (p.nelx, p.nely) != (p0.nelx, p0.nely):
            raise ValueError("all problems in a batch must share one mesh; "
                             f"got {p.nelx}x{p.nely} vs {p0.nelx}x{p0.nely}")
        if p.penal != p0.penal or p.e_min != p0.e_min:
            raise ValueError("SIMP penalty/e_min must match across a batch")
    elem_mask = None
    if any(p.elem_mask is not None for p in probs):
        ones = torch.ones((p0.nely, p0.nelx))
        elem_mask = torch.stack([ones if p.elem_mask is None
                                 else _f32(p.elem_mask) for p in probs])
    bp = BatchProblem(
        nelx=p0.nelx, nely=p0.nely, edof=p0.edof, KE=p0.KE,
        f=torch.stack([p.f for p in probs]),
        free_mask=torch.stack([p.free_mask for p in probs]),
        fixed_x_mask=torch.stack([p.fixed_x_mask for p in probs]),
        volfrac=torch.tensor([float(p.volfrac) for p in probs],
                             dtype=torch.float32),
        penal=p0.penal, e_min=p0.e_min, elem_mask=elem_mask)
    return bp.to(dev)


# ---------------------------------------------------------------------------
# Batch-invariant reductions and the structured-mesh stencil
# ---------------------------------------------------------------------------


def tree_sum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum along ``dim`` in one fixed balanced-tree order: zero-pad to a
    power of two and fold halves, x[:h] + x[h:]. Every output sums its
    inputs in the same order whatever the surrounding batch shape."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def tree_dot(a, b, dim: int = -1):
    return tree_sum(a * b, dim)


def tree_norm(a, dim: int = -1):
    return torch.sqrt(tree_sum(a * a, dim))


def simp_pow(x: torch.Tensor, penal: float) -> torch.Tensor:
    """x ** penal, with the integer penalties as explicit products in a
    fixed order ((x*x)*x for 3) — the order the CG kernel uses too."""
    if penal == 3.0:
        return x * x * x
    if penal == 2.0:
        return x * x
    return x ** penal


def _ke_apply(KE, ue):
    """(KE @ ue_e) per element, contraction unrolled in a fixed order.
    ue: (..., 8)."""
    acc = ue[..., 0:1] * KE[:, 0]
    for j in range(1, 8):
        acc = acc + ue[..., j:j + 1] * KE[:, j]
    return acc


def _ue_slices(Ug):
    """Element-local dofs as slices of the (B, nelx+1, nely+1, 2) dof grid,
    in edof order [n1 n2 n3 n4] x [x y]. Returns (B, nelx, nely, 8)."""
    n1 = Ug[:, :-1, :-1, :]        # node (ex,   ey)
    n2 = Ug[:, 1:, :-1, :]         # node (ex+1, ey)
    n3 = Ug[:, 1:, 1:, :]          # node (ex+1, ey+1)
    n4 = Ug[:, :-1, 1:, :]         # node (ex,   ey+1)
    return torch.cat([n1, n2, n3, n4], dim=-1)


def _assemble(fe):
    """Per-element dof contributions (B, nelx, nely, 8) -> nodal dof grid
    (B, nelx+1, nely+1, 2): four zero-padded shifted slices added in the
    fixed order (c1 + c2) + (c3 + c4). No scatter, so deterministic."""
    c1 = F.pad(fe[..., 0:2], (0, 0, 0, 1, 0, 1))
    c2 = F.pad(fe[..., 2:4], (0, 0, 0, 1, 1, 0))
    c3 = F.pad(fe[..., 4:6], (0, 0, 1, 0, 1, 0))
    c4 = F.pad(fe[..., 6:8], (0, 0, 1, 0, 0, 1))
    return (c1 + c2) + (c3 + c4)


def _simp_e(bp: BatchProblem, X):
    e = bp.e_min + simp_pow(X.reshape(X.shape[0], -1), bp.penal) \
        * (1 - bp.e_min)
    if bp.elem_mask is not None:
        e = e * bp.elem_mask.reshape(X.shape[0], -1)
    return e


def _e_grid(bp: BatchProblem, X):
    """SIMP stiffness on the (nelx, nely) element grid (reshape, not
    transpose). Passive elements get exactly zero stiffness."""
    B, nely, nelx = X.shape
    e = bp.e_min + simp_pow(X.reshape(B, nelx, nely), bp.penal) \
        * (1 - bp.e_min)
    if bp.elem_mask is not None:
        e = e * bp.elem_mask.reshape(B, nelx, nely)
    return e


def stiffness_apply_b(bp: BatchProblem, X, U):
    """Batched matrix-free K(x) u. X: (B, nely, nelx); U: (B, ndof)."""
    B, nely, nelx = X.shape
    Ug = U.reshape(B, nelx + 1, nely + 1, 2)
    fe = _e_grid(bp, X)[..., None] * _ke_apply(bp.KE, _ue_slices(Ug))
    return _assemble(fe).reshape(B, -1) * bp.free_mask


def jacobi_diag(bp: BatchProblem, X):
    """Diagonal of K(x) per slot (B, ndof), 1.0 where it is not positive."""
    B = X.shape[0]
    diag = _assemble(_e_grid(bp, X)[..., None]
                     * torch.diagonal(bp.KE)).reshape(B, -1)
    return torch.where(diag > 0, diag, torch.ones_like(diag))


def compliance_and_sens_b(bp: BatchProblem, X, U):
    """Batched compliance and SIMP sensitivity: ((B,), (B, nely, nelx))."""
    B, nely, nelx = X.shape
    ue = _ue_slices(U.reshape(B, nelx + 1, nely + 1, 2))
    ce = tree_sum(ue * _ke_apply(bp.KE, ue), dim=-1)    # (B, nelx, nely)
    ce = ce.reshape(B, -1)                              # el = ex*nely + ey
    e = _simp_e(bp, X)
    c = tree_sum(e * ce, dim=-1)
    xf = X.reshape(B, -1)
    if bp.elem_mask is not None:
        # border elements share nodes with active ones: mask explicitly
        ce = ce * bp.elem_mask.reshape(B, -1)
    dc = -bp.penal * simp_pow(xf, bp.penal - 1) * (1 - bp.e_min) * ce
    return c, dc.reshape(X.shape)


def load_volume_b(bp: BatchProblem) -> torch.Tensor:
    """(B, 4, nely+1, nelx+1, 1) TrunkNet inputs [Fx, Fy, supp_x, supp_y]."""
    B = bp.batch
    nx, ny = bp.nelx + 1, bp.nely + 1

    def img(v):
        return v.reshape(B, nx, ny).transpose(1, 2)

    vol = torch.stack([img(bp.f[:, 0::2]), img(bp.f[:, 1::2]),
                       img(bp.fixed_x_mask[:, 0::2]),
                       img(bp.fixed_x_mask[:, 1::2])], dim=1)
    return vol[..., None].contiguous()


def load_volume(prob: Problem) -> torch.Tensor:
    """(4, nely+1, nelx+1, 1) TrunkNet input of one problem, on the
    problem's device."""
    return load_volume_b(stack_problems([prob], device=prob.f.device))[0]


def solve_b(bp: BatchProblem, X, tol: float = 1e-6, max_iter: int = 2000,
            U0=None, need=None):
    """Batched Jacobi-PCG with per-slot convergence (``fea2d.solve_b``):
    returns (U (B, ndof), per-slot iterations (B,) int32). A slot with
    f == 0 converges in zero iterations; a slot with need=False keeps its
    warm start. CUDA tensors run the ``solve_b_fused`` kernel, CPU tensors
    its plain version."""
    from repro_torch.kernels.cg_fused import solve_b_fused
    return solve_b_fused(bp, X, tol=tol, max_iter=max_iter, U0=U0, need=need)


# ---------------------------------------------------------------------------
# Single problem (run_hybrid metrics, run_simp): width-2 batches
# ---------------------------------------------------------------------------


def _pair(prob: Problem, device) -> BatchProblem:
    # width 2 (the problem plus an idle slot), the minimum width of the
    # serving path's slot-invariance; the idle slot costs no CG iterations
    idle = idle_problem(prob.nelx, prob.nely)
    if prob.elem_mask is not None:
        idle = idle._replace(elem_mask=torch.ones_like(prob.elem_mask))
    return stack_problems([prob, idle], device=device)


def solve(prob: Problem, x_phys, tol: float = 1e-6, max_iter: int = 2000,
          u0=None):
    """Solve one problem. Returns (u (ndof,), iterations)."""
    bp = _pair(prob, x_phys.device)
    X = torch.stack([x_phys, torch.zeros_like(x_phys)])
    U0 = None if u0 is None else torch.stack([u0, torch.zeros_like(u0)])
    U, its = solve_b(bp, X, tol=tol, max_iter=max_iter, U0=U0)
    return U[0], its[0]


def compliance_and_sens(prob: Problem, x_phys, u):
    """Compliance u^T K u and SIMP sensitivity of one problem."""
    bp = _pair(prob, x_phys.device)
    c, dc = compliance_and_sens_b(
        bp, torch.stack([x_phys, torch.zeros_like(x_phys)]),
        torch.stack([u, torch.zeros_like(u)]))
    return c[0], dc[0]
