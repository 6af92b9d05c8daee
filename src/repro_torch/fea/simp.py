"""SIMP topology-optimization loop pieces: sensitivity filter and OC
update (the counterpart of ``repro.fea.simp``).

The filter is written as fixed-order shifted adds instead of a
convolution: every output sums its taps in one order on every device and
batch width, so it keeps the serving path's bitwise slot-invariance (a
cuDNN convolution would not promise that). Batched functions take
(B, nely, nelx) fields; the single-problem ones are width-1 views of them.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.fea import fea2d


def _filter_weights(rmin: float):
    r = int(np.ceil(rmin)) - 1
    wy, wx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                         indexing="ij")
    return r, np.maximum(0.0, rmin - np.sqrt(wx ** 2 + wy ** 2))


def make_filter_b(nelx: int, nely: int, rmin: float = 1.5,
                  masked: bool = False) -> Callable:
    """Batched sensitivity filter dc~ = conv(w * x * dc) / (x * conv(w)).

    Returns ``apply(X, DC)``, or ``apply(X, DC, mask)`` with
    ``masked=True``: the normalization then counts active neighbours only
    (``conv(mask)``) and the output is zeroed on passive elements. The conv
    is SAME cross-correlation with zero padding, summed tap by tap in
    row-major order."""
    r, w = _filter_weights(rmin)
    taps = [(i, j, float(w[i, j])) for i in range(2 * r + 1)
            for j in range(2 * r + 1)]

    def conv(a):                                        # (B, nely, nelx)
        ap = F.pad(a, (r, r, r, r))
        acc = None
        for i, j, wij in taps:
            t = ap[:, i:i + nely, j:j + nelx] * wij
            acc = t if acc is None else acc + t
        return acc

    def apply(X, DC, mask=None):
        num = conv(X * DC)
        den = conv(torch.ones_like(X) if mask is None else mask)
        out = num / torch.clamp_min(den * torch.clamp_min(X, 1e-3), 1e-9)
        return out if mask is None else out * mask

    if masked:
        return apply
    return lambda X, DC: apply(X, DC)


def make_filter(nelx: int, nely: int, rmin: float = 1.5) -> Callable:
    """Single-problem filter ``apply(x, dc, mask=None)`` on (nely, nelx)."""
    fb = make_filter_b(nelx, nely, rmin, masked=True)

    def apply(x, dc, mask=None):
        return fb(x[None], dc[None], None if mask is None else mask[None])[0]

    return apply


def oc_update_b(X, DC, dv, volfrac, move: float = 0.2, mask=None):
    """Batched optimality-criteria update, 60-step bisection on the
    Lagrange multiplier per slot. ``volfrac`` is (B,); ``dv`` is one shared
    (nely, nelx) field or a per-slot (B, nely, nelx) stack; ``mask`` freezes
    passive densities at 0 and takes the volume over active elements. The
    volume is a ``tree_sum``: the bisection compares it, so it must not
    depend on the batch width."""
    B = X.shape[0]

    def xnew(lmid):
        be = torch.sqrt(torch.clamp_min(-DC / (dv * lmid[:, None, None]),
                                        1e-30))
        xn = X * be
        xn = torch.minimum(torch.maximum(xn, X - move), X + move)
        xn = torch.clamp(xn, 0.001, 1.0)
        return xn if mask is None else xn * mask

    if mask is None:
        active = float(X.shape[1] * X.shape[2])
    else:
        active = torch.clamp_min(fea2d.tree_sum(mask.reshape(B, -1)), 1.0)
    l1 = torch.full((B,), 1e-9, dtype=X.dtype, device=X.device)
    l2 = torch.full((B,), 1e9, dtype=X.dtype, device=X.device)
    for _ in range(60):
        lmid = 0.5 * (l1 + l2)
        vol = fea2d.tree_sum(xnew(lmid).reshape(B, -1)) / active
        too_much = vol > volfrac
        l1 = torch.where(too_much, lmid, l1)
        l2 = torch.where(too_much, l2, lmid)
    return xnew(0.5 * (l1 + l2))


def oc_update(x, dc, dv, volfrac, move: float = 0.2, mask=None):
    """Single-problem OC update on (nely, nelx) fields."""
    vf = torch.tensor([float(volfrac)], dtype=x.dtype, device=x.device)
    return oc_update_b(x[None], dc[None], dv, vf, move,
                       None if mask is None else mask[None])[0]


class SimpState(NamedTuple):
    x: torch.Tensor            # (nely, nelx) densities
    u: torch.Tensor            # (ndof,) last displacement
    compliance: float
    iteration: int


def run_simp(prob: fea2d.Problem, n_iter: int = 60, rmin: float = 1.5,
             solver: Optional[Callable] = None, record_every: int = 1,
             x0=None, device="cuda"):
    """Reference SIMP loop. solver(x_phys, u_prev) -> (u, c, dc); defaults
    to FEA. Returns (final_state, history dict of numpy arrays)."""
    from repro_torch.common import resolve_device
    dev = resolve_device(device)
    filt = make_filter(prob.nelx, prob.nely, rmin)

    def fea_solver(x_phys, u_prev):
        u, _ = fea2d.solve(prob, x_phys, u0=u_prev)
        c, dc = fea2d.compliance_and_sens(prob, x_phys, u)
        return u, c, dc

    solver = solver or fea_solver
    x = (torch.full((prob.nely, prob.nelx), float(prob.volfrac), device=dev)
         if x0 is None else x0.to(dev))
    u = torch.zeros(prob.f.shape, device=dev)
    dv = torch.ones_like(x) / x.numel()
    xs, us, cs = [], [], []
    for it in range(n_iter):
        u, c, dc = solver(x, u)
        x = oc_update(x, filt(x, dc), dv, prob.volfrac)
        if it % record_every == 0:
            xs.append(x.cpu().numpy())
            us.append(u.cpu().numpy())
            cs.append(float(c))
    state = SimpState(x=x, u=u, compliance=cs[-1], iteration=n_iter)
    return state, {"x": np.stack(xs), "u": np.stack(us), "c": np.asarray(cs)}
