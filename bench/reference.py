"""The plain reference the benchmark holds the served designs to.

One hybrid NN-FEA iteration of paper §VI-A for a batch of independent
lanes, in plain PyTorch, from each lane's state (its densities, history,
displacement, iteration count and scored error), its load case and the
weights:

* CRONet (paper Table I): the trunk's 3-D convolutions, AAP3D and FC
  stack, the branch's time-distributed 2-D convolutions, max pool, AAP2D,
  tanh RNN and FC stack, their product, written here with
  ``torch.nn.functional`` in channels-first layouts; the decoder's
  antialiased bilinear resize to the nodal grid.
* The FEA fallback and the SIMP stages, a frozen copy of the served
  algorithm: the 88-line Q4 stiffness, the masked batched Jacobi-PCG
  (tol 1e-6, 2,000 iterations at most, warm-started), compliance and
  sensitivity, the 3x3 sensitivity filter, the 60-step OC bisection.
  Every sum is the balanced tree of ``tree_sum`` and every product an
  explicit op in a fixed order, so each lane's result is the same at any
  batch width and the FEA stages agree with the served ones to the bit.
* The error gate: CRONet's displacement on a warm lane while the last
  scored error is under the threshold, except each ``verify_every``-th
  iteration.

It imports nothing of the program. Run it in float32 with TF32 off;
``lowp=True`` is the control: the same arithmetic with TF32 allowed in the
convolutions and products (on a CPU, their operands rounded to TF32).
"""
from __future__ import annotations

import contextlib
from typing import Dict, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

E_MIN, PENAL, NU = 1e-9, 3.0, 0.3
HIST_LEN, P = 10, 2560


# ------------------------------------------------------------ the weights

def weight_shapes() -> Dict[str, Dict[str, tuple]]:
    """Table I's weights in the served layouts: DHWIO / HWIO convolutions,
    (K, N) products."""
    return {
        "branch": {"conv1": (3, 3, 1, 16), "conv2": (3, 3, 16, 32),
                   "fc1": (64, 40), "fc2": (40, P), "rnn_wh": (64, 64),
                   "rnn_wx": (32, 64)},
        "trunk": {"conv1": (2, 3, 3, 1, 16), "conv2": (1, 3, 3, 16, 64),
                  "fc1": (4800, 40), "fc2": (40, P)},
    }


def make_weights(seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Weights drawn from ``seed`` on ``device`` in one call: N(0, 1)
    scaled by 1/sqrt(fan-in = shape[0]), float32, leaves in sorted order."""
    shapes = weight_shapes()
    leaves = [(part, name, shapes[part][name]) for part in sorted(shapes)
              for name in sorted(shapes[part])]
    sizes = [int(np.prod(s)) for _, _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out: Dict[str, Dict[str, torch.Tensor]] = {p: {} for p in shapes}
    for (part, name, shape), chunk in zip(leaves, flat.split(sizes)):
        out[part][name] = chunk.reshape(shape) / float(np.sqrt(shape[0]))
    return out


# ------------------------------------------------------------- CRONet

def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits, to nearest even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _Prec:
    """Operand rounding of the convolutions and products: identity in
    float32; TF32 on the CPU for the control (CUDA runs real TF32)."""

    def __init__(self, emulate_tf32: bool):
        self.r = _tf32 if emulate_tf32 else (lambda t: t)

    def conv3d(self, x, w, pad):
        return F.conv3d(F.pad(self.r(x), pad), self.r(w))

    def conv2d(self, x, w):
        return F.conv2d(self.r(x), self.r(w), padding=1)

    def mm(self, a, b):
        return self.r(a) @ self.r(b)


def cronet(params, load_vol, hist, prec: _Prec):
    """load_vol (B, 4, ny+1, nx+1), hist (B, T, ny, nx) -> (B, P)."""
    t, b = params["trunk"], params["branch"]
    B = load_vol.shape[0]
    # trunk: depth is the stack [Fx, Fy, supp_x, supp_y]; depth padded
    # causally (0, kd - 1), rows and columns SAME
    x = load_vol[:, None]                                 # (B, 1, 4, H, W)
    x = F.silu(prec.conv3d(x, t["conv1"].permute(4, 3, 0, 1, 2),
                           (1, 1, 1, 1, 0, 1)))
    x = F.silu(prec.conv3d(x, t["conv2"].permute(4, 3, 0, 1, 2),
                           (1, 1, 1, 1, 0, 0)))
    x = F.adaptive_avg_pool3d(x, (3, 5, 5))               # (B, 64, 3, 5, 5)
    x = x.permute(0, 2, 3, 4, 1).reshape(B, -1)           # (d, h, w, c)
    trunk = prec.mm(F.silu(prec.mm(x, t["fc1"])), t["fc2"])
    # branch: every history frame through the same CNN, then the RNN
    T = hist.shape[1]
    y = hist.reshape(B * T, 1, *hist.shape[2:])
    y = F.silu(prec.conv2d(y, b["conv1"].permute(3, 2, 0, 1)))
    y = F.silu(prec.conv2d(y, b["conv2"].permute(3, 2, 0, 1)))
    y = F.max_pool2d(y, 2)                                # floor windows
    feats = y.mean(dim=(2, 3)).reshape(B, T, -1)          # AAP2D (1, 1)
    h = torch.zeros((B, b["rnn_wh"].shape[0]), device=hist.device)
    for i in range(T):
        h = torch.tanh(prec.mm(feats[:, i], b["rnn_wx"])
                       + prec.mm(h, b["rnn_wh"]))
    branch = prec.mm(F.silu(prec.mm(h, b["fc1"])), b["fc2"])
    return branch * trunk


def decode_to_dofs(u_vec, nelx: int, nely: int):
    """(B, P) -> (B, ndof): the (32, 40, 2) grid resized bilinearly, with
    antialiasing, to the (ny+1, nx+1) nodes, in the 88-line dof layout
    (node n = x * (nely + 1) + y)."""
    B = u_vec.shape[0]
    grid = u_vec.reshape(B, 32, 40, 2).permute(0, 3, 1, 2)
    out = F.interpolate(grid, size=(nely + 1, nelx + 1), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.permute(0, 3, 2, 1).reshape(B, -1)


# --------------------------------------------------------- the FEA stages

def element_stiffness() -> np.ndarray:
    nu = NU
    k = np.array([1 / 2 - nu / 6, 1 / 8 + nu / 8, -1 / 4 - nu / 12,
                  -1 / 8 + 3 * nu / 8, -1 / 4 + nu / 12, -1 / 8 - nu / 8,
                  nu / 6, 1 / 8 - 3 * nu / 8])
    idx = [[0, 1, 2, 3, 4, 5, 6, 7], [1, 0, 7, 6, 5, 4, 3, 2],
           [2, 7, 0, 5, 6, 3, 4, 1], [3, 6, 5, 0, 7, 2, 1, 4],
           [4, 5, 6, 7, 0, 1, 2, 3], [5, 4, 3, 2, 1, 0, 7, 6],
           [6, 3, 4, 1, 2, 7, 0, 5], [7, 2, 1, 4, 3, 6, 5, 0]]
    return 1 / (1 - nu ** 2) * k[np.array(idx)]


def tree_sum(x, dim: int = -1):
    """Sum in one balanced tree: zero-pad to a power of two, fold halves."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def tree_norm(a):
    return torch.sqrt(tree_sum(a * a))


class Mesh(NamedTuple):
    nelx: int
    nely: int
    KE: torch.Tensor      # (8, 8) float32


def make_mesh(nelx: int, nely: int, device) -> Mesh:
    return Mesh(nelx, nely, torch.as_tensor(element_stiffness(),
                                            dtype=torch.float32,
                                            device=device))


def _ke_apply(KE, ue):
    acc = ue[..., 0:1] * KE[:, 0]
    for j in range(1, 8):
        acc = acc + ue[..., j:j + 1] * KE[:, j]
    return acc


def _ue(Ug):
    return torch.cat([Ug[:, :-1, :-1, :], Ug[:, 1:, :-1, :],
                      Ug[:, 1:, 1:, :], Ug[:, :-1, 1:, :]], dim=-1)


def _assemble(fe):
    c1 = F.pad(fe[..., 0:2], (0, 0, 0, 1, 0, 1))
    c2 = F.pad(fe[..., 2:4], (0, 0, 0, 1, 1, 0))
    c3 = F.pad(fe[..., 4:6], (0, 0, 1, 0, 1, 0))
    c4 = F.pad(fe[..., 6:8], (0, 0, 1, 0, 0, 1))
    return (c1 + c2) + (c3 + c4)


def _stiff(X):
    # the densities' (nely, nelx) buffer read as the (nelx, nely) grid
    B, nely, nelx = X.shape
    Xg = X.reshape(B, nelx, nely)
    return E_MIN + Xg * Xg * Xg * (1 - E_MIN)


def k_apply(m: Mesh, X, U, free):
    B = X.shape[0]
    Ug = U.reshape(B, m.nelx + 1, m.nely + 1, 2)
    fe = _stiff(X)[..., None] * _ke_apply(m.KE, _ue(Ug))
    return _assemble(fe).reshape(B, -1) * free


def pcg(m: Mesh, X, f, free, U0, need, tol: float = 1e-6,
        max_iter: int = 2000, chunk: int = 32):
    """Masked batched Jacobi-PCG; a lane with need False keeps U0. A lane
    stops on its own criterion and is frozen from then on, so running
    further iterations changes nothing: the loop tests for the end every
    ``chunk`` iterations, which on a card replay one CUDA graph."""
    B = X.shape[0]
    Fv = f * free
    diag = _assemble(_stiff(X)[..., None]
                     * torch.diagonal(m.KE)).reshape(B, -1)
    diag = torch.where(diag > 0, diag, torch.ones_like(diag))
    U = U0 * free
    R = Fv - k_apply(m, X, U, free)
    Pd = R / diag * free
    RZ = tree_sum(R * Pd)
    fnorm = tree_norm(Fv)
    its = torch.zeros((B,), dtype=torch.int32, device=X.device)

    def active(R, its):
        return (need & (tree_norm(R) > tol * fnorm) & (fnorm > 0)
                & (its < max_iter))

    act = active(R, its)

    def body():
        KP = k_apply(m, X, Pd, free)
        alpha = RZ / torch.clamp_min(tree_sum(Pd * KP), 1e-30)
        U_n = U + alpha[:, None] * Pd
        R_n = R - alpha[:, None] * KP
        Z = R_n / diag * free
        RZ_n = tree_sum(R_n * Z)
        P_n = Z + (RZ_n / torch.clamp_min(RZ, 1e-30))[:, None] * Pd
        a = act[:, None]
        U.copy_(torch.where(a, U_n, U))
        R.copy_(torch.where(a, R_n, R))
        Pd.copy_(torch.where(a, P_n, Pd))
        RZ.copy_(torch.where(act, RZ_n, RZ))
        its.add_(act.to(torch.int32))
        act.copy_(active(R, its))

    def run_chunk():
        for _ in range(chunk):
            body()

    if X.device.type == "cuda" and bool(act.any()):
        side = torch.cuda.Stream(X.device)
        side.wait_stream(torch.cuda.current_stream(X.device))
        graph = torch.cuda.CUDAGraph()
        state = [t.clone() for t in (U, R, Pd, RZ, its, act)]
        with torch.cuda.stream(side):
            body()                                  # warm the allocator
        torch.cuda.current_stream(X.device).wait_stream(side)
        for t, s in zip((U, R, Pd, RZ, its, act), state):
            t.copy_(s)                              # undo the warm step
        with torch.cuda.graph(graph):
            run_chunk()
        run_chunk = graph.replay
    while bool(act.any()):
        run_chunk()
    return U, its


def compliance_and_sens(m: Mesh, X, U):
    B = X.shape[0]
    ue = _ue(U.reshape(B, m.nelx + 1, m.nely + 1, 2))
    ce = tree_sum(ue * _ke_apply(m.KE, ue)).reshape(B, -1)
    xf = X.reshape(B, -1)
    e = E_MIN + xf * xf * xf * (1 - E_MIN)
    c = tree_sum(e * ce)
    dc = -PENAL * (xf * xf) * (1 - E_MIN) * ce
    return c, dc.reshape(X.shape)


def sens_filter(X, DC, rmin: float = 1.5):
    r = int(np.ceil(rmin)) - 1
    B, nely, nelx = X.shape
    taps = [(i, j, float(max(0.0, rmin - np.sqrt((j - r) ** 2
                                                + (i - r) ** 2))))
            for i in range(2 * r + 1) for j in range(2 * r + 1)]

    def conv(a):
        ap = F.pad(a, (r, r, r, r))
        acc = None
        for i, j, w in taps:
            t = ap[:, i:i + nely, j:j + nelx] * w
            acc = t if acc is None else acc + t
        return acc

    num = conv(X * DC)
    den = conv(torch.ones_like(X))
    return num / torch.clamp_min(den * torch.clamp_min(X, 1e-3), 1e-9)


def oc_update(X, DC, volfrac, move: float = 0.2):
    B, nely, nelx = X.shape
    dv = torch.ones_like(X[0]) / (nelx * nely)

    def xnew(lmid):
        be = torch.sqrt(torch.clamp_min(-DC / (dv * lmid[:, None, None]),
                                        1e-30))
        xn = X * be
        xn = torch.minimum(torch.maximum(xn, X - move), X + move)
        return torch.clamp(xn, 0.001, 1.0)

    active = float(nely * nelx)
    l1 = torch.full((B,), 1e-9, device=X.device)
    l2 = torch.full((B,), 1e9, device=X.device)
    for _ in range(60):
        lmid = 0.5 * (l1 + l2)
        vol = tree_sum(xnew(lmid).reshape(B, -1)) / active
        too_much = vol > volfrac
        l1 = torch.where(too_much, lmid, l1)
        l2 = torch.where(too_much, l2, lmid)
    return xnew(0.5 * (l1 + l2))


# ---------------------------------------------------------------- a tick

class State(NamedTuple):
    """A batch of lanes' optimisation state, the program's leaf names."""
    x: torch.Tensor       # (B, nely, nelx) densities
    u: torch.Tensor       # (B, ndof) the displacement carried over
    hist: torch.Tensor    # (B, HIST_LEN, nely, nelx), oldest first
    it: torch.Tensor      # (B,) int32 iterations done
    err: torch.Tensor     # (B,) CRONet's last scored relative error


def fresh(volfrac, nelx: int, nely: int) -> State:
    """A newly admitted lane: uniform ``volfrac`` density, zero
    displacement, empty history, no scored error."""
    B, dev = volfrac.shape[0], volfrac.device
    return State(
        x=volfrac[:, None, None].expand(B, nely, nelx).clone(),
        u=torch.zeros((B, 2 * (nelx + 1) * (nely + 1)), device=dev),
        hist=torch.zeros((B, HIST_LEN, nely, nelx), device=dev),
        it=torch.zeros((B,), dtype=torch.int32, device=dev),
        err=torch.full((B,), float("inf"), device=dev))


def load_volume(f, fixed_x, nelx: int, nely: int):
    """(B, 4, ny+1, nx+1): [Fx, Fy, supp_x, supp_y] as nodal images."""
    B = f.shape[0]

    def img(v):
        return v.reshape(B, nelx + 1, nely + 1).transpose(1, 2)

    return torch.stack([img(f[:, 0::2]), img(f[:, 1::2]),
                        img(fixed_x[:, 0::2]), img(fixed_x[:, 1::2])], dim=1)


@contextlib.contextmanager
def precision(lowp: bool, device):
    """TF32 off for the reference, on for the control (CUDA only)."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(lowp)
    torch.backends.cudnn.allow_tf32 = bool(lowp)
    try:
        yield _Prec(emulate_tf32=lowp and torch.device(device).type != "cuda")
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def tick(params, m: Mesh, f, free, fixed_x, volfrac, s: State, *,
         u_scale: float, error_threshold: float, verify_every: int,
         rmin: float, lowp: bool = False):
    """One hybrid iteration of every lane from its state ``s``:
    ``f``, ``free``, ``fixed_x`` (B, ndof) and ``volfrac`` (B,) float32 on
    the device. A warm lane (``HIST_LEN`` iterations done) takes CRONet's
    displacement while its last scored error is under the threshold,
    except each ``verify_every``-th iteration; the others solve, and a
    warm lane that solved scores CRONet against the solve. Returns the new
    state and the iteration's compliance (B,)."""
    f = f * free
    warm = s.it >= HIST_LEN
    with precision(lowp, f.device) as prec:
        if bool(warm.any()):
            lv = load_volume(f, fixed_x, m.nelx, m.nely)
            u_pred = (decode_to_dofs(cronet(params, lv, s.hist, prec),
                                     m.nelx, m.nely) * u_scale * free)
        else:
            u_pred = torch.zeros_like(f)
    use = warm & (s.err < error_threshold) & (s.it % verify_every != 0)
    need = ~use
    if bool(need.any()):
        u_fea, _ = pcg(m, s.x, f, free, s.u, need)
    else:
        u_fea = s.u
    un = tree_norm(u_fea)
    err_new = tree_norm(u_pred - u_fea) / torch.clamp_min(un, 1e-30)
    err = torch.where(need & warm, err_new, s.err)
    u = torch.where(use[:, None], u_pred, u_fea)
    c, dc = compliance_and_sens(m, s.x, u)
    hist = torch.cat([s.hist[:, 1:], s.x[:, None]], dim=1)
    x = oc_update(s.x, sens_filter(s.x, dc, rmin), volfrac)
    return State(x=x, u=u, hist=hist, it=s.it + 1, err=err), c
