"""Hybrid NN-FEA topology optimization (paper §VI-A): the counterpart of
``repro.fea.hybrid``.

``hist_len`` FEA warm-up iterations seed CRONet's recurrent context; after
that each iteration uses CRONet's displacement while the last measured
error ||u_pred - u_fea|| / ||u_fea|| is below ``error_threshold``, with a
forced FEA verification every ``verify_every`` iterations, per slot. One
batch-first step function drives both ``run_hybrid`` (one problem, padded
to width 2) and the serving engine (``serve/topo_service.py``).

Dispatch, in place of the JAX knobs ``backend=`` / ``fea_backend=`` (which
chose between numerically equal paths): on a CUDA device the tick's
CRONet forward always runs the ``cronet_fused`` kernel and its FEA fallback
always runs the ``solve_b_fused`` kernel; on the CPU both run their plain
versions. The JAX step's ``hybrid_compiles_total`` counter counts XLA
retraces and has no counterpart here: PyTorch runs eagerly.

The tick keeps the reference's two skips — no forward while no slot is
warm, and no solve (``u_fea = state.u``, zero CG iterations) while no slot
needs FEA. Each is decided on the host, so the tick synchronises with the
device twice.

Lane operations (``reset_slot``, ``restore_slot``, ``move_slot``) write
into the state's tensors in place — the JAX versions build new arrays —
and return the same state. ``make_hybrid_step``'s step never writes into
the state it is given.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common import Params, map_params, resolve_device
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.core import cronet
from repro_torch.fea import fea2d, simp
from repro_torch.kernels.cronet_pipeline import cronet_fused
from repro_torch.optim.compress import dequantize_int8, quantize_int8

_INPUT_DTYPE = {"fp32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.float32}


def cast_params(params: Params, precision: str) -> Params:
    """fp32 | bf16 | int8 (fake-quant weights, per-tensor symmetric)."""
    if precision == "fp32":
        return map_params(lambda p: p.float(), params)
    if precision == "bf16":
        return map_params(lambda p: p.bfloat16(), params)
    if precision == "int8":
        return map_params(lambda p: dequantize_int8(*quantize_int8(p)),
                          params)
    raise ValueError(precision)


class HybridState(NamedTuple):
    """Stacked per-slot optimization state (leading axis B)."""
    x: torch.Tensor           # (B, nely, nelx) densities
    u: torch.Tensor           # (B, ndof) last accepted displacement
    hist: torch.Tensor        # (B, T, nely, nelx) density ring, oldest first
    it: torch.Tensor          # (B,) int32 per-slot iteration counter
    err: torch.Tensor         # (B,) last measured CRONet relative L2 error
    n_cronet: torch.Tensor    # (B,) int32 accepted-surrogate iterations
    n_fea: torch.Tensor       # (B,) int32 FEA iterations
    compliance: torch.Tensor  # (B,) compliance of the last iteration
    cg_iters: torch.Tensor    # (B,) int32 cumulative CG iterations


def init_state(cfg: CRONetConfig, bp: fea2d.BatchProblem) -> HybridState:
    """Fresh state on ``bp``'s device: uniform volfrac density, cold
    history; a shape-padded batch starts with its border at 0."""
    B, dev = bp.batch, bp.f.device
    x0 = bp.volfrac[:, None, None].expand(B, bp.nely, bp.nelx).clone()
    if bp.elem_mask is not None:
        x0 = x0 * bp.elem_mask
    i32 = dict(dtype=torch.int32, device=dev)
    return HybridState(
        x=x0, u=torch.zeros_like(bp.f),
        hist=torch.zeros((B, cfg.hist_len, bp.nely, bp.nelx), device=dev),
        it=torch.zeros((B,), **i32),
        err=torch.full((B,), float("inf"), device=dev),
        n_cronet=torch.zeros((B,), **i32), n_fea=torch.zeros((B,), **i32),
        compliance=torch.zeros((B,), device=dev),
        cg_iters=torch.zeros((B,), **i32))


def reset_slot(cfg: CRONetConfig, state: HybridState, i: int,
               volfrac: float, elem_mask=None) -> HybridState:
    """Re-initialize slot i in place (serving refill after completion).
    ``elem_mask`` (nely, nelx) zeroes the passive shape-class border."""
    x0 = torch.full(state.x.shape[1:], float(volfrac), device=state.x.device)
    if elem_mask is not None:
        x0 = x0 * elem_mask.to(state.x.device)
    state.x[i] = x0
    state.u[i] = 0.0
    state.hist[i] = 0.0
    state.it[i] = 0
    state.err[i] = float("inf")
    state.n_cronet[i] = 0
    state.n_fea[i] = 0
    state.compliance[i] = 0.0
    state.cg_iters[i] = 0
    return state


def park_slot(state: HybridState, i: int) -> HybridState:
    """Lane i as host numpy arrays (preemption parking): a complete
    per-slot snapshot that ``restore_slot`` puts back exactly."""
    return HybridState(*[leaf[i].cpu().numpy().copy() for leaf in state])


def restore_slot(state: HybridState, i: int,
                 parked: HybridState) -> HybridState:
    """Write a parked lane snapshot into slot i, in place."""
    for leaf, v in zip(state, parked):
        leaf[i] = torch.as_tensor(v).to(leaf.device)
    return state


def move_slot(state: HybridState, src: int, dst: int) -> HybridState:
    """Copy lane src over lane dst in place (ladder compaction); src's old
    lane is left behind for the caller to reseed or slice away."""
    for leaf in state:
        leaf[dst] = leaf[src]
    return state


def resize_state(state: HybridState, new_b: int) -> HybridState:
    """Re-width the state to ``new_b`` lanes. Shrinking slices off the tail
    (callers compact live lanes first); growing appends idle lanes shaped
    like ``init_state`` output."""
    B = state.x.shape[0]
    if new_b == B:
        return state
    if new_b < B:
        return HybridState(*[leaf[:new_b].clone() for leaf in state])
    n = new_b - B

    def pad(leaf, fill):
        extra = torch.full((n,) + tuple(leaf.shape[1:]), fill,
                           dtype=leaf.dtype, device=leaf.device)
        return torch.cat([leaf, extra], dim=0)

    return HybridState(
        x=pad(state.x, 0.5), u=pad(state.u, 0.0), hist=pad(state.hist, 0.0),
        it=pad(state.it, 0), err=pad(state.err, float("inf")),
        n_cronet=pad(state.n_cronet, 0), n_fea=pad(state.n_fea, 0),
        compliance=pad(state.compliance, 0.0),
        cg_iters=pad(state.cg_iters, 0))


@functools.lru_cache(maxsize=32)
def make_hybrid_step(cfg: CRONetConfig, u_scale: float,
                     error_threshold: float = 0.05, verify_every: int = 3,
                     rmin: float = 1.5, precision: str = "bf16") -> Callable:
    """The batched iteration

        step(params, bp: BatchProblem, load_vol (B,4,H,W,1), state) -> state

    on whatever device its tensors are on. Whenever FEA runs for a warm
    slot, CRONet's prediction for that state is scored against it; the
    slot uses CRONet while the last error is under ``error_threshold``
    (strict ``<``), except every ``verify_every``-th iteration. FEA runs
    once, batched, for the slots that need it."""
    dtype = _INPUT_DTYPE[precision]
    filt_b = simp.make_filter_b(cfg.nelx, cfg.nely, rmin)
    filt_mask_b = simp.make_filter_b(cfg.nelx, cfg.nely, rmin, masked=True)

    def step(params: Params, bp: fea2d.BatchProblem, load_vol,
             state: HybridState) -> HybridState:
        warm = state.it >= cfg.hist_len
        if bool(warm.any()):
            pred = cronet_fused(cfg, params, load_vol.to(dtype),
                                state.hist[..., None].to(dtype))
            u_pred = (cronet.decode_to_dofs(cfg, pred) * u_scale
                      * bp.free_mask)
        else:    # no slot can consume or score a prediction yet
            u_pred = torch.zeros_like(bp.f)
        use_cronet = (warm & (state.err < error_threshold)
                      & (state.it % verify_every != 0))
        need_fea = ~use_cronet
        if bool(need_fea.any()):
            u_fea, cg_its = fea2d.solve_b(bp, state.x, U0=state.u,
                                          need=need_fea)
        else:
            u_fea, cg_its = state.u, torch.zeros_like(state.cg_iters)

        # batch-invariant norms: err is compared against the threshold
        un = fea2d.tree_norm(u_fea)
        err_new = fea2d.tree_norm(u_pred - u_fea) / torch.clamp_min(un, 1e-30)
        err = torch.where(need_fea & warm, err_new, state.err)
        u = torch.where(use_cronet[:, None], u_pred, u_fea)

        c, dc = fea2d.compliance_and_sens_b(bp, state.x, u)
        hist = torch.roll(state.hist, -1, dims=1)   # a new tensor
        hist[:, -1] = state.x                       # written in place
        if bp.elem_mask is None:
            dc_f = filt_b(state.x, dc)
            dv = torch.ones_like(state.x[0]) / (cfg.nelx * cfg.nely)
            x = simp.oc_update_b(state.x, dc_f, dv, bp.volfrac)
        else:
            dc_f = filt_mask_b(state.x, dc, bp.elem_mask)
            # mean-over-ACTIVE-elements volume: gradient 1/active per slot
            active = torch.clamp_min(fea2d.tree_sum(
                bp.elem_mask.reshape(state.x.shape[0], -1)), 1.0)
            dv = torch.ones_like(state.x) / active[:, None, None]
            x = simp.oc_update_b(state.x, dc_f, dv, bp.volfrac,
                                 mask=bp.elem_mask)
        return HybridState(
            x=x, u=u, hist=hist, it=state.it + 1, err=err,
            n_cronet=state.n_cronet + use_cronet.to(torch.int32),
            n_fea=state.n_fea + need_fea.to(torch.int32), compliance=c,
            cg_iters=state.cg_iters + cg_its.to(torch.int32))

    return step


@dataclasses.dataclass
class HybridResult:
    cronet_invocations: int
    fea_invocations: int
    final_compliance: float
    reference_compliance: float
    solution_accuracy: float   # 100 * (1 - |c - c_ref| / c_ref)
    design_match: float        # 100 * (1 - mean |x - x_ref|)
    compliances: np.ndarray
    density: Optional[np.ndarray] = None   # (nely, nelx) final design


def run_hybrid(cfg: CRONetConfig, params: Params, u_scale: float,
               n_iter: int = 100, error_threshold: float = 0.05,
               verify_every: int = 3, rmin: float = 1.5,
               reference: Optional[dict] = None, precision: str = "bf16",
               problem: Optional[fea2d.Problem] = None,
               compute_metrics: bool = True,
               device="cuda") -> HybridResult:
    """Run the hybrid loop for one problem, padded to a width-2 batch (the
    minimum width of the slot-invariance contract, hybrid.py:332-336).
    ``reference``: optional pure-FEA history from ``simp.run_simp``;
    ``compute_metrics=False`` skips the reference and the final FEA
    evaluation, leaving the metric fields NaN."""
    dev = resolve_device(device)
    prob = problem if problem is not None else fea2d.mbb_problem(cfg.nelx,
                                                                 cfg.nely)
    params = cast_params(map_params(lambda p: p.to(dev), params), precision)
    bp = fea2d.stack_problems([prob, fea2d.idle_problem(cfg.nelx, cfg.nely)],
                              device=dev)
    load_vol = fea2d.load_volume_b(bp)
    step = make_hybrid_step(cfg, u_scale, error_threshold, verify_every,
                            rmin, precision)
    state = init_state(cfg, bp)
    cs = []
    for _ in range(n_iter):
        state = step(params, bp, load_vol, state)
        cs.append(state.compliance[0])
    cs = [float(c) for c in cs]
    x = state.x[0]
    n_cronet = int(state.n_cronet[0])
    n_fea = int(state.n_fea[0])
    if not compute_metrics:
        return HybridResult(
            cronet_invocations=n_cronet, fea_invocations=n_fea,
            final_compliance=float("nan"), reference_compliance=float("nan"),
            solution_accuracy=float("nan"), design_match=float("nan"),
            compliances=np.asarray(cs), density=x.cpu().numpy())
    if reference is None:
        _, reference = simp.run_simp(prob, n_iter=n_iter, rmin=rmin,
                                     device=dev)
    c_ref = float(reference["c"][-1])
    # solution quality: FEA-evaluated compliance of the final design
    u_fin, _ = fea2d.solve(prob, x, u0=state.u[0])
    c_fin = float(fea2d.compliance_and_sens(prob, x, u_fin)[0])
    acc = 100.0 * max(0.0, 1.0 - abs(c_fin - c_ref) / abs(c_ref))
    xn = x.cpu().numpy()
    dm = 100.0 * float(1.0 - np.mean(np.abs(xn - reference["x"][-1])))
    return HybridResult(
        cronet_invocations=n_cronet, fea_invocations=n_fea,
        final_compliance=c_fin, reference_compliance=c_ref,
        solution_accuracy=acc, design_match=dm, compliances=np.asarray(cs),
        density=xn)
