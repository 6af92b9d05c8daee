"""The benchmark's frozen yardstick: the H100's peaks and the operations and
bytes that each measured piece of work needs.

Counts come from the shapes alone, never from the program: CRONet's from
paper Table I's layer shapes, the CG's from the Q4 stencil at the mesh, the
tick stages' from their per-element arithmetic. A roofline share divides
the least time these counts allow by the measured device time.
"""
from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
PEAK_FP32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12         # HBM3 bytes a second
F32 = 4                          # bytes of a float32 value

# paper Table I's fixed widths (both sizes share them)
T_C1, T_C2, T_DEPTH, T_POOL = 16, 64, 4, (3, 5, 5)
B_C1, B_C2, RNN_HIDDEN, HIST_LEN = 16, 32, 64, 10
MID, P = 40, 2560


def cronet_macs(nelx: int, nely: int) -> Dict[str, int]:
    """Multiply-accumulates of one CRONet forward (one lane), layer by
    layer, as paper Table I counts them: the trunk's first conv at its
    depth-valid positions, the branch's convolutions time-distributed over
    the ``HIST_LEN`` frames of the density history."""
    H, W = nely + 1, nelx + 1
    feats = T_POOL[0] * T_POOL[1] * T_POOL[2] * T_C2
    return {
        "trunk/conv3d1": 3 * H * W * (2 * 3 * 3 * 1 * T_C1),
        "trunk/conv3d2": T_DEPTH * H * W * (1 * 3 * 3 * T_C1 * T_C2),
        "trunk/fc1": feats * MID,
        "trunk/fc2": MID * P,
        "branch/conv2d1": HIST_LEN * nely * nelx * (3 * 3 * 1 * B_C1),
        "branch/conv2d2": HIST_LEN * nely * nelx * (3 * 3 * B_C1 * B_C2),
        "branch/rnn": HIST_LEN * RNN_HIDDEN * (B_C2 + RNN_HIDDEN),
        "branch/fc1": RNN_HIDDEN * MID,
        "branch/fc2": MID * P,
    }


def cronet_params(nelx: int, nely: int) -> int:
    """Weights of the network (419,760 at every Table I size)."""
    feats = T_POOL[0] * T_POOL[1] * T_POOL[2] * T_C2
    trunk = 2 * 3 * 3 * T_C1 + 3 * 3 * T_C1 * T_C2 + feats * MID + MID * P
    branch = (3 * 3 * B_C1 + 3 * 3 * B_C1 * B_C2
              + RNN_HIDDEN * (B_C2 + RNN_HIDDEN) + RNN_HIDDEN * MID + MID * P)
    return trunk + branch


def cronet_flops(nelx: int, nely: int, lanes: int) -> float:
    """Operations of one ``cronet_fused`` call over ``lanes`` lanes: two a
    multiply-accumulate, plus the branch x trunk product."""
    return lanes * (2.0 * sum(cronet_macs(nelx, nely).values()) + P)


def cronet_bytes(nelx: int, nely: int, lanes: int) -> float:
    """Bytes of one fp32 ``cronet_fused`` call: the weights once, each
    lane's load volume and density history read once, its (p,) output
    written once."""
    H, W = nely + 1, nelx + 1
    per_lane = T_DEPTH * H * W + HIST_LEN * nely * nelx + P
    return F32 * (cronet_params(nelx, nely) + lanes * per_lane)


def ndof(nelx: int, nely: int) -> int:
    return 2 * (nelx + 1) * (nely + 1)


def cg_iter_flops(nelx: int, nely: int) -> float:
    """Operations of one Jacobi-PCG iteration of one lane: the stencil
    K(x) p (each element's 8x8 product, 64 multiplies and 56 adds, scaled
    by its SIMP stiffness, 8 multiplies; the assembly's 3 adds a dof) and
    the vector work a dof (two axpys, 4; the preconditioner's divide and
    mask, 2; three dot products, 6; the direction update, 2)."""
    ne = nelx * nely
    return ne * (64 + 56 + 8) + ndof(nelx, nely) * (3 + 4 + 2 + 6 + 2)


def cg_solve_bytes(nelx: int, nely: int, lanes: int) -> float:
    """Bytes of one ``solve_b_fused`` call: per lane the densities, load,
    free mask, warm start and need flag read once, the displacement and the
    iteration count written once (the 8x8 stiffness arrives by value)."""
    n = ndof(nelx, nely)
    return F32 * lanes * (nelx * nely + 3 * n + 1 + n + 1)


# per-element operations of the tick's other stages
COMPLIANCE_ELEM = 64 + 56 + 8 + 7 + 2 + 1 + 4   # ue.KE.ue, x^3, E, dc
FILTER_ELEM = 2 * 9 * 2 + 4                     # two 3x3 sums, the quotient
OC_STEP_ELEM = 9 + 1                            # one bisection step, its sum
OC_STEPS = 60


def tick_stage_flops(nelx: int, nely: int) -> float:
    """Operations of the compliance, the sensitivity filter and the
    60-step OC bisection (plus its final update) for one lane a tick."""
    ne = nelx * nely
    return ne * (COMPLIANCE_ELEM + FILTER_ELEM
                 + (OC_STEPS + 1) * OC_STEP_ELEM)


def roofline_bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: operations at the fp32 peak or
    bytes at HBM bandwidth, whichever is longer."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
