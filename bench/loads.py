"""The general traffic generator: a traffic file's parameters and a seed in,
the requests' load cases and iteration counts out.

The distribution is that of the serving generator of the port's dataset
module (``sample_load_cases``): a point load on a top-edge node, uniform in
x over ``node_frac`` of the edge (default all of it) and kept off the
right-most column, within ``max_angle_deg`` of straight down, of magnitude
in ``mag``, on the MBB supports (left edge fixed in x, the bottom-right
node in y), at volume fraction ``volfrac``. Each quantity takes the
midpoints of ``pool`` equal strata of its range, permuted on its own, so
every seed serves the same set of positions, angles, magnitudes and
iteration counts in another pairing and order. ``node_frac`` [0, 0] with
``max_angle_deg`` 0 is the MBB half-beam's own load, straight down at the
top-left corner.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np


class Pool(NamedTuple):
    """``n`` load cases on one mesh, as float32 arrays (88-line dof
    layout, node n = x * (nely + 1) + y)."""
    f: np.ndarray          # (n, ndof) load, zero on fixed dofs
    free: np.ndarray       # (n, ndof) 1 on free dofs
    fixed_x: np.ndarray    # (n, ndof) the supports' mask
    volfrac: np.ndarray    # (n,)
    node: np.ndarray       # (n,) loaded top-edge node's x
    load: np.ndarray       # (n, 2) (Fx, Fy)


def _strata(rng, n: int, lo: float, hi: float) -> np.ndarray:
    """The midpoints of n equal strata of [lo, hi], shuffled."""
    u = (np.arange(n) + 0.5) / n
    return rng.permutation(lo + (hi - lo) * u)


def mbb_masks(nelx: int, nely: int):
    """(free, fixed_x) of the MBB supports."""
    nd = 2 * (nelx + 1) * (nely + 1)
    fixed = list(range(0, 2 * (nely + 1), 2)) + [nd - 1]
    free = np.ones(nd, np.float32)
    free[fixed] = 0.0
    return free, 1.0 - free


def load_pool(traffic: Dict, nelx: int, nely: int, seed: int) -> Pool:
    spec = traffic["load"]
    n = int(traffic["pool"])
    rng = np.random.default_rng([seed % (1 << 63), 1])
    frac = _strata(rng, n, *spec.get("node_frac", (0.0, 1.0)))
    theta = np.deg2rad(_strata(rng, n, -spec["max_angle_deg"],
                               spec["max_angle_deg"]))
    mag = _strata(rng, n, *spec["mag"])
    node = np.minimum(np.round(frac * nelx).astype(np.int64), nelx - 1)
    load = np.stack([mag * np.sin(theta), -mag * np.cos(theta)], axis=1)
    free, fixed_x = mbb_masks(nelx, nely)
    nd = free.shape[0]
    f = np.zeros((n, nd), np.float64)
    dof = 2 * node * (nely + 1)              # top-edge node (x, 0)
    f[np.arange(n), dof] = load[:, 0]
    f[np.arange(n), dof + 1] = load[:, 1]
    f = (f * free).astype(np.float32)
    return Pool(f=f, free=np.broadcast_to(free, (n, nd)),
                fixed_x=np.broadcast_to(fixed_x, (n, nd)),
                volfrac=np.full(n, spec["volfrac"], np.float32),
                node=node, load=load.astype(np.float32))


def iteration_counts(traffic: Dict, seed: int) -> np.ndarray:
    """The SIMP iteration count of request j is ``counts[j % len]``: every
    value of the traffic's inclusive range equally often, shuffled."""
    lo, hi = traffic["n_iter"]
    n = int(traffic["pool"])
    rng = np.random.default_rng([seed % (1 << 63), 2])
    return rng.permutation(lo + np.arange(n) % (hi - lo + 1)).astype(np.int64)


def case_order(traffic: Dict, seed: int) -> np.ndarray:
    """Request j takes load case ``order[j % pool]``."""
    rng = np.random.default_rng([seed % (1 << 63), 3])
    return rng.permutation(int(traffic["pool"]))
