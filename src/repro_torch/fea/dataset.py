"""Multi-load-case trajectory dataset for CRONet training (the
counterpart of ``repro.fea.dataset``).

  * ``LoadCase`` — a declarative load configuration (position, angle,
    magnitude) that builds its ``fea2d.point_load_problem``; the
    registry stores these as the checkpoint's training distribution.
  * ``sample_load_cases`` — the sampler over the serving request space
    (a numpy generator: the same cases as the JAX package for a seed).
  * ``run_simp_b`` — SIMP trajectories for many problems at once through
    the batch axis: ``fea2d.solve_b`` (the ``solve_b_fused`` kernel on
    the card), compliance and sensitivity, the filter, the OC update.
  * ``build_dataset`` — windows the trajectories into one stacked
    ``TrajectoryDataset`` with per-window ``load_vol`` conditioning and
    one shared ``u_scale``.
  * ``harvest_dataset`` / ``concat_datasets`` — the serving-data
    flywheel's data layer.

Datasets are numpy arrays, as in the reference, so they cross between
the two packages unchanged. Trajectories run on ``device`` (the card
unless the caller asks for the CPU) and come to the host once, at the
end.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.fea import fea2d, simp


# ------------------------------------------------------------- load cases


@dataclasses.dataclass(frozen=True)
class LoadCase:
    """One load configuration on the (nelx, nely) MBB-style mesh.

    ``load_frac`` is the load node's x position as a FRACTION of nelx
    (mesh-independent, so a sampled distribution transfers across
    buckets); the load itself is (Fx, Fy) at that top-edge node.
    """
    load_frac: float = 0.0          # x position / nelx, in [0, 1)
    load: Tuple[float, float] = (0.0, -1.0)
    volfrac: float = 0.5
    kind: str = "point"             # "mbb" marks the canonical case

    def load_node(self, nelx: int) -> Tuple[int, int]:
        # keep loads off the right-most column: directly above the
        # bottom-right support the fp32 CG system degenerates
        return (min(int(round(self.load_frac * nelx)), nelx - 1), 0)

    def problem(self, nelx: int, nely: int) -> fea2d.Problem:
        return fea2d.point_load_problem(nelx, nely,
                                        load_node=self.load_node(nelx),
                                        load=self.load,
                                        volfrac=self.volfrac)

    def describe(self) -> Dict:
        """JSON-able metadata for the model registry."""
        return {"kind": self.kind, "load_frac": self.load_frac,
                "load": list(self.load), "volfrac": self.volfrac}

    @classmethod
    def from_dict(cls, d: Dict) -> "LoadCase":
        return cls(load_frac=float(d["load_frac"]),
                   load=tuple(d["load"]), volfrac=float(d["volfrac"]),
                   kind=d.get("kind", "point"))

    @classmethod
    def from_problem(cls, prob, kind: str = "harvest") -> "LoadCase":
        """The load case a point-load problem was built from: the
        serving-traffic harvester's inverse of ``problem()``. The
        dominant loaded node is recovered from the load vector (node id
        ``x * (nely + 1) + y``, 2 dofs per node); a load component the
        boundary conditions zeroed comes back as zero."""
        f = prob.f
        f = (f.detach().cpu().numpy() if isinstance(f, torch.Tensor)
             else np.asarray(f))
        pairs = f.reshape(-1, 2)                      # (n_nodes, 2)
        node = int(np.argmax(np.abs(pairs).sum(axis=1)))
        xn = node // (prob.nely + 1)
        return cls(load_frac=xn / max(prob.nelx, 1),
                   load=(float(pairs[node, 0]), float(pairs[node, 1])),
                   volfrac=float(prob.volfrac), kind=kind)

    def key(self, ndigits: int = 4) -> Tuple:
        """Dedup key: two requests with the same (rounded) load
        configuration regenerate the same trajectory."""
        return (round(self.load_frac, ndigits),
                round(self.load[0], ndigits),
                round(self.load[1], ndigits),
                round(self.volfrac, ndigits))


MBB_CASE = LoadCase(load_frac=0.0, load=(0.0, -1.0), kind="mbb")


def sample_load_cases(n: int, seed: int = 0, include_mbb: bool = True,
                      max_angle_deg: float = 50.0,
                      mag_range: Tuple[float, float] = (0.5, 1.5)
                      ) -> List[LoadCase]:
    """Sample ``n`` load cases from the serving request distribution:
    uniform top-edge position, load direction within ``max_angle_deg``
    of straight down, magnitude in ``mag_range``; with ``include_mbb``
    the canonical MBB load first."""
    rng = np.random.default_rng(seed)
    cases: List[LoadCase] = [MBB_CASE] if include_mbb else []
    while len(cases) < n:
        frac = float(rng.uniform(0.0, 1.0))
        theta = float(np.deg2rad(rng.uniform(-max_angle_deg, max_angle_deg)))
        mag = float(rng.uniform(*mag_range))
        cases.append(LoadCase(
            load_frac=frac,
            load=(mag * np.sin(theta), -mag * np.cos(theta))))
    return cases


# ------------------------------------------------- batched SIMP trajectories


def _make_simp_step_b(nelx: int, nely: int, rmin: float):
    """One batch-first SIMP iteration over a BatchProblem: FEA solve
    (``fea2d.solve_b``: the ``solve_b_fused`` kernel for CUDA tensors),
    compliance and sensitivity, filter, OC update."""
    filt_b = simp.make_filter_b(nelx, nely, rmin)

    def step(bp: fea2d.BatchProblem, X, U):
        dv = torch.full((nely, nelx), 1.0 / (nelx * nely), device=X.device)
        U, _ = fea2d.solve_b(bp, X, U0=U)
        c, dc = fea2d.compliance_and_sens_b(bp, X, U)
        X_new = simp.oc_update_b(X, filt_b(X, dc), dv, bp.volfrac)
        return X_new, U, c

    return step


def run_simp_b(probs: Sequence[fea2d.Problem], n_iter: int = 60,
               rmin: float = 1.5, device="cuda"
               ) -> List[Dict[str, np.ndarray]]:
    """Run SIMP for every problem at once through the batch axis, on
    ``device``. Returns one ``run_simp``-shaped history dict per problem
    (``x``: densities AFTER each OC update, ``u``: the displacement of
    the solve that produced that update, ``c``: compliance)."""
    bp = fea2d.stack_problems(probs, device=resolve_device(device))
    step = _make_simp_step_b(bp.nelx, bp.nely, rmin)
    B = bp.batch
    X = bp.volfrac[:, None, None].expand(B, bp.nely, bp.nelx).contiguous()
    U = torch.zeros_like(bp.f)
    xs, us, cs = [], [], []
    for _ in range(n_iter):
        X, U, c = step(bp, X, U)
        xs.append(X)
        us.append(U)
        cs.append(c)
    # one host transfer at the end instead of a per-iteration sync
    xs = torch.stack(xs).cpu().numpy()          # (T, B, nely, nelx)
    us = torch.stack(us).cpu().numpy()          # (T, B, ndof)
    cs = torch.stack(cs).cpu().numpy()          # (T, B)
    return [{"x": xs[:, b], "u": us[:, b], "c": cs[:, b]} for b in range(B)]


# ----------------------------------------------------------------- dataset


class TrajectoryDataset(NamedTuple):
    """Stacked sliding windows over many SIMP trajectories: one row =
    (density-history window, per-window load conditioning) -> next FEA
    displacement, normalized by ONE shared ``u_scale``."""
    load_vol: np.ndarray    # (N, 4, nely+1, nelx+1, 1) TrunkNet input
    windows: np.ndarray     # (N, T, nely, nelx, 1) BranchNet input
    targets: np.ndarray     # (N, ndof) u / u_scale
    u_scale: float
    traj_id: np.ndarray     # (N,) which trajectory each window came from
    cases: Tuple[LoadCase, ...]
    ref: Dict               # trajectory-0 history (reference metrics)

    @property
    def n_windows(self) -> int:
        return self.windows.shape[0]

    @property
    def n_trajectories(self) -> int:
        return len(self.cases)

    def rows_of(self, traj: int) -> np.ndarray:
        """Window indices belonging to one trajectory."""
        return np.nonzero(self.traj_id == traj)[0]


def window_trajectory(hist: Dict[str, np.ndarray], hist_len: int):
    """Sliding (hist_len)-windows over one SIMP history; the target is
    the displacement of the solve that follows the window."""
    xs, us = hist["x"], hist["u"]
    windows, targets = [], []
    for i in range(hist_len, len(xs)):
        windows.append(xs[i - hist_len:i])
        targets.append(us[i])
    return (np.stack(windows)[..., None].astype(np.float32),
            np.stack(targets).astype(np.float32))


def build_dataset(cfg: CRONetConfig,
                  cases: Optional[Sequence[LoadCase]] = None,
                  n_iter: int = 100, rmin: float = 1.5, seed: int = 0,
                  n_cases: int = 6, batch: int = 8,
                  device="cuda") -> TrajectoryDataset:
    """The stacked multi-trajectory dataset. ``cases`` defaults to
    ``sample_load_cases(n_cases, seed)`` (MBB first); trajectories run
    through ``run_simp_b`` on ``device`` in chunks of ``batch``; ONE
    shared ``u_scale`` (max |u| over all targets) normalizes the set."""
    if cases is None:
        cases = sample_load_cases(n_cases, seed=seed)
    cases = tuple(cases)
    probs = [c.problem(cfg.nelx, cfg.nely) for c in cases]
    hists: List[Dict[str, np.ndarray]] = []
    for lo in range(0, len(probs), batch):
        hists.extend(run_simp_b(probs[lo:lo + batch], n_iter=n_iter,
                                rmin=rmin, device=device))
    load_vols, windows, targets, traj_id = [], [], [], []
    for t, (prob, hist) in enumerate(zip(probs, hists)):
        w, tg = window_trajectory(hist, cfg.hist_len)
        lv = fea2d.load_volume(prob).numpy().astype(np.float32)
        load_vols.append(np.broadcast_to(lv[None], (len(w),) + lv.shape))
        windows.append(w)
        targets.append(tg)
        traj_id.append(np.full((len(w),), t, np.int32))
    targets = np.concatenate(targets)
    u_scale = float(np.abs(targets).max())
    return TrajectoryDataset(
        load_vol=np.ascontiguousarray(np.concatenate(load_vols)),
        windows=np.concatenate(windows),
        targets=targets / u_scale,
        u_scale=u_scale,
        traj_id=np.concatenate(traj_id),
        cases=cases,
        ref=hists[0],
    )


def concat_datasets(a: TrajectoryDataset,
                    b: TrajectoryDataset) -> TrajectoryDataset:
    """Stack two trajectory datasets (same mesh and hist_len) onto one
    shared ``u_scale``: the flywheel fine-tune's mix of harvested and
    replayed trajectories. ``b``'s trajectory ids are shifted past
    ``a``'s; ``ref`` stays ``a``'s."""
    if a.windows.shape[1:] != b.windows.shape[1:]:
        raise ValueError(
            f"cannot concat datasets of different window shapes "
            f"{a.windows.shape[1:]} vs {b.windows.shape[1:]} "
            f"(mesh/hist_len must match)")
    u_scale = max(a.u_scale, b.u_scale)
    # targets are stored pre-divided by their own u_scale
    targets = np.concatenate([a.targets * (a.u_scale / u_scale),
                              b.targets * (b.u_scale / u_scale)])
    return TrajectoryDataset(
        load_vol=np.concatenate([a.load_vol, b.load_vol]),
        windows=np.concatenate([a.windows, b.windows]),
        targets=targets.astype(np.float32),
        u_scale=u_scale,
        traj_id=np.concatenate([a.traj_id,
                                b.traj_id + a.n_trajectories]),
        cases=a.cases + b.cases,
        ref=a.ref)


def harvest_dataset(gateway_log, mesh: Tuple[int, int], *,
                    cfg: CRONetConfig, n_iter: int = 40, rmin: float = 1.5,
                    max_cases: int = 16, batch: int = 8, device="cuda"
                    ) -> Optional[TrajectoryDataset]:
    """A bucket's harvested fallback traffic as a training dataset: the
    load cases of ``gateway_log`` (anything with ``rejected_cases(mesh)``,
    or a sequence of ``LoadCase``s / ``describe()`` dicts), deduplicated,
    the newest ``max_cases`` kept, regenerated as pure-FEA SIMP
    trajectories on the bucket's mesh. ``None`` when no case is left."""
    raw = (gateway_log.rejected_cases(mesh)
           if hasattr(gateway_log, "rejected_cases") else gateway_log)
    seen, cases = set(), []
    for c in raw:
        case = c if isinstance(c, LoadCase) else LoadCase.from_dict(c)
        k = case.key()
        if k in seen:
            continue
        seen.add(k)
        cases.append(case)
    if not cases:
        return None
    if len(cases) > max_cases:
        cases = cases[-max_cases:]
    nelx, nely = int(mesh[0]), int(mesh[1])
    cfg = dataclasses.replace(cfg, nelx=nelx, nely=nely)
    return build_dataset(cfg, cases=cases, n_iter=n_iter, rmin=rmin,
                         batch=batch, device=device)


def split_by_trajectory(ds: TrajectoryDataset, heldout_frac: float = 0.25,
                        seed: int = 0):
    """Train/held-out split BY TRAJECTORY (windows of one trajectory are
    correlated). Returns (train_traj, held_traj) index arrays; at least
    one trajectory is held out when there are >= 2, and trajectory 0
    (the canonical case) always stays in training."""
    n = ds.n_trajectories
    if n < 2 or heldout_frac <= 0.0:
        return np.arange(n), np.arange(0)
    n_held = min(n - 1, max(1, int(round(n * heldout_frac))))
    rng = np.random.default_rng(seed)
    held = rng.choice(np.arange(1, n), size=n_held, replace=False)
    held = np.sort(held)
    train = np.setdiff1d(np.arange(n), held)
    return train, held
