"""CRONet training on FEA-generated trajectories (the counterpart of
``repro.fea.train_cronet``).

Dataset: sliding (hist_len)-windows over SIMP trajectories; the target is
the FEA displacement field of the next iteration. Trained with AdamW in
fp32 through PyTorch autograd on the batched forward
(``cronet.forward(..., invariant=False)``; the reference differentiates
its pure-XLA oracle the same way, so no kernel is on the training step).
Minibatches mix windows of every training trajectory; trajectories are
split into train and held-out BY TRAJECTORY; eval reports per-load-case
MSE, relative error and surrogate acceptance.

The minibatch indices and the density noise come from
``np.random.default_rng(seed)`` in the reference's order, so the same
seed and data give the same batches in both packages. Every entry point
runs on ``device`` (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import common
from repro_torch.common import Params, map_params, resolve_device
from repro_torch.configs.cronet import CRONetConfig
from repro_torch.core import cronet
from repro_torch.fea import dataset as ds_mod
from repro_torch.fea import fea2d, simp
from repro_torch.optim import adamw


def build_dataset(cfg: CRONetConfig, n_iter: int = 100, rmin: float = 1.5,
                  device="cuda"):
    """Legacy single-MBB-trajectory dataset: (load_vol (1, 4, ny+1,
    nx+1, 1), windows (N, T, ny, nx, 1), targets (N, ndof), u_scale,
    reference history), through the unbatched ``simp.run_simp``."""
    prob = fea2d.mbb_problem(cfg.nelx, cfg.nely)
    _, hist = simp.run_simp(prob, n_iter=n_iter, rmin=rmin, device=device)
    windows, targets = ds_mod.window_trajectory(hist, cfg.hist_len)
    u_scale = float(np.abs(targets).max())
    load_vol = fea2d.load_volume(prob).numpy().astype(np.float32)[None]
    return load_vol, windows, targets / u_scale, u_scale, hist


def _coerce_dataset(cfg: CRONetConfig, data) -> ds_mod.TrajectoryDataset:
    """Accept a TrajectoryDataset or the legacy 5-tuple."""
    if isinstance(data, ds_mod.TrajectoryDataset):
        return data
    load_vol, windows, targets, u_scale, hist = data
    n = windows.shape[0]
    return ds_mod.TrajectoryDataset(
        load_vol=np.ascontiguousarray(
            np.broadcast_to(load_vol, (n,) + load_vol.shape[1:])),
        windows=windows, targets=targets, u_scale=u_scale,
        traj_id=np.zeros((n,), np.int32),
        cases=(ds_mod.MBB_CASE,), ref=hist)


@dataclasses.dataclass
class TrainResult:
    """Everything a training run produced. Iterable as the legacy
    ``(params, u_scale, losses, ref)`` 4-tuple."""
    params: Dict
    u_scale: float
    losses: List[float]
    ref: Dict                      # trajectory-0 pure-FEA history
    eval_metrics: Dict             # heldout mse/acceptance + per-case rows
    cases: Tuple[ds_mod.LoadCase, ...]
    heldout_traj: np.ndarray       # trajectory ids held out of training
    step_s: List[float] = dataclasses.field(default_factory=list)

    def __iter__(self):
        return iter((self.params, self.u_scale, self.losses, self.ref))


def predict_dofs(cfg: CRONetConfig, params: Params, lv_b, hist_b):
    """The batched forward decoded to (B, ndof) in the 88-line layout."""
    pred = cronet.forward(cfg, params, lv_b, hist_b, invariant=False)
    return cronet.decode_to_dofs(cfg, pred)


def loss_fn(cfg: CRONetConfig, params: Params, lv_b, hist_b, target_b):
    """The training objective: mean squared error of the decoded
    displacement against the normalized target."""
    u = predict_dofs(cfg, params, lv_b, hist_b)
    return torch.mean(torch.square(u - target_b))


def loss_and_grad(cfg: CRONetConfig, params: Params, lv_b, hist_b,
                  target_b):
    """(loss, grads): ``jax.value_and_grad`` of ``loss_fn`` with respect
    to ``params``. The caller's tensors are not touched: the gradient is
    taken on detached leaves."""
    leaves = map_params(lambda t: t.detach().requires_grad_(True), params)
    paths = [(part, k) for part in sorted(leaves)
             for k in sorted(leaves[part])]
    loss = loss_fn(cfg, leaves, lv_b, hist_b, target_b)
    grads = torch.autograd.grad(loss, [leaves[p][k] for p, k in paths])
    out: Params = {part: {} for part in leaves}
    for (p, k), g in zip(paths, grads):
        out[p][k] = g
    return loss.detach(), out


def _to(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def minibatch(data: ds_mod.TrajectoryDataset, rows: np.ndarray,
              batch: int, rng: np.random.Generator, noise: float):
    """One training minibatch, drawn from ``rng`` as the reference draws
    it: window indices into ``rows``, then, with ``noise``, Gaussian
    jitter on the density histories clipped to [0.001, 1] (robustness
    off the training trajectory: the hybrid loop's designs drift from
    pure-FEA's). Returns numpy (load_vol, windows, targets)."""
    idx = rows[rng.integers(0, len(rows), size=min(batch, len(rows)))]
    wb = data.windows[idx]
    if noise:
        wb = np.clip(wb + rng.normal(0, noise, wb.shape).astype(np.float32),
                     0.001, 1.0)
    return data.load_vol[idx], wb, data.targets[idx]


def evaluate(cfg: CRONetConfig, params, data: ds_mod.TrajectoryDataset,
             traj: Optional[np.ndarray] = None,
             error_threshold: float = 0.05, chunk: int = 64) -> Dict:
    """Per-load-case eval over the given trajectories (default: all):
    per case and pooled, the normalized eval MSE (the training
    objective), the mean relative L2 displacement error and the
    surrogate acceptance (the fraction of windows whose relative error
    is below ``error_threshold``, the hybrid loop's residual gate). Runs
    on the params' device, in batches of ``chunk`` windows."""
    if traj is None:
        traj = np.arange(data.n_trajectories)
    dev = next(iter(next(iter(params.values())).values())).device

    per_case, all_mse, all_err = {}, [], []
    with torch.no_grad():
        for t in traj:
            rows = data.rows_of(int(t))
            mses, errs = [], []
            for lo in range(0, len(rows), chunk):
                idx = rows[lo:lo + chunk]
                target = _to(data.targets[idx], dev)
                u = predict_dofs(cfg, params, _to(data.load_vol[idx], dev),
                                 _to(data.windows[idx], dev))
                mses.append(torch.mean(torch.square(u - target), dim=-1))
                errs.append(torch.linalg.norm(u - target, dim=-1)
                            / torch.clamp(torch.linalg.norm(target, dim=-1),
                                          min=1e-30))
            mses = torch.cat(mses).cpu().numpy()
            errs = torch.cat(errs).cpu().numpy()
            case = data.cases[int(t)]
            per_case[f"traj{int(t)}_{case.kind}"] = {
                "case": case.describe(),
                "eval_mse": float(mses.mean()),
                "mean_rel_err": float(errs.mean()),
                "acceptance": float((errs < error_threshold).mean()),
                "windows": int(len(rows)),
            }
            all_mse.append(mses)
            all_err.append(errs)
    all_mse = np.concatenate(all_mse) if all_mse else np.zeros((0,))
    all_err = np.concatenate(all_err) if all_err else np.zeros((0,))
    return {
        "eval_mse": float(all_mse.mean()) if len(all_mse) else float("nan"),
        "mean_rel_err": float(all_err.mean()) if len(all_err) else float("nan"),
        "acceptance": float((all_err < error_threshold).mean())
        if len(all_err) else 0.0,
        "error_threshold": error_threshold,
        "per_case": per_case,
    }


def train(cfg: CRONetConfig, steps: int = 400, batch: int = 16,
          seed: int = 0, lr: float = 2e-3, data=None, log_every: int = 100,
          verbose: bool = True, noise: float = 0.01,
          heldout_frac: float = 0.25, error_threshold: float = 0.05,
          ckpt_dir: Optional[str] = None,
          init_params: Optional[Dict] = None,
          device="cuda") -> TrainResult:
    """Train CRONet on the (multi-)trajectory dataset, on ``device``.

    A ``heldout_frac`` of trajectories is held out of training and
    scored afterwards with ``evaluate``. With ``ckpt_dir`` the final
    params and metrics are saved through ``checkpoint/manager.py``. With
    ``init_params`` the run warm-starts from that fp32 tree: it is copied
    into fresh leaves first, so a tree an engine or a resolver holds is
    never written (``steps=0`` then just evaluates it). Otherwise the
    weights are ``common.init_params(cfg in fp32, seed, device)``.

    Returns a ``TrainResult`` (unpacks as ``(params, u_scale, losses,
    ref)``); ``step_s`` holds each step's wall seconds.
    """
    dev = resolve_device(device)
    if data is None:
        data = ds_mod.build_dataset(cfg, device=dev)
    data = _coerce_dataset(cfg, data)
    train_traj, held_traj = ds_mod.split_by_trajectory(
        data, heldout_frac, seed)
    train_rows = np.concatenate([data.rows_of(int(t)) for t in train_traj])

    if init_params is not None:
        params = map_params(lambda t: t.detach().to(dev, copy=True),
                            init_params)
    else:
        params = common.init_params(
            dataclasses.replace(cfg, dtype="float32"), seed, device=dev)
    ocfg = adamw.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps,
                             weight_decay=0.0, master_fp32=False)
    opt = adamw.init_state(ocfg, params)

    rng = np.random.default_rng(seed)
    losses, step_s = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        lv_b, hist_b, target_b = minibatch(data, train_rows, batch, rng,
                                           noise)
        loss, grads = loss_and_grad(cfg, params, _to(lv_b, dev),
                                    _to(hist_b, dev), _to(target_b, dev))
        params, opt, _ = adamw.apply_updates(ocfg, params, grads, opt)
        losses.append(float(loss))
        step_s.append(time.perf_counter() - t0)
        if verbose and i % log_every == 0:
            print(f"  cronet train step {i}: mse={losses[-1]:.5f}")

    eval_traj = held_traj if len(held_traj) else train_traj
    metrics = evaluate(cfg, params, data, traj=eval_traj,
                       error_threshold=error_threshold)
    metrics["heldout"] = bool(len(held_traj))
    metrics["train_trajectories"] = int(len(train_traj))
    metrics["final_train_mse"] = losses[-1] if losses else float("nan")
    if verbose:
        print(f"  eval ({'held-out' if metrics['heldout'] else 'train'} "
              f"trajectories {list(map(int, eval_traj))}): "
              f"mse={metrics['eval_mse']:.5f} "
              f"rel_err={metrics['mean_rel_err']:.3f} "
              f"acceptance={metrics['acceptance']:.0%}")

    result = TrainResult(params=params, u_scale=data.u_scale, losses=losses,
                         ref=data.ref, eval_metrics=metrics,
                         cases=data.cases, heldout_traj=held_traj,
                         step_s=step_s)
    if ckpt_dir is not None:
        from repro_torch.checkpoint import manager as ckpt
        ckpt.save(ckpt_dir, steps, {"params": params},
                  extras={"u_scale": data.u_scale,
                          "metrics": metrics,
                          "load_cases": [c.describe() for c in data.cases],
                          "cfg": dataclasses.asdict(cfg)})
    return result


def train_and_register(cfg: CRONetConfig, registry, *, tag: Optional[str]
                       = None, pin: bool = False, **train_kw):
    """Train, then persist the run as a registry version (params,
    cfg, u_scale, training load distribution, eval metrics). Returns
    (record, result)."""
    result = train(cfg, **train_kw)
    record = registry.register(
        result.params, cfg, result.u_scale, tag=tag, pin=pin,
        metrics=result.eval_metrics,
        load_cases=[c.describe() for c in result.cases])
    return record, result


def finetune_from_tag(reg, base_tag: str, mesh, harvested, *,
                      steps: int = 300, lr: float = 5e-4,
                      replay_cases: int = 4,
                      replay_n_iter: Optional[int] = None,
                      tag: Optional[str] = None, pin: bool = False,
                      seed: int = 0, heldout_frac: float = 0.25,
                      error_threshold: float = 0.05,
                      verbose: bool = False, device="cuda", **train_kw):
    """Fine-tune a bucket specialist from its serving checkpoint: the
    flywheel's training layer.

    Warm-starts from ``base_tag``'s fp32 weights (loaded onto ``device``;
    ``train`` copies them, so the base tensors stay as they are) and
    trains on ``harvested`` mixed with up to ``replay_cases`` trajectories
    replayed from the base checkpoint's own training distribution (the
    anti-forgetting guard). The child is registered specialized for
    ``mesh`` with ``parent=base_tag``; ``tag`` defaults to
    ``"<base>-ft<nelx>x<nely>"`` with a numeric suffix when taken.
    Returns ``(record, result)``.
    """
    dev = resolve_device(device)
    nelx, nely = int(mesh[0]), int(mesh[1])
    base_params, base_rec = reg.load(base_tag, device=dev)
    cfg = dataclasses.replace(base_rec.cfg, nelx=nelx, nely=nely)
    if harvested is None or harvested.n_windows == 0:
        raise ValueError(
            f"finetune_from_tag needs a non-empty harvested dataset for "
            f"{nelx}x{nely} (harvest_dataset returned "
            f"{'None' if harvested is None else 'no windows'})")

    data = harvested
    if replay_cases > 0 and base_rec.load_cases:
        replay = [ds_mod.LoadCase.from_dict(d)
                  for d in base_rec.load_cases[:replay_cases]]
        if replay_n_iter is None:
            # match the harvested trajectories' length so neither side
            # of the mix dominates by window count alone
            per_traj = len(harvested.rows_of(0))
            replay_n_iter = per_traj + cfg.hist_len
        replay_ds = ds_mod.build_dataset(cfg, cases=replay,
                                         n_iter=replay_n_iter, device=dev)
        data = ds_mod.concat_datasets(harvested, replay_ds)

    result = train(cfg, steps=steps, lr=lr, seed=seed, data=data,
                   heldout_frac=heldout_frac,
                   error_threshold=error_threshold, verbose=verbose,
                   init_params=base_params, device=dev, **train_kw)
    result.eval_metrics["finetuned_from"] = base_tag
    result.eval_metrics["harvested_trajectories"] = int(
        harvested.n_trajectories)

    if tag is None:
        base = f"{base_tag}-ft{nelx}x{nely}"
        taken = set(reg.tags())
        tag = base
        k = 2
        while tag in taken:
            tag = f"{base}.{k}"
            k += 1
    record = reg.register(
        result.params, cfg, result.u_scale, tag=tag, pin=pin,
        mesh=(nelx, nely), parent=base_tag,
        metrics=result.eval_metrics,
        load_cases=[c.describe() for c in result.cases])
    return record, result
