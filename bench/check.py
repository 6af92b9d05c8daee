"""The comparison that decides ``correct``.

Once the window has closed, the harness lets the engine run a few more
ticks at the window's width (``harness.TickCapture``), each lane's request
and the state before and after each tick recorded, and the designs of the
requests harvested between them kept as the clients got them. The plain
reference (``bench/reference.py``) recomputes each of those ticks, every
occupied lane, from the program's state before it, or, for a lane admitted
since the tick before, from the reference's own fresh state; the load
cases come from the pool, the weights are drawn again from their seed.
Three numbers, each the largest over the lanes and ticks:

* ``x_gap``: |x - x_ref| of the new densities and of the history ring, and
  of each harvested design against the reference's state of its lane (a
  lane whose iteration counter differs reads inf);
* ``c_gap``: |c - c_ref| / |c_ref| of the tick's compliance, and of each
  harvested compliance;
* ``u_gap``: ||u - u_ref|| / ||u_ref|| of the displacement carried over,
  and |err - err_ref| / |err_ref| of CRONet's error scored against it
  (a norm's ratio, which a rounding of CRONet's output barely moves: the
  displacement's gap is what separates the control).

A lane whose quantity is finite on one side only reads inf; one that is
non-finite on both sides (the fp32 PCG fault) agrees. ``control=True``
puts the reference at TF32 in the program's place: the lanes' states after
each tick and the harvested designs are the control's.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

NUMBERS = ("x_gap", "c_gap", "u_gap")
BLOCK = 4096           # lanes the reference holds at once


def _agree(gap, fin, fin_ref):
    """Per-lane gap where both sides are finite, 0 where neither is, inf
    where one is."""
    import torch
    gap = torch.where(fin & fin_ref, gap, torch.zeros_like(gap))
    return torch.where(fin != fin_ref, torch.full_like(gap, math.inf), gap)


def _finite(t):
    return t.reshape(t.shape[0], -1).isfinite().all(dim=1)


def lane_gaps(x, hist, it, u, err, c, ref, c_ref) -> Dict:
    """The three numbers of each lane (tensors (B,)) between the program's
    leaves and the reference's state ``ref`` and compliance ``c_ref``."""
    import torch
    B = x.shape[0]
    dx = torch.maximum((x - ref.x).abs().reshape(B, -1).amax(dim=1),
                       (hist - ref.hist).abs().reshape(B, -1).amax(dim=1))
    dx = _agree(dx, _finite(x) & _finite(hist),
                _finite(ref.x) & _finite(ref.hist))
    dx = torch.where(it == ref.it, dx, torch.full_like(dx, math.inf))
    dc = _agree((c - c_ref).abs() / c_ref.abs(), c.isfinite(),
                c_ref.isfinite())
    du = _agree(torch.linalg.vector_norm(u - ref.u, dim=1)
                / torch.linalg.vector_norm(ref.u, dim=1),
                _finite(u), _finite(ref.u))
    de = _agree((err - ref.err).abs() / ref.err.abs(), err.isfinite(),
                ref.err.isfinite())
    return {"x_gap": dx, "c_gap": dc, "u_gap": torch.maximum(du, de)}


def compare(capture, records, pool, config, engine_spec, device,
            control: bool = False) -> Dict:
    """The numbers, each beside its limit, and ``_pass``."""
    import torch

    from bench import reference
    limits = config["check"]
    fields = config["config"]
    nelx, nely = int(fields["nelx"]), int(fields["nely"])
    weights = reference.make_weights(int(config["weights_seed"]), device)
    mesh = reference.make_mesh(nelx, nely, device)
    eng = dict(u_scale=float(engine_spec["u_scale"]),
               error_threshold=float(engine_spec["error_threshold"]),
               verify_every=int(engine_spec["verify_every"]),
               rmin=float(engine_spec["rmin"]))
    worst = {k: 0.0 for k in NUMBERS}
    lanes = harvested = nonfinite = 0
    ticks: List[Dict] = capture.ticks
    for k, t in enumerate(ticks):
        uids = t["uids"]
        after = (ticks[k + 1]["uids"] if k + 1 < len(ticks)
                 else capture.uids_after)
        for s in range(0, len(uids), BLOCK):
            idx = np.nonzero(uids[s:s + BLOCK] >= 0)[0] + s
            if not len(idx):
                continue
            cases = np.array([records[u].case for u in uids[idx]])

            def put(a):
                return torch.as_tensor(np.ascontiguousarray(a[cases]),
                                       device=device)

            f, free, fixed_x, volfrac = (put(pool.f), put(pool.free),
                                         put(pool.fixed_x),
                                         put(pool.volfrac))
            lane = torch.as_tensor(idx, device=t["pre"]["x"].device)
            pre = reference.State(*(t["pre"][n][lane].to(device)
                                    for n in reference.State._fields))
            if k:
                new = torch.as_tensor(uids[idx] != ticks[k - 1]["uids"][idx],
                                      device=device)
                start = reference.fresh(volfrac, nelx, nely)
                pre = reference.State(*(
                    torch.where(new.view(-1, *[1] * (a.dim() - 1)), b, a)
                    for a, b in zip(pre, start)))
            ref, c_ref = reference.tick(weights, mesh, f, free, fixed_x,
                                        volfrac, pre, **eng)
            if control:
                got, c_got = reference.tick(weights, mesh, f, free, fixed_x,
                                            volfrac, pre, lowp=True, **eng)
                post = dict(got._asdict(), compliance=c_got)
            else:
                post = {n: v[lane].to(device) for n, v in t["post"].items()}
            gaps = lane_gaps(post["x"], post["hist"], post["it"], post["u"],
                             post["err"], post["compliance"], ref, c_ref)
            # the requests harvested after this tick, as their clients got
            # them (the control's: its state of the lane)
            gone = np.nonzero(~np.isin(uids[idx], after))[0]
            for i in gone:
                rec = records[uids[idx[i]]]
                if not rec.fut.done() or rec.fut.exception() is not None:
                    continue
                if control:
                    x_h, c_h = post["x"][i], post["compliance"][i]
                else:
                    x_h = torch.as_tensor(rec.req.density, device=device)
                    c_h = torch.tensor(rec.req.compliance, device=device)
                one = reference.State(*(v[i:i + 1] for v in ref))
                g = lane_gaps(x_h[None], ref.hist[i:i + 1], ref.it[i:i + 1],
                              ref.u[i:i + 1], ref.err[i:i + 1],
                              c_h.reshape(1), one, c_ref[i:i + 1])
                for n in ("x_gap", "c_gap"):
                    worst[n] = max(worst[n], float(g[n][0]))
                harvested += 1
            for n in NUMBERS:
                worst[n] = max(worst[n], float(gaps[n].max()))
            lanes += len(idx)
            nonfinite += int((~c_ref.isfinite()).sum())
    out: Dict = {"lanes": lanes, "ticks": len(ticks),
                 "harvested": harvested, "nonfinite": nonfinite}
    for n in NUMBERS:
        out[n] = {"value": worst[n], "limit": limits[n]}
    out["_pass"] = (lanes > 0 and harvested > 0
                    and all(worst[n] <= limits[n] for n in NUMBERS))
    return out
