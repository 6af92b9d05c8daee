"""Live terminal dashboard over the metrics registry.

A copy of ``repro.obs.dashboard`` (the port imports nothing from ``repro``).

Pure text rendering (``render``) plus a tiny ANSI refresh loop
(``watch``) — no curses, no dependencies — used by
``examples/serve_topo.py --observe``. Everything shown is read from the
same ``MetricsRegistry`` the exporters scrape, so the dashboard can
never disagree with the JSONL/Prometheus views.
"""
from __future__ import annotations

import sys
import threading
import time
from typing import Callable, Dict, Iterable, Optional

from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, default_registry)

__all__ = ["render", "watch"]

_CLEAR = "\x1b[2J\x1b[H"


def _bar(frac: float, width: int = 20) -> str:
    frac = min(max(frac, 0.0), 1.0)
    n = int(round(frac * width))
    return "#" * n + "." * (width - n)


def _series_rows(inst) -> Iterable[str]:
    if isinstance(inst, Histogram):
        for key in inst.labelsets():
            labels = dict(key)
            cnt = inst.count(**labels)
            if not cnt:
                continue
            p50 = inst.percentile(50, **labels)
            p99 = inst.percentile(99, **labels)
            mean = inst.sum(**labels) / cnt
            lk = ",".join(f"{k}={v}" for k, v in key) or "-"
            yield (f"    {lk:<38} n={cnt:<8d} mean={_fmt(mean)} "
                   f"p50={_fmt(p50)} p99={_fmt(p99)}")
    elif isinstance(inst, Gauge) and inst._callback is not None:
        yield f"    {'-':<38} {_fmt(inst.value())}"
    else:
        for key in inst.labelsets():
            labels = dict(key)
            lk = ",".join(f"{k}={v}" for k, v in key) or "-"
            yield f"    {lk:<38} {_fmt(inst.value(**labels))}"


def _fmt(v: float) -> str:
    if v != v:   # nan
        return "nan"
    if abs(v) >= 1000 or v == int(v):
        return f"{v:.0f}"
    if abs(v) < 0.01:
        return f"{v * 1e3:.3f}ms" if abs(v) < 1 else f"{v:.4f}"
    return f"{v:.3f}"


def render(registry: Optional[MetricsRegistry] = None,
           stats: Optional[Dict] = None,
           width: int = 78) -> str:
    """One dashboard frame as a string.

    ``stats`` is an optional gateway/engine ``throughput_stats`` dict;
    when present its per-mesh sub-dicts become the per-bucket panel
    (occupancy / acceptance / p99 — the drill-down unit the per-bucket
    specialists are judged on).
    """
    reg = registry if registry is not None else default_registry()
    now = time.strftime("%H:%M:%S")
    lines = [f"== repro.obs dashboard @ {now} ".ljust(width, "=")]

    if stats:
        lines.append("-- serving ".ljust(width, "-"))
        for k in ("requests", "problems_per_s", "deadline_hit_rate",
                  "cronet_hit_rate", "p99_latency_s", "pending",
                  "shed", "rejected", "engines"):
            if k in stats:
                lines.append(f"  {k:<24} {_fmt(float(stats[k]))}")
        per_mesh = stats.get("per_mesh") or {}
        if per_mesh:
            lines.append("-- buckets ".ljust(width, "-"))
            for mesh, sub in sorted(per_mesh.items()):
                acc = float(sub.get("cronet_hit_rate", 0.0))
                lines.append(
                    f"  {str(mesh):<12} acc [{_bar(acc, 12)}] "
                    f"{acc:5.0%}  p99={_fmt(float(sub.get('p99_latency_s', 0.0)))} "
                    f"reqs={int(float(sub.get('requests', 0)))} "
                    f"tags={','.join(sub.get('model_tags', [])) or '-'}")

    insts = reg.instruments()
    if insts:
        lines.append("-- instruments ".ljust(width, "-"))
        for name in sorted(insts):
            inst = insts[name]
            rows = list(_series_rows(inst))
            if not rows:
                continue
            lines.append(f"  {name} ({inst.kind})")
            lines.extend(rows)
    return "\n".join(lines)


def watch(registry: Optional[MetricsRegistry] = None,
          stats_fn: Optional[Callable[[], Dict]] = None,
          interval_s: float = 1.0,
          stop: Optional[threading.Event] = None,
          out=None,
          frames: Optional[int] = None):
    """ANSI refresh loop: clear + redraw every ``interval_s`` until
    ``stop`` is set (or ``frames`` frames were drawn — tests/demos)."""
    out = out if out is not None else sys.stdout
    stop = stop or threading.Event()
    drawn = 0
    while not stop.is_set():
        stats = None
        if stats_fn is not None:
            try:
                stats = stats_fn()
            except Exception:
                stats = None
        out.write(_CLEAR + render(registry, stats) + "\n")
        out.flush()
        drawn += 1
        if frames is not None and drawn >= frames:
            return
        stop.wait(interval_s)
