"""Telemetry exporters: periodic JSONL snapshots + Prometheus text file.

A copy of ``repro.obs.export`` (the port imports nothing from ``repro``).

``TelemetrySnapshotter`` is a daemon thread that, every ``interval_s``,
appends one JSON line (wall + monotonic stamps + the registry's full
``snapshot()``) to a bounded JSONL file and rewrites a Prometheus
text-format file next to it. Both writes follow the ``HarvestLog``
spooling idiom: serialize to a ``.tmp`` sibling, then ``os.replace`` —
atomic on POSIX, so a scraper or a crashed run never sees a torn FILE.
Torn LINES can still exist in a snapshot file a previous process died
while appending to; ``read_snapshots`` skips them instead of failing
(the same tolerance ``HarvestLog._read_spool`` has).

The snapshot file is bounded: when it exceeds ``max_snapshots`` lines
the oldest are dropped on the next write (newest-N retention, like the
harvest spool), so a week-long soak cannot fill the disk.

The snapshotter is drivable without the thread — ``snapshot_once()``
does one synchronous cycle — which is what the benchmark round-trip
gate and the tests use.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry, default_registry

__all__ = ["TelemetrySnapshotter", "read_snapshots"]


def read_snapshots(path: str) -> List[Dict]:
    """Parse a snapshot JSONL file, skipping torn/corrupt lines (a
    killed writer can leave a partial final line; that is data loss of
    one snapshot, not of the file)."""
    out: List[Dict] = []
    if not os.path.exists(path):
        return out
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


class TelemetrySnapshotter:
    """Periodic registry exporter (JSONL + Prometheus text file).

    Parameters
    ----------
    path:            snapshot JSONL file; ``<path>.prom`` gets the
                     Prometheus text format unless ``prom_path`` is set.
    registry:        defaults to the process-wide ``default_registry()``.
    interval_s:      daemon period.
    max_snapshots:   newest-N line retention bound on the JSONL file.
    extra:           optional callable returning a dict merged into each
                     snapshot record (the gateway passes its
                     ``throughput_stats`` so snapshots carry the derived
                     view alongside the raw instruments).
    """

    def __init__(self, path: str,
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 5.0,
                 max_snapshots: int = 2048,
                 prom_path: Optional[str] = None,
                 extra: Optional[Callable[[], Dict]] = None):
        self.path = str(path)
        self.prom_path = prom_path or self.path + ".prom"
        self.registry = registry if registry is not None \
            else default_registry()
        self.interval_s = float(interval_s)
        self.max_snapshots = int(max_snapshots)
        self.extra = extra
        self.snapshots_written = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------ cycle

    def snapshot_once(self) -> Dict:
        """One synchronous export cycle; returns the record written."""
        rec = {
            "t": time.time(),
            "t_mono": time.monotonic(),
            "metrics": self.registry.snapshot(),
        }
        if self.extra is not None:
            try:
                rec["extra"] = self.extra()
            except Exception as e:   # a broken stats hook must not
                rec["extra_error"] = repr(e)   # kill the daemon
        with self._lock:
            self._append_bounded(rec)
            self._write_prom()
            self.snapshots_written += 1
        return rec

    def _append_bounded(self, rec: Dict):
        line = json.dumps(rec, sort_keys=True)
        existing: List[str] = []
        if os.path.exists(self.path):
            with open(self.path, "r") as f:
                existing = [ln.rstrip("\n") for ln in f
                            if ln.strip()]
        existing.append(line)
        if len(existing) > self.max_snapshots:   # newest-N retention
            existing = existing[-self.max_snapshots:]
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            f.write("\n".join(existing) + "\n")
        os.replace(tmp, self.path)   # atomic: readers never see a torn file

    def _write_prom(self):
        tmp = self.prom_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(self.registry.to_prometheus())
        os.replace(tmp, self.prom_path)

    # ----------------------------------------------------------- daemon

    def start(self) -> "TelemetrySnapshotter":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="telemetry-snapshotter", daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.snapshot_once()
            except Exception:
                # export must never take the serving process down;
                # the next cycle retries
                pass

    def stop(self, final_snapshot: bool = True):
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            # Only forget the handle once the daemon actually exited.
            # A wedged loop (stuck extra() hook, hung write) must keep
            # the handle so start() cannot spawn a SECOND loop racing
            # the stuck one onto the same files; the final snapshot
            # below stays safe either way because snapshot_once
            # serializes every file write under _lock.
            if not t.is_alive():
                self._thread = None
        if final_snapshot:
            try:
                self.snapshot_once()
            except Exception:
                pass

    def __enter__(self) -> "TelemetrySnapshotter":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
