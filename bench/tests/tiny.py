"""A benchmark root at a size a CPU test can hold: a copy of ``bench/`` with
one more configuration (a cell's configuration at a 12x4 mesh, its limits
kept), traffic mix (8 slots, 12-14 iterations) and cell, beside a link to
the program's ``src``."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny-s8"


def make_root(tmp: Path, mesh=(12, 4), config="cronet-medium",
              **traffic) -> Path:
    root = tmp / "root"
    shutil.copytree(REPO / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(REPO / "src")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    med = json.loads((REPO / f"bench/configs/{config}.json").read_text())
    del med["size"]
    med["config"].update(name="cronet-tiny", nelx=mesh[0], nely=mesh[1])
    (root / "bench/configs/cronet-tiny.json").write_text(json.dumps(med))
    mix = json.loads(
        (REPO / "bench/traffic/mbb-s4096-n40to80.json").read_text())
    mix.update(slots=8, spare_clients=4, n_iter=[12, 14], join_over_ticks=4,
               pool=32)
    mix.update(traffic)
    (root / "bench/traffic/tiny.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "cronet-tiny", "source": "test",
                             "file": "bench/configs/cronet-tiny.json",
                             "reduced": ["nelx", "nely"], "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "cronet-tiny",
                               "traffic": "tiny", "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
