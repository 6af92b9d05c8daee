"""The port stands alone: nothing under src/repro_torch/ and nothing in
chip_smoke.py imports JAX or the JAX package, and the port serves on the
CPU, through an engine and through the registry and the gateway, in a
process where importing either would fail."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


def test_no_jax_or_reference_imports():
    files = _files()
    assert len(files) > 10
    bad = [f"{p.relative_to(ROOT)}:{line} imports {mod}"
           for p in files for mod, line in _imported_roots(p)
           if mod in FORBIDDEN]
    assert not bad, bad


def test_port_serves_with_jax_and_reference_unimportable():
    code = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import dataclasses
from repro_torch.common import init_params
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.fea import fea2d
from repro_torch.serve.topo_service import TopoServingEngine
from repro_torch.serve.types import TopoRequest
cfg = dataclasses.replace(get_cronet_config("small"), nelx=12, nely=4,
                          hist_len=3)
params = init_params(cfg, seed=0, device="cpu")
eng = TopoServingEngine(cfg, params, 50.0, slots=2, device="cpu",
                        error_threshold=1e9)
done = eng.run([TopoRequest(uid=i, problem=fea2d.point_load_problem(
    12, 4, load_node=(3 * i, 0)), n_iter=5) for i in range(2)])
eng.shutdown()
assert all(r.done and r.density.shape == (4, 12) for r in done)
assert sum(r.cronet_iters for r in done) > 0
# the registry and the gateway: register, serve two meshes, snapshot
import tempfile
from repro_torch.obs import TelemetrySnapshotter, read_snapshots
from repro_torch.serve import ModelRegistry, TopoGateway
root = tempfile.mkdtemp()
reg = ModelRegistry(root + "/registry")
reg.register(params, cfg, 50.0, tag="v1")
gw = TopoGateway.from_registry(reg, "v1", slots=2, device="cpu",
                               error_threshold=1e9, trace_every=1)
snap = TelemetrySnapshotter(root + "/telemetry.jsonl",
                            extra=gw.throughput_stats)
futs = [gw.submit(TopoRequest(uid=10 + i, problem=fea2d.point_load_problem(
    *mesh, load_node=(i, 0)), n_iter=4))
    for i, mesh in enumerate([(12, 4), (10, 6), (12, 4)])]
got = [f.result(timeout=120) for f in futs]
snap.snapshot_once()
gw.shutdown()
assert [r.model_tag for r in got] == ["v1"] * 3
assert [r.density.shape for r in got] == [(4, 12), (6, 10), (4, 12)]
(rec,) = read_snapshots(root + "/telemetry.jsonl")
assert rec["extra"]["engines"] == 2.0
assert "topo_completions_total" in rec["metrics"]
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("served", [round(r.compliance, 3) for r in done + got])
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served" in out.stdout
