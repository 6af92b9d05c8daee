"""The port stands alone: nothing under src/repro_torch/ and nothing in
chip_smoke.py imports JAX or the JAX package, and the port serves on the
CPU, through an engine, through the registry and the gateway, and through
a gateway's worker process, builds a dataset, trains, runs a flywheel
tick, serves a dense and a moe LM through ``repro_torch.launch.serve``,
trains one through ``repro_torch.launch.train`` and traces a dry-run cell
through ``repro_torch.launch.dryrun``, in processes where importing
either would fail."""
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


def test_port_serves_with_jax_and_reference_unimportable(tmp_path):
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
# one request through a spawned worker, which does not inherit the
# sys.modules entries above: the packages first on PYTHONPATH refuse it
gw = TopoGateway.from_registry(reg, "v1", slots=2, device="cpu",
                               error_threshold=1e9, workers=1)
try:
    far = gw.submit(TopoRequest(uid=20, problem=fea2d.point_load_problem(
        12, 4, load_node=(2, 0)), n_iter=4)).result(timeout=120)
finally:
    gw.shutdown()
assert far.worker_id == 0 and far.model_tag == "v1"
assert far.density.shape == (4, 12)
# training and the flywheel: a 2-case dataset, 2 steps registered, one
# controller tick that harvests, fine-tunes and starts a canary
from repro_torch.fea import dataset, train_cronet
from repro_torch.serve import FlywheelController, HarvestLog
tcfg = dataclasses.replace(cfg, dtype="float32")
data = dataset.build_dataset(tcfg, n_cases=2, n_iter=5, device="cpu")
rec, res = train_cronet.train_and_register(
    tcfg, reg, tag="t1", steps=2, batch=2, data=data, verbose=False,
    device="cpu")
assert len(res.losses) == 2 and rec.load_cases
log = HarvestLog(accept_below=1.0)
gw = TopoGateway.from_registry(reg, "t1", slots=2, device="cpu",
                               error_threshold=0.05, harvest=log)
fly = FlywheelController(gw, log, trigger_below=1.01, min_completed=2,
                         finetune_steps=1, harvest_n_iter=5,
                         replay_cases=1)
try:
    for i in range(2):
        gw.submit(TopoRequest(uid=30 + i, problem=fea2d.point_load_problem(
            12, 4, load_node=(3 * i + 1, 0)), n_iter=4)).result(timeout=120)
    assert fly.tick()
    assert fly.cycles()["12x4"]["state"] == "canary", fly.status()
finally:
    gw.shutdown()
# LM serving: the launcher at the smoke size, on the CPU
from repro_torch.launch import serve as lm_serve
lm = lm_serve.main(["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
                    "--requests", "2", "--max-new", "3"])
assert [len(r.output) for r in lm] == [3, 3]
for arch in ("granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-1.3b"):
    lm = lm_serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                        "--requests", "2", "--max-new", "3"])
    assert [len(r.output) for r in lm] == [3, 3]
# LM training: the launcher at the smoke size, on the CPU
from repro_torch.launch import train as lm_train
hist = lm_train.main(["--arch", "granite-8b", "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16"])
assert hist[-1]["step"] == 3
# the dry-run: one decode cell at the smoke size on a fake 16x16 mesh
from repro_torch.configs.base import ShapeConfig, get_config as lm_config
from repro_torch.launch import dryrun
cell = dryrun.trace_cell(
    "granite-moe-3b-a800m", "decode_32k", device="cpu",
    cfg=lm_config("granite-moe-3b-a800m").reduce(),
    shape=ShapeConfig("decode_32k", 32, 128, "decode"))
assert cell["flops_per_device"] > 0 and cell["chips"] == 256
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m in sys.modules if sys.modules[m] is not None)
print("served", [round(r.compliance, 3) for r in done + got + [far]])
"""
    # the spawned worker starts from a fresh interpreter: these stand-ins
    # come first on its path, so importing jax, jaxlib or repro fails there
    for mod in FORBIDDEN:
        (tmp_path / mod).mkdir()
        (tmp_path / mod / "__init__.py").write_text(
            f"raise ImportError('{mod} must not be imported by the port')\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "served" in out.stdout
