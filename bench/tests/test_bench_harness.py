"""The harness on the CPU at a tiny size: files found by name, failed
requests counted, the module check, the flop counts of the yardstick, and
the card-only run that skips here."""
from __future__ import annotations

import json
import sys

import pytest
import torch

from bench import harness, run, yardstick
from bench.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _run(root, seed, trace, plant=None, seconds=2.0):
    return harness.run(tiny.CELL, seed, seconds, trace, root=root,
                       device="cpu", plant=plant, log=lambda _m: None)


def test_finds_new_configuration_traffic_and_metric(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "bench/metrics/lanes_held.py").write_text(
        'LAYER = "engine (serve/topo_service.py)"\nUNIT = "lanes"\n'
        'MOVES = "designs_per_s"\n\n\ndef read(r):\n'
        '    return r["mean_occupied"]\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "lanes_held", "unit": "lanes", "better": "higher",
        "source": "program_counter", "layer": "engine (serve/topo_service.py)",
        "moves": "designs_per_s", "workloads": [tiny.CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    res = _run(root, 5, True, seconds=10.0)
    assert res["correct"], res["check"]
    assert res["metrics"]["lanes_held"]["value"] == 8
    assert res["metrics"]["tick_ms"]["value"] > 0
    assert res["device"]["window_s"] > 0
    # no device on the CPU: the device readers find nothing and stay out
    assert "cronet_fused_roofline" not in res["metrics"]
    assert list(res)[-1] == "check"


def test_untraced_run_reports_end_to_end_metrics(tmp_path):
    res = _run(tiny.make_root(tmp_path), 2**31 + 17, False)
    assert res["correct"], res["check"]
    assert set(res["metrics"]) == {"designs_per_s", "p95_latency_s",
                                   "setup_s"}
    assert res["attempted"] > 0 and res["check"]["harvested"] > 0


def test_nonfinite_request_counts_as_failed(tmp_path):
    """A request whose design is not finite is counted in ``failed`` and
    the run still gives its line (the plant turns designs non-finite
    inside the window only, before the check's ticks)."""
    def plant(engine):
        orig = engine._harvest_lane

        def harvest(shard, lane, now):
            if (shard.slot_adm[lane].req.uid % 2
                    and not isinstance(engine.step, harness.TickCapture)):
                shard.state.x[lane] = float("nan")
            orig(shard, lane, now)
        engine._harvest_lane = harvest

    res = _run(tiny.make_root(tmp_path), 3, False, plant)
    assert res["failed"] > 0
    assert res["attempted"] > res["failed"]
    assert res["correct"], res["check"]
    line = json.dumps(run.finite(res))
    assert json.loads(line)["failed"] == res["failed"]


def test_module_check(monkeypatch):
    for name in ("jax", "jaxlib.xla_client", "flax", "repro", "repro.fea"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name.split(".")[0] in {m.split(".")[0] for m in
                                      harness.forbidden_modules()}
        monkeypatch.delitem(sys.modules, name)
    for name in ("repro_torch", "repro_torch.fea", "jax_like", "reprox"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not [m for m in harness.forbidden_modules()
                if m.startswith(("repro_torch", "jax_like", "reprox"))]


# paper Table I as printed: (figure, one unit of its last digit)
K, M = 1_000, 1_000_000
TABLE1 = {
    (30, 10): [(294 * K, K), (12.6 * M, M / 10), (432 * K, K),
               (13.8 * M, M / 10)],
    (30, 20): [(562 * K, K), (24 * M, M), (864 * K, K), (27.6 * M, M / 10)],
    (60, 20): [(1.1 * M, M / 10), (47.2 * M, M / 10), (1.7 * M, M / 10),
               (55.3 * M, M / 10)],
}


@pytest.mark.parametrize("mesh", sorted(TABLE1))
def test_table1_macs(mesh):
    """Trunk conv3d1 / conv3d2 and branch conv2d1 / conv2d2 MACs within
    one unit of Table I's last printed digit."""
    m = yardstick.cronet_macs(*mesh)
    got = (m["trunk/conv3d1"], m["trunk/conv3d2"], m["branch/conv2d1"],
           m["branch/conv2d2"])
    for g, (figure, unit) in zip(got, TABLE1[mesh]):
        assert abs(g - figure) <= unit, (mesh, g, figure)
    assert yardstick.cronet_params(*mesh) == 419_760
    assert m["branch/rnn"] == 61_440


def test_roofline_bound_takes_the_longer_term():
    assert yardstick.roofline_bound_s(67e12, 0) == pytest.approx(1.0)
    assert yardstick.roofline_bound_s(0, 3.35e12) == pytest.approx(1.0)
    medium = yardstick.cronet_flops(30, 20, 4096)
    assert 0.4e12 < medium < 0.5e12       # ~0.44 TFLOP a 4096-lane tick


@pytest.mark.cuda
def test_tiny_cell_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    res = harness.run(tiny.CELL, 11, 3.0, False,
                      root=tiny.make_root(tmp_path, mesh=(30, 10)),
                      device="cuda",
                      log=lambda _m: None)
    assert res["correct"], res["check"]
    assert res["device"]["platform"] == "gpu"
