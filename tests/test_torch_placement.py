"""``repro_torch.core.placement`` against ``repro.core.placement``: the
same numbers exactly (paper Table VI and the rule selection).

- ``cronet_graph`` at small, medium and large: nodes and edge bytes.
- The three placers at (8, 38), ``place_random`` at seeds 0-3, and the
  ``congestion_cost`` of each.
- ``estimate_traffic``, ``arch_rules`` and ``choose_rules`` for each of
  the ten configurations x the four ``SHAPES`` x a 16x16 and a 2x16x16
  mesh shape (``candidate_rules`` too).
- The reference's four placement properties
  (tests/test_placement_optim.py), on the port.
"""
import dataclasses

import pytest

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget_config
from repro.configs.cronet import get_cronet_config as jcronet
from repro.core import placement as JP
from repro_torch.configs.all import ASSIGNED
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.configs.cronet import get_cronet_config
from repro_torch.core import placement as TP

GRID = (8, 38)
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _graph(mod, cfg):
    nodes, edges = mod.cronet_graph(cfg)
    return ([dataclasses.astuple(n) for n in nodes],
            [dataclasses.astuple(e) for e in edges])


@pytest.mark.parametrize("size", ["small", "medium", "large"])
def test_cronet_graph_matches_reference(size):
    assert _graph(TP, get_cronet_config(size)) == _graph(JP, jcronet(size))


def _placements(mod, cfg):
    nodes, edges = mod.cronet_graph(cfg)
    out = {"rowmajor": mod.place_rowmajor(nodes, GRID),
           "congestion_aware": mod.place_congestion_aware(nodes, edges, GRID)}
    for seed in range(4):
        out[f"random{seed}"] = mod.place_random(nodes, GRID, seed=seed)
    return out, edges


@pytest.mark.parametrize("size", ["small", "medium", "large"])
def test_placers_and_cost_match_reference(size):
    mine, edges = _placements(TP, get_cronet_config(size))
    theirs, jedges = _placements(JP, jcronet(size))
    assert list(mine) == list(theirs)
    for name in mine:
        assert {k: [tuple(c) for c in v] for k, v in mine[name].items()} == \
            {k: [tuple(c) for c in v] for k, v in theirs[name].items()}, name
        assert TP.congestion_cost(mine[name], edges) == \
            JP.congestion_cost(theirs[name], jedges), name


def _report(r):
    return (r.per_axis_bytes, r.cost, r.detail)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ASSIGNED)
def test_rule_selection_matches_reference(name, shape, mesh):
    cfg, jcfg = get_config(name), jget_config(name)
    sh, jsh, ms = SHAPES[shape], JSHAPES[shape], MESHES[mesh]
    assert TP.candidate_rules() == JP.candidate_rules()
    for rname, rules in TP.candidate_rules().items():
        assert _report(TP.estimate_traffic(cfg, sh, ms, rules)) == \
            _report(JP.estimate_traffic(jcfg, jsh, ms, rules)), rname
    assert TP.arch_rules(cfg, sh, ms) == JP.arch_rules(jcfg, jsh, ms)
    best, rules, rep, reps = TP.choose_rules(cfg, sh, ms)
    jbest, jrules, jrep, jreps = JP.choose_rules(jcfg, jsh, ms)
    assert (best, rules, _report(rep)) == (jbest, jrules, _report(jrep))
    assert {k: _report(v) for k, v in reps.items()} == \
        {k: _report(v) for k, v in jreps.items()}


# the reference's properties (tests/test_placement_optim.py), on the port


def test_congestion_aware_beats_default():
    cfg = get_cronet_config("medium")
    nodes, edges = TP.cronet_graph(cfg)
    c_row = TP.congestion_cost(TP.place_rowmajor(nodes, GRID), edges)
    c_rand = TP.congestion_cost(TP.place_random(nodes, GRID), edges)
    c_custom = TP.congestion_cost(
        TP.place_congestion_aware(nodes, edges, GRID), edges)
    assert c_custom < c_row
    assert c_custom < c_rand
    assert c_custom < 0.6 * c_row


def test_placement_uses_disjoint_tiles():
    nodes, edges = TP.cronet_graph(get_cronet_config("medium"))
    placed = TP.place_congestion_aware(nodes, edges, GRID)
    tiles = [t for ts in placed.values() for t in ts]
    assert len(tiles) == len(set(tiles))
    assert len(tiles) == sum(n.tiles for n in nodes) == 223  # Table IV


def test_rule_selection_runs():
    name, rules, report, reports = TP.choose_rules(
        get_config("qwen2.5-32b"), SHAPES["train_4k"],
        {"data": 16, "model": 16})
    assert name in reports
    assert report.cost == min(r.cost for r in reports.values())
    assert report.cost > 0


def test_traffic_model_moe_has_a2a():
    rep = TP.estimate_traffic(get_config("deepseek-v3-671b"),
                              SHAPES["train_4k"], {"data": 16, "model": 16},
                              TP.DEFAULT_RULES)
    assert rep.detail.get("moe_all_to_all", 0) > 0
