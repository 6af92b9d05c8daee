"""The check must fail: each fault a serving cell can have, planted under a
whole run on the CPU (the harness's look for a card skipped), and the
control (the reference at TF32, on the CPU by operand rounding) against
the limits of the cells' configurations.

A single card runs each cell, so there is no exchange between cards to
leave out."""
from __future__ import annotations

import pytest
import torch

from bench import check, harness
from bench.tests import tiny


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _state_unchanged(engine):
    engine.step = lambda params, bp, load_vol, state: state


def _half_the_batch(engine):
    step = engine.step

    def half(params, bp, load_vol, state):
        new = step(params, bp, load_vol, state)
        keep = torch.arange(state.x.shape[0]) >= state.x.shape[0] // 2
        return type(state)(*[
            torch.where(keep.view(-1, *[1] * (n.dim() - 1)), o, n)
            for n, o in zip(new, state)])
    engine.step = half


def _answer_altered(engine):
    orig = engine._harvest_lane

    def harvest(shard, lane, now):
        shard.state.x[lane, 0, 0] += 1e-3
        orig(shard, lane, now)
    engine._harvest_lane = harvest


@pytest.mark.parametrize("plant", [_state_unchanged, _half_the_batch,
                                   _answer_altered],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered"])
def test_fault_fails_the_check(tmp_path, plant):
    root = tiny.make_root(tmp_path)
    res = harness.run(tiny.CELL, 23, 2.0, False, root=root, device="cpu",
                      plant=plant, log=lambda _m: None)
    assert res["check"]["lanes"] > 0 and res["check"]["harvested"] > 0
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("config", ["cronet-medium", "cronet-small"])
def test_control_fails_the_limits(tmp_path, config):
    """The reference at TF32 in the program's place fails the check of the
    configuration's limits, through the harness's own comparison, while
    the program passes it on the same ticks."""
    root = tiny.make_root(tmp_path, config=config)
    res = harness.run(tiny.CELL, 7, 2.0, False, root=root, device="cpu",
                      control=True, log=lambda _m: None)
    assert res["check"]["lanes"] > 0 and res["check"]["harvested"] > 0
    assert not res["correct"], res["check"]
    prog = res["program_check"]
    assert all(prog[n]["value"] <= prog[n]["limit"] for n in check.NUMBERS)
