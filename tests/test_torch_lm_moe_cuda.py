"""The moe family's serving path on an NVIDIA GPU against the same code on
the CPU, at ``reduce()`` in fp32 (TF32 off).

Marked ``cuda``: without a GPU every test here skips (the decision is made
inside the fixture, never at import). On a machine with one:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_lm_moe_cuda.py

No kernel of the port runs here (the reference's MoE and MLA call none):
these hold the dispatch's scatters and sorts, the latent cache writes and
the tie order to the CPU's results at the published capacity factor,
where assignments are dropped.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.common import map_params, materialize
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import make_requests
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models.transformer import layer_params
from repro_torch.serve.server import ServingEngine

pytestmark = pytest.mark.cuda

MOES = ["granite-moe-3b-a800m", "deepseek-v3-671b"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def small(name: str):
    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32",
                              moe_capacity_factor=1.25)
    return cfg, materialize(M.param_specs(cfg), seed=0, device="cpu")


@pytest.mark.parametrize("name", MOES)
def test_moe_layer_with_drops_matches_cpu(dev, name):
    """One MoE layer on 64 tokens at factor 1.25: the same ids, the same
    dispatch (drops included) and the output within 1e-5 of its max."""
    cfg, params = small(name)
    p = layer_params(params["moe_blocks"]["moe"], 0)
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    ids, _, _ = MOE.route(cfg, x.reshape(64, -1), p["router"])
    ids_d, _, _ = MOE.route(cfg, x.reshape(64, -1).to(dev),
                            p["router"].to(dev))
    assert torch.equal(ids, ids_d.cpu())
    cap = max(4, math.ceil(64 * cfg.top_k * 1.25 / cfg.num_experts))
    order, buf = MOE._dispatch_indices(ids, cfg.num_experts, cap)
    order_d, buf_d = MOE._dispatch_indices(ids_d, cfg.num_experts, cap)
    assert torch.equal(order, order_d.cpu()) and torch.equal(buf, buf_d.cpu())
    assert int((buf == cfg.num_experts * cap).sum()) > 0
    want, _ = MOE.apply_moe(cfg, p, x)
    got, _ = MOE.apply_moe(cfg, map_params(lambda t: t.to(dev), p), x.to(dev))
    assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


def test_route_tie_order_on_the_card(dev):
    """deepseek-v3's router at full width with saturated sigmoid scores:
    the card's ids are the lowest-index experts among the ties, as on the
    CPU."""
    cfg = get_config("deepseek-v3-671b")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((8, cfg.d_model), generator=gen)
    w = torch.randn((cfg.d_model, cfg.num_experts), generator=gen)
    ids, _, _ = MOE.route(cfg, x.to(dev), w.to(dev))
    scores = torch.sigmoid(x.to(dev) @ w.to(dev)).cpu().numpy()
    idx = np.arange(cfg.num_experts)
    want = np.stack([np.lexsort((idx, -row))[:cfg.top_k] for row in scores])
    assert (scores == 1.0).sum(1).min() > cfg.top_k
    assert np.array_equal(ids.cpu().numpy(), want)


@pytest.mark.parametrize("name", MOES)
def test_engine_on_the_card_matches_cpu(dev, name):
    """launch/serve.py's requests through ServingEngine at factor 1.25 on
    the card and on the CPU: every greedy token equal."""
    cfg, params = small(name)
    outs = []
    for device in ("cpu", dev):
        eng = ServingEngine(cfg, params, slots=4, max_len=64, device=device)
        outs.append([r.output for r in eng.run(make_requests(cfg, 8, 6))])
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
