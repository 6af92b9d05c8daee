"""The recurrent families' serving path on an NVIDIA GPU against the same
code on the CPU, at ``reduce()`` widths in fp32 (TF32 off).

Marked ``cuda``: without a GPU every test here skips (the decision is made
inside the fixture, never at import). On a machine with one:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_lm_recurrent_cuda.py

No kernel of the port runs here (the reference's recurrent blocks call
none; its sLSTM is a scan, not ``slstm_fused``): these hold the blocks'
products, scans and in-place state writes on the card to the CPU's
results. Weights are drawn at the full models' layer scale (std
1/sqrt(n), n the full model's layers of that kind), where the blocks are
conditioned; errors are over max |out|.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.common import map_params, materialize
from repro_torch.configs.base import get_config
from repro_torch.launch.serve import make_requests
from repro_torch.models import model as M
from repro_torch.models import recurrent as R
from repro_torch.models.transformer import layer_params
from repro_torch.serve.server import ServingEngine

pytestmark = pytest.mark.cuda

REL_TOL = 1e-4
# kind: (configuration, spec function, block, layers of that kind in full)
BLOCKS = {"rglru": ("recurrentgemma-2b", R.rglru_specs,
                    R.apply_rglru_block, 8),
          "mlstm": ("xlstm-1.3b", R.mlstm_specs, R.apply_mlstm_block, 42),
          "slstm": ("xlstm-1.3b", R.slstm_specs, R.apply_slstm_block, 6)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def one_block(kind: str):
    name, specs, apply, n = BLOCKS[kind]
    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    spec = map_params(lambda sp: dataclasses.replace(sp, init=("scaled", n))
                      if sp.init == "normal" else sp, specs(cfg, 1))
    return cfg, apply, layer_params(materialize(spec, seed=0, device="cpu"),
                                    0)


def fresh_state(kind, cfg, b, device):
    """The cache's zero state of one layer of ``kind``."""
    return M.layer_state(M.init_cache(cfg, b, 16, device=device), kind, 0)


def err(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


@pytest.mark.parametrize("kind,s", [("rglru", 64), ("mlstm", 32),
                                    ("mlstm", 128), ("slstm", 32)])
def test_block_on_the_card_matches_cpu(dev, kind, s):
    """One block from a carried zero state, then one decode step from the
    state it left: output and every state leaf within 1e-4 of max |out|
    (the mLSTM at S 32 takes the sequential scan, at 128 the chunkwise
    form; the card's C written in place)."""
    cfg, apply, p = one_block(kind)
    x = torch.randn((2, s + 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(0))
    p_dev = map_params(lambda t: t.to(dev), p)
    outs = {}
    for device, params in (("cpu", p), (dev, p_dev)):
        st = fresh_state(kind, cfg, 2, device)
        y, st1 = apply(cfg, params, x[:, :s].to(device), state=st)
        y1, st2 = apply(cfg, params, x[:, s:].to(device), state=st1)
        outs[str(device)] = (y, y1, st2)
    (y, y1, st), (yd, y1d, std) = outs["cpu"], outs[str(dev)]
    assert err(yd, y) <= REL_TOL and err(y1d, y1) <= REL_TOL
    for key in st:
        assert std[key].device.type == dev.type
        assert err(std[key], st[key]) <= REL_TOL, key


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "xlstm-1.3b"])
def test_engine_on_the_card_matches_cpu(dev, name):
    """launch/serve.py's requests through ServingEngine on the card and on
    the CPU, reduce() at materialize's scale: every greedy token equal."""
    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    params = materialize(M.param_specs(cfg), seed=0, device="cpu")
    outs = []
    for device in ("cpu", dev):
        eng = ServingEngine(cfg, params, slots=4, max_len=64, device=device)
        outs.append([r.output for r in eng.run(make_requests(cfg, 8, 6))])
    assert all(np.array_equal(a, b) for a, b in zip(*outs))
