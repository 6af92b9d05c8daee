"""The LM train step on an NVIDIA GPU against the same code on the CPU,
at ``reduce()`` widths in fp32 (TF32 off).

Marked ``cuda``: without a GPU every test here skips (the decision is made
inside the fixture, never at import). On a machine with one:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_lm_train_cuda.py

No kernel of the port runs here (the LM training path calls none): these
hold autograd's products on the card to the CPU's. Every stacked layer
weight is drawn at the full model's layer scale (std 1/sqrt(n), n its
layers), where the models are conditioned: at ``reduce()``'s own scale
(std 1/sqrt(4)) a GEMM's summation order alone moves recurrentgemma's
embedding gradient card against CPU by 2e-3 of its max. Bars, as in
tests/test_torch_lm_train_step.py with the CPU's own float64 run (the
port's code on float64 weights and inputs, its fp32 casts kept) as the
spread: loss and ce within 1e-4 of max(1, |value|) or twice the spread,
grad_norm relative to its value, each gradient, mu and sqrt(nu) leaf
within 1e-4 of its max or four times the spread on that leaf. The mLSTM's
gradient in both forms (S 32 sequential, S 128 chunkwise) at the full
model's layer scale (std 1/sqrt(42)): each leaf within 1e-4 of its max
|g| or four times the CPU's float64 spread.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.common import map_params, materialize, tree_leaves
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models import model as M
from repro_torch.models import recurrent as R
from repro_torch.models.transformer import layer_params
from repro_torch.optim import adamw
from repro_torch.train import steps as TS

pytestmark = pytest.mark.cuda

REL = 1e-4
FAMILIES = ["granite-8b", "internvl2-1b", "hubert-xlarge",
            "granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-1.3b"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@dataclasses.dataclass(frozen=True)
class Float64Config(ModelConfig):
    """A configuration whose activations run in float64: the frontends'
    casts to ``cfg.torch_dtype`` keep float64 inputs (the fp32 casts inside
    the blocks stay)."""

    @property
    def torch_dtype(self):
        return torch.float64


def layer_scaled(name: str, cfg):
    """``cfg``'s specs with every "normal" leaf of a layer stack drawn at
    std 1/sqrt(the full model's layers)."""
    n = get_config(name).num_layers
    outside = ("embed", "unembed", "final_norm", "projector", "frontend_proj")
    return {k: v if k in outside else map_params(
        lambda sp: dataclasses.replace(sp, init=("scaled", n))
        if sp.init == "normal" else sp, v)
        for k, v in M.param_specs(cfg).items()}


def to(tree, device, dtype=None):
    return map_params(lambda t: t.to(device=device, dtype=dtype
                                     if t.is_floating_point() else None),
                      tree)


def flat(tree) -> dict:
    return {k: v.detach().double().cpu().numpy() for k, v in tree_leaves(tree)}


def hold_leaves(got, want, want64, what):
    for k in want:
        bar = max(REL * float(np.abs(want[k]).max()),
                  4 * float(np.abs(want[k] - want64[k]).max()))
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= bar, (what, k, err, bar)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_card_matches_cpu(name, dev):
    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    tc = TS.TrainConfig(optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                    total_steps=10))
    params = materialize(layer_scaled(name, cfg), seed=0, device="cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in TokenPipeline(cfg, 2, 32).next_batch().items()}
    cfg64 = Float64Config(**dataclasses.asdict(cfg))
    runs = {}
    for key, device, dtype in (("card", dev, None), ("cpu", "cpu", None),
                               ("cpu64", "cpu", torch.float64)):
        c = cfg64 if dtype else cfg
        p = to(params, device, dtype)
        b = to(batch, device, dtype)
        (_, _), g = TS._value_and_grad(c, tc, p, b)
        _, o2, m = TS.make_train_step(c, tc)(
            p, adamw.init_state(tc.optimizer, p), b)
        runs[key] = (flat(g), o2, {k: float(v) for k, v in m.items()})
    (g, o, m), (gw, ow, mw), (g64, o64, m64) = (runs[k] for k in
                                                ("card", "cpu", "cpu64"))
    for k in ("loss", "ce", "aux"):
        bar = max(REL * max(1.0, abs(mw[k])), 2 * abs(mw[k] - m64[k]))
        assert abs(m[k] - mw[k]) <= bar, (k, m[k], mw[k], m64[k])
    assert abs(m["grad_norm"] - mw["grad_norm"]) / mw["grad_norm"] <= max(
        REL, 4 * abs(mw["grad_norm"] - m64["grad_norm"]) / mw["grad_norm"])
    hold_leaves(g, gw, g64, "grad")
    hold_leaves(flat(o.mu), flat(ow.mu), flat(o64.mu), "mu")
    hold_leaves(*({k: np.sqrt(v) for k, v in flat(t.nu).items()}
                  for t in (o, ow, o64)), "sqrt(nu)")


@pytest.mark.parametrize("s", [32, 128], ids=["sequential", "chunkwise"])
def test_mlstm_gradient_card_matches_cpu(s, dev):
    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduce(),
                              dtype="float32")
    spec = map_params(lambda sp: dataclasses.replace(sp, init=("scaled", 42))
                      if sp.init == "normal" else sp, R.mlstm_specs(cfg, 1))
    p = layer_params(materialize(spec, seed=0, device="cpu"), 0)
    rng = np.random.default_rng(s)
    x = torch.from_numpy(rng.standard_normal((2, s, cfg.d_model))
                         .astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    grads = {}
    for key, device, dtype in (("card", dev, torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("cpu64", "cpu", torch.float64)):
        leaves = {k: v.to(device, dtype).requires_grad_(True)
                  for k, v in p.items()}
        xt = x.to(device, dtype).requires_grad_(True)
        out, _ = R.apply_mlstm_block(cfg, leaves, xt)
        g = torch.autograd.grad(out, list(leaves.values()) + [xt],
                                ct.to(device, dtype))
        grads[key] = {k: t.double().cpu().numpy()
                      for k, t in zip(list(leaves) + ["x"], g)}
    hold_leaves(grads["card"], grads["cpu"], grads["cpu64"], "mlstm grad")
