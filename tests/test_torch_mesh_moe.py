"""``apply_moe``'s three mesh bodies on a 2x2 ("data", "model") mesh of
four CPU ranks against ``mesh=None`` (the reference's
tests/test_distributed.py::test_moe_ep_all_to_all_correct, at its bar
1e-4, in fp32):

- EP sequence-sharded: deepseek-v3 at ``reduce()`` with 8 experts and
  capacity factor 16 (nothing dropped), x of 2 x 8 tokens: the two tiled
  ``all_to_all``s over ``model``.
- EP decode: the same layer on 4 x 1 tokens (s == 1): tokens gathered
  over ``data``, the partial-d FFN summed over ``data``, the experts over
  ``model``.
- TP: 7 experts (2 does not divide them), the FFN's d_ff split over
  ``model`` and summed.

Each also takes a backward: the gradients of ``sum(out * g)`` with
respect to x and every weight, through the bodies' collectives and the
DTensor edges, against the local body's, within 1e-4 of each leaf's max.
"""
import numpy as np
import pytest

from test_torch_mesh_train import run_ranks

CASES = {"ep_seq": (8, (2, 8)), "ep_decode": (8, (4, 1)), "tp": (7, (2, 8))}

BODY = '''
import dataclasses
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.common import materialize, tree_leaves
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.optim.adamw import tree_map

CASES = %r
out = {}
for name, (experts, shape) in CASES.items():
    cfg = dataclasses.replace(get_config("deepseek-v3-671b").reduce(),
                              dtype="float32", num_experts=experts,
                              moe_capacity_factor=16.0)
    specs = M.param_specs(cfg)["moe_blocks"]["moe"]
    stacked = materialize(specs, 0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(shape + (cfg.d_model,), generator=gen)
    g = torch.randn(shape + (cfg.d_model,), generator=gen)
    # the layer as the model takes it: layer 0 of the stacked tree
    p_local = tree_map(lambda t: t[0].detach().requires_grad_(True),
                       {k: v for k, v in stacked.items() if k != "shared"})
    xl = x.clone().requires_grad_(True)
    ref, _ = MOE.apply_moe(cfg, p_local, xl, None)
    leaves = [xl] + [t for _, t in tree_leaves(p_local)]
    want = torch.autograd.grad((ref * g).sum(), leaves)

    placed = SH.shard_tree(stacked, SH.spec_tree_to_shardings(specs, mesh))
    p_mesh = tree_map(lambda t: t[0].detach().requires_grad_(True),
                      {k: v for k, v in placed.items() if k != "shared"})
    xm = DTensor.from_local(x.clone(), mesh, [Replicate()] * 2
                            ).requires_grad_(True)
    with SH.replicate_plain():
        got, aux = MOE.apply_moe(cfg, p_mesh, xm, mesh)
        mleaves = [xm] + [t for _, t in tree_leaves(p_mesh)]
        grads = torch.autograd.grad((got * g).sum(), mleaves)
    assert isinstance(got, DTensor)
    out[name + "/out"] = SH.full(got).detach().numpy()
    out[name + "/ref"] = ref.detach().numpy()
    out[name + "/aux"] = np.asarray(float(SH.full(aux)))
    names = ["x"] + [k for k, _ in tree_leaves(p_local)]
    for n, a, b in zip(names, grads, want):
        out[name + "/grad/" + n] = SH.full(a).detach().numpy()
        out[name + "/want/" + n] = b.numpy()
save(**out)
'''


@pytest.fixture(scope="module")
def bodies(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("moe"), BODY % (CASES,))


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_body_matches_local(bodies, name):
    got, want = bodies[name + "/out"], bodies[name + "/ref"]
    diff = float(np.abs(got - want).max())
    print(f"{name}: max |out - local| {diff:.3g}")
    assert got.shape == want.shape and diff < 1e-4
    assert np.isfinite(bodies[name + "/aux"])


@pytest.mark.parametrize("name", list(CASES))
def test_apply_moe_body_gradients_match_local(bodies, name):
    leaves = [k[len(name) + 6:] for k in bodies
              if k.startswith(name + "/grad/")]
    assert "x" in leaves and "wg" in leaves and "router" in leaves
    for leaf in leaves:
        got = bodies[f"{name}/grad/{leaf}"]
        want = bodies[f"{name}/want/{leaf}"]
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got - want).max()) / scale
        assert err < 1e-4, (leaf, err)


COLLECTIVES_BODY = '''
from repro_torch.parallel import shard_map as SM

axes = SM.Axes(mesh)
x = (torch.arange(24.).reshape(4, 6) + 100 * RANK).requires_grad_(True)
c1 = torch.arange(24.).reshape(2, 12) * (RANK + 1)
c2 = torch.arange(48.).reshape(4, 12) - 7 * RANK
a2a = SM.all_to_all(x, axes, "model", 0, 1)
gath = SM.all_gather(x, axes, "data", 1)
red = SM.psum(x, axes, "model")
g1, = torch.autograd.grad((a2a * c1).sum(), x)
g2, = torch.autograd.grad((gath * c2).sum(), x)
g3, = torch.autograd.grad((red * c2[:, :6]).sum(), x)
np.savez(os.path.join(DIR, "rank%d.npz" % RANK),
         **{k: v.detach().numpy() for k, v in dict(
             a2a=a2a, gath=gath, red=red, g1=g1, g2=g2, g3=g3).items()})
'''


def test_collectives_match_lax_semantics(tmp_path):
    """``shard_map``'s collectives at two ranks an axis, on gloo, against
    ``lax``'s tiled semantics worked out in numpy: ``all_to_all`` over
    ``model`` (chunk i of dim 0 to model rank i, received chunks
    concatenated on dim 1 in rank order), ``all_gather`` over ``data`` on
    dim 1, ``psum`` over ``model``, and each one's gradient (the inverse
    exchange, the reduce-scatter, the psum). Rank r sits at data r // 2,
    model r % 2. Exact: every value is a small integer."""
    run_ranks(tmp_path, COLLECTIVES_BODY)
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    xs = [np.arange(24.).reshape(4, 6) + 100 * r for r in range(4)]
    c1 = [np.arange(24.).reshape(2, 12) * (r + 1) for r in range(4)]
    c2 = [np.arange(48.).reshape(4, 12) - 7 * r for r in range(4)]
    for r in range(4):
        d, m = divmod(r, 2)
        mpeers = [2 * d + j for j in range(2)]
        dpeers = [2 * j + m for j in range(2)]
        a2a = np.concatenate([xs[p][2 * m:2 * m + 2] for p in mpeers], 1)
        gath = np.concatenate([xs[p] for p in dpeers], 1)
        g1 = np.concatenate([c1[p][:, 6 * m:6 * m + 6] for p in mpeers], 0)
        g2 = sum(c2[p][:, 6 * d:6 * d + 6] for p in dpeers)
        g3 = sum(c2[p][:, :6] for p in mpeers)
        want = dict(a2a=a2a, gath=gath, red=sum(xs[p] for p in mpeers),
                    g1=g1, g2=g2, g3=g3)
        for k, v in want.items():
            np.testing.assert_array_equal(got[r][k], v, err_msg=f"{k} r{r}")
