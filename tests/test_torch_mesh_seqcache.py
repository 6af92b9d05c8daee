"""The sequence-sharded decode cache on a 2x2 ("data", "model") mesh of
four CPU ranks: the K/V (granite-8b) and the MLA latents (deepseek-v3-671b)
lie as the reference's dry-run places them (``cache_logical_axes``: the
positions over ``model``), each rank writes the positions its share
holds, and the decode attention combines the ranks' partial softmaxes
(flash-decode: one ``pmax`` and one ``psum`` over model).

fp32 at ``reduce()`` with the port's seed-0 weights: a 9-token prompt
into a 12-slot cache (6 slots a rank: the prefill's write crosses the
shard boundary), then 6 greedy decode steps from the same tokens on and
off the mesh, the last three past ``max_len`` (the write clamps onto the
last slot, as ``lax.dynamic_update_slice`` does). The caches within
1e-5 of each leaf's max of the unsharded caches; prefill and decode
logits within 1e-4 of max |logit| of the unsharded ones, the reference's
bar for a sharded step against an unsharded one (tests/test_distributed.py,
tests/test_torch_mesh_moe.py): at ``reduce()``'s std-1 weights the
sharded layers' summation order alone parts the logits by up to 3.3e-6
of max |logit| with the cache whole on each model rank, and by up to
1.3e-5 with it split (the combine itself parts from the plain attention
by one ulp); ``ServingEngine(mesh=)`` tokens equal to the engine's
without a mesh.
"""
import dataclasses

import numpy as np
import pytest

from repro_torch.common import materialize
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.serve.server import Request, ServingEngine

from test_torch_mesh_train import run_ranks

NAMES = ["granite-8b", "deepseek-v3-671b"]
MAX_LEN, PROMPT, STEPS = 12, 9, 6

BODY = '''
import dataclasses
from repro_torch.common import materialize
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.serve import decode as D
from repro_torch.serve.server import Request, ServingEngine
from repro_torch.parallel import shard_map as SM
NAMES, MAX_LEN, STEPS = %r, %r, %r
data = np.load(os.path.join(DIR, "in.npz"))
out = {}
for name in NAMES:
    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    params = materialize(M.param_specs(cfg), 0, device="cpu")
    placed = SH.shard_tree(params, SH.spec_tree_to_shardings(
        M.param_specs(cfg), mesh))
    tokens = torch.from_numpy(data["prompt/" + name])
    calls0 = dict(SM.CALLS)
    with torch.no_grad():
        l0, c0 = D.prefill(cfg, params, {"tokens": tokens}, MAX_LEN)
        l1, c1 = D.prefill(cfg, placed, {"tokens": tokens}, MAX_LEN,
                           mesh=mesh)
        out[name + "/prefill"] = l0.numpy()
        out[name + "/prefill_mesh"] = SH.full(l1).numpy()
        for key, t in c1.items():
            if key != "index":
                out[name + "/cache_mesh/" + key] = SH.full(t).numpy()
                out[name + "/cache/" + key] = c0[key].numpy().copy()
                out[name + "/local/" + key] = np.array(t.to_local().shape)
        for i in range(STEPS):
            tok = l0[:, -1:].argmax(-1).to(torch.int32)
            l0, c0 = D.decode_step(cfg, params, tok, c0)
            l1, c1 = D.decode_step(cfg, placed, tok, c1, mesh=mesh)
            out[name + "/decode/%%d" %% i] = l0.numpy()
            out[name + "/decode_mesh/%%d" %% i] = SH.full(l1).numpy()
    out[name + "/combines"] = np.array(SM.CALLS["pmax"] - calls0["pmax"])
    reqs = [Request(i, data["req/%%s/%%d" %% (name, i)], max_new=4)
            for i in range(4)]
    ServingEngine(cfg, params, slots=4, max_len=MAX_LEN, mesh=mesh).run(reqs)
    for r in reqs:
        out[name + "/engine/%%d" %% r.uid] = r.output
save(**out)
''' % (NAMES, MAX_LEN, STEPS)


def _requests(cfg):
    rng = np.random.default_rng(1)
    return [rng.integers(0, cfg.vocab_size, 5 + i).astype(np.int32)
            for i in range(4)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    inputs = {}
    for name in NAMES:
        cfg = get_config(name).reduce()
        rng = np.random.default_rng(0)
        inputs[f"prompt/{name}"] = rng.integers(
            0, cfg.vocab_size, (4, PROMPT)).astype(np.int32)
        for i, r in enumerate(_requests(cfg)):
            inputs[f"req/{name}/{i}"] = r
    return run_ranks(tmp_path_factory.mktemp("seqcache"), BODY,
                     inputs=inputs)


def _close(a, b, bar=1e-5):
    scale = float(np.abs(a).max())
    err = float(np.abs(a - b).max())
    print(f"max |diff| {err:.3g} of max |value| {scale:.3g}")
    assert err <= bar * scale, (err, scale)


@pytest.mark.parametrize("name", NAMES)
def test_cache_lies_on_its_share_of_the_positions(ranks, name):
    """Each rank holds half the rows and half the 12 positions of every
    K/V or latent leaf, and the prefill's 9 positions (across the
    boundary at 6) land where the unsharded prefill puts them (within
    1e-5 of the leaf's max: the sharded layers sum in another order)."""
    keys = [k for k in ranks if k.startswith(f"{name}/local/")]
    assert keys
    for key in keys:
        shape = ranks[key]
        assert shape[1] == 4 // 2 and shape[2] == MAX_LEN // 2, (key, shape)
        leaf = key.split("/")[-1]
        _close(ranks[f"{name}/cache/{leaf}"],
               ranks[f"{name}/cache_mesh/{leaf}"])


@pytest.mark.parametrize("name", NAMES)
def test_flash_decode_matches_unsharded_past_max_len(ranks, name):
    """Prefill and 6 decode steps (positions 9..14 of a 12-slot cache:
    the last three clamp onto slot 11) within 1e-4 of max |logit|, through
    the flash-decode combine at every decode layer."""
    _close(ranks[f"{name}/prefill"], ranks[f"{name}/prefill_mesh"], 1e-4)
    for i in range(STEPS):
        _close(ranks[f"{name}/decode/{i}"], ranks[f"{name}/decode_mesh/{i}"],
               1e-4)
    assert int(ranks[f"{name}/combines"]) >= STEPS


@pytest.mark.parametrize("name", NAMES)
def test_engine_on_seq_sharded_cache_matches_unsharded(ranks, name):
    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    params = materialize(TM.param_specs(cfg), 0, device="cpu")
    reqs = [Request(i, p, max_new=4) for i, p in enumerate(_requests(cfg))]
    ServingEngine(cfg, params, slots=4, max_len=MAX_LEN, device="cpu").run(
        reqs)
    for r in reqs:
        np.testing.assert_array_equal(ranks[f"{name}/engine/{r.uid}"],
                                      r.output)

