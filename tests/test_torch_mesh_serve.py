"""``ServingEngine(mesh=)`` on a 2x2 ("data", "model") mesh of four CPU
ranks against the engine without a mesh: the same greedy tokens for
every request, in fp32 at ``reduce()`` (the port's seed-0 weights), one
configuration of each family that decodes (dense, moe with MLA, moe with
GQA, hybrid, ssm). Four requests of 5-8 prompt tokens and 6 new tokens
on 4 slots: prefill, the cache written in place on each rank's rows, and
decode (granite-moe and deepseek through the EP sequence body in prefill
and the EP decode body in decode). In bf16 the sharded sums round
differently and greedy tokens may part at these std-1 weights; the card's
``mesh`` phase checks bf16 on a one-rank mesh.
"""
import numpy as np
import pytest

from repro_torch.common import materialize
from repro_torch.configs.base import get_config
from repro_torch.models import model as TM
from repro_torch.serve.server import Request, ServingEngine

from test_torch_mesh_train import run_ranks

NAMES = ["granite-8b", "deepseek-v3-671b", "granite-moe-3b-a800m",
         "recurrentgemma-2b", "xlstm-1.3b"]

BODY = '''
import dataclasses
from repro_torch.common import materialize
from repro_torch.configs.base import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.server import Request, ServingEngine
out = {}
attention, seen = L.attention, set()


def counted(q, *args, **kwargs):
    seen.add(q.shape[2])
    return attention(q, *args, **kwargs)


L.attention = counted
for name in %r:
    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    params = materialize(M.param_specs(cfg), 0, device="cpu")
    prompts = inputs("q/" + name + "/")
    reqs = [Request(i, prompts[str(i)].numpy(), max_new=6)
            for i in range(len(prompts))]
    seen.clear()
    ServingEngine(cfg, params, slots=4, max_len=32, mesh=mesh).run(reqs)
    for r in reqs:
        out[name + "/" + str(r.uid)] = r.output
    out["heads_seen/" + name] = np.array(sorted(seen))
    cache = M.init_cache(cfg, 4, 32, mesh=mesh)
    out["cache_local/" + name] = np.array(
        [tuple(t.to_local().shape) for k, t in sorted(cache.items())
         if k.split("_")[-1] in ("k", "v")] or [(0,) * 5])
save(**out)
'''


def _prompts(cfg):
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, 5 + i).astype(np.int32)
            for i in range(4)]


@pytest.fixture(scope="module")
def mesh_tokens(tmp_path_factory):
    inputs = {}
    for name in NAMES:
        for i, p in enumerate(_prompts(get_config(name).reduce())):
            inputs[f"q/{name}/{i}"] = p
    return run_ranks(tmp_path_factory.mktemp("serve"), BODY % (NAMES,),
                     inputs=inputs)


#: q heads each rank's attention gets on the 2x2 mesh (4 q heads at
#: ``reduce()``): a half where the model axis divides the kv heads too
HEADS_SEEN = {"granite-8b": [2], "deepseek-v3-671b": [2],
              "granite-moe-3b-a800m": [2], "recurrentgemma-2b": [4],
              "xlstm-1.3b": []}


@pytest.mark.parametrize("name", NAMES)
def test_attention_on_a_share_of_the_heads(mesh_tokens, name):
    """The prefill's attention runs on each rank's share of the heads
    where the model axis divides both head counts (recurrentgemma's one
    kv head does not). The K/V caches lie as the reference's dry-run
    places them (``cache_logical_axes``): each rank holds a quarter of
    the whole, half the rows and half the positions with every kv head;
    the hybrid's rolling window only half the rows."""
    cfg = get_config(name).reduce()
    np.testing.assert_array_equal(mesh_tokens[f"heads_seen/{name}"],
                                  HEADS_SEEN[name])
    for shape in mesh_tokens[f"cache_local/{name}"]:
        if shape[0]:
            assert shape[1] == 2        # 4 rows over data
            window = cfg.family == "hybrid"
            assert shape[2] == (cfg.attn_window if window else 32 // 2)
            assert shape[3] == cfg.num_kv_heads


@pytest.mark.parametrize("name", NAMES)
def test_serving_on_mesh_matches_unsharded(mesh_tokens, name):
    import dataclasses

    cfg = dataclasses.replace(get_config(name).reduce(), dtype="float32")
    params = materialize(TM.param_specs(cfg), 0, device="cpu")
    reqs = [Request(i, p, max_new=6) for i, p in enumerate(_prompts(cfg))]
    ServingEngine(cfg, params, slots=4, max_len=32, device="cpu").run(reqs)
    for r in reqs:
        np.testing.assert_array_equal(mesh_tokens[f"{name}/{r.uid}"],
                                      r.output)
