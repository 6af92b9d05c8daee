"""The sharded train step on a 2x2 ("data", "model") mesh of four CPU
ranks (gloo) against the JAX package's unsharded step.

Each mesh test runs its ranks as four processes of a script written under
``tmp_path`` (``run_ranks``): they meet through a ``FileStore`` there (no
TCP port, so parallel test workers never collide), run one thread each,
and rank 0 writes what it gathered to ``out.npz``. Inputs go the other way
in ``in.npz``. The JAX side runs in the test process.

granite-8b at ``reduce()`` in fp32: the JAX package's seed-0 weights,
placed on their shardings (``spec_tree_to_shardings``: FSDP over data, TP
over model), one step at the smoke recipe on a batch of 4 x 32 sharded
over data. Held to tests/test_torch_lm_train_step.py's bars (loss, ce,
aux, grad_norm, the moments, every weight whose gradient is above
rounding level within 1e-4), and the loss within 2e-4, the reference's
own bar for its sharded step (tests/test_distributed.py). The updated
params and moments keep their shardings. Then two microbatches and
EF-int8 on the mesh, at the same bars.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro_torch.common import tree_leaves
from repro_torch.data.pipeline import TokenPipeline

from test_torch_lm_train_step import (_nest, check_leaves, check_moments,
                                      check_params, check_scalars, configs,
                                      flat, jax_runs, leaf_bar, setup)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PREAMBLE = '''
import os, sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
RANK, WORLD, DIR = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", rank=RANK, world_size=WORLD,
                        store=dist.FileStore(os.path.join(DIR, "store"), WORLD))
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.parallel import sharding as SH
mesh = make_debug_mesh((2, 2), ("data", "model"), device="cpu")


def nest(flat):
    out = {}
    for key, v in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def inputs(prefix):
    data = np.load(os.path.join(DIR, "in.npz"))
    return nest({k[len(prefix):]: torch.from_numpy(data[k]) for k in data
                 if k.startswith(prefix)})


def gathered(prefix, tree):
    from repro_torch.common import tree_leaves
    return {prefix + k: SH.full(v).detach().float().numpy()
            for k, v in tree_leaves(tree)}


def save(**arrays):
    if RANK == 0:
        np.savez(os.path.join(DIR, "out.npz"), **arrays)
'''

EPILOGUE = '''
dist.barrier()
dist.destroy_process_group()
'''


def run_ranks(tmp_path, body: str, world: int = 4, timeout: int = 300,
              inputs=None) -> dict:
    """Run ``body`` on ``world`` gloo ranks (a 2x2 mesh named ``mesh``);
    ``inputs`` (name -> array) go to ``in.npz``. Returns rank 0's
    ``out.npz`` as a dict (empty when it saved nothing)."""
    if inputs is not None:
        np.savez(tmp_path / "in.npz", **inputs)
    script = tmp_path / "ranks.py"
    script.write_text(PREAMBLE + textwrap.dedent(body) + EPILOGUE)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world), str(tmp_path)],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{err[-4000:]}"
    print(outs[0][0])
    out = tmp_path / "out.npz"
    return dict(np.load(out)) if out.exists() else {}


def flat_inputs(prefix, tree) -> dict:
    """A JAX (or numpy) tree's leaves as ``prefix + path`` -> array, in
    their own dtype."""
    return {prefix + k: np.asarray(v)
            for k, v in tree_leaves(jax.device_get(tree))}


TRAIN_BODY = '''
import dataclasses
from repro_torch.configs.base import get_config
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.train import steps as TS
from torch.distributed.tensor import DTensor
from repro_torch.common import tree_leaves as tree_leaves_of

MICROBATCHES, COMPRESS = %r, %r
cfg = dataclasses.replace(get_config("granite-8b").reduce(), dtype="float32")
tc = TS.TrainConfig(microbatches=MICROBATCHES, compress_pod_grads=COMPRESS,
                    optimizer=adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=10))
shardings = SH.spec_tree_to_shardings(M.param_specs(cfg), mesh)
sharded = SH.shard_tree(inputs("p/"), shardings)
extra = (SH.shard_tree(inputs("e/"), shardings),) if COMPRESS else ()
out = TS.make_train_step(cfg, tc, mesh)(
    sharded, adamw.init_state(tc.optimizer, sharded), inputs("b/"), *extra)
p2, o2, m = out[:3]
# the step keeps every leaf on its sharding, the AdamW state's too
for tree in (p2, o2.mu, o2.nu, o2.master) + out[3:]:
    for (k, a), (_, s) in zip(tree_leaves_of(tree), tree_leaves_of(shardings)):
        assert isinstance(a, DTensor) and tuple(a.placements) == s.placements, k
save(**gathered("p/", p2), **gathered("mu/", o2.mu), **gathered("nu/", o2.nu),
     **(gathered("e/", out[3]) if COMPRESS else {}),
     **{"m/" + k: np.asarray(float(v)) for k, v in m.items()},
     step=np.asarray(int(o2.step)))
'''


class _Moments:
    def __init__(self, mu, nu):
        self.mu, self.nu = mu, nu


def mesh_step(tmp_path, jp, batch, microbatches=1, err_np=None):
    """The port's step of granite-8b on the 2x2 mesh from the JAX
    package's weights: (params, moments, metrics[, error]) as flat numpy
    dicts, gathered whole."""
    compress = err_np is not None
    inputs = {**flat_inputs("p/", jp),
              **{"b/" + k: v for k, v in batch.items()}}
    if compress:
        inputs.update({"e/" + k: v for k, v in err_np.items()})
    out = run_ranks(tmp_path, TRAIN_BODY % (microbatches, compress),
                    inputs=inputs)
    assert int(out["step"]) == 1

    def part(prefix):
        return {k[len(prefix):]: v.astype(np.float64)
                for k, v in out.items() if k.startswith(prefix)}

    got = (part("p/"), _Moments(part("mu/"), part("nu/")),
           {k: float(v) for k, v in part("m/").items()})
    return got + ((part("e/"),) if compress else ())


def test_sharded_train_step_matches_reference(tmp_path):
    jc, tc, jp = setup("granite-8b")
    jtc, _ = configs()
    batch = TokenPipeline(tc, 4, 32).next_batch()
    (jp2, jo2, jm), jg, (_, o64, m64), g64 = jax_runs(jc, jtc, jp, batch)
    params, moments, tm = mesh_step(tmp_path, jp, batch)
    loss_diff = abs(tm["loss"] - float(jm["loss"]))
    print(f"granite-8b 2x2: loss {tm['loss']} vs {float(jm['loss'])} "
          f"(diff {loss_diff:.3g})")
    assert loss_diff < 2e-4
    check_scalars(tm, jm, m64)
    check_moments(moments, jo2, o64)
    want_g, want_g64 = flat(jg), flat(g64)
    bars = {k: leaf_bar(want_g[k], want_g64[k]) for k in want_g}
    loose = check_params(params, flat(jp2), want_g, bars)
    n = sum(v.size for v in want_g.values())
    print(f"{loose} of {n} weights with a rounding-level gradient moved "
          "apart by more than 1e-4")


@pytest.mark.parametrize("mode", ["microbatches2", "ef_int8"])
def test_sharded_microbatches_and_ef_int8_match_reference(tmp_path, mode):
    """Two microbatches (each sharded over data), or EF-int8 on the
    sharded gradients with a carried error state (each leaf's scale over
    the whole leaf), against the JAX package's step at
    tests/test_torch_lm_train_step.py's bars; under EF-int8 a gradient
    within its bar of a code's half-way point may take the neighbouring
    code, and those elements are held to one quantisation step."""
    jc, tc, jp = setup("granite-8b")
    mb, comp = (2, False) if mode == "microbatches2" else (1, True)
    jtc, _ = configs(mb, comp)
    batch = TokenPipeline(tc, 8, 32, seed=1).next_batch()
    err_np = None
    if comp:
        rng = np.random.default_rng(5)
        err_np = {k: (1e-3 * rng.standard_normal(v.shape)).astype(np.float32)
                  for k, v in flat(jp).items()}
    jerr = _nest(err_np, jnp.asarray) if comp else None
    out, jg, out64, jg64 = jax_runs(jc, jtc, jp, batch, jerr)
    got = mesh_step(tmp_path, jp, batch, mb, err_np)
    assert abs(got[2]["loss"] - float(out[2]["loss"])) < 2e-4
    if not comp:
        check_scalars(got[2], out[2], out64[2])
        check_moments(got[1], out[1], out64[1])
        return
    g, g64 = flat(jg), flat(jg64)
    steps = {k: np.abs(g[k] + err_np[k]).max() / 127.0 for k in g}
    e_got, e_want = got[3], flat(out[3])
    flips = {k: np.abs(e_got[k] - e_want[k]) > steps[k] / 2 for k in g}
    for k, f in flips.items():
        d = np.abs(e_got[k] - e_want[k])[f]
        assert d.size == 0 or np.abs(d - steps[k]).max() <= leaf_bar(
            g[k], g64[k]), (k, d[:5], steps[k])
    norm = float(out[2]["grad_norm"])
    deq = {k: g[k] + err_np[k] - e_want[k] for k in g}
    norm_extra = sum(float((2 * np.abs(deq[k][f]) * steps[k]
                            + steps[k] ** 2).sum())
                     for k, f in flips.items()) / (2 * norm ** 2)
    print(f"EF-int8 on the mesh: {sum(int(f.sum()) for f in flips.values())}"
          f" of {sum(f.size for f in flips.values())} int8 codes differ")
    check_scalars(got[2], out[2], out64[2], norm_extra)
    check_moments(got[1], out[1], out64[1], skip=flips,
                  norms=[m[2]["grad_norm"] for m in (got, out, out64)])
    check_leaves(e_got, e_want, flat(out64[3]), "error", skip=flips)
