"""Multi-pod dry-run: trace one step of every (arch x shape) cell on the
production mesh (16x16 single pod / 2x16x16 multi-pod) with NOTHING
allocated, and read from rank 0's view the per-device memory, matmul
flops, bytes moved and collective bytes. The counterpart of
``repro/launch/dryrun.py``, which lowers and compiles on forced host
devices and reads the HLO.

The mesh is a DeviceMesh of ``--device`` type (default ``cuda``) over a
``torch.distributed`` "fake" process group of 256 or 512 ranks, whose
collectives return at once. Every tensor is a "meta" tensor: the
params, optimizer state, batch and cache are DTensors whose local shards
are meta tensors of this rank's shapes (``parallel.sharding.meta_dtensor``),
so the step's collectives are its own, not the placement's. (Meta, not
``FakeTensorMode``'s CUDA tensors: autograd records each CUDA input's
stream through the CUDA device guard, which a torch built without CUDA
does not have.) The step runs under ``launch.op_analysis.OpAnalysis``:
flops, bytes, collectives, and the peak of live local storage
(``memory_analysis``). Not ``MemTracker``'s peak: before torch 2.13 it
also counts the global-shaped ops of DTensor's sharding propagation
(granite-moe-3b-a800m ``decode_32k``: 139 GB a device under torch 2.11,
against 1.57 GB), and it takes a third of a trace's time; chip_smoke's
``dryrun`` phase reports it beside the analyzer's. Decode gets the
concrete index ``seq_len - 1``.

Roofline terms, with the H100 SXM data sheet's constants:

  compute    = flops_per_device / 989e12         [bf16 dense, per GPU]
  memory     = bytes_per_device / 3.35e12        [HBM3]
  collective = wire_bytes_per_device / 50e9      [one 400 Gb/s NDR port:
                                                  every group of these
                                                  meshes spans nodes]

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-32b \\
      --shape train_4k [--multi-pod] [--placed] [--out out.json] \\
      [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import time
from typing import Dict

import torch

PEAK_FLOPS = 989e12        # bf16 dense flop/s, H100 SXM
HBM_BW = 3.35e12           # bytes/s, H100 SXM HBM3
LINK_BW = 50e9             # bytes/s per GPU across nodes (400 Gb/s NDR)

# per-arch training-step overrides so the big models fit (the reference's)
DRYRUN_TRAIN_OVERRIDES: Dict[str, Dict] = {
    "deepseek-v3-671b": dict(microbatches=8, master_fp32=False),
    "qwen2-72b": dict(microbatches=4, master_fp32=True),
    "qwen2.5-32b": dict(microbatches=2, master_fp32=True),
}


def active_params(cfg) -> int:
    """Params touched per token (MoE: shared + top_k of routed)."""
    from repro_torch.common import param_count
    from repro_torch.models import model as M

    total = param_count(M.param_specs(cfg))
    if not cfg.num_experts:
        return total
    nm = cfg.num_layers - cfg.num_dense_layers
    expert_p = nm * cfg.num_experts * 3 * cfg.d_model * cfg.d_ff_expert
    active_expert_p = expert_p * cfg.top_k / cfg.num_experts
    return int(total - expert_p + active_expert_p)


def model_flops(cfg, shape) -> float:
    n = active_params(cfg)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per row


@contextlib.contextmanager
def fake_world(ranks: int):
    """A "fake" default process group of ``ranks`` ranks, this process
    rank 0, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=ranks)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _tensors(tree) -> list:
    from torch.utils import _pytree

    return [t for t in _pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _local_bytes(tree) -> int:
    from repro_torch.parallel.sharding import is_dtensor

    return sum((t.to_local() if is_dtensor(t) else t).numel()
               * t.element_size() for t in _tensors(tree))


def cache_bytes(cfg, shape, mesh) -> Dict:
    """Per-device bytes of the decode cache under the port's layout
    (``model.cache_placements``: the recurrent states on the batch only)
    and the reference's (``cache_logical_axes`` for every leaf), by leaf."""
    from repro_torch.launch.specs import batch_shardings
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import local_shape

    ref = batch_shardings(cfg, shape, mesh)["cache"]
    out = {"port": 0, "reference": 0, "by_leaf": {}}
    for k, m in M.init_cache_shapes(cfg, shape.global_batch,
                                    shape.seq_len).items():
        if k == "index":
            continue
        port = math.prod(local_shape(m.shape, mesh, M.cache_placements(
            cfg, k, m.shape, mesh))) * m.element_size()
        theirs = math.prod(local_shape(m.shape, mesh, ref[k].placements)) \
            * m.element_size()
        out["port"] += port
        out["reference"] += theirs
        out["by_leaf"][k] = {"port": port, "reference": theirs}
    return out


def trace(cfg, shape, mesh, *, arch: str = None, rules=None):
    """One step of (cfg, shape) on ``mesh`` under the analyzer: (costs,
    memory dict, seconds). ``arch`` picks ``DRYRUN_TRAIN_OVERRIDES``."""
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharding as SH
    from repro_torch.serve import decode as D
    from repro_torch.train.steps import TrainConfig, make_train_step

    rules = rules or SH.active_rules()
    with SH.use_rules(rules):
        specs = M.param_specs(cfg)
        shard = SH.spec_tree_to_shardings(specs, mesh, rules)

        def place(spec, sh):
            if isinstance(spec, dict):
                return {k: place(spec[k], sh[k]) for k in spec}
            return SH.meta_dtensor(spec.shape, spec.dtype, mesh,
                                   sh.placements)

        params = place(specs, shard)
        io = input_specs(cfg, shape)
        if shape.kind == "train":
            ov = DRYRUN_TRAIN_OVERRIDES.get(arch or cfg.name, {})
            tc = TrainConfig(
                microbatches=ov.get("microbatches", 1),
                optimizer=adamw.AdamWConfig(
                    master_fp32=ov.get("master_fp32", True)))
            opt = adamw.init_state(tc.optimizer, params)
            step = make_train_step(cfg, tc, mesh)
            # the batch is split into microbatches before it is sharded
            # (train.steps): its local shards are made inside the step
            args = (params, opt, io)
            extra = {"batch": sum(
                math.prod(SH.local_shape(v.shape, mesh, SH.batch_sharding(
                    mesh, v.shape).placements)) * v.element_size()
                for v in io.values())}
            run = step
        elif shape.kind == "prefill":
            batch = SH.place_batch(io, mesh)
            args, extra = (params, batch), {}
            if cfg.decoder:
                def run(p, b):
                    with torch.no_grad():
                        return D.prefill(cfg, p, b, max_len=shape.seq_len,
                                         mesh=mesh)
            else:
                def run(p, b):
                    with torch.no_grad():
                        return M.forward(cfg, p, b, mesh)
        else:
            cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 device="meta", mesh=mesh)
            cache["index"] = shape.seq_len - 1
            tokens = SH.place_batch({"tokens": io["tokens"]}, mesh)["tokens"]
            args, extra = (params, tokens, cache), {}

            def run(p, t, c):
                with torch.no_grad():
                    return D.decode_step(cfg, p, t, c, mesh=mesh)

        arg_bytes = _local_bytes(args) + sum(extra.values())
        held = _tensors(args[:2] if shape.kind == "train" else args)
        gc.collect()        # earlier garbage is not freed inside the trace
        t0 = time.time()
        with OpAnalysis() as mode:
            mode.track(*held)
            out = run(*args)
        seconds = time.time() - t0
        out_bytes = _local_bytes(out)
    costs = mode.result()
    peak = costs.peak_bytes
    memory = {"argument_bytes": arg_bytes, "output_bytes": out_bytes,
              "temp_bytes": max(peak - arg_bytes, 0), "alias_bytes": 0,
              "peak_bytes": peak}
    return costs, memory, seconds


def roofline(costs, cfg, shape, chips: int) -> Dict:
    """The reference's three terms on this card's constants, with the
    memory term less the traffic the port's kernels keep on chip."""
    flops_dev = float(costs.flops)
    bytes_dev = float(costs.hbm_bytes)
    wire_dev = float(costs.collective_wire_bytes)
    compute_t = flops_dev / PEAK_FLOPS
    memory_t = bytes_dev / HBM_BW
    coll_t = wire_dev / LINK_BW
    # csrc/flash_attention.cu keeps the score chain on chip: ~6 HBM passes
    # over the score tensor disappear (the reference's estimate)
    flash_saving = 6.0 * float(costs.attention_score_bytes)
    # csrc/slstm.cu keeps the step loop's state on chip: one in/out pass
    # of the loop's traffic stays (the reference's 1/512 floor)
    rnn_saving = float(costs.hbm_bytes_seq_loops) * (1.0 - 1.0 / 512)
    memory_k = max(bytes_dev - flash_saving - rnn_saving, 0.0) / HBM_BW
    dominant = max((("compute", compute_t), ("memory", memory_t),
                    ("collective", coll_t)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_t, "memory_s": memory_t,
            "memory_s_kernels": memory_k, "collective_s": coll_t,
            "dominant": dominant,
            "step_time_lower_bound_s": max(compute_t, memory_t, coll_t),
            "step_time_lower_bound_kernels_s": max(compute_t, memory_k,
                                                   coll_t)}


def trace_cell(arch: str, shape_name: str, multi_pod: bool = False,
               placed: bool = False, device: str = "cuda", cfg=None,
               shape=None):
    """The dry-run of one cell as the reference's JSON (``lower_cell``'s
    keys; ``trace_s`` for ``lower_s`` / ``compile_s``). ``cfg`` /
    ``shape`` stand in for the registry's (tests trace ``reduce()``)."""
    from repro_torch.configs.base import SHAPES, applicable_shapes, get_config
    from repro_torch.core.placement import arch_rules, choose_rules
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.parallel import sharding as SH

    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    if shape.name not in {s.name for s in applicable_shapes(cfg)}:
        return {"skipped": True,
                "reason": "shape not applicable (DESIGN.md §7)"}
    chips = 512 if multi_pod else 256
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device=device)
        mesh_shape = SH.mesh_axes(mesh)
        # the congestion-aware placement pass runs by default; --placed
        # applies the traffic-model rule selection on top
        rules = arch_rules(cfg, shape, mesh_shape)
        placement_info = {"arch_rules": {
            k: list(v) for k, v in rules.items()
            if v != SH.DEFAULT_RULES.get(k)}}
        if placed:
            name, chosen, report, _ = choose_rules(cfg, shape, mesh_shape)
            rules.update({k: v for k, v in chosen.items()
                          if k not in ("act_q_seq", "act_kv_seq")})
            placement_info.update({"chosen": name, "cost": report.cost,
                                   "per_axis": report.per_axis_bytes})
        costs, memory, seconds = trace(cfg, shape, mesh, arch=arch,
                                       rules=rules)
        caches = cache_bytes(cfg, shape, mesh) \
            if shape.kind == "decode" else None

    flops_dev = float(costs.flops)
    mf = model_flops(cfg, shape)
    out = {
        "arch": arch, "shape": shape.name,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "device": device, "trace_s": round(seconds, 1),
        "memory_analysis": memory,
        "flops_per_device": flops_dev,
        "bytes_per_device": float(costs.hbm_bytes),
        "wire_bytes_per_device": float(costs.collective_wire_bytes),
        # no XLA here: the key stays, empty
        "xla_cost_analysis_flops_raw": None,
        "model_flops_global": mf,
        "model_flops_per_device": mf / chips,
        "useful_flops_ratio": (mf / chips) / flops_dev if flops_dev else None,
        "ops": costs.ops, "launches": costs.launches,
        "attention_score_bytes": costs.attention_score_bytes,
        "hbm_bytes_seq_loops": costs.hbm_bytes_seq_loops,
        "collectives": {
            "counts": costs.collective_counts,
            "result_bytes": costs.collective_result_bytes,
            "groups": costs.collective_groups,
            "wire_bytes_per_chip": float(costs.collective_wire_bytes),
            "largest_result_bytes_by_site": costs.site_result_bytes,
            "top_sites": [{"wire_bytes": w, "kind": k, "site": s}
                          for w, k, s in costs.top_collective_sites[:10]],
        },
        "roofline": roofline(costs, cfg, shape, chips),
        "placement": placement_info,
    }
    if caches is not None:
        out["cache_bytes_per_device"] = caches
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--placed", action="store_true",
                    help="use congestion-aware placement rules")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake mesh's device type")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    res = trace_cell(args.arch, args.shape, args.multi_pod, args.placed,
                     args.device)
    js = json.dumps(res, indent=2, default=str)
    print(js)
    if args.out:
        with open(args.out, "w") as f:
            f.write(js)


if __name__ == "__main__":
    main()
