"""Congestion-aware placement (paper §IV-F): a copy of
``repro/core/placement.py``, numpy on a ``mesh_shape`` dict, with its two
TPU translations:

A. Graph-on-grid placement — the literal analogue of the paper's ADF
   placement (Fig 8): CRONet's kernel graph is placed onto a 2D tile grid
   so that dataflow-adjacent kernels occupy neighbouring tiles. Cost =
   sum(edge_bytes * manhattan_distance); greedy BFS placement vs the
   default (row-major) placer reproduces the Table VI effect in the
   congestion currency that exists on TPU (benchmarks/placement.py).

B. Sharding-rule selection — for the LM architectures, "placement" means
   deciding which mesh axis each logical tensor axis shards over. An
   analytic collective-traffic model scores rule candidates and the best
   assignment is installed via parallel.sharding.use_rules.
   The same bytes x hops currency: ICI links are the congested resource.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import DEFAULT_RULES

# ---------------------------------------------------------------------------
# A. Graph-on-grid placement (CRONet / ADF analogue)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KernelNode:
    name: str
    tiles: int          # how many engines/cores this subgraph occupies


@dataclasses.dataclass
class Edge:
    src: str
    dst: str
    bytes: int


def cronet_graph(cfg) -> Tuple[List[KernelNode], List[Edge]]:
    """CRONet's subgraph topology with paper Table IV tile counts and
    Table I traffic estimates (bf16 bytes between stages)."""
    ny, nx = cfg.nely, cfg.nelx
    H, W = cfg.nodes
    T = cfg.hist_len
    nodes = [
        KernelNode("t_conv3d1", 16), KernelNode("t_conv3d2", 24),
        KernelNode("t_aap3d", 8), KernelNode("t_fc1", 23),
        KernelNode("t_fc2", 11),
        KernelNode("b_conv2d1", 5), KernelNode("b_conv2d2", 40),
        KernelNode("b_maxpool", 40), KernelNode("b_aap2d", 5),
        KernelNode("b_rnn", 28), KernelNode("b_fc1", 1),
        KernelNode("b_fc2", 11), KernelNode("mul", 11),
    ]
    e2 = 2  # bf16
    edges = [
        Edge("t_conv3d1", "t_conv3d2", 4 * H * W * cfg.t_c1 * e2),
        Edge("t_conv3d2", "t_aap3d", 4 * H * W * cfg.t_c2 * e2),
        Edge("t_aap3d", "t_fc1", cfg.trunk_features * e2),
        Edge("t_fc1", "t_fc2", cfg.mid * e2),
        Edge("t_fc2", "mul", cfg.p * e2),
        Edge("b_conv2d1", "b_conv2d2", T * ny * nx * cfg.b_c1 * e2),
        Edge("b_conv2d2", "b_maxpool", T * ny * nx * cfg.b_c2 * e2),
        Edge("b_maxpool", "b_aap2d", T * (ny // 2) * (nx // 2) * cfg.b_c2 * e2),
        Edge("b_aap2d", "b_rnn", T * cfg.branch_features * e2),
        Edge("b_rnn", "b_fc1", cfg.rnn_hidden * e2),
        Edge("b_fc1", "b_fc2", cfg.mid * e2),
        Edge("b_fc2", "mul", cfg.p * e2),
    ]
    return nodes, edges


def _tile_coords(grid: Tuple[int, int]):
    return [(r, c) for r in range(grid[0]) for c in range(grid[1])]


def place_rowmajor(nodes: Sequence[KernelNode], grid=(8, 38)) -> Dict[str, List[Tuple[int, int]]]:
    """Default-compiler analogue: fill tiles in scan order."""
    coords = _tile_coords(grid)
    out, i = {}, 0
    for n in nodes:
        out[n.name] = coords[i:i + n.tiles]
        i += n.tiles
    return out


def place_random(nodes, grid=(8, 38), seed=0):
    coords = _tile_coords(grid)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(coords))
    out, i = {}, 0
    for n in nodes:
        out[n.name] = [coords[p] for p in perm[i:i + n.tiles]]
        i += n.tiles
    return out


def place_congestion_aware(nodes: Sequence[KernelNode], edges: Sequence[Edge],
                           grid=(8, 38)) -> Dict[str, List[Tuple[int, int]]]:
    """Greedy dataflow-locality placement (paper §IV-F): process nodes in
    order of total traffic; each node claims the free tiles closest to the
    centroid of its already-placed neighbours."""
    free = set(_tile_coords(grid))
    traffic: Dict[str, int] = {n.name: 0 for n in nodes}
    nbrs: Dict[str, List[Tuple[str, int]]] = {n.name: [] for n in nodes}
    for e in edges:
        traffic[e.src] += e.bytes
        traffic[e.dst] += e.bytes
        nbrs[e.src].append((e.dst, e.bytes))
        nbrs[e.dst].append((e.src, e.bytes))
    order = sorted(nodes, key=lambda n: -traffic[n.name])
    placed: Dict[str, List[Tuple[int, int]]] = {}
    for n in order:
        anchor = None
        wsum = 0.0
        cy = cx = 0.0
        for other, b in nbrs[n.name]:
            if other in placed:
                oy = np.mean([c[0] for c in placed[other]])
                ox = np.mean([c[1] for c in placed[other]])
                cy += oy * b
                cx += ox * b
                wsum += b
        if wsum > 0:
            anchor = (cy / wsum, cx / wsum)
        else:
            anchor = (grid[0] / 2, grid[1] / 2)
        chosen = sorted(free, key=lambda c: abs(c[0] - anchor[0]) + abs(c[1] - anchor[1]))[: n.tiles]
        for c in chosen:
            free.remove(c)
        placed[n.name] = chosen
    return placed


def congestion_cost(placement: Dict[str, List[Tuple[int, int]]],
                    edges: Sequence[Edge]) -> float:
    """Sum over edges of bytes x centroid manhattan distance (wirelength
    analogue; on TPU this is bytes x ICI hops)."""
    total = 0.0
    for e in edges:
        a = np.mean(np.asarray(placement[e.src]), axis=0)
        b = np.mean(np.asarray(placement[e.dst]), axis=0)
        total += e.bytes * float(np.abs(a - b).sum())
    return total


# ---------------------------------------------------------------------------
# B. Sharding-rule selection for the LM archs
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrafficReport:
    per_axis_bytes: Dict[str, float]       # collective bytes per mesh axis
    cost: float                            # bytes x (axis hops weight)
    detail: Dict[str, float]


def _axis_sizes(mesh_shape: Dict[str, int]):
    return mesh_shape


def estimate_traffic(cfg: ModelConfig, shape: ShapeConfig,
                     mesh_shape: Dict[str, int], rules: Dict) -> TrafficReport:
    """Analytic per-step collective traffic under a rule assignment.

    Counted terms (bf16 bytes, per training/serve step, whole mesh):
      fsdp all-gather + reduce-scatter of params over rules['fsdp'] axis
      TP all-reduce of block outputs over rules['tp'] axis (2/layer)
      MoE all-to-all over rules['expert'] axis
      gradient all-reduce over remaining batch axes (pod)
    """
    e2 = 2
    b, s = shape.global_batch, shape.seq_len
    d, L, f = cfg.d_model, cfg.num_layers, cfg.d_ff
    toks = b * (1 if shape.kind == "decode" else s)

    def axis_of(logical):
        ax = rules.get(logical, ())
        return ax[0] if ax else None

    def size(axis):
        return mesh_shape.get(axis, 1) if axis else 1

    detail: Dict[str, float] = {}
    per_axis = {a: 0.0 for a in mesh_shape}

    # params (rough; embeddings excluded — they shard over vocab)
    n_params = cfg.num_layers * (4 * d * cfg.num_heads * cfg.hd / max(cfg.num_heads, 1)
                                 + 3 * d * max(f, 1))
    if cfg.num_experts:
        n_params += L * cfg.num_experts * 3 * d * cfg.d_ff_expert
    fsdp_ax = axis_of("fsdp")
    if fsdp_ax and shape.kind == "train":
        # all-gather fwd + bwd, reduce-scatter grads: ~3x param bytes
        v = 3 * n_params * e2 * (size(fsdp_ax) - 1) / max(size(fsdp_ax), 1)
        detail["fsdp_param_ag_rs"] = v
        per_axis[fsdp_ax] += v

    tp_ax = axis_of("tp")
    if tp_ax and size(tp_ax) > 1:
        # 2 all-reduces per layer on (toks, d) activations (fwd; x2 for bwd)
        mult = 4 if shape.kind == "train" else 2
        v = mult * L * toks * d * e2 * 2 * (size(tp_ax) - 1) / size(tp_ax)
        detail["tp_allreduce"] = v
        per_axis[tp_ax] += v

    if cfg.num_experts:
        ep_ax = axis_of("expert")
        if ep_ax and cfg.num_experts % size(ep_ax) == 0 and size(ep_ax) > 1:
            mult = 2 if shape.kind != "train" else 6  # fwd 2 a2a, bwd 4
            nm = L - cfg.num_dense_layers
            v = mult * nm * toks * cfg.top_k * d * e2 * (size(ep_ax) - 1) / size(ep_ax)
            detail["moe_all_to_all"] = v
            per_axis[ep_ax] += v

    # cross-pod gradient all-reduce
    if shape.kind == "train" and size("pod") > 1:
        v = 2 * n_params * e2
        detail["pod_grad_allreduce"] = v
        per_axis["pod"] += v

    # hop weights: pod axis crosses DCN (x16 congestion weight), ICI = 1
    cost = sum(v * (16.0 if a == "pod" else 1.0) for a, v in per_axis.items())
    return TrafficReport(per_axis_bytes=per_axis, cost=cost, detail=detail)


def candidate_rules() -> Dict[str, Dict]:
    """The discrete placement space for rule selection."""
    base = dict(DEFAULT_RULES)
    swapped = dict(base)
    swapped.update({"fsdp": ("model",), "tp": ("data",), "tp_in": ("data",),
                    "expert": ("data",), "embed_vocab": ("data",),
                    "embed_d": ("model",), "act_tp": ("data",)})
    no_fsdp = dict(base)
    no_fsdp.update({"fsdp": (), "embed_d": ()})
    return {"default": base, "swapped": swapped, "replicated_params": no_fsdp}


def arch_rules(cfg: ModelConfig, shape: ShapeConfig,
               mesh_shape: Dict[str, int]) -> Dict:
    """Arch-aware rule placement (the pass dryrun.py applies by default).

    The key decision — the TPU analogue of the paper's dataflow-adjacent
    placement — is how attention maps onto the model axis:
      * heads divide the axis -> Megatron head sharding (default rules);
      * heads do NOT divide (qwen2.5-32b: 40, internvl2: 14) -> context
        parallelism: queries shard on the sequence dim, K/V stay whole,
        which replaces the score-tensor all-reduce with a K/V all-gather
        (orders of magnitude smaller; EXPERIMENTS.md §Perf P2).
    """
    rules = dict(DEFAULT_RULES)
    tp = mesh_shape.get("model", 1)
    seq_shardable = shape.seq_len % max(tp, 1) == 0 and shape.kind != "decode"
    heads_ok = (cfg.num_heads % tp == 0) or cfg.use_mla
    recurrent = bool(cfg.block_pattern) or cfg.family in ("ssm", "hybrid")
    if not heads_ok and seq_shardable and not recurrent:
        rules["act_q_seq"] = ("model",)
    return rules


def choose_rules(cfg: ModelConfig, shape: ShapeConfig,
                 mesh_shape: Dict[str, int]):
    """Greedy selection over candidate_rules; returns (name, rules, report,
    all_reports)."""
    reports = {}
    for name, rules in candidate_rules().items():
        reports[name] = estimate_traffic(cfg, shape, mesh_shape, rules)
    best = min(reports, key=lambda n: reports[n].cost)
    return best, candidate_rules()[best], reports[best], reports
