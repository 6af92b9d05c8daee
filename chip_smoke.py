#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, one JSON line each on stdout:
  1. build  — nvcc builds every kernel from csrc/ (one process per source,
     in parallel); the card's name and power limit; TF32 switched off so
     the plain versions run in full fp32.
  2. kernels — each kernel wrapper against its plain PyTorch version on the
     card, at the main path's shapes (CRONet medium, 4 slots): cronet_fused
     at fp32 and bf16 (also timed by graph replay at 1 and 4 slots; at most
     three device kernels a call by torch.profiler, counted in a process of
     its own, and the same bits over two calls, or the phase fails),
     solve_b_fused with a mix of need flags, an idle slot, a warm start
     and a shape-padded (elem_mask) batch, bitwise equal to its
     plain loop (U and iterations) in both; times of both, and the CG
     kernel's us per iteration of its longest slot. Then both at the
     gateway phase's 60x20 shapes (large's mesh, medium's weights, 4
     slots): over 20 engine ticks at threshold 0.1 on the serving
     generator's seed-1 requests, which include top point loads under
     which fp32 PCG turns NaN at 60x20, solve_b_fused bitwise equal to
     solve_b_plain on every tick's state (U and iterations, NaN where the
     plain loop has NaN), and cronet_fused within 1e-4 of its plain
     version on that run's last all-finite history and on a random one.
  3. fusion — (a) each per-op kernel (conv2d, conv3d, gemm, maxpool2d,
     adaptive_avg_pool2d/3d) against its plain version at CRONet medium's
     layer shapes and at odd shapes, fp32 and bf16 (the adaptive pools, the
     convolutions and gemm also bitwise equal over two calls, maxpool2d
     bitwise equal to its plain version), timed beside
     its plain version and the one PyTorch call for the same function (the
     convolutions and gemm in bf16 too, beside F.conv2d/F.conv3d and
     torch.matmul in bf16, each case printed); every bf16 convolution call
     at Cin 16 must launch the tensor-core kernel and every fp32 call the
     SIMT kernel (counted); torch.profiler must see one device kernel per
     gemm call at every case (one launch, whatever K); (b)
     core.fusion.infer on the none / l1 / l2l3 paths at small, medium and
     large (fp32) against core.cronet.forward at 1e-4, with the median
     latency of 30 synchronised calls, the launches per call and each
     path's device time by graph replay (reported: whether l2l3 takes less
     than l1); every per-op kernel must be launched by (b).
  4. breakdown — silu_lut and silu_exact bitwise equal to their plain
     versions (NaN where they have NaN), one launch a call, at fp32 and
     bf16 on 2^14 elements, on CRONet medium's largest SiLU input at 4
     slots (768,000), on 2^26 elements (a bandwidth reading), on 2^14 + 3
     and on a view one element into its buffer, with the tails, the
     infinities, NaN of both signs, every table point and every midpoint
     (and their neighbouring floats) among the inputs; the first three
     timed by graph replay on normal draws (scale 4: the special values
     put tens of full IEEE divisions into a few threads, in these kernels
     and in F.silu alike) beside an ``empty`` build of csrc/silu.cu at
     the same grid (the launch floor), the plain version and F.silu; then
     repro_torch.layer_breakdown.run at medium (paper Fig 7, bf16), which
     must launch both SiLU kernels and each convolution wrapper's
     tensor-core kernel.
  5. lm_kernels — (a) flash_attention (non-causal, the GQA fold) and
     flash_attention_causal_gqa at qwen2.5-32b's attention widths (B 1,
     S 4096, 40 q heads on 8 kv heads, D 128, bf16: each call must launch
     the tensor-core kernel) against the port's models.layers.attention
     (bf16 also element by element, a test that a dropped key tile and a
     wrong kv head are shown to fail), again at fp32 with S 1024 (the SIMT
     kernel), at the CPU tests' shapes and at a ragged bf16 S 200, timed
     beside F.scaled_dot_product_attention; the SIMT kernel at
     hubert-xlarge's (80), recurrentgemma-2b's (256) and deepseek-v3's MLA
     (D 192, Dv 128, its 128 heads) widths, fp32 at S 1024 (timed beside SDPA) and bf16
     at S 512; flash's build seconds and ptxas report; (b) slstm_fused at xlstm-1.3b's widths
     (B 8, S 4096, 4 heads of 512, fp32 wx) against ref.slstm_sequential,
     the error over the first and the last 64 steps; at the JAX package's
     init scale over 64 steps against the plain version in fp32 and
     float64; and at the CPU tests' shapes; its launch plan (blocks, the
     blocks a head that a step waits for, shared bytes).
  6. serving — TopoServingEngine(device="cuda") on medium, 4 slots, serving
     8 requests of 20 iterations (the MBB case plus off-distribution point
     loads) once with error_threshold=0.1 and once with 1e9; cronet_fused
     and solve_b_fused must be launched by that phase.
  7. gateway — CRONet medium's random weights v1 (seed 0) and v2 (seed 1)
     registered in a fresh ModelRegistry and loaded back onto the card
     (fp32 equal, the bf16 load equal to .to(bfloat16)); then
     serving's 8 requests on 30x20 through a bare engine and through a
     gateway of one bucket, both warm, MIX_RUNS times each in turns (the
     same pool_stats over each run); then
     TopoGateway.from_registry(reg, "v1", slots=4) at threshold 0.1
     serves serving's 8 requests on 30x20 and 4 of the MBB load case on
     60x20 (large's mesh; four volume fractions and loads: the serving
     generator's point loads turn NaN there, see the kernels phase),
     with canary("v2", fraction=0.5) on 30x20 started part-way and
     promoted after; every density finite, every
     completion tagged with
     its engine's version, the 30x20 completions of each version bitwise
     equal to a dedicated engine's run of them, and the 60x20 bucket
     evicted (memory_allocated must drop) and rebuilt to the same bits;
     problems/s and p50/p99 beside the serving phase's; cronet_fused and
     solve_b_fused must be launched by that phase.
  8. workers — the gateway phase's mix (8 requests on 30x20, 4 of the MBB
     load case on 60x20, a canary of v2 at 0.5 on 30x20) from a fresh
     registry through three fronts: TopoGateway(workers=3) (one bucket a
     process), workers=1 (the three tick loops in one worker, the front
     door outside it) and the threaded gateway; one warm run each, then
     3 / 1 / 3 timed runs in turns, each read by one pool_stats, and one
     more threaded run with the GIL switch interval at 0.5 ms, with
     each bucket's ms a tick (its span over its steps), os.cpu_count()
     and each worker's spawn-to-ready and spawn-to-first-build seconds
     (a failure prints every pool's worker-* events); every completion of
     every run (densities, CRONet / FEA / CG iterations) bitwise equal
     to a dedicated in-process engine's. Then unregistered card params
     through workers=1: the worker's tree equal to the parent's by
     digest and on its device, its densities bitwise equal; then kill -9
     of that worker with four requests in a tick and two queued: the four
     fail with WorkerLost naming it, the two complete on the respawned
     worker, bitwise. cronet_fused and solve_b_fused must launch in the
     worker processes (each worker's counts from its stats verb).
  9. flywheel — CRONet medium trained on the card in fp32: the default
     dataset (6 load cases, MBB first, 100 SIMP iterations, through
     solve_b_fused; every window and target finite), 400 steps of batch
     16 from init_params(seed 0) with the mean of the last 40 losses below
     the first 40's, registered by train_and_register and read back
     bitwise; the first 5 steps again on the host's CPU on the same numpy
     data (losses within FLY_LOSS_RTOL) and the step-0 gradient against
     a float64 CPU gradient (each leaf within FLY_GRAD_RTOL of its norm).
     Then TopoGateway.from_registry(reg, "base", slots=4,
     harvest=HarvestLog(accept_below=1.0)) at threshold 0.05 serves 16 of
     the serving generator's requests on 30x20 and a FlywheelController
     (trigger below 1.01, so a cycle starts whatever the acceptance)
     carries one cycle: harvest, a 200-step fine-tune with 4 replayed
     cases, a canary at 0.5 served in rounds of 8 (at most 8 rounds),
     promotion; the flywheel-trigger/harvest/train/canary/promote events
     in order, a child with parent "base" on 30x20, its canary
     completions bitwise equal to a dedicated engine's with its weights,
     the base weights unchanged; dataset seconds, seconds a step, peak
     memory (and what was allocated before training), fine-tune
     seconds, acceptance of base and child; both
     serving kernels launched in the phase.
 10. lm_serving — granite-3-8b served whole: bf16, 40 layers, every width
     as published, weights from materialize(seed 0) on the card (16.75
     GB); launch/serve.py's 8 requests (seed-0 prompts of 4-31 tokens,
     max_new 16) through ServingEngine(slots 4, max_len 128) twice, every
     output max_new tokens in [0, vocab) and the same in both runs, with
     tokens/s and the mean batch latency from throughput_stats; decode ms
     a step at that cache; 4 prompts of 2,048 tokens prefilled at max_len
     4096 (the chunked attention path) and decode ms a step there, each
     beside its bound (weight and cache bytes over 3.35 TB/s), and
     torch.profiler over 3 decode steps (device ms, idle share, launches).
     Then depth 2 at full width in fp32, its layers drawn at the full
     model's scale (std 1/sqrt(40)): prefill(S-1) + decode_step against
     forward, and the card's forward against the host CPU's on the same
     weights, each within 1e-4 of max |logit|, and the greedy tokens of 4
     steps on both, the differing ones counted; the same reported, not
     gated, at materialize's scale for 2 layers (std 1/sqrt(2)), where
     the larger scores leave fp32 short of the bar. memory_allocated
     before and after (all freed). The phase adds no kernel: the JAX LM
     stack calls none.
 11. lm_moe — the moe family: granite-moe-3b-a800m whole (bf16, 32 layers,
     40 experts top-8, 3.38B weights, 6.75 GB) and deepseek-v3-671b cut to
     4 layers (3 dense + 1 MoE; MLA, 1 shared and 256 routed experts,
     sigmoid top-8, every width as published: 15.8B weights, 31.6 GB),
     each serving launch/serve.py's 8 requests through ServingEngine(slots
     4, max_len 128) twice (the same tokens, all in range), with
     throughput_stats, decode ms a step beside two bounds (every weight
     and the cache over 3.35 TB/s; the weights one token's path reads) and
     a profile of decode steps. On deepseek's hidden states (its first
     group's prefill, recorded by wrapping moe.route), route on the card
     against the host CPU at d 7168 and 256 experts, with the served
     router and one at the full model's scale: the card's ids its own
     scores' top 8 with the lower index first among ties, and equal to
     the CPU's wherever the 8th and 9th scores differ. Then fp32, TF32
     off, at the full model's layer scale (gated at 1e-4 of max |logit|
     or |out|; the cut depth's scale reported): granite-moe at depth 4 at
     capacity factor 5 (num_experts / top_k: nothing dropped), each block
     on the card from the host CPU's input to it against the CPU's output
     (teacher-forced), the unembedding of the CPU's last hidden state, and
     prefill(S-1) + decode_step against forward over the sequences whose
     routing agrees (the parted tokens counted); reported, the forward
     card against CPU end to end beside the host CPU's own spread over
     summation orders (its forward at 1 thread against all: at this
     width the attention grows an fp32 rounding difference ~5x a layer,
     to 2e-4..5e-4 of max |logit| on the CPU alone), and the greedy
     tokens of 4 steps on both; deepseek's
     apply_mla on one layer's weights at full width (187M), the absorbed
     decode step against the materialized form and card against CPU.
     memory_allocated before and after (all freed). No kernel: the JAX
     MoE and MLA call none.
 12. lm_recurrent — the recurrent families: recurrentgemma-2b whole
     (hybrid: RG-LRU blocks and local attention; bf16, 26 layers, d 2560,
     10 q heads on 1 kv head of 256, window 2048: 3.55B weights, 7.10 GB)
     and xlstm-1.3b whole (ssm: 6 sLSTM and 42 mLSTM blocks; bf16, d
     2048, 4 heads: 2.01B weights, 4.02 GB), each serving launch/serve.py's
     8 requests through ServingEngine(slots 4, max_len 128) twice (the
     same tokens, all in range), with throughput_stats, decode ms a step
     beside its bound (every weight and the cache read, the recurrent
     states written, over 3.35 TB/s) and a profile of decode steps; then
     4 prompts of 2,048 tokens prefilled at max_len 4096 (seconds; the
     mLSTM's chunkwise form, a 2,048-step sLSTM scan) and 16 decode steps,
     every logit finite, the hybrid's 2,048-slot window wrapped: slot_pos
     holds exactly the last 2,048 positions, p in slot p % 2048. Then fp32,
     TF32 off, at full width, one superblock deep (recurrentgemma 3 layers,
     xlstm 8), drawn at the full model's layer scale (gated at 1e-4 of max
     |out| or |logit|; materialize's scale for the cut reported): each
     block on the card from the host CPU's input against the CPU's output
     and each recurrent block's prefill(S-1) + one decode step against
     its forward (teacher-forced), the unembedding, prefill(S-1) +
     decode_step against forward end to end where the host CPU's own
     1-thread-vs-all spread is under the bar (recurrentgemma; xlstm's
     chained sLSTM and mLSTM part by O(1) under a mere change of
     summation order, so there it is reported), the RG-LRU doubling
     scan against fp32 and float64 sequential loops at B 4, S 2048, W
     2560, the mLSTM's chunkwise form against its
     sequential scan at dh 1024, S 128, the sLSTM card against CPU over
     its first 16 steps (64 and 256 reported beside float64: at this scale
     its recurrence parts from float64 within 64 steps); reported, the
     forward card against CPU beside the host CPU's 1-thread-vs-all
     spread, and the greedy tokens of 4 steps on both. memory_allocated
     before and after (all freed), peak. No kernel: the reference's
     recurrent blocks call none (its sLSTM is a scan, not slstm_fused).
 13. lm_training — xlstm-1.3b whole (48 layers, d 2048, 2.01B weights,
     bf16 with fp32 masters and moments: 28.16 GB of state; remat "full";
     weights at std 1/sqrt(fan-in), a stand-in: under materialize's rule,
     the reference's, the sLSTM's gradient overflows fp32, ROADMAP §C)
     trained through launch/train.py's Trainer: batch 4 x 256 tokens in
     two microbatches, 4 steps, a checkpoint every 2, each step
     synchronised and timed; then a fresh Trainer resumes from the step-2
     checkpoint to step 4. Only the step-2 checkpoint is written (32.2 GB,
     under TMPDIR); the saves at step 4 are recorded. Gates: losses and
     grad_norm finite, grad_norm > 0, the params moved, the saves asked
     for, the resumed losses within 1e-4 of the straight run's (bitwise
     equality reported). Reported: s a step, tokens/s, peak memory, state
     bytes, checkpoint save and restore s. Then fp32, TF32 off:
     granite-3-8b at depth 2, full width, drawn at 40 layers' scale, one
     train step's loss, grad_norm, gradients and mu card against CPU
     (the CPU's float64 run as the spread), and one xlstm superblock's
     blocks' vjps teacher-forced at S 16 (sequential mLSTM) and 128
     (chunkwise) from 3 seeds each, card and CPU against float64, pooled
     over blocks and seeds of a kind: the card's median within 2x the
     CPU's, its worst within 4x the CPU's worst (the sLSTM at S 16 only:
     at 128 its backward is chaotic on either device).
     Frees what it allocates. No kernel: the LM training path calls none.
 14. contracts — one tick at width 4 equals the same slots' tick at width 2
     bitwise, and park -> restore -> step equals an uninterrupted step.
 15. mesh — a one-rank NCCL process group (FileStore under TMPDIR) and
     launch.mesh.make_debug_mesh((1, 1)) on the card. granite-moe-3b-a800m
     at every published width, 4 of its 32 layers: two fp32 steps of a
     Trainer on the mesh (params, AdamW state and batch as DTensors; the
     MoE's EP sequence body with its two all_to_alls through NCCL, counted)
     and two of a Trainer without a mesh from the same seed, each step
     timed: the losses within 2e-4 (the reference's bar for its sharded
     step), the largest param difference, whether all is bitwise equal.
     Then ServingEngine(mesh=) in bf16 twice (prefill through the EP
     sequence body, decode through the EP decode body's all_gather /
     psum) against the engine without a mesh: the same tokens. The port's
     paper Table VI rows: the three
     placers' congestion_cost on CRONet medium at (8, 38), choose_rules of
     each architecture at train_4k on 16x16. Destroys the group, frees
     what it allocates. No kernel: the mesh path calls none.
 16. dryrun — (a) launch.op_analysis held against the card: one fp32
     train step of granite-moe-3b-a800m at every published width, 4 of
     its 32 layers, batch 4 x 256, without a mesh, once on meta tensors
     under OpAnalysis and MemTracker (nothing allocated) and once real:
     the analyzer's predicted peak within 10% of
     torch.cuda.max_memory_allocated (MemTracker's reported beside it),
     the matmul flops equal to torch.profiler's with_flops count (mm,
     addmm, bmm, baddbmm), the bytes' bound (bytes / 3.35e12) no larger
     than the profiled device time; the op count beside the device
     kernels. (b) python -m repro_torch.launch.dryrun --arch
     granite-moe-3b-a800m --shape decode_32k in a process of its own
     (its fake 256-rank group; the card is not used), its JSON reported.
     No kernel: the dry-run's path calls none.
Then the card's nvidia-smi line, one `kernels` JSON line (the thirteen
kernels of the twelve wrappers; each kernel's launches from the phase that
drives its path: serving for cronet_fused and solve_b_fused (the gateway
phase's as gateway_launches, the worker processes' of the workers phase
as workers_launches, the flywheel phase's as flywheel_launches), fusion (b)
for the per-op kernels, breakdown's layer_breakdown.run for the SiLU
kernels, lm_kernels' counted calls for the two flash kernels and
slstm_fused; the conv2d and conv3d rows also carry kernel_for's split:
the SIMT kernel's launches on fusion (b), fp32, and the tensor-core
kernel's on the breakdown, bf16), and last
{"ok": true, "device": {...}}. Exits nonzero, without the ok line, when
there is no CUDA GPU, when the port is not beside this script, or when
any phase fails. Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
U_SCALE = 50.0
MIX_RUNS = 3                    # timed runs of the serving mix, each front
SHORT_SWITCH_S = 5e-4           # a GIL switch interval 10x below Python's
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12        # bf16 on the tensor cores, dense


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        f"nvidia-smi failed: {out.stderr.strip()}"


def sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def problems(fea2d, cfg, n, seed=0):
    """The MBB load case plus off-distribution point loads, built as
    examples/serve_topo.py builds its requests."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i == 0:
            out.append(fea2d.point_load_problem(cfg.nelx, cfg.nely))
        else:
            out.append(fea2d.point_load_problem(
                cfg.nelx, cfg.nely,
                load_node=(int(rng.integers(0, cfg.nelx - 1)), 0),
                load=(0.0, float(-0.5 - rng.random()))))
    return out


# ------------------------------------------------------------------ phases


def ptxas_report(log: str) -> list:
    """ptxas's register, shared memory and spill lines from an nvcc log."""
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def phase_build(ctx):
    import torch
    from repro_torch.kernels import _build, build_all
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    build_s = build_all()
    ptxas = {name: ptxas_report(log)
             for name, log in _build.build_logs.items()}
    ctx["smi"] = nvidia_smi()
    emit({"phase": "build", "build_s": build_s,
          "build_s_per_source": _build.build_seconds, "nvidia_smi": ctx["smi"],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"cudnn": torch.backends.cudnn.allow_tf32,
                         "matmul": torch.backends.cuda.matmul.allow_tf32},
          "ptxas": ptxas})


def phase_kernels(ctx):
    import functools
    import numpy as np
    import torch
    from repro_torch.common import init_params
    from repro_torch.core.cronet import count_macs
    from repro_torch.fea import fea2d, hybrid
    from repro_torch.kernels import cg_fused, cronet_pipeline
    from repro_torch.timing import cuda_ms, graph_ms
    dev, cfg = ctx["device"], ctx["cfg"]
    B = 4
    gen = torch.Generator().manual_seed(0)
    p32 = hybrid.cast_params(init_params(cfg, seed=0, device=dev), "fp32")
    bp = fea2d.stack_problems(problems(fea2d, cfg, B), device=dev)
    lv = fea2d.load_volume_b(bp)
    hist = torch.rand((B, cfg.hist_len, cfg.nely, cfg.nelx, 1),
                      generator=gen).to(dev)
    rows = {}

    # -- cronet_fused, fp32: against core.cronet.forward at fp32
    out = cronet_pipeline.cronet_fused(cfg, p32, lv, hist)
    ref = cronet_pipeline.cronet_fused_plain(cfg, p32, lv, hist)
    sync()
    err32 = float((out - ref).abs().max())
    ok32 = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
    k_ms = cuda_ms(lambda: cronet_pipeline.cronet_fused(cfg, p32, lv, hist),
                   reps=20)
    p_ms = cuda_ms(lambda: cronet_pipeline.cronet_fused_plain(
        cfg, p32, lv, hist), reps=5)
    # -- bf16 weights and inputs: against the plain version at bf16 (5% of
    # max |ref|: bf16 rounds every plain intermediate, the kernel keeps
    # fp32) and against fp32 arithmetic on the same bf16 values (1e-4)
    p16 = hybrid.cast_params(p32, "bf16")
    lv16, hist16 = lv.bfloat16(), hist.bfloat16()
    out16 = cronet_pipeline.cronet_fused(cfg, p16, lv16, hist16)
    ref16 = cronet_pipeline.cronet_fused_plain(cfg, p16, lv16, hist16)
    ref16_32 = cronet_pipeline.cronet_fused_plain(
        cfg, hybrid.cast_params(p16, "fp32"), lv16.float(), hist16.float())
    sync()
    err16 = float((out16 - ref16).abs().max())
    ok16 = err16 <= 0.05 * float(ref16.abs().max())
    err16_32 = float((out16 - ref16_32).abs().max())
    ok16_32 = bool(torch.allclose(out16, ref16_32, rtol=1e-4, atol=1e-4))
    k16_ms = cuda_ms(lambda: cronet_pipeline.cronet_fused(
        cfg, p16, lv16, hist16), reps=20)
    # device time by graph replay at one and four slots, fp32 and bf16;
    # the device kernels of a call (torch.profiler, at most 3); the same
    # bits over two calls
    graph = {}
    for width in (1, 4):
        for dname, pp, a, h in (("float32", p32, lv, hist),
                                ("bfloat16", p16, lv16, hist16)):
            graph[f"B{width}/{dname}"] = graph_ms(functools.partial(
                cronet_pipeline.cronet_fused, cfg, pp, a[:width],
                h[:width]), reps=20, replays=10)
    per_call = cronet_kernels_per_call()
    n_kernels = max(sum(v.values()) for v in per_call.values())
    same_bits = bool(
        torch.equal(out, cronet_pipeline.cronet_fused(cfg, p32, lv, hist))
        and torch.equal(out16, cronet_pipeline.cronet_fused(
            cfg, p16, lv16, hist16)))
    ok_calls = 1 <= n_kernels <= 3 and same_bits
    flops = 2.0 * count_macs(cfg)["total"] * B
    nbytes = 4 * (lv.numel() + hist.numel() + B * cfg.p
                  + sum(v.numel() for part in p32.values()
                        for v in part.values()))
    rows["cronet_fused"] = dict(
        name="cronet_fused", route="cuda",
        source="src/repro_torch/csrc/cronet_fused.cu",
        replaces="src/repro/kernels/cronet_pipeline.py:142",
        max_abs_err=err32, ms=graph["B4/float32"], eager_ms=k_ms,
        plain_ms=p_ms, **bound(nbytes, flops, H100_FP32_FLOPS),
        library_ms=None)
    emit({"phase": "kernel", "name": "cronet_fused", "B": B,
          "fp32": {"max_abs_err": err32, "tol": "rtol=atol=1e-4",
                   "ok": ok32, "kernel_ms": k_ms, "plain_ms": p_ms,
                   "max_abs_ref": float(ref.abs().max())},
          "bf16": {"max_abs_err_vs_plain_bf16": err16,
                   "tol_vs_plain_bf16": "0.05 * max|ref|", "ok": ok16,
                   "max_abs_err_vs_fp32_on_bf16_values": err16_32,
                   "tol_vs_fp32": "rtol=atol=1e-4", "ok_fp32": ok16_32,
                   "kernel_ms": k16_ms},
          "graph_ms": graph, "device_kernels_per_call": per_call,
          "device_kernels_limit": 3, "same_bits_two_calls": same_bits,
          "plan": {f"B{w}": cronet_pipeline.cronet_plan(cfg, w)._asdict()
                   for w in (1, 4)},
          "library_ms": None})

    # -- solve_b_fused: need mix, an idle slot, a warm start; then elem_mask
    probs = problems(fea2d, cfg, 3, seed=1)
    idle = fea2d.idle_problem(cfg.nelx, cfg.nely)
    bp = fea2d.stack_problems([probs[0], probs[1], idle, probs[2]],
                              device=dev)
    X = (0.2 + 0.8 * torch.rand((4, cfg.nely, cfg.nelx),
                                generator=gen)).to(dev)
    U0, _ = cg_fused.solve_b_plain(bp, X, max_iter=5)
    need = torch.tensor([True, False, True, True], device=dev)
    small = [fea2d.point_load_problem(cfg.nelx - 2, cfg.nely - 2,
                                      load_node=(i * (cfg.nelx // 6), 0),
                                      load=(0.0, -1.0 - 0.2 * i))
             for i in range(4)]
    bpm = fea2d.stack_problems([fea2d.pad_problem(p, cfg.nelx, cfg.nely)
                                for p in small], device=dev)
    Xm = bpm.elem_mask * (0.3 + 0.6 * torch.rand(
        (4, cfg.nely, cfg.nelx), generator=gen).to(dev))
    cases = {"need_idle_warm": (bp, X, U0, need),
             "elem_mask": (bpm, Xm, None, None)}
    cg_report, err_cg, its_total, cg_ok = {}, 0.0, 0, True
    for label, (b, x, u0, nd) in cases.items():
        U, its = cg_fused.solve_b_fused(b, x, U0=u0, need=nd)
        Ur, itr = cg_fused.solve_b_plain(b, x, U0=u0, need=nd)
        sync()
        rel = ((U - Ur).norm(dim=1)
               / Ur.norm(dim=1).clamp_min(1e-30)).cpu().numpy()
        dits = (its - itr).abs().cpu().numpy()
        bitwise = bool(torch.equal(U, Ur) and torch.equal(its, itr))
        ok = bool(np.all(rel <= 1e-4) and np.all(dits <= 1)) and bitwise
        if nd is not None:   # the need=False slot keeps its warm start
            ok = ok and bool(torch.equal(U[1], (u0 * b.free_mask)[1]))
            ok = ok and int(its[1]) == 0 and int(its[2]) == 0
        cg_ok = cg_ok and ok
        err_cg = max(err_cg, float((U - Ur).abs().max()))
        its_total += int(its.sum())
        cg_report[label] = {"rel_l2": rel.tolist(),
                            "its": its.cpu().tolist(),
                            "its_plain": itr.cpu().tolist(),
                            "bitwise": bitwise, "ok": ok}
    b, x, u0, nd = cases["need_idle_warm"]
    k_ms = cuda_ms(lambda: cg_fused.solve_b_fused(b, x, U0=u0, need=nd),
                   reps=10)
    p_ms = cuda_ms(lambda: cg_fused.solve_b_plain(b, x, U0=u0, need=nd),
                   reps=2)
    its_warm = cg_report["need_idle_warm"]["its"]
    us_per_iter = 1e3 * k_ms / max(its_warm)    # the longest slot's chain
    ne, ndof = cfg.nelx * cfg.nely, 2 * (cfg.nelx + 1) * (cfg.nely + 1)
    # per slot iteration: KE apply (8 rows x 15) + e scale (8) per element;
    # assembly (3), free mask (1), two dots, two axpys, precondition (2),
    # P update and norm (2 each) per dof
    flops = float(sum(its_warm)) * (ne * 128 + ndof * 18)
    nbytes = 4 * (B * ne + 7 * B * ndof)
    rows["solve_b_fused"] = dict(
        name="solve_b_fused", route="cuda",
        source="src/repro_torch/csrc/cg_fused.cu",
        replaces="src/repro/kernels/cg_fused.py:194",
        max_abs_err=err_cg, ms=k_ms, kernel_ms=k_ms, plain_ms=p_ms,
        **bound(nbytes, flops, H100_FP32_FLOPS), library_ms=None)
    rows["solve_b_fused"]["us_per_iteration"] = us_per_iter
    emit({"phase": "kernel", "name": "solve_b_fused", "cases": cg_report,
          "tol": "bitwise (U and iterations); U rel L2 <= 1e-4, "
                 "iterations +-1", "ok": cg_ok,
          "kernel_ms": k_ms, "plain_ms": p_ms, "iterations_timed": its_warm,
          "us_per_iteration": us_per_iter, "library_ms": None})
    ok60 = kernels_at_60x20(ctx, rows)
    ctx["rows"] = rows
    if not (ok32 and ok16 and ok16_32 and cg_ok and ok60):
        raise AssertionError("a kernel disagrees with its plain version")
    if not ok_calls:
        raise AssertionError(f"cronet_fused: {per_call} device kernels a "
                             f"call (at most 3), same bits {same_bits}")


def kernels_at_60x20(ctx, rows) -> bool:
    """Both serving kernels at the shapes the gateway phase gives them on
    large's 60x20 mesh: medium's weights, 4 slots, the engine's tick at
    threshold 0.1. The slots hold the serving generator's seed-1 requests
    (the MBB case and three top point loads), under which fp32 PCG turns
    NaN at this mesh (tests/test_torch_hybrid.py shows it in both
    packages on the CPU). Before each of 20 ticks, ``solve_b_fused`` and
    ``solve_b_plain`` solve that tick's state: U and iterations bitwise,
    NaN where the plain version has NaN. ``cronet_fused`` is held to its
    plain version (rtol=atol=1e-4) on the last history in which every
    slot is finite and on a random one. Adds the largest errors to the
    kernels' rows."""
    import dataclasses
    import torch
    from repro_torch.common import init_params
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.fea import fea2d, hybrid
    from repro_torch.kernels import cg_fused, cronet_pipeline
    dev, big = ctx["device"], get_cronet_config("large")
    cfg = dataclasses.replace(ctx["cfg"], nelx=big.nelx, nely=big.nely)
    params = hybrid.cast_params(init_params(ctx["cfg"], seed=0, device=dev),
                                "fp32")
    bp = fea2d.stack_problems(problems(fea2d, cfg, 4, seed=1), device=dev)
    lv = fea2d.load_volume_b(bp)
    step = hybrid.make_hybrid_step(cfg, U_SCALE, 0.1, 3, 1.5, "fp32")
    state = hybrid.init_state(cfg, bp)
    ticks, cg_ok, first_nan, hist_finite = [], True, [None] * 4, None
    err_cg = 0.0
    for k in range(1, 21):
        U, its = cg_fused.solve_b_fused(bp, state.x, U0=state.u)
        Ur, itr = cg_fused.solve_b_plain(bp, state.x, U0=state.u)
        sync()
        bitwise = same_bits(U, Ur) and bool(torch.equal(its, itr))
        cg_ok = cg_ok and bitwise
        both = U.isfinite() & Ur.isfinite()
        err_cg = max(err_cg, float(torch.where(both, (U - Ur).abs(), 0.0)
                                   .max()))
        ticks.append({"tick": k, "bitwise": bitwise,
                      "its": its.cpu().tolist(),
                      "finite_u": U.isfinite().all(dim=1).cpu().tolist()})
        if bool(state.hist.isfinite().all()):
            hist_finite = state.hist.clone()
        state = step(params, bp, lv, state)
        for b, fin in enumerate(state.x.isfinite().flatten(1).all(dim=1)
                                .cpu().tolist()):
            if not fin and first_nan[b] is None:
                first_nan[b] = k
    gen = torch.Generator().manual_seed(60)
    hists = {"trajectory": hist_finite[..., None],
             "random": torch.rand(hist_finite[..., None].shape,
                                  generator=gen).to(dev)}
    cronet = {}
    for label, hist in hists.items():
        out = cronet_pipeline.cronet_fused(cfg, params, lv, hist)
        ref = cronet_pipeline.cronet_fused_plain(cfg, params, lv, hist)
        sync()
        cronet[label] = {
            "max_abs_err": float((out - ref).abs().max()),
            "max_abs_ref": float(ref.abs().max()),
            "ok": bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))}
    cr_ok = all(c["ok"] for c in cronet.values())
    err_cr = max(c["max_abs_err"] for c in cronet.values())
    rows["cronet_fused"]["max_abs_err"] = max(
        rows["cronet_fused"]["max_abs_err"], err_cr)
    rows["cronet_fused"]["max_abs_err_60x20"] = err_cr
    rows["solve_b_fused"]["max_abs_err"] = max(
        rows["solve_b_fused"]["max_abs_err"], err_cg)
    rows["solve_b_fused"]["max_abs_err_60x20"] = err_cg
    emit({"phase": "kernel", "mesh": "60x20", "B": 4, "error_threshold": 0.1,
          "loads": "problems(fea2d, cfg, 4, seed=1)",
          "solve_b_fused": {"tol": "bitwise (U and iterations), NaN where "
                                   "the plain version has NaN",
                            "ok": cg_ok, "max_abs_err": err_cg,
                            "first_nan_tick": first_nan,
                            "ticks": ticks},
          "cronet_fused": {"tol": "rtol=atol=1e-4", "ok": cr_ok,
                           "cases": cronet}})
    return cg_ok and cr_ok


def _valid_taps(n: int, k: int, causal: bool) -> int:
    """Taps of a k-wide filter that land inside n inputs, summed over the n
    outputs: SAME (centred) or causal (d .. d+k-1) padding."""
    lo = 0 if causal else k // 2
    return sum(1 for o in range(n) for t in range(k) if 0 <= o + t - lo < n)


def fusion_cases(cfg):
    """The per-op calls of one CRONet forward on the l1 path, per kernel:
    (label, times per forward, shape arguments)."""
    H, W = cfg.nodes
    T, ny, nx = cfg.hist_len, cfg.nely, cfg.nelx
    return {
        "conv3d": [("trunk1", 1, dict(x=(1, cfg.t_depth, H, W, 1),
                                      w=(2, 3, 3, 1, cfg.t_c1),
                                      depth_padding="causal_same")),
                   ("trunk2", 1, dict(x=(1, cfg.t_depth, H, W, cfg.t_c1),
                                      w=(1, 3, 3, cfg.t_c1, cfg.t_c2),
                                      depth_padding="same"))],
        "conv2d": [("branch1", 1, dict(x=(T, ny, nx, 1),
                                       w=(3, 3, 1, cfg.b_c1))),
                   ("branch2", 1, dict(x=(T, ny, nx, cfg.b_c1),
                                       w=(3, 3, cfg.b_c1, cfg.b_c2))),
                   ("odd_7x9", 0, dict(x=(2, 7, 9, 3), w=(3, 3, 3, 5)))],
        "gemm": [("trunk_fc1", 1, dict(m=1, k=cfg.trunk_features, n=cfg.mid,
                                       act="silu")),
                 ("fc2", 2, dict(m=1, k=cfg.mid, n=cfg.p, act=None)),
                 ("rnn_wx", T, dict(m=1, k=cfg.branch_features,
                                    n=cfg.rnn_hidden, act=None)),
                 ("rnn_wh", T, dict(m=1, k=cfg.rnn_hidden, n=cfg.rnn_hidden,
                                    act=None)),
                 ("branch_fc1", 1, dict(m=1, k=cfg.rnn_hidden, n=cfg.mid,
                                        act="silu")),
                 ("odd_33x70x9", 0, dict(m=33, k=70, n=9, act="tanh"))],
        "maxpool2d": [("branch", 1, dict(x=(T, ny, nx, cfg.b_c2))),
                      ("odd_7x9", 0, dict(x=(3, 7, 9, 8)))],
        "adaptive_avg_pool2d": [("branch", 1, dict(
            x=(T, ny // 2, nx // 2, cfg.b_c2), out=cfg.b_pool)),
            ("odd_7x9", 0, dict(x=(2, 7, 9, 6), out=(3, 4)))],
        "adaptive_avg_pool3d": [("trunk", 1, dict(
            x=(1, cfg.t_depth, H, W, cfg.t_c2), out=cfg.t_pool))],
    }


def fusion_call(name, args, dt, dev, gen):
    """(kernel call, plain call, library call, bytes, flops) for one case,
    on inputs made from ``gen``; the library call is the one PyTorch call
    that computes the same function (without a fused activation)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import conv, gemm, pool

    def rand(shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dt).to(dev)

    es = torch.empty((), dtype=dt).element_size()
    if name in ("conv2d", "conv3d"):
        x, w = rand(args["x"], 0.5), rand(args["w"], 0.3)
        cin, cout = w.shape[-2:]
        if name == "conv2d":
            B, H, W_ = x.shape[:3]
            D, kd, causal = 1, 1, False
            xc = x.permute(0, 3, 1, 2)                  # channels_last view
            wc = w.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib = lambda: F.conv2d(xc, wc, padding=1)  # noqa: E731
            kern = lambda fs: conv.conv2d(x, w, fuse_silu=fs)  # noqa: E731
            plain = lambda fs: conv.conv2d_plain(x, w, fuse_silu=fs)  # noqa
        else:
            B, D, H, W_ = x.shape[:4]
            kd = w.shape[0]
            dp = args["depth_padding"]
            causal = dp == "causal_same"
            xc = x.permute(0, 4, 1, 2, 3)
            wc = w.permute(4, 3, 0, 1, 2).contiguous(
                memory_format=torch.channels_last_3d)
            # symmetric depth padding kd-1: its last D slices are the
            # causal output (one extra slice of work for kd = 2)
            lib = lambda: F.conv3d(xc, wc, padding=(kd - 1, 1, 1))  # noqa
            kern = lambda fs: conv.conv3d(x, w, depth_padding=dp,  # noqa
                                          fuse_silu=fs)
            plain = lambda fs: conv.conv3d_plain(  # noqa: E731
                x, w, depth_padding=dp, fuse_silu=fs)
        macs = (B * _valid_taps(D, kd, causal) * _valid_taps(H, 3, False)
                * _valid_taps(W_, 3, False) * cin * cout)
        nbytes = es * (x.numel() + w.numel() + B * D * H * W_ * cout)
        return kern, plain, lib, nbytes, 2.0 * macs
    if name == "gemm":
        m, k, n = args["m"], args["k"], args["n"]
        x, w = rand((m, k), 0.3), rand((k, n), 0.3)
        act = args["act"]
        return (lambda fs: gemm.gemm(x, w, activation=act),
                lambda fs: gemm.gemm_plain(x, w, act),
                lambda: torch.matmul(x, w),
                es * (m * k + k * n + m * n), 2.0 * m * k * n)
    x = rand(args["x"])
    if name == "maxpool2d":
        B, H, W_, C = x.shape
        xc = x.permute(0, 3, 1, 2)
        return (lambda fs: pool.maxpool2d(x, 2),
                lambda fs: pool.maxpool2d_plain(x, 2),
                lambda: F.max_pool2d(xc, 2),
                es * (x.numel() + B * (H // 2) * (W_ // 2) * C),
                3.0 * B * (H // 2) * (W_ // 2) * C)
    out = args["out"]
    dims = x.shape[1:-1]
    adds = x.shape[0] * x.shape[-1]
    for n_in, n_out in zip(dims, out):
        s, e = pool.adaptive_bounds(n_in, n_out)
        adds *= sum(b - a for a, b in zip(s, e))
    nbytes = es * (x.numel() + x.shape[0] * x.shape[-1] * math.prod(out))
    if name == "adaptive_avg_pool2d":
        xc = x.permute(0, 3, 1, 2)
        return (lambda fs: pool.adaptive_avg_pool2d(x, out),
                lambda fs: pool.adaptive_avg_pool2d_plain(x, out),
                lambda: F.adaptive_avg_pool2d(xc, out), nbytes, float(adds))
    xc = x.permute(0, 4, 1, 2, 3)
    return (lambda fs: pool.adaptive_avg_pool3d(x, out),
            lambda fs: pool.adaptive_avg_pool3d_plain(x, out),
            lambda: F.adaptive_avg_pool3d(xc, out), nbytes, float(adds))


FUSION_TOL = {"float32": (2e-5, 2e-4), "bfloat16": (2e-2, 2e-1)}
CONV_NAMES = ("conv2d", "conv3d")
BF16_TIMED = CONV_NAMES + ("gemm",)     # per-op kernels timed in bf16 too


def cronet_kernels_per_call() -> dict:
    """The device kernels torch.profiler sees per cronet_fused call (medium,
    B 1 and 4, fp32 and bf16), counted by kernel_probe --cronet-kernels in
    a process of its own: a profile here would cost the fusion phase's gemm
    profile kernel records (see kernel_probe.cronet_kernels_per_call)."""
    import os
    env = dict(os.environ, PYTHONPATH=str(SRC))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernel_probe", "--cronet-kernels"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if run.returncode:
        raise RuntimeError(f"kernel_probe --cronet-kernels failed:\n"
                           f"{run.stderr[-3000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])[
        "cronet_kernels_per_call"]


def kernels_per_call(calls) -> dict:
    """Device kernels torch.profiler sees per call of each of ``calls``
    (each called once, in one profiled window), by name; every
    instantiation of gemm_kernel counts as "gemm_kernel"."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        for fn in calls:
            fn()
        sync()
    seen = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            key = "gemm_kernel" if "gemm_kernel" in e.name else e.name
            seen[key] = seen.get(key, 0) + 1
    return {k: n / len(calls) for k, n in seen.items()}


def _conv_counts(name):
    """(tensor-core, SIMT) launches of a convolution wrapper so far."""
    from repro_torch.kernels import conv
    if name not in CONV_NAMES:
        return None
    fn = getattr(conv, name)
    return fn.tc_launches, fn.simt_launches


def _check_conv_kernel(name, args, dname, before, calls):
    """The kernel the case's ``calls`` calls launched, by the counters:
    every bf16 call at Cin 16 must have gone to the tensor cores, every
    fp32 call to the SIMT kernel, any other to what kernel_for names."""
    import torch
    from repro_torch.kernels import conv
    cin, cout = args["w"][-2:]
    dt = getattr(torch, dname)
    want = ("simt" if dname == "float32" else
            "tc" if cin == 16 else conv.kernel_for(dt, cin, cout))
    if conv.kernel_for(dt, cin, cout) != want:
        raise AssertionError(f"{name}: kernel_for({dname}, {cin}, {cout}) "
                             f"is not {want}")
    tc, simt = _conv_counts(name)
    moved = (tc - before[0], simt - before[1])
    if moved != ((calls, 0) if want == "tc" else (0, calls)):
        raise AssertionError(f"{name} {args} {dname}: {calls} calls moved "
                             f"(tc, simt) by {moved}, want all on {want}")
    return want
FUSION_SOURCES = {
    "conv2d": ("conv.cu", "src/repro/kernels/conv.py:44"),
    "conv3d": ("conv.cu", "src/repro/kernels/conv.py:82"),
    "gemm": ("gemm.cu", "src/repro/kernels/gemm.py:48"),
    "maxpool2d": ("pool.cu", "src/repro/kernels/pool.py:34"),
    "adaptive_avg_pool2d": ("pool.cu", "src/repro/kernels/pool.py:58"),
    "adaptive_avg_pool3d": ("pool.cu", "src/repro/kernels/pool.py:89"),
}


def phase_fusion(ctx):
    """(a) each per-op kernel against its plain version at CRONet medium's
    layer shapes and odd shapes, fp32 and bf16, timed beside its plain
    version and the one PyTorch call for the same function; (b)
    fusion.infer on none / l1 / l2l3 at small, medium and large (fp32)
    against core.cronet.forward, with latency and launches per call."""
    import dataclasses
    import functools
    import statistics
    import torch
    from repro_torch import kernels
    from repro_torch.common import init_params
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.core import cronet, fusion
    from repro_torch.fea import fea2d
    from repro_torch.timing import cuda_ms, graph_ms
    dev = ctx["device"]
    gen = torch.Generator().manual_seed(1)
    ok_all, per_kernel, gemm_calls = True, {}, []
    for name, cases in fusion_cases(ctx["cfg"]).items():
        rep = {"cases": {}, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
               "call_ms": 0.0, "bytes": 0.0, "flops": 0.0,
               "max_abs_err": 0.0}
        if name in BF16_TIMED:      # bf16 sums over the same calls
            rep["bfloat16"] = {"ms": 0.0, "library_ms": 0.0,
                               "bound_ms": 0.0}
        for label, per_fwd, args in cases:
            for dname, dt in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
                kern, plain, lib, nbytes, flops = fusion_call(
                    name, args, dt, dev, gen)
                rtol, atol = FUSION_TOL[dname]
                errs, ok = [], True
                before = _conv_counts(name)
                for fs in (False, True):     # convolutions: SiLU off / on
                    out, ref = kern(fs), plain(fs)
                    sync()
                    ok = ok and out.dtype == dt and bool(torch.allclose(
                        out.float(), ref.float(), rtol=rtol, atol=atol))
                    if name.startswith(("adaptive", "conv", "gemm")):
                        ok = ok and bool(torch.equal(out, kern(fs)))  # order
                    if name == "maxpool2d":     # an input's bits, exactly
                        ok = ok and bool(torch.equal(out, ref))
                    errs.append(float((out.float() - ref.float())
                                      .abs().max()))
                ok_all = ok_all and ok
                case = {"max_abs_err": max(errs), "ok": ok,
                        "tol": f"rtol={rtol} atol={atol}"}
                if name in CONV_NAMES:
                    case["kernel"] = _check_conv_kernel(
                        name, args, dname, before, calls=4)
                if name == "gemm":
                    gemm_calls.append(functools.partial(kern, False))
                if dname == "float32":      # timed as the l1 path calls it
                    case.update(
                        ms=graph_ms(lambda: kern(True)),
                        plain_ms=graph_ms(lambda: plain(True)),
                        library_ms=graph_ms(lib),
                        call_ms=cuda_ms(lambda: kern(True), reps=50),
                        **bound(nbytes, flops, H100_FP32_FLOPS))
                    rep["max_abs_err"] = max(rep["max_abs_err"], max(errs))
                    if per_fwd:
                        for key in ("ms", "plain_ms", "library_ms",
                                    "call_ms"):
                            rep[key] += per_fwd * case[key]
                        rep["bytes"] += per_fwd * nbytes
                        rep["flops"] += per_fwd * flops
                elif name in BF16_TIMED:    # bf16, as Fig 7 calls it
                    case.update(
                        ms=graph_ms(lambda: kern(True)),
                        library_ms=graph_ms(lib),
                        **bound(nbytes, flops, H100_BF16_FLOPS
                                if case.get("kernel") == "tc"
                                else H100_FP32_FLOPS))
                    if per_fwd:
                        for key in ("ms", "library_ms", "bound_ms"):
                            rep["bfloat16"][key] += per_fwd * case[key]
                rep["cases"][f"{label}/{dname}"] = case
        if name == "gemm":          # one device kernel per call, any K
            rep["device_kernels_per_call"] = kernels_per_call(gemm_calls)
            ok_all = ok_all and rep["device_kernels_per_call"] == {
                "gemm_kernel": 1.0}
        per_kernel[name] = rep
        emit({"phase": "fusion_kernel", "name": name, **rep})

    # (b) the three paths, driven through fusion.infer
    paths = {"none": fusion.FusionConfig(False, False, False),
             "l1": fusion.FusionConfig(True, False, False),
             "l2l3": fusion.FusionConfig(True, True, True)}
    kernels.reset_launch_counts()
    latency, graphed = {}, {}
    for size in ("small", "medium", "large"):
        cfg = dataclasses.replace(get_cronet_config(size), dtype="float32")
        params = init_params(cfg, seed=0, device=dev)
        bp = fea2d.stack_problems([fea2d.mbb_problem(cfg.nelx, cfg.nely)],
                                  device=dev)
        lv = fea2d.load_volume_b(bp)[0]
        hist = torch.rand((cfg.hist_len, cfg.nely, cfg.nelx, 1),
                          generator=gen).to(dev)
        ref = cronet.forward(cfg, params, lv[None], hist[None])[0]
        for pname, fc in paths.items():
            out = fusion.infer(cfg, params, lv, hist, fc)
            sync()
            err = float((out - ref).abs().max())
            ok = bool(torch.allclose(out, ref, rtol=1e-4, atol=1e-4))
            ok = ok and out.shape == ref.shape and bool(
                torch.isfinite(out).all())
            ok_all = ok_all and ok
            for _ in range(5):                   # warm-up
                fusion.infer(cfg, params, lv, hist, fc)
            before = sum(kernels.launch_counts().values())
            walls = []
            for _ in range(30):
                t0 = time.perf_counter()
                fusion.infer(cfg, params, lv, hist, fc)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            per_call = (sum(kernels.launch_counts().values()) - before) / 30
            graphed[f"{pname}/{size}"] = functools.partial(
                fusion.infer, cfg, params, lv, hist, fc)
            latency[f"{pname}/{size}"] = {
                "median_ms": statistics.median(walls), "min_ms": min(walls),
                "launches_per_call": per_call, "max_abs_err": err,
                "tol": "rtol=atol=1e-4", "ok": ok}
    counts = kernels.launch_counts()
    conv_simt = {n: _conv_counts(n) for n in CONV_NAMES}
    # device time of a forward without the host: the path in a CUDA graph
    # (after the counts are read: capture is not a run of the path)
    for key, fn in graphed.items():
        latency[key]["graph_device_ms"] = graph_ms(fn, reps=5)
    below = {size: latency[f"l2l3/{size}"]["graph_device_ms"]
             < latency[f"l1/{size}"]["graph_device_ms"]
             for size in ("small", "medium", "large")}
    emit({"phase": "fusion", "latency_ms": latency, "launches": counts,
          "l2l3_below_l1_device_ms": below})

    for name, rep in per_kernel.items():
        src, replaces = FUSION_SOURCES[name]
        ctx["rows"][name] = dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=replaces, max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            call_ms=rep["call_ms"], plain_ms=rep["plain_ms"],
            **bound(rep["bytes"], rep["flops"], H100_FP32_FLOPS),
            library_ms=rep["library_ms"], launches=counts[name])
        if name in BF16_TIMED:
            ctx["rows"][name]["bf16_sums"] = rep["bfloat16"]
        if name in CONV_NAMES:
            # kernel_for's split: the SIMT kernel's launches on the fusion
            # paths (fp32); the tensor-core kernel's, Fig 7's (bf16), are
            # filled in by the breakdown phase
            tc, simt = conv_simt[name]
            ctx["rows"][name]["split"] = {
                "simt": {"launches": simt, "path": "fusion (b), fp32"},
                "tc": {"launches": None, "path": "breakdown, Fig 7, bf16"}}
            if tc:
                raise AssertionError(f"{name}: an fp32 fusion path launched "
                                     "the tensor-core kernel")
    if not ok_all:
        raise AssertionError("a per-op kernel or a fusion path disagrees "
                             "with its plain version")
    missing = [n for n in FUSION_SOURCES if counts[n] == 0]
    if missing:
        raise AssertionError(f"fusion paths never launched {missing}")


def bound(nbytes: float, flops: float, peak: float) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def silu_inputs(n: int, gen):
    """n fp32 values: normal draws (scale 4) after the cases where a table
    lookup can go wrong: every table point and every midpoint between two
    of them (the arithmetic midpoint and the fp32 value nearest the exact
    tie of the index formula), each with its two neighbouring floats, the
    tails on both sides of -8 and 8, the bounds of the exact kernel's fast
    quotient (x near -22.18, |x| at 2^-64 and 2^64, subnormals), the
    infinities and NaN of both signs."""
    import torch
    from repro_torch.kernels import ref, silu
    grid = ref.linspace(silu.LO, silu.HI, silu.N_ENTRIES)
    mids = grid[:-1] + (grid[1:] - grid[:-1]) / 2
    ties = ((torch.arange(silu.N_ENTRIES - 1, dtype=torch.float64) + 0.5)
            * (silu.HI - silu.LO) / (silu.N_ENTRIES - 1) + silu.LO).float()
    pts = torch.cat([grid, mids, ties])
    inf = torch.full_like(pts, math.inf)
    tails = torch.tensor([-1e4, -22.5, -22.180710, -22.0, -20.0, -8.0, 8.0,
                          20.0, 1e4, 0.0, -0.0, 2.0 ** -64, -2.0 ** -64,
                          2.0 ** 64, -2.0 ** 64, 1e-40, -1e-40, math.inf,
                          -math.inf, math.nan, -math.nan])
    tails = torch.cat([tails, torch.nextafter(tails, tails * 2)])
    special = torch.cat([pts, torch.nextafter(pts, inf),
                         torch.nextafter(pts, -inf), tails])
    x = torch.randn((n,), generator=gen) * 4
    x[:special.numel()] = special
    return x


# label: (elements, element offset of the view into its buffer)
SILU_CASES = {"layer_breakdown": (1 << 14, 0),
              "cronet_medium_conv2_4slots": (4 * 10 * 20 * 30 * 32, 0),
              "bandwidth": (1 << 26, 0),
              "odd": ((1 << 14) + 3, 0),
              "unaligned_view": ((1 << 14) + 3, 1)}
SILU_TIMED = ("layer_breakdown", "cronet_medium_conv2_4slots", "bandwidth")
SILU_SOURCES = {"silu_lut": "src/repro/kernels/silu.py:39",
                "silu_exact": "src/repro/kernels/silu.py:58"}


def same_bits(a, b) -> bool:
    """a and b have one dtype and shape, NaN at the same places and the
    same bits everywhere else (a NaN's payload is the arithmetic's)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    na, nb = a.isnan(), b.isnan()
    bits = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return bool(torch.equal(na, nb) and torch.equal(
        a.masked_fill(na, 0).view(bits), b.masked_fill(nb, 0).view(bits)))


def silu_case(x, offset: int, dtype, dev):
    """x (fp32, on the CPU) on the card in ``dtype``, as a view ``offset``
    elements into its buffer, so that its first element may sit off a
    16-byte boundary."""
    import torch
    buf = torch.empty(x.numel() + offset, dtype=dtype, device=dev)
    return buf[offset:].copy_(x)


def phase_breakdown(ctx):
    """silu_lut / silu_exact against their plain versions, then the paper's
    Fig 7 layer breakdown (repro_torch.layer_breakdown) at medium."""
    import torch
    import torch.nn.functional as F
    from repro_torch import kernel_probe, kernels, layer_breakdown
    from repro_torch.kernels import silu
    from repro_torch.timing import graph_ms
    dev = ctx["device"]
    gen = torch.Generator().manual_seed(3)
    empty = kernel_probe.build(
        ROOT / "build" / "silu_empty", "silu", kernel_probe.SILU_HOOKS,
        {"empty": kernel_probe.SILU_BUILDS["empty"]}, [])["empty"]
    pairs = {"silu_lut": (silu.silu_lut, silu.silu_lut_plain, None),
             "silu_exact": (silu.silu_exact, silu.silu_exact_plain, F.silu)}
    report, ok_all = {}, True
    for label, (n, offset) in SILU_CASES.items():
        xs = silu_inputs(n, gen)
        xt = torch.randn((n,), generator=gen) * 4     # timed
        reps = 5 if n > 1 << 22 else 20
        for dname, dt in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
            x = silu_case(xs, offset, dt, dev)
            t = silu_case(xt, offset, dt, dev)
            for name, (kern, plain, lib) in pairs.items():
                before = kern.launches
                out = kern(x)
                launched = kern.launches - before
                ref = plain(x)
                sync()
                fin = torch.isfinite(ref)
                err = float((out.float() - ref.float())[fin].abs().max())
                ok = same_bits(out, ref) and launched == 1
                ok_all = ok_all and ok
                case = {"n": n, "offset": offset, "max_abs_err": err,
                        "tol": "bitwise", "ok": ok, "launches": launched}
                if label in SILU_TIMED:
                    case.update(
                        ms=graph_ms(lambda: kern(t), reps=reps),
                        empty_ms=graph_ms(kernel_probe.silu_call(
                            empty, name, t), reps=reps),
                        plain_ms=graph_ms(lambda: plain(t), reps=reps),
                        library_ms=(graph_ms(lambda: lib(t), reps=reps)
                                    if lib else None),
                        **bound(2.0 * x.element_size() * n, 4.0 * n,
                                H100_FP32_FLOPS))
                    case["tb_per_s"] = case["bytes"] / case["ms"] / 1e9
                report[f"{name}/{label}/{dname}"] = case
    # the path: Fig 7's layer breakdown, both SiLU kernels included
    kernels.reset_launch_counts()
    rows = layer_breakdown.run("medium", device=dev)
    counts = kernels.launch_counts()
    conv_split = {n: dict(zip(("tc", "simt"), _conv_counts(n)))
                  for n in CONV_NAMES}
    emit({"phase": "breakdown", "silu": report, "fig7_medium": rows,
          "launches": counts, "conv_launches": conv_split})
    for name in CONV_NAMES:     # Fig 7 runs the Cin-16 layers in bf16
        ctx["rows"][name]["split"]["tc"]["launches"] = conv_split[name]["tc"]
        if conv_split[name]["tc"] == 0:
            raise AssertionError(f"the layer breakdown never launched "
                                 f"{name}'s tensor-core kernel")
    for name, replaces in SILU_SOURCES.items():
        main = report[f"{name}/layer_breakdown/float32"]
        ctx["rows"][name] = dict(
            name=name, route="cuda", source="src/repro_torch/csrc/silu.cu",
            replaces=replaces, launches=counts[name],
            max_abs_err=max(c["max_abs_err"] for key, c in report.items()
                            if key.startswith(name + "/")),
            **{key: main[key] for key in ("ms", "empty_ms", "plain_ms",
                                          "bound_ms", "bound_by", "bytes",
                                          "flops", "library_ms")})
    if not ok_all:
        raise AssertionError("a SiLU kernel disagrees with its plain version")
    missing = [n for n in SILU_SOURCES if counts[n] == 0]
    if missing:
        raise AssertionError(f"the layer breakdown never launched {missing}")


def sdpa(q, k, v, causal):
    """F.scaled_dot_product_attention on (B, S, H, D) tensors with grouped
    kv heads: the yardstick for the flash kernel, never called by the
    port."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal,
        enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


# Flash against models.layers.attention: max |err| <= 2e-5 at fp32 and
# 3e-2 at bf16, and at bf16 also |err| <= 2e-3 + 1e-2 |ref| element by
# element. Two bf16 values one ulp apart differ by at most 2^-7 |ref|, so
# an output rounded the other way passes; one dropped 64-key tile or a
# wrong kv head moves it by far more, and the full-width run checks that
# those two stand-ins fail the same test.
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# (q heads, kv heads, D, Dv) of the other LM configurations' attention:
# hubert-xlarge, recurrentgemma-2b (its local attention as global: the
# kernel has no window), deepseek-v3's MLA (128 heads, its kv per head)
SIMT_WIDTHS = {"hubert_xlarge_d80": (16, 16, 80, 80),
               "recurrentgemma_2b_d256": (10, 1, 256, 256),
               "deepseek_v3_mla_d192_dv128": (128, 128, 192, 128)}
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 1e-2, 2e-3
SLSTM_TOL = 1e-4


def flash_excess(out, want) -> float:
    """Largest |out - want| / (atol + rtol |want|) of the bf16 elementwise
    test: at most 1 passes."""
    o, w = out.float(), want.float()
    return float(((o - w).abs()
                  / (FLASH_BF16_ATOL + FLASH_BF16_RTOL * w.abs())).max())


def phase_lm_kernels(ctx):
    """(a) the flash kernel at qwen2.5-32b's attention widths, (b) the fused
    sLSTM at xlstm-1.3b's widths, each against its plain version."""
    import torch
    from repro_torch import kernels
    from repro_torch.configs.lm import get_lm_config
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_causal_gqa)
    from repro_torch.kernels.slstm import launch_plan, slstm_fused
    from repro_torch.timing import cuda_ms
    dev = ctx["device"]
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dt)

    qc, xc = get_lm_config("qwen2.5-32b"), get_lm_config("xlstm-1.3b")
    S, bf16, f32 = 4096, torch.bfloat16, torch.float32

    def qkv(b, sq, sk, hq, hkv, d, dt, scale=1.0):
        return (randn((b, sq, hq, d), dt, scale),
                randn((b, sk, hkv, d), dt, scale),
                randn((b, sk, hkv, d), dt, scale))

    def flash(q, k, v, causal, **blocks):
        if causal:
            return flash_attention_causal_gqa(q, k, v, **blocks)
        return flash_attention(q, k, v, causal=False, **blocks)

    q, k, v = qkv(1, S, S, qc.num_heads, qc.num_kv_heads, qc.head_dim, bf16)
    q32, k32, v32 = qkv(1, 1024, 1024, qc.num_heads, qc.num_kv_heads,
                        qc.head_dim, f32)
    B, nh = 8, xc.num_heads
    dh = xc.d_model // nh
    # fp32 wx as apply_slstm_block feeds it; R scaled by 1/sqrt(dh), the
    # fan-in of the recurrent product (see PERF.md on the conditioning)
    wx = randn((B, S, 4 * xc.d_model), f32)
    r = randn((nh, dh, 4 * dh), f32, dh ** -0.5)

    # the path: both flash entry points at full width in bf16 (each must go
    # through the tensor-core kernel) and in fp32 at S 1024 (the SIMT
    # kernel), and the sLSTM at full width
    kernels.reset_launch_counts()
    outs, tc_calls = {}, []
    for c in (False, True):
        before = flash_attention.tc_launches
        outs[c] = flash(q, k, v, c)
        tc_calls.append(flash_attention.tc_launches - before)
    outs32 = {c: flash(q32, k32, v32, c) for c in (False, True)}
    h = slstm_fused(wx, r)
    sync()
    counts = kernels.launch_counts()
    tc_launches = flash_attention.tc_launches
    simt_launches = flash_attention.simt_launches
    if tc_calls != [1, 1]:
        raise AssertionError(f"the qwen S 4096 bf16 calls did not each "
                             f"launch the tensor-core kernel: {tc_calls}")

    ok_all, fl = True, {}

    def check(label, q, k, v, causal, out=None, chunk=1024, **blocks):
        nonlocal ok_all
        dname = str(q.dtype).split(".")[-1]
        o = flash(q, k, v, causal, **blocks) if out is None else out
        rf = ref.attention(q, k, v, causal=causal, chunk=chunk)
        sync()
        err = float((o.float() - rf.float()).abs().max())
        ok = (o.shape == rf.shape and o.dtype == q.dtype
              and bool(torch.isfinite(o).all()) and err <= FLASH_TOL[dname])
        case = {"shape": list(q.shape), "kv_heads": k.shape[2],
                "max_abs_err": err, "tol": FLASH_TOL[dname],
                "max_abs_ref": float(rf.float().abs().max())}
        if q.dtype == torch.bfloat16:
            case["excess"] = flash_excess(o, rf)
            case["elementwise_tol"] = (f"{FLASH_BF16_ATOL} + "
                                       f"{FLASH_BF16_RTOL} |ref|")
            ok = ok and case["excess"] <= 1.0
        case["ok"] = ok
        ok_all = ok_all and ok
        fl[f"{label}/{'causal' if causal else 'noncausal'}/{dname}"] = case
        return err

    full_err = [check("qwen_S4096", q, k, v, c, out=outs[c])
                for c in (False, True)]
    del outs
    # the bf16 test must fail a reference that drops the last 64-key tile,
    # and one that maps q head h to kv head h % Hkv instead of h // g
    want = ref.attention(q, k, v, causal=False)
    wrong = [h_ % qc.num_kv_heads for h_ in range(qc.num_heads)]
    stand_ins = {
        "last_64_keys_dropped": ref.attention(
            q, k, v, causal=False,
            kv_len=torch.full((1,), S - 64, device=dev)),
        "kv_head_h_mod_hkv": ref.attention(q, k[:, :, wrong], v[:, :, wrong],
                                           causal=False)}
    sensitivity = {name: flash_excess(o, want)
                   for name, o in stand_ins.items()}
    fl["qwen_S4096/stand_ins_must_fail"] = sensitivity
    del want, stand_ins
    if min(sensitivity.values()) <= 1.0:
        raise AssertionError(f"the bf16 flash test passes a wrong "
                             f"attention: {sensitivity}")
    times, times32 = {}, {}
    for c in (False, True):
        times[c] = dict(
            ms=cuda_ms(lambda: flash(q, k, v, c), reps=10),
            plain_ms=cuda_ms(lambda: ref.attention(q, k, v, causal=c),
                             reps=2),
            library_ms=cuda_ms(lambda: sdpa(q, k, v, c), reps=10))
        fl[f"qwen_S4096/{'causal' if c else 'noncausal'}/bfloat16"].update(
            times[c])
    full_err32 = [check("qwen_S1024", q32, k32, v32, c, out=outs32[c])
                  for c in (False, True)]
    for c in (False, True):
        times32[c] = dict(
            ms=cuda_ms(lambda: flash(q32, k32, v32, c), reps=3),
            plain_ms=cuda_ms(lambda: ref.attention(q32, k32, v32, causal=c),
                             reps=2),
            library_ms=cuda_ms(lambda: sdpa(q32, k32, v32, c), reps=10))
        fl[f"qwen_S1024/{'causal' if c else 'noncausal'}/float32"].update(
            times32[c])
    del q32, k32, v32, outs32
    for sq, sk, hq, hkv, d in ((256, 256, 4, 4, 32), (512, 512, 8, 2, 16),
                               (256, 512, 2, 2, 64)):
        small = qkv(2, sq, sk, hq, hkv, d, f32, 0.5)
        for c in ((False, True) if sq == sk else (False,)):
            check(f"cpu_tests_{sq}x{sk}x{hq}x{hkv}x{d}", *small, c,
                  block_q=128, block_k=128)
    check("cpu_tests_bf16", *qkv(1, 256, 256, 2, 2, 32, bf16, 0.5), True,
          block_q=128, block_k=128)
    # tensor cores, ragged tiles, against the reference's online-softmax
    # path (its direct path rounds the normalised p; see
    # tests/test_torch_flash_tc.py)
    ragged = qkv(1, 200, 200, 10, 2, 128, bf16)
    for c in (False, True):
        check("tc_ragged_200", *ragged, c, chunk=40)
    # the SIMT kernel at the other configurations' attention widths, fp32
    # at S 1024 (also timed beside SDPA) and bf16 at S 512 (against the
    # reference's online-softmax path in the kernel's 32-key tiles); each
    # call must launch the SIMT kernel
    widths = {}
    for label, (hq_, hkv_, d_, dv_) in SIMT_WIDTHS.items():
        for dt, s_ in ((f32, 1024), (bf16, 512)):
            qw = randn((1, s_, hq_, d_), dt)
            kw = randn((1, s_, hkv_, d_), dt)
            vw = randn((1, s_, hkv_, dv_), dt)
            dname = str(dt).split(".")[-1]
            for c in (False, True):
                before = flash_attention.simt_launches
                check(label, qw, kw, vw, c,
                      chunk=32 if dt == bf16 else 1024)
                if flash_attention.simt_launches != before + 1:
                    raise AssertionError(f"{label} {dname}: not one launch "
                                         f"of the SIMT kernel")
                if dt == f32:
                    key = f"{label}/{'causal' if c else 'noncausal'}/{dname}"
                    fl[key].update(
                        ms=cuda_ms(lambda: flash(qw, kw, vw, c), reps=3),
                        library_ms=cuda_ms(lambda: sdpa(qw, kw, vw, c),
                                           reps=3))
                    widths[key] = {k_: fl[key][k_]
                                   for k_ in ("ms", "library_ms")}
            del qw, kw, vw
    fl["simt_widths_fp32_S1024_ms"] = widths

    # tensor-core kernel at bf16 S 4096, SIMT kernel at fp32 S 1024, each
    # summed over its non-causal and causal call
    hq, hkv, d = qc.num_heads, qc.num_kv_heads, qc.head_dim
    for name, t, s_, es, peak, n, err in (
            ("flash_attention_tc", times, S, 2, H100_BF16_FLOPS, tc_launches,
             max(full_err)),
            ("flash_attention_simt", times32, 1024, 4, H100_FP32_FLOPS,
             simt_launches, max(full_err32))):
        pairs = s_ * s_ + s_ * (s_ + 1) // 2   # non-causal + causal
        ctx["rows"][name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention.py:72",
            launches=n, max_abs_err=err,
            **{key: sum(x[key] for x in t.values())
               for key in ("ms", "plain_ms", "library_ms")},
            **bound(2.0 * es * (2 * s_ * hq * d + 2 * s_ * hkv * d),
                    4.0 * hq * d * pairs, peak))

    # (b) the sLSTM: the full-width run above against the plain loop
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    h_ref = ref.slstm_sequential(wx, r)
    end.record()
    sync()
    plain_ms = start.elapsed_time(end)
    e = (h - h_ref).abs()
    sl = {"full": {"shape": [B, S, nh, dh], "plan": launch_plan(B, nh, dh),
                   "max_abs_err": float(e.max()),
                   "max_abs_err_first64": float(e[:, :64].max()),
                   "max_abs_err_last64": float(e[:, -64:].max()),
                   "tol": SLSTM_TOL, "finite": bool(torch.isfinite(h).all())}}
    sl["full"]["ok"] = sl["full"]["finite"] and float(e.max()) <= SLSTM_TOL
    del h, h_ref, e
    k_ms = cuda_ms(lambda: slstm_fused(wx, r), reps=3)
    sl["full"].update(ms=k_ms, plain_ms=plain_ms)
    for b, s, nh_, dh_, tb, bt in ((2, 64, 2, 8, 16, 2), (2, 64, 2, 8, 64, 1),
                                   (3, 50, 2, 12, 25, 3)):
        wx_s = randn((b, s, 4 * nh_ * dh_), f32)
        r_s = randn((nh_, dh_, 4 * dh_), f32, 0.3)
        o = slstm_fused(wx_s, r_s, time_block=tb, batch_tile=bt)
        err = float((o - ref.slstm_sequential(wx_s, r_s)).abs().max())
        sl[f"small_{b}x{s}x{nh_}x{dh_}_tb{tb}_bt{bt}"] = {
            "max_abs_err": err, "ok": err <= SLSTM_TOL,
            "plan": launch_plan(b, nh_, dh_)}
    # the JAX package's init for xlstm-1.3b, R ~ N(0, 1/6), where the fp32
    # recurrence is chaotic (PERF.md): the kernel is held to the plain
    # version at 1e-4 over the first 4 steps, and over 64 steps its error
    # against the float64 plain version stays within 4x the fp32 plain
    # version's own, step by step, until that reaches 0.1
    wx_j = randn((B, 64, 4 * xc.d_model), f32)
    r_j = randn((nh, dh, 4 * dh), f32, 6 ** -0.5)
    h_j = slstm_fused(wx_j, r_j)
    p32 = ref.slstm_sequential(wx_j, r_j)
    p64 = ref.slstm_sequential(wx_j.double(), r_j.double())
    e_plain = (h_j - p32).abs().amax(dim=(0, 2))
    e_k64 = (h_j.double() - p64).abs().amax(dim=(0, 2))
    e_p64 = (p32.double() - p64).abs().amax(dim=(0, 2))
    live = e_p64 < 0.1
    ratio = (e_k64 / e_p64.clamp_min(1e-12))[live]
    sl["jax_init_S64"] = {
        "r_std": 6 ** -0.5, "max_abs_err_first4": float(e_plain[:4].max()),
        "tol_first4": SLSTM_TOL, "steps_before_fp32_err_0.1": int(live.sum()),
        "err_vs_fp64_kernel": e_k64.tolist(),
        "err_vs_fp64_plain": e_p64.tolist(),
        "max_ratio_kernel_to_plain": float(ratio.max()),
        "ok": (float(e_plain[:4].max()) <= SLSTM_TOL and bool(
            (e_k64[live] <= 4 * e_p64[live] + 1e-6).all()))}
    del wx_j, h_j, p32, p64
    ok_sl = all(case["ok"] for case in sl.values())
    ctx["rows"]["slstm_fused"] = dict(
        name="slstm_fused", route="cuda", source="src/repro_torch/csrc/slstm.cu",
        replaces="src/repro/kernels/slstm.py:78",
        launches=counts["slstm_fused"], max_abs_err=sl["full"]["max_abs_err"], ms=k_ms, plain_ms=plain_ms,
        library_ms=None,
        **bound(4.0 * (wx.numel() + B * S * nh * dh + r.numel()),
                2.0 * B * S * nh * dh * 4 * dh, H100_FP32_FLOPS))
    emit({"phase": "lm_kernels", "flash_attention": fl, "slstm": sl,
          "launches": counts, "flash_launches": {"tc": tc_launches,
                                                 "simt": simt_launches},
          "flash_build": {
              "build_s": _build.build_seconds.get("flash_attention"),
              "ptxas": ptxas_report(_build.build_logs.get(
                  "flash_attention", ""))}})
    if not (ok_all and ok_sl):
        raise AssertionError("an LM kernel disagrees with its plain version")
    missing = [n for n, c in (("flash_attention_tc", tc_launches),
                              ("flash_attention_simt", simt_launches),
                              ("slstm_fused", counts["slstm_fused"]))
               if c == 0]
    if missing:
        raise AssertionError(f"the LM kernel path never launched {missing}")


def phase_serving(ctx):
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.common import init_params
    from repro_torch.fea import fea2d
    from repro_torch.serve.topo_service import TopoServingEngine
    from repro_torch.serve.types import TopoRequest
    cfg = ctx["cfg"]
    params = init_params(cfg, seed=0, device=ctx["device"])
    kernels.reset_launch_counts()
    runs = {}
    for thr in (0.1, 1e9):
        eng = TopoServingEngine(cfg, params, U_SCALE, slots=4,
                                error_threshold=thr, device=ctx["device"])
        reqs = [TopoRequest(uid=i, problem=p, n_iter=20)
                for i, p in enumerate(problems(fea2d, cfg, 8))]
        t0 = time.perf_counter()
        done = eng.run(reqs)
        wall = time.perf_counter() - t0
        eng.shutdown()
        stats = eng.throughput_stats(wall_s=wall)
        comp = [r.compliance for r in done]
        runs[str(thr)] = {
            "wall_s": wall, "problems_per_s": stats["problems_per_s"],
            "p50_latency_s": stats["p50_latency_s"],
            "p99_latency_s": stats["p99_latency_s"],
            "cronet_iters": [r.cronet_iters for r in done],
            "fea_iters": [r.fea_iters for r in done],
            "cg_iters": [r.cg_iters for r in done], "compliance": comp}
        if not (all(r.done for r in done) and np.all(np.isfinite(comp))):
            raise AssertionError(f"threshold {thr}: unfinished or "
                                 "non-finite request")
    counts = kernels.launch_counts()
    for name in ("cronet_fused", "solve_b_fused"):
        ctx["rows"][name]["launches"] = counts[name]
    ctx["serving"] = runs["0.1"]
    emit({"phase": "serving", "mesh": f"{cfg.nelx}x{cfg.nely}", "slots": 4,
          "requests": 8, "n_iter": 20, "runs": runs, "launches": counts})
    if sum(runs["1000000000.0"]["cronet_iters"]) == 0:
        raise AssertionError("surrogate never accepted at threshold 1e9")
    if min(counts["cronet_fused"], counts["solve_b_fused"]) == 0:
        raise AssertionError(f"a kernel was not launched: {counts}")


def mbb_problems(fea2d, mesh):
    """The 60x20 requests of the gateway and workers phases: the MBB load
    case at four volume fractions and loads. Under the serving generator's
    top point loads fp32 PCG turns NaN at 60x20 once void regions form, in
    the JAX package too (tests/test_torch_hybrid.py::
    test_fp32_pcg_turns_nan_at_60x20_in_both_packages)."""
    return [fea2d.point_load_problem(*mesh, load=(0.0, -m), volfrac=v)
            for v, m in ((0.4, 1.0), (0.45, 1.0), (0.5, 1.0), (0.5, 0.8))]


def same_params(a, b) -> bool:
    """Two parameter trees hold the same dtypes and bits."""
    import torch
    return all(a[p][n].dtype == b[p][n].dtype and torch.equal(a[p][n], b[p][n])
               for p in a for n in a[p])


def phase_gateway(ctx):
    """The registry and the gateway at medium's full width: a round trip
    through a fresh registry, two meshes behind one queue, a canary on
    30x20 promoted part-way through, and an evicted 60x20 bucket rebuilt.
    Both serving kernels must be launched in this phase."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.common import init_params
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.fea import fea2d
    from repro_torch.serve import (ModelRegistry, TopoGateway, TopoRequest,
                                   TopoServingEngine)
    from repro_torch.serve.types import pool_stats
    dev, cfg = ctx["device"], ctx["cfg"]
    small_mesh = (cfg.nelx, cfg.nely)
    big = get_cronet_config("large")
    big_mesh = (big.nelx, big.nely)
    n_iter, thr = 20, 0.1
    root = tempfile.mkdtemp(prefix="chip_smoke_registry_")
    try:
        # -- registry round trip: fp32 exact, the bf16 deploy cast exact
        versions = {"v1": init_params(cfg, seed=0, device=dev,
                                      dtype="float32"),
                    "v2": init_params(cfg, seed=1, device=dev,
                                      dtype="float32")}
        reg = ModelRegistry(root)
        for tag, params in versions.items():
            reg.register(params, cfg, U_SCALE, tag=tag)
        roundtrip = {}
        for tag, params in versions.items():
            f32, rec = reg.load(tag, device=dev)
            b16, _ = reg.load(tag, dtype="bfloat16", device=dev)
            want16 = {p: {n: w.to(torch.bfloat16) for n, w in ws.items()}
                      for p, ws in params.items()}
            roundtrip[tag] = {"float32": same_params(f32, params),
                              "bfloat16": same_params(b16, want16),
                              "on_device": all(
                                  t.device.type == dev.type
                                  for ws in f32.values() for t in ws.values()),
                              "weights": sum(t.numel() for ws in f32.values()
                                             for t in ws.values())}
        if not all(all(v.values()) for v in roundtrip.values()):
            raise AssertionError(f"registry round trip: {roundtrip}")

        # -- the gateway: two meshes, a canary promoted part-way through
        small = problems(fea2d, cfg, 8)
        large = mbb_problems(fea2d, big_mesh)
        # the serving phase's mix through a bare engine and through a
        # gateway of one bucket, both warm and both read by pool_stats:
        # one untimed run of each, then MIX_RUNS of each in turns
        bare = TopoServingEngine(cfg, versions["v1"], U_SCALE, slots=4,
                                 error_threshold=thr, device=dev)
        alone = TopoGateway.from_registry(reg, "v1", slots=4, device=dev,
                                          error_threshold=thr)
        mix = {"engine": [], "gateway": []}
        solo = []
        for run in range(MIX_RUNS + 1):
            for front, label in ((bare, "engine"), (alone, "gateway")):
                t0 = time.perf_counter()
                futs = [front.submit(TopoRequest(uid=100 * run + i,
                                                 problem=p, n_iter=n_iter))
                        for i, p in enumerate(small)]
                got = [f.result(timeout=600) for f in futs]
                run_wall = time.perf_counter() - t0
                solo += got
                if run:
                    mix[label].append(dict(pool_stats(got, run_wall),
                                           wall_s=run_wall))
        bare.shutdown()
        alone.shutdown()
        kernels.reset_launch_counts()
        gw = TopoGateway.from_registry(reg, "v1", slots=4, device=dev,
                                       error_threshold=thr, max_pending=64)
        t0 = time.perf_counter()
        futs = []

        def submit(mesh, prob):
            futs.append(gw.submit(TopoRequest(uid=len(futs), problem=prob,
                                              n_iter=n_iter)))

        for i in range(4):
            submit(small_mesh, small[i])
            if i < 2:
                submit(big_mesh, large[i])
        gw.canary("v2", fraction=0.5, mesh=small_mesh, auto_rollback=False)
        for i in range(4, 8):
            submit(small_mesh, small[i])
            if i < 6:
                submit(big_mesh, large[i - 2])
        done = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        promoted = gw.promote(mesh=small_mesh, timeout=300)
        # -- eviction of the 60x20 bucket and its lazy rebuild
        if not gw.drain(timeout=300):
            raise AssertionError("the gateway did not drain")
        sync()
        mem_before = torch.cuda.memory_allocated(dev)
        if not gw.evict_bucket(big_mesh, timeout=300):
            raise AssertionError("no 60x20 bucket to evict")
        sync()
        mem_after = torch.cuda.memory_allocated(dev)
        first = next(r for r in done if r.mesh == big_mesh)
        rebuilt = gw.submit(TopoRequest(uid=100, problem=first.problem,
                                        n_iter=n_iter)).result(timeout=600)
        counts = kernels.launch_counts()
        stats = gw.throughput_stats(per_mesh=True)
        events = [(e.kind, e.tag) for e in gw.fleet_events()]
        gw.shutdown()
        leased = reg.leased()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- checks against dedicated engines (launches here do not count)
    def dedicated(params, reqs):
        eng = TopoServingEngine(cfg, params, U_SCALE, slots=4,
                                error_threshold=thr, device=dev)
        refs = eng.run([TopoRequest(uid=r.uid, problem=r.problem,
                                    n_iter=n_iter) for r in reqs])
        eng.shutdown()
        return refs

    bitwise = {}
    for tag in ("v1", "v2"):
        mine = [r for r in done if r.mesh == small_mesh and r.model_tag == tag]
        refs = dedicated(versions[tag], mine)
        bitwise[f"{tag}_30x20"] = all(
            np.array_equal(r.density, ref.density)
            and (r.cronet_iters, r.fea_iters) == (ref.cronet_iters,
                                                  ref.fea_iters)
            for r, ref in zip(mine, refs)) and len(mine) > 0
    bitwise["rebuilt_60x20"] = bool(np.array_equal(rebuilt.density,
                                                   first.density))
    tags = {}
    for r in done + [rebuilt]:
        key = f"{r.mesh[0]}x{r.mesh[1]}:{r.model_tag}"
        tags[key] = tags.get(key, 0) + 1
    subset = [r for r in done if r.mesh == small_mesh]
    sub_stats = pool_stats(subset, wall)
    report = {
        "phase": "gateway", "slots": 4, "n_iter": n_iter,
        "error_threshold": thr, "weights": roundtrip["v1"]["weights"],
        "registry_roundtrip": roundtrip, "tags": tags,
        "promoted": promoted, "events": events, "leased_after": leased,
        "mix_30x20_in_turns": {label: {k: [r[k] for r in runs] for k in (
            "wall_s", "problems_per_s", "p50_latency_s", "p99_latency_s")}
            for label, runs in mix.items()},
        "gateway_30x20": {k: sub_stats[k] for k in (
            "problems_per_s", "p50_latency_s", "p99_latency_s")},
        "gateway_all": {"wall_s": wall, "requests": len(done),
                        "problems_per_s": len(done) / wall},
        "serving_30x20": {k: ctx["serving"][k] for k in (
            "wall_s", "problems_per_s", "p50_latency_s", "p99_latency_s")},
        "memory_allocated": {"before_evict": mem_before,
                             "after_evict": mem_after},
        "bitwise": bitwise, "launches": counts,
        "per_mesh": {m: {k: st.get(k) for k in (
            "requests", "p50_latency_s", "p99_latency_s", "total_steps")}
            for m, st in stats["per_mesh"].items()},
        "total_steps": stats["total_steps"],
        "engines": stats["engines"], "evictions": stats["evictions"],
        "rebuilds": stats["rebuilds"], "promotions": stats["promotions"]}
    for name in ("cronet_fused", "solve_b_fused"):
        ctx["rows"][name]["gateway_launches"] = counts[name]
    emit(report)
    unfinished = [r.uid for r in solo + done + [rebuilt]
                  if not (r.done and np.all(np.isfinite(r.density)))]
    mistagged = [r.uid for r in done + [rebuilt]
                 if r.model_tag != r.routed_tag
                 or r.model_tag not in ("v1", "v2")
                 or (r.mesh == big_mesh and r.model_tag != "v1")]
    if unfinished or mistagged:
        raise AssertionError(f"unfinished {unfinished}, mis-tagged "
                             f"{mistagged}")
    key = f"{small_mesh[0]}x{small_mesh[1]}:"
    if promoted != ["v2"] or not tags.get(key + "v1") or \
            not tags.get(key + "v2"):
        raise AssertionError(f"the canary did not serve and promote: {tags}")
    if not all(bitwise.values()):
        raise AssertionError(f"not bitwise: {bitwise}")
    if not mem_after < mem_before:
        raise AssertionError("the evicted bucket kept its device memory: "
                             f"{mem_before} -> {mem_after} bytes")
    if stats["rebuilds"] != 1.0 or leased:
        raise AssertionError(f"rebuilds {stats['rebuilds']}, leases left "
                             f"{leased}")
    if min(counts["cronet_fused"], counts["solve_b_fused"]) == 0:
        raise AssertionError(f"a kernel was not launched: {counts}")


def mix_order(small_mesh, big_mesh):
    """The gateway phase's order of submission: 8 requests on 30x20 and
    4 on 60x20, interleaved, as (mesh, index into its list)."""
    order = []
    for i in range(8):
        order.append((small_mesh, i))
        if i < 2 or 4 <= i < 6:
            order.append((big_mesh, i if i < 2 else i - 2))
    return order


def serve_mix(gw, order, probs, base, n_iter):
    """One warm run of the mix through ``gw``; (done, wall seconds, each
    engine's steps in the run by bucket)."""
    from repro_torch.serve import TopoRequest

    def steps():
        return {bucket_of(e): e.total_steps for e in gw._all_engines()}

    before = steps()
    t0 = time.perf_counter()
    futs = [gw.submit(TopoRequest(uid=base + k, problem=probs[m][i],
                                  n_iter=n_iter))
            for k, (m, i) in enumerate(order)]
    done = [f.result(timeout=600) for f in futs]
    wall = time.perf_counter() - t0
    after = steps()
    return done, wall, {b: after[b] - before.get(b, 0) for b in after}


def dev_of(params):
    """The device a parameter tree lies on (its first tensor's)."""
    return next(iter(next(iter(params.values())).values())).device


def bucket_of(x) -> str:
    """A bucket's label, of an engine or of a completion: mesh and tag."""
    mesh = (x.cfg.nelx, x.cfg.nely) if hasattr(x, "cfg") else x.mesh
    return f"{mesh[0]}x{mesh[1]}:{x.model_tag}"


def ms_per_tick(done, steps) -> dict:
    """Each bucket's ms a tick in one run: the span from its first
    admission to its last completion over the steps it took."""
    out = {}
    for b, n in steps.items():
        mine = [r for r in done if bucket_of(r) == b]
        if mine and n:
            span = (max(r.admitted_t + r.latency_s for r in mine)
                    - min(r.admitted_t for r in mine))
            out[b] = 1e3 * span / n
    return out


def phase_workers(ctx):
    """The gateway's engines in worker processes at medium's full width:
    the gateway phase's mix through workers=3 from the registry, bitwise
    equal to dedicated in-process engines; explicit card params through
    workers=1, bitwise; both serving kernels launched in the workers (their
    own counts); kill -9 mid-tick; the mix timed warm in turns through the
    threaded gateway, workers=3 and workers=1."""
    import dataclasses
    import os
    import shutil
    import signal
    import tempfile
    import numpy as np
    from repro_torch.common import init_params
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.fea import fea2d
    from repro_torch.serve import (ModelRegistry, TopoGateway, TopoRequest,
                                   TopoServingEngine, WorkerLost)
    from repro_torch.serve.types import pool_stats
    from repro_torch.serve.workers import params_digest
    dev, cfg = ctx["device"], ctx["cfg"]
    small_mesh = (cfg.nelx, cfg.nely)
    big = get_cronet_config("large")
    big_mesh = (big.nelx, big.nely)
    n_iter, thr = 20, 0.1
    probs = {small_mesh: problems(fea2d, cfg, 8),
             big_mesh: mbb_problems(fea2d, big_mesh)}
    order = mix_order(small_mesh, big_mesh)
    versions = {tag: init_params(cfg, seed=seed, device=dev, dtype="float32")
                for tag, seed in (("v1", 0), ("v2", 1))}
    explicit = init_params(cfg, seed=2, device=dev, dtype="float32")
    root = tempfile.mkdtemp(prefix="chip_smoke_workers_")
    reg = ModelRegistry(root)
    gateways = {}
    launches = {}
    try:
        for tag, params in versions.items():
            reg.register(params, cfg, U_SCALE, tag=tag)

        def front(workers):
            gw = TopoGateway.from_registry(reg, "v1", slots=4, device=dev,
                                           error_threshold=thr,
                                           max_pending=64, workers=workers)
            gw.canary("v2", fraction=0.5, mesh=small_mesh,
                      auto_rollback=False)
            return gw

        # the pools spawn eagerly: workers=3 first, then its warm run, so
        # each worker's spawn-to-first-build is its own start and build
        t_spawn = time.perf_counter()
        gateways["workers3"] = front(3)
        gateways["workers1"] = front(1)
        gateways["threaded"] = front(None)
        done_all = []           # (front, completion) of every run
        warm = ("workers3", "workers1", "threaded")
        # the last run: the threaded front with the interpreter lock
        # handed over every SHORT_SWITCH_S instead of every 5 ms, which
        # shows how much of its tick is waiting for the lock
        turns = (("threaded", "workers3"),
                 ("workers3", "workers1", "threaded"),
                 ("threaded", "workers3"), ("threaded_short_switch",))
        runs = {label: [] for label in sum(turns, ())}
        switch = sys.getswitchinterval()
        for n, label in enumerate(warm + sum(turns, ())):
            short = label.endswith("_short_switch")
            sys.setswitchinterval(SHORT_SWITCH_S if short else switch)
            try:
                done, wall, steps = serve_mix(
                    gateways[label.replace("_short_switch", "")], order,
                    probs, 1000 * n, n_iter)
            finally:
                sys.setswitchinterval(switch)
            done_all += [(label, r) for r in done]
            if n < len(warm):
                warm_s = time.perf_counter() - t_spawn
                continue
            sub = [r for r in done if r.mesh == small_mesh]
            runs[label].append({
                "wall_s": wall,
                "problems_per_s": len(done) / wall,
                "30x20": {k: pool_stats(sub, wall)[k] for k in (
                    "problems_per_s", "p50_latency_s", "p99_latency_s")},
                "all": {k: pool_stats(done, wall)[k] for k in (
                    "p50_latency_s", "p99_latency_s")},
                "steps": steps,
                "ms_per_tick": ms_per_tick(done, steps)})
        # workers=3 served first: each worker's spawn to the end of its
        # first build (start, imports, CUDA context, registry read)
        spawned = {e.details["worker_id"]: e.t_mono
                   for e in gateways["workers3"].fleet_events("worker-spawn")}
        first_build = {}
        for e in gateways["workers3"].fleet_events("worker-lease"):
            wid = e.details["worker_id"]
            first_build.setdefault(wid, e.t_mono - spawned[wid])
        # spawn to the worker's "ready" (imports done, its loop reading
        # the pipe): the window in which the heartbeat does not ping it
        started = {e.details["worker_id"]: e.details["start_s"]
                   for e in gateways["workers3"].fleet_events("worker-ready")}
        for label in ("workers3", "workers1"):
            launches[label] = gateways[label]._pool.launch_counts()
        leases = {label: {bucket_of(e): e.worker_id
                          for e in gateways[label]._all_engines()}
                  for label in ("workers3", "workers1")}

        # -- explicit (unregistered) card params through workers=1, then
        # kill -9 of its worker mid-tick
        gx = TopoGateway(cfg, explicit, U_SCALE, slots=4, device=dev,
                         error_threshold=thr, workers=1,
                         worker_pool_kwargs={"heartbeat_s": 0.5})
        gateways["explicit"] = gx
        xdone = [f.result(timeout=600) for f in [
            gx.submit(TopoRequest(uid=i, problem=probs[small_mesh][i],
                                  n_iter=n_iter)) for i in range(4)]]
        proxy = gx.engines[small_mesh]
        crossed = {"digest_equal": proxy.build_info["params_digest"]
                   == params_digest(explicit),
                   "params_devices": proxy.build_info["params_devices"],
                   "parent_device": str(dev_of(explicit)),
                   "spec_device": str(proxy.spec["engine_kwargs"]["device"]),
                   "by_value": "params" in proxy.spec}
        victim = gx._pool.live_workers()[0]
        launches["explicit_before_kill"] = gx._pool.launch_counts()
        long = [gx.submit(TopoRequest(uid=10 + i, problem=probs[small_mesh][i],
                                      n_iter=1000)) for i in range(4)]
        queued = [gx.submit(TopoRequest(uid=20 + i,
                                        problem=probs[small_mesh][4 + i],
                                        n_iter=n_iter)) for i in range(2)]

        def admitted(uid):
            with proxy._sched.cond:
                ent = proxy._pending.get(uid)
                return ent is not None and ent[2]

        t0 = time.perf_counter()
        while not all(admitted(10 + i) for i in range(4)):
            if time.perf_counter() - t0 > 300:
                raise AssertionError("the long requests were never admitted")
            time.sleep(0.01)
        os.kill(victim.proc.pid, signal.SIGKILL)
        t_kill = time.perf_counter()
        lost = []
        for f in long:
            try:
                f.result(timeout=600)
                lost.append(None)
            except WorkerLost as exc:
                lost.append(exc.worker_id)
        requeued = [f.result(timeout=600) for f in queued]
        recover_s = time.perf_counter() - t_kill
        crash = {"victim": victim.worker_id, "lost_worker_ids": lost,
                 "requeued_worker_ids": [r.worker_id for r in requeued],
                 "recover_s": recover_s,
                 "events": [e.kind for e in gx.fleet_events()
                            if e.kind.startswith("worker-")],
                 "restarts": gx._pool.stats()["restarts"]}
        launches["explicit_after_kill"] = gx._pool.launch_counts()
    except BaseException:
        # what the pools saw, for a failure that a worker's loss caused
        for label, gw in gateways.items():
            evs = [e for e in gw.fleet_events() if e.kind.startswith("worker-")]
            if evs:
                print(f"chip_smoke: {label} worker events: " + json.dumps(
                    [(e.kind, round(e.t_mono - evs[0].t_mono, 3), e.reason,
                      e.details) for e in evs], default=str),
                    file=sys.stderr)
        raise
    finally:
        for gw in gateways.values():
            gw.shutdown()
        exits = {label: [e.details["exitcode"]
                         for e in gw.fleet_events("worker-exit")]
                 for label, gw in gateways.items() if gw.workers}
        leased = reg.leased()
        shutil.rmtree(root, ignore_errors=True)

    # -- references: dedicated in-process engines (not counted)
    def dedicated(params, mesh, reqs):
        eng = TopoServingEngine(dataclasses.replace(cfg, nelx=mesh[0],
                                                    nely=mesh[1]), params, U_SCALE, slots=4,
                                error_threshold=thr, device=dev)
        refs = eng.run([TopoRequest(uid=k, problem=p, n_iter=n_iter)
                        for k, p in enumerate(reqs)])
        eng.shutdown()
        return refs

    refs = {("v1", small_mesh): dedicated(versions["v1"], small_mesh,
                                          probs[small_mesh]),
            ("v2", small_mesh): dedicated(versions["v2"], small_mesh,
                                          probs[small_mesh]),
            ("v1", big_mesh): dedicated(versions["v1"], big_mesh,
                                        probs[big_mesh]),
            ("x", small_mesh): dedicated(explicit, small_mesh,
                                         probs[small_mesh][:6])}

    def same(r, ref):
        return (np.array_equal(r.density, ref.density)
                and (r.cronet_iters, r.fea_iters, r.cg_iters)
                == (ref.cronet_iters, ref.fea_iters, ref.cg_iters))

    bitwise = {}
    for label, r in done_all:
        mesh, i = order[r.uid % 1000]
        ok = r.model_tag == r.routed_tag and same(
            r, refs[(r.model_tag, mesh)][i])
        key = f"{label}:{mesh[0]}x{mesh[1]}:{r.model_tag}"
        bitwise[key] = bitwise.get(key, True) and ok
    bitwise["explicit"] = all(same(r, refs[("x", small_mesh)][i])
                              for i, r in enumerate(xdone))
    bitwise["requeued"] = all(same(r, refs[("x", small_mesh)][4 + i])
                              for i, r in enumerate(requeued))
    # each worker's own counts (the killed one's as read before the kill)
    summed = {}
    for by_worker in launches.values():
        for counts in by_worker.values():
            for name, n in counts.items():
                summed[name] = summed.get(name, 0) + n
    for name in ("cronet_fused", "solve_b_fused"):
        ctx["rows"][name]["workers_launches"] = summed[name]
    report = {
        "phase": "workers", "cpu_count": os.cpu_count(), "slots": 4,
        "n_iter": n_iter, "error_threshold": thr,
        "requests_per_run": len(order), "warm_s": warm_s,
        "switch_interval_s": {"default": switch, "short": SHORT_SWITCH_S},
        "spawn_to_ready_s": started,
        "spawn_to_first_build_s": first_build, "leases": leases,
        "runs": runs, "bitwise": bitwise, "explicit_params": crossed,
        "crash": crash, "launches": summed,
        "launches_by_worker": launches, "leased_after": leased,
        "worker_exitcodes": exits}
    emit(report)
    unfinished = [r.uid for _, r in done_all if not (
        r.done and np.all(np.isfinite(r.density)))]
    if unfinished or not all(bitwise.values()):
        raise AssertionError(f"unfinished {unfinished}; bitwise {bitwise}")
    if not (crossed["digest_equal"] and crossed["by_value"]
            and crossed["params_devices"] == [str(dev_of(explicit))]
            and dev_of(explicit).type == dev.type):
        raise AssertionError(f"explicit params did not cross: {crossed}")
    if set(lost) != {victim.worker_id} or victim.worker_id in \
            crash["requeued_worker_ids"]:
        raise AssertionError(f"kill -9: {crash}")
    for kind in ("worker-lost", "worker-reassign", "worker-requeue"):
        if kind not in crash["events"]:
            raise AssertionError(f"no {kind} event: {crash['events']}")
    if any(code != 0 for codes in exits.values() for code in codes):
        raise AssertionError(f"a worker did not exit cleanly: {exits}")
    if len(set(leases["workers3"].values())) != 3 or leased:
        raise AssertionError(f"workers=3 leases {leases}, leases left "
                             f"{leased}")
    if min(summed["cronet_fused"], summed["solve_b_fused"]) == 0:
        raise AssertionError(f"a kernel was not launched in a worker: "
                             f"{launches}")


FLY_STEPS = 400                 # training steps at medium
FLY_BATCH = 16
FLY_PARITY_STEPS = 5            # of them again on the host's CPU
FLY_LOSS_RTOL = 1e-3            # card vs CPU, each of those steps
FLY_GRAD_RTOL = 1e-4            # step-0 gradient vs float64, each leaf
FLY_REQUESTS = 16               # serving requests before the trigger
FLY_ROUNDS = 8                  # canary rounds at most


def leaf_errors(got, want) -> dict:
    """Per leaf: |got - want| over |want| (L2 norms, in float64)."""
    import torch

    def norm(t):
        return float(torch.linalg.norm(t.double().cpu().reshape(-1)))

    return {f"{p}/{k}": norm(got[p][k].double().cpu() - want[p][k].cpu())
            / norm(want[p][k]) for p in want for k in want[p]}


def first_nonfinite(ds, t):
    """The first SIMP iteration whose densities are not all finite in
    trajectory ``t`` of a dataset, or None (window w holds iterations
    w .. w + hist_len - 1)."""
    import numpy as np
    rows = ds.rows_of(t)
    xs = np.concatenate([ds.windows[rows[0], :-1], ds.windows[rows, -1]])
    bad = [i for i, x in enumerate(xs) if not np.all(np.isfinite(x))]
    return bad[0] if bad else None


def acceptance(reqs) -> float:
    """Iteration-weighted CRONet acceptance of completed requests."""
    nn = sum(r.cronet_iters for r in reqs)
    total = nn + sum(r.fea_iters for r in reqs)
    return nn / total if total else float("nan")


def phase_flywheel(ctx):
    """CRONet training and one flywheel cycle at medium, fp32, on the
    card: the default dataset (6 cases, 100 SIMP iterations) through
    solve_b_fused; FLY_STEPS training steps from init_params(seed 0)
    with a falling loss, held against the host's CPU on the first steps
    and against a float64 gradient at step 0; the trained version
    registered and read back bitwise; then a gateway serving it with a
    harvest sink, and a FlywheelController carrying one cycle from the
    trigger to promotion. The canary's completions must be bitwise a
    dedicated engine's with the child's weights, the base weights
    untouched, and both serving kernels launched in the phase."""
    import dataclasses
    import shutil
    import statistics
    import tempfile
    import numpy as np
    import torch
    from repro_torch import kernels
    from repro_torch.common import map_params
    from repro_torch.fea import dataset, fea2d, train_cronet
    from repro_torch.serve import (FlywheelController, HarvestLog,
                                   ModelRegistry, TopoGateway, TopoRequest,
                                   TopoServingEngine)
    dev = ctx["device"]
    cfg = dataclasses.replace(ctx["cfg"], dtype="float32")
    mesh = (cfg.nelx, cfg.nely)
    thr, n_iter = 0.05, 20
    kernels.reset_launch_counts()

    # -- 1. the dataset, on the card. The default cases' trajectory 5
    # turns NaN at SIMP iteration 9 in both packages (fp32 PCG, ROADMAP
    # §C), so a NaN trajectory is reported and training runs on the
    # finite ones, rebuilt without it: bitwise the same windows, since
    # run_simp_b's slots do not depend on the batch width
    t0 = time.perf_counter()
    full = dataset.build_dataset(cfg, device=dev)
    sync()
    dataset_s = time.perf_counter() - t0
    data_launches = kernels.launch_counts()["solve_b_fused"]
    first_bad = {t: first_nonfinite(full, t)
                 for t in range(full.n_trajectories)}
    kept = [t for t, bad in first_bad.items() if bad is None]
    data = full
    if len(kept) < full.n_trajectories:
        data = dataset.build_dataset(cfg, cases=[full.cases[t] for t in kept],
                                     device=dev)
    kept_rows = np.concatenate([full.rows_of(t) for t in kept] + [[]])
    same_windows = bool(np.array_equal(
        data.windows, full.windows[kept_rows.astype(np.int64)]))
    finite = bool(np.all(np.isfinite(data.windows))
                  and np.all(np.isfinite(data.targets)))

    root = tempfile.mkdtemp(prefix="chip_smoke_flywheel_")
    try:
        # -- 2. training (train_and_register: 4. registers it as "base")
        reg = ModelRegistry(root)
        torch.cuda.reset_peak_memory_stats(dev)
        held_bytes = torch.cuda.memory_allocated(dev)   # earlier phases'
        t0 = time.perf_counter()
        record, res = train_cronet.train_and_register(
            cfg, reg, tag="base", steps=FLY_STEPS, batch=FLY_BATCH,
            data=data, verbose=False, device=dev)
        train_s = time.perf_counter() - t0
        peak_bytes = torch.cuda.max_memory_allocated(dev)
        losses = res.losses
        first, last = (float(np.mean(losses[:40])),
                       float(np.mean(losses[-40:])))

        # -- 3. the first steps on the CPU, the step-0 gradient in float64
        cpu = train_cronet.train(cfg, steps=FLY_PARITY_STEPS,
                                 batch=FLY_BATCH, data=data, verbose=False,
                                 device="cpu")
        loss_rel = [abs(a - b) / abs(b) for a, b in
                    zip(losses[:FLY_PARITY_STEPS], cpu.losses)]
        train_traj, _ = dataset.split_by_trajectory(data, 0.25, 0)
        rows = np.concatenate([data.rows_of(int(t)) for t in train_traj])
        batch0 = train_cronet.minibatch(data, rows, FLY_BATCH,
                                        np.random.default_rng(0), 0.01)
        from repro_torch.common import init_params
        p0 = init_params(cfg, seed=0, device=dev)
        _, g_card = train_cronet.loss_and_grad(
            cfg, p0, *[torch.from_numpy(a).to(dev) for a in batch0])
        _, g64 = train_cronet.loss_and_grad(
            cfg, map_params(lambda t: t.double().cpu(), p0),
            *[torch.from_numpy(a).double() for a in batch0])
        grad_err = leaf_errors(g_card, g64)

        # -- 4. the registry round trip
        loaded, _ = reg.load("base", device=dev)
        roundtrip = same_params(loaded, res.params)

        # -- 5. one flywheel cycle through the gateway
        log = HarvestLog(accept_below=1.0)
        gw = TopoGateway.from_registry(reg, "base", slots=4, device=dev,
                                       error_threshold=thr, harvest=log)
        base_before = map_params(lambda t: t.clone(), gw.params)
        fly = FlywheelController(
            gw, log, trigger_below=1.01, min_completed=8, min_harvest=2,
            finetune_steps=200, replay_cases=4, canary_fraction=0.5,
            promote_after=4, promote_margin=-1.0)
        probs = problems(fea2d, cfg, FLY_REQUESTS)
        t0 = time.perf_counter()
        futs = [gw.submit(TopoRequest(uid=i, problem=p, n_iter=n_iter))
                for i, p in enumerate(probs)]
        served = [f.result(timeout=600) for f in futs]
        serve_s = time.perf_counter() - t0
        ticks = 0
        t0 = time.perf_counter()
        while not fly.cycles() and not fly.history and ticks < 4:
            fly.tick()
            ticks += 1
        cycle_s = time.perf_counter() - t0
        live = fly.cycles().get(f"{mesh[0]}x{mesh[1]}", {})
        child = live.get("child_tag")
        canary_done, rounds = [], 0
        t0 = time.perf_counter()
        while child and not fly.history and rounds < FLY_ROUNDS:
            futs = [gw.submit(TopoRequest(uid=1000 * (rounds + 1) + i,
                                          problem=p, n_iter=n_iter))
                    for i, p in enumerate(probs[:8])]
            canary_done += [f.result(timeout=600) for f in futs]
            rounds += 1
            fly.tick()
        canary_s = time.perf_counter() - t0
        events = [(e.kind, e.t_mono) for e in gw.fleet_events()]
        base_same = same_params(gw.params, base_before) and \
            same_params(gw.params, res.params)
        gw.shutdown()
        counts = kernels.launch_counts()
        child_rec = reg.get(child) if child else None
        child_params = reg.load(child, device=dev)[0] if child else None
        leased = reg.leased()
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # -- checks against a dedicated engine (launches here do not count)
    mine = [r for r in canary_done if r.model_tag == child]
    bitwise = False
    if mine:
        eng = TopoServingEngine(cfg, child_params, child_rec.u_scale,
                                slots=4, error_threshold=thr, device=dev)
        refs = eng.run([TopoRequest(uid=r.uid, problem=r.problem,
                                    n_iter=n_iter) for r in mine])
        eng.shutdown()
        bitwise = all(np.array_equal(r.density, ref.density)
                      and (r.cronet_iters, r.fea_iters)
                      == (ref.cronet_iters, ref.fea_iters)
                      for r, ref in zip(mine, refs))
    fly_kinds = [k for k, _ in events if k.startswith("flywheel-")]
    t_of = {k: t for k, t in events}
    finetune_s = (t_of["flywheel-canary"] - t_of["flywheel-train"]
                  if {"flywheel-train", "flywheel-canary"} <= set(t_of)
                  else None)
    sides = {"base": [r for r in canary_done if r.model_tag == "base"],
             "child": mine}
    report = {
        "phase": "flywheel", "mesh": f"{mesh[0]}x{mesh[1]}",
        "weights": sum(t.numel() for w in res.params.values()
                       for t in w.values()),
        "dataset": {"seconds": dataset_s, "windows": int(full.n_windows),
                    "trajectories": full.n_trajectories,
                    "first_nonfinite_iteration": first_bad,
                    "train_set": {"trajectories": data.n_trajectories,
                                  "windows": int(data.n_windows),
                                  "u_scale": data.u_scale,
                                  "finite": finite,
                                  "windows_bitwise_as_in_full": same_windows},
                    "solve_b_fused_launches": data_launches},
        "train": {"steps": len(losses), "batch": FLY_BATCH,
                  "seconds": train_s,
                  "step_s_median": statistics.median(res.step_s),
                  "step_s_first": res.step_s[0],
                  "loss_first40": first, "loss_last40": last,
                  "loss_final": losses[-1],
                  "eval": {k: res.eval_metrics[k] for k in (
                      "eval_mse", "mean_rel_err", "acceptance")},
                  "max_memory_allocated": peak_bytes,
                  "memory_allocated_before": held_bytes},
        "parity": {"loss_rel_card_vs_cpu": loss_rel,
                   "loss_rtol": FLY_LOSS_RTOL,
                   "grad_rel_vs_float64": grad_err,
                   "grad_rtol": FLY_GRAD_RTOL},
        "registry_roundtrip_bitwise": roundtrip,
        "flywheel": {
            "served": len(served), "serve_s": serve_s,
            "problems_per_s": len(served) / serve_s,
            "base_acceptance_served": acceptance(served),
            "ticks_to_cycle": ticks, "cycle_tick_s": cycle_s,
            "finetune_s": finetune_s, "child": child,
            "child_parent": child_rec.parent if child_rec else None,
            "child_mesh": list(child_rec.mesh) if child_rec else None,
            "child_metrics": {k: child_rec.metrics.get(k) for k in (
                "eval_mse", "acceptance", "harvested_trajectories")}
            if child_rec else None,
            "canary_rounds": rounds, "canary_s": canary_s,
            "canary_problems_per_s": (len(canary_done) / canary_s
                                      if canary_s else None),
            "acceptance_on_bucket": {k: acceptance(v)
                                     for k, v in sides.items()},
            "completions": {k: len(v) for k, v in sides.items()},
            "states": [c.state.value for c in fly.history],
            "events": fly_kinds, "bitwise_vs_dedicated": bitwise,
            "base_unchanged": base_same, "leased_after": leased,
            "harvest": log.snapshot()},
        "launches": counts}
    for name in ("cronet_fused", "solve_b_fused"):
        ctx["rows"][name]["flywheel_launches"] = counts[name]
    emit(report)
    want = ["flywheel-trigger", "flywheel-harvest", "flywheel-train",
            "flywheel-canary", "flywheel-promote"]
    failures = []
    if not (finite and same_windows and len(kept) >= 2) \
            or data_launches == 0:
        failures.append(f"dataset: finite {finite}, first non-finite "
                        f"iterations {first_bad}, bitwise {same_windows}, "
                        f"solve_b_fused {data_launches}")
    if not (np.all(np.isfinite(losses)) and last < first):
        failures.append(f"loss did not fall: {first} -> {last}")
    if max(loss_rel) > FLY_LOSS_RTOL:
        failures.append(f"card vs CPU losses {loss_rel}")
    if max(grad_err.values()) > FLY_GRAD_RTOL:
        failures.append(f"step-0 gradient vs float64 {grad_err}")
    if not roundtrip:
        failures.append("registry round trip not bitwise")
    if fly_kinds != want:
        failures.append(f"flywheel events {fly_kinds}")
    if not (child_rec and child_rec.parent == "base"
            and child_rec.mesh == mesh):
        failures.append(f"child {child}: {child_rec}")
    if not (mine and bitwise and all(r.routed_tag == r.model_tag
                                     for r in served + canary_done)):
        failures.append(f"canary: {len(mine)} completions, bitwise "
                        f"{bitwise}")
    if not base_same or leased:
        failures.append(f"base unchanged {base_same}, leases {leased}")
    if min(counts["cronet_fused"], counts["solve_b_fused"]) == 0:
        failures.append(f"a kernel was not launched: {counts}")
    if failures:
        raise AssertionError("; ".join(failures))


LM_ARCH = "granite-3-8b"        # the dense configuration one H100 holds whole
LM_SLOTS, LM_MAX_LEN = 4, 128   # launch/serve.py's defaults
LM_REQUESTS, LM_MAX_NEW = 8, 16
LM_LONG = (4, 2048, 4096)       # long prompts: batch, tokens, max_len
LM_DECODE_REPS = 10             # timed decode steps at each cache
LM_CHECK_LAYERS = 2             # depth of the fp32 card-vs-CPU check
LM_CHECK_SHAPE = (2, 16)        # its batch and prompt tokens
LM_GREEDY_STEPS = 4
LM_REL_TOL = 1e-4               # of max |logit|, fp32 checks
LM_PROFILE_STEPS = 3            # decode steps under torch.profiler
LM_FREE_SLACK = 64 << 20        # bytes the phase may leave allocated
LM_MOE_ARCH = "granite-moe-3b-a800m"    # the moe configuration one H100 holds whole
LM_MOE_CUT = ("deepseek-v3-671b", 4)    # 3 dense + 1 MoE layer: 31.6 GB bf16,
                                        # ~47 GB with the fp32 draw of its largest leaf
LM_MOE_CHECK_LAYERS = 4         # depth of granite-moe's fp32 card-vs-CPU check


def lm_max_err(got, want, vocab: int) -> float:
    """max |got - want| over the real vocabulary, over max |want| there."""
    got, want = got[..., :vocab].float(), want[..., :vocab].float()
    return float((got.cpu() - want.cpu()).abs().max()
                 / want.abs().max().clamp_min(1e-30).cpu())


def lm_decode_ms(D, cfg, params, cache, tok, reps: int):
    """Event-timed ms a decode step from ``cache`` (advanced in place),
    and whether every step's logits were finite."""
    import torch
    from repro_torch.timing import cuda_ms
    state = {"cache": cache, "finite": torch.ones((), dtype=torch.bool,
                                                  device=tok.device)}

    def step():         # no host sync inside: the flag stays on the card
        lg, state["cache"] = D.decode_step(cfg, params, tok, state["cache"])
        state["finite"] &= torch.isfinite(lg[..., :cfg.vocab_size]).all()

    return cuda_ms(step, reps=reps), bool(state["finite"])


def lm_greedy(D, cfg, params, tokens, steps: int, max_len: int):
    """Greedy tokens after prefilling ``tokens``: the prefill's, then one
    a decode step."""
    import torch
    lg, cache = D.prefill(cfg, params, {"tokens": tokens}, max_len=max_len)
    out = []
    for _ in range(steps):
        nxt = torch.argmax(lg[:, -1:, :cfg.vocab_size], dim=-1)
        out.append(nxt)
        lg, cache = D.decode_step(cfg, params, nxt, cache)
    return torch.cat(out, dim=1).cpu()


def lm_fp32_check(D, M, cfg, specs, toks, dev) -> dict:
    """The depth-cut fp32 checks on weights drawn from ``specs`` (seed 0)
    on the card and copied to the host: prefill(S-1) + decode_step
    against forward at the last position on the card and the card's
    forward against the CPU's (errors over max |logit|), and the greedy
    tokens of LM_GREEDY_STEPS steps on both."""
    import torch
    from repro_torch.common import map_params, materialize
    v, ss = cfg.vocab_size, toks.shape[1]
    p_card = materialize(specs, seed=0, device=dev)
    p_cpu = map_params(lambda t: t.cpu(), p_card)
    full, _ = M.forward(cfg, p_card, {"tokens": toks.to(dev)})
    _, cache = D.prefill(cfg, p_card, {"tokens": toks[:, :-1].to(dev)},
                         max_len=ss + 4)
    lg, _ = D.decode_step(cfg, p_card, toks[:, -1:].to(dev), cache)
    full_cpu, _ = M.forward(cfg, p_cpu, {"tokens": toks})
    greedy_card = lm_greedy(D, cfg, p_card, toks.to(dev), LM_GREEDY_STEPS,
                            ss + LM_GREEDY_STEPS)
    greedy_cpu = lm_greedy(D, cfg, p_cpu, toks, LM_GREEDY_STEPS,
                           ss + LM_GREEDY_STEPS)
    return {
        "max_abs_logit": float(full[..., :v].abs().max()),
        "decode_vs_forward": lm_max_err(lg[:, 0], full[:, -1], v),
        "card_vs_cpu_forward": lm_max_err(full, full_cpu, v),
        "greedy_tokens_differing": int((greedy_card != greedy_cpu).sum()),
        "greedy_tokens": greedy_card.tolist()}


def first_group_tokens(reqs, dev):
    """The first LM_SLOTS prompts of ``reqs``, left-padded with token 0 as
    ServingEngine pads a group, on ``dev``."""
    import numpy as np
    import torch
    group = reqs[:LM_SLOTS]
    plen = max(len(r.prompt) for r in group)
    toks = torch.zeros((LM_SLOTS, plen), dtype=torch.long)
    for i, r in enumerate(group):
        toks[i, plen - len(r.prompt):] = torch.from_numpy(
            r.prompt.astype(np.int64))
    return toks.to(dev)


def lm_serve_twice(cfg, params, dev, failures) -> dict:
    """launch/serve.py's LM_REQUESTS requests through
    ServingEngine(LM_SLOTS, LM_MAX_LEN) twice (every output LM_MAX_NEW
    tokens in [0, vocab), the same in both runs, or a failure), then decode
    ms a step and a profile at the cache of the first group's prompts,
    left-padded as the engine pads them. Returns the runs' stats, the
    first outputs, ``decode_128`` and the cache's ``cache_bytes``."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import make_requests
    from repro_torch.serve import decode as D
    from repro_torch.serve.server import ServingEngine
    eng = ServingEngine(cfg, params, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                        device=dev)
    runs = []
    for _ in range(2):
        reqs = make_requests(cfg, LM_REQUESTS, LM_MAX_NEW)
        t0 = time.perf_counter()
        eng.run(reqs)
        stats = eng.throughput_stats(reqs)
        stats["wall_s"] = time.perf_counter() - t0
        runs.append((reqs, stats))
    outs = [[r.output for r in reqs] for reqs, _ in runs]
    in_range = all(len(o) == LM_MAX_NEW and 0 <= int(o.min())
                   and int(o.max()) < cfg.vocab_size
                   for o in outs[0] + outs[1])
    same = all(np.array_equal(a, b) for a, b in zip(*outs))
    if not (in_range and same):
        failures.append(f"{cfg.name}: outputs in range {in_range}, same "
                        f"tokens in both runs {same}")

    lg, cache = D.prefill(cfg, params,
                          {"tokens": first_group_tokens(runs[0][0], dev)},
                          max_len=LM_MAX_LEN)
    finite = bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
    tok = torch.argmax(lg[:, -1:, :cfg.vocab_size], dim=-1)
    ms, fin = lm_decode_ms(D, cfg, params, cache, tok, LM_DECODE_REPS)
    state = {"cache": cache}

    def step():
        _, state["cache"] = D.decode_step(cfg, params, tok, state["cache"])

    profile = lm_profile(step, LM_PROFILE_STEPS)
    if not (finite and fin):
        failures.append(f"{cfg.name}: non-finite logits at max_len "
                        f"{LM_MAX_LEN}")
    return {"runs": [st for _, st in runs],
            "outputs_first_run": [o.tolist() for o in outs[0][:2]],
            "decode_128": {"profile": profile, "ms_a_step": ms,
                           "tokens_per_s_at_slots": LM_SLOTS / ms * 1e3},
            "cache_bytes": sum(t.numel() * t.element_size()
                               for k, t in cache.items() if k != "index")}


def lm_profile(step, n: int) -> dict:
    """torch.profiler over ``n`` calls of ``step``: wall and device ms a
    call (kernel time summed), the device's idle share, launches a call
    and the five kernels that take the most time."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    step()
    sync()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    return {"calls": n, "wall_ms_a_call": wall_ms / n,
            "device_ms_a_call": device_ms / n,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "launches_a_call": len(kernels) / n,
            "top_kernels_ms": sorted(by_name.items(),
                                     key=lambda kv: -kv[1])[:5]}


def phase_lm_serving(ctx):
    """granite-3-8b served whole on the card: bf16, 40 layers, every width
    as published, weights from materialize(seed 0). launch/serve.py's
    8 requests (seed-0 prompts of 4-31 tokens, max_new 16) through
    ServingEngine(slots 4, max_len 128), twice: every output max_new
    tokens in [0, vocab), the same tokens in both runs. Decode ms a step
    at that cache and after a prefill of 4 prompts of 2,048 tokens at
    max_len 4096 (the chunked attention path), beside the bound (weight
    and cache bytes, each read once, over 3.35 TB/s), and a profile of
    decode steps. Then granite-3-8b at full width, depth 2, fp32 (TF32
    off), its layers drawn at the full model's scale: prefill(S-1) +
    decode_step against forward at the last position, the card's forward
    against the host CPU's on the same weights (each within LM_REL_TOL of
    max |logit|), and the greedy tokens of LM_GREEDY_STEPS steps on both,
    the differing ones counted; the same reported at materialize's scale
    for the cut depth. Frees what it allocates."""
    import dataclasses
    import gc
    import torch
    from repro_torch.common import (map_params, materialize, param_bytes,
                                    param_count)
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    dev = ctx["device"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    failures = []
    cfg = get_config(LM_ARCH)
    specs = M.param_specs(cfg)
    weight_bytes = param_bytes(specs)
    out = {"phase": "lm_serving", "arch": cfg.name, "dtype": cfg.dtype,
           "layers": cfg.num_layers, "weights": param_count(specs),
           "weight_bytes": weight_bytes, "nvidia_smi": ctx["smi"],
           "memory_allocated_before": before}

    with torch.inference_mode():
        # -- 1. the whole model, served twice
        t0 = time.perf_counter()
        params = materialize(specs, seed=0, device=dev)
        sync()
        out["materialize_s"] = time.perf_counter() - t0
        out["memory_allocated_weights"] = torch.cuda.memory_allocated(dev)
        served = lm_serve_twice(cfg, params, dev, failures)
        cache_bytes = served.pop("cache_bytes")
        served["decode_128"].update(
            cache_bytes=cache_bytes,
            bound_ms=(weight_bytes + cache_bytes) / H100_BYTES_PER_S * 1e3)
        out.update(served)

        # -- 2. long prompts: the chunked prefill, then decode at 4096
        b, s, max_len = LM_LONG
        gen = torch.Generator().manual_seed(0)
        long_toks = torch.randint(0, cfg.vocab_size, (b, s),
                                  generator=gen).to(dev)
        prefill_ms = []
        for _ in range(2):          # the first call also warms up
            cache = None
            sync()
            t0 = time.perf_counter()
            lg, cache = D.prefill(cfg, params, {"tokens": long_toks},
                                  max_len=max_len)
            sync()
            prefill_ms.append((time.perf_counter() - t0) * 1e3)
        finite = bool(torch.isfinite(lg[..., :cfg.vocab_size]).all())
        tok = torch.argmax(lg[:, -1:, :cfg.vocab_size], dim=-1)
        ms, fin = lm_decode_ms(D, cfg, params, cache, tok, LM_DECODE_REPS)
        cache_bytes = 2 * cache["k"].numel() * cache["k"].element_size()
        out["long"] = {
            "batch": b, "prompt_tokens": s, "max_len": max_len,
            "prefill_ms": prefill_ms, "decode_ms_a_step": ms,
            "cache_bytes": cache_bytes,
            "decode_bound_ms": (weight_bytes + cache_bytes)
            / H100_BYTES_PER_S * 1e3,
            "peak_memory_allocated_in_phase":
                torch.cuda.max_memory_allocated(dev)}
        if not (finite and fin):
            failures.append("non-finite logits after the long prefill")
        del params, cache, lg, long_toks
        gc.collect()
        torch.cuda.empty_cache()

        # -- 3. fp32 at full width, depth cut: decode vs forward, card vs
        # the host's CPU on the same weights. Drawn at the full model's
        # layer scale (gated) and at materialize's scale for the cut depth
        # (reported): the reference's rule takes fan_in = shape[0], the
        # layer count, so cutting 40 layers to 2 makes every layer weight
        # 4.5x larger (std 1/sqrt(2), not 1/sqrt(40)), attention scores
        # ~20x larger, and the sharper softmax turns fp32 rounding into
        # logit changes past the bar
        cfg2 = dataclasses.replace(cfg, num_layers=LM_CHECK_LAYERS,
                                   dtype="float32")
        bb, ss = LM_CHECK_SHAPE
        toks = torch.randint(0, cfg2.vocab_size, (bb, ss), generator=gen)
        specs2 = M.param_specs(cfg2)
        full_scale = dict(specs2, blocks=map_params(
            lambda sp: dataclasses.replace(sp, init=("scaled", cfg.num_layers))
            if sp.init == "normal" else sp, specs2["blocks"]))
        out["fp32_check"] = {
            "layers": LM_CHECK_LAYERS, "weights": param_count(specs2),
            "batch": bb, "tokens": ss,
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "full_model_scale": lm_fp32_check(D, M, cfg2, full_scale, toks,
                                              dev),
            "materialize_depth2_scale": lm_fp32_check(D, M, cfg2, specs2,
                                                      toks, dev)}
        chk = out["fp32_check"]["full_model_scale"]
        if max(chk["decode_vs_forward"], chk["card_vs_cpu_forward"]) \
                > LM_REL_TOL:
            failures.append(f"fp32 check over {LM_REL_TOL} of max |logit|: "
                            f"{chk}")

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    out["memory_allocated_after"] = after
    if after > before + LM_FREE_SLACK:
        failures.append(f"memory_allocated {before} before, {after} after")
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


@contextlib.contextmanager
def routes_recorded():
    """Record each call of ``repro_torch.models.moe.route`` while the
    block runs: its input rows and ids, in call order (the package has no
    hook; the module's function is wrapped here and put back after)."""
    from repro_torch.models import moe
    route, calls = moe.route, []

    def recording(cfg, x, w):
        out = route(cfg, x, w)
        calls.append({"x": x, "ids": out[0]})
        return out

    moe.route = recording
    try:
        yield calls
    finally:
        moe.route = route


def at_layer_scale(specs, keys, n: int):
    """``specs`` with every "normal" leaf under ``keys`` drawn at std
    1/sqrt(n): the full model's layer scale where the cut depth's
    ``fan_in = shape[0]`` would draw larger weights."""
    import dataclasses
    from repro_torch.common import map_params

    def scaled(sp):
        return (dataclasses.replace(sp, init=("scaled", n))
                if sp.init == "normal" else sp)

    return dict(specs, **{k: map_params(scaled, specs[k]) for k in keys})


def moe_bounds(cfg, specs, cache_bytes: int) -> dict:
    """Decode-step bounds over 3.35 TB/s: every weight and the cache read
    once (the reference's capacity-buffer FFN multiplies every expert each
    step), and the weights one token's path needs (the embedding table and
    the MTP module not read, top_k of num_experts routed experts)."""
    from repro_torch.common import param_bytes
    every = param_bytes(specs)
    moe = specs["moe_blocks"]["moe"]
    experts = param_bytes({k: moe[k] for k in ("wg", "wu", "wd")})
    unread = param_bytes({k: specs[k] for k in ("mtp",) if k in specs})
    if not cfg.tie_embeddings:
        unread += param_bytes({"embed": specs["embed"]})
    active = every - unread - experts + experts * cfg.top_k / cfg.num_experts
    return {"bound_all_weights_ms":
            (every + cache_bytes) / H100_BYTES_PER_S * 1e3,
            "bound_active_ms": (active + cache_bytes) / H100_BYTES_PER_S * 1e3,
            "active_weight_bytes": int(active)}


def route_check(cfg, x, w, dev) -> dict:
    """``moe.route`` on the card against the host CPU on rows ``x`` and
    router ``w`` (fp32): the card's ids must be its own scores' top_k with
    the lower index first among ties (a numpy lexsort), and equal to the
    CPU's wherever the CPU's top_k-th and next scores differ; the rest
    are reported."""
    import numpy as np
    import torch
    from repro_torch.models import moe
    k = cfg.top_k
    ids, _, _ = moe.route(cfg, x.to(dev), w.to(dev))
    ids_cpu, _, _ = moe.route(cfg, x.cpu(), w.cpu())
    sc = torch.sigmoid(x.to(dev).float() @ w.to(dev).float()).cpu().numpy()
    sc_cpu = torch.sigmoid(x.cpu().float() @ w.cpu().float()).numpy()
    idx = np.arange(sc.shape[1])
    want = np.stack([np.lexsort((idx, -row))[:k] for row in sc])
    ids, ids_cpu = ids.cpu().numpy(), ids_cpu.numpy()
    top = -np.sort(-sc_cpu, axis=1)
    gated = top[:, k - 1] > top[:, k]
    same = (ids == ids_cpu).all(1)
    return {"rows": int(len(ids)), "experts": int(sc.shape[1]),
            "saturated_a_row_mean": float((sc == 1.0).sum(1).mean()),
            "tie_order_on_card": bool((ids == want).all()),
            "rows_gated": int(gated.sum()),
            "gated_equal_card_vs_cpu": bool(same[gated].all()),
            "ungated_equal_card_vs_cpu": int(same[~gated].sum()),
            "ungated": int((~gated).sum())}


def routes_by_sequence(calls, b: int):
    """Each recorded call's ids as (B, S, k), on the host."""
    return [c["ids"].cpu().reshape(b, -1, c["ids"].shape[-1]) for c in calls]


@contextlib.contextmanager
def blocks_recorded():
    """Record each call of the moe family's blocks
    (``model._dense_block``, ``model._moe_block``) while the block runs:
    the function's name, its arguments and its output (wrapped here, put
    back after)."""
    from repro_torch.models import model as M
    saved = {n: getattr(M, n) for n in ("_dense_block", "_moe_block")}
    calls = []

    def recording(name):
        def call(cfg, p, x, positions, *rest, **kw):
            out = saved[name](cfg, p, x, positions, *rest, **kw)
            calls.append((name, p, x, positions, out))
            return out
        return call

    for name in saved:
        setattr(M, name, recording(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(M, name, fn)


def moe_fp32_check(cfg, specs, toks, dev) -> dict:
    """The moe family's fp32 checks on weights drawn from ``specs`` (seed
    0) on the card and copied to the host, with every route call
    recorded. Gated by the caller: each block on the card from the host
    CPU's input to it, against the CPU's output (teacher-forced: the
    block's own error, errors over its max |out|; MoE blocks whose
    routing agrees), the unembedding of the CPU's last hidden state, and
    prefill(S-1) + decode_step against forward at the last position on
    the card over the sequences whose routing agrees (errors over max
    |logit|). Reported: forward on the card against the CPU's end to end
    (over the sequences whose routing agrees, the parted tokens counted)
    beside the CPU's own spread (its forward at one thread against all),
    and the greedy tokens of LM_GREEDY_STEPS steps on both."""
    import torch
    from repro_torch.common import map_params, materialize
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    v, (b, ss) = cfg.vocab_size, toks.shape
    p_card = materialize(specs, seed=0, device=dev)
    p_cpu = map_params(lambda t: t.cpu(), p_card)
    with routes_recorded() as fwd:
        full, _ = M.forward(cfg, p_card, {"tokens": toks.to(dev)})
    with routes_recorded() as fwd_cpu, blocks_recorded() as blocks:
        hidden_cpu, _ = M.forward(cfg, p_cpu, {"tokens": toks},
                                  return_hidden=True)
    full_cpu = M.unembed_logits(cfg, p_cpu, hidden_cpu)
    with routes_recorded() as dec:
        _, cache = D.prefill(cfg, p_card, {"tokens": toks[:, :-1].to(dev)},
                             max_len=ss + 4)
        lg, _ = D.decode_step(cfg, p_card, toks[:, -1:].to(dev), cache)

    def err(got, want):
        got, want = got.float().cpu(), want.float().cpu()
        return float((got - want).abs().max() / want.abs().max())

    # each block on the card from the CPU's input to it
    with routes_recorded() as replay:
        outs = [getattr(M, name)(cfg, map_params(lambda t: t.to(dev), p),
                                 x.to(dev), pos.to(dev))
                for name, p, x, pos, _ in blocks]
    moe_calls = iter(zip(fwd_cpu, replay))
    block_errs = []
    for (name, _, _, _, want), got in zip(blocks, outs):
        if name == "_moe_block":
            a, c = next(moe_calls)
            if not torch.equal(a["ids"].cpu(), c["ids"].cpu()):
                block_errs.append(None)        # routing parted: not gated
                continue
            got, want = got[0], want[0]
        block_errs.append(err(got, want))
    unembed_err = lm_max_err(M.unembed_logits(cfg, p_card,
                                              hidden_cpu.to(dev)),
                             full_cpu, v)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one_thread, _ = M.forward(cfg, p_cpu, {"tokens": toks})
    finally:
        torch.set_num_threads(threads)

    n = len(fwd)
    card, host = routes_by_sequence(fwd, b), routes_by_sequence(fwd_cpu, b)
    pre = routes_by_sequence(dec, b)        # the prefill's n, then the step's
    stepped = [torch.cat([pre[i], pre[n + i]], 1) for i in range(n)]

    def agreeing(a, c):
        parted = torch.stack([(x != y).any(-1) for x, y in zip(a, c)])
        return ~parted.any(0).any(-1), int(parted.sum())

    seq_cpu, parted_cpu = agreeing(card, host)
    seq_dec, parted_dec = agreeing(card, stepped)
    greedy_card = lm_greedy(D, cfg, p_card, toks.to(dev), LM_GREEDY_STEPS,
                            ss + LM_GREEDY_STEPS)
    greedy_cpu = lm_greedy(D, cfg, p_cpu, toks, LM_GREEDY_STEPS,
                           ss + LM_GREEDY_STEPS)
    seq_dec_dev = seq_dec.to(dev)
    return {
        "max_abs_logit": float(full[..., :v].abs().max()),
        "blocks_card_vs_cpu_teacher_forced": block_errs,
        "unembed_card_vs_cpu": unembed_err,
        "card_vs_cpu_forward": (lm_max_err(full[seq_cpu.to(dev)],
                                           full_cpu[seq_cpu], v)
                                if seq_cpu.any() else None),
        "cpu_one_thread_vs_all": lm_max_err(one_thread, full_cpu, v),
        "cpu_threads": threads,
        "sequences_gated_card_vs_cpu": int(seq_cpu.sum()),
        "token_layers_parted_card_vs_cpu": parted_cpu,
        "decode_vs_forward": (lm_max_err(lg[seq_dec_dev, 0],
                                         full[seq_dec_dev, -1], v)
                              if seq_dec.any() else None),
        "sequences_gated_decode_vs_forward": int(seq_dec.sum()),
        "token_layers_parted_decode_vs_forward": parted_dec,
        "route_calls_a_forward": n,
        "greedy_tokens_differing": int((greedy_card != greedy_cpu).sum()),
        "greedy_tokens": greedy_card.tolist()}


def mla_check(cfg, n_scale: int, shape, dev) -> dict:
    """``mla.apply_mla`` on one layer's weights at full width in fp32,
    drawn at std 1/sqrt(n_scale) (seed 0): the absorbed decode step after
    a materialized prefill of S-1 tokens against the materialized form over
    S tokens at the last position, on the card; and the card's
    materialized form against the host CPU's on the same weights (errors
    over max |out|)."""
    import torch
    from repro_torch.common import map_params, materialize
    from repro_torch.models import mla
    from repro_torch.models.transformer import layer_params
    b, s = shape
    specs = at_layer_scale({"attn": mla.mla_specs(cfg, 1)}, ("attn",),
                           n_scale)
    p = layer_params(materialize(specs, seed=0, device=dev)["attn"], 0)
    p_cpu = map_params(lambda t: t.cpu(), p)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((b, s, cfg.d_model), generator=gen)
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    full, _ = mla.apply_mla(cfg, p, x.to(dev), pos.to(dev))
    cache = {"ckv": torch.zeros((b, s + 4, cfg.kv_lora_rank), device=dev),
             "krope": torch.zeros((b, s + 4, cfg.qk_rope_head_dim),
                                  device=dev)}
    mla.apply_mla(cfg, p, x[:, :-1].to(dev), pos[:, :-1].to(dev),
                  kv_cache=cache, cache_index=0)
    step, _ = mla.apply_mla(cfg, p, x[:, -1:].to(dev), pos[:, -1:].to(dev),
                            kv_cache=cache, cache_index=s - 1)
    full_cpu, _ = mla.apply_mla(cfg, p_cpu, x, pos)

    def err(got, want):
        got, want = got.float().cpu(), want.float().cpu()
        return float((got - want).abs().max() / want.abs().max())

    return {"weights": sum(t.numel() for t in p.values()), "batch": b,
            "tokens": s, "max_abs_out": float(full_cpu.abs().max()),
            "absorbed_vs_materialized": err(step[:, 0], full[:, -1]),
            "card_vs_cpu": err(full, full_cpu)}


def phase_lm_moe(ctx):
    """The moe family served on the card. (a) granite-moe-3b-a800m whole:
    bf16, 32 layers, 40 experts top-8, every width as published, weights
    from materialize(seed 0); (b) deepseek-v3-671b cut to LM_MOE_CUT's 4
    layers (3 dense + 1 MoE: MLA, 1 shared and 256 routed experts,
    sigmoid top-8, every width as published). Each serves launch/serve.py's
    requests through ServingEngine twice (the same tokens in both runs,
    all in range), with decode ms a step, a profile and two bounds. On
    deepseek's hidden states (the first group's prefill, recorded), route
    on the card against the CPU at d 7168 and 256 experts, with its own
    router and one drawn at the full model's scale. (c) fp32, TF32 off,
    at the full model's layer scale (gated at LM_REL_TOL of max |logit|
    or |out|), the cut depth's scale reported: granite-moe at depth 4 at a
    capacity factor of num_experts / top_k (no assignment dropped), its
    blocks card against CPU teacher-forced and decode against forward
    (moe_fp32_check); deepseek's apply_mla on one layer at full width,
    absorbed decode against the materialized form and card against CPU.
    Frees what it allocates."""
    import dataclasses
    import gc
    import torch
    from repro_torch.common import materialize, param_bytes, param_count
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve import decode as D
    dev = ctx["device"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    failures = []
    out = {"phase": "lm_moe", "nvidia_smi": ctx["smi"],
           "memory_allocated_before": before}

    def served(cfg):
        specs = M.param_specs(cfg)
        t0 = time.perf_counter()
        params = materialize(specs, seed=0, device=dev)
        sync()
        res = {"arch": cfg.name, "dtype": cfg.dtype,
               "layers": cfg.num_layers,
               "dense_layers": cfg.num_dense_layers,
               "experts": cfg.num_experts, "top_k": cfg.top_k,
               "shared_experts": cfg.num_shared_experts,
               "mla": cfg.use_mla, "weights": param_count(specs),
               "weight_bytes": param_bytes(specs),
               "materialize_s": time.perf_counter() - t0,
               "memory_allocated_weights": torch.cuda.memory_allocated(dev),
               "peak_memory_allocated_materialize":
                   torch.cuda.max_memory_allocated(dev)}
        res.update(lm_serve_twice(cfg, params, dev, failures))
        cache_bytes = res.pop("cache_bytes")
        res["decode_128"].update(cache_bytes=cache_bytes,
                                 **moe_bounds(cfg, specs, cache_bytes))
        return res, params

    with torch.inference_mode():
        # -- (a) granite-moe-3b-a800m whole
        out["granite_moe"], params = served(get_config(LM_MOE_ARCH))
        del params
        gc.collect()
        torch.cuda.empty_cache()

        # -- (b) deepseek-v3-671b cut in depth, every width as published
        name, layers = LM_MOE_CUT
        full_cfg = get_config(name)
        cfg = dataclasses.replace(full_cfg, num_layers=layers)
        ds, params = served(cfg)
        ds["cut"] = {"num_layers": [full_cfg.num_layers, layers],
                     "moe_layers": [full_cfg.num_layers
                                    - full_cfg.num_dense_layers,
                                    layers - cfg.num_dense_layers],
                     "widths": "as published"}
        toks = first_group_tokens(make_requests(cfg, LM_REQUESTS,
                                                LM_MAX_NEW), dev)
        with routes_recorded() as calls:
            D.prefill(cfg, params, {"tokens": toks}, max_len=LM_MAX_LEN)
        x = calls[0]["x"]
        n_moe = full_cfg.num_layers - full_cfg.num_dense_layers
        router_full = materialize(at_layer_scale(
            {"r": MOE.moe_specs(cfg, 1, True)["router"]}, ("r",), n_moe),
            seed=1, device=dev)["r"][0]
        ds["route"] = {
            "served_router_std_1": route_check(
                cfg, x, params["moe_blocks"]["moe"]["router"][0], dev),
            "full_model_scale": route_check(cfg, x, router_full, dev)}
        for key, chk in ds["route"].items():
            if not (chk["tie_order_on_card"]
                    and chk["gated_equal_card_vs_cpu"]):
                failures.append(f"deepseek route {key}: {chk}")
        ds["peak_memory_allocated_in_phase"] = \
            torch.cuda.max_memory_allocated(dev)
        out["deepseek_cut"] = ds
        del params, calls, x, router_full
        gc.collect()
        torch.cuda.empty_cache()

        # -- (c) fp32 at the full model's layer scale (gated) and at the cut
        # depth's (reported)
        gm = get_config(LM_MOE_ARCH)
        no_drop = gm.num_experts / gm.top_k
        cfg4 = dataclasses.replace(gm, num_layers=LM_MOE_CHECK_LAYERS,
                                   dtype="float32",
                                   moe_capacity_factor=no_drop)
        gen = torch.Generator().manual_seed(0)
        toks = torch.randint(0, cfg4.vocab_size, LM_CHECK_SHAPE,
                             generator=gen)
        specs4 = M.param_specs(cfg4)
        chk = moe_fp32_check(cfg4, at_layer_scale(specs4, ("moe_blocks",),
                                                  gm.num_layers), toks, dev)
        ds32 = dataclasses.replace(full_cfg, dtype="float32")
        mla_full = mla_check(ds32, n_moe, LM_CHECK_SHAPE, dev)
        out["fp32_check"] = {
            "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "granite_moe": {
                "layers": LM_MOE_CHECK_LAYERS, "weights": param_count(specs4),
                "batch": LM_CHECK_SHAPE[0], "tokens": LM_CHECK_SHAPE[1],
                "capacity_factor": no_drop,
                "full_model_scale": chk,
                "materialize_depth4_scale": moe_fp32_check(cfg4, specs4,
                                                           toks, dev)},
            "deepseek_mla_layer": {
                "full_model_scale": mla_full,
                "materialize_depth4_scale": mla_check(ds32, 1,
                                                      LM_CHECK_SHAPE, dev)}}
        gated = [e for e in chk["blocks_card_vs_cpu_teacher_forced"]
                 if e is not None]
        errs = [max(gated, default=None), chk["unembed_card_vs_cpu"],
                chk["decode_vs_forward"],
                mla_full["absorbed_vs_materialized"], mla_full["card_vs_cpu"]]
        if any(e is None or e > LM_REL_TOL for e in errs):
            failures.append(f"fp32 checks over {LM_REL_TOL}: {errs}")

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    out["memory_allocated_after"] = after
    out["peak_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    if after > before + LM_FREE_SLACK:
        failures.append(f"memory_allocated {before} before, {after} after")
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


LM_REC_ARCHS = ("recurrentgemma-2b", "xlstm-1.3b")    # each whole on one H100
LM_REC_WRAP_STEPS = 16          # decode steps after the long prefill: the
                                # hybrid's 2,048-slot window wraps
LM_REC_CHECK = {"recurrentgemma-2b": (3, {"superblocks": 8}),
                "xlstm-1.3b": (8, {"superblocks/slstm": 6,
                                   "superblocks/mlstm": 42})}
                                # one superblock each; each stack drawn at
                                # the full model's layers of its kind
LM_REC_SCAN = (4, 2048)         # the RG-LRU scan check: batch, steps
LM_REC_FORMS = (2, 128)         # the mLSTM forms check: batch, steps (dh 1024)
LM_SLSTM_WINDOWS = (16, 64, 256)  # the sLSTM run card vs CPU: the first
                                  # window gated, the longer ones reported


def at_scales(specs, scales: dict):
    """``specs`` with every "normal" leaf under each path of ``scales``
    ("a" or "a/b") drawn at std 1/sqrt(n): ``at_layer_scale`` one level
    down where the path has two parts."""
    out = dict(specs)
    for path, n in scales.items():
        head, _, sub = path.partition("/")
        if sub:
            out[head] = at_layer_scale(out[head], (sub,), n)
        else:
            out = at_layer_scale(out, (head,), n)
    return out


@contextlib.contextmanager
def rec_blocks_recorded():
    """Record each call of the recurrent families' blocks
    (``recurrent.apply_{rglru,mlstm,slstm}_block``,
    ``transformer.apply_block``) while the block runs: its name, the
    function, its arguments and its output (wrapped here, put back
    after)."""
    from repro_torch.models import recurrent as R
    from repro_torch.models import transformer as T
    targets = [(R, "apply_rglru_block"), (R, "apply_mlstm_block"),
               (R, "apply_slstm_block"), (T, "apply_block")]
    saved = {(mod, name): getattr(mod, name) for mod, name in targets}
    calls = []

    def recording(mod, name):
        fn = saved[(mod, name)]

        def call(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, fn, args, kw, out))
            return out
        return call

    for mod, name in targets:
        setattr(mod, name, recording(mod, name))
    try:
        yield calls
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (at least 1), on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1.0))


def op_replay(fn, args, kw, dev, top: int = 8) -> dict:
    """Every floating-point aten op of ``fn(*args, **kw)`` on the host CPU
    recorded with its inputs and output, then replayed on the card from
    the CPU's inputs (op by op, teacher-forced) and on the CPU at one
    thread: each op's card error and the CPU's own spread over max |out|.
    Returns the ``top`` ops by card error, in order of the call, how many
    ops differ at all, and those on the card by op (count, worst error)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map
    ops = []

    def clone(t):
        return t.detach().clone() if isinstance(t, torch.Tensor) else t

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), k=None):
            k = k or {}
            res = func(*a, **k)
            if (isinstance(res, torch.Tensor) and res.is_floating_point()
                    and res.numel()):
                ops.append((func, tree_map(clone, a), tree_map(clone, k),
                            clone(res)))
            return res

    with torch.no_grad(), Record():
        fn(*args, **kw)

    def to_card(t):
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        return dev if isinstance(t, torch.device) else t

    def err(got, want):
        got, want = got.double().cpu(), want.double()
        finite = torch.isfinite(want)
        scale = float(want[finite].abs().max()) if finite.any() else 1.0
        return float((got - want)[finite].abs().max()) / max(scale, 1e-30)

    rows = []
    threads = torch.get_num_threads()
    for i, (func, a, k, want) in enumerate(ops):
        with torch.no_grad():
            card = func(*tree_map(to_card, a), **tree_map(to_card, k))
            torch.set_num_threads(1)
            try:
                one = func(*a, **k)
            finally:
                torch.set_num_threads(threads)
        rows.append({"index": i, "op": str(func), "shape": list(want.shape),
                     "card_vs_cpu": err(card, want),
                     "cpu_one_thread_vs_all": err(one, want)})
    worst = sorted(rows, key=lambda r: r["card_vs_cpu"])[-top:]
    differing = {}
    for r in rows:
        if r["card_vs_cpu"] > 0:
            n, e = differing.get(r["op"], (0, 0.0))
            differing[r["op"]] = (n + 1, max(e, r["card_vs_cpu"]))
    return {"ops": len(rows),
            "ops_differing_on_card": sum(r["card_vs_cpu"] > 0 for r in rows),
            "ops_differing_on_one_cpu_thread":
                sum(r["cpu_one_thread_vs_all"] > 0 for r in rows),
            "differing_on_card_by_op": differing,
            "top": sorted(worst, key=lambda r: r["index"])}


def rec_fp32_check(cfg, specs, toks, dev, replay=False) -> dict:
    """The recurrent families' fp32 checks on weights drawn from ``specs``
    (seed 0) on the card and copied to the host, gated by the caller:
    each block on the card from the host CPU's input to it against the
    CPU's output (teacher-forced), each recurrent block's prefill of
    that input's first S-1 positions from a zero state plus one decode
    step against its forward at the last position (teacher-forced, on the
    card), the unembedding of the CPU's last hidden state, and
    prefill(S-1) + decode_step against forward at the last position on
    the card end to end (gated where the CPU's own spread, one thread
    against all, is under the bar). Reported: the card's forward against
    the CPU's beside that spread, and the greedy tokens of
    LM_GREEDY_STEPS steps on both; with ``replay``, the block furthest
    from the CPU replayed op by op (``op_replay``)."""
    import torch
    from repro_torch.common import map_params, materialize
    from repro_torch.models import model as M
    from repro_torch.serve import decode as D
    v, ss = cfg.vocab_size, toks.shape[1]
    p_card = materialize(specs, seed=0, device=dev)
    p_cpu = map_params(lambda t: t.cpu(), p_card)
    full, _ = M.forward(cfg, p_card, {"tokens": toks.to(dev)})
    _, cache = D.prefill(cfg, p_card, {"tokens": toks[:, :-1].to(dev)},
                         max_len=ss + 4)
    lg, _ = D.decode_step(cfg, p_card, toks[:, -1:].to(dev), cache)
    with rec_blocks_recorded() as blocks:
        hidden_cpu, _ = M.forward(cfg, p_cpu, {"tokens": toks},
                                  return_hidden=True)
    full_cpu = M.unembed_logits(cfg, p_cpu, hidden_cpu)

    def card(a):
        if isinstance(a, dict):
            return {k: card(t) for k, t in a.items()}
        return a.to(dev) if isinstance(a, torch.Tensor) else a

    zero = M.init_cache(cfg, toks.shape[0], 8, device=dev)
    block_errs, decode_errs = [], []
    for name, fn, args, kw, out in blocks:
        bcfg, p, x = args[0], card(args[1]), card(args[2])
        full_card = fn(bcfg, p, x, *[card(a) for a in args[3:]],
                       **card(kw))[0]
        block_errs.append((name, rel_err(full_card, out[0])))
        kind = name[len("apply_"):-len("_block")]
        if kind in M.STATE_KEYS:
            st = {k: t.clone()
                  for k, t in M.layer_state(zero, kind, 0).items()}
            _, st = fn(bcfg, p, x[:, :-1], state=st)
            step, _ = fn(bcfg, p, x[:, -1:], state=st)
            decode_errs.append((name, rel_err(step[:, 0], full_card[:, -1])))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one_thread, _ = M.forward(cfg, p_cpu, {"tokens": toks})
    finally:
        torch.set_num_threads(threads)
    worst_ops = None
    if replay:
        i = max(range(len(block_errs)), key=lambda j: block_errs[j][1])
        name, fn, args, kw, _ = blocks[i]
        worst_ops = {"block_index": i, "block": name,
                     **op_replay(fn, args, kw, dev)}
    greedy_card = lm_greedy(D, cfg, p_card, toks.to(dev), LM_GREEDY_STEPS,
                            ss + LM_GREEDY_STEPS)
    greedy_cpu = lm_greedy(D, cfg, p_cpu, toks, LM_GREEDY_STEPS,
                           ss + LM_GREEDY_STEPS)
    return {
        "max_abs_logit": float(full[..., :v].abs().max()),
        "blocks_card_vs_cpu_teacher_forced": block_errs,
        "blocks_decode_vs_forward_teacher_forced": decode_errs,
        "unembed_card_vs_cpu": lm_max_err(
            M.unembed_logits(cfg, p_card, hidden_cpu.to(dev)), full_cpu, v),
        "decode_vs_forward": lm_max_err(lg[:, 0], full[:, -1], v),
        "card_vs_cpu_forward": lm_max_err(full, full_cpu, v),
        "cpu_one_thread_vs_all": lm_max_err(one_thread, full_cpu, v),
        "cpu_threads": threads,
        "greedy_tokens_differing": int((greedy_card != greedy_cpu).sum()),
        "greedy_tokens": greedy_card.tolist(),
        "worst_block_op_replay": worst_ops}


def rglru_scan_check(cfg, dev) -> dict:
    """``recurrent._rglru_core`` (the doubling scan) on the card against
    an fp32 and a float64 sequential loop on the card, at LM_REC_SCAN's
    batch and steps and the LRU's width, from a carried h0."""
    import torch
    from repro_torch.models import recurrent as R
    b, s = LM_REC_SCAN
    w = cfg.lru_width
    gen = torch.Generator().manual_seed(2)
    x, r, i = (torch.randn((b, s, w), generator=gen) for _ in range(3))
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    lam = torch.rand(w, generator=gen) * 2 - 1
    h0 = torch.randn((b, w), generator=gen)
    x, r, i, lam, h0 = (t.to(dev) for t in (x, r, i, lam, h0))
    y, _ = R._rglru_core(x, r, i, lam, h0)
    loops = {}
    for dt in (torch.float32, torch.float64):
        sp = torch.nn.functional.softplus(lam.to(dt))
        log_a = -R._LRU_C * sp * r.to(dt)
        a = torch.exp(log_a)
        g = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-12)) \
            * (i.to(dt) * x.to(dt))
        h, ys = h0.to(dt), []
        for t in range(s):
            h = a[:, t] * h + g[:, t]
            ys.append(h)
        loops[str(dt)] = torch.stack(ys, 1)
    return {"batch": b, "steps": s, "width": w,
            "max_abs_h": float(y.abs().max()),
            "scan_vs_fp32_loop": rel_err(y, loops["torch.float32"]),
            "scan_vs_float64_loop": rel_err(y, loops["torch.float64"]),
            "fp32_loop_vs_float64_loop": rel_err(loops["torch.float32"],
                                                 loops["torch.float64"])}


def mlstm_forms_check(cfg, dev) -> dict:
    """The mLSTM's chunkwise form against its sequential scan on the card
    on the same q, k, v and gates at the configuration's heads (dh 1024
    at xlstm-1.3b) over LM_REC_FORMS' steps, from a carried state:
    h, C, n and m over their max |value|."""
    import torch
    from repro_torch.models import recurrent as R
    b, s = LM_REC_FORMS
    h, dh = cfg.num_heads, 2 * cfg.d_model // cfg.num_heads
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((b, s, h, dh), generator=gen).to(dev)
               for _ in range(3))
    k = k * dh ** -0.5
    i_pre, f_pre = (2 * torch.randn((b, s, h), generator=gen).to(dev)
                    for _ in range(2))
    C0 = 0.1 * torch.randn((b, h, dh, dh), generator=gen).to(dev)
    n0 = torch.randn((b, h, dh), generator=gen).to(dev)
    m0 = torch.zeros((b, h), device=dev)
    hc, st_c = R._mlstm_chunkwise(q, k, v, i_pre, f_pre, C0.clone(), n0, m0,
                                  R.MLSTM_CHUNK)
    hs, st_s = R._mlstm_sequential(q, k, v, i_pre, f_pre, C0.clone(), n0, m0)
    errs = {"h": rel_err(hc, hs)}
    errs.update({key: rel_err(a, c)
                 for key, a, c in zip(("C", "n", "m"), st_c, st_s)})
    return {"batch": b, "steps": s, "heads": h, "dh": dh,
            "chunkwise_vs_sequential": errs}


def slstm_window_check(cfg, n_scale: int, dev) -> dict:
    """One sLSTM block at full width drawn at std 1/sqrt(n_scale) (seed 0)
    over the longest of LM_SLSTM_WINDOWS steps: the card against the
    host CPU and the CPU against its run on float64 weights and input
    (the block's own fp32 casts kept), each over the first w steps of
    every window w (errors over max |out| there)."""
    import torch
    from repro_torch.common import map_params, materialize
    from repro_torch.models import recurrent as R
    from repro_torch.models.transformer import layer_params
    specs = at_scales({"s": R.slstm_specs(cfg, 1)}, {"s": n_scale})
    p = layer_params(materialize(specs, seed=0, device=dev)["s"], 0)
    p_cpu = map_params(lambda t: t.cpu(), p)
    x = torch.randn((2, max(LM_SLSTM_WINDOWS), cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    y, _ = R.apply_slstm_block(cfg, p, x.to(dev))
    y_cpu, _ = R.apply_slstm_block(cfg, p_cpu, x)
    y64, _ = R.apply_slstm_block(cfg, map_params(lambda t: t.double(), p_cpu),
                                 x.double())
    return {"scale_layers": n_scale, "windows": {
        w: {"card_vs_cpu": rel_err(y[:, :w], y_cpu[:, :w]),
            "cpu_vs_float64": rel_err(y_cpu[:, :w], y64[:, :w])}
        for w in LM_SLSTM_WINDOWS}}


def rec_long(cfg, params, dev, failures) -> dict:
    """LM_LONG's prompts prefilled at its max_len (twice: the first call
    warms up), then LM_REC_WRAP_STEPS decode steps, event-timed. Every
    logit finite; for the hybrid the rolling window (min(max_len,
    attn_window) slots) must hold exactly the last positions, position p
    in slot p % w: past 2,048 tokens the first steps overwrite the
    oldest slots."""
    import torch
    from repro_torch.serve import decode as D
    from repro_torch.timing import cuda_ms
    b, s, max_len = LM_LONG
    toks = torch.randint(0, cfg.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(0)).to(dev)
    prefill_s = []
    for _ in range(2):
        cache = None
        sync()
        t0 = time.perf_counter()
        lg, cache = D.prefill(cfg, params, {"tokens": toks}, max_len=max_len)
        sync()
        prefill_s.append(time.perf_counter() - t0)
    state = {"cache": cache, "finite": torch.isfinite(
        lg[..., :cfg.vocab_size]).all()}
    tok = torch.argmax(lg[:, -1:, :cfg.vocab_size], dim=-1)

    def step():
        lg, state["cache"] = D.decode_step(cfg, params, tok, state["cache"])
        state["finite"] &= torch.isfinite(lg[..., :cfg.vocab_size]).all()

    ms = cuda_ms(step, reps=LM_REC_WRAP_STEPS - 1)      # + one warm-up step
    cache = state["cache"]
    out = {"batch": b, "prompt_tokens": s, "max_len": max_len,
           "prefill_s": prefill_s, "decode_steps": LM_REC_WRAP_STEPS,
           "decode_ms_a_step": ms, "index": cache["index"]}
    if not bool(state["finite"]):
        failures.append(f"{cfg.name}: non-finite logits after the long "
                        f"prefill")
    if cache["index"] != s + LM_REC_WRAP_STEPS:
        failures.append(f"{cfg.name}: index {cache['index']}")
    if "slot_pos" in cache:
        sp = cache["slot_pos"].cpu()
        w, idx = sp.shape[0], cache["index"]
        held = list(range(idx - w, idx))
        rolled = (sorted(sp.tolist()) == held
                  and all(int(sp[p % w]) == p for p in held))
        out.update(window_slots=w, slot_pos_rolled=rolled,
                   slots_overwritten=idx - w)
        if not rolled:
            failures.append(f"{cfg.name}: slot_pos does not hold the last "
                            f"{w} positions")
    return out


def phase_lm_recurrent(ctx):
    """The recurrent families served on the card: recurrentgemma-2b
    (hybrid: RG-LRU blocks and local attention; bf16, 26 layers, every
    width as published) and xlstm-1.3b (ssm: sLSTM and mLSTM; bf16, 48
    layers, every width as published) whole, weights from
    materialize(seed 0). Each serves launch/serve.py's requests through
    ServingEngine twice (the same tokens in both runs, all in range), with
    decode ms a step beside its bound (every weight and the cache read,
    the recurrent states written, over 3.35 TB/s) and a profile; then 4
    prompts of 2,048 tokens prefilled at max_len 4096 (the mLSTM's
    chunkwise form, a 2,048-step sLSTM scan) and 16 decode steps, where
    the hybrid's 2,048-slot window wraps. Then fp32, TF32 off, at full
    width, one superblock deep (recurrentgemma 3 layers, xlstm 8), drawn
    at the full model's layer scale (gated at LM_REL_TOL of max |out| or
    |logit|; materialize's scale for the cut depth reported): each block
    on the card from the CPU's input to it against the CPU's output and
    each recurrent block's prefill + decode step against its forward
    (teacher-forced), decode against forward end to end where the CPU's
    own spread says the model is conditioned, the RG-LRU scan against
    fp32 and float64 sequential loops at S 2048, the mLSTM's chunkwise
    form against its sequential scan at dh 1024, S 128; the sLSTM card
    against CPU over
    its first 16 steps (gated; 64 and 256 reported beside float64: its
    recurrence parts from float64 at this scale within 64 steps).
    Reported: the forward card against CPU beside the CPU's own spread,
    and greedy tokens. Frees what it allocates. No kernel: the reference's
    recurrent blocks call none (its sLSTM is a scan, not slstm_fused)."""
    import dataclasses
    import gc
    import torch
    from repro_torch.common import materialize, param_bytes, param_count
    from repro_torch.configs.base import get_config
    from repro_torch.models import model as M
    dev = ctx["device"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    failures = []
    out = {"phase": "lm_recurrent", "nvidia_smi": ctx["smi"],
           "memory_allocated_before": before}
    t_phase = time.perf_counter()

    with torch.inference_mode():
        for name in LM_REC_ARCHS:
            cfg = get_config(name)
            specs = M.param_specs(cfg)
            t0 = time.perf_counter()
            params = materialize(specs, seed=0, device=dev)
            sync()
            res = {"arch": cfg.name, "family": cfg.family,
                   "dtype": cfg.dtype, "layers": cfg.num_layers,
                   "weights": param_count(specs),
                   "weight_bytes": param_bytes(specs),
                   "materialize_s": time.perf_counter() - t0,
                   "memory_allocated_weights":
                       torch.cuda.memory_allocated(dev)}
            res.update(lm_serve_twice(cfg, params, dev, failures))
            shapes = M.init_cache_shapes(cfg, LM_SLOTS, LM_MAX_LEN)
            state_bytes = sum(m.numel() * m.element_size()
                              for k, m in shapes.items()
                              if k not in ("index", "k", "v", "slot_pos"))
            cache_bytes = res.pop("cache_bytes")
            res["decode_128"].update(
                cache_bytes=cache_bytes, state_bytes_written=state_bytes,
                bound_ms=(res["weight_bytes"] + cache_bytes + state_bytes)
                / H100_BYTES_PER_S * 1e3)
            t0 = time.perf_counter()
            res["long"] = rec_long(cfg, params, dev, failures)
            res["long"]["wall_s"] = time.perf_counter() - t0
            res["peak_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
            out[name] = res
            del params
            gc.collect()
            torch.cuda.empty_cache()

        # -- fp32 at full width, one superblock deep
        gen = torch.Generator().manual_seed(0)
        checks = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
        errs = []
        for name in LM_REC_ARCHS:
            full = get_config(name)
            layers, scales = LM_REC_CHECK[name]
            cfg = dataclasses.replace(full, num_layers=layers,
                                      dtype="float32")
            specs = M.param_specs(cfg)
            toks = torch.randint(0, cfg.vocab_size, LM_CHECK_SHAPE,
                                 generator=gen)
            chk = rec_fp32_check(cfg, at_scales(specs, scales), toks, dev,
                                 replay=True)
            checks[name] = {
                "layers": layers, "weights": param_count(specs),
                "batch": LM_CHECK_SHAPE[0], "tokens": LM_CHECK_SHAPE[1],
                "scale_layers": scales, "full_model_scale": chk,
                f"materialize_depth{layers}_scale": rec_fp32_check(
                    cfg, specs, toks, dev)}
            errs += [e for _, e in chk["blocks_card_vs_cpu_teacher_forced"]]
            errs += [e for _, e in
                     chk["blocks_decode_vs_forward_teacher_forced"]]
            errs.append(chk["unembed_card_vs_cpu"])
            if chk["cpu_one_thread_vs_all"] <= LM_REL_TOL:   # conditioned
                errs.append(chk["decode_vs_forward"])
        rg = dataclasses.replace(get_config("recurrentgemma-2b"),
                                 dtype="float32")
        xl = dataclasses.replace(get_config("xlstm-1.3b"), dtype="float32")
        checks["rglru_scan"] = rglru_scan_check(rg, dev)
        checks["mlstm_forms"] = mlstm_forms_check(xl, dev)
        checks["slstm_windows"] = slstm_window_check(
            xl, LM_REC_CHECK["xlstm-1.3b"][1]["superblocks/slstm"], dev)
        errs.append(checks["rglru_scan"]["scan_vs_fp32_loop"])
        errs += list(checks["mlstm_forms"]["chunkwise_vs_sequential"].values())
        errs.append(checks["slstm_windows"]["windows"][LM_SLSTM_WINDOWS[0]]
                    ["card_vs_cpu"])
        out["fp32_check"] = checks
        if max(errs) > LM_REL_TOL:
            failures.append(f"fp32 checks over {LM_REL_TOL}: {errs}")

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    out["memory_allocated_after"] = after
    out["peak_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    if after > before + LM_FREE_SLACK:
        failures.append(f"memory_allocated {before} before, {after} after")
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


LM_TRAIN_ARGV = ["--arch", "xlstm-1.3b", "--steps", "4", "--batch", "4",
                 "--seq", "256", "--microbatches", "2", "--ckpt-every", "2"]
                                # xlstm-1.3b whole: its AdamW state (fp32
                                # masters and moments, ~16 bytes a weight)
                                # is what one H100 holds; seq 256, a multiple
                                # of 64, takes the mLSTM's chunkwise form (a
                                # step took 27 s at 512, 11.7 s at 256)
LM_TRAIN_RESUME_AT = 2          # the fresh Trainer resumes from this step,
                                # the one checkpoint written (32.2 GB: a
                                # call may write 45 GiB to its disk, deleted
                                # files included)
LM_TRAIN_RESUME_REL = 1e-4      # resumed losses vs the straight run's
LM_TRAIN_CHECK = ("granite-3-8b", 2, 40)   # depth-2 fp32 step card vs CPU,
                                           # drawn at 40 layers' scale
LM_TRAIN_BLOCK_S = (16, 128)    # xlstm superblock vjps (batch 1): both
                                # mLSTM forms
LM_TRAIN_BLOCK_SEEDS = 3        # inputs and cotangents drawn per S; the
                                # errors are pooled over blocks and seeds
LM_TRAIN_INIT = ("at_fan_in: every 'normal' leaf drawn at std "
                 "1/sqrt(shape[-2]), a stand-in for materialize's "
                 "1/sqrt(shape[0]), under which the sLSTM's gradient "
                 "overflows fp32 (ROADMAP §C, open)")


@contextlib.contextmanager
def ckpt_timed(rows, write_step):
    """Wall seconds of every ``checkpoint.manager`` save and restore while
    the block runs (wrapped here, put back after). Only the save of step
    ``write_step`` is written: any other is recorded (its step and extras)
    and not written, since one checkpoint of the model fills most of what
    a call may write to its disk."""
    from repro_torch.checkpoint import manager as ckpt
    saved = {name: getattr(ckpt, name) for name in ("save", "restore")}

    def timed(name):
        fn = saved[name]

        def call(*args, **kw):
            if name == "save" and args[1] != write_step:
                rows.append(("save_not_written", args[1],
                             kw.get("extras")))
                return None
            t0 = time.perf_counter()
            res = fn(*args, **kw)
            rows.append((name, time.perf_counter() - t0))
            return res
        return call

    for name in saved:
        setattr(ckpt, name, timed(name))
    try:
        yield rows
    finally:
        for name, fn in saved.items():
            setattr(ckpt, name, fn)


def at_fan_in(specs):
    """``specs`` with every "normal" leaf drawn at std 1/sqrt(its matrix's
    input width, ``shape[-2]``). ``materialize``'s rule (the reference's)
    takes ``shape[0]``, the layer count of a stacked weight: xlstm-1.3b's
    sLSTM recurrent matrix (512 wide) then draws at std 1/sqrt(6), and
    backward through the recurrence overflows fp32 in both packages (the
    gradient norm is inf from seq 64 and NaN at 256 on the card;
    ``LM_TRAIN_INIT``, ROADMAP §C)."""
    import dataclasses
    from repro_torch.common import map_params
    return map_params(lambda sp: dataclasses.replace(
        sp, init=("scaled", sp.shape[-2])) if sp.init == "normal" else sp,
        specs)


def lm_train_run(trainer) -> dict:
    """``trainer.run()`` with every step synchronised and timed (its
    metrics read on the host), and its checkpoints' save and restore
    seconds (``ckpt_timed``: only step LM_TRAIN_RESUME_AT's is written).
    Returns the run's params and optimizer state too."""
    import torch
    rows, io = [], []
    fn = trainer.step_fn

    def step(*args):
        sync()
        t0 = time.perf_counter()
        res = fn(*args)
        sync()
        rows.append({"step_s": time.perf_counter() - t0,
                     **{k: float(v) for k, v in res[2].items()}})
        return res

    trainer.step_fn = step
    torch.cuda.reset_peak_memory_stats(trainer.device)
    t0 = time.perf_counter()
    with ckpt_timed(io, LM_TRAIN_RESUME_AT):
        params, opt, hist = trainer.run()
    return {"params": params, "opt": opt, "history": hist, "steps": rows,
            "checkpoint_io_s": io, "wall_s": time.perf_counter() - t0,
            "peak_memory_allocated":
                torch.cuda.max_memory_allocated(trainer.device)}


def train_step_check(cfg, params, toks, dev) -> dict:
    """One fp32 train step's parts (``train.steps._value_and_grad``, then
    ``adamw.apply_updates`` from a fresh state: the step at one
    microbatch) on the card against the host CPU on the same weights and
    tokens, and the CPU on float64 weights and inputs (its fp32 casts kept)
    as the spread: loss within 1e-4 of max(1, |loss|) or twice the spread,
    grad_norm relative, each gradient and mu leaf within 1e-4 of its max
    |g| or four times the spread (tests/test_torch_lm_train_step.py's
    bars). Returns the worst ratio of error to bar (gate: <= 1)."""
    import dataclasses
    import torch
    from repro_torch.common import map_params, tree_leaves
    from repro_torch.configs.base import ModelConfig
    from repro_torch.optim import adamw
    from repro_torch.train import steps as TS

    @dataclasses.dataclass(frozen=True)
    class Float64(ModelConfig):
        @property
        def torch_dtype(self):
            return torch.float64

    tc = TS.TrainConfig()
    labels = torch.roll(toks, -1, 1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}

    def run(device, dtype=None):
        c = Float64(**dataclasses.asdict(cfg)) if dtype else cfg
        p = map_params(lambda t: t.to(device, dtype or t.dtype), params)
        b = {k: v.to(device) for k, v in batch.items()}
        (lv, _), g = TS._value_and_grad(c, tc, p, b)
        _, o2, m = adamw.apply_updates(tc.optimizer, p, g,
                                       adamw.init_state(tc.optimizer, p))
        return {"loss": float(lv), "grad_norm": float(m["grad_norm"]),
                "grad": {k: t.float().cpu() for k, t in tree_leaves(g)},
                "mu": {k: t.float().cpu() for k, t in tree_leaves(o2.mu)}}

    cpu = run("cpu")
    f64 = run("cpu", torch.float64)     # kept only as per-leaf spreads
    spread = {part: {k: float((t - f64[part][k]).abs().max())
                     for k, t in cpu[part].items()} for part in ("grad", "mu")}
    scalars64 = {k: f64[k] for k in ("loss", "grad_norm")}
    del f64
    card = run(dev)
    ratios = {"loss": abs(card["loss"] - cpu["loss"]) / max(
        1e-4 * max(1.0, abs(cpu["loss"])),
        2 * abs(cpu["loss"] - scalars64["loss"])),
        "grad_norm": abs(card["grad_norm"] - cpu["grad_norm"]) / max(
            1e-4 * cpu["grad_norm"],
            4 * abs(cpu["grad_norm"] - scalars64["grad_norm"]))}
    for part in ("grad", "mu"):
        for k, want in cpu[part].items():
            bar = max(1e-4 * float(want.abs().max()), 4 * spread[part][k],
                      1e-30)
            ratios[f"{part}/{k}"] = float(
                (card[part][k] - want).abs().max()) / bar
    worst = max(ratios, key=ratios.get)
    return {"loss": [card["loss"], cpu["loss"], scalars64["loss"]],
            "grad_norm": [card["grad_norm"], cpu["grad_norm"],
                          scalars64["grad_norm"]],
            "worst": worst, "worst_error_over_bar": ratios[worst],
            "loss_error_over_bar": ratios["loss"],
            "grad_norm_error_over_bar": ratios["grad_norm"]}


def xlstm_block_vjps(cfg, params, s: int, seed: int, dev,
                     slstm: bool) -> dict:
    """One xlstm superblock (its sLSTM, then its mLSTMs) at full width,
    teacher-forced: the host CPU runs the blocks in order from a random
    input and back from a random cotangent (drawn from ``seed``); each
    block's vjp (params and input) is then taken on the card from the CPU's
    input to it and the CPU's cotangent at its output, against the CPU's
    own vjp of the same and the CPU's on float64 weights and inputs (the
    blocks' fp32 casts kept). Batch 1. Errors over each leaf's max |g|,
    the worst leaf of each block (named for the card's). The sLSTM's own
    vjps only with ``slstm``."""
    import torch
    from repro_torch.models import recurrent as R
    from repro_torch.models.transformer import layer_params
    gen = torch.Generator().manual_seed(1000 * seed + s)
    sb = params["superblocks"]
    n_m = cfg.slstm_every - 1
    blocks = [(R.apply_slstm_block, layer_params(sb["slstm"], 0))] + [
        (R.apply_mlstm_block, layer_params(sb["mlstm"], i))
        for i in range(n_m)]
    xs = [torch.randn((1, s, cfg.d_model), generator=gen)]
    for fn, p in blocks:
        xs.append(fn(cfg, p, xs[-1])[0].detach())
    cts = [torch.randn(xs[-1].shape, generator=gen)]   # at each output
    for (fn, p), x in zip(reversed(blocks[1:]), reversed(xs[1:-1])):
        xr = x.clone().requires_grad_(True)
        cts.insert(0, torch.autograd.grad(fn(cfg, p, xr)[0], xr, cts[0])[0])

    def vjp(fn, p, x, ct, device, dtype=torch.float32):
        leaves = {k: t.to(device, dtype).requires_grad_(True)
                  for k, t in p.items()}
        xr = x.to(device, dtype).requires_grad_(True)
        g = torch.autograd.grad(fn(cfg, leaves, xr)[0],
                                list(leaves.values()) + [xr],
                                ct.to(device, dtype))
        return dict(zip(list(leaves) + ["x"], (t.double().cpu() for t in g)))

    def errs(got, want):
        return {k: float((got[k] - w).abs().max() / w.abs().max().clamp_min(
            1e-30)) for k, w in want.items()}

    rows = []
    for i, (fn, p) in enumerate(blocks):
        if i == 0 and not slstm:
            continue
        x, ct = xs[i], cts[i]
        cpu, card = vjp(fn, p, x, ct, "cpu"), vjp(fn, p, x, ct, dev)
        f64 = vjp(fn, p, x, ct, "cpu", torch.float64)
        card64 = errs(card, f64)
        leaf = max(card64, key=card64.get)
        rows.append({"block": fn.__name__,
                     "card_vs_cpu": max(errs(card, cpu).values()),
                     "card_vs_float64": card64[leaf],
                     "cpu_vs_float64": max(errs(cpu, f64).values()),
                     "card_worst_leaf": leaf})
    return {"steps": s, "seed": seed, "blocks": rows}


def phase_lm_training(ctx):
    """LM training on the card: xlstm-1.3b whole (48 layers, d 2048, 2.01B
    weights; bf16 with fp32 masters, remat "full"; weights at std
    1/sqrt(fan-in), ``at_fan_in``, LM_TRAIN_INIT), driven through
    launch/train.py's ``Trainer`` (LM_TRAIN_ARGV: batch 4, seq 256, two
    microbatches, 4 steps, a checkpoint every 2), every step synchronised
    and timed; then a fresh Trainer resumes from the step-2 checkpoint to
    step 4. The step-2 checkpoint is the one written (under TMPDIR); the
    Trainers' saves at step 4 are recorded, not written (``ckpt_timed``).
    Gates: every loss and grad_norm finite, grad_norm > 0, the params
    moved, the saves asked for at steps 2 and 4 and then 4, the resumed
    steps' losses within LM_TRAIN_RESUME_REL of the straight run's
    (bitwise equality of losses and final params reported). Reported:
    seconds a step (median after the first), tokens/s, peak memory, the
    bytes of params and optimizer state, checkpoint save and restore
    seconds. Then fp32 (TF32 off): granite-3-8b at depth 2, full width,
    drawn at 40 layers' scale, one step's loss, grad_norm, gradients and
    mu card against CPU (gated at the CPU tests' bars), and an xlstm
    superblock's blocks teacher-forced in both mLSTM forms from
    LM_TRAIN_BLOCK_SEEDS inputs each, each block's vjp on the card and the
    CPU against the CPU's float64 run. A block's error (over each leaf's
    max |g|) moves 10x and more between seeds on either device, and the
    card is the further from float64 in about half the (block, seed)
    pairs, so the errors of a kind and S are pooled over blocks and seeds:
    the card's median within twice the CPU's, its worst within four times
    the CPU's worst (or LM_REL_TOL); the sLSTM only at S 16 (at S 128
    backward through its recurrence parts fp32 from float64 by O(1) on
    the CPU too, so it is not run there).
    Frees what it allocates. No kernel: the LM training path calls
    none."""
    import dataclasses
    import gc
    import shutil
    import tempfile
    import torch
    from repro_torch.common import (map_params, materialize, param_count,
                                    tree_bytes, tree_leaves)
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import model as M
    dev = ctx["device"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    failures = []
    out = {"phase": "lm_training", "nvidia_smi": ctx["smi"],
           "memory_allocated_before": before, "argv": LM_TRAIN_ARGV}
    t_phase = time.perf_counter()
    ckpt_dir = tempfile.mkdtemp(prefix="lm_training_")
    argv = LM_TRAIN_ARGV + ["--ckpt-dir", ckpt_dir]
    try:
        out["disk_free_bytes"] = shutil.disk_usage(ckpt_dir).free
        trainer = launch_train.build(argv)
        trainer.specs = at_fan_in(trainer.specs)
        cfg, rc = trainer.cfg, trainer.rc
        first = lm_train_run(trainer)
        params, opt = first.pop("params"), first.pop("opt")
        state_bytes = tree_bytes(params) + sum(
            tree_bytes(t) for t in (opt.mu, opt.nu, opt.master))
        final = {k: t.cpu() for k, t in tree_leaves(params)}
        del params, opt
        gc.collect()
        torch.cuda.empty_cache()
        init = materialize(trainer.specs, rc.seed, device=dev)
        unchanged = [k for k, t in tree_leaves(init)
                     if torch.equal(t.cpu(), final[k])]
        moved = sum(float((t.float() - final[k].to(dev).float()).abs().sum())
                    for k, t in tree_leaves(init))
        del init
        gc.collect()
        torch.cuda.empty_cache()
        fresh = launch_train.build(argv)
        fresh.specs = trainer.specs
        resumed = lm_train_run(fresh)
        p2 = resumed.pop("params")
        resumed.pop("opt")
        same_params = all(torch.equal(t.cpu(), final[k])
                          for k, t in tree_leaves(p2))
        del p2
        gc.collect()
        torch.cuda.empty_cache()
        rows = first["steps"]
        tail = rows[LM_TRAIN_RESUME_AT:]
        times = sorted(r["step_s"] for r in rows[1:])
        median = times[len(times) // 2] if len(times) % 2 else \
            0.5 * (times[len(times) // 2 - 1] + times[len(times) // 2])
        tokens = rc.batch * rc.seq
        resume_errs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(resumed["steps"], tail)]
        out["xlstm"] = {
            "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "remat": cfg.remat, "init": LM_TRAIN_INIT,
            "weights": param_count(trainer.specs),
            "batch": rc.batch, "seq": rc.seq,
            "microbatches": trainer.tc.microbatches,
            "params_and_optimizer_bytes": state_bytes,
            "steps": rows, "step_s_median_after_first": median,
            "tokens_per_s": tokens / median,
            "peak_memory_allocated": first["peak_memory_allocated"],
            "checkpoint_io_s": first["checkpoint_io_s"],
            "wall_s": first["wall_s"],
            "leaves_unchanged": unchanged, "sum_abs_moved": moved,
            "resumed": {"from_step": LM_TRAIN_RESUME_AT,
                        "steps": resumed["steps"],
                        "checkpoint_io_s": resumed["checkpoint_io_s"],
                        "wall_s": resumed["wall_s"],
                        "peak_memory_allocated":
                            resumed["peak_memory_allocated"],
                        "loss_rel_err": resume_errs,
                        "losses_bitwise": [a["loss"] == b["loss"] for a, b
                                           in zip(resumed["steps"], tail)],
                        "final_params_bitwise": same_params}}
        values = [r[k] for r in rows + resumed["steps"]
                  for k in ("loss", "grad_norm")]
        if not all(math.isfinite(v) for v in values):
            failures.append(f"non-finite loss or grad_norm: {values}")
        if not all(r["grad_norm"] > 0 for r in rows):
            failures.append("grad_norm 0")
        if not moved > 0:
            failures.append("params did not move")
        if len(resumed["steps"]) != len(tail) or \
                max(resume_errs) > LM_TRAIN_RESUME_REL:
            failures.append(f"resumed losses part: {resume_errs}")
        asked = [[r[1] for r in run["checkpoint_io_s"]
                  if r[0] == "save_not_written"] for run in (first, resumed)]
        written = [[r[0] for r in run["checkpoint_io_s"]]
                   for run in (first, resumed)]
        if asked != [[rc.steps], [rc.steps]] or \
                written != [["save", "save_not_written"],
                            ["restore", "save_not_written"]]:
            failures.append(f"checkpoints: {written}, not written {asked}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    # -- fp32 at full width, card against CPU
    checks = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32}
    name, depth, scale = LM_TRAIN_CHECK
    cfg = dataclasses.replace(get_config(name), num_layers=depth,
                              dtype="float32")
    specs = at_layer_scale(M.param_specs(cfg), ("blocks",), scale)
    params = map_params(lambda t: t.cpu(), materialize(specs, seed=0,
                                                       device=dev))
    toks = torch.randint(0, cfg.vocab_size, LM_CHECK_SHAPE,
                         generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    chk = train_step_check(cfg, params, toks, dev)
    chk["check_s"] = time.perf_counter() - t0
    checks[name] = {"layers": depth, "scale_layers": scale,
                    "batch": LM_CHECK_SHAPE[0], "tokens": LM_CHECK_SHAPE[1],
                    **chk}
    if chk["worst_error_over_bar"] > 1:
        failures.append(f"{name} fp32 step: {chk['worst']} at "
                        f"{chk['worst_error_over_bar']} of its bar")
    del params
    t0 = time.perf_counter()
    xl = dataclasses.replace(get_config("xlstm-1.3b"), num_layers=8,
                             dtype="float32")
    specs = at_scales(M.param_specs(xl), LM_REC_CHECK["xlstm-1.3b"][1])
    params = map_params(lambda t: t.cpu(), materialize(specs, seed=0,
                                                       device=dev))
    runs = [xlstm_block_vjps(xl, params, s, seed, dev,
                             slstm=s == min(LM_TRAIN_BLOCK_S))
            for s in LM_TRAIN_BLOCK_S for seed in range(LM_TRAIN_BLOCK_SEEDS)]
    pooled = []
    for s in LM_TRAIN_BLOCK_S:
        for kind in {r["block"]: 0 for c in runs if c["steps"] == s
                     for r in c["blocks"]}:
            rows = [r for c in runs if c["steps"] == s
                    for r in c["blocks"] if r["block"] == kind]
            card = sorted(r["card_vs_float64"] for r in rows)
            cpu = sorted(r["cpu_vs_float64"] for r in rows)
            pooled.append({
                "steps": s, "block": kind, "samples": len(rows),
                "card_worse_in": sum(r["card_vs_float64"]
                                     > r["cpu_vs_float64"] for r in rows),
                "card_median": statistics.median(card),
                "cpu_median": statistics.median(cpu),
                "card_worst": card[-1], "cpu_worst": cpu[-1]})
    checks["xlstm-1.3b"] = {"runs": runs, "pooled": pooled}
    over = [g for g in pooled if (
        g["card_median"] > 2 * g["cpu_median"]
        or g["card_worst"] > max(LM_REL_TOL, 4 * g["cpu_worst"]))]
    if over:
        failures.append(f"xlstm block vjps card vs CPU over their bars: "
                        f"{over}")
    del params
    checks["xlstm_vjps_s"] = time.perf_counter() - t0
    out["fp32_check"] = checks

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    out["memory_allocated_after"] = after
    out["peak_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    if after > before + LM_FREE_SLACK:
        failures.append(f"memory_allocated {before} before, {after} after")
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


MESH_ARCH = ("granite-moe-3b-a800m", 4)   # every published width, 4 of 32
MESH_TRAIN = dict(steps=2, batch=4, seq=256)   # layers: 0.555B weights
MESH_LOSS_TOL = 2e-4            # mesh vs unsharded step, the reference's bar
MESH_SERVE = (4, 16, 8)         # requests, prompt tokens, new tokens


def phase_mesh(ctx):
    """The mesh on the card (see the module docstring, phase 15)."""
    import dataclasses
    import gc
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    import numpy as np
    from repro_torch.common import materialize, param_count, tree_leaves
    from repro_torch.configs.all import ASSIGNED
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.configs.cronet import get_cronet_config
    from repro_torch.core import placement
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.parallel import shard_map as SM
    from repro_torch.parallel import sharding as SH
    from repro_torch.serve.server import Request, ServingEngine
    from repro_torch.train.steps import TrainConfig
    from repro_torch.train.trainer import RunConfig, Trainer
    dev = ctx["device"]
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t_phase = time.perf_counter()
    failures = []
    out = {"phase": "mesh", "nvidia_smi": ctx["smi"]}
    store = os.path.join(tempfile.mkdtemp(prefix="mesh_"), "store")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(store, 1))
    try:
        mesh = make_debug_mesh((1, 1), device="cuda")
        out["mesh"] = {"shape": [1, 1], "axes": list(mesh.mesh_dim_names),
                       "backend": dist.get_backend()}
        name, layers = MESH_ARCH
        cfg = dataclasses.replace(get_config(name), num_layers=layers)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        out["config"] = {"arch": name, "num_layers": layers,
                         "of_layers": get_config(name).num_layers,
                         "params": param_count(M.param_specs(cfg))}

        # training: one fp32 step on the mesh, one without
        tc = TrainConfig(optimizer=adamw.AdamWConfig(
            lr=1e-4, warmup_steps=1, total_steps=10))
        rc = RunConfig(log_every=1, **MESH_TRAIN)

        def timed_run(trainer):
            """(params, history, s a step): each step's metrics read on
            the host (a sync) as it ends."""
            marks = [time.perf_counter()]
            params, _, hist = trainer.run(
                progress=lambda s, row: marks.append(time.perf_counter()))
            return params, hist, [b - a for a, b in zip(marks, marks[1:])]

        calls0 = dict(SM.CALLS)
        p_mesh, h_mesh, s_mesh = timed_run(Trainer(cfg32, tc, rc, mesh=mesh))
        train_calls = {k: SM.CALLS[k] - calls0[k] for k in calls0}
        p_mesh = {k: SH.full(t).detach() for k, t in tree_leaves(p_mesh)}
        gc.collect()
        p_one, h_one, s_one = timed_run(Trainer(cfg32, tc, rc, device=dev))
        diffs = {k: float((p_mesh[k].float() - t.float()).abs().max())
                 for k, t in tree_leaves(p_one)}
        bitwise = all(torch.equal(p_mesh[k], t) for k, t in tree_leaves(p_one))
        loss_diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(h_mesh, h_one))
        worst = max(diffs, key=diffs.get)
        out["train"] = {
            **MESH_TRAIN, "dtype": "float32",
            "losses_mesh": [h["loss"] for h in h_mesh],
            "losses_unsharded": [h["loss"] for h in h_one],
            "loss_diff": loss_diff, "loss_tol": MESH_LOSS_TOL,
            "grad_norms_mesh": [h["grad_norm"] for h in h_mesh],
            "grad_norms_unsharded": [h["grad_norm"] for h in h_one],
            "max_param_diff": diffs[worst], "max_param_diff_leaf": worst,
            "bitwise_equal": bitwise, "collectives": train_calls,
            "s_a_step_mesh": s_mesh, "s_a_step_unsharded": s_one}
        del p_mesh, p_one
        gc.collect()
        torch.cuda.empty_cache()
        if not (np.isfinite(h_mesh[-1]["loss"]) and loss_diff <= MESH_LOSS_TOL):
            failures.append(f"mesh step losses {out['train']['losses_mesh']}"
                            f" vs {out['train']['losses_unsharded']} over "
                            f"{MESH_LOSS_TOL}")
        if train_calls["all_to_all"] == 0:
            failures.append("the training step reached no all_to_all")

        # serving: bf16, the EP decode body on the mesh
        n_req, plen, new = MESH_SERVE
        params = materialize(M.param_specs(cfg), 0, device=dev)
        gen = np.random.default_rng(0)
        prompts = [gen.integers(0, cfg.vocab_size, plen).astype(np.int32)
                   for _ in range(n_req)]
        def serve(engine):
            """(requests done, s): the group's wall, synchronised."""
            t0 = time.perf_counter()
            done = engine.run([Request(i, p, max_new=new)
                               for i, p in enumerate(prompts)])
            sync()
            return done, time.perf_counter() - t0

        calls0 = dict(SM.CALLS)
        engine = ServingEngine(cfg, params, slots=n_req, max_len=64,
                               mesh=mesh)
        on_mesh, cold_s = serve(engine)
        serve_calls = {k: SM.CALLS[k] - calls0[k] for k in calls0}
        again, warm_s = serve(engine)
        alone, one_s = serve(ServingEngine(cfg, params, slots=n_req,
                                           max_len=64, device=dev))
        same = all(np.array_equal(a.output, b.output) and
                   np.array_equal(a.output, c.output)
                   for a, b, c in zip(on_mesh, again, alone))
        out["serve"] = {"dtype": "bfloat16", "requests": n_req,
                        "prompt_tokens": plen, "new_tokens": new,
                        "tokens_equal": same, "collectives": serve_calls,
                        "tokens_mesh": [r.output.tolist() for r in on_mesh],
                        "mesh_first_s": cold_s, "mesh_again_s": warm_s,
                        "unsharded_s": one_s}
        del engine
        del params
        if not same:
            failures.append("mesh serving tokens differ from unsharded")
        if serve_calls["all_gather"] == 0:
            failures.append("serving reached no EP decode all_gather")
    finally:
        dist.destroy_process_group()

    # paper Table VI, the port's placement module
    ccfg = get_cronet_config("medium")
    nodes, edges = placement.cronet_graph(ccfg)
    grid = (8, 38)
    out["table6"] = {
        "congestion_bytes_x_hops": {
            "rowmajor": placement.congestion_cost(
                placement.place_rowmajor(nodes, grid), edges),
            "random": placement.congestion_cost(
                placement.place_random(nodes, grid), edges),
            "congestion_aware": placement.congestion_cost(
                placement.place_congestion_aware(nodes, edges, grid), edges)},
        "rules_train_4k_16x16": {}}
    for arch in ASSIGNED:
        chosen, _, rep, reps = placement.choose_rules(
            get_config(arch), SHAPES["train_4k"], {"data": 16, "model": 16})
        out["table6"]["rules_train_4k_16x16"][arch] = {
            "chosen": chosen, "cost": rep.cost,
            "costs": {k: v.cost for k, v in reps.items()}}

    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    out["memory_allocated_before"] = before
    out["memory_allocated_after"] = after
    out["peak_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
    out["phase_s"] = time.perf_counter() - t_phase
    if after > before + LM_FREE_SLACK:
        failures.append(f"memory_allocated {before} before, {after} after")
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


def phase_contracts(ctx):
    import torch
    from repro_torch.common import init_params
    from repro_torch.fea import fea2d, hybrid
    dev, cfg = ctx["device"], ctx["cfg"]
    params = hybrid.cast_params(init_params(cfg, seed=0, device=dev), "fp32")
    step = hybrid.make_hybrid_step(cfg, U_SCALE, 1e9, 3, 1.5, "fp32")
    probs = problems(fea2d, cfg, 4, seed=2)
    b4 = fea2d.stack_problems(probs, device=dev)
    b2 = fea2d.stack_problems(probs[:2], device=dev)
    lv4, lv2 = fea2d.load_volume_b(b4), fea2d.load_volume_b(b2)
    s4 = hybrid.init_state(cfg, b4)
    for _ in range(cfg.hist_len):
        s4 = step(params, b4, lv4, s4)
    s2 = hybrid.HybridState(*[t[:2].clone() for t in s4])

    def same(a, b, la, lb):
        return all(torch.equal(x[la], y[lb]) for x, y in zip(a, b))

    width_ok = True
    for _ in range(3):      # a surrogate tick, then a forced-FEA tick
        s4 = step(params, b4, lv4, s4)
        s2 = step(params, b2, lv2, s2)
        width_ok = width_ok and same(s4, s2, slice(0, 2), slice(0, 2))
    ref = step(params, b4, lv4, hybrid.HybridState(*[t.clone() for t in s4]))
    parked = hybrid.park_slot(s4, 1)
    hybrid.reset_slot(cfg, s4, 1, 0.5)
    hybrid.restore_slot(s4, 1, parked)
    park_ok = same(step(params, b4, lv4, s4), ref, slice(None), slice(None))
    emit({"phase": "contracts", "width4_vs_width2_bitwise": width_ok,
          "park_restore_bitwise": park_ok,
          "n_cronet": s4.n_cronet.cpu().tolist(),
          "n_fea": s4.n_fea.cpu().tolist()})
    if not (width_ok and park_ok):
        raise AssertionError("a bitwise contract failed on the card")


DRYRUN_ARCH = ("granite-moe-3b-a800m", 4)  # every published width, 4 of 32
DRYRUN_BATCH = (4, 256)                      # one fp32 train step
DRYRUN_PEAK_TOL = 0.10
DRYRUN_CELL = ("granite-moe-3b-a800m", "decode_32k")
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def phase_dryrun(ctx):
    """The dry-run's analyzer held against the card, then one cell of the
    dry-run in a process of its own (see the module docstring)."""
    import dataclasses
    import gc
    import os
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from repro_torch.common import map_params, materialize
    from repro_torch.configs.base import get_config
    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train.steps import TrainConfig, make_train_step
    dev = ctx["device"]
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    failures = []
    name, layers = DRYRUN_ARCH
    b, s = DRYRUN_BATCH
    cfg = dataclasses.replace(get_config(name), num_layers=layers,
                              dtype="float32")
    specs = M.param_specs(cfg)
    tc = TrainConfig()
    step = make_train_step(cfg, tc)
    gen = torch.Generator(device=dev).manual_seed(0)

    def tokens():
        return torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                             device=dev, dtype=torch.int32)

    # the prediction: the same step on meta tensors, nothing allocated
    meta = map_params(lambda sp: torch.empty(sp.shape, dtype=sp.dtype,
                                             device="meta"), specs)
    mopt = adamw.init_state(tc.optimizer, meta)
    mbatch = {k: torch.empty((b, s), dtype=torch.int32, device="meta")
              for k in ("tokens", "labels")}
    held = [t for t in torch.utils._pytree.tree_leaves((meta, mopt, mbatch))
            if isinstance(t, torch.Tensor)]
    tracker = MemTracker()
    tracker.track_external(*held)
    t0 = time.perf_counter()
    with tracker, OpAnalysis() as mode:
        mode.track(*held)
        step(meta, mopt, mbatch)
    trace_s = time.perf_counter() - t0
    costs = mode.result()
    predicted = costs.peak_bytes
    tracker_peak = sum(d.get("Total", 0) for d in
                       tracker.get_tracker_snapshot("peak").values())

    # the card: the same step, real
    base = torch.cuda.memory_allocated(dev)
    params = materialize(specs, 0, device=dev)
    opt = adamw.init_state(tc.optimizer, params)
    batch = {"tokens": tokens(), "labels": tokens()}
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    out = step(params, opt, batch)
    sync()
    real_peak = torch.cuda.max_memory_allocated(dev) - base
    loss = float(out[2]["loss"])
    del out
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts, record_shapes=True,
                                with_flops=True) as prof:
        t0 = time.perf_counter()
        out = step(params, opt, batch)
        sync()
        wall_s = time.perf_counter() - t0
    del out
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(e.time_range.elapsed_us() for e in kernels) / 1e6
    prof_flops = sum(e.flops for e in prof.key_averages()
                     if e.key in MATMUL_OPS)
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    bound_s = costs.hbm_bytes / H100_BYTES_PER_S
    peak_err = abs(predicted - real_peak) / real_peak
    out = {"phase": "dryrun", "nvidia_smi": ctx["smi"],
           "config": {"arch": name, "num_layers": layers,
                      "of_layers": get_config(name).num_layers,
                      "dtype": "float32", "batch": b, "seq": s},
           "loss": loss, "trace_s": trace_s,
           "peak_bytes_predicted": predicted, "peak_bytes_card": real_peak,
           "peak_bytes_mem_tracker": tracker_peak,
           "peak_rel_err": peak_err, "peak_tol": DRYRUN_PEAK_TOL,
           "matmul_flops_predicted": costs.flops,
           "matmul_flops_profiler": prof_flops,
           "bytes_predicted": costs.hbm_bytes,
           "memory_bound_s": bound_s, "device_s": device_s,
           "wall_s": wall_s, "ops_predicted": costs.ops,
           "launches_predicted": costs.launches,
           "device_kernels": len(kernels)}
    if not math.isfinite(loss):
        failures.append(f"the step's loss is {loss}")
    if peak_err > DRYRUN_PEAK_TOL:
        failures.append(f"predicted peak {predicted} vs the card's "
                        f"{real_peak}: {peak_err:.3f} apart")
    if costs.flops != prof_flops:
        failures.append(f"matmul flops {costs.flops} vs the profiler's "
                        f"{prof_flops}")
    if bound_s > device_s:
        failures.append(f"the bytes' bound {bound_s} s exceeds the device "
                        f"time {device_s} s")

    # (b) one cell of the dry-run, in a process of its own (its fake
    # process group of 256 ranks)
    arch, shape = DRYRUN_CELL
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape], env=env, capture_output=True, text=True,
        timeout=300, cwd=str(ROOT))
    cell_s = time.perf_counter() - t0
    if proc.returncode != 0:
        failures.append(f"dryrun {arch} {shape} exited {proc.returncode}: "
                        f"{proc.stderr[-1500:]}")
    else:
        cell = json.loads(proc.stdout[proc.stdout.index("{"):])
        out["cell"] = {"wall_s": cell_s, **{k: cell[k] for k in (
            "arch", "shape", "mesh", "chips", "device", "trace_s",
            "memory_analysis", "flops_per_device", "bytes_per_device",
            "wire_bytes_per_device", "useful_flops_ratio", "roofline",
            "cache_bytes_per_device")}}
        out["cell"]["collective_counts"] = cell["collectives"]["counts"]
        if cell["roofline"]["dominant"] not in ("compute", "memory",
                                                "collective"):
            failures.append("the dry-run cell has no dominant term")
    out["phase_s"] = time.perf_counter() - t_phase
    emit(out)
    if failures:
        raise AssertionError("; ".join(failures))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU; nothing to drive", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: the port is not beside this script "
              f"({SRC / 'repro_torch'} missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs.cronet import get_cronet_config
    ctx = {"device": torch.device("cuda"), "cfg": get_cronet_config("medium")}
    t0 = time.perf_counter()
    for phase in (phase_build, phase_kernels, phase_fusion, phase_breakdown,
                  phase_lm_kernels, phase_serving, phase_gateway,
                  phase_workers, phase_flywheel, phase_lm_serving,
                  phase_lm_moe, phase_lm_recurrent, phase_lm_training,
                  phase_contracts, phase_mesh, phase_dryrun):
        try:
            phase(ctx)
        except Exception:
            traceback.print_exc()
            print(f"chip_smoke: {phase.__name__} failed", file=sys.stderr)
            return 1
    print(ctx["smi"], flush=True)
    emit({"total_s": time.perf_counter() - t0})
    emit({"kernels": list(ctx["rows"].values())})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
