"""The whole tick's share of the H100's fp32 peak in the profiled span:
the operations the tick's algorithm needs for the lanes holding a request
(CRONet's forward on the warm ones, the CG iterations run, compliance,
filter and the 60-step OC on all) over span seconds x 67 TFLOP/s."""
from bench import yardstick as Y

LAYER = "hybrid tick (fea/hybrid.py make_hybrid_step)"
UNIT = "%"
MOVES = "designs_per_s"


def read(r):
    if r["span_ticks"] <= 0 or r["window_s"] <= 0:
        return None
    cfg = r["cfg"]
    lane_ticks = r["span_ticks"] * r["mean_occupied"]
    warm_ticks = r["span_ticks"] * r["mean_warm"]
    flops = (lane_ticks * Y.tick_stage_flops(cfg.nelx, cfg.nely)
             + warm_ticks * Y.cronet_flops(cfg.nelx, cfg.nely, 1)
             + r["span_cg_iters"] * Y.cg_iter_flops(cfg.nelx, cfg.nely))
    return 100.0 * flops / (r["window_s"] * Y.PEAK_FP32_FLOPS)
