"""``solve_b_fused``'s share of its roofline in the profiled span: the
bound of the CG iterations these inputs needed (the lanes' ``cg_iters``
counters read at both ends of the span, plus the final counts of requests
harvested inside it) and of each call's bytes, at the H100's peaks, over
the device time of ``cg_solve_kernel``."""
from bench import yardstick as Y

LAYER = "kernel solve_b_fused (kernels/cg_fused.py)"
UNIT = "%"
MOVES = "designs_per_s"


def read(r):
    cg = [(a, b) for n, a, b in r["device_events"] if "cg_solve_kernel" in n]
    if not cg or r["span_cg_iters"] <= 0:
        return None
    cfg, lanes = r["cfg"], r["slots"]
    flops = r["span_cg_iters"] * Y.cg_iter_flops(cfg.nelx, cfg.nely)
    nbytes = len(cg) * Y.cg_solve_bytes(cfg.nelx, cfg.nely, lanes)
    return 100.0 * Y.roofline_bound_s(flops, nbytes) / sum(b - a
                                                         for a, b in cg)
