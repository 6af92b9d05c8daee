"""``cronet_fused``'s share of its roofline in the profiled span: the sum
of each call's bound (Table I's operations for every lane of the call, or
its bytes, at the H100's peaks) over the device time of its two kernels
(``conv_kernel`` and ``head_kernel`` of csrc/cronet_fused.cu)."""
from bench import yardstick as Y

LAYER = "kernel cronet_fused (kernels/cronet_pipeline.py)"
UNIT = "%"
MOVES = "designs_per_s"


def read(r):
    ev = r["device_events"]
    conv = [(a, b) for n, a, b in ev if "conv_kernel" in n
            and "simt" not in n and "conv_tc" not in n]
    head = [(a, b) for n, a, b in ev if "head_kernel" in n]
    if not conv or not head:
        return None
    time_s = sum(b - a for a, b in conv + head)
    cfg, lanes = r["cfg"], r["slots"]
    bound = len(conv) * Y.roofline_bound_s(
        Y.cronet_flops(cfg.nelx, cfg.nely, lanes),
        Y.cronet_bytes(cfg.nelx, cfg.nely, lanes))
    return 100.0 * bound / time_s
