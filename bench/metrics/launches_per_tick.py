"""Device kernels a tick in the profiled span (copies and fills left out),
from torch.profiler's records over the engine ticks in the span."""
LAYER = "tick stages (fea/fea2d.py, fea/simp.py)"
UNIT = "launches/tick"
MOVES = "designs_per_s"


def read(r):
    if r["span_ticks"] <= 0:
        return None
    kernels = [n for n, _, _ in r["device_events"]
               if not n.startswith(("Memcpy", "Memset"))]
    if not kernels:
        return None
    return len(kernels) / r["span_ticks"]
