"""Milliseconds a hybrid tick: the traced run's unprofiled seconds over the
engine ticks in them (``TopoServingEngine.total_steps``)."""
LAYER = "hybrid tick (fea/hybrid.py make_hybrid_step)"
UNIT = "ms"
MOVES = "designs_per_s"


def read(r):
    if r["unprofiled_ticks"] <= 0:
        return None
    return 1e3 * r["unprofiled_s"] / r["unprofiled_ticks"]
