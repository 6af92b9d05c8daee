"""95th percentile of the queue wait (submit -> first admission to a lane)
of the requests admitted in the traced run's unprofiled part, from the
engine's ``TopoRequest.queue_wait_s``."""
import numpy as np

LAYER = "engine (serve/topo_service.py)"
UNIT = "s"
MOVES = "p95_latency_s"


def read(r):
    waits = r["queue_waits"]
    if len(waits) < 20:
        return None
    return float(np.percentile(np.asarray(waits, np.float64), 95))
