"""Share of the profiled span in which no kernel, copy or fill ran on the
card: 1 - (union of the device records' intervals / span)."""
LAYER = "device (H100)"
UNIT = "%"
MOVES = "designs_per_s"


def read(r):
    if r["window_s"] <= 0 or not r["device_events"]:
        return None
    return 100.0 * (1.0 - r["busy_s"] / r["window_s"])
