"""Host time a page beyond its device spans (ms): timings["total"] minus
device_timings["total"], a lower bound on the host's share."""

from benchmark import readings


def read(ctx):
    pages = readings.unprofiled(ctx)
    vals = [p["res"].timings["total"] - p["res"].device_timings["total"]
            for p in pages if "total" in p["res"].device_timings]
    return 1000.0 * sum(vals) / len(vals) if vals else None
