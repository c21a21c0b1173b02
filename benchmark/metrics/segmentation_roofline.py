"""The segmentation forwards' share of their roofline (%): the least time
of each unprofiled page's region and textline forwards (the larger of
their FLOPs at the bf16 peak and their bytes at the HBM peak,
benchmark/flops) over its device_timings["region_extraction"]. The span
holds more than the forwards, so the share stays at or under 100."""

from benchmark import flops, readings

# a reading of the card: left out of a run on another device
DEVICE = True


def read(ctx):
    least = spans = 0.0
    for p in readings.unprofiled(ctx):
        work = ctx["work"][p["j"]]
        span = p["res"].device_timings.get("region_extraction")
        if work is None or not span:
            continue
        least += flops.least_seconds(work["seg_flops"], work["seg_bytes"])
        spans += span
    return 100.0 * least / spans if spans else None
