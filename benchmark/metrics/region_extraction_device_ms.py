"""Mean device_timings["region_extraction"] of a page (ms): the CUDA-event
span of the fused segmentation, launch gaps included."""

from benchmark import readings


def read(ctx):
    return readings.mean_ms(ctx, "region_extraction", device=True)
