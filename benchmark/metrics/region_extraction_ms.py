"""Mean timings["region_extraction"] of a page (ms)."""

from benchmark import readings


def read(ctx):
    return readings.mean_ms(ctx, "region_extraction")
