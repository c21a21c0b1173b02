"""Mean timings["deskew"] of a page (ms)."""

from benchmark import readings


def read(ctx):
    return readings.mean_ms(ctx, "deskew")
