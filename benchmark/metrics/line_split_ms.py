"""Mean timings["line_split"] of a page (ms)."""

from benchmark import readings


def read(ctx):
    return readings.mean_ms(ctx, "line_split")
