"""Mean time the batch's consumer blocked on a page's device phase (ms):
the page's `batch.wait_device` span."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, lambda s: spans.total(s, "batch.wait_device"))
