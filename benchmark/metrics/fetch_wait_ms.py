"""Mean time the host waited a page for copies from the card (ms): the
page's `fetch` spans summed."""

from benchmark import spans


def read(ctx):
    return spans.mean_ms(ctx, lambda s: spans.total(s, "fetch"))
