"""Share of the profiled slice's device idle time that the host spent in
a page's host phase (%): the gaps between the slice's device operations
(trace.gaps) that lie inside the union of the window's `host.dispatch`
and `host.phase` spans, over all the gaps."""

from benchmark import readings, spans, trace

# a reading of the card: left out of a run on another device
DEVICE = True


def read(ctx):
    sl = readings.profiled_slice(ctx)
    if sl is None:
        return None
    host = spans.window_intervals(ctx, spans.HOST_PHASE)
    gaps = trace.gaps([(s, e) for _, s, e in sl["device"]])
    idle = sum(e - s for s, e in gaps)
    if not host or idle <= 0:
        return None
    return 100.0 * spans.overlap(gaps, host) / idle
