"""Share of the profiled slice's wall in which no operation ran on the
card (%): 1 - (union of the device operations' intervals) / wall."""

from benchmark import readings, trace

# a reading of the card: left out of a run on another device
DEVICE = True


def read(ctx):
    sl = readings.profiled_slice(ctx)
    if sl is None:
        return None
    busy = trace.union_length([(s, e) for _, s, e in sl["device"]])
    return 100.0 * (1.0 - busy / sl["wall_s"])
