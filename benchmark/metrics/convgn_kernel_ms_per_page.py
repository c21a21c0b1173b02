"""Time of the profiled slice's kernels whose name holds "convgn" (the
ConvGN epilogue's pair, csrc/convgn.cu), a page (ms)."""

from benchmark import readings

# a reading of the card: left out of a run on another device
DEVICE = True


def read(ctx):
    sl = readings.profiled_slice(ctx)
    if sl is None:
        return None
    spans = [e - s for name, s, e in sl["device"] if "convgn" in name.lower()]
    return 1000.0 * sum(spans) / sl["pages"] if spans else None
