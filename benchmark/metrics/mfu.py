"""The model step's share of the card's dense bf16 peak (%): the FLOPs of
every forward of the unprofiled pages (benchmark/flops.page_work on the
reference's page box) over their wall, over 989e12 FLOP/s. A single
entry's failed page, whose wall reads inf, is left out of both."""

from benchmark import flops, readings

# a reading of the card: left out of a run on another device
DEVICE = True


def read(ctx):
    pages = readings.timed(ctx)
    work = [ctx["work"][p["j"]] for p in pages]
    seconds = readings.unprofiled_seconds(ctx)
    if not pages or None in work or seconds <= 0:
        return None
    total = sum(w["flops"] for w in work)
    return 100.0 * total / seconds / flops.PEAK_BF16_FLOPS
