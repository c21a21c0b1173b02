"""Mean time a batched page's finished device state waited for the host
(ms): the start of the page's `host.dispatch` span (its `host.phase`
where it has none) less the end of its `batch.device_phase`."""

from benchmark import spans


def _wait(s):
    done = spans.named(s, "batch.device_phase")
    taken = spans.named(s, "host.dispatch") or spans.named(s, "host.phase")
    if not done or not taken:
        return None
    return (min(sp.start_ns for sp in taken)
            - max(sp.end_ns for sp in done)) * 1e-9


def read(ctx):
    return spans.mean_ms(ctx, _wait)
