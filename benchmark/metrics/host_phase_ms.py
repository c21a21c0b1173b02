"""Mean host work of a page's host phase (ms): its `host.dispatch` and
`host.phase` spans less the `fetch` spans inside them (the host's waits
for copies from the card)."""

from benchmark import spans


def _host(s):
    if not any(sp.name in spans.HOST_PHASE for sp in s):
        return None
    busy = sum(spans.seconds(sp) for sp in s if sp.name in spans.HOST_PHASE)
    waits = sum(spans.seconds(sp) for i, sp in enumerate(s)
                if sp.name == "fetch"
                and spans.within(s, i, spans.HOST_PHASE))
    return busy - waits


def read(ctx):
    return spans.mean_ms(ctx, _host)
