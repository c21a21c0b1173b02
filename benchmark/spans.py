"""What the readers of the program's spans share (benchmark/metrics/
consumer_wait_ms.py, ready_wait_ms.py, host_phase_ms.py,
fetch_wait_ms.py, idle_host_phase_share.py). A served page's spans are
its `PageResult.spans`: each has a `name`, `start_ns` and `end_ns` on the
profiler's clock, a `parent` (its parent's index in the page's list, -1
for a root) and `attrs`. A program whose pages carry no spans gives
nothing to read: every reader then returns None."""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from benchmark import readings

Interval = Tuple[float, float]
HOST_PHASE = ("host.dispatch", "host.phase")


def of(res) -> list:
    """The page's spans (none for a page that raised, or a program
    without spans)."""
    return list(getattr(res, "spans", None) or ())


def seconds(sp) -> float:
    return (sp.end_ns - sp.start_ns) * 1e-9


def named(spans, name: str) -> list:
    return [sp for sp in spans if sp.name == name]


def total(spans, name: str) -> Optional[float]:
    """Seconds of the page's spans named `name`; None when it has none."""
    found = named(spans, name)
    return sum(seconds(sp) for sp in found) if found else None


def within(spans, i: int, names: Sequence[str]) -> bool:
    """Whether span i lies inside a span named in `names` (an ancestor)."""
    i = spans[i].parent
    while i >= 0:
        if spans[i].name in names:
            return True
        i = spans[i].parent
    return False


def mean_ms(ctx, per_page: Callable[[list], Optional[float]]
            ) -> Optional[float]:
    """Mean of per_page(spans) in ms over the unprofiled pages that carry
    spans and for which it is not None."""
    vals = []
    for p in readings.unprofiled(ctx):
        spans = of(p["res"])
        value = per_page(spans) if spans else None
        if value is not None:
            vals.append(value)
    return 1000.0 * sum(vals) / len(vals) if vals else None


def window_intervals(ctx, names: Sequence[str]) -> List[Interval]:
    """(start, end) in seconds, on the profiler's clock, of the spans named
    in `names` of every page the window served."""
    return [(sp.start_ns * 1e-9, sp.end_ns * 1e-9)
            for p in ctx["window"].pages
            for sp in of(p["res"]) if sp.name in names]


def union(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of intervals as sorted disjoint intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: Sequence[Interval], b: Sequence[Interval]) -> float:
    """Length of the intersection of two unions of intervals."""
    a, b = union(a), union(b)
    i = j = 0
    length = 0.0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            length += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return length
