"""What the per-layer readers (benchmark/metrics/<base>.py) share: the
window's pages that ran outside the profiled slice, their stage means,
and the slice itself. Each reader is `read(ctx) -> float or None`, where
ctx holds "entry" (batch or single), "window" (run.Window) and "work"
(flops.page_work of each pool page's reference page box)."""

from __future__ import annotations

import math
from typing import List, Optional


def unprofiled(ctx) -> List[dict]:
    """The window's served pages that the profiler did not see."""
    return [p for p in ctx["window"].pages
            if p["res"] is not None and not p["profiled"]]


def timed(ctx) -> List[dict]:
    """The unprofiled pages whose time unprofiled_seconds holds: all of a
    batch's; of a single entry's, those that did not fail (a failed page's
    wall reads inf)."""
    pages = unprofiled(ctx)
    if ctx["entry"] == "single":
        return [p for p in pages if math.isfinite(p["wall"])]
    return pages


def unprofiled_seconds(ctx) -> float:
    """The wall of the unprofiled pages: a single entry's walls of the
    timed pages, or the batch window less the profiled slice and the
    profiler's start and stop."""
    win = ctx["window"]
    if ctx["entry"] == "single":
        return sum(p["wall"] for p in timed(ctx))
    sl = win.slice
    return win.seconds - (sl["wall_s"] + sl["overhead_s"] if sl else 0.0)


def mean_ms(ctx, key: str, device: bool = False) -> Optional[float]:
    """Mean of a stage's seconds (timings, or device_timings), in ms, over
    the unprofiled pages that report the stage."""
    vals = [(p["res"].device_timings if device else p["res"].timings)[key]
            for p in unprofiled(ctx)
            if key in (p["res"].device_timings if device
                       else p["res"].timings)]
    return 1000.0 * sum(vals) / len(vals) if vals else None


def profiled_slice(ctx) -> Optional[dict]:
    """The profiled slice, when it saw device operations."""
    sl = ctx["window"].slice
    return sl if sl and sl["device"] and sl["pages"] else None
