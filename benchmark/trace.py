"""Reading a torch.profiler slice: the device's operations as intervals,
their union (busy time), the heaviest operations, and the longest idle
gaps named by the host operation that was running then.

Under the program's pipelined batch two worker threads put work on the
card, so operations may overlap: busy time is the length of the union of
their intervals, never the sum of their durations.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import numpy as np

Interval = Tuple[float, float]


def union_length(intervals: Sequence[Interval]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals: Sequence[Interval]) -> List[Interval]:
    """The uncovered stretches between the first start and the last end."""
    out, end = [], None
    for s, e in sorted(intervals):
        if end is not None and s > end:
            out.append((end, s))
        end = e if end is None else max(end, e)
    return out


def events_of(prof) -> Tuple[List[tuple], List[tuple]]:
    """(device ops, host ops) of a finished torch.profiler.profile, each a
    list of (name, start_s, end_s) on the profiler's clock. Device ops are
    kernels, copies and sets on the card."""
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        kind = str(ev.device_type())
        if kind.endswith("CUDA"):
            device.append((ev.name(), start, end))
        elif kind.endswith("CPU"):
            host.append((ev.name(), start, end))
    return device, host


def summary(device: List[tuple], host: List[tuple], top: int = 10,
            named_gaps: int = 500) -> dict:
    """busy_s, the device ops that took the most time (summed by name), and
    the `named_gaps` longest idle gaps summed by the innermost host op
    that covered each gap's middle ("host_python" when none did)."""
    busy = union_length([(s, e) for _, s, e in device])
    by_name: Dict[str, float] = collections.Counter()
    for name, s, e in device:
        by_name[name] += e - s
    idle: Dict[str, float] = collections.Counter()
    longest = sorted(gaps([(s, e) for _, s, e in device]),
                     key=lambda g: g[0] - g[1])[:named_gaps]
    if host:
        names = [n for n, _, _ in host]
        starts = np.asarray([s for _, s, _ in host])
        ends = np.asarray([e for _, _, e in host])
    for g0, g1 in longest:
        mid = 0.5 * (g0 + g1)
        name = "host_python"
        if host:
            hit = np.flatnonzero((starts <= mid) & (ends >= mid))
            if len(hit):
                name = names[hit[np.argmin(ends[hit] - starts[hit])]]
        idle[name] += g1 - g0
    return {"busy_s": busy,
            "device_ops": [[n, v] for n, v in by_name.most_common(top)],
            "idle_gaps": [[n, v] for n, v in idle.most_common(top)]}
