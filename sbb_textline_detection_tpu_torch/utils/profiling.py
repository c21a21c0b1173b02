"""Profiling / tracing hooks (counterpart of
sbb_textline_detection_tpu/utils/profiling.py).

Every PageResult carries its per-stage timings (`timings`,
`device_timings`, `flops`). Beyond them, `trace(logdir)` wraps a region in
a torch.profiler trace of the host and, where there is one, of the card,
written as a Chrome trace (chrome://tracing, Perfetto), and
`annotate(name)` names a host-side region on that timeline.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterable, Iterator


@contextlib.contextmanager
def trace(logdir: str | None) -> Iterator[None]:
    """Host + device profiler trace into `logdir` (no-op when None): one
    `trace-<pid>-<ms since the epoch>.json` per traced region. Kernels
    are recorded whichever thread launched them."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))


def annotate(name: str):
    """Host-side scope annotation on the profiler timeline."""
    import torch

    return torch.profiler.record_function(name)


def merge_stage_timings(timings: Iterable[Dict[str, float]]
                        ) -> Dict[str, Dict[str, float]]:
    """Aggregate per-page stage timings into {stage: {sum, mean, max}}."""
    acc: Dict[str, list] = {}
    for t in timings:
        for k, v in t.items():
            acc.setdefault(k, []).append(v)
    return {k: {"sum": float(sum(v)),
                "mean": float(sum(v) / len(v)),
                "max": float(max(v))}
            for k, v in acc.items()}
