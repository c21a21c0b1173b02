"""Device-time and FLOP accounting for pipeline stages (counterpart of
sbb_textline_detection_tpu/utils/stagetime.py).

Wall clock alone cannot say whether a stage is limited by the card or by
the host, so every entry point that puts work on the device runs inside
`device_section(device)`, and every model forward adds its FLOPs. Both go
to a thread-local ledger that the detector reads per stage: reset(),
the stage, snapshot().

PyTorch launches asynchronously, so wall time around a launch measures the
host. On a CUDA device a section therefore records a CUDA event pair on
the calling thread's current stream, and the pair is resolved (its end
event waited for, its elapsed time read) when the ledger is read: after
the stage has fetched its result, which makes the wait free. A stage that
only enqueues work takes its ledger along unresolved with detach() and
resolves it once the result has come back. On the CPU a section is wall
time.

"Device seconds" is the span on the stream from the section's first
operation starting to its last one finishing. It includes the gaps in
which the stream waits for the host to launch the next operation, and
work of other streams that shares the card meanwhile: an upper bound on
the time the card was busy for the stage, as the reference's
host-observed dispatch time is. FLOPs are those of the model forwards
(convolutions and matmuls, counted once per module and input shape with
count_flops) and of the deskew chain's projection matmuls; elementwise
work, the morphology and the Radon kernel's data-dependent sums are not
counted.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Callable, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_TLS = threading.local()


class Ledger:
    """Seconds already known, FLOPs, and CUDA event pairs not yet read."""

    def __init__(self):
        self.seconds = 0.0
        self.flops = 0.0
        self.pairs: List[Tuple[torch.cuda.Event, torch.cuda.Event]] = []

    def resolve(self) -> Tuple[float, float]:
        """(device_seconds, flops); waits for every open event pair."""
        for start, end in self.pairs:
            end.synchronize()
            self.seconds += start.elapsed_time(end) / 1e3
        self.pairs = []
        return self.seconds, self.flops


def _ledger() -> Ledger:
    led = getattr(_TLS, "ledger", None)
    if led is None:
        led = _TLS.ledger = Ledger()
    return led


def reset() -> None:
    """Start this thread's ledger anew (start of a stage or page)."""
    _TLS.ledger = Ledger()


def snapshot() -> Tuple[float, float]:
    """(device_seconds, flops) accumulated on this thread since reset();
    waits for the device work of the sections recorded so far."""
    return _ledger().resolve()


def detach() -> Ledger:
    """Take this thread's ledger without waiting for the device, and start
    a new one; the caller reads it later with Ledger.resolve()."""
    led = _ledger()
    reset()
    return led


def add(seconds: float, flops: float = 0.0) -> None:
    led = _ledger()
    led.seconds += seconds
    led.flops += flops


@contextmanager
def device_section(device, flops: float = 0.0):
    """Wrap one piece of device work (and the fetch of its result): its
    time on `device` and `flops` go to the thread ledger."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.time()
        try:
            yield
        finally:
            add(time.time() - t0, flops)
        return
    led = _ledger()
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    try:
        yield
    finally:
        # the stream the section ended on is the one it began on: nothing
        # inside a section switches streams
        end.record(stream)
        led.pairs.append((start, end))
        led.flops += flops


class _FlopCount(TorchDispatchMode):
    """Sums torch.utils.flop_counter's formulas (2 x multiply-adds of
    convolutions and matmuls) over the operations dispatched on this
    thread. Unlike FlopCounterMode it installs no process-wide module
    hooks, so another thread's forward neither disturbs nor enters the
    count."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        return out


def count_flops(fn: Callable, *args):
    """(fn(*args), the FLOPs of its convolutions and matmuls)."""
    with _FlopCount() as mode:
        out = fn(*args)
    return out, float(mode.flops)
