"""Profiling and tracing (counterpart of
sbb_textline_detection_tpu/utils/profiling.py).

Every PageResult carries its per-stage timings (`timings`,
`device_timings`, `flops`) and its spans (`spans`): the intervals of the
page's work, recorded where the work happens, on the clock that
torch.profiler stamps its events with (`time.time_ns()`), so that a span
lines up with the profiler's record of the card. Recording is always on:
a span costs two clock reads, the thread's name and a list append, takes
no lock and formats no string. It opens no `record_function`
range either: the profiler reports such a range around kernel launches
as an event of the card, which would count as device work.

A thread records into the span list of the page it works on
(`record_into`); spans opened while no page's list is in use keep their
stamps (the timings read them) and are kept nowhere. Work shared by
several pages (a prefetch window's forward, a group's device phase) is
recorded into a list of its own and copied into each page's list
(`adopt`), carrying the pages' ids.

`trace(logdir)` wraps a region in a torch.profiler trace of the host and,
where there is one, of the card, written as a Chrome trace
(chrome://tracing, Perfetto) with the spans of the pages handed to it,
one track per thread, on the profiler's time base.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional, Sequence


class Span:
    """One interval of a page's work: its name, start and end in ns on
    the profiler's clock, the name of the thread that ran it, the index
    of its parent in the page's span list (-1 for a root), the page's id,
    and its attributes or None (`pages`: the ids of the pages that share
    it; `bytes`: a fetch's size; `tiles`: the segmentation's tiles)."""

    __slots__ = ("name", "start_ns", "end_ns", "thread", "parent", "page",
                 "attrs")

    def __init__(self, name: str, start_ns: int, thread: str, parent: int,
                 page: str, attrs: Optional[dict]):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.thread = thread
        self.parent = parent
        self.page = page
        self.attrs = attrs

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        end(self)


class _Book(threading.local):
    """A thread's page span list in use, the indices of its open spans,
    and the page's id."""
    spans: Optional[List[Span]] = None
    open: Sequence[int] = ()
    page: str = ""


_TLS = _Book()


@contextlib.contextmanager
def record_into(spans: List[Span], page: str) -> Iterator[None]:
    """Record this thread's spans into `spans`, the list of page `page`,
    for the block; nothing changes when that list is already in use (a
    span opened around the block stays the parent)."""
    book = _TLS
    if book.spans is spans:
        yield
        return
    saved = book.spans, book.open, book.page
    book.spans, book.open, book.page = spans, [], page
    try:
        yield
    finally:
        book.spans, book.open, book.page = saved


def span(name: str, **attrs) -> Span:
    """Open a span on this thread, a child of its innermost open span.
    As a context manager it is the block: stamped once the block ends."""
    book = _TLS
    stack = book.open
    sp = Span(name, time.time_ns(), threading.current_thread().name,
              stack[-1] if stack else -1, book.page, attrs or None)
    spans = book.spans
    if spans is not None:
        stack.append(len(spans))
        spans.append(sp)
    return sp


def end(sp: Span) -> None:
    """Close `sp` (once: a second call keeps the first end)."""
    if sp.end_ns is not None:
        return
    sp.end_ns = time.time_ns()
    book = _TLS
    stack = book.open
    if stack and book.spans[stack[-1]] is sp:
        stack.pop()


def finished(name: str, start_ns: int, page: str, **attrs) -> Span:
    """A root span from `start_ns` to now, kept in no list: for work done
    before the page's list exists, or for a wait that the caller files
    under each page it held up."""
    sp = Span(name, start_ns, threading.current_thread().name, -1, page,
              attrs or None)
    sp.end_ns = time.time_ns()
    return sp


def note(key: str, value) -> None:
    """Add `value` to attribute `key` of this thread's innermost open span
    (nothing when no span is open in a page's list)."""
    book = _TLS
    if not book.open:
        return
    sp = book.spans[book.open[-1]]
    if sp.attrs is None:
        sp.attrs = {}
    sp.attrs[key] = sp.attrs.get(key, 0) + value


def adopt(spans: List[Span], shared: List[Span], page: str) -> None:
    """Append copies of `shared`, a list of spans recorded for several
    pages, to page `page`'s list, their parent indices moved along."""
    base = len(spans)
    for sp in shared:
        c = Span(sp.name, sp.start_ns, sp.thread,
                 sp.parent + base if sp.parent >= 0 else -1, page, sp.attrs)
        c.end_ns = sp.end_ns
        spans.append(c)


def fetch(t):
    """`t.cpu().numpy()` in a `fetch` span: the host's wait for a copy
    from the card, with the bytes it brings."""
    with span("fetch", bytes=t.numel() * t.element_size()):
        return t.cpu().numpy()


def chrome_events(spans: Iterable[Span], base_ns: int = 0) -> List[dict]:
    """The spans as Chrome trace events on a time base of `base_ns` (µs
    from it), one track per thread in a process of their own; a span that
    several pages share appears once."""
    tids: Dict[str, int] = {}
    events, seen = [], set()
    for sp in spans:
        key = (sp.name, sp.start_ns, sp.end_ns, sp.thread)
        if sp.end_ns is None or key in seen:
            continue
        seen.add(key)
        tid = tids.setdefault(sp.thread, len(tids) + 1)
        args = {"page": sp.page}
        args.update(sp.attrs or {})
        events.append({"ph": "X", "cat": "program_span", "name": sp.name,
                       "pid": "program spans", "tid": tid,
                       "ts": (sp.start_ns - base_ns) / 1e3,
                       "dur": (sp.end_ns - sp.start_ns) / 1e3,
                       "args": args})
    events += [{"ph": "M", "name": "thread_name", "pid": "program spans",
                "tid": tid, "args": {"name": thread}}
               for thread, tid in tids.items()]
    return events


@contextlib.contextmanager
def trace(logdir: str | None) -> Iterator[List[Span]]:
    """Host + device profiler trace into `logdir` (nothing is written when
    it is None or empty): one `trace-<pid>-<ms since the epoch>.json` per
    traced region, holding the spans put into the list it yields (the
    served pages' `spans`). Kernels are recorded whichever thread
    launched them."""
    spans: List[Span] = []
    if not logdir:
        yield spans
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield spans
    path = os.path.join(logdir,
                        f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += chrome_events(
        spans, int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
