"""The readers of the program's spans (benchmark/spans.py and its
metrics) on hand-made spans and device intervals, against values computed
by hand: waits and host work a page, fetches, the share of the card's
idle time spent in host phases (overlapping device streams, overlapping
host spans, spans that cross the slice's edges), and nothing read from a
program whose pages carry no spans."""

from types import SimpleNamespace

import pytest

from benchmark import run, spans

NS = 1_000_000_000


def _span(name, start, end, parent=-1, **attrs):
    """A span from seconds on the profiler's clock."""
    return SimpleNamespace(name=name, start_ns=int(start * NS),
                           end_ns=int(end * NS), parent=parent,
                           attrs=attrs or None)


def _batch_page(t):
    """A batched page's spans, t seconds after the window's start."""
    return [
        _span("batch.pull", t + 0.0, t + 0.1),
        _span("prefetch.window", t + 0.1, t + 0.3, pages=["a", "b"]),
        _span("fetch", t + 0.25, t + 0.3, parent=1, bytes=64),
        _span("batch.device_phase", t + 0.3, t + 0.8),
        _span("fetch", t + 0.7, t + 0.75, parent=3, bytes=8),
        _span("batch.wait_device", t + 0.5, t + 0.8),
        _span("host.dispatch", t + 0.9, t + 1.0),
        _span("host.contours", t + 0.9, t + 0.95, parent=6),
        _span("host.phase", t + 1.0, t + 1.5),
        _span("deskew", t + 1.0, t + 1.2, parent=8),
        _span("fetch", t + 1.1, t + 1.15, parent=9, bytes=16),
        _span("pagexml.build", t + 1.3, t + 1.5, parent=8),
    ]


def _ctx(pages, device=(), entry="batch"):
    """pages: (spans, profiled) pairs."""
    window = SimpleNamespace(
        pages=[{"j": i, "res": SimpleNamespace(spans=s), "profiled": prof}
               for i, (s, prof) in enumerate(pages)],
        seconds=10.0,
        slice={"wall_s": 5.0, "overhead_s": 0.0, "pages": 1,
               "device": list(device), "host": []} if device else None)
    return {"entry": entry, "window": window, "work": []}


def _read(base, ctx):
    return run._reader(base).read(ctx)


def test_waits_host_work_and_fetches_a_page():
    # the profiled page reads wrong on purpose: it must be left out
    odd = _batch_page(0.0)
    odd[5] = _span("batch.wait_device", 0.0, 9.0)
    ctx = _ctx([(_batch_page(0.0), False), (_batch_page(2.0), False),
                (odd, True)])
    assert _read("consumer_wait_ms", ctx) == pytest.approx(300.0)
    assert _read("ready_wait_ms", ctx) == pytest.approx(100.0)
    # dispatch 0.1 + phase 0.5 - the fetch inside the phase's deskew
    # 0.05 (the device phase's and the window's fetches are not inside)
    assert _read("host_phase_ms", ctx) == pytest.approx(550.0)
    assert _read("fetch_wait_ms", ctx) == pytest.approx(150.0)


def test_a_single_page_reads_its_host_phase_under_its_root():
    page = [_span("process_image", 0.0, 2.0),
            _span("page_extraction", 0.0, 0.2, parent=0),
            _span("fetch", 0.1, 0.2, parent=1),
            _span("host.dispatch", 0.5, 0.7, parent=0),
            _span("host.phase", 0.7, 1.9, parent=0),
            _span("reading_order", 1.0, 1.5, parent=4),
            _span("fetch", 1.2, 1.4, parent=5)]
    ctx = _ctx([(page, False)], entry="single")
    assert _read("host_phase_ms", ctx) == pytest.approx(1200.0)
    assert _read("fetch_wait_ms", ctx) == pytest.approx(300.0)
    # no batch spans on this path
    assert _read("consumer_wait_ms", ctx) is None
    assert _read("ready_wait_ms", ctx) is None


def test_idle_host_share_takes_unions_inside_the_gaps():
    # two streams overlap ([0, 4] and [2, 6]); the gaps are (6, 8) and
    # (9, 10): 3 s idle
    device = [("conv", 0.0, 4.0), ("gemm", 2.0, 6.0), ("radon", 8.0, 9.0),
              ("copy", 10.0, 12.0), ("set", 10.5, 11.0)]
    a = [_span("host.dispatch", -5.0, 6.5),      # crosses the slice's start
         _span("host.phase", 7.0, 7.5),
         _span("fetch", 7.1, 7.2, parent=1)]
    b = [_span("host.dispatch", 7.2, 8.5),       # overlaps a's host.phase
         _span("batch.wait_device", 9.0, 9.6),
         _span("host.phase", 9.5, 20.0)]         # crosses the slice's end
    ctx = _ctx([(a, False), (b, True)], device)
    # inside the gaps: (6, 6.5), the union (7, 8) and (9.5, 10) = 2 s
    assert _read("idle_host_phase_share", ctx) == pytest.approx(
        100.0 * 2.0 / 3.0)
    assert spans.overlap([(0.0, 2.0), (1.0, 3.0)], [(2.5, 5.0)]) == \
        pytest.approx(0.5)


@pytest.mark.parametrize("base", ["consumer_wait_ms", "ready_wait_ms",
                                  "host_phase_ms", "fetch_wait_ms",
                                  "idle_host_phase_share"])
def test_a_program_without_spans_gives_nothing(base):
    window = SimpleNamespace(
        pages=[{"j": 0, "res": SimpleNamespace(timings={}),
                "profiled": False},
               {"j": 1, "res": None, "profiled": True}],
        seconds=10.0,
        slice={"wall_s": 5.0, "overhead_s": 0.0, "pages": 1,
               "device": [("conv", 0.0, 1.0), ("gemm", 2.0, 3.0)],
               "host": []})
    assert _read(base, {"entry": "batch", "window": window,
                        "work": []}) is None
