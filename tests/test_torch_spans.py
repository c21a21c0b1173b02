"""The port's per-page spans (utils/profiling): recorded where the work
happens, carried by the page (`PageResult.spans`), on the clock that
torch.profiler stamps its events with. One tiny page through
process_image, three through a process_batch on two workers, one page
that fails before any page box exists."""

import ast
import dataclasses
import pathlib

import pytest
import torch

from sbb_textline_detection_tpu_torch.pipeline import detector, stages
from sbb_textline_detection_tpu_torch.utils import profiling

from tests.test_torch_detector import CFG, _page, bundles  # noqa: F401

PAGES = [(_page(s, 210, 170), f"p{s}.png") for s in (0, 3, 5)]


def _cfg(**flags):
    return dataclasses.replace(
        CFG, runtime=dataclasses.replace(CFG.runtime, **flags))


@pytest.fixture(scope="module")
def fetched():
    """The nbytes of each array that profiling.fetch returned, in order,
    while the module's pages were served."""
    mp = pytest.MonkeyPatch()
    sizes = []
    real = profiling.fetch

    def fetch(t):
        out = real(t)
        sizes.append(out.nbytes)
        return out

    mp.setattr(profiling, "fetch", fetch)
    yield sizes
    mp.undo()


@pytest.fixture(scope="module")
def single(bundles, fetched):  # noqa: F811
    _, tb = bundles
    fetched.clear()
    res = detector.TextlineDetector(tb, CFG).process_image(*PAGES[0])
    return res, list(fetched)


@pytest.fixture(scope="module")
def batch(bundles):  # noqa: F811
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(device_phase_workers=2,
                                             page_box_batch=8))
    assert det._page_box_batch_size() == 8
    return list(det.process_batch(iter(PAGES)))


def _named(spans, name):
    return [sp for sp in spans if sp.name == name]


def _one(spans, name):
    found = _named(spans, name)
    assert len(found) == 1, (name, spans)
    return found[0]


def _total(spans, name):
    return sum(sp.seconds for sp in _named(spans, name))


def _assert_nested(spans):
    for sp in spans:
        assert sp.end_ns is not None and sp.start_ns <= sp.end_ns
        if sp.parent >= 0:
            up = spans[sp.parent]
            assert up.start_ns <= sp.start_ns and sp.end_ns <= up.end_ns, \
                (sp, up)
            assert up.thread == sp.thread


def test_each_page_carries_its_own_spans(single, batch):
    res, _ = single
    assert {sp.page for sp in res.spans} == {"p0.png"}
    root = _one(res.spans, "process_image")
    assert root.parent == -1 and res.spans[0] is root
    assert [sp for sp in res.spans if sp.parent == -1] == [root]
    for name in ("page_extraction", "region_extraction.model",
                 "host.dispatch", "host.contours", "deskew", "line_split",
                 "host.phase", "reading_order", "pagexml.build", "fetch"):
        assert _named(res.spans, name), name
    names = [n for _, n in PAGES]
    assert len(batch) == len(PAGES)
    for r, name in zip(batch, names):
        assert {sp.page for sp in r.spans} == {name}
        for one in ("batch.pull", "batch.device_phase", "batch.wait_device",
                    "host.dispatch", "host.phase", "page_extraction",
                    "region_extraction.model"):
            _one(r.spans, one)
        # the window's forward is shared: it names every page it served
        window = _one(r.spans, "prefetch.window")
        assert window.attrs["pages"] == names
        assert _named(r.spans, "fetch")[0].parent == \
            r.spans.index(window)


def test_children_nest_inside_their_parents(single, batch):
    _assert_nested(single[0].spans)
    for r in batch:
        _assert_nested(r.spans)
        threads = {sp.name: sp.thread for sp in r.spans if sp.parent < 0}
        assert threads["batch.device_phase"].startswith("device-phase")
        assert threads["batch.pull"] == threads["prefetch.window"] == \
            "page-box-prefetch"
        assert threads["batch.wait_device"] == threads["host.dispatch"] == \
            threads["host.phase"]


def test_device_phase_ends_before_the_host_takes_the_page(batch):
    for r in batch:
        pull = _one(r.spans, "batch.pull")
        window = _one(r.spans, "prefetch.window")
        dev = _one(r.spans, "batch.device_phase")
        wait = _one(r.spans, "batch.wait_device")
        dispatch = _one(r.spans, "host.dispatch")
        phase = _one(r.spans, "host.phase")
        assert pull.end_ns <= window.start_ns
        assert window.end_ns <= dev.start_ns
        assert dev.end_ns <= dispatch.start_ns
        assert wait.end_ns <= dispatch.start_ns <= dispatch.end_ns <= \
            phase.start_ns


def _derived(spans, window_pages=1):
    """Each timings key from the page's spans."""
    dispatch = spans.index(_one(spans, "host.dispatch"))
    pre = sum(sp.seconds for sp in spans if sp.parent == dispatch)
    window = _named(spans, "prefetch.window")
    share = window[0].seconds / window_pages if window else 0.0
    line_split = _total(spans, "line_split")
    return {"page_extraction": _total(spans, "page_extraction") + share,
            "region_extraction": (_total(spans, "region_extraction.model")
                                  + _total(spans, "host.contours")),
            "textlines": 0.0,
            "deskew": _total(spans, "deskew") - line_split,
            "line_split": line_split,
            "reading_order": _total(spans, "reading_order"),
            "total": (_total(spans, "page_extraction") + share
                      + _total(spans, "region_extraction.model")
                      + _total(spans, "host.phase") + pre)}


def test_timings_are_read_from_the_spans(single, batch):
    res, _ = single
    assert res.timings == pytest.approx(_derived(res.spans), abs=1e-9)
    for r in batch:
        assert r.timings == pytest.approx(
            _derived(r.spans, len(PAGES)), abs=1e-9)


def test_fetch_bytes_are_the_fetched_arrays(single):
    res, sizes = single
    fetches = _named(res.spans, "fetch")
    assert len(fetches) == len(sizes) >= 3
    assert [sp.attrs["bytes"] for sp in fetches] == sizes


def test_tiles_are_the_grid(bundles, single):  # noqa: F811
    _, tb = bundles
    res, _ = single
    pc = res.page_coord
    ny, nx = tb.region.grid_for(pc[1] - pc[0], pc[3] - pc[2],
                                CFG.tiling.margin_ratio)
    seg = _one(res.spans, "region_extraction.model")
    assert seg.attrs["tiles"] == ny * nx >= 12


def test_degraded_page_still_carries_its_root(bundles, monkeypatch):  # noqa: F811,E501
    _, tb = bundles
    boom = RuntimeError("injected")
    monkeypatch.setattr(tb.region, "upload_raw",
                        lambda *a: (_ for _ in ()).throw(boom))
    monkeypatch.setattr(stages, "scale_image",
                        lambda *a: (_ for _ in ()).throw(boom))
    res = detector.TextlineDetector(tb, CFG).process_image(*PAGES[1])
    assert res.degraded
    root = _one(res.spans, "process_image")
    assert root.parent == -1 and root.page == "p3.png"
    assert _one(res.spans, "pagexml.build").parent == res.spans.index(root)
    _assert_nested(res.spans)


def test_a_span_agrees_with_the_profilers_record():
    """A span and a record_function opened at the same point agree, under
    torch.profiler's CPU activity, to within 2 ms at both ends."""
    spans = []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.record_into(spans, "x"), \
                profiling.span("probe") as sp, \
                torch.profiler.record_function("probe_rf"):
            torch.ones(64).sum()
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "probe_rf"]
    assert abs(ev.start_ns() - sp.start_ns) < 2e6
    assert abs(ev.start_ns() + ev.duration_ns() - sp.end_ns) < 2e6
    assert spans == [sp]


def test_the_program_opens_no_record_function():
    """Only the profiler may name intervals on the card's timeline: the
    port calls no record_function (a range around launches would read as
    device work)."""
    root = pathlib.Path(profiling.__file__).parents[1]
    for path in root.rglob("*.py"):
        tree = ast.parse(path.read_text())
        called = {node.attr for node in ast.walk(tree)
                  if isinstance(node, ast.Attribute)}
        called |= {node.id for node in ast.walk(tree)
                   if isinstance(node, ast.Name)}
        assert "record_function" not in called, path
