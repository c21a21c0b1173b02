"""The port's own contracts inside a pipelined batch (no JAX counterpart,
or one that differs on purpose): a batch equals process_image in turn, in
input order, whatever the scheduling and grouping; no page is dropped when
the page-box prefetch thread dies; a failed pre-dispatch is not tried
again; a page that fails before its page box comes out degraded in its
place; a failing grouped call is served page by page and counted; an early
stop leaves no thread; the counters and ops/precision.full_f32 hold under
threads. Tiny float32 models on the CPU; every comparison is exact."""

import sys
import threading
import time
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu_torch.ops import precision
from sbb_textline_detection_tpu_torch.pipeline import detector, stages

from tests.test_torch_batch import (_assert_results_equal, _boom, _cfg,
                                    _pages)
from tests.test_torch_detector import CFG, _page, _strip, bundles


@pytest.fixture(scope="module")
def sequential(bundles):
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)
    return [det.process_image(img, name) for img, name in _pages()]


@pytest.mark.parametrize("flags", [
    {}, dict(device_phase_workers=1, page_box_batch=0),
    dict(device_phase_workers=3, page_box_batch=2),
    dict(pages_per_dispatch=2), dict(pages_per_dispatch=4),
    dict(pages_per_dispatch=2, raw_upload=False),
    dict(pages_per_dispatch=3, resident_upload=False),
    dict(pages_per_dispatch=2, resident_deskew=False)],
    ids=lambda f: "-".join(f"{k}{v}" for k, v in f.items()) or "default")
def test_batch_equals_sequential_in_input_order(bundles, sequential, flags):
    """Whatever the scheduling and grouping, a batch gives what
    process_image gives page by page, in input order; the crop-upload
    group (resident_upload off) runs predict_dual_tiled_multi."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(**flags))
    got = list(det.process_batch(iter(_pages()), prefetch=2))
    want = sequential
    if flags.get("resident_deskew") is False:
        seq = detector.TextlineDetector(tb, _cfg(resident_deskew=False))
        want = [seq.process_image(img, name) for img, name in _pages()]
    _assert_results_equal(got, want)
    names = [ET.fromstring(_strip(r.xml_tree)).find(".//{*}Page")
             .get("imageFilename") for r in got]
    assert names == [name for _, name in _pages()]
    assert det.degraded == 0 and not det.fallbacks


def test_batch_empty_iterable(bundles):
    _, tb = bundles
    for flags in ({}, dict(pages_per_dispatch=2), dict(page_box_batch=0)):
        det = detector.TextlineDetector(tb, _cfg(**flags))
        assert list(det.process_batch(iter([]))) == []


@pytest.mark.parametrize("flag,value", [
    ("pages_per_dispatch", 4), ("pages_per_dispatch", 0),
    ("device_phase_workers", 1), ("device_phase_workers", 0),
    ("page_box_batch", 0), ("page_box_batch", 1)])
def test_batch_flags_construct_and_serve(bundles, sequential, flag, value):
    """Any value of the three flags constructs; a value below 1 means 1
    (0 or 1 for the page-box window: no batched stage)."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(**{flag: value}))
    assert det._effective_group_size() == (
        max(1, value) if flag == "pages_per_dispatch" else 1)
    if flag == "page_box_batch":
        assert det._page_box_batch_size() == 0
    got = list(det.process_batch(iter(_pages()[:2])))
    _assert_results_equal(got, sequential[:2])


def test_page_box_batch_size_follows_the_path(bundles):
    _, tb = bundles
    assert detector.TextlineDetector(tb, CFG)._page_box_batch_size() == \
        CFG.runtime.page_box_batch == 8
    for flags in (dict(raw_upload=False), dict(resident_upload=False)):
        assert detector.TextlineDetector(
            tb, _cfg(**flags))._page_box_batch_size() == 0


def test_pre_box_skips_the_page_forward(bundles, monkeypatch):
    """device_phase with a ready box runs no page-model forward and folds
    the window's shares into page_extraction."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)
    image = _page(0, 210, 170)
    clean = det.device_phase(image, "p.png")
    pc = clean.page_coord
    box = [pc[2], pc[0], pc[3] - pc[2], pc[1] - pc[0]]
    monkeypatch.setattr(tb.page, "predict_smalls_prescaled_batch", _boom)
    st = det.device_phase(image, "p.png", pre_box=(box, 5.0, 3.0, 7e9))
    assert not det.fallbacks
    assert st.page_coord == pc
    np.testing.assert_array_equal(st.region_mask, clean.region_mask)
    assert st.timings["page_extraction"] >= 5.0
    assert st.device_timings["page_extraction"] >= 3.0
    page_forward = tb.page._flops_per_sample[(3, 64, 64)]
    assert st.flops == pytest.approx(clean.flops - page_forward + 7e9)


def test_prefetch_thread_death_drops_no_pages(bundles, sequential):
    """If the page-box prefetch THREAD dies (a KeyboardInterrupt escapes
    the window's `except Exception`), every page still comes out, in
    order, with its own page-model forward."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(page_box_batch=3))
    assert det._page_box_batch_size() == 3

    def dying(smalls, pad_to=None):
        if smalls.shape[0] > 1:
            raise KeyboardInterrupt("injected prefetch-thread death")
        return real(smalls, pad_to)

    real = tb.page.predict_smalls_prescaled_batch
    tb.page.predict_smalls_prescaled_batch = dying
    try:
        got = list(det.process_batch(iter(_pages())))
    finally:
        del tb.page.predict_smalls_prescaled_batch
    _assert_results_equal(got, sequential)
    assert det.fallbacks == {"page_box_batch": 1} and det.degraded == 0


def test_failed_page_box_window_runs_per_page_forwards(bundles, sequential):
    """A window whose batched forward raises yields its pages box-less;
    each window that failed is counted."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(page_box_batch=2))
    real = tb.page.predict_smalls_prescaled_batch

    def failing(smalls, pad_to=None):
        if smalls.shape[0] > 1:
            raise RuntimeError("injected")
        return real(smalls, pad_to)

    tb.page.predict_smalls_prescaled_batch = failing
    try:
        got = list(det.process_batch(iter(_pages())))
    finally:
        del tb.page.predict_smalls_prescaled_batch
    _assert_results_equal(got, sequential)
    # windows of 2, 2 and 1 pages: the last one is a batch of one
    assert det.fallbacks == {"page_box_batch": 2}


def test_failed_box_decision_in_the_window_gives_the_whole_page(
        bundles, monkeypatch):
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(page_box_batch=3))
    monkeypatch.setattr(detector.stages, "_page_box_model_res", _boom)
    pages = _pages()[:3]
    got = list(det.process_batch(iter(pages)))
    for (img, _), r in zip(pages, got):
        th, tw = stages.working_dims(img, CFG)
        assert r.page_coord == [0, th - 1, 0, tw - 1] and not r.degraded
    assert det.fallbacks == {"whole_page_box": 3}


def test_failed_predispatch_not_reattempted(bundles, monkeypatch):
    """When host_phase_dispatch already tried the resident dispatch and
    got no handle, host_phase does not try again: the host sweep serves
    the page, with one attempt in all."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)
    page = _page(0, 210, 170)
    st = det.device_phase(page, "p.png")
    assert st.textline_dev is not None
    want = det.host_phase(st, det.host_phase_dispatch(st))
    assert len(want.contours) >= 3

    calls = []

    def failing(boxes, engine, textline_dev):
        calls.append(1)
        return None     # what the real wrapper returns on a caught failure

    monkeypatch.setattr(stages, "deskew_dispatch_resident", failing)
    st2 = det.device_phase(page, "p.png")
    pre = det.host_phase_dispatch(st2)
    assert pre is not None and pre["handle"] is None and len(calls) == 1
    got = det.host_phase(st2, pre)
    assert len(calls) == 1
    assert len(got.contours) == len(want.contours)
    assert got.slopes == want.slopes
    assert det.fallbacks == {"host_sweep": 1}


@pytest.mark.parametrize("flags", [{}, dict(device_phase_workers=1,
                                            page_box_batch=0),
                                   dict(pages_per_dispatch=2)],
                         ids=["default", "w1-nobox", "grouped"])
def test_page_that_fails_early_is_degraded_in_place(bundles, sequential,
                                                    flags):
    """The third page's device phase fails before any page box exists (raw
    upload, canvas upload and host resize all raise for it): it comes out
    as a whole-page empty PAGE-XML in its place and the batch goes on."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(**flags))
    pages = _pages()
    bad = pages[2][0]
    real_raw, real_scale = tb.region.upload_raw, stages.scale_image

    def upload_raw(image):
        if image.shape[:2] == bad.shape[:2] and np.array_equal(
                image, bad[..., 0]):
            raise RuntimeError("injected")
        return real_raw(image)

    def scale_image(image, cfg):
        if image is bad:
            raise RuntimeError("injected")
        return real_scale(image, cfg)

    tb.region.upload_raw = upload_raw
    stages.scale_image = scale_image
    try:
        got = list(det.process_batch(iter(pages)))
    finally:
        del tb.region.upload_raw
        stages.scale_image = real_scale
    assert [r.degraded for r in got] == [False, False, True, False, False]
    assert det.degraded == 1
    th, tw = stages.working_dims(bad, CFG)
    assert got[2].page_coord == [0, th - 1, 0, tw - 1]
    assert got[2].contours == [] and b"PcGts" in _strip(got[2].xml_tree)
    assert b"p1.png" in _strip(got[2].xml_tree)
    ok = [0, 1, 3, 4]
    _assert_results_equal([got[i] for i in ok], [sequential[i] for i in ok])


@pytest.mark.parametrize("where", ["subgroup", "group"])
def test_failing_grouped_call_falls_back_per_page(bundles, sequential,
                                                  monkeypatch, where):
    """A fused call that fails for a sub-group, or shared work that fails
    for the whole group, is served by per-page device phases and counted."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(pages_per_dispatch=2,
                                             raw_upload=False))
    if where == "subgroup":
        real = tb.region.predict_dual_tiled_resident

        def resident(other, canvases, boxes, *a, **k):
            if len(canvases) > 1:
                raise RuntimeError("injected")
            return real(other, canvases, boxes, *a, **k)

        monkeypatch.setattr(tb.region, "predict_dual_tiled_resident",
                            resident)
        # pages 0+1 share a grid and fail together; 2+3 are unlike (two
        # sub-groups of one) and the tail is alone
        want = {"per_page_dispatch": 1}
    else:
        monkeypatch.setattr(stages, "extract_page_batch", _boom)
        want = {"per_page_dispatch": 2}
    got = list(det.process_batch(iter(_pages())))
    _assert_results_equal(got, sequential)
    assert det.fallbacks == want and det.degraded == 0


def test_stopping_early_leaves_no_thread(bundles):
    """A consumer that takes one result and closes the generator: the
    worker threads and the prefetch thread end, and the rest of the pages
    is not pulled."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, _cfg(page_box_batch=2))
    pulled = []

    def source():
        for i in range(40):
            pulled.append(i)
            yield _page(0, 210, 170), f"p{i}.png"

    before = {t.ident for t in threading.enumerate()}
    gen = det.process_batch(source())
    first = next(gen)
    gen.close()
    assert first.contours
    deadline = time.time() + 10
    while time.time() < deadline and any(
            t.ident not in before and t.is_alive()
            for t in threading.enumerate()):
        time.sleep(0.05)
    left = [t.name for t in threading.enumerate()
            if t.ident not in before and t.is_alive()]
    assert left == []
    assert len(pulled) < 20


def test_counters_are_exact_under_threads(bundles):
    """More threads than cores and a short switch interval: a lost update
    of `fallbacks` or `degraded` would show in the totals."""
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)

    def hammer():
        for _ in range(1000):
            det._fell_back("x")
            det._page_degraded()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert det.fallbacks == {"x": 16000} and det.degraded == 16000


# -- full_f32 under threads ----------------------------------------------------

def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_full_f32_under_two_out_of_step_threads():
    """A enters, B enters, A leaves, B leaves (and the mirror order): TF32
    stays off until the last block closes, then each flag goes back to its
    own value."""
    prev = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = False
    try:
        steps = {n: threading.Event() for n in
                 ("a_in", "b_in", "a_out", "b_out")}
        seen = {}

        def a():
            with precision.full_f32():
                seen["a_in"] = _tf32()
                steps["a_in"].set()
                steps["b_in"].wait(10)
                seen["a_late"] = _tf32()
            seen["after_a"] = _tf32()
            steps["a_out"].set()

        def b():
            steps["a_in"].wait(10)
            with precision.full_f32():
                seen["b_in"] = _tf32()
                steps["b_in"].set()
                steps["a_out"].wait(10)
                seen["b_alone"] = _tf32()
            seen["after_b"] = _tf32()
            steps["b_out"].set()

        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(20)
        assert not any(t.is_alive() for t in threads)
        off = (False, False)
        assert seen == {"a_in": off, "b_in": off, "a_late": off,
                        "after_a": off, "b_alone": off,
                        "after_b": (True, False)}
        assert _tf32() == (True, False)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def test_full_f32_many_threads_never_see_tf32(bundles):
    """Eight threads enter and leave at random: none ever sees a flag on
    inside its block, and the flags come back."""
    prev = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    bad = []
    try:
        def run(seed):
            rng = np.random.default_rng(seed)
            for _ in range(200):
                with precision.full_f32():
                    if _tf32() != (False, False):
                        bad.append(seed)
                    time.sleep(float(rng.uniform(0, 2e-4)))
                    if _tf32() != (False, False):
                        bad.append(seed)

        threads = [threading.Thread(target=run, args=(s,)) for s in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert bad == [] and _tf32() == (True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def test_batch_of_a_float32_bundle_leaves_the_flags(bundles):
    """A pipelined batch of a float32 bundle (worker forwards and the main
    thread's deskew matmuls inside full_f32 at once) runs every forward
    with TF32 off and puts the flags back."""
    _, tb = bundles
    prev = _tf32()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    seen = []
    real = tb.region.module.forward_nchw

    def spy(x):
        seen.append(_tf32())
        return real(x)

    tb.region.module.forward_nchw = spy
    try:
        det = detector.TextlineDetector(tb, CFG)
        assert len(list(det.process_batch(iter(_pages())))) == 5
        assert seen and set(seen) == {(False, False)}
        assert _tf32() == (True, True)
    finally:
        del tb.region.module.forward_nchw
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
