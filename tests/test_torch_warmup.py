"""TextlineDetector.warm_up of the port against the JAX package's.

(a) The job plan: the stage entry points and model methods that the warm
jobs call are replaced, in both packages, by recorders that compute
nothing, and both warm_ups run at 500 x 380 on the same tiny bundle. The
JAX package runs its jobs on threads; here its threads run their targets
inline, one after another, so that each recorded call lands in its job.
Per job, the calls must be equal: the entry point (the port's
DeskewEngine.resident_dispatch stands for the JAX package's
slopes_and_profiles_resident), the group, the boxes or slot counts, the
crop heights and the shapes.

(b) The port alone: pages served by process_image after warm_up equal
the pages served before it (contours, slopes, page box, FLOPs, PAGE-XML
without <Metadata>), and warm_up counts no fallback and no degraded page.

(c) A job that raises makes warm_up raise (the JAX package logs it and
goes on).

(d) On a serving mesh, the grouped job runs a forward on every member's
replica.
"""

import dataclasses
import logging
import threading

import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu.pipeline import stages as jstages
from sbb_textline_detection_tpu_torch.models import runner
from sbb_textline_detection_tpu_torch.parallel import mesh as mesh_mod
from sbb_textline_detection_tpu_torch.pipeline import detector, stages

from tests.test_torch_detector import CFG, _page, _strip, bundles

H, W = 500, 380
FIXED_JOBS = {"page_model", "dual_multi", "dual_single", "deskew",
              "headless", "fullfused"}

# the stage entry points the warm jobs call, in both packages
STAGES = ("extract_page", "extract_page_batch",
          "extract_regions_and_textline",
          "extract_regions_and_textline_multi",
          "extract_regions_and_textline_resident",
          "extract_regions_and_textline_resident_raw",
          "extract_regions_and_textline_resident_raw_headless",
          "extract_regions_and_textline_resident_raw_fullfused",
          "deskew_spec_dispatch")


def _cfg(**flags):
    return dataclasses.replace(
        CFG, runtime=dataclasses.replace(CFG.runtime, **flags))


CONFIGS = {
    "default": {},
    "warm_fallback_programs": {"warm_fallback_programs": True},
    "pages_per_dispatch_4": {"pages_per_dispatch": 4},
    "resident_deskew_off": {"resident_deskew": False},
    "device_page_box": {"device_page_box": True},
    "fused_page_box": {"fused_page_box": True},
    "spec_deskew": {"spec_deskew": True, "textline_projection": True},
}


def _plain(x):
    """Shapes, boxes and sizes as nested lists of Python ints."""
    if isinstance(x, (list, tuple)) or (isinstance(x, np.ndarray)
                                        and x.dtype != object):
        return [_plain(v) for v in x]
    if isinstance(x, (np.integer, np.floating)):
        return x.item()
    return x


class _Token:
    """What a recorded upload or forward returns: its shape, if any."""

    def __init__(self, shape=None):
        self.shape = shape


class _Handle:
    """A deferred fused call's handle: fetch() is recorded."""

    def __init__(self, log):
        self.log = log

    def fetch(self):
        self.log.append(("fetch",))


_JOB_END = object()


def _install(mp, log, stage_mod, models, engine, resident_names):
    """Replace the warm jobs' callees by recorders that append to `log`."""
    for name in STAGES:
        def rec(*args, _name=name, **kw):
            if _name == "extract_page":
                entry = (_name, _plain(args[0].image.shape))
            elif _name == "extract_page_batch":
                entry = (_name, [_plain(s.image.shape) for s in args[0]])
            elif _name == "extract_regions_and_textline":
                entry = (_name, _plain(args[0].shape))
            elif _name == "extract_regions_and_textline_multi":
                entry = (_name, [_plain(p.shape) for p in args[0]])
            elif _name == "extract_regions_and_textline_resident":
                entry = (_name, [_plain(c.shape) for c in args[0]],
                         _plain(args[1]))
            elif _name == "extract_regions_and_textline_resident_raw":
                entry = (_name, [_plain(r.shape) for r in args[0]],
                         _plain(args[1]), _plain(args[2]),
                         _plain(kw.get("raw_hws")),
                         bool(kw.get("defer_fetch", False)))
            elif _name == "deskew_spec_dispatch":
                entry = (_name, _plain(args[2]))
            elif _name.endswith("_headless"):
                entry = (_name, _plain(args[0].shape), _plain(args[2]),
                         _plain(kw.get("raw_hw")))
            elif _name.endswith("_fullfused"):
                entry = (_name, _plain(args[0].shape), _plain(args[1]),
                         _plain(kw.get("raw_hw")))
            if "return_device_textline" in kw:
                entry += (bool(kw["return_device_textline"]),
                          bool(kw.get("textline_projection", False)))
            log.append(entry)
            if kw.get("defer_fetch"):
                return _Handle(log)
            return None
        mp.setattr(stage_mod, name, rec)

    page, region = models.page, models.region

    def predict_smalls(smalls, pad_to=None):
        log.append(("predict_smalls_prescaled_batch",
                    _plain(np.shape(smalls)), pad_to))

    def upload_canvas(img, margin_ratio=0.1):
        log.append(("upload_canvas", _plain(img.shape), margin_ratio))
        return _Token((1, 1))

    def upload_raw(img):
        log.append(("upload_raw", _plain(img.shape)))
        return _Token(tuple(img.shape))

    def page_box_dev(small, th, tw):
        log.append(("page_box_dev", _plain(np.shape(small)), th, tw))
        return _Token((1, 5))

    mp.setattr(page, "predict_smalls_prescaled_batch", predict_smalls)
    mp.setattr(page, "page_box_dev", page_box_dev)
    mp.setattr(region, "upload_canvas", upload_canvas)
    mp.setattr(region, "upload_raw", upload_raw)

    def resident(mask, boxes):
        log.append(("resident_chain", _plain(tuple(mask.shape)),
                    _plain(boxes)))
        return ([], [])

    def sweep(canvases, s, angles):
        log.append(("sweep", _plain(canvases.shape), s, len(angles)))
        return []

    for name in resident_names:
        mp.setattr(engine, name, resident)
    mp.setattr(engine, "_sweep_batched", sweep)


def _segments(log, names):
    """{job: its recorded calls}: `log` holds _JOB_END after each job."""
    out, cur = {}, []
    it = iter(names)
    for e in log:
        if e is _JOB_END:
            out[next(it)] = cur
            cur = []
        else:
            cur.append(e)
    assert not cur and next(it, None) is None
    return out


def _jax_plan(mp, jb, cfg, hw, caplog):
    """The JAX warm_up's calls by job, its threads run inline."""
    jdet = jdetector.TextlineDetector(jb, cfg)
    log = []
    _install(mp, log, jstages, jb, jdet.deskew,
             ["slopes_and_profiles_resident"])
    real = threading.Thread

    def thread(*args, target=None, **kw):
        qual = getattr(target, "__qualname__", "")
        if "warm_up.<locals>" not in qual:
            return real(*args, target=target, **kw)

        class Inline:
            def start(self):
                target(*kw.get("args", ()))
                if qual.endswith("timed.<locals>.run"):
                    log.append(_JOB_END)

            def join(self, timeout=None):
                pass
        return Inline()

    mp.setattr(threading, "Thread", thread)
    with caplog.at_level(logging.WARNING):
        timings = jdet.warm_up(*hw)
    mp.setattr(threading, "Thread", real)
    assert "warm_up:" not in caplog.text, caplog.text
    return _segments(log, list(timings))


def _port_plan(mp, tb, cfg, hw):
    """The port's warm_up calls by job; the job ends at its synchronize."""
    det = detector.TextlineDetector(tb, cfg)
    log = []
    _install(mp, log, stages, tb, det.deskew, ["resident_dispatch"])
    collects = []
    mp.setattr(det.deskew, "resident_collect",
               lambda pending: collects.append(pending) or ([], []))
    mp.setattr(det, "_synchronize", lambda: log.append(_JOB_END))
    timings = det.warm_up(*hw)
    plan = _segments(log, list(timings))
    # every dispatched chain is collected in its job
    assert len(collects) == sum(e[0] == "resident_chain"
                                for calls in plan.values() for e in calls)
    assert det.fallbacks == {} and det.degraded == 0
    return plan


# the seven configs at 500 x 380 (one crop-grid bucket, crops no taller
# than the page), and the default on a page wide enough for five buckets
# and tall enough for the chain's 1200-row crop
CASES = [(flags, (H, W)) for flags in CONFIGS.values()] + [({}, (1300, 600))]
CASE_IDS = list(CONFIGS) + ["default_wide"]


@pytest.mark.parametrize("flags,hw", CASES, ids=CASE_IDS)
def test_warm_up_job_plan_matches_jax(bundles, flags, hw, caplog):
    jb, tb = bundles
    cfg = _cfg(**flags)
    with pytest.MonkeyPatch.context() as mp:
        want = _jax_plan(mp, jb, cfg, hw, caplog)
    with pytest.MonkeyPatch.context() as mp:
        got = _port_plan(mp, tb, cfg, hw)
    assert set(got) == set(want)
    assert FIXED_JOBS <= set(got)
    for job in want:
        assert got[job] == want[job], job
    # the plan is not empty where the config's production paths run
    assert any(want.values())
    raw = [k for k in want if k.startswith("raw_single_")]
    fetchfree = flags.get("device_page_box") or flags.get("fused_page_box")
    assert bool(raw) == (not fetchfree)
    if hw[1] == 600:
        assert len(raw) == 5


# -- (b) the port alone: warm_up changes no page ---------------------------------

def _assert_same_page(a, b):
    assert a.page_coord == b.page_coord
    assert a.slopes == b.slopes
    assert len(a.contours) == len(b.contours)
    for ca, cb in zip(a.contours, b.contours):
        np.testing.assert_array_equal(ca, cb)
    assert a.flops == b.flops
    assert a.degraded == b.degraded
    assert _strip(a.xml_tree) == _strip(b.xml_tree)


def test_pages_after_warm_up_equal_pages_before(bundles):
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)
    pages = [_page(0, 210, 170), _page(2, 200, 160)]
    cold = [det.process_image(p, f"p{i}.png") for i, p in enumerate(pages)]
    assert all(len(r.contours) >= 3 for r in cold)
    fallbacks, degraded = dict(det.fallbacks), det.degraded
    timings = det.warm_up(H, W)
    assert dict(det.fallbacks) == fallbacks and det.degraded == degraded
    raw = {k for k in timings if k.startswith("raw_single_")}
    assert raw and set(timings) == FIXED_JOBS | raw
    assert all(v >= 0.0 for v in timings.values())
    warm = [det.process_image(p, f"p{i}.png") for i, p in enumerate(pages)]
    for a, b in zip(cold, warm):
        _assert_same_page(a, b)


# -- (c) a failing job ------------------------------------------------------------

def test_a_failing_job_makes_warm_up_raise(bundles, monkeypatch):
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(stages, "extract_page", boom)
    with pytest.raises(RuntimeError, match="injected"):
        det.warm_up(H, W)
    assert det.fallbacks == {} and det.degraded == 0


# -- (d) the serving mesh ----------------------------------------------------------

def test_grouped_job_reaches_every_mesh_member(bundles, monkeypatch):
    """With a 2-member mesh, mesh_auto_group makes the group 2, and the
    grouped job (dual_multi) deals each page's tile chunks over both
    members: each replica runs a forward."""
    _, tb = bundles

    def state(m):
        return m.spec, {k: v.clone() for k, v in
                        m.module.state_dict().items()}

    meshed = runner.ModelBundle._from_state(
        state(tb.page), state(tb.region), None, tb.region.runtime, "cpu",
        torch.float32, mesh_mod.make_mesh(["cpu"] * 2))
    det = detector.TextlineDetector(meshed, CFG)
    assert det._effective_group_size() == 2
    members = meshed.region.members
    assert len(members) == 2 and members[0][1] is not members[1][1]
    seen = [0] * len(members)
    for i, (_, module) in enumerate(members):
        def counted(x, _fwd=module.forward_nchw, _i=i):
            seen[_i] += 1
            return _fwd(x)
        monkeypatch.setattr(module, "forward_nchw", counted)
    dict(det._warm_jobs(H, W))["dual_multi"]()
    assert all(n >= 1 for n in seen), seen
