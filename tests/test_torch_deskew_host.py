"""The port's host-sweep deskew (DeskewEngine.best_angles and the host
branch of stages.slopes_and_lines) against the JAX package's, on the same
seeded crops: canvases bit-equal, angles equal, scores close, line boxes
equal. The JAX side runs its XLA einsum route (use_pallas=False), the
port its plain Radon version (CPU tensors)."""

import dataclasses

import numpy as np
import pytest

from sbb_textline_detection_tpu.core.config import (DEFAULT_CONFIG,
                                                    DeskewConfig)
from sbb_textline_detection_tpu.pipeline import deskew as jdeskew
from sbb_textline_detection_tpu.pipeline import stages as jstages
from sbb_textline_detection_tpu_torch.ops import radon
from sbb_textline_detection_tpu_torch.pipeline import deskew, stages

S = 256
# the Radon tests' tolerance on f32 sums taken in another order
RTOL = 1e-4


def _cfg(guard):
    return DeskewConfig(coarse_steps=12, vertical_steps=6,
                        vertical_resweep_guard=guard)


def _engines(guard, region_batch=4):
    cfg = _cfg(guard)
    je = jdeskew.DeskewEngine(cfg, max_canvas=S, use_pallas=False,
                              region_batch=region_batch)
    te = deskew.DeskewEngine(cfg, max_canvas=S, region_batch=region_batch,
                             device="cpu")
    return je, te


def _line_crop(rng, h, w, deg, pitch=18, thick=7):
    """Text-line bars at `deg` degrees with ragged ends and a little salt
    noise, as an eroded textline crop looks."""
    crop = np.zeros((h, w), np.uint8)
    t = np.tan(np.deg2rad(deg))
    xs = np.arange(w)
    for y0 in range(3, h - 3, pitch):
        x1 = int(rng.integers(w // 2, w))
        for k in range(thick):
            ys = np.round(y0 + k + t * (xs - w / 2)).astype(int)
            ok = (ys >= 0) & (ys < h) & (xs < x1)
            crop[ys[ok], xs[ok]] = 1
    crop[rng.uniform(size=(h, w)) < 0.002] = 1
    return crop


def _crops(seed=0):
    """Five regions, so that a region_batch of 4 gives a full group and a
    one-region tail: skewed both ways, vertical text, a crop larger than
    the canvas (downscaled), and an empty one."""
    rng = np.random.default_rng(seed)
    vertical = _line_crop(rng, 120, 200, 0.0).T.copy()
    return [_line_crop(rng, 150, 170, 7.0), vertical,
            _line_crop(rng, 90, 420, -3.0, pitch=16),
            _line_crop(rng, 110, 140, -19.0), np.zeros((40, 60), np.uint8)]


@pytest.mark.parametrize("hw", [(150, 170), (90, 420), (333, 47), (5, 3),
                                (256, 256)])
def test_canvas_into_is_bit_equal(hw):
    je, te = _engines(True)
    crop = (np.random.default_rng(hw[0]).uniform(size=hw) < 0.3).astype(
        np.uint8) * 255
    want = np.zeros((S, S), np.uint8)
    got = np.zeros((S, S), np.uint8)
    je._canvas_into(crop, want)
    te._canvas_into(crop, got)
    assert want.any()
    np.testing.assert_array_equal(got, want)
    assert te._bucket_for([crop]) == je._bucket_for([crop])


@pytest.mark.parametrize("guard", [True, False])
def test_best_angles_match_jax(guard):
    je, te = _engines(guard)
    crops = _crops()
    radon.launches = 0
    want = je.best_angles(crops)
    got = te.best_angles(crops)
    assert radon.launches == 0, "CPU tensors take the plain version"
    assert got == want
    assert abs(want[0]) > 1 and abs(want[3]) > 10, "skew must register"
    assert want[1] < -50, "the vertical region takes the vertical sweep"
    assert want[4] == 0.0
    assert te.best_angle(crops[0]) == want[0]
    assert te.best_angles([]) == []


@pytest.mark.parametrize("angles", ["coarse", "vertical"])
def test_sweep_scores_match_jax(angles):
    je, te = _engines(True)
    crops = _crops(1)[:4]
    buf = np.zeros((4, S, S), np.uint8)
    for i, c in enumerate(crops):
        te._canvas_into(c, buf[i])
    ang = getattr(te, "_" + angles)
    np.testing.assert_array_equal(ang, getattr(je, "_" + angles))
    want = je._sweep_batched(buf, S, ang)
    got = te._sweep_batched(buf, S, ang)
    assert [a for a, _ in got] == [a for a, _ in want]
    np.testing.assert_allclose([s for _, s in got], [s for _, s in want],
                               rtol=RTOL)


def test_batch_buckets_match_jax():
    for rb in (1, 2, 3, 8):
        je, te = _engines(True, rb)
        assert te._batch_buckets() == je._batch_buckets()


@pytest.mark.parametrize("slope", [0.0, 6.0, -3.5, 72.0])
def test_textline_postprocess_matches_jax(slope):
    rng = np.random.default_rng(3)
    crop = _line_crop(rng, 140, 180, -slope if abs(slope) < 45 else 0.0)
    box = [30, 50, 180, 140]
    contour = np.array([[30, 50], [209, 50], [209, 189], [30, 189]])
    want = jstages.textline_postprocess(crop, slope, contour, box,
                                        DEFAULT_CONFIG)
    got = stages.textline_postprocess(crop, slope, contour, box,
                                      DEFAULT_CONFIG)
    assert len(got) == len(want)
    if abs(slope) < 45:
        assert len(want) >= 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


class _FailingEngine:
    """An engine whose resident chain dispatches but fails at collect."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def resident_dispatch(self, mask_dev, boxes):
        return ["handle"]

    def resident_collect(self, handle):
        raise RuntimeError("injected")


def _page_mask(seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros((260, 460), np.uint8)
    boxes = [[10, 10, 170, 150], [200, 20, 240, 110], [30, 180, 140, 70]]
    for (x, y, w, h), deg in zip(boxes, (5.0, -2.0, 0.0)):
        # bars thick enough to survive the 9x9 crop erode
        mask[y:y + h, x:x + w] = _line_crop(rng, h, w, deg, pitch=28,
                                            thick=15)
    contours = [np.array([[x, y], [x + w - 1, y], [x + w - 1, y + h - 1],
                          [x, y + h - 1]]) for x, y, w, h in boxes]
    return mask, boxes, contours


@pytest.mark.parametrize("how", ["collect_fails", "no_device_canvas",
                                 "fetched_mask", "sweep_fails", "no_mask"])
def test_slopes_and_lines_host_branch_matches_jax(how):
    """The host branch behind a failing resident handle, with no device
    canvas at all, with the mask fetched on demand, with a failing sweep
    (slope sentinel -> 0) and with no mask anywhere."""
    cfg = dataclasses.replace(DEFAULT_CONFIG, deskew=_cfg(True))
    je, te = _engines(True)
    mask, boxes, contours = _page_mask()
    rungs = []
    kw_j, kw_t = {}, {}
    tmask = mask
    if how == "collect_fails":
        je, te = _FailingEngine(je), _FailingEngine(te)
        kw_j = dict(textline_dev=object())
        kw_t = dict(textline_dev=object())
    elif how == "fetched_mask":
        tmask = None
        kw_j = dict(textline_mask_fetch=lambda: mask, deskew_attempted=True)
        kw_t = dict(kw_j)
    elif how == "sweep_fails":
        def boom(crops):
            raise RuntimeError("injected")
        je.best_angles = boom
        te.best_angles = boom
    elif how == "no_mask":
        tmask = None
    want = jstages.slopes_and_lines(contours, boxes, tmask, cfg, je, **kw_j)
    got = stages.slopes_and_lines(contours, boxes, tmask, cfg, te,
                                  on_fallback=rungs.append, **kw_t)
    assert got[0] == want[0]
    assert [len(l) for l in got[1]] == [len(l) for l in want[1]]
    for gl, wl in zip(got[1], want[1]):
        for g, w in zip(gl, wl):
            np.testing.assert_array_equal(g, w)
    if how in ("collect_fails", "no_device_canvas", "fetched_mask"):
        assert any(s != 0.0 for s in want[0])
        assert sum(len(l) for l in want[1]) >= 4
    else:
        assert want[0] == [0.0] * 3
    assert rungs == {"collect_fails": ["host_sweep"],
                     "fetched_mask": ["host_sweep"],
                     "sweep_fails": ["slope_zero"]}.get(how, [])
