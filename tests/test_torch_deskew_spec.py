"""The speculative deskew and the resident buffer cap of the port
(pipeline/deskew.py) against the JAX package (the cases of
tests/test_deskew_spec.py), and against the port's own ordinary chain.

Tolerances: slopes are compared for equality (bit for bit), region boxes
and canvas maps are integers and must be equal. Profiles are held to
rtol 1e-4 / atol 1e-2 (the Radon tests' tolerance): the JAX program and
the port sum in other orders, and a speculative slot's crop buffer is
spec_buffer_shape while the port's ordinary dispatch sizes each group's
buffer to its largest crop, which rounds the hat's offset K = bufW // 2
differently (ROADMAP Queue 3)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.ops import pack as jpack
from sbb_textline_detection_tpu.pipeline import deskew as jdeskew
from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu_torch.core.config import (DEFAULT_CONFIG,
                                                          DeskewConfig)
from sbb_textline_detection_tpu_torch.pipeline import deskew, detector

from tests.test_torch_deskew import _draw_lines
from tests.test_torch_detector import CFG, _strip, bundles  # noqa: F401
from tests.test_torch_detector import _page as _photo

RTOL, ATOL = 1e-4, 1e-2


def _page(boxes=None, h=360, w=480):
    """(region canvas, textline canvas, boxes): filled region rectangles
    (their traced contours ARE the boxes) holding text-line bars at a few
    degrees, thick enough to survive the chain's crop erode."""
    boxes = boxes or [[30, 40, 180, 120], [240, 60, 200, 160]]
    region = np.zeros((h, w), np.uint8)
    textline = np.zeros((h, w), np.uint8)
    for i, (x, y, bw, bh) in enumerate(boxes):
        region[y:y + bh, x:x + bw] = 1
        _draw_lines(textline, x, y, bw, bh, deg=3.0 + 4.0 * i)
    return region, textline, boxes


def _engines(canvas=256, region_batch=4, buf_max=1024):
    kw = dict(max_canvas=canvas, region_batch=region_batch,
              morph_kernel=DEFAULT_CONFIG.morphology.kernel_size,
              crop_erode_iterations=(
                  DEFAULT_CONFIG.morphology.deskew_crop_erode_iterations),
              buf_max=buf_max)
    return (jdeskew.DeskewEngine(jdeskew.DeskewConfig(), **kw),
            deskew.DeskewEngine(DeskewConfig(), device="cpu", **kw))


def _spec(eng, region, textline, boxes, crop_hw=None, slots=8):
    """Dispatch and finalize as the detector does (permissive pixel-count
    area bounds over the crop)."""
    crop_hw = crop_hw or region.shape
    area = float(crop_hw[0] * crop_hw[1])
    amin = 0.5 * DEFAULT_CONFIG.region.min_area_ratio * area
    pending = eng.spec_dispatch(torch.from_numpy(region),
                                torch.from_numpy(textline), crop_hw, amin,
                                area, slots=slots)
    return eng.spec_finalize(pending, boxes)


def _jax_spec(eng, region, textline, boxes, crop_hw=None, slots=8):
    crop_hw = crop_hw or region.shape
    packed = jpack.pack1_host(region)
    area = float(crop_hw[0] * crop_hw[1])
    amin = 0.5 * DEFAULT_CONFIG.region.min_area_ratio * area
    pending = eng.spec_dispatch(
        jnp.asarray(np.concatenate([packed, np.zeros(8, np.uint8)])),
        len(packed), region.shape, jnp.asarray(textline), crop_hw, amin,
        area, slots=slots)
    return eng.resident_collect(eng.spec_finalize(pending, boxes))


def _same(got, want):
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for (g1, g0), (w1, w0) in zip(got[1], want[1]):
        assert g1.shape == w1.shape and g0.shape == w0.shape
        np.testing.assert_allclose(g1, w1, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g0, w0, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["all_match", "one_unmatched",
                                  "bucket_mismatch", "crop_mask"])
def test_spec_matches_resident_and_jax(case):
    """Every host box finds its slot (all_match); a host box the device
    mask lacks goes to the ordinary dispatch (one_unmatched); regions
    whose bucket is not the speculative one send the whole page there
    (bucket_mismatch); foreground outside the page crop mints no device
    box (crop_mask). In each case the slopes equal the ordinary chain's
    and the JAX speculative path's, bit for bit."""
    jeng, eng = _engines(canvas=512 if case == "bucket_mismatch" else 256)
    crop_hw = None
    if case == "bucket_mismatch":
        region, textline, boxes = _page(boxes=[[30, 40, 80, 60],
                                               [150, 60, 90, 70]])
        assert eng._bucket_for_sizes([(b[3], b[2]) for b in boxes]) == 256
    else:
        region, textline, boxes = _page()
    if case == "one_unmatched":
        boxes = boxes + [[300, 10, 60, 30]]
    if case == "crop_mask":
        crop_hw = (300, 460)
        region = region.copy()
        region[300:, :] = 1
        region[:, 460:] = 1
        boxes = [b for b in boxes if b[0] + b[2] <= 460 and b[1] + b[3] <= 300]
    resolved = _spec(eng, region, textline, boxes, crop_hw)
    if case == "bucket_mismatch":
        assert not isinstance(resolved, deskew._SpecResolved)
    else:
        assert isinstance(resolved, deskew._SpecResolved)
        assert resolved.mapping.count(-1) == (case == "one_unmatched")
        assert (resolved.fallback is None) == (case != "one_unmatched")
    got = eng.resident_collect(resolved)
    plain = eng.resident_collect(eng.resident_dispatch(
        torch.from_numpy(textline), boxes))
    _same(got, plain)
    _same(got, _jax_spec(jeng, region, textline, boxes, crop_hw))
    assert any(s != 0.0 for s in got[0])


@pytest.mark.parametrize("where", ["resident", "spec"])
def test_region_over_the_cap_raises_like_jax(where):
    jeng, eng = _engines(buf_max=256)
    region, textline, _ = _page()
    boxes = [[0, 0, 300, 300]]
    assert eng.resident_buffer_shape((360, 480)) == \
        jeng.resident_buffer_shape((360, 480)) == (256, 256)
    with pytest.raises(ValueError, match="exceeds"):
        jeng.resident_dispatch(jnp.asarray(textline), boxes)
    with pytest.raises(ValueError, match="exceeds"):
        if where == "resident":
            eng.resident_dispatch(torch.from_numpy(textline), boxes)
        else:
            pend = deskew._SpecPending(None, eng.spec_canvas(), 256, 256, 8,
                                       torch.from_numpy(textline))
            eng.spec_finalize(pend, boxes)


def test_buffer_shapes_and_canvas_match_jax():
    for buf_max in (1024, 2816):
        jeng, eng = _engines(canvas=512, buf_max=buf_max)
        assert eng.spec_canvas() == jeng.spec_canvas() == 512
        for hw in ((360, 480), (1500, 3100), (4320, 3240)):
            assert eng.resident_buffer_shape(hw) == \
                jeng.resident_buffer_shape(hw)
            assert eng.spec_buffer_shape(hw) == jeng.spec_buffer_shape(hw)


@pytest.mark.parametrize("s", [256, 512])
def test_canvas_maps_graph_matches_jax_and_host(s):
    """The device canvas maps (a batch of crop sizes at once) equal the
    JAX in-graph maps and the numpy twin, and the twin equals JAX's."""
    rng = np.random.default_rng(50 + s)
    hw = rng.integers(0, 1400, size=(16, 2))
    hw[0] = (0, 0)                              # an empty slot
    pad = 1.4
    table = (np.arange(1401, dtype=np.float64) * pad).astype(np.int32)
    cy, cx = deskew._canvas_maps_graph(
        torch.from_numpy(hw[:, 0]), torch.from_numpy(hw[:, 1]), s,
        torch.from_numpy(table.astype(np.int64)))
    fn = jax.jit(jax.vmap(lambda h, w: jdeskew._canvas_maps_graph(
        h, w, s, jnp.asarray(table))))
    jy, jx = fn(jnp.asarray(hw[:, 0], jnp.int32),
                jnp.asarray(hw[:, 1], jnp.int32))
    np.testing.assert_array_equal(cy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(cx.numpy(), np.asarray(jx))
    for (h, w), y, x in zip(hw, cy.numpy(), cx.numpy()):
        ty, tx = deskew._canvas_maps_graph_host(int(h), int(w), s, pad)
        jty, jtx = jdeskew._canvas_maps_graph_host(int(h), int(w), s, pad)
        np.testing.assert_array_equal(ty, y)
        np.testing.assert_array_equal(tx, x)
        np.testing.assert_array_equal(ty, jty)
        np.testing.assert_array_equal(tx, jtx)


def _cfg(**flags):
    return dataclasses.replace(CFG, runtime=dataclasses.replace(
        CFG.runtime, **flags))


def test_detector_spec_on_matches_off_and_jax(bundles,  # noqa: F811
                                              monkeypatch):
    """process_image with spec_deskew on: page box, slopes and PAGE-XML
    equal the port's with it off and the JAX detector's with it on, and
    the slopes came from matched speculative slots."""
    jb, tb = bundles
    image = _photo(0, 210, 170)
    cfg = _cfg(spec_deskew=True, deskew_spec_slots=8)
    want = jdetector.TextlineDetector(jb, cfg).process_image(image, "p.png")
    off = detector.TextlineDetector(tb, CFG).process_image(image, "p.png")
    det = detector.TextlineDetector(tb, cfg)
    resolved = []
    real = det.deskew.spec_finalize

    def spy(pending, boxes):
        resolved.append(real(pending, boxes))
        return resolved[-1]

    monkeypatch.setattr(det.deskew, "spec_finalize", spy)
    got = det.process_image(image, "p.png")
    assert not det.fallbacks and not got.degraded
    assert len(resolved) == 1 and isinstance(resolved[0],
                                             deskew._SpecResolved)
    assert sum(j >= 0 for j in resolved[0].mapping) >= 3
    assert got.page_coord == off.page_coord == want.page_coord
    assert got.slopes == off.slopes == want.slopes
    assert _strip(got.xml_tree) == _strip(off.xml_tree) \
        == _strip(want.xml_tree)


def test_detector_region_over_the_cap_takes_the_host_sweep(
        bundles):  # noqa: F811
    """deskew_buf_max below the page's regions: the chain raises, the host
    sweep serves the page, one host_sweep fallback is counted, and the
    PAGE-XML equals the JAX detector's under the same cap."""
    jb, tb = bundles
    image = _photo(0, 210, 170)
    cfg = _cfg(deskew_buf_max=64)
    want = jdetector.TextlineDetector(jb, cfg).process_image(image, "p.png")
    det = detector.TextlineDetector(tb, cfg)
    got = det.process_image(image, "p.png")
    assert det.fallbacks == {"host_sweep": 1} and not got.degraded
    assert any(np.ptp(np.asarray(c).reshape(-1, 2), 0).max() >= 64
               for c in got.contours)
    assert got.slopes == want.slopes
    assert _strip(got.xml_tree) == _strip(want.xml_tree)
