"""The fetch-free page box of the port (runner.page_box_dev, the headless
and the fully-fused raw forms, the detector's rungs for device_page_box
and fused_page_box) against the JAX package, float32 on both sides with
the same weights (the cases of tests/test_runner_resident.py:309-520).

Tolerances: boxes are integers and must be equal; region masks and row
projections are argmaxes and integer sums and must be equal on pages
whose top-2 logit gaps exceed the two frameworks' f32 differences
(tests/test_torch_fused.py). The JAX headless program runs the grid of
the whole working page and the port the box-sized grid of the raw path,
so their textline canvases are compared inside the box, where the
pipeline reads them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.models import runner as jrunner
from sbb_textline_detection_tpu.ops import resize as jresize
from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu.pipeline import stages as jstages
from sbb_textline_detection_tpu_torch.models import runner
from sbb_textline_detection_tpu_torch.pipeline import detector, stages

from tests.test_torch_detector import CFG, _page, _strip, bundles  # noqa: F401
from tests.test_torch_fused import (MORPH, POST, _min_logit_gap,  # noqa: F401
                                    _raw_page, models)

SHAPING = dict(morph=MORPH, mask_class=1, post_morph=POST)
# (seed, gray) of tests/test_torch_fused.py's page with every top-2 logit
# gap of the crop above 1e-4, its working size and box
SEED, GRAY, TH, TW, BOX = 9, True, 110, 95, [6, 4, 90, 80]


def _small(raw, model, th=TH, tw=TW):
    mh, mw = model.input_hw
    rgb = raw if raw.ndim == 3 else np.repeat(raw[..., None], 3, -1)
    return jstages.page_model_input_from_raw(rgb, th, tw, mh, mw)


@pytest.mark.parametrize("seed", [0, 3])
def test_page_box_dev_matches_jax_and_host(bundles, seed):  # noqa: F811
    """The page model's device decision equals the JAX one and the host
    decision (stages._page_box_model_res) on the detector's pages."""
    jb, tb = bundles
    image = _page(seed, 210, 170)
    th, tw = stages.working_dims(image, CFG)
    small = _small(image, tb.page, th, tw)
    want = np.asarray(jb.page.page_box_dev(small, th, tw))
    got = tb.page.page_box_dev(small, th, tw)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 5)
    assert got.tolist() == want.tolist()
    x, y, w, h = stages._page_box_model_res(
        tb.page.predict_small_prescaled(small), th, tw, CFG)
    assert got.tolist() == [[y, x, h, w, 1]]


class _Background:
    """A page model whose every pixel is background."""

    input_hw = (64, 64)

    @staticmethod
    def _logits(x):
        n, _, h, w = x.shape
        return torch.stack([torch.ones(n, h, w), torch.zeros(n, h, w)], 1)

    @staticmethod
    def apply(variables, x):
        return jnp.stack([jnp.ones(x.shape[:3]), jnp.zeros(x.shape[:3])], -1)


def test_empty_page_mask_gives_the_whole_page_quirk():
    small = np.full((64, 64, 3), 200, np.uint8)
    want = np.asarray(jax.jit(lambda x: jrunner._page_box_from_small(
        _Background, None, x, 160, 136))(jnp.asarray(small)))
    got = runner._page_box_from_small(_Background, torch.from_numpy(small),
                                      160, 136)
    assert got.tolist() == want.tolist() == [[0, 0, 159, 135, 0]]


def test_headless_matches_raw_and_jax(models):  # noqa: F811
    """The headless form: its region mask, row projection and textline
    canvas equal the port's raw form on the same box, and the JAX
    headless program's (the canvas inside the box)."""
    jm, tm = models
    raw = _raw_page(np.random.default_rng(SEED), 130, 110, GRAY)
    box5 = np.array([BOX + [1]], np.int32)
    want_r, want_p, want_tl, want_b = jm.predict_dual_tiled_resident_raw_headless(
        jm, jm.upload_raw(raw), jax.device_put(box5), (TH, TW),
        raw_hw=raw.shape[:2], **SHAPING)
    got_r, got_p, got_tl, got_b = tm.predict_dual_tiled_resident_raw_headless(
        tm, tm.upload_raw(raw), torch.from_numpy(box5), (TH, TW),
        raw_hw=raw.shape[:2], **SHAPING)
    raw_r, raw_p, raw_tl = tm.predict_dual_tiled_resident_raw(
        tm, [tm.upload_raw(raw)], [BOX], [(TH, TW)],
        return_device_textline=True, textline_projection=True,
        raw_hws=[raw.shape[:2]], **SHAPING)[0]
    assert list(got_b) == list(want_b) == BOX + [1]
    assert 0 < got_r.sum() < got_r.size
    for got, want in ((got_r, want_r), (got_p, want_p), (got_r, raw_r),
                      (got_p, raw_p)):
        np.testing.assert_array_equal(got, want)
    bh, bw = BOX[2], BOX[3]
    assert torch.equal(got_tl, raw_tl)
    np.testing.assert_array_equal(got_tl.numpy()[:bh, :bw],
                                  np.asarray(want_tl)[:bh, :bw])


def test_fullfused_matches_headless_and_jax(models, bundles):  # noqa: F811
    """The fully-fused form gathers the page model's input from the
    resident raw page: the same box, masks and canvas as the headless
    form fed by page_box_dev on the host-gathered input, and as the JAX
    fully-fused program (page model: the detector tests' 3-channel one)."""
    jm, tm = models
    jpage, tpage = bundles[0].page, bundles[1].page
    # tests/test_torch_fused.py's RGB page (seed 8) at (100, 90): the page
    # model picks the whole page, whose crop has no near-tie logit
    th, tw = 100, 90
    raw = _raw_page(np.random.default_rng(8), 130, 110, False)
    mh, mw = tpage.input_hw
    sy = jresize.compose_nearest_indices(mh, th, raw.shape[0])
    sx = jresize.compose_nearest_indices(mw, tw, raw.shape[1])
    want = jm.predict_dual_tiled_resident_raw_fullfused(
        jm, jpage, jm.upload_raw(raw), sy, sx, (th, tw),
        raw_hw=raw.shape[:2], **SHAPING)
    got = tm.predict_dual_tiled_resident_raw_fullfused(
        tm, tpage, tm.upload_raw(raw), sy, sx, (th, tw),
        raw_hw=raw.shape[:2], **SHAPING)
    head = tm.predict_dual_tiled_resident_raw_headless(
        tm, tm.upload_raw(raw), tpage.page_box_dev(
            _small(raw, tpage, th, tw), th, tw),
        (th, tw), raw_hw=raw.shape[:2], **SHAPING)
    assert list(got[3]) == list(want[3]) == list(head[3])
    assert list(got[3]) == [0, 0, th, tw, 1]
    assert _min_logit_gap(jm, raw, [0, 0, th, tw], th, tw) > 1e-4
    bh, bw = int(got[3][2]), int(got[3][3])
    for i in (0, 1):
        np.testing.assert_array_equal(got[i], want[i])
        np.testing.assert_array_equal(got[i], head[i])
    assert torch.equal(got[2], head[2])
    np.testing.assert_array_equal(got[2].numpy()[:bh, :bw],
                                  np.asarray(want[2])[:bh, :bw])


def _boom(*a, **k):
    raise AssertionError("a lower rung ran")


@pytest.mark.parametrize("flag", ["device_page_box", "fused_page_box"])
def test_detector_fetchfree_matches_jax(bundles, flag):  # noqa: F811
    """process_image with the flag on: page box, slopes and PAGE-XML equal
    the JAX detector's with the flag on and the port's with it off, and
    the page went through the fetch-free rung (the lower rungs raise)."""
    jb, tb = bundles
    cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(
        CFG.runtime, **{flag: True}))
    image = _page(0, 210, 170)
    want = jdetector.TextlineDetector(jb, cfg).process_image(image, "p.png")
    plain = detector.TextlineDetector(tb, CFG).process_image(image, "p.png")
    det = detector.TextlineDetector(tb, cfg)
    det._device_phase_raw = det._device_phase_standard = _boom
    got = det.process_image(image, "p.png")
    assert not det.fallbacks and not got.degraded
    assert len(got.contours) >= 3
    assert got.page_coord == want.page_coord == plain.page_coord
    assert got.slopes == want.slopes == plain.slopes
    assert _strip(got.xml_tree) == _strip(want.xml_tree) \
        == _strip(plain.xml_tree)


def test_failed_fused_rung_falls_to_headless_then_raw(bundles,  # noqa: F811
                                                      monkeypatch):
    """Both flags on: a failing fully-fused call is counted and the
    headless rung serves; with both failing, the raw path does."""
    _, tb = bundles
    cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(
        CFG.runtime, device_page_box=True, fused_page_box=True))
    image = _page(0, 210, 170)
    clean = detector.TextlineDetector(tb, CFG).process_image(image, "p.png")
    monkeypatch.setattr(tb.region, "predict_dual_tiled_resident_raw_fullfused",
                        _boom)
    det = detector.TextlineDetector(tb, cfg)
    got = det.process_image(image, "p.png")
    assert det.fallbacks == {"fused_page_box": 1}
    assert _strip(got.xml_tree) == _strip(clean.xml_tree)
    monkeypatch.setattr(tb.page, "page_box_dev", _boom)
    det = detector.TextlineDetector(tb, cfg)
    got = det.process_image(image, "p.png")
    assert det.fallbacks == {"fused_page_box": 1, "device_page_box": 1}
    assert _strip(got.xml_tree) == _strip(clean.xml_tree)


def test_page_box_window_is_off_for_the_fetchfree_paths(bundles):  # noqa: F811
    _, tb = bundles
    for flags, want in (({}, 8), ({"device_page_box": True}, 0),
                        ({"fused_page_box": True}, 0)):
        cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(
            CFG.runtime, page_box_batch=8, **flags))
        assert detector.TextlineDetector(tb, cfg)._page_box_batch_size() \
            == want
