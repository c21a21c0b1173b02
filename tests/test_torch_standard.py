"""The standard segmentation path of the port against the JAX package:
`predict_dual_tiled` (crop upload), `predict_dual_tiled_resident` (canvas
upload) and `predict_tiled` (one model alone), then the detector end to
end with each of `raw_upload`, `resident_upload`, `resident_deskew` and
`textline_projection` switched off, and `run_file` / `run_files`.

Same weights, float32 on both sides, seeded numpy pages. Tolerances, as in
tests/test_torch_fused.py and tests/test_torch_classic.py (the busy-page
rule): the dual-head pages are chosen so that no stitched pixel has a
top-2 logit gap under 1e-4, and every output is then EQUAL; the classic
TpuUnet pair is compared where a pixel's logit gap exceeds 4x the
frameworks' measured f32 difference (the region mask beyond the
morphology's reach of any other pixel). Within the port the three forms
are bit-equal to `predict_dual_tiled_resident_raw` on the same crop."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import runner as jrunner
from sbb_textline_detection_tpu.ops import resize as jresize
from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu_torch.models import checkpoint, runner
from sbb_textline_detection_tpu_torch.models import registry as treg
from sbb_textline_detection_tpu_torch.pipeline import detector

from tests.test_torch_classic import (MORPH_REACH, REGION_RESNET,
                                      REGION_TINY, TEXTLINE_RESNET,
                                      TEXTLINE_TINY, _sure_pixels, jax_f32)
from tests.test_torch_detector import CFG, _page, _strip, bundles
from tests.test_torch_fused import (MORPH, POST, RT, _min_logit_gap,
                                    _raw_page, models)

SHAPING = dict(morph=MORPH, mask_class=1, post_morph=POST)
DUAL_CASES = [(8, (100, 90), [0, 0, 100, 90], False),
              (9, (110, 95), [6, 4, 90, 80], True)]


def _scaled(raw, th, tw):
    """The working image the host resize makes of `raw`, as RGB."""
    img = jresize.resize_nearest_host(raw, th, tw)
    return img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)


def _modes(keep_dev, proj):
    return dict(return_device_textline=keep_dev, textline_projection=proj)


def _assert_page_equal(got, want, box):
    """One fused-path tuple against another: region mask, then the
    textline mask or row sum, then the crop of the device canvas."""
    bh, bw = box[2], box[3]
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    if len(want) == 3:
        np.testing.assert_array_equal(
            np.asarray(got[2].cpu() if torch.is_tensor(got[2])
                       else got[2])[:bh, :bw],
            np.asarray(want[2].cpu() if torch.is_tensor(want[2])
                       else want[2])[:bh, :bw])


@pytest.mark.parametrize("keep_dev,proj", [(False, False), (True, False),
                                           (True, True)])
@pytest.mark.parametrize("seed,page_hw,box,gray", DUAL_CASES)
def test_dual_tiled_forms_match_jax(models, seed, page_hw, box, gray,
                                    keep_dev, proj):
    """Crop upload and canvas upload against the JAX functions, in the
    three output modes, and bit-equal to the port's raw form."""
    jm, tm = models
    raw = _raw_page(np.random.default_rng(seed), 130, 110, gray)
    th, tw = page_hw
    assert _min_logit_gap(jm, raw, box, th, tw) > 1e-4
    scaled = _scaled(raw, th, tw)
    by, bx, bh, bw = box
    crop = scaled[by:by + bh, bx:bx + bw]
    kw = dict(SHAPING, **_modes(keep_dev, proj))

    want = jm.predict_dual_tiled(jm, crop, **kw)
    got = tm.predict_dual_tiled(tm, crop, **kw)
    assert 0 < want[0].sum() < want[0].size
    _assert_page_equal(got, want, box)

    want_c = jm.predict_dual_tiled_resident(
        jm, [jm.upload_canvas(scaled)], [box], **kw)[0]
    got_c = tm.predict_dual_tiled_resident(
        tm, [tm.upload_canvas(scaled)], [box], **kw)[0]
    _assert_page_equal(got_c, want_c, box)

    own_raw = tm.predict_dual_tiled_resident_raw(
        tm, [tm.upload_raw(raw)], [box], [(th, tw)],
        raw_hws=[raw.shape[:2]], **kw)[0]
    _assert_page_equal(got, own_raw, box)
    _assert_page_equal(got_c, own_raw, box)


def test_upload_canvas_matches_jax(models):
    jm, tm = models
    scaled = _scaled(_raw_page(np.random.default_rng(1), 130, 110, False),
                     100, 90)
    np.testing.assert_array_equal(tm.upload_canvas(scaled).numpy(),
                                  np.asarray(jm.upload_canvas(scaled)))


def test_dual_tiled_rejects_what_jax_rejects(models):
    _, tm = models
    crop = _scaled(_raw_page(np.random.default_rng(1), 130, 110, False),
                   100, 90)
    with pytest.raises(ValueError, match="requires return_device_textline"):
        tm.predict_dual_tiled(tm, crop, textline_projection=True, **SHAPING)
    canvases = [tm.upload_canvas(crop)] * 2
    with pytest.raises(ValueError, match="multiple tile grids"):
        tm.predict_dual_tiled_resident(
            tm, canvases, [[0, 0, 100, 90], [0, 0, 40, 40]], **SHAPING)


@pytest.fixture(scope="module")
def classic(jax_f32):
    """(jax region, jax textline, port region, port textline) tiny
    TpuUnets, built as tests/test_torch_classic.py builds them."""
    made = []
    for spec, seed, nudge in ((REGION_TINY, 1, 0.5), (TEXTLINE_TINY, 6, 0.9)):
        v = jax.tree_util.tree_map(np.array,
                                   jreg.init_variables(spec, seed=seed))
        v["params"]["head"]["bias"][1] += nudge
        made.append((spec, v))
    return tuple(jrunner.SegmentationModel(s, v, RT) for s, v in made) + \
        tuple(runner.SegmentationModel(s, checkpoint.params_from_flax(v), RT,
                                       device="cpu", dtype=torch.float32)
              for s, v in made)


def _rgb_crop(seed, h, w):
    return _raw_page(np.random.default_rng(seed), h, w, False)


def test_predict_tiled_matches_jax(classic):
    """The separate per-model rung's two calls: the region model with
    pre_otsu and the mask shaping, the textline model on the raw crop;
    plus the plain label map with a label morph only."""
    from scipy.ndimage import maximum_filter

    jm_r, jm_t, tm_r, tm_t = classic
    crop = _rgb_crop(8, 100, 90)
    h, w = crop.shape[:2]
    sure_r, sure_t = _sure_pixels(jm_r, jm_t, tm_r, tm_t, crop,
                                  [0, 0, h, w], h, w)
    assert sure_r.mean() > 0.99 and sure_t.mean() > 0.99

    want = jm_r.predict_tiled(crop, pre_otsu=True, **SHAPING)
    got = tm_r.predict_tiled(crop, pre_otsu=True, **SHAPING)
    assert got.shape == want.shape == (h, w) and got.dtype == np.uint8
    assert 0 < want.sum() < want.size
    far = ~maximum_filter(~sure_r, size=2 * MORPH_REACH + 1)
    assert far.mean() > 0.5
    np.testing.assert_array_equal(got[far], want[far])

    want_t = jm_t.predict_tiled(crop)
    got_t = tm_t.predict_tiled(crop)
    assert want_t.any()
    np.testing.assert_array_equal(got_t[sure_t], want_t[sure_t])

    # label map + label morph, no class mask: compare beyond the reach of
    # MORPH (erode 1 + dilate 2 passes of radius 2)
    want_l = jm_t.predict_tiled(crop, morph=MORPH)
    got_l = tm_t.predict_tiled(crop, morph=MORPH)
    far_t = ~maximum_filter(~sure_t, size=2 * 6 + 1)
    np.testing.assert_array_equal(got_l[far_t], want_l[far_t])


def test_separate_models_equal_the_fused_pair(classic):
    """Within the port, predict_tiled per model gives what the fused
    classic pair gives on the same crop, bit for bit."""
    _, _, tm_r, tm_t = classic
    crop = _rgb_crop(5, 100, 90)
    fused_r, fused_t = tm_r.predict_dual_tiled(tm_t, crop, **SHAPING)
    np.testing.assert_array_equal(
        tm_r.predict_tiled(crop, pre_otsu=True, **SHAPING), fused_r)
    np.testing.assert_array_equal(tm_t.predict_tiled(crop), fused_t)


def test_resnet_pair_forms_are_bit_equal():
    """A 64x64-input ResNet50Unet pair: crop upload, canvas upload and
    the two separate calls equal the raw form on the same crop (the raw
    form is held against the JAX package in tests/test_torch_classic.py)."""
    tm_r, tm_t = (runner.SegmentationModel(
        treg.ModelSpec.from_meta(spec.to_meta()),
        checkpoint.random_init(treg.ModelSpec.from_meta(spec.to_meta()),
                               torch.Generator().manual_seed(seed)),
        RT, device="cpu") for spec, seed in ((REGION_RESNET, 1),
                                             (TEXTLINE_RESNET, 2)))
    assert tm_r.computes_f32 and tm_t.computes_f32
    raw = _rgb_crop(9, 130, 110)
    th, tw, box = 110, 95, [6, 4, 90, 80]
    scaled = _scaled(raw, th, tw)
    crop = scaled[6:96, 4:84]
    want = tm_r.predict_dual_tiled_resident_raw(
        tm_t, [tm_r.upload_raw(raw)], [box], [(th, tw)],
        raw_hws=[raw.shape[:2]], **SHAPING)[0]
    _assert_page_equal(tm_r.predict_dual_tiled(tm_t, crop, **SHAPING), want,
                       box)
    _assert_page_equal(tm_r.predict_dual_tiled_resident(
        tm_t, [tm_r.upload_canvas(scaled)], [box], **SHAPING)[0], want, box)
    np.testing.assert_array_equal(
        tm_r.predict_tiled(crop, pre_otsu=True, **SHAPING), want[0])
    np.testing.assert_array_equal(tm_t.predict_tiled(crop), want[1])


def _with_runtime(**flags):
    return dataclasses.replace(
        CFG, runtime=dataclasses.replace(CFG.runtime, **flags))


@pytest.mark.parametrize("flags", [
    dict(raw_upload=False), dict(resident_upload=False),
    dict(resident_deskew=False), dict(textline_projection=False),
    dict(raw_upload=False, resident_deskew=False),
    dict(resident_upload=False, textline_projection=False)],
    ids=lambda f: "-".join(f))
def test_process_image_with_flags_off_matches_jax(bundles, flags):
    """Each flag the port reads, switched off: the same page box, slopes,
    contours and PAGE-XML as the JAX detector under the same flags, with
    no rung counted as a fallback (the config asked for the path)."""
    jb, tb = bundles
    cfg = _with_runtime(**flags)
    image = _page(0, 210, 170)
    want = jdetector.TextlineDetector(jb, cfg).process_image(image, "p.png")
    det = detector.TextlineDetector(tb, cfg)
    got = det.process_image(image, "p.png")
    assert det.degraded == 0 and not got.degraded and not det.fallbacks
    assert len(want.contours) >= 3 and any(s != 0.0 for s in want.slopes)
    assert got.page_coord == want.page_coord
    assert got.slopes == want.slopes
    for a, b in zip(got.contours, want.contours):
        np.testing.assert_array_equal(a, b)
    assert _strip(got.xml_tree) == _strip(want.xml_tree)
    assert set(got.timings) == set(want.timings) | {"line_split"}


def test_run_file_and_run_files_paths(bundles, tmp_path):
    jb, tb = bundles
    paths = []
    for seed in (1, 2):
        p = tmp_path / f"scan_{seed}.png"
        Image.fromarray(_page(seed, 210, 170)).save(p)
        paths.append(str(p))
    det = detector.TextlineDetector(tb, CFG)
    out = tmp_path / "out"
    out.mkdir()
    (tmp_path / "out_jax").mkdir()
    got = list(det.run_files(paths, str(out)))
    want = list(jdetector.TextlineDetector(jb, CFG).run_files(
        paths, str(tmp_path / "out_jax")))
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["scan_1.xml", "scan_2.xml"]
    assert all(os.path.dirname(p) == str(out) for p in got)
    single = det.run_file(paths[0], str(out), "renamed")
    assert os.path.basename(single) == "renamed.xml"

    def body(p):
        import re
        return re.sub(rb"<Metadata>.*?</Metadata>", b"",
                      open(p, "rb").read(), flags=re.S)

    assert body(single) == body(got[0]) == body(want[0])
