"""The pipelined batch of the port: the batched page-model forwards, the
multi-page fused segmentation, device_phase_group and process_batch,
against the JAX package on the same seeded pages with the same weights
(float32 on both sides). The port's own contracts inside a batch are in
tests/test_torch_batch_contracts.py.

Tolerance: none. Label maps, masks, page boxes, slopes, contours and the
PAGE-XML (without <Metadata>, its time stamps) are integer outputs and
must be EQUAL. Where a tiny f32 TpuUnet's argmax is compared directly,
the inputs are chosen so that no compared pixel has a top-2 logit gap
under 1e-4 (the rule of tests/test_torch_fused.py: XLA's and PyTorch's f32
sums agree to ~1e-6), and the test asserts that gap.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu.pipeline import stages as jstages
from sbb_textline_detection_tpu_torch.pipeline import detector, stages

from tests.test_torch_detector import CFG, _page, _strip, bundles
from tests.test_torch_fused import _min_logit_gap, _raw_page, models
from tests.test_torch_standard import SHAPING, _assert_page_equal, _scaled


def _boom(*a, **k):
    raise RuntimeError("injected")


def _cfg(**flags):
    return dataclasses.replace(
        CFG, runtime=dataclasses.replace(CFG.runtime, **flags))


def _pages():
    """Five busy pages of two sizes, ordered so that groups of two are
    one of a kind, then mixed, then a single tail page."""
    return [(_page(0, 210, 170), "p0.png"), (_page(3, 210, 170), "p3.png"),
            (_page(1, 200, 160), "p1.png"), (_page(5, 210, 170), "p5.png"),
            (_page(2, 200, 160), "p2.png")]


def _assert_results_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.page_coord == w.page_coord
        assert g.slopes == w.slopes
        assert len(g.contours) == len(w.contours)
        for a, b in zip(g.contours, w.contours):
            np.testing.assert_array_equal(a, b)
        assert _strip(g.xml_tree) == _strip(w.xml_tree)


# -- the batched page-model forwards -----------------------------------------

def _noise_smalls(seed, k):
    return np.random.default_rng(seed).integers(0, 256, (k, 64, 64, 3),
                                                dtype=np.uint8)


def test_predict_smalls_prescaled_batch_matches_jax(bundles):
    """K inputs in one forward: equal to the JAX function's label maps
    (which pads the batch to `pad_to`) and to K single forwards."""
    jb, tb = bundles
    smalls = _noise_smalls(12, 3)
    with torch.no_grad():
        logits = tb.page.module.forward_nchw(
            torch.from_numpy(smalls).to(torch.float32).permute(0, 3, 1, 2)
            / 255.0)
    top2 = torch.topk(logits, 2, dim=1).values
    assert float((top2[:, 0] - top2[:, 1]).min()) > 1e-4
    want = jb.page.predict_smalls_prescaled_batch(smalls, pad_to=4)
    got = tb.page.predict_smalls_prescaled_batch(smalls, pad_to=4)
    assert got.shape == want.shape == (3, 64, 64) and got.dtype == np.uint8
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got, want)
    for one, small in zip(got, smalls):
        np.testing.assert_array_equal(
            tb.page.predict_small_prescaled(small), one)
    with pytest.raises(ValueError, match="expected"):
        tb.page.predict_smalls_prescaled_batch(smalls[:, :32])


def test_predict_whole_small_batch_matches_jax(bundles):
    jb, tb = bundles
    imgs = [_page(s, 200, 160) for s in (1, 2)] + [_page(0, 210, 170)]
    want = jb.page.predict_whole_small_batch(imgs)
    got = tb.page.predict_whole_small_batch(imgs)
    np.testing.assert_array_equal(got, want)
    for one, img in zip(got, imgs):
        np.testing.assert_array_equal(tb.page.predict_whole_small(img), one)


def test_extract_page_batch_matches_jax(bundles):
    """Crops, page_coord and cont_page equal the JAX function's and K
    single extract_page calls."""
    jb, tb = bundles
    imgs = [img for img, _ in _pages()[:3]]
    want = jstages.extract_page_batch(
        [jstages.scale_image(im, CFG) for im in imgs], jb, CFG)
    scaleds = [stages.scale_image(im, CFG) for im in imgs]
    got = stages.extract_page_batch(scaleds, tb, CFG)
    assert len(got) == len(want) == 3
    for (g_crop, g_coord, g_cont), (w_crop, w_coord, w_cont), s in zip(
            got, want, scaleds):
        assert g_coord == w_coord
        np.testing.assert_array_equal(g_cont, w_cont)
        np.testing.assert_array_equal(g_crop, w_crop)
        one = stages.extract_page(s, tb, CFG)
        assert one[1] == g_coord
        np.testing.assert_array_equal(one[0], g_crop)
    h, w = scaleds[0].image.shape[:2]
    assert got[0][1] != [0, h - 1, 0, w - 1], "a real box, not the fallback"


def test_extract_page_batch_falls_back_per_page(bundles, monkeypatch):
    """A failed batched forward is counted and the pages run their own
    forwards; a failed box decision gives that page the whole image."""
    _, tb = bundles
    scaleds = [stages.scale_image(im, CFG) for im, _ in _pages()[:2]]
    clean = stages.extract_page_batch(scaleds, tb, CFG)
    seen = []
    monkeypatch.setattr(tb.page, "predict_whole_small_batch", _boom)
    got = stages.extract_page_batch(scaleds, tb, CFG, on_fallback=seen.append)
    assert seen == ["page_box_batch"]
    assert [g[1] for g in got] == [c[1] for c in clean]
    monkeypatch.undo()
    monkeypatch.setattr(stages, "_page_box_model_res", _boom)
    got = stages.extract_page_batch(scaleds, tb, CFG, on_fallback=seen.append)
    assert seen[1:] == ["whole_page_box"] * 2
    for g, s in zip(got, scaleds):
        h, w = s.image.shape[:2]
        assert g[1] == [0, h - 1, 0, w - 1]


# -- the multi-page fused segmentation -----------------------------------------

MULTI_SEEDS = (8, 17, 9)


def _multi_crops(jm):
    crops = []
    for seed in MULTI_SEEDS:
        raw = _raw_page(np.random.default_rng(seed), 130, 110, False)
        assert _min_logit_gap(jm, raw, [0, 0, 100, 90], 100, 90) > 1e-4
        crops.append(_scaled(raw, 100, 90))
    return crops


@pytest.mark.parametrize("keep_dev,proj", [(False, False), (True, False),
                                           (True, True)])
def test_predict_dual_tiled_multi_matches_jax(models, keep_dev, proj):
    """Three crops of one grid as one tile batch (the JAX function runs
    the 12 tiles in 3 chunks of 4 across the pages, the port each page's
    4 in a chunk of its own): equal to the JAX function and to three
    predict_dual_tiled calls of the port, in every output mode."""
    jm, tm = models
    crops = _multi_crops(jm)
    kw = dict(SHAPING, return_device_textline=keep_dev,
              textline_projection=proj)
    want = jm.predict_dual_tiled_multi(jm, crops, **kw)
    got = tm.predict_dual_tiled_multi(tm, crops, **kw)
    assert len(got) == len(want) == 3
    for g, w, crop in zip(got, want, crops):
        assert 0 < w[0].sum() < w[0].size
        _assert_page_equal(g, w, [0, 0, 100, 90])
        _assert_page_equal(g, tm.predict_dual_tiled(tm, crop, **kw),
                           [0, 0, 100, 90])


def test_predict_dual_tiled_multi_rejects_mixed_grids(models):
    jm, tm = models
    crop = _multi_crops(jm)[0]
    for m in (jm, tm):
        with pytest.raises(ValueError, match="multiple tile grids"):
            m.predict_dual_tiled_multi(m, [crop, crop[:40, :40]], **SHAPING)
    one = tm.predict_dual_tiled_multi(tm, [crop], **SHAPING)
    _assert_page_equal(one[0], tm.predict_dual_tiled(tm, crop, **SHAPING),
                       [0, 0, 100, 90])


def test_new_entry_points_build_no_graph(models, bundles):
    """torch.no_grad is thread-local: an entry point called on a fresh
    thread must still run without autograd."""
    _, tm = models
    page = bundles[1].page
    seen, errors = [], []

    def spied(module):
        real = module.forward_nchw

        def spy(x):
            seen.append(torch.is_grad_enabled())
            return real(x)

        module.forward_nchw = spy

    def run():
        try:
            tm.predict_dual_tiled_multi(tm, [crop, crop], **SHAPING)
            page.predict_smalls_prescaled_batch(_noise_smalls(1, 2))
        except Exception as exc:
            errors.append(exc)

    crop = _scaled(_raw_page(np.random.default_rng(8), 130, 110, False),
                   100, 90)
    spied(tm.module)
    spied(page.module)
    try:
        th = threading.Thread(target=run)
        th.start()
        th.join(120)
    finally:
        del tm.module.forward_nchw, page.module.forward_nchw
    assert not th.is_alive() and not errors
    assert len(seen) >= 3 and not any(seen)


# -- process_batch against the JAX package ---------------------------------------

_JAX_BATCH = {}


def _jax_batch(jb, box_batch, per_dispatch):
    """The JAX process_batch over _pages(); it does not depend on the
    worker count (scheduling only), so one run serves both."""
    key = (box_batch, per_dispatch)
    if key not in _JAX_BATCH:
        cfg = _cfg(page_box_batch=box_batch, pages_per_dispatch=per_dispatch)
        _JAX_BATCH[key] = list(jdetector.TextlineDetector(jb, cfg)
                               .process_batch(iter(_pages())))
    return _JAX_BATCH[key]


@pytest.mark.parametrize("per_dispatch", [1, 2])
@pytest.mark.parametrize("box_batch", [0, 3])
@pytest.mark.parametrize("workers", [1, 2])
def test_process_batch_matches_jax(bundles, workers, box_batch, per_dispatch):
    """Five pages (a tail window of 2 behind a window of 3; groups of two
    alike, two unlike, one alone): page box, slopes, contours and PAGE-XML
    equal the JAX process_batch under the same config."""
    jb, tb = bundles
    want = _jax_batch(jb, box_batch, per_dispatch)
    det = detector.TextlineDetector(tb, _cfg(
        device_phase_workers=workers, page_box_batch=box_batch,
        pages_per_dispatch=per_dispatch))
    got = list(det.process_batch(iter(_pages())))
    assert all(len(w.contours) >= 3 for w in want)
    assert any(s != 0.0 for w in want for s in w.slopes)
    _assert_results_equal(got, want)
    assert det.degraded == 0 and not det.fallbacks
    assert not any(r.degraded for r in got)
