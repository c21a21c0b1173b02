"""The port's fused dual-head segmentation program against the JAX
package's predict_dual_tiled_resident_raw (projection mode, resident
textline canvas), same weights, float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.core.config import RuntimeConfig
from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import runner as jrunner
from sbb_textline_detection_tpu.models import unet as junet
from sbb_textline_detection_tpu.ops import resize as jresize
from sbb_textline_detection_tpu.ops import threshold as jthreshold
from sbb_textline_detection_tpu_torch.models import checkpoint
from sbb_textline_detection_tpu_torch.models import runner

DUAL_TINY = jreg.ModelSpec("tiny_dual", "tpu_unet", 64, 64, 5,
                           widths=(8, 16), heads=(3, 2), in_channels=2)
MORPH = (("erode", 5, 1), ("dilate", 5, 2))
POST = (("open", 5, 1), ("close", 5, 1))
RT = RuntimeConfig(batch_buckets=(2, 4, 8), tile_chunk=5)


def _f32_module(spec):
    return junet.TpuUnet(n_classes=spec.n_classes, widths=spec.widths,
                         dtype=jnp.float32)


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    mp.setattr(jreg, "build_module", _f32_module)
    try:
        dv = jax.tree_util.tree_map(np.array,
                                    jreg.init_variables(DUAL_TINY, seed=2))
        dv["params"]["head"]["bias"][1] += 0.3
        jm = jrunner.SegmentationModel(DUAL_TINY, dv, RT)
        tm = runner.SegmentationModel(DUAL_TINY,
                                      checkpoint.params_from_flax(dv), RT,
                                      device="cpu", dtype=torch.float32)
        yield jm, tm
    finally:
        mp.undo()


def _raw_page(rng, h, w, gray):
    """Dark bars on noisy paper (noise keeps GroupNorm well conditioned,
    see tests/test_torch_detector.py)."""
    img = np.full((h, w), 215, np.int32)
    for y in range(8, h - 8, 12):
        img[y:y + 5, int(rng.integers(3, 15)):int(rng.integers(w // 2,
                                                                w - 3))] = 40
    img = np.clip(img + rng.integers(-30, 31, (h, w)), 0, 255)
    img = img.astype(np.uint8)
    return img if gray else np.repeat(img[..., None], 3, axis=-1)


def _min_logit_gap(jm, raw, box, th, tw):
    """Smallest top-2 logit gap of either head over the crop's stitched
    pixels, from the JAX module on an independently rebuilt tile batch."""
    mh, mw = jm.input_hw
    margin = int(0.1 * mw)
    sh, sw = mh - 2 * margin, mw - 2 * margin
    by, bx, bh, bw = box
    ny, nx = jm.grid_for(bh, bw)
    ch, cw = jm.canvas_shape_for(th, tw)
    plane = raw if raw.ndim == 2 else raw[..., 0]
    iy = np.full(ch, -1)
    ix = np.full(cw, -1)
    iy[margin:margin + th] = jresize._nearest_indices(th, plane.shape[0])
    ix[margin:margin + tw] = jresize._nearest_indices(tw, plane.shape[1])
    canvas = plane[np.clip(iy, 0, None)][:, np.clip(ix, 0, None)]
    yy, xx = np.arange(ch)[:, None], np.arange(cw)[None, :]
    inside = ((yy >= margin + by) & (yy < margin + by + bh)
              & (xx >= margin + bx) & (xx < margin + bx + bw))
    canvas = np.where((iy[:, None] >= 0) & (ix[None, :] >= 0) & inside,
                      canvas, 255).astype(np.uint8)
    t = jthreshold.otsu_threshold_host(canvas[inside])
    tiles = np.stack([
        canvas[min(by + j * sh, ch - mh):][:mh,
               min(bx + i * sw, cw - mw):][:, :mw]
        for j in range(ny) for i in range(nx)])
    x = np.stack([tiles / np.float32(255.0),
                  (tiles.astype(np.int32) > t).astype(np.float32)], -1)
    logits = np.asarray(jax.jit(_f32_module(DUAL_TINY).apply)(
        jm.variables, jnp.asarray(x, jnp.float32)))
    gaps = []
    for lo, hi in ((0, 3), (3, 5)):
        srt = np.sort(logits[..., lo:hi], axis=-1)
        g = (srt[..., -1] - srt[..., -2])[:, margin:margin + sh,
                                          margin:margin + sw]
        g = (g.reshape(ny, nx, sh, sw).transpose(0, 2, 1, 3)
             .reshape(ny * sh, nx * sw))
        gaps.append(g[:bh, :bw].min())
    return float(min(gaps))


# page seeds chosen so that no stitched pixel of the crop has a top-2
# logit gap under 1e-4 (the f32 sums of XLA and PyTorch agree to ~1e-6)
@pytest.mark.parametrize("seed,page_hw,box,gray", [
    (8, (100, 90), [0, 0, 100, 90], False),
    (9, (110, 95), [6, 4, 90, 80], True),
])
def test_fused_matches_jax(models, seed, page_hw, box, gray):
    """Region mask, textline row sum and the crop of the resident textline
    canvas are equal. Outside the crop the tiles are white by
    construction, a constant input on which GroupNorm's variance is
    rounding noise, so the canvas is compared where the pipeline reads
    it."""
    jm, tm = models
    raw = _raw_page(np.random.default_rng(seed), 130, 110, gray)
    th, tw = page_hw
    assert _min_logit_gap(jm, raw, box, th, tw) > 1e-4
    want_r, want_p, want_tl = jm.predict_dual_tiled_resident_raw(
        jm, [jm.upload_raw(raw)], [box], [(th, tw)], morph=MORPH,
        mask_class=1, post_morph=POST, return_device_textline=True,
        raw_hws=[raw.shape[:2]], textline_projection=True)[0]
    got_r, got_p, got_tl = tm.predict_dual_tiled_resident_raw(
        tm, [tm.upload_raw(raw)], [box], [(th, tw)], morph=MORPH,
        mask_class=1, post_morph=POST, return_device_textline=True,
        raw_hws=[raw.shape[:2]], textline_projection=True)[0]
    assert 0 < want_r.sum() < want_r.size
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_p, want_p)
    bh, bw = box[2], box[3]
    assert tuple(got_tl.shape) == tuple(want_tl.shape)
    np.testing.assert_array_equal(got_tl.numpy()[:bh, :bw],
                                  np.asarray(want_tl)[:bh, :bw])


def test_balanced_chunk_matches_jax():
    for total in (1, 7, 54, 96, 97, 108, 300):
        for cap in (5, 16, 96):
            assert runner._balanced_chunk(total, cap) == \
                jrunner._balanced_chunk(total, cap)


def test_geometry_matches_jax(models):
    jm, tm = models
    for h, w in ((150, 120), (4209, 2975), (53, 52)):
        assert tm.grid_for(h, w) == jm.grid_for(h, w)
        assert tm.canvas_shape_for(h, w) == jm.canvas_shape_for(h, w)


def test_predict_small_prescaled_matches_jax():
    """The page model's whole-image forward + argmax (uniform noise input:
    every top-2 logit gap stays above 1e-4)."""
    spec = jreg.ModelSpec("tiny_page", "tpu_unet", 64, 64, 2, widths=(8, 16))
    pv = jreg.init_variables(spec, seed=0)
    small = np.random.default_rng(12).integers(0, 256, (64, 64, 3),
                                              dtype=np.uint8)
    logits = np.asarray(jax.jit(_f32_module(spec).apply)(
        pv, jnp.asarray(small[None].astype(np.float32) / 255.0)))[0]
    srt = np.sort(logits, -1)
    assert (srt[..., -1] - srt[..., -2]).min() > 1e-4
    tm = runner.SegmentationModel(spec, checkpoint.params_from_flax(pv), RT,
                                  device="cpu", dtype=torch.float32)
    np.testing.assert_array_equal(tm.predict_small_prescaled(small),
                                  np.argmax(logits, -1).astype(np.uint8))
