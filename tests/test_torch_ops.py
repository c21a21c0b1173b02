"""The port's device ops (on CPU tensors) against the JAX package's: same
numpy inputs from seeds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.models import runner as jrunner
from sbb_textline_detection_tpu.ops import morphology as jmorph
from sbb_textline_detection_tpu.ops import profiles as jprofiles
from sbb_textline_detection_tpu.ops import threshold as jthreshold
from sbb_textline_detection_tpu.pipeline import deskew as jdeskew
from sbb_textline_detection_tpu_torch.ops import morphology, profiles
from sbb_textline_detection_tpu_torch.ops import threshold
from sbb_textline_detection_tpu_torch.pipeline import deskew


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_otsu_masked_bit_equal(seed):
    rng = np.random.default_rng(seed)
    img = np.clip(rng.normal(150, 50, (97, 83)), 0, 255).astype(np.uint8)
    img[:40, :30] = rng.integers(0, 60, (40, 30))
    mask = rng.uniform(size=img.shape) < 0.7
    want = int(jthreshold.otsu_threshold_masked(jnp.asarray(img),
                                                jnp.asarray(mask)))
    got = int(threshold.otsu_threshold_masked(torch.from_numpy(img),
                                              torch.from_numpy(mask)))
    assert got == want == jthreshold.otsu_threshold_host(img[mask])


@pytest.mark.parametrize("op,k,it", [("erode", 5, 1), ("erode", 5, 3),
                                     ("dilate", 5, 2), ("dilate", 3, 1)])
def test_erode_dilate_bit_equal(op, k, it):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 3, (61, 47)).astype(np.uint8)
    want = np.asarray(getattr(jmorph, op)(jnp.asarray(img), k, it))
    got = getattr(morphology, op)(torch.from_numpy(img), k, it).numpy()
    np.testing.assert_array_equal(got, want)


def test_apply_morph_neutral_fill_bit_equal():
    """runner._apply_morph's inside-mask neutral fill per primitive."""
    rng = np.random.default_rng(5)
    canvas = rng.integers(0, 3, (70, 64)).astype(np.uint8)
    inside = np.zeros(canvas.shape, bool)
    inside[:53, :41] = True
    ops = (("erode", 5, 3), ("dilate", 5, 4), ("open", 5, 1),
           ("close", 5, 1))
    want = np.asarray(jrunner.SegmentationModel._apply_morph(
        jrunner.SegmentationModel, jnp.asarray(canvas), ops,
        jnp.asarray(inside)))
    got = morphology.apply_morph(torch.from_numpy(canvas), ops,
                                 torch.from_numpy(inside)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [5, 9])
def test_sep_filters_bit_equal(k):
    rng = np.random.default_rng(k)
    x = (rng.uniform(size=(3, 40, 52)) < 0.6).astype(np.uint8)
    np.testing.assert_array_equal(
        deskew._min_sep_u8(torch.from_numpy(x), k).numpy(),
        np.asarray(jdeskew._min_sep_u8(jnp.asarray(x), k)))
    np.testing.assert_array_equal(
        deskew._max_sep_u8(torch.from_numpy(x), k).numpy(),
        np.asarray(jdeskew._max_sep_u8(jnp.asarray(x), k)))


@pytest.mark.parametrize("h,w,s", [(40, 90, 256), (300, 120, 256),
                                   (365, 365, 512), (1, 7, 256),
                                   (900, 1400, 512)])
def test_canvas_index_maps_equal(h, w, s):
    got = deskew._canvas_index_maps(h, w, s, 1.4)
    want = jdeskew._canvas_index_maps(h, w, s, 1.4)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _profiles(seed, n=6, s=256):
    """Projection-like profiles: integer bumps plus flat plateaus."""
    rng = np.random.default_rng(seed)
    P = np.zeros((n, s), np.float32)
    for i in range(n):
        for c in rng.integers(10, s - 10, 8):
            P[i, c - 4:c + 4] += rng.integers(5, 60)
    P[:, 100:140] = 17.0
    return P


def test_gaussian_filter1d_close():
    """f32 taps summed in another order than XLA's conv: rtol 1e-5."""
    P = _profiles(0)
    want = np.asarray(jprofiles.gaussian_filter1d(jnp.asarray(P), 2.0))
    got = profiles.gaussian_filter1d(torch.from_numpy(P), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_peak_mask_equal():
    """On integer-valued profiles with plateaus the masks agree exactly
    (the peak finder compares neighbours, so only exact data is a fair
    test)."""
    P = np.round(_profiles(1))
    P[:, 50:58] = P[:, 49:50] + 3.0   # an interior plateau peak
    want = np.asarray(jprofiles.peak_mask(jnp.asarray(P)))
    got = profiles.peak_mask(torch.from_numpy(P)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any()


def test_score_profiles_close():
    """[valid, score] of the deskew scorer: valid equal, score rtol 1e-5."""
    P = _profiles(2, n=12)
    want = np.asarray(jdeskew._score_profiles_impl(jnp.asarray(P)))
    got = deskew._score_profiles_impl(torch.from_numpy(P)).numpy()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    assert want[0].any()
