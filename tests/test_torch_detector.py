"""The port's single-page main path end to end against the JAX package's
TextlineDetector.process_image (raw-upload path, resident deskew), with
the same weights and float32 on both sides: page box, slopes, contours and
the PAGE-XML (minus <Metadata>) must be equal."""

import dataclasses
import re
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.core.config import (DEFAULT_CONFIG,
                                                    DeskewConfig,
                                                    ResizePolicy)
from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import runner as jrunner
from sbb_textline_detection_tpu.models import unet as junet
from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
from sbb_textline_detection_tpu_torch.ops import radon
from sbb_textline_detection_tpu_torch.pipeline import detector

DUAL_TINY = jreg.ModelSpec("tiny_dual", "tpu_unet", 64, 64, 5,
                           widths=(8, 16), heads=(3, 2), in_channels=2)
PAGE_TINY = jreg.ModelSpec("tiny_page", "tpu_unet", 64, 64, 2,
                           widths=(8, 16))

CFG = dataclasses.replace(
    DEFAULT_CONFIG,
    resize=ResizePolicy(300, 240, 1.0),
    deskew=DeskewConfig(coarse_steps=6, vertical_steps=4),
    runtime=dataclasses.replace(DEFAULT_CONFIG.runtime,
                                batch_buckets=(2, 4, 8), deskew_canvas=256))


def _f32_module(spec):
    return junet.TpuUnet(n_classes=spec.n_classes, widths=spec.widths,
                         dtype=jnp.float32)


@pytest.fixture(scope="module")
def bundles():
    mp = pytest.MonkeyPatch()
    mp.setattr(jreg, "build_module", _f32_module)
    try:
        pv = jreg.init_variables(PAGE_TINY, seed=0)
        dv = jax.tree_util.tree_map(np.array,
                                    jreg.init_variables(DUAL_TINY, seed=1))
        # random weights rarely pick the text classes; nudge both heads'
        # class-1 logits so the page carries several regions with lines
        dv["params"]["head"]["bias"][1] += 0.3
        dv["params"]["head"]["bias"][4] += 0.6
        rt = CFG.runtime
        dual = jrunner.SegmentationModel(DUAL_TINY, dv, rt)
        jb = jrunner.ModelBundle(jrunner.SegmentationModel(PAGE_TINY, pv, rt),
                                 dual, dual)
        tb = ModelBundle.from_jax_variables(pv, dv, PAGE_TINY, DUAL_TINY,
                                            runtime=rt, device="cpu",
                                            dtype=torch.float32)
        yield jb, tb
    finally:
        mp.undo()


def _page(seed, h, w):
    """Dark text-like bars on noisy paper. The noise keeps every tile's
    activations far from constant: Flax GroupNorm's variance E[x^2] -
    E[x]^2 is rounding noise on a near-constant tile, and the two
    frameworks' differently ordered sums would then disagree by ~1e-3."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 215, np.int32)
    for y in range(20, h - 20, 14):
        x0 = int(rng.integers(10, 30))
        x1 = int(rng.integers(w // 2, w - 10))
        img[y:y + 6, x0:x1] = int(rng.integers(20, 60))
    img = img + rng.integers(-30, 31, (h, w, 1))
    return np.clip(img, 0, 255).astype(np.uint8)


def _strip(tree):
    return re.sub(rb"<Metadata>.*?</Metadata>", b"",
                  ET.tostring(tree.getroot()), flags=re.S)


@pytest.mark.parametrize("seed,hw", [(0, (210, 170)), (3, (210, 170))])
def test_process_image_matches_jax(bundles, seed, hw):
    jb, tb = bundles
    image = _page(seed, *hw)
    want = jdetector.TextlineDetector(jb, CFG).process_image(image, "p.png")
    det = detector.TextlineDetector(tb, CFG)
    got = det.process_image(image, "p.png")
    assert det.degraded == 0 and not got.degraded
    assert len(want.contours) >= 3, "the page must reach the deskew chain"
    assert any(s != 0.0 for s in want.slopes)
    assert got.page_coord == want.page_coord
    assert got.slopes == want.slopes
    assert len(got.contours) == len(want.contours)
    for a, b in zip(got.contours, want.contours):
        np.testing.assert_array_equal(a, b)
    assert _strip(got.xml_tree) == _strip(want.xml_tree)


def test_process_batch_is_sequential_process_image(bundles):
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)
    pages = [(_page(s, 200, 160), f"p{s}.png") for s in (1, 2)]
    radon.launches = 0
    batch = list(det.process_batch(pages))
    assert radon.launches == 0, "CPU tensors take the plain version"
    single = [det.process_image(img, name) for img, name in pages]
    assert [r.slopes for r in batch] == [r.slopes for r in single]
    assert [_strip(r.xml_tree) for r in batch] == \
        [_strip(r.xml_tree) for r in single]


def test_degraded_page_still_writes_xml(bundles, monkeypatch):
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)

    def boom(*a, **k):
        raise RuntimeError("injected")

    monkeypatch.setattr(det.models.region, "predict_dual_tiled_resident_raw",
                        boom)
    res = det.process_image(_page(0, 200, 160), "p.png")
    assert res.degraded and det.degraded == 1
    assert res.contours == [] and b"PcGts" in ET.tostring(
        res.xml_tree.getroot())
