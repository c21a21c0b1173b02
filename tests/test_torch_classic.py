"""The classic three-model bundle in the port against the JAX package: the
fused region + textline program (`predict_dual_tiled_resident_raw` with a
separate region and textline model, TpuUnet or ResNet50Unet), the
detector's `process_image`, `ModelBundle.from_dir` on `.npz` and Keras
`.h5` directories, and the CLI's `-m`. Same weights, float32 on both
sides, seeded numpy inputs."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.core.config import RuntimeConfig
from sbb_textline_detection_tpu.models import h5_import as jh5
from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import runner as jrunner
from sbb_textline_detection_tpu.models import unet as junet
from sbb_textline_detection_tpu.ops import resize as jresize
from sbb_textline_detection_tpu.ops import threshold as jthreshold
from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu_torch.models import checkpoint, runner
from sbb_textline_detection_tpu_torch.models import registry as treg
from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
from sbb_textline_detection_tpu_torch.ops import radon
from sbb_textline_detection_tpu_torch.pipeline import detector

from tests.h5_fixture import build_fake_keras_h5
from tests.test_torch_detector import CFG, PAGE_TINY, _page, _strip

REGION_TINY = jreg.ModelSpec("tiny_region", "tpu_unet", 64, 64, 3,
                             widths=(8, 16))
TEXTLINE_TINY = jreg.ModelSpec("tiny_textline", "tpu_unet", 64, 64, 2,
                               widths=(8, 16))
REGION_RESNET = jreg.ModelSpec("model_strukturerkennung", "resnet50_unet",
                               64, 64, 3)
TEXTLINE_RESNET = jreg.ModelSpec("model_textline_new", "resnet50_unet", 64,
                                 64, 2)
MORPH = (("erode", 5, 1), ("dilate", 5, 2))
POST = (("open", 5, 1), ("close", 5, 1))
RT = RuntimeConfig(batch_buckets=(2, 4, 8), tile_chunk=5)


def _f32_module(spec):
    if spec.arch == "resnet50_unet":
        return junet.ResNet50Unet(n_classes=spec.n_classes)
    return junet.TpuUnet(n_classes=spec.n_classes, widths=spec.widths,
                         dtype=jnp.float32)


def _resnet_vars(spec, seed):
    """A Flax ResNet50Unet variable tree drawn by the port with Flax's
    initialisers (a Flax init of the ResNet takes ~10 s here)."""
    sd = checkpoint.random_init(treg.ModelSpec.from_meta(
        spec.to_meta()), torch.Generator().manual_seed(seed))
    return checkpoint.flax_from_params(sd)


@pytest.fixture(scope="module")
def jax_f32():
    mp = pytest.MonkeyPatch()
    mp.setattr(jreg, "build_module", _f32_module)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def pairs(jax_f32):
    """{kind: (jax region, jax textline, port region, port textline)}."""
    out = {}
    tiny = (REGION_TINY, 1, 0.5), (TEXTLINE_TINY, 6, 0.9)
    resnet = (REGION_RESNET, 1, -0.2), (TEXTLINE_RESNET, 2, 0.0)
    for kind, roles in (("tpu_unet", tiny), ("resnet50_unet", resnet)):
        models = []
        for spec, seed, nudge in roles:
            v = (_resnet_vars(spec, seed) if spec.arch == "resnet50_unet"
                 else jax.tree_util.tree_map(
                     np.array, jreg.init_variables(spec, seed=seed)))
            v["params"]["head"]["bias"][1] += nudge
            models.append((spec, v))
        out[kind] = tuple(
            jrunner.SegmentationModel(s, v, RT) for s, v in models) + tuple(
            runner.SegmentationModel(s, checkpoint.params_from_flax(v), RT,
                                     device="cpu", dtype=torch.float32)
            for s, v in models)
    return out


def _raw_page(seed, h, w, color, noise=30):
    """Dark bars on noisy paper; a gray plane, or RGB with a tint that
    makes the three channels differ."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w), 215, np.int32)
    for y in range(8, h - 8, 12):
        img[y:y + 5, int(rng.integers(3, 15)):int(rng.integers(w // 2,
                                                                w - 3))] = 40
    img = np.clip(img + rng.integers(-noise, noise + 1, (h, w)), 0, 255)
    if not color:
        return img.astype(np.uint8)
    rgb = np.stack([img, img * 7 // 10, np.clip(img + 40, 0, 255)], -1)
    rgb[..., 2] = np.where(rng.uniform(size=(h, w)) < 0.2, 90, rgb[..., 2])
    return rgb.astype(np.uint8)


def _sure_pixels(jm_r, jm_t, tm_r, tm_t, raw, box, th, tw):
    """Per model, the crop's stitched pixels whose top-2 logit gap exceeds
    4x the largest |JAX - port| difference of their logits, on an
    independently rebuilt tile batch: there no argmax can flip between
    the frameworks."""
    mh, mw = jm_r.input_hw
    margin = int(0.1 * mw)
    sh, sw = mh - 2 * margin, mw - 2 * margin
    by, bx, bh, bw = box
    ny, nx = jm_r.grid_for(bh, bw)
    ch, cw = jm_r.canvas_shape_for(th, tw)
    rgb = raw if raw.ndim == 3 else raw[..., None].repeat(3, -1)
    iy = np.full(ch, -1)
    ix = np.full(cw, -1)
    iy[margin:margin + th] = jresize._nearest_indices(th, raw.shape[0])
    ix[margin:margin + tw] = jresize._nearest_indices(tw, raw.shape[1])
    canvas = rgb[np.clip(iy, 0, None)][:, np.clip(ix, 0, None)]
    yy, xx = np.arange(ch)[:, None], np.arange(cw)[None, :]
    inside = ((yy >= margin + by) & (yy < margin + by + bh)
              & (xx >= margin + bx) & (xx < margin + bx + bw))
    keep = (iy[:, None] >= 0) & (ix[None, :] >= 0) & inside
    canvas = np.where(keep[..., None], canvas, 255).astype(np.uint8)
    t = jthreshold.otsu_threshold_host(canvas[..., 0][inside])
    tiles = np.stack([
        canvas[min(by + j * sh, ch - mh):][:mh,
               min(bx + i * sw, cw - mw):][:, :mw]
        for j in range(ny) for i in range(nx)])
    binar = (tiles[..., 0].astype(np.int32) > t).astype(np.float32)
    out = []
    for jm, tm, x in ((jm_r, tm_r, np.repeat(binar[..., None], 3, -1)),
                      (jm_t, tm_t, tiles / np.float32(255.0))):
        x = np.asarray(x, np.float32)
        logits = np.asarray(jax.jit(_f32_module(jm.spec).apply)(
            jm.variables, jnp.asarray(x)))
        with torch.no_grad():
            err = np.abs(tm.module(torch.from_numpy(x)).numpy()
                         - logits).max(-1)
        srt = np.sort(logits, axis=-1)
        sure = (srt[..., -1] - srt[..., -2]) > 4 * err
        sure = (sure[:, margin:margin + sh, margin:margin + sw]
                .reshape(ny, nx, sh, sw).transpose(0, 2, 1, 3)
                .reshape(ny * sh, nx * sw))
        out.append(sure[:bh, :bw])
    return out


# how far a flipped label can reach through MORPH and POST (5x5 windows:
# erode 1 + dilate 2 + open 2 + close 2 passes of radius 2)
MORPH_REACH = 14


@pytest.mark.parametrize("kind,seed,color", [
    ("tpu_unet", 2, False), ("tpu_unet", 2, True),
    ("resnet50_unet", 9, True)])
def test_classic_fused_matches_jax(pairs, kind, seed, color):
    """On a gray plane and on a tinted RGB page: the textline canvas is
    equal at every pixel whose logit gap exceeds the frameworks' f32
    difference, the row sum on rows made of such pixels, and the region
    mask beyond the morphology's reach of any other pixel. The tiny
    TpuUnet's f32 logits differ by 2e-4 to 3e-2 between XLA and PyTorch
    (Flax GroupNorm's fast variance on near-constant tiles), so a few
    pixels fall out; the ResNet50Unet's agree to ~2e-6 and none does."""
    from scipy.ndimage import maximum_filter

    jm_r, jm_t, tm_r, tm_t = pairs[kind]
    raw = _raw_page(seed, 130, 110, color)
    box, (th, tw) = [6, 4, 90, 80], (110, 95)
    sure_r, sure_t = _sure_pixels(jm_r, jm_t, tm_r, tm_t, raw, box, th, tw)
    assert sure_r.mean() > 0.99 and sure_t.mean() > 0.99
    if kind == "resnet50_unet":
        assert sure_r.all() and sure_t.all()
    want_r, want_p, want_tl = jm_r.predict_dual_tiled_resident_raw(
        jm_t, [jm_r.upload_raw(raw)], [box], [(th, tw)], morph=MORPH,
        mask_class=1, post_morph=POST, return_device_textline=True,
        raw_hws=[raw.shape[:2]], textline_projection=True)[0]
    got_r, got_p, got_tl = tm_r.predict_dual_tiled_resident_raw(
        tm_t, [tm_r.upload_raw(raw)], [box], [(th, tw)], morph=MORPH,
        mask_class=1, post_morph=POST, return_device_textline=True,
        raw_hws=[raw.shape[:2]], textline_projection=True)[0]
    assert 0 < want_r.sum() < want_r.size and want_p.sum() > 0
    bh, bw = box[2], box[3]
    assert got_r.shape == want_r.shape == (bh, bw)
    assert tuple(got_tl.shape) == tuple(want_tl.shape)
    tl = np.asarray(want_tl)[:bh, :bw]
    np.testing.assert_array_equal(got_tl.numpy()[:bh, :bw][sure_t],
                                  tl[sure_t])
    rows = sure_t.all(1)
    assert rows.mean() > 0.5
    np.testing.assert_array_equal(got_p[rows], want_p[rows])
    far = ~maximum_filter(~sure_r, size=2 * MORPH_REACH + 1)
    assert far.mean() > 0.5
    np.testing.assert_array_equal(got_r[far], want_r[far])


def test_classic_pair_geometry_and_classes(pairs):
    jm_r, jm_t, tm_r, tm_t = pairs["tpu_unet"]
    assert tm_r.textline_n_classes(tm_t) == jm_r.textline_n_classes(jm_t) == 2
    bad = runner.SegmentationModel(
        dataclasses.replace(treg.ModelSpec.from_meta(
            TEXTLINE_TINY.to_meta()), input_height=96, input_width=96),
        tm_t.module.state_dict(), RT, device="cpu", dtype=torch.float32)
    raw = _raw_page(0, 130, 110, False)
    with pytest.raises(ValueError, match="identical geometry"):
        tm_r.predict_dual_tiled_resident_raw(
            bad, [tm_r.upload_raw(raw)], [[0, 0, 90, 80]], [(110, 95)],
            mask_class=1)


@pytest.fixture(scope="module")
def bundles(jax_f32):
    pv = jreg.init_variables(PAGE_TINY, seed=0)
    roles = []
    for spec, seed, nudge in ((REGION_TINY, 1, 0.5), (TEXTLINE_TINY, 6, 0.9)):
        v = jax.tree_util.tree_map(np.array,
                                   jreg.init_variables(spec, seed=seed))
        v["params"]["head"]["bias"][1] += nudge
        roles.append((spec, v))
    rt = CFG.runtime
    jb = jrunner.ModelBundle(*(jrunner.SegmentationModel(s, v, rt) for s, v
                               in [(PAGE_TINY, pv)] + roles))
    tb = ModelBundle.from_jax_variables((PAGE_TINY, pv), *roles, runtime=rt,
                                        device="cpu", dtype=torch.float32)
    return jb, tb


def _tint(img):
    out = img.astype(np.int32)
    out[..., 1] = out[..., 1] * 9 // 10
    out[..., 2] = np.clip(out[..., 2] + 25, 0, 255)
    return out.astype(np.uint8)


@pytest.mark.parametrize("seed,color", [(0, False), (3, True)])
def test_process_image_classic_matches_jax(bundles, seed, color):
    """Page box, slopes, contours and PAGE-XML equal the JAX package's; on
    the CPU the deskew chain takes the Radon kernel's plain version."""
    jb, tb = bundles
    assert not tb.is_dual_head
    image = _page(seed, 210, 170)
    if color:
        image = _tint(image)
        assert not detector._channels_identical(image)
    want = jdetector.TextlineDetector(jb, CFG).process_image(image, "p.png")
    det = detector.TextlineDetector(tb, CFG)
    radon.launches = 0
    got = det.process_image(image, "p.png")
    assert radon.launches == 0
    assert det.degraded == 0 and not got.degraded
    assert len(want.contours) >= 3, "the page must reach the deskew chain"
    assert sum(s != 0.0 for s in want.slopes) >= 3
    assert got.page_coord == want.page_coord
    assert got.slopes == want.slopes
    assert len(got.contours) == len(want.contours)
    for a, b in zip(got.contours, want.contours):
        np.testing.assert_array_equal(a, b)
    assert _strip(got.xml_tree) == _strip(want.xml_tree)


def test_rgb_upload_only_for_coloured_classic_pages(bundles, monkeypatch):
    """The classic bundle ships one plane for a gray page stored as RGB and
    the three channels of a coloured one."""
    _, tb = bundles
    shipped = []
    real = tb.region.upload_raw

    def record(image):
        shipped.append(image.shape)
        return real(image)

    monkeypatch.setattr(tb.region, "upload_raw", record)
    det = detector.TextlineDetector(tb, CFG)
    gray = _page(1, 200, 160)
    for img in (gray, _tint(gray)):
        det.process_image(img, "p.png")
    assert shipped == [(200, 160), (200, 160, 3)]


@pytest.mark.parametrize("dual_head", [False, True])
def test_random_init_builds_either_layout(dual_head):
    specs = {"page": PAGE_TINY, "region": REGION_TINY,
             "textline": TEXTLINE_TINY}
    b = ModelBundle.random_init(seed=3, device="cpu", specs=specs,
                                dual_head=dual_head)
    assert b.is_dual_head == dual_head
    assert b.page.spec.to_meta() == PAGE_TINY.to_meta()
    if dual_head:
        assert b.region is b.textline and b.region.spec.heads == (3, 2)
    else:
        assert b.textline.spec.to_meta() == TEXTLINE_TINY.to_meta()
        want = treg.init_variables(b.region.spec, 3)
        got = b.region.module.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)


def _save_classic(model_dir, specs_seeds):
    saved = {}
    for role, (spec, seed) in specs_seeds.items():
        tspec = treg.ModelSpec.from_meta(spec.to_meta())
        sd = checkpoint.random_init(tspec, torch.Generator().manual_seed(seed))
        checkpoint.save(os.path.join(model_dir, spec.name + ".npz"), tspec, sd)
        saved[role] = (tspec, sd)
    return saved


def test_from_dir_three_model_npz(tmp_path):
    """Page TpuUnet, region and textline ResNet50Unets under the default
    names: loaded as the classic bundle with the saved weights."""
    page = dataclasses.replace(PAGE_TINY, name="model_page_mixed_best")
    saved = _save_classic(str(tmp_path), {
        "page": (page, 0), "region": (REGION_RESNET, 1),
        "textline": (TEXTLINE_RESNET, 2)})
    b = ModelBundle.from_dir(str(tmp_path), device="cpu",
                             dtype=torch.float32)
    assert not b.is_dual_head and b.region is not b.textline
    for role, (spec, sd) in saved.items():
        m = getattr(b, role)
        assert m.spec == spec
        got = m.module.state_dict()
        assert all(torch.equal(got[k], sd[k]) for k in sd), role


def test_cli_and_from_dir_serve_an_h5_directory(tmp_path, monkeypatch):
    """`-m` on a directory of the three upstream-named Keras .h5 files
    converts each on load, caches it as its .npz sibling and writes a
    PAGE-XML; from_dir then loads the weights the JAX importer reads from
    the same files."""
    import xml.etree.ElementTree as ET

    from click.testing import CliRunner
    from PIL import Image

    from sbb_textline_detection_tpu_torch import cli
    from sbb_textline_detection_tpu_torch.core.config import (
        DEFAULT_CONFIG, DeskewConfig, ResizePolicy)

    rng = np.random.default_rng(4)
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    trees = {}
    for spec in (dataclasses.replace(REGION_RESNET,
                                     name="model_page_mixed_best",
                                     n_classes=2),
                 REGION_RESNET, TEXTLINE_RESNET):
        tree = _resnet_vars(spec, 0)
        path = str(model_dir / f"{spec.name}.h5")
        build_fake_keras_h5(path, tree, rng, with_model_config=(64, 64))
        trees[spec.name] = jh5.import_h5(path, tree)[0]

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, resize=ResizePolicy(100, 64, 1.0),
        deskew=DeskewConfig(coarse_steps=8, vertical_steps=4),
        runtime=dataclasses.replace(DEFAULT_CONFIG.runtime, tile_chunk=4,
                                    deskew_canvas=256))
    monkeypatch.setattr(cli, "DEFAULT_CONFIG", cfg)
    img = tmp_path / "page.png"
    Image.fromarray(_page(2, 80, 60)).save(img)
    out = tmp_path / "out"
    out.mkdir()
    res = CliRunner().invoke(cli.main, ["-i", str(img), "-o", str(out), "-m",
                                        str(model_dir), "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert ET.parse(str(out / "page.xml")).getroot().tag.endswith("PcGts")
    for name in trees:
        assert (model_dir / f"{name}.npz").exists()

    b = ModelBundle.from_dir(str(model_dir), device="cpu")
    assert (b.page.spec.n_classes, b.region.spec.n_classes,
            b.textline.spec.n_classes) == (2, 3, 2)
    for role in ("page", "region", "textline"):
        m = getattr(b, role)
        assert m.spec.arch == "resnet50_unet" and m.input_hw == (64, 64)
        want = checkpoint.params_from_flax(trees[m.spec.name])
        got = m.module.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want), role
