"""How the port behaves when something is off or fails, held against the
JAX package under the same condition:

  * float32 models run with TF32 off (ops/precision.full_f32), bf16 ones
    are left alone;
  * every RuntimeConfig flag is read: the four that the port once
    refused build a detector that serves a page as the JAX detector does;
  * an injected failure at each point of a page degrades exactly as far
    as the JAX detector degrades under the same failure (PAGE-XML equal),
    each rung that gave way is counted in `fallbacks`, and a page that a
    lower rung served keeps its regions and lines.
"""

import dataclasses

import pytest
import torch

from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu_torch.core.config import (DEFAULT_CONFIG,
                                                          RuntimeConfig)
from sbb_textline_detection_tpu_torch.models import checkpoint, runner, unet
from sbb_textline_detection_tpu_torch.models import registry as treg
from sbb_textline_detection_tpu_torch.ops import precision
from sbb_textline_detection_tpu_torch.pipeline import detector

from tests.test_torch_classic import bundles as classic_bundles
from tests.test_torch_classic import jax_f32
from tests.test_torch_detector import CFG, _page, _strip, bundles

SHAPING = dict(morph=(("erode", 5, 1),), mask_class=1,
               post_morph=(("open", 5, 1),))


def _boom(*a, **k):
    raise RuntimeError("injected")


# -- A1: TF32 off around float32 forwards -----------------------------------

@pytest.fixture
def tf32_on():
    """Both TF32 switches on, as a user's process may have them."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _tf32():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def test_full_f32_sets_and_restores_both_flags(tf32_on):
    with precision.full_f32():
        assert _tf32() == (False, False)
        with precision.full_f32():
            assert _tf32() == (False, False)
        assert _tf32() == (False, False)
    assert _tf32() == (True, True)
    with pytest.raises(RuntimeError, match="injected"):
        with precision.full_f32():
            _boom()
    assert _tf32() == (True, True)
    torch.backends.cudnn.allow_tf32 = False
    with precision.full_f32():
        pass
    assert _tf32() == (True, False), "each flag goes back to its own value"


def _spied_model(spec, dtype, seen):
    spec = treg.ModelSpec.from_meta(spec.to_meta())
    model = runner.SegmentationModel(
        spec, checkpoint.random_init(spec, torch.Generator().manual_seed(0)),
        CFG.runtime, device="cpu", dtype=dtype)
    real = model.module.forward_nchw

    def spy(x):
        seen.append(_tf32())
        return real(x)

    model.module.forward_nchw = spy
    return model


ENTRY_POINTS = ["predict_small_prescaled", "predict_whole_small",
                "page_box_dev", "predict_tiled", "predict_dual_tiled",
                "predict_dual_tiled_resident",
                "predict_dual_tiled_resident_raw"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_forwards_run_in_full_f32(tf32_on, entry, dtype):
    """Every forward entry point of a float32 model runs its module inside
    full_f32 and leaves the flags as they were; a bf16 TpuUnet is not
    touched."""
    from tests.test_torch_classic import REGION_TINY, TEXTLINE_TINY
    from tests.test_torch_detector import DUAL_TINY

    seen = []
    img = _page(0, 100, 90)
    if entry in ("predict_small_prescaled", "predict_whole_small"):
        m = _spied_model(TEXTLINE_TINY, dtype, seen)
        getattr(m, entry)(img[:64, :64] if "prescaled" in entry else img)
    elif entry == "page_box_dev":
        m = _spied_model(TEXTLINE_TINY, dtype, seen)
        m.page_box_dev(img[:64, :64], 100, 90)
    elif entry == "predict_tiled":
        m = _spied_model(REGION_TINY, dtype, seen)
        m.predict_tiled(img, pre_otsu=True, **SHAPING)
    else:
        # the classic pair for one form, the dual-head model for the rest
        m = _spied_model(DUAL_TINY if entry != "predict_dual_tiled"
                         else REGION_TINY, dtype, seen)
        other = m if entry != "predict_dual_tiled" \
            else _spied_model(TEXTLINE_TINY, dtype, seen)
        if entry == "predict_dual_tiled":
            m.predict_dual_tiled(other, img, **SHAPING)
        elif entry == "predict_dual_tiled_resident":
            m.predict_dual_tiled_resident(
                other, [m.upload_canvas(img)], [[0, 0, 100, 90]], **SHAPING)
        else:
            m.predict_dual_tiled_resident_raw(
                other, [m.upload_raw(img[..., 0])], [[0, 0, 100, 90]],
                [(100, 90)], **SHAPING)
    assert m.computes_f32 == (dtype == torch.float32)
    assert seen, "the module's forward must have run"
    want = (False, False) if dtype == torch.float32 else (True, True)
    assert set(seen) == {want}
    assert _tf32() == (True, True)


def test_full_f32_without_convs_leaves_cudnn_alone(tf32_on):
    """full_f32(convs=False), the deskew matmuls' block, turns the matmul
    switch off and leaves cuDNN's as it is; beside a full block each
    switch comes back when the last block that turned it off closes."""
    with precision.full_f32(convs=False):
        assert _tf32() == (False, True)
        with precision.full_f32():
            assert _tf32() == (False, False)
        assert _tf32() == (False, True)
    assert _tf32() == (True, True)
    with precision.full_f32():
        with precision.full_f32(convs=False):
            assert _tf32() == (False, False)
        assert _tf32() == (False, False)
    assert _tf32() == (True, True)


def test_bf16_forward_leaves_cudnn_switch_alone(tf32_on, monkeypatch):
    """A bf16 TpuUnet's forward never flips cuDNN's TF32 switch, which
    picks the kernels (and the order of the float32 sums) of the bf16
    convs on every thread; its float32 head is a matmul with the matmul
    switch off."""
    from tests.test_torch_detector import DUAL_TINY

    spec = treg.ModelSpec.from_meta(DUAL_TINY.to_meta())
    model = treg.build_module(spec, torch.bfloat16).eval()
    model.load_state_dict(checkpoint.random_init(
        spec, torch.Generator().manual_seed(0)))
    seen = []
    for block in model.modules():
        if isinstance(block, unet.ConvGN):
            block.register_forward_pre_hook(lambda *a: seen.append(_tf32()))
    real = torch.nn.functional.linear

    def linear(*a, **k):
        seen.append(("head",) + _tf32())
        return real(*a, **k)

    monkeypatch.setattr(torch.nn.functional, "linear", linear)
    with torch.no_grad():
        model.forward_nchw(torch.rand(1, 2, 64, 64))
    assert set(seen) == {(True, True), ("head", False, True)}
    assert _tf32() == (True, True)


def test_mixed_bundle_serves_bf16_models_in_full_f32(tf32_on):
    """Beside a float32 model, whose forwards switch cuDNN's TF32 off on
    the pipelined batch's threads, a bundle's bf16 TpuUnets are served
    inside full_f32 too; a bundle of one dtype leaves them alone."""
    from tests.test_torch_classic import REGION_TINY, TEXTLINE_TINY

    seen = []
    page = _spied_model(TEXTLINE_TINY, torch.bfloat16, seen)
    runner.ModelBundle(page, page, page)
    assert not page.without_tf32
    page.predict_whole_small(_page(0, 100, 90))
    assert seen == [(True, True)]
    runner.ModelBundle(page, _spied_model(REGION_TINY, torch.float32, []),
                       _spied_model(TEXTLINE_TINY, torch.float32, []))
    assert page.without_tf32
    seen.clear()
    page.predict_whole_small(_page(0, 100, 90))
    assert seen == [(False, False)]
    assert _tf32() == (True, True)


# -- A2: the flags the port once refused ---------------------------------------

def _with_runtime(**flags):
    return dataclasses.replace(
        CFG, runtime=dataclasses.replace(CFG.runtime, **flags))


@pytest.mark.parametrize("flag,value", [
    ("spec_deskew", True), ("device_page_box", True),
    ("fused_page_box", True), ("deskew_buf_max", 64)])
def test_once_refused_flags_serve_like_jax(bundles, flag, value):
    """Each flag builds a detector that serves a tiny page with the JAX
    detector's page box, slopes and PAGE-XML under the same flag (64 puts
    the page's regions over the deskew buffer cap: the host sweep serves
    them, counted as the JAX package's ladder would)."""
    jb, tb = bundles
    cfg = _with_runtime(**{flag: value})
    jdet, det = _pair(jb, tb, cfg)
    want, got = _both(jdet, det, _page(0, 210, 170))
    assert len(got.contours) >= 3 and not got.degraded
    assert det.fallbacks == ({"host_sweep": 1} if flag == "deskew_buf_max"
                             else {})


def test_every_runtime_flag_is_read_raised_or_listed(bundles):
    """No RuntimeConfig field is silently ignored: each is read by the
    port, none is without effect; and the defaults construct."""
    _, tb = bundles
    detector.TextlineDetector(tb, DEFAULT_CONFIG)
    read = {"batch_buckets", "tile_chunk", "grid_bucket", "grid_bucket_x",
            "compute_dtype", "deskew_batch", "deskew_canvas",
            "exact_point_in_polygon", "resident_deskew",
            "textline_projection", "raw_upload", "resident_upload",
            "pages_per_dispatch", "device_phase_workers", "page_box_batch",
            "spec_deskew", "deskew_spec_slots", "device_page_box",
            "fused_page_box", "deskew_buf_max", "warm_fallback_programs",
            "mesh_auto_group"}
    without_effect = set()
    fields = {f.name for f in dataclasses.fields(RuntimeConfig)}
    assert fields == read | without_effect
    assert not hasattr(detector, "_UNPORTED_FLAGS")


# -- A3: the scope of a degraded page -------------------------------------------

def _pair(jb, tb, cfg=CFG):
    return (jdetector.TextlineDetector(jb, cfg),
            detector.TextlineDetector(tb, cfg))


def _both(jdet, det, image):
    want = jdet.process_image(image, "p.png")
    got = det.process_image(image, "p.png")
    assert got.page_coord == want.page_coord
    assert got.slopes == want.slopes
    assert len(got.contours) == len(want.contours)
    assert _strip(got.xml_tree) == _strip(want.xml_tree)
    return want, got


def _whole_page(image, res):
    th, tw = detector.stages.working_dims(image, CFG)
    return res.page_coord == [0, th - 1, 0, tw - 1]


@pytest.mark.parametrize("where", ["page_forward", "page_box_decision"])
def test_failed_page_box_gives_whole_page_and_goes_on(bundles, monkeypatch,
                                                      where):
    jb, tb = bundles
    jdet, det = _pair(jb, tb)
    if where == "page_forward":
        monkeypatch.setattr(jb.page, "predict_small_prescaled", _boom)
        monkeypatch.setattr(tb.page, "predict_small_prescaled", _boom)
    else:
        monkeypatch.setattr(jdetector.stages, "_page_box_model_res", _boom)
        monkeypatch.setattr(detector.stages, "_page_box_model_res", _boom)
    image = _page(0, 210, 170)
    want, got = _both(jdet, det, image)
    assert _whole_page(image, got)
    assert len(got.contours) >= 3 and sum(map(len, got.textlines)) >= 3
    assert not got.degraded and det.degraded == 0
    assert det.fallbacks == {"whole_page_box": 1}


@pytest.mark.parametrize("where", ["reading_order", "region_contours",
                                   "slopes_and_lines"])
def test_failure_after_the_page_box_keeps_the_box(bundles, monkeypatch,
                                                  where):
    jb, tb = bundles
    jdet, det = _pair(jb, tb)
    clean = det.process_image(_page(0, 210, 170), "p.png")
    target = {"reading_order": ("order_mod", "order_and_id_of_texts"),
              "region_contours": ("stages", "region_contours_and_boxes"),
              "slopes_and_lines": ("stages", "slopes_and_lines")}[where]
    for mod in (jdetector, detector):
        monkeypatch.setattr(getattr(mod, target[0]), target[1], _boom)
    image = _page(0, 210, 170)
    want, got = _both(jdet, det, image)
    assert got.page_coord == clean.page_coord and not _whole_page(image, got)
    assert got.contours == [] and got.textlines == []
    assert got.degraded and det.degraded == 1
    assert b"TextRegion" not in _strip(got.xml_tree)


def _fail_fused(jb, tb, monkeypatch, names):
    for m in (jb.region, tb.region):
        for name in names:
            monkeypatch.setattr(m, name, _boom)


FUSED = ("predict_dual_tiled_resident_raw", "predict_dual_tiled_resident",
         "predict_dual_tiled")


def test_failed_raw_phase_is_served_by_the_standard_path(bundles,
                                                         monkeypatch):
    jb, tb = bundles
    jdet, det = _pair(jb, tb)
    image = _page(0, 210, 170)
    clean = det.process_image(image, "p.png")
    _fail_fused(jb, tb, monkeypatch, FUSED[:1])
    want, got = _both(jdet, det, image)
    assert not got.degraded and det.degraded == 0
    assert det.fallbacks == {"standard_path": 1}
    assert len(got.contours) >= 3 and sum(map(len, got.textlines)) >= 3
    assert _strip(got.xml_tree) == _strip(clean.xml_tree)


def test_failed_canvas_upload_takes_the_crop_upload(bundles, monkeypatch):
    jb, tb = bundles
    cfg = _with_runtime(raw_upload=False)
    jdet, det = _pair(jb, tb, cfg)
    image = _page(0, 210, 170)
    clean = det.process_image(image, "p.png")
    monkeypatch.setattr(jb.region, "upload_canvas", _boom)
    monkeypatch.setattr(tb.region, "upload_canvas", _boom)
    want, got = _both(jdet, det, image)
    assert not got.degraded and det.fallbacks == {"crop_upload": 1}
    assert _strip(got.xml_tree) == _strip(clean.xml_tree)


def test_failed_fused_call_is_served_by_the_separate_models(
        classic_bundles, monkeypatch):
    """The classic bundle: with every fused call failing, the region and
    the textline model run one after the other and the page keeps its
    regions and lines."""
    jb, tb = classic_bundles
    jdet, det = _pair(jb, tb)
    image = _page(0, 210, 170)
    clean = det.process_image(image, "p.png")
    _fail_fused(jb, tb, monkeypatch, FUSED)
    want, got = _both(jdet, det, image)
    assert not got.degraded and det.degraded == 0
    assert det.fallbacks == {"standard_path": 1, "separate_models": 1}
    assert len(got.contours) >= 3 and sum(map(len, got.textlines)) >= 3
    assert got.slopes == clean.slopes
    assert _strip(got.xml_tree) == _strip(clean.xml_tree)


@pytest.mark.parametrize("which", ["region", "textline"])
def test_failed_separate_model_leaves_no_regions(classic_bundles,
                                                 monkeypatch, which):
    """A region model that fails, or a textline model that fails after
    it (a missing textline mask), leaves the page its box and no
    regions."""
    jb, tb = classic_bundles
    jdet, det = _pair(jb, tb)
    _fail_fused(jb, tb, monkeypatch, FUSED)
    for b in (jb, tb):
        monkeypatch.setattr(getattr(b, which), "predict_tiled", _boom)
    image = _page(0, 210, 170)
    want, got = _both(jdet, det, image)
    assert got.contours == [] and not _whole_page(image, got)
    assert got.degraded and det.degraded == 1


def test_dual_head_model_cannot_serve_the_separate_rung(bundles,
                                                        monkeypatch):
    """As in the JAX package: the dual-head model reads two channels, so
    its forward on predict_tiled's three raises and the page gets no
    regions."""
    jb, tb = bundles
    jdet, det = _pair(jb, tb)
    _fail_fused(jb, tb, monkeypatch, FUSED)
    want, got = _both(jdet, det, _page(0, 210, 170))
    assert got.contours == [] and got.degraded


@pytest.mark.parametrize("where", ["collect", "dispatch"])
def test_failed_resident_chain_is_served_by_the_host_sweep(bundles,
                                                           monkeypatch,
                                                           where):
    jb, tb = bundles
    jdet, det = _pair(jb, tb)
    image = _page(0, 210, 170)
    clean = det.process_image(image, "p.png")
    for d in (jdet, det):
        monkeypatch.setattr(d.deskew, "resident_" + where, _boom)
    want, got = _both(jdet, det, image)
    assert not got.degraded and det.degraded == 0
    assert det.fallbacks == {"host_sweep": 1}
    assert len(got.contours) == len(clean.contours) >= 3
    assert sum(map(len, got.textlines)) >= 3
    assert any(s != 0.0 for s in got.slopes)


def test_failed_sweep_too_gives_slope_zero(bundles, monkeypatch):
    jb, tb = bundles
    jdet, det = _pair(jb, tb)
    for d in (jdet, det):
        monkeypatch.setattr(d.deskew, "resident_collect", _boom)
        monkeypatch.setattr(d.deskew, "best_angles", _boom)
    want, got = _both(jdet, det, _page(0, 210, 170))
    assert got.slopes == [0.0] * len(got.contours) and got.contours
    assert not got.degraded
    assert det.fallbacks == {"host_sweep": 1, "slope_zero": 1}
