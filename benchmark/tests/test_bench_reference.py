"""The benchmark's plain reference and arithmetic against the program on
the CPU: the plain TpuUnet and ResNet50-UNet against the port's float32
forwards, the reference's page box and raw-path segmentation against the
port's float32 paths on either architecture, the float8 control's
rounding, the FLOP and byte counts against hand counts and torch's FLOP
counter, the existing configurations' page work against the numbers it
has always given, and the layout judge."""

import json
import math
import pathlib
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from benchmark import flops, layout_score, plain_unet, recipe, synthetic
from benchmark.pool import render
from benchmark.reference import Reference, box_from_labels, grid_for
from benchmark.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]
DUAL = tiny.spec("model_dualhead", 5, (3, 2), 2)
PAGE = tiny.spec("model_page_mixed_best", 2)
CONFIGS = {
    "tpu_unet": {"roles": {
        "page": {"file": "model_page_mixed_best", "data": "page",
                 "steps": 2, "spec": PAGE},
        "dualhead": {"file": "model_dualhead", "data": "dualhead",
                     "steps": 2, "spec": DUAL}},
        "recipe": {"seed": 0, "learning_rate": 3e-4, "weight_decay": 1e-4,
                   "batch": 2}},
    "resnet50_unet": tiny.three_roles(tiny.resnet_spec)}
# the plain model against the port's: the TpuUnet within the rounding of
# Flax's GroupNorm order; the ResNet50-UNet the same float32 arithmetic in
# another summation order, max |err| <= 1e-5 of max |logit|
PLAIN = {"tpu_unet": (DUAL, lambda got, want: torch.allclose(
             got, want, atol=2e-4, rtol=1e-4)),
         "resnet50_unet": (tiny.resnet_spec("model_strukturerkennung", 3),
                           lambda got, want: bool(
             (got - want).abs().max() <= 1e-5 * want.abs().max()))}


@pytest.fixture(scope="module", params=list(CONFIGS))
def weights(request, tmp_path_factory):
    config = CONFIGS[request.param]
    out = tmp_path_factory.mktemp("weights")
    recipe.ensure(config, str(out), "cpu")
    torch.use_deterministic_algorithms(False)
    return config, out


def _port_module(spec):
    from sbb_textline_detection_tpu_torch.models import registry

    return registry.build_module(registry.ModelSpec.from_meta(spec),
                                 torch.float32)


def _stir_batch_norms(state, seed):
    """The BatchNorms' scales, biases and running statistics drawn off
    their initial 1 and 0, so that the eval() formula is exercised."""
    gen = torch.Generator().manual_seed(seed)
    bn = {k.rsplit(".", 1)[0] for k in state if k.endswith(".running_mean")}
    for key, t in state.items():
        mod, leaf = key.rsplit(".", 1)
        if mod in bn and leaf in ("weight", "running_var"):
            state[key] = 0.5 + torch.rand(t.shape, generator=gen)
        elif mod in bn:
            state[key] = 0.1 * torch.randn(t.shape, generator=gen)
    return state


@pytest.mark.parametrize("arch", list(PLAIN))
def test_plain_unet_matches_the_ports_float32_forward(arch):
    """The plain model in eval() against the port's float32 forward on the
    same state; the fp8 control fails the same comparison."""
    spec, close = PLAIN[arch]
    plain = plain_unet.build(spec)
    plain.load_state_dict(_stir_batch_norms(plain_unet.init_state(plain, 3),
                                            5))
    port = _port_module(spec)
    port.load_state_dict(plain.state_dict())
    plain.eval()
    port.eval()
    x = torch.rand(2, spec["in_channels"], 64, 64,
                   generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = port.forward_nchw(x)
        got = plain(x)
        plain.set_quantize("fp8")
        control = plain(x)
    assert close(got, want), (got - want).abs().max()
    assert not close(control, want), (control - want).abs().max()


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3.0, 3.0, 1001)
    q = plain_unet.fp8_round(x)
    scale = x.abs().max() / plain_unet.FP8_MAX
    assert torch.all((q - x).abs() <= x.abs() * 2 ** -4 + scale * 2 ** -9)
    assert len(torch.unique(q)) < 256 and not torch.equal(q, x)


def _port_bundle(weights_dir):
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle

    return ModelBundle.from_dir(str(weights_dir), DEFAULT_CONFIG.runtime,
                                "cpu", DEFAULT_CONFIG.model_names,
                                dtype=torch.float32)


@pytest.mark.parametrize("labels", [
    [(3, 5, 20, 40)],
    [(0, 0, 64, 64)],
    [(10, 2, 30, 12), (40, 30, 63, 60)],
])
def test_box_from_labels_is_the_programs_page_box(labels):
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.pipeline import stages

    small = np.zeros((64, 64), np.uint8)
    for y0, x0, y1, x1 in labels:
        small[y0:y1, x0:x1] = 1
    th, tw = 400, 300
    box = stages._page_box_model_res(small, th, tw, DEFAULT_CONFIG)
    assert box_from_labels(small, th, tw) == [
        box[1], box[1] + box[3], box[0], box[0] + box[2]]


@pytest.mark.parametrize("page_coord", [[20, 380, 15, 290], [0, 400, 0, 300],
                                        [101, 222, 40, 170]])
def test_reference_is_the_ports_float32_device_phase(weights, page_coord):
    """On one page box the reference's shaped region mask and textline
    labels equal the port's float32 raw path, and its page-model labels
    the port's: the dual-head TpuUnet bundle and the three ResNet50-UNets."""
    from sbb_textline_detection_tpu_torch.pipeline import stages

    config, weights = weights
    cfg = tiny.pipeline_config()
    models = _port_bundle(weights)
    page, _ = render(5, 1, (6.0, 0.5, 1, 0.2, False), 400, 300)
    ref = Reference(config, str(weights), "cpu", (300, 240, 1.0))
    th, tw = stages.working_dims(page, cfg)
    small = stages.page_model_input_from_raw(page, th, tw, 64, 64)
    want = models.page.predict_small_prescaled(small)
    assert np.mean(ref.page_labels(page) != want) < 1e-3

    pbox = [page_coord[0], page_coord[2], page_coord[1] - page_coord[0],
            page_coord[3] - page_coord[2]]
    raw_dev = models.region.upload_raw(page[:, :, 0])
    (region, _, tl), = stages.extract_regions_and_textline_resident_raw(
        [raw_dev], [pbox], [(th, tw)], models, cfg,
        return_device_textline=True, raw_hws=[page.shape[:2]],
        textline_projection=True)
    ref_region, ref_lines = ref.segment(page, page_coord)
    lines = tl[:pbox[2], :pbox[3]].numpy()
    assert region.shape == ref_region.shape and lines.shape == \
        ref_lines.shape
    assert 0 < ref_lines.mean() < 1
    assert np.mean(region != ref_region) < 1e-3
    assert np.mean(lines != ref_lines) < 1e-3


def test_flops_match_a_hand_count():
    spec = {"widths": [8, 16], "n_classes": 2, "in_channels": 3,
            "input_height": 64, "input_width": 64}
    # stem 3->8 at 32; 8->8, 8->8 at 32, s2 at 16; 8->16, 16->16 at 16,
    # s2 at 8; mid 16->32, 32->32 at 8; up 16: 32->16, 32->16, 16->16;
    # up 32: 16->8, 16->8, 8->8; refine 8->32 at 64; head 32->2 (1x1)
    convs = [(3, 8, 32), (8, 8, 32), (8, 8, 32), (8, 8, 16), (8, 16, 16),
             (16, 16, 16), (16, 16, 8), (16, 32, 8), (32, 32, 8),
             (32, 16, 16), (32, 16, 16), (16, 16, 16), (16, 8, 32),
             (16, 8, 32), (8, 8, 32), (8, 32, 64)]
    want = sum(2 * 9 * ci * co * s * s for ci, co, s in convs)
    want += 2 * 32 * 2 * 64 * 64
    assert flops.forward_flops(spec) == want
    module = plain_unet.build(spec)
    assert flops.weight_count(spec) == sum(
        t.numel() for t in module.state_dict().values())
    assert flops.forward_bytes(spec, 10) == (
        2 * 10 * 64 * 64 * 3 + 2 * flops.weight_count(spec)
        + 4 * 10 * 64 * 64 * 2)


@pytest.mark.parametrize("arch", ["tpu_unet", "resnet50_unet"])
def test_forward_flops_equal_torchs_counter_on_the_ports_module(arch):
    """At 448 x 448 on the meta device: the flagship dual-head TpuUnet and
    the ResNet50-UNet (59.3 GFLOP a tile); the weight count is the port's
    state_dict's size."""
    from torch.utils.flop_counter import FlopCounterMode

    if arch == "tpu_unet":
        config = json.loads((ROOT / "benchmark" / "configs" /
                             "tpu_dualhead.json").read_text())
        spec = config["roles"]["dualhead"]["spec"]
    else:
        spec = dict(tiny.resnet_spec("model_strukturerkennung", 3),
                    input_height=448, input_width=448)
    with torch.device("meta"):
        port = _port_module(spec)
        x = torch.empty(1, spec["in_channels"], 448, 448)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        port.forward_nchw(x)
    assert flops.forward_flops(spec) == counter.get_total_flops()
    assert flops.weight_count(spec) == sum(
        t.numel() for t in port.state_dict().values())
    if arch == "resnet50_unet":
        assert flops.forward_flops(spec) == pytest.approx(59.3e9, rel=0.01)


# flops.page_work of the benchmark's configurations on three page boxes, as
# the arithmetic has given them since the benchmark began: (tiles, flops,
# seg_flops, seg_bytes)
PAGE_WORK = {
    "tpu_dualhead": [
        (60, 1869145112576.0, 1838512865280.0, 307887050.0),
        (40, 1256307490816.0, 1225675243520.0, 211549130.0),
        (48, 1501442539520.0, 1470810292224.0, 250084298.0)],
    "tpu_threemodel": [
        (60, 3707272626176.0, 3676640378880.0, 423099082.0),
        (40, 2481725833216.0, 2451093585920.0, 294648522.0),
        (48, 2971944550400.0, 2941312303104.0, 346028746.0)]}
BOXES = ([0, 3000, 0, 2000], [120, 2900, 77, 1800], [31, 2804, 200, 2310])


@pytest.mark.parametrize("name", list(PAGE_WORK))
def test_page_work_of_the_configurations_is_unchanged(name):
    config = json.loads((ROOT / "benchmark" / "configs" /
                         f"{name}.json").read_text())
    for box, want in zip(BOXES, PAGE_WORK[name]):
        work = flops.page_work(config, box)
        assert (work["tiles"], work["flops"], work["seg_flops"],
                work["seg_bytes"]) == want


def test_plain_resnet_loads_neither_jax_nor_the_program():
    code = ("import json, sys, benchmark.plain_resnet; print(json.dumps("
            "sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout))
    assert "benchmark" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "sbb_textline_detection_tpu",
                         "sbb_textline_detection_tpu_torch"}


def test_mfu_of_a_single_entry_leaves_a_failed_page_out():
    """A failed page's wall reads inf: the share is that of the pages
    served (it read 0 when the inf entered the sum of walls)."""
    from types import SimpleNamespace

    from benchmark import run

    res = SimpleNamespace()
    pages = [{"j": 0, "res": res, "profiled": False, "wall": 0.5},
             {"j": 1, "res": res, "profiled": False, "wall": math.inf},
             {"j": 1, "res": res, "profiled": True, "wall": 0.4}]
    ctx = {"entry": "single",
           "window": SimpleNamespace(pages=pages, seconds=2.0, slice=None),
           "work": [{"flops": 0.1 * flops.PEAK_BF16_FLOPS},
                    {"flops": 0.2 * flops.PEAK_BF16_FLOPS}]}
    assert run._reader("mfu").read(ctx) == pytest.approx(20.0)


def test_page_work_counts_the_raw_paths_tiles():
    config = {"roles": {"page": {"spec": PAGE}, "dualhead": {"spec": DUAL}}}
    # 64-px tiles: margin 6, stride 52; 300 x 200 -> ceil(300/52) = 6 rows
    # (even already), ceil(200/52) = 4 columns
    assert grid_for(300, 200, 64) == (6, 4)
    assert grid_for(260, 52, 64) == (6, 1)
    work = flops.page_work(config, [10, 310, 5, 205])
    assert work["tiles"] == 24
    assert work["seg_flops"] == 24 * flops.forward_flops(DUAL)
    assert work["flops"] == work["seg_flops"] + flops.forward_flops(PAGE)
    least = flops.least_seconds(work["seg_flops"], work["seg_bytes"])
    assert least == max(work["seg_flops"] / 989e12,
                        work["seg_bytes"] / 3.35e12)


def _page_xml(polys):
    ns = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15"
    root = ET.Element(f"{{{ns}}}PcGts")
    page = ET.SubElement(root, f"{{{ns}}}Page")
    region = ET.SubElement(page, f"{{{ns}}}TextRegion")
    for poly in polys:
        line = ET.SubElement(region, f"{{{ns}}}TextLine")
        ET.SubElement(line, f"{{{ns}}}Coords", points=" ".join(
            f"{x},{y}" for x, y in poly))
    return ET.ElementTree(root)


def test_layout_judge_reads_lines_and_slopes():
    layout = synthetic.PageLayout((0, 0, 100, 100), [(0, 0, 100, 60)], [2],
                                  [(10, 10, 90, 20), (10, 40, 90, 50)],
                                  0.0, (100, 100))
    both = _page_xml([[(5, 5), (95, 5), (95, 25), (5, 25)],
                      [(5, 35), (95, 35), (95, 55), (5, 55)]])
    one = _page_xml([[(5, 5), (95, 5), (95, 25), (5, 25)]])
    assert layout_score.line_recall(both, layout) == 1.0
    assert layout_score.line_recall(one, layout) == 0.5
    layout.skew_deg = 8.0
    assert layout_score.slope_gap_deg([-8.2, -7.9, -8.0], layout) == \
        pytest.approx(0.0)
    assert layout_score.slope_gap_deg([82.0], layout) == pytest.approx(0.0)
    assert layout_score.slope_gap_deg([-6.0], layout) == pytest.approx(2.0)
    assert layout_score.slope_gap_deg([], layout) == 45.0


def _regions_xml(regions, order=None):
    """A PAGE-XML tree of (region polygon, [line polygons]) pairs, read in
    `order` (region indices; in turn by default)."""
    ns = "http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15"
    root = ET.Element(f"{{{ns}}}PcGts")
    page = ET.SubElement(root, f"{{{ns}}}Page")
    group = ET.SubElement(ET.SubElement(page, f"{{{ns}}}ReadingOrder"),
                          f"{{{ns}}}OrderedGroup")
    for index, k in enumerate(order or range(len(regions))):
        ET.SubElement(group, f"{{{ns}}}RegionRefIndexed",
                      index=str(index), regionRef=f"r{k}")

    def coords(parent, poly):
        ET.SubElement(parent, f"{{{ns}}}Coords", points=" ".join(
            f"{x},{y}" for x, y in poly))

    for k, (poly, lines) in enumerate(regions):
        region = ET.SubElement(page, f"{{{ns}}}TextRegion", id=f"r{k}")
        coords(region, poly)
        for line_poly in lines:
            coords(ET.SubElement(region, f"{{{ns}}}TextLine"), line_poly)
    return ET.ElementTree(root)


def _box(x0, y0, x1, y1):
    return [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]


def test_layout_judge_reads_regions_and_merged_lines():
    """Two paragraphs of two lines each: the right answer reads 0
    everywhere; merging a region's two lines into one TextLine, a page-wide
    region, a reversed reading order or a turned slope each read what they
    broke."""
    layout = synthetic.PageLayout(
        (0, 0, 100, 200), [(0, 0, 100, 60), (0, 100, 100, 160)], [2, 2],
        [(10, 10, 90, 20), (10, 40, 90, 50), (10, 110, 90, 120),
         (10, 140, 90, 150)], 0.0, (200, 100))
    lines = [_box(5, 5, 95, 25), _box(5, 35, 95, 55)]
    lower = [_box(5, 105, 95, 125), _box(5, 135, 95, 155)]
    right = _regions_xml([(_box(0, 0, 100, 60), lines),
                          (_box(0, 100, 100, 160), lower)])
    score = layout_score.score_page(right, [0.0, 0.0], [2, 2], layout)
    assert score == {"line_recall_gap": 0.0, "line_precision_gap": 0.0,
                     "region_recall_gap": 0.0, "region_precision_gap": 0.0,
                     "line_count_err": 0.0, "reading_order_gap": 0.0,
                     "slope_deg": 0.0}
    backwards = _regions_xml([(_box(0, 0, 100, 60), lines),
                              (_box(0, 100, 100, 160), lower)], [1, 0])
    assert layout_score.score_page(backwards, [0.0, 0.0], [2, 2], layout)[
        "reading_order_gap"] == 1.0
    merged = _regions_xml([(_box(0, 0, 100, 60), [_box(5, 5, 95, 55)]),
                           (_box(0, 100, 100, 160), lower)])
    score = layout_score.score_page(merged, [0.0, 0.0], [1, 2], layout)
    assert score["line_recall_gap"] == 0.0
    assert score["line_precision_gap"] == pytest.approx(1 / 3)
    assert score["line_count_err"] == 0.5
    one = _regions_xml([(_box(0, 0, 100, 200), lines + lower)])
    score = layout_score.score_page(one, [0.0], [4], layout)
    assert score["region_recall_gap"] == 1.0
    assert score["region_precision_gap"] == 1.0
    score = layout_score.score_page(right, [0.0, 2.5], [3, 3], layout)
    assert score["slope_deg"] == pytest.approx(2.5)
    # without a region of SLOPE_MIN_LINES lines, the median slope
    score = layout_score.score_page(right, [0.0, 2.5], [2, 2], layout)
    assert score["slope_deg"] == pytest.approx(1.25)
    # a region of fewer than SLOPE_MIN_LINES lines is not held alone
    score = layout_score.score_page(right, [0.0, 2.5, 0.2], [3, 2, 3],
                                    layout)
    assert score["slope_deg"] == pytest.approx(0.2)
