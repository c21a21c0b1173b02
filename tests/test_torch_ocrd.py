"""The port's OCR-D layer against the JAX package's: the polygon ops and
the PAGE-XML merge (every case of tests/test_ocrd_merge.py runs on both
packages' functions), the tool descriptor, and the processor end to end
on the stub workspace of tests/ocrd_stub.py.

Tolerance: none. Polygons and predicates must be equal, merged documents
byte for byte. The processors' merged PAGE-XML must be equal apart from
the tool name in the processing-step item, which differs by design. The
one repair of the copy (clip_convex where the JAX package's clip leaves
its window) is held to the window instead (to 1e-6 px).
"""

import dataclasses
import re
import xml.etree.ElementTree as ET

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from sbb_textline_detection_tpu.models import checkpoint as jckpt
from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.ocrd import merge as jmerge
from sbb_textline_detection_tpu.ocrd import processor as jprocessor
from sbb_textline_detection_tpu.ops import polygon as jpoly
from sbb_textline_detection_tpu_torch.ocrd import merge as tmerge
from sbb_textline_detection_tpu_torch.ocrd import processor as tprocessor
from sbb_textline_detection_tpu_torch.ops import polygon as tpoly

from tests import ocrd_stub
from tests.test_ocrd_merge import NS, _detection, _target_page
from tests.test_torch_detector import (CFG, DUAL_TINY, PAGE_TINY,
                                       _f32_module, _page)

SQUARE = [[0, 0], [10, 0], [10, 10], [0, 10]]


# -- polygon ops and the merge, case by case ---------------------------------

def _poly(pts):
    return np.asarray(pts, float)


def _polygon_case(name, poly):
    if name == "convex_hull":
        return poly.convex_hull(_poly(SQUARE + [[5, 5], [2, 3]]))
    if name == "is_convex":
        return (poly.is_convex(_poly([[0, 0], [4, 0], [4, 4], [0, 4]])),
                poly.is_convex(_poly([[0, 0], [4, 0], [2, 2], [4, 4],
                                      [0, 4]])))
    bowtie = _poly([[0, 0], [4, 4], [4, 0], [0, 4]])
    if name == "is_simple_bowtie":
        return poly.is_simple(bowtie), poly.is_simple(_poly(SQUARE))
    if name == "make_valid_bowtie":
        return poly.make_valid(bowtie)
    if name == "clip_convex":
        return poly.clip_convex(_poly([[-2, 1], [6, 1], [6, 3], [-2, 3]]),
                                _poly([[0, 0], [4, 0], [4, 4], [0, 4]]))
    child = {"parent_inside": [[1, 1], [3, 1], [3, 3], [1, 3]],
             "parent_outside": [[20, 20], [30, 20], [30, 30], [20, 30]],
             "parent_partial": [[5, 5], [15, 5], [15, 8], [5, 8]]}[name]
    return poly.polygon_for_parent(_poly(child), _poly(SQUARE))


def _merge_case(name, merge):
    """The document a case of tests/test_ocrd_merge.py leaves behind."""
    target = _target_page(with_old=name not in ("alternative_image",
                                                "metadata_roundtrip",
                                                "metadata_appends"))
    det = _detection()
    kwargs = {}
    if name == "clip_to_border":
        det = _detection(regions=(
            ("r0", "600,100 790,100 790,400 600,400",
             [("l0", "610,120 780,120 780,160 610,160")]),))
    elif name == "drop_outside_border":
        det = _detection(regions=(
            ("r0", "100,100 700,100 700,400 100,400", []),
            ("r_out", "760,960 790,960 790,990 760,990", []),))
    elif name == "inverse_transform":
        kwargs["transform"] = np.asarray([[1, 0, 10], [0, 1, 20], [0, 0, 1]],
                                         float)
    elif name == "no_border":
        page = merge.find_child(det, "Page")
        page.remove(merge.find_child(page, "Border"))
    elif name == "alternative_image":
        page = merge.find_child(target, "Page")
        for fname in ("bin.png", "gray.png"):
            ET.SubElement(page, f"{{{NS}}}AlternativeImage").set("filename",
                                                                 fname)
    elif name == "metadata_appends":
        md = ET.Element(f"{{{NS}}}Metadata")
        ET.SubElement(md, f"{{{NS}}}Creator").text = "existing"
        target.insert(0, md)
        merge.add_processing_step_metadata(
            target, executable="x", version="0", step="s", parameters={})
        return ET.tostring(target)
    merge.merge_detection_into_page(target, det, **kwargs)
    if name == "metadata_roundtrip":
        merge.add_processing_step_metadata(
            target, executable="ocrd-sbb-textline-detector-tpu",
            version="1.0.0", step="layout/segmentation/region",
            parameters={"model": "/models"})
        target = ET.fromstring(ET.tostring(target, encoding="unicode"))
    return ET.tostring(target)


POLYGON_CASES = ["convex_hull", "is_convex", "is_simple_bowtie",
                 "make_valid_bowtie", "clip_convex", "parent_inside",
                 "parent_outside", "parent_partial"]
MERGE_CASES = ["all_sections", "clip_to_border", "drop_outside_border",
               "inverse_transform", "no_border", "alternative_image",
               "metadata_roundtrip", "metadata_appends"]


@pytest.mark.parametrize("name", POLYGON_CASES)
def test_polygon_case_matches_jax(name):
    got, want = _polygon_case(name, tpoly), _polygon_case(name, jpoly)
    if isinstance(want, tuple):
        assert got == want
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert len(got) >= 3


@pytest.mark.parametrize("name", MERGE_CASES)
def test_merge_case_matches_jax(name):
    got, want = _merge_case(name, tmerge), _merge_case(name, jmerge)
    assert got == want
    assert b"TextRegion" in got or b"MetadataItem" in got


def _window(parent):
    """The convex window polygon_for_parent clips a child to."""
    parent = jpoly.make_valid(np.asarray(parent, float))
    return parent if jpoly.is_convex(parent) else jpoly.convex_hull(parent)


def _in_window(poly, window, tol=1e-6):
    """Every vertex of `poly` on the inner side of every window edge."""
    if jpoly.polygon_area_signed(window) < 0:
        window = window[::-1]
    a, b = window, np.roll(window, -1, axis=0)
    side = ((b[None, :, 0] - a[None, :, 0])
            * (poly[:, None, 1] - a[None, :, 1])
            - (b[None, :, 1] - a[None, :, 1])
            * (poly[:, None, 0] - a[None, :, 0]))
    return bool(np.all(side >= -tol * np.hypot(*(b - a).T)[None]))


# a region of a random-weight A4 page on the H100 and its line's box:
# the JAX package's clip_convex meets a clip edge almost along a segment
# and puts a vertex 11 px outside the window
R573 = [[754, 2092], [767, 2092], [767, 2098], [768, 2099], [787, 2099],
        [787, 2104], [788, 2105], [800, 2105], [800, 2118], [786, 2118],
        [786, 2116], [785, 2116], [781, 2116], [780, 2116], [780, 2118],
        [771, 2118], [771, 2119], [771, 2131], [756, 2131], [756, 2122],
        [755, 2121], [737, 2121], [737, 2119], [736, 2118], [707, 2118],
        [707, 2115], [706, 2114], [692, 2114], [692, 2100], [723, 2100],
        [724, 2099], [753, 2099], [754, 2098]]
R573_LINE = [[692, 2092], [801, 2092], [801, 2131], [692, 2131]]


def test_clip_convex_repair_stays_in_the_window():
    """The one place where the port differs from the JAX package: its
    clip_convex takes the crossing's fraction of the segment where the
    line formula lands off the segment, so the clipped line stays within
    the region's window. The line's box holds the whole window, so the
    clipped line is the window (to 1e-6 px^2 of area)."""
    region, line = np.asarray(R573, float), np.asarray(R573_LINE, float)
    window = _window(region)
    want = jpoly.polygon_for_parent(line, region)
    got = tpoly.polygon_for_parent(line, region)
    assert not _in_window(want, window)
    assert _in_window(got, window)
    assert abs(abs(tpoly.polygon_area_signed(got))
               - abs(jpoly.polygon_area_signed(window))) < 1e-6


@settings(max_examples=60, deadline=None, derandomize=True,
          database=None)
@given(st.integers(0, 2**32 - 1), st.integers(3, 9), st.integers(3, 6))
def test_polygon_for_parent_matches_jax(seed, n_child, n_parent):
    """Random child and parent polygons, convex or not, sometimes self-
    intersecting: both packages clip alike, unless the JAX package's clip
    leaves the window (the repair above), where the port's stays in it."""
    rng = np.random.default_rng(seed)
    child = rng.integers(-20, 120, (n_child, 2)).astype(float)
    parent = rng.integers(0, 100, (n_parent, 2)).astype(float)
    got = tpoly.polygon_for_parent(child, parent)
    want = jpoly.polygon_for_parent(child, parent)
    if want is None:
        assert got is None
    elif _in_window(want, _window(parent)) or len(parent) < 3:
        np.testing.assert_array_equal(got, want)
    else:
        assert _in_window(got, _window(parent))


@pytest.mark.parametrize("seed", range(3))
def test_is_simple_and_hull_match_jax_on_contours(seed):
    """The port's vectorized is_simple and cached convex_hull on region
    contours of a noisy mask (simple rings of hundreds of vertices) and on
    the same rings with two vertices swapped (mostly self-intersecting):
    the same answers as the JAX package's loops."""
    from sbb_textline_detection_tpu_torch.ops import contours

    rng = np.random.default_rng(seed)
    mask = (rng.uniform(size=(60, 80)) < 0.55).astype(np.uint8)
    mask[10:50, 15:65] |= 1
    rings = sorted((c.astype(float) for c in contours.find_contours(mask)
                    if len(c) >= 4), key=len)[-6:]
    assert len(rings[-1]) > 100
    answers = []
    for ring in rings:
        bent = ring.copy()
        k = int(rng.integers(1, len(ring) - 1))
        bent[[0, k]] = bent[[k, 0]]
        for poly in (ring, bent):
            got = tpoly.is_simple(poly)
            assert got == jpoly.is_simple(poly)
            answers.append(got)
            np.testing.assert_array_equal(tpoly.convex_hull(poly),
                                          jpoly.convex_hull(poly))
    assert True in answers and False in answers


def test_descriptor_matches_jax_but_for_the_tool_name():
    got, want = tprocessor.ocrd_tool(), jprocessor.ocrd_tool()
    (tname, tool), = got["tools"].items()
    (jname, jtool), = want["tools"].items()
    assert tname == tool["executable"] == \
        "ocrd-sbb-textline-detector-tpu-torch"
    assert "PyTorch/CUDA port" in tool["description"]
    assert ".npz" in tool["parameters"]["model"]["description"]
    for key in ("executable", "description"):
        tool.pop(key), jtool.pop(key)
    tool["parameters"]["model"].pop("description")
    jtool["parameters"]["model"].pop("description")
    assert tool == jtool
    got.pop("tools"), want.pop("tools")
    assert got == want


# -- the processor ----------------------------------------------------------

def _model_dir(path):
    """The page and dual-head models of tests/test_torch_detector.py as
    .npz checkpoints under the default names, which both packages'
    from_dir read."""
    import jax

    names = CFG.model_names
    pv = jreg.init_variables(PAGE_TINY, seed=0)
    dv = jax.tree_util.tree_map(np.array,
                                jreg.init_variables(DUAL_TINY, seed=1))
    dv["params"]["head"]["bias"][1] += 0.3
    dv["params"]["head"]["bias"][4] += 0.6
    for spec, name, v in ((PAGE_TINY, names.page, pv),
                          (DUAL_TINY, names.dualhead, dv)):
        jckpt.save(jckpt.npz_path(str(path), name),
                   dataclasses.replace(spec, name=name), v)
    return str(path)


def _stub_pages():
    """Page 1 as scanned; page 2 the crop at (12, 17) of a larger scan."""
    crop = _page(3, 210, 170)
    scan = np.clip(_page(7, 240, 200).astype(np.int32) + 25, 0,
                   255).astype(np.uint8)
    scan[12:222, 17:187] = crop
    return [("PHYS_1", _page(0, 210, 170), None),
            ("PHYS_2", scan, (12, 17, 210, 170))]


def _run(processor, tmp_path, sub, monkeypatch, config, **kw):
    """One processor over the stub workspace, in its own output directory:
    (the processor, the bytes of each PAGE-XML it added)."""
    out = tmp_path / sub
    out.mkdir()
    monkeypatch.chdir(out)
    ws = ocrd_stub.StubWorkspace(str(out), _stub_pages())
    with ocrd_stub.installed():
        proc = processor.OcrdSbbTextlineDetectorRecognize(
            ws, ocrd_stub.INPUT_GRP, "OCR-D-SEG",
            {"model": str(tmp_path / "models")}, config=config, **kw)
        proc.process()
    return proc, [open(p, "rb").read() for p in ws.added]


def test_processor_matches_jax(tmp_path, monkeypatch):
    """Both processors on the stub workspace, float32 on both sides (the
    JAX registry patched to an f32 TpuUnet, the port's runtime asking for
    float32): each merged PAGE-XML is equal, up to the tool name."""
    (tmp_path / "models").mkdir()
    _model_dir(tmp_path / "models")
    with monkeypatch.context() as mp:
        mp.setattr(jreg, "build_module", _f32_module)
        _, want = _run(jprocessor, tmp_path, "jax", monkeypatch, CFG)
    cfg = dataclasses.replace(CFG, runtime=dataclasses.replace(
        CFG.runtime, compute_dtype="float32"))
    proc, got = _run(tprocessor, tmp_path, "torch", monkeypatch, cfg,
                     device="cpu")
    assert proc._detector.degraded == 0
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.count(b"TextLine ") >= 3
        assert re.sub(rb"ocrd-sbb-textline-detector-tpu-torch",
                      b"ocrd-sbb-textline-detector-tpu", g) == w
    # the cropped page's coordinates are the detector's own plus the offset
    crop = ET.fromstring(got[1])
    own = proc._detector.process_image(_page(3, 210, 170), "p.png")
    border = tmerge.find_child(tmerge.find_child(crop, "Page"), "Border")
    det_border = tmerge.find_child(own.xml_tree.getroot(), "Page")
    det_border = tmerge.find_child(det_border, "Border")
    np.testing.assert_array_equal(
        tmerge.points_to_polygon(
            tmerge.find_child(border, "Coords").get("points")),
        tmerge.points_to_polygon(
            tmerge.find_child(det_border, "Coords").get("points"))
        + [17, 12])


def test_processor_requires_ocrd(monkeypatch):
    for name in ("ocrd", "ocrd_modelfactory", "ocrd_models", "ocrd_utils"):
        monkeypatch.setitem(__import__("sys").modules, name, None)
    with pytest.raises(ImportError, match="ocrd"):
        tprocessor.OcrdSbbTextlineDetectorRecognize(
            workspace=None, input_file_grp="A", output_file_grp="B")
    with pytest.raises(ImportError, match="ocrd"):
        tprocessor.ocrd_sbb_textline_detector_tpu_torch()
