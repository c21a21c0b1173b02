"""The PyTorch port stands alone: it and its chip smoke script import with
JAX, Flax, Optax, h5py and the whole JAX package blocked, no line of them names
the JAX package, its copies of the JAX package's host modules compute the
same, and the library API defaults to the card."""

import dataclasses
import inspect
import os
import pathlib
import re
import subprocess
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from sbb_textline_detection_tpu.core import config as jconfig
from sbb_textline_detection_tpu.ocrd import merge as jmerge
from sbb_textline_detection_tpu.ops import contours as jcontours
from sbb_textline_detection_tpu.ops import morphology as jmorphology
from sbb_textline_detection_tpu.ops import polygon as jpolygon
from sbb_textline_detection_tpu.ops import rotate as jrotate
from sbb_textline_detection_tpu.ops import tiling as jtiling
from sbb_textline_detection_tpu.pagexml import writer as jwriter
from sbb_textline_detection_tpu_torch import bench as tbench
from sbb_textline_detection_tpu_torch.core import config as tconfig
from sbb_textline_detection_tpu_torch.models import runner
from sbb_textline_detection_tpu_torch.ocrd import merge as tmerge
from sbb_textline_detection_tpu_torch.ocrd import processor as tprocessor
from sbb_textline_detection_tpu_torch.ops import contours as tcontours
from sbb_textline_detection_tpu_torch.ops import morphology as tmorphology
from sbb_textline_detection_tpu_torch.ops import polygon as tpolygon
from sbb_textline_detection_tpu_torch.ops import rotate as trotate
from sbb_textline_detection_tpu_torch.ops import tiling as ttiling
from sbb_textline_detection_tpu_torch.pagexml import writer as twriter

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "sbb_textline_detection_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
MODULES = sorted(
    "sbb_textline_detection_tpu_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py"))
# h5py too: the port reads Keras .h5 files only inside the functions that
# need it, and the card's machine may not have it; the OCR-D framework and
# triton are optional, and nothing starts a process group at import
BLOCKED = ("jax", "jaxlib", "flax", "optax", "sbb_textline_detection_tpu",
           "h5py", "ocrd", "ocrd_modelfactory", "ocrd_models", "ocrd_utils",
           "triton")


def test_port_imports_with_jax_blocked():
    # the serving bench too: it runs on the card's machine, which has no JAX
    assert "sbb_textline_detection_tpu_torch.bench" in MODULES
    code = ("import sys, importlib, importlib.util\n"
            f"for m in {BLOCKED!r}:\n"
            "    sys.modules[m] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke', "
            f"{str(SMOKE)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_initialized()\n"
            "print('ok')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [SMOKE],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_names_jax(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax)\b", src,
                         re.M), path
    assert not re.search(
        r"^\s*(from|import)\s+sbb_textline_detection_tpu(\.|\s|$)", src,
        re.M), path


def _page_xml_bytes(writer, cfg_mod, tmp_path, name):
    rng = np.random.default_rng(11)
    contours = [rng.uniform(0, 900, (7, 2)), rng.uniform(0, 900, (5, 2))]
    lines = [[rng.uniform(0, 300, (6, 2)) for _ in range(3)],
             [rng.uniform(0, 300, (4, 2))]]
    tree = writer.build_page_xml(
        image_filename="page.png", height_org=3508, width_org=2480,
        scale_x=1.2, scale_y=1.2,
        cont_page=np.array([[0, 0], [2900, 0], [2900, 4100], [0, 4100]]),
        contours=contours, page_coord=[12, 4000, 7, 2800],
        order_of_texts=[1, 0], id_of_texts=["r0", "r1"],
        all_found_textline_polygons=lines,
        all_box_coord=[[3, 90, 5, 300], [40, 200, 9, 400]],
        cfg=cfg_mod.PageXmlConfig(), now="2026-01-01T00:00:00")
    return pathlib.Path(writer.write_page_xml(
        tree, str(tmp_path), name)).read_bytes()


def _mask():
    rng = np.random.default_rng(5)
    m = (rng.uniform(size=(96, 128)) < 0.02).astype(np.uint8)
    m[10:30, 20:70] = 1
    m[15:20, 30:40] = 0
    m[50:90, 90:120] = 1
    return m


def _gray():
    return np.random.default_rng(6).integers(0, 256, (40, 56)).astype(
        np.uint8)


def _check_tiling():
    rng = np.random.default_rng(7)
    for (h, w), (th, tw) in (((150, 170), (64, 64)), ((64, 64), (64, 64)),
                             ((97, 210), (48, 80))):
        got = ttiling.compute_grid(h, w, th, tw, 0.1)
        want = jtiling.compute_grid(h, w, th, tw, 0.1)
        for f in dataclasses.fields(want):
            np.testing.assert_array_equal(getattr(got, f.name),
                                          getattr(want, f.name))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        tiles = ttiling.extract_tiles(img, got)
        np.testing.assert_array_equal(tiles,
                                      jtiling.extract_tiles(img, want))
        labels = tiles[..., 0] % 3
        np.testing.assert_array_equal(ttiling.stitch_labels(labels, got),
                                      jtiling.stitch_labels(labels, want))
    with pytest.raises(ValueError, match="smaller than tile"):
        ttiling.compute_grid(30, 100, 64, 64)


def _check_morphology_host(monkeypatch):
    """Binary masks (the native library, when built) and gray images (the
    numpy windows), then the numpy windows on the masks too."""
    seq = (("open", 5, 1), ("close", 5, 1), ("erode", 3, 2),
           ("dilate", 5, 1))
    for native in (True, False):
        if not native:
            for mod in (tmorphology, jmorphology):
                monkeypatch.setattr(mod, "_binary_foreground_value",
                                    lambda img: None)
        for img in (_mask(), _mask() * np.uint8(255), _gray()):
            for name in ("erode_host", "dilate_host"):
                for k, it in ((5, 1), (5, 2), (3, 3)):
                    np.testing.assert_array_equal(
                        getattr(tmorphology, name)(img, k, it),
                        getattr(jmorphology, name)(img, k, it))
            for name in ("morph_open_host", "morph_close_host"):
                np.testing.assert_array_equal(
                    getattr(tmorphology, name)(img, 5),
                    getattr(jmorphology, name)(img, 5))
            got = tmorphology.morph_seq_host(img, seq)
            np.testing.assert_array_equal(
                got, jmorphology.morph_seq_host(img, seq))
            assert got.dtype == img.dtype
    with pytest.raises(ValueError, match="unknown morph op"):
        tmorphology.morph_seq_host(_mask(), (("blur", 5, 1),))


def _check_rotate_mask_host():
    m = _mask() * np.uint8(255)
    for angle in (0.0, 3.5, -17.0, 72.0):
        got = trotate.rotate_mask_host(m, angle)
        np.testing.assert_array_equal(got, jrotate.rotate_mask_host(m, angle))
        assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 1}
        assert got.any()


def _check_polygon():
    rng = np.random.default_rng(13)
    for _ in range(20):
        poly = rng.integers(0, 60, (int(rng.integers(3, 9)), 2)).astype(float)
        for name in ("convex_hull", "make_valid"):
            np.testing.assert_array_equal(getattr(tpolygon, name)(poly),
                                          getattr(jpolygon, name)(poly))
        for name in ("is_convex", "is_simple", "polygon_area_signed"):
            assert getattr(tpolygon, name)(poly) == \
                getattr(jpolygon, name)(poly)


def _merged_page_bytes(merge):
    """A detection with a region across the Border, a line inside it and a
    region outside it, merged through a translation."""
    ns = "{http://schema.primaresearch.org/PAGE/gts/pagecontent/2019-07-15}"
    target = ET.Element(ns + "PcGts")
    page = ET.SubElement(target, ns + "Page")
    page.set("imageWidth", "800")
    page.set("imageHeight", "1000")
    det = ET.fromstring(
        "<PcGts><Page><Border><Coords points='50,50 750,50 750,950 50,950'"
        "/></Border><ReadingOrder><OrderedGroup id='ro'/></ReadingOrder>"
        "<TextRegion id='r0'><Coords points='600,100 790,100 790,400 "
        "600,400'/><TextLine id='l0'><Coords points='610,120 780,120 "
        "780,160 610,160'/></TextLine></TextRegion><TextRegion id='r1'>"
        "<Coords points='760,960 790,960 790,990 760,990'/></TextRegion>"
        "</Page></PcGts>")
    merge.merge_detection_into_page(
        target, det, transform=np.asarray([[1, 0, 5], [0, 1, -7], [0, 0, 1]],
                                          float))
    merge.add_processing_step_metadata(target, executable="x", version="1",
                                       step="s", parameters={"model": "m"})
    return ET.tostring(target)


@pytest.mark.parametrize("what", ["config", "pagexml", "contours", "tiling",
                                  "morphology_host", "rotate_mask_host",
                                  "polygon", "ocrd_merge"])
def test_copies_match_jax_package(what, tmp_path, monkeypatch):
    if what == "polygon":
        _check_polygon()
    elif what == "ocrd_merge":
        got = _merged_page_bytes(tmerge)
        assert got == _merged_page_bytes(jmerge)
        assert b"r0" in got and b"r1" not in got
    elif what == "tiling":
        _check_tiling()
    elif what == "morphology_host":
        _check_morphology_host(monkeypatch)
    elif what == "rotate_mask_host":
        _check_rotate_mask_host()
    elif what == "config":
        assert dataclasses.asdict(tconfig.DEFAULT_CONFIG) == \
            dataclasses.asdict(jconfig.DEFAULT_CONFIG)
    elif what == "pagexml":
        got = _page_xml_bytes(twriter, tconfig, tmp_path, "torch")
        want = _page_xml_bytes(jwriter, jconfig, tmp_path, "jax")
        assert got == want and b"TextLine" in got
    else:
        m = _mask()
        got = tcontours.find_contours(m)
        want = jcontours.find_contours(m)
        assert len(got) == len(want) >= 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert [tcontours.polygon_area(c) for c in got] == \
            [jcontours.polygon_area(c) for c in want]


@pytest.mark.parametrize("fn", [
    runner.SegmentationModel.__init__, runner.ModelBundle.random_init,
    runner.ModelBundle.from_jax_variables, runner.ModelBundle.from_dir,
    tprocessor.OcrdSbbTextlineDetectorRecognize.__init__,
    tbench.ensure_bench_checkpoints],
    ids=lambda f: f.__qualname__)
def test_library_api_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
