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

import numpy as np
import pytest

from sbb_textline_detection_tpu.core import config as jconfig
from sbb_textline_detection_tpu.ops import contours as jcontours
from sbb_textline_detection_tpu.pagexml import writer as jwriter
from sbb_textline_detection_tpu_torch.core import config as tconfig
from sbb_textline_detection_tpu_torch.models import runner
from sbb_textline_detection_tpu_torch.ops import contours as tcontours
from sbb_textline_detection_tpu_torch.pagexml import writer as twriter

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "sbb_textline_detection_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
MODULES = sorted(
    "sbb_textline_detection_tpu_torch." + ".".join(
        p.relative_to(PKG).with_suffix("").parts).replace(".__init__", "")
    for p in PKG.rglob("*.py"))
# h5py too: the port reads Keras .h5 files only inside the functions that
# need it, and the card's machine may not have it
BLOCKED = ("jax", "jaxlib", "flax", "optax", "sbb_textline_detection_tpu",
           "h5py")


def test_port_imports_with_jax_blocked():
    code = ("import sys, importlib, importlib.util\n"
            f"for m in {BLOCKED!r}:\n"
            "    sys.modules[m] = None\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke', "
            f"{str(SMOKE)!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
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


@pytest.mark.parametrize("what", ["config", "pagexml", "contours"])
def test_copies_match_jax_package(what, tmp_path):
    if what == "config":
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
    runner.ModelBundle.from_jax_variables, runner.ModelBundle.from_dir],
    ids=lambda f: f.__qualname__)
def test_library_api_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
