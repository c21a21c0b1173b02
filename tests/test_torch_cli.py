"""The port's serving CLI runs where it is told: without a CUDA card it
stops unless `--device cpu` is given, and never moves to the CPU on its
own. A directory of several pages warms the detector up once, at the
first page's shape, before the batch; a single file is served by
process_image, without a warm-up and without the batch's threads."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from sbb_textline_detection_tpu_torch import cli
from sbb_textline_detection_tpu_torch.models import runner
from sbb_textline_detection_tpu_torch.pipeline import detector


@pytest.fixture
def page(tmp_path):
    path = tmp_path / "p.png"
    Image.fromarray(np.full((40, 30, 3), 240, np.uint8)).save(str(path))
    (tmp_path / "out").mkdir()
    return str(path), str(tmp_path / "out")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def detector_calls():
    """What the stub detector was asked: warm_up's (height, width), the
    pages process_batch received and the pages process_image received, in
    order."""
    return []


@pytest.fixture
def stub_pipeline(monkeypatch, detector_calls):
    """Record the device the bundle is built on; skip the pages."""
    seen = []

    def random_init(runtime=None, seed=0, device="cpu", **kw):
        seen.append(device)
        return "bundle"

    class Detector:
        def __init__(self, models, config):
            assert models == "bundle"

        def warm_up(self, height, width):
            detector_calls.append(("warm_up", height, width))
            return {}

        def process_batch(self, pages):
            for img, name in pages:
                detector_calls.append(("page", img.shape[:2], name))
            return iter(())

        def process_image(self, image, image_filename=""):
            detector_calls.append(("image", image.shape[:2],
                                   image_filename))
            return detector.PageResult(ET.ElementTree(ET.Element("PcGts")),
                                       [], [], [], [0, 40, 0, 30], {})

    monkeypatch.setattr(runner.ModelBundle, "random_init",
                        staticmethod(random_init))
    monkeypatch.setattr(detector, "TextlineDetector", Detector)
    return seen


def test_without_cuda_and_no_device_exits_nonzero(page, no_cuda,
                                                  stub_pipeline):
    img, out = page
    res = CliRunner().invoke(cli.main, ["-i", img, "-o", out,
                                        "--synthetic-models"])
    assert res.exit_code != 0
    assert "no CUDA card" in res.output and "--device cpu" in res.output
    assert stub_pipeline == []


def test_explicit_cuda_without_card_exits_nonzero(page, no_cuda,
                                                  stub_pipeline):
    img, out = page
    res = CliRunner().invoke(cli.main, ["-i", img, "-o", out,
                                        "--synthetic-models",
                                        "--device", "cuda:0"])
    assert res.exit_code != 0
    assert stub_pipeline == []


def test_device_cpu_runs_on_the_cpu(page, no_cuda, stub_pipeline):
    img, out = page
    res = CliRunner().invoke(cli.main, ["-i", img, "-o", out,
                                        "--synthetic-models",
                                        "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert stub_pipeline == [torch.device("cpu")]


def test_bad_device_name_exits_nonzero(page, stub_pipeline):
    img, out = page
    res = CliRunner().invoke(cli.main, ["-i", img, "-o", out,
                                        "--synthetic-models",
                                        "--device", "no-such-device"])
    assert res.exit_code == 2
    assert stub_pipeline == []


def test_directory_warms_up_once_at_the_first_page(tmp_path, stub_pipeline,
                                                   detector_calls):
    pages = tmp_path / "pages"
    pages.mkdir()
    Image.fromarray(np.full((40, 30, 3), 240, np.uint8)).save(
        str(pages / "a.png"))
    Image.fromarray(np.full((50, 20, 3), 240, np.uint8)).save(
        str(pages / "b.png"))
    (tmp_path / "out").mkdir()
    res = CliRunner().invoke(cli.main, ["-i", str(pages), "-o",
                                        str(tmp_path / "out"),
                                        "--synthetic-models",
                                        "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert detector_calls == [
        ("warm_up", 40, 30), ("page", (40, 30), str(pages / "a.png")),
        ("page", (50, 20), str(pages / "b.png"))]
    assert "[warm-up " in res.stderr


def test_single_file_runs_without_warm_up(page, stub_pipeline,
                                          detector_calls):
    img, out = page
    res = CliRunner().invoke(cli.main, ["-i", img, "-o", out,
                                        "--synthetic-models",
                                        "--device", "cpu"])
    assert res.exit_code == 0, res.output
    assert detector_calls == [("image", (40, 30), img)]
    assert "[warm-up" not in res.output
    assert os.listdir(out) == ["p.xml"]
