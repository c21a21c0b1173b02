"""The port's serving CLI runs where it is told: without a CUDA card it
stops unless `--device cpu` is given, and never moves to the CPU on its
own."""

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
def stub_pipeline(monkeypatch):
    """Record the device the bundle is built on; skip the pages."""
    seen = []

    def random_init(runtime=None, seed=0, device="cpu", **kw):
        seen.append(device)
        return "bundle"

    class Detector:
        def __init__(self, models, config):
            assert models == "bundle"

        def process_batch(self, pages):
            return iter(())

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
