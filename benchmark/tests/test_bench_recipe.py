"""The benchmark's frozen weight recipe and page renderer on the CPU: the
recipe's checkpoints of either architecture (TpuUnet, ResNet50-UNet) load
through the program's ModelBundle.from_dir with the trained values, the
recipe repeats bit for bit, and the frozen renderer and training batches
equal the port's copies today."""

import numpy as np
import pytest
import torch

from benchmark import plain_resnet, plain_unet, pool, recipe, synthetic
from benchmark.tests import tiny

CONFIGS = {"tpu_unet": tiny.three_roles(tiny.spec),
           "resnet50_unet": tiny.three_roles(tiny.resnet_spec)}


def _train(config, path):
    try:
        recipe.ensure(config, str(path), "cpu")
    finally:
        torch.use_deterministic_algorithms(False)


def _states(config, path):
    out = {}
    for role, entry in config["roles"].items():
        module = plain_unet.build(entry["spec"])
        out[role] = plain_unet.load(str(path / (entry["file"] + ".npz")),
                                    module)
    return out


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_recipe_checkpoints_load_through_from_dir(tmp_path, arch):
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle

    config = CONFIGS[arch]
    _train(config, tmp_path)
    bundle = ModelBundle.from_dir(str(tmp_path), DEFAULT_CONFIG.runtime,
                                  "cpu", DEFAULT_CONFIG.model_names,
                                  dtype=torch.float32)
    states = _states(config, tmp_path)
    for role in ("page", "region", "textline"):
        assert getattr(bundle, role).spec.arch == arch
        got = getattr(bundle, role).module.state_dict()
        assert set(got) == set(states[role])
        for key, value in states[role].items():
            assert torch.equal(got[key], value), (role, key)
    # trained: the recipe moved the weights from their initial draw
    init = plain_unet.build(config["roles"]["page"]["spec"])
    init = plain_unet.init_state(init, 0)
    first = next(k for k, v in init.items() if v.ndim == 4)
    assert not torch.equal(states["page"][first], init[first])
    # and the BatchNorms' running statistics moved off their 0 and 1
    for key, value in states["page"].items():
        if key.endswith("running_mean"):
            assert value.abs().max() > 0, key
        elif key.endswith("running_var"):
            assert (value != 1).any(), key


@pytest.mark.parametrize("arch", list(CONFIGS))
def test_recipe_repeats_bit_for_bit(tmp_path, arch):
    _train(CONFIGS[arch], tmp_path / "a")
    _train(CONFIGS[arch], tmp_path / "b")
    a = _states(CONFIGS[arch], tmp_path / "a")
    b = _states(CONFIGS[arch], tmp_path / "b")
    for role in a:
        assert plain_unet.state_sha256(a[role]) == \
            plain_unet.state_sha256(b[role])


def test_recalibrate_averages_the_batch_statistics():
    """A BatchNorm's running mean and variance after recalibrate are the
    plain means of the batches' means and biased variances, and it trains
    at momentum 0.99 again after."""
    norm = plain_resnet.BatchNorm(3).train()
    gen = torch.Generator().manual_seed(0)
    xs = [2.0 + 3.0 * torch.randn(4, 3, 5, 5, generator=gen)
          for _ in range(3)]
    plain_resnet.recalibrate(norm, xs)
    means = torch.stack([x.mean((0, 2, 3)) for x in xs])
    variances = torch.stack([x.var((0, 2, 3), unbiased=False) for x in xs])
    torch.testing.assert_close(norm.running_mean, means.mean(0))
    torch.testing.assert_close(norm.running_var, variances.mean(0))
    assert norm.momentum == plain_resnet.BN_MOMENTUM


@pytest.mark.parametrize("role", ["page", "region", "textline", "dualhead"])
def test_frozen_batches_equal_the_ports(role):
    from sbb_textline_detection_tpu_torch.utils import synthetic as port

    got = synthetic.BATCH_FNS[role](np.random.default_rng(3), 3, 96, 80)
    want = port.BATCH_FNS[role](np.random.default_rng(3), 3, 96, 80)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(g, w, atol=1e-6)


@pytest.mark.parametrize("kind", [(0.0, 0.8, 0, 0.0, False),
                                  (18.0, 0.0, 2, 0.0, False),
                                  (0.0, 0.0, 0, 0.0, True),
                                  (-8.0, 0.8, 0, 0.4, False)])
def test_frozen_pages_equal_the_ports(kind):
    from sbb_textline_detection_tpu_torch.utils import synthetic as port

    img, layout = pool.render(2 ** 31 + 11, 3, kind, 700, 500)
    skew, degrade, figures, bleed, vertical = kind
    want, want_layout = port.make_page(
        np.random.default_rng([2 ** 31 + 11, 3]), 700, 500, skew_deg=skew,
        degrade=degrade, figures=figures, bleed=bleed, vertical=vertical)
    np.testing.assert_array_equal(img, want)
    assert layout.line_boxes == want_layout.line_boxes
    again, _ = pool.render(2 ** 31 + 11, 3, kind, 700, 500)
    np.testing.assert_array_equal(img, again)
