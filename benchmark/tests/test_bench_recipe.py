"""The benchmark's frozen weight recipe and page renderer on the CPU: the
recipe's checkpoints load through the program's ModelBundle.from_dir with
the trained values, the recipe repeats bit for bit, and the frozen
renderer and training batches equal the port's copies today."""

import numpy as np
import pytest
import torch

from benchmark import plain_unet, pool, recipe, synthetic
from benchmark.tests import tiny

CONFIG = {"roles": {
    "page": {"file": "model_page_mixed_best", "data": "page", "steps": 2,
             "spec": tiny.spec("model_page_mixed_best", 2)},
    "region": {"file": "model_strukturerkennung", "data": "region",
               "steps": 2, "spec": tiny.spec("model_strukturerkennung", 3)},
    "textline": {"file": "model_textline_new", "data": "textline",
                 "steps": 2, "spec": tiny.spec("model_textline_new", 2)}},
    "recipe": {"seed": 0, "learning_rate": 3e-4, "weight_decay": 1e-4,
               "batch": 2}}


def _train(path):
    try:
        recipe.ensure(CONFIG, str(path), "cpu")
    finally:
        torch.use_deterministic_algorithms(False)


def _states(path):
    out = {}
    for role, entry in CONFIG["roles"].items():
        module = plain_unet.build(entry["spec"])
        out[role] = plain_unet.load(str(path / (entry["file"] + ".npz")),
                                    module)
    return out


def test_recipe_checkpoints_load_through_from_dir(tmp_path):
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle

    _train(tmp_path)
    bundle = ModelBundle.from_dir(str(tmp_path), DEFAULT_CONFIG.runtime,
                                  "cpu", DEFAULT_CONFIG.model_names,
                                  dtype=torch.float32)
    states = _states(tmp_path)
    init = plain_unet.build(CONFIG["roles"]["page"]["spec"])
    init = plain_unet.init_state(init, 0)
    for role in ("page", "region", "textline"):
        got = getattr(bundle, role).module.state_dict()
        assert set(got) == set(states[role])
        for key, value in states[role].items():
            assert torch.equal(got[key], value), (role, key)
    # trained: the recipe moved the weights from their initial draw
    assert not torch.equal(states["page"]["stem.conv.weight"],
                           init["stem.conv.weight"])


def test_recipe_repeats_bit_for_bit(tmp_path):
    _train(tmp_path / "a")
    _train(tmp_path / "b")
    a, b = _states(tmp_path / "a"), _states(tmp_path / "b")
    for role in a:
        assert plain_unet.state_sha256(a[role]) == \
            plain_unet.state_sha256(b[role])


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
