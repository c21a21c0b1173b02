"""The serving mesh on the card with the library's defaults. This file
imports no JAX, so that it runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_mesh_cuda.py

Without a card the tests skip.

Tolerance: none; the model computes in float32 with TF32 off
(ops/precision.full_f32), and the labels must be EQUAL. On one card the
default mesh has one member, which runs the unmeshed model's chunks.
"""

import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu_torch.core.config import RuntimeConfig
from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from sbb_textline_detection_tpu_torch.models import runner
from sbb_textline_detection_tpu_torch.parallel import mesh as mesh_mod

SPEC = registry.ModelSpec("mesh_cuda", "tpu_unet", 64, 64, 2,
                          widths=(8, 16))


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_default_device_is_the_default_mesh_first_member(cuda_device):
    """device="cuda" and make_mesh()'s cuda:0..N-1 name the same card:
    the first member is the model's own module, and the meshed model's
    tiled and whole-image labels equal the unmeshed model's."""
    state = checkpoint.random_init(SPEC, torch.Generator().manual_seed(0))
    runtime = RuntimeConfig(tile_chunk=4)
    plain = runner.SegmentationModel(SPEC, state, runtime,
                                     device=cuda_device, dtype=torch.float32)
    mesh = mesh_mod.make_mesh()
    meshed = runner.SegmentationModel(SPEC, state, runtime,
                                      device=cuda_device,
                                      dtype=torch.float32, mesh=mesh)
    assert meshed.device == torch.device("cuda",
                                         torch.cuda.current_device())
    assert meshed.members[0][0] == meshed.device
    assert meshed.members[0][1] is meshed.module
    img = np.random.default_rng(0).integers(0, 256, (150, 200, 3), np.uint8)
    np.testing.assert_array_equal(meshed.predict_tiled(img),
                                  plain.predict_tiled(img))
    np.testing.assert_array_equal(meshed.predict_whole_small(img),
                                  plain.predict_whole_small(img))
