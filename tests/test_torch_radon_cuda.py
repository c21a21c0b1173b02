"""The Radon wrapper's dispatch rule and the CUDA kernel (csrc/radon.cu)
against its plain PyTorch version. This file imports no JAX, so that the
card's tests run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_radon_cuda.py

Without a card the `cuda` tests skip; the input checks run anywhere.
"""

import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

# f32 sums in another order than the matrix form's: the JAX package's
# Pallas-vs-einsum tolerance
RTOL, ATOL = 1e-4, 1e-2


def _inputs(seed, r, s, n_angles, fill=0.2):
    angles = np.concatenate([
        np.linspace(-25, 25, n_angles - 3), [-90.0, -63.3, 0.0]]
    ).astype(np.float32)
    return radon_bench.noise(seed, r, s, fill), angles


@pytest.mark.parametrize("shape,dtype,match", [
    ((2, 64, 64), torch.float32, "uint8"),
    ((2, 64, 48), torch.uint8, "uint8"),
    ((2, 40, 40), torch.uint8, "multiple of 16"),
], ids=["shape0-dtype0-64-uint8", "shape1-dtype1-64-uint8",
        "shape2-dtype2-40-multiple of 16"])
def test_kernel_wrapper_rejects_bad_canvases(shape, dtype, match):
    with pytest.raises(ValueError, match=match):
        radon.radon_pairs_cuda(torch.zeros(shape, dtype=dtype),
                               torch.zeros(1), torch.zeros(1))


def test_unsupported_device_raises():
    canv = torch.zeros((1, 64, 64), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        radon.radon_pairs(canv, torch.zeros(1, device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("regions,s", radon_bench.SHAPES,
                         ids=["880x512", "220x512", "880x256"])
@pytest.mark.parametrize("kind", ["noise", "lines"])
def test_kernel_matches_plain_on_card(cuda_device, regions, s, kind):
    """The main path's shapes: groups of 8 regions and the tail group of 2,
    110 angles, at both canvas sizes; 20 % noise and text-like bands."""
    if kind == "lines":
        canv = radon_bench.text_bands(5, regions, s)
    else:
        canv = radon_bench.noise(4, regions, s)
    canv = torch.from_numpy(canv).to(cuda_device)
    angles = torch.from_numpy(radon_bench.sweep_angles()).to(cuda_device)
    cosv, sinv = radon.angle_cos_sin(angles)
    want = radon.radon_pairs_plain(canv, cosv, sinv).cpu().numpy()
    before = radon.launches
    got = radon.radon_pairs(canv, angles)
    torch.cuda.synchronize()
    assert radon.launches == before + 1
    assert tuple(got.shape) == (regions * 110, s)
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
def test_card_tensors_never_take_the_plain_version(cuda_device, monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(radon, "radon_pairs_plain", plain)
    canv, angles = _inputs(6, 2, 64, 8)
    out = radon.radon_pairs(*[torch.from_numpy(x).to(cuda_device)
                              for x in (canv, angles)])
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and tuple(out.shape) == (16, 64)


@pytest.mark.cuda
def test_kernel_is_reproducible_on_card(cuda_device):
    """The blocks' partial sums go through integer atomics: 20 launches on
    the same inputs are bitwise equal, and a region's rows do not depend
    on the other regions of its batch."""
    canv = torch.from_numpy(radon_bench.noise(7, 8, 512)).to(cuda_device)
    angles = torch.from_numpy(radon_bench.sweep_angles()).to(cuda_device)
    first = radon.radon_pairs(canv, angles)
    for _ in range(19):
        assert torch.equal(radon.radon_pairs(canv, angles), first)
    n = int(angles.shape[0])
    tail = radon.radon_pairs(canv[6:].contiguous(), angles)
    torch.cuda.synchronize()
    assert torch.equal(tail, first[6 * n:])
