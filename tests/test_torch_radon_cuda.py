"""The Radon wrapper's dispatch rule and the CUDA kernel (csrc/radon.cu)
against its plain PyTorch version. This file imports no JAX, so that the
card's tests run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_radon_cuda.py

Without a card the `cuda` tests skip; the input checks run anywhere.
"""

import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu_torch.ops import radon

# f32 sums in another order, and shared-memory atomics in an order that
# changes from run to run: the JAX package's Pallas-vs-einsum tolerance
RTOL, ATOL = 1e-4, 1e-2


def _inputs(seed, r, s, n_angles, fill=0.2):
    rng = np.random.default_rng(seed)
    canv = (rng.uniform(size=(r, s, s)) < fill).astype(np.uint8)
    angles = np.concatenate([
        np.linspace(-25, 25, n_angles - 3), [-90.0, -63.3, 0.0]]
    ).astype(np.float32)
    ridx = np.repeat(np.arange(r), n_angles).astype(np.int32)
    aidx = np.tile(np.arange(n_angles), r).astype(np.int32)
    return canv, angles, ridx, aidx


def _lines(seed, r, s):
    """Mostly empty canvases with skewed bars, like the sweep's real
    inputs (most 16-byte vectors are zero)."""
    rng = np.random.default_rng(seed)
    canv = np.zeros((r, s, s), np.uint8)
    xs = np.arange(s // 4, 3 * s // 4)
    for i in range(r):
        t = np.tan(np.deg2rad(rng.uniform(-20, 20)))
        for y0 in range(s // 4, 3 * s // 4, 24):
            for k in range(8):
                ys = np.round(y0 + k + t * (xs - s / 2)).astype(int)
                ok = (ys >= 0) & (ys < s)
                canv[i, ys[ok], xs[ok]] = 1
    return canv


@pytest.mark.parametrize("shape,dtype,s,match", [
    ((2, 64, 64), torch.float32, 64, "uint8"),
    ((2, 64, 48), torch.uint8, 64, "uint8"),
    ((2, 40, 40), torch.uint8, 40, "multiple of 16"),
])
def test_kernel_wrapper_rejects_bad_canvases(shape, dtype, s, match):
    args = (torch.zeros(shape, dtype=dtype), torch.zeros(1), torch.zeros(1),
            torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        radon.radon_pairs_cuda(*args, s)


def test_unsupported_device_raises():
    canv = torch.zeros((1, 64, 64), dtype=torch.uint8, device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        radon.radon_pairs(canv, torch.zeros(1, device="meta"), idx, idx, 64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("s,kind", [(256, "noise"), (512, "noise"),
                                    (512, "lines")])
def test_kernel_matches_plain_on_card(cuda_device, s, kind):
    canv, angles, ridx, aidx = _inputs(4, 8, s, 110)
    if kind == "lines":
        canv = _lines(5, 8, s)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (canv, angles, ridx, aidx)]
    cosv, sinv = radon.angle_cos_sin(args[1])
    want = radon.radon_pairs_plain(args[0], cosv, sinv, args[2], args[3],
                                   s).cpu().numpy()
    before = radon.launches
    got = radon.radon_pairs(*args, s)
    torch.cuda.synchronize()
    assert radon.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL,
                               atol=ATOL)


@pytest.mark.cuda
def test_card_tensors_never_take_the_plain_version(cuda_device, monkeypatch):
    def plain(*a, **k):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(radon, "radon_pairs_plain", plain)
    canv, angles, ridx, aidx = _inputs(6, 2, 64, 8)
    out = radon.radon_pairs(*[torch.from_numpy(x).to(cuda_device)
                              for x in (canv, angles, ridx, aidx)], 64)
    torch.cuda.synchronize()
    assert out.device.type == "cuda" and tuple(out.shape) == (16, 64)
