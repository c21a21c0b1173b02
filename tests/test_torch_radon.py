"""The port's Radon sweep (ops/radon.py) against the JAX package: the plain
version against deskew._radon_pairs (einsum path) and against the Pallas
kernel in interpret mode. The CUDA kernel against the plain version on the
card is in test_torch_radon_cuda.py, which imports no JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.ops import pallas_radon
from sbb_textline_detection_tpu.pipeline import deskew as jdeskew
from sbb_textline_detection_tpu_torch.ops import radon

# f32 sums in a different order (and, on the card, atomics): the same
# tolerance as the JAX package's Pallas-vs-einsum test
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


@pytest.mark.parametrize("s", [64, 256])
def test_plain_matches_jax_einsum(s):
    canv, angles, ridx, aidx = _inputs(0, 2, s, 8)
    want = np.asarray(jdeskew._radon_pairs(
        jnp.asarray(canv, jnp.float32), jnp.asarray(angles),
        jnp.asarray(ridx), jnp.asarray(aidx), s, 8, False))
    got = radon.radon_pairs(torch.from_numpy(canv),
                            torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_plain_matches_pallas_interpret():
    """A and B built from the same angles as the port's plain version,
    through the TPU kernel in interpret mode, S = 256."""
    s = 256
    canv, angles, ridx, aidx = _inputs(1, 2, s, 4)
    c = float(s // 2)
    idx = np.arange(s, dtype=np.float32)
    rad = np.deg2rad(angles[aidx]).astype(np.float32)
    a, b = np.cos(rad), np.sin(rad)
    fy = a[:, None] * (idx - c) + c
    gx = -b[:, None] * (idx - c) + c
    hat = lambda x: np.maximum(0.0, 1.0 - np.abs(x)).astype(np.float32)
    A = hat(idx[None, :, None] - fy[:, None, :])
    Bxu = hat(idx[None, None, :] - gx[:, :, None])
    want = np.asarray(pallas_radon.radon_profiles_pallas(
        jnp.asarray(A), jnp.asarray(canv[ridx], jnp.float32),
        jnp.asarray(Bxu), interpret=True))
    got = radon.radon_pairs(torch.from_numpy(canv),
                            torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_angle_zero_is_exact_row_sums():
    s = 64
    canv, _, _, _ = _inputs(2, 1, s, 4)
    got = radon.radon_pairs(torch.from_numpy(canv), torch.zeros(1)).numpy()
    np.testing.assert_array_equal(got[0], canv[0].sum(axis=1))


def test_cpu_tensors_do_not_count_launches():
    s = 64
    canv, angles, ridx, aidx = _inputs(3, 1, s, 4)
    radon.launches = 0
    radon.radon_pairs(torch.from_numpy(canv), torch.from_numpy(angles))
    assert radon.launches == 0
