"""ops/cc.py of the port against the JAX package's ops/cc.py on the same
seeded numpy masks (the cases of tests/test_cc.py): labels, top-k boxes
and the largest box must be EQUAL, value for value (integer outputs, no
tolerance)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.ops import cc as jcc
from sbb_textline_detection_tpu.ops import contours as jcontours
from sbb_textline_detection_tpu_torch.ops import cc

from tests.test_cc import _random_blob_mask


@functools.lru_cache(maxsize=None)
def _jax_labels():
    return jax.jit(jcc.label_components)


@functools.lru_cache(maxsize=None)
def _jax_topk(k):
    return jax.jit(lambda m, lo, hi: jcc.component_boxes_topk(m, k, lo, hi))


def _labels(m):
    want = np.asarray(_jax_labels()(jnp.asarray(m)))
    got = cc.label_components(torch.from_numpy(m))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    return want


def _spiral():
    m = np.zeros((41, 41), np.uint8)
    m[0, :] = 1
    for k in range(1, 20, 2):
        m[k * 2, k:41 - k] = 1
        m[k * 2 - 1, 41 - k - 1] = 1 if k % 4 == 1 else 0
        m[k * 2 + 1, k] = 1
    return m


@pytest.mark.parametrize("case", [f"blobs{s}" for s in range(4)]
                         + ["noise", "spiral", "empty", "full"])
def test_labels_match_jax(case):
    """Equal labels, and the partition of the host oracle (dense ids)."""
    if case.startswith("blobs"):
        rng = np.random.default_rng(int(case[5:]))
        m = _random_blob_mask(rng, 40, 56, int(rng.integers(1, 7)))
    elif case == "noise":
        m = (np.random.default_rng(99).random((64, 48)) < 0.45
             ).astype(np.uint8)
    elif case == "spiral":
        m = _spiral()
    else:
        m = np.full((24, 32), case == "full", np.uint8)
    lab = _labels(m)
    host, n = jcontours.label_components(m)
    assert ((lab == m.size) == (host == 0)).all()
    pairs = {(int(a), int(b)) for a, b in zip(host.ravel(), lab.ravel())
             if a != 0}
    assert len(pairs) == n == len({b for _, b in pairs})


@pytest.mark.parametrize("seed", range(4))
def test_largest_component_box_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    m = _random_blob_mask(rng, 48, 64, int(rng.integers(1, 6)))
    box, valid = jax.jit(jcc.largest_component_box)(jnp.asarray(m))
    got, got_valid = cc.largest_component_box(torch.from_numpy(m))
    assert got.tolist() == np.asarray(box).tolist()
    assert bool(got_valid) == bool(valid) is True


def test_empty_mask_gives_an_invalid_zero_box():
    got, valid = cc.largest_component_box(torch.zeros((32, 32),
                                                      dtype=torch.uint8))
    want, jvalid = jax.jit(jcc.largest_component_box)(
        jnp.zeros((32, 32), np.uint8))
    assert got.tolist() == np.asarray(want).tolist() == [0, 0, 0, 0]
    assert not bool(valid) and not bool(jvalid)


@pytest.mark.parametrize("seed", range(4))
def test_topk_matches_jax_and_covers_host_boxes(seed):
    """The speculative deskew's contract: equal rows, and every host
    contour box that passes the reference area filter appears among the
    valid rows."""
    from sbb_textline_detection_tpu.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu.pipeline import stages as jstages

    rng = np.random.default_rng(200 + seed)
    m = _random_blob_mask(rng, 80, 96, int(rng.integers(1, 8)))
    area = float(m.size)
    lo = 0.5 * DEFAULT_CONFIG.region.min_area_ratio * area
    want = np.asarray(_jax_topk(16)(jnp.asarray(m), jnp.float32(lo),
                                    jnp.float32(area)))
    got = cc.component_boxes_topk(torch.from_numpy(m), 16, lo, area)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    dev = {tuple(int(v) for v in b[:4]) for b in want if b[4]}
    _, host_boxes = jstages.region_contours_and_boxes(m, DEFAULT_CONFIG)
    assert all((y, x, h, w) in dev for x, y, w, h in host_boxes)


@pytest.mark.parametrize("k,lo,rows", [
    (4, 2.0, [[2, 2, 28, 28, 1], [50, 45, 10, 15, 1], [0] * 5, [0] * 5]),
    (2, 1.0, [[2, 2, 28, 28, 1], [40, 40, 1, 1, 1]]),
    (3, 200.0, [[2, 2, 28, 28, 1], [0] * 5, [0] * 5]),
], ids=["speck-filtered", "truncated", "min-area"])
def test_topk_filters_compacts_and_truncates(k, lo, rows):
    m = np.zeros((64, 64), np.uint8)
    m[2:30, 2:30] = 1          # 784 px
    m[40, 40] = 1              # one pixel
    m[50:60, 45:60] = 1        # 150 px
    want = np.asarray(_jax_topk(k)(jnp.asarray(m), jnp.float32(lo),
                                   jnp.float32(1e9)))
    got = cc.component_boxes_topk(torch.from_numpy(m), k, lo, 1e9)
    assert got.tolist() == want.tolist() == rows
