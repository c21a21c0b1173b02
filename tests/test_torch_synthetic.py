"""The port's synthetic training streams and host rotation against the JAX
package's: given the same rng they are bit-equal."""

import os
import shutil
import subprocess

import numpy as np
import pytest

from sbb_textline_detection_tpu import native_bridge as jnative
from sbb_textline_detection_tpu.ops import rotate as jrotate
from sbb_textline_detection_tpu.training import data as jdata
from sbb_textline_detection_tpu.utils import synthetic as jsyn
from sbb_textline_detection_tpu_torch import native_bridge
from sbb_textline_detection_tpu_torch.ops import rotate
from sbb_textline_detection_tpu_torch.training import data
from sbb_textline_detection_tpu_torch.utils import synthetic

ROLES = ("page", "region", "textline", "dualhead")


def _assert_batches_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("role", ROLES)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_fns_equal_jax(role, seed):
    """64x64 patches, batch 2 (under 224 px: no page pool)."""
    assert set(synthetic.BATCH_FNS) == set(jsyn.BATCH_FNS) == set(ROLES)
    got = synthetic.BATCH_FNS[role](np.random.default_rng(seed), 2, 64, 64)
    want = jsyn.BATCH_FNS[role](np.random.default_rng(seed), 2, 64, 64)
    _assert_batches_equal(got, want)


@pytest.mark.parametrize("role", ROLES)
def test_synthetic_batches_stream_equals_jax(role):
    """Two batches of each role's endless stream, 48x40, batch 2."""
    got = data.synthetic_batches(role, 2, 48, 40, seed=3)
    want = jdata.synthetic_batches(role, 2, 48, 40, seed=3)
    for _ in range(2):
        _assert_batches_equal(next(got), next(want))


def test_dualhead_page_crop_stream_equals_jax(monkeypatch):
    """At 224 px the dual-head batch draws page crops. Both modules get one
    small pool of the same two pages (a rendered pool costs tens of
    seconds), so the crops, and every patch around them, are equal."""
    rng = np.random.default_rng(5)
    pool = []
    for _ in range(2):
        gray = rng.integers(0, 256, (300, 260)).astype(np.uint8)
        packed = rng.integers(0, 8, (300, 260)).astype(np.uint8)
        pool.append((gray, packed))
    monkeypatch.setattr(jsyn, "_PAGE_POOL", pool)
    monkeypatch.setattr(synthetic, "_PAGE_POOL", pool)
    crops = []
    page_crop = synthetic._page_crop

    def counted(*args):
        crops.append(args)
        return page_crop(*args)

    monkeypatch.setattr(synthetic, "_page_crop", counted)
    got = synthetic.dualhead_batch(np.random.default_rng(8), 6, 224, 224)
    want = jsyn.dualhead_batch(np.random.default_rng(8), 6, 224, 224)
    _assert_batches_equal(got, want)
    assert 0 < len(crops) < 6


def test_render_pool_page_equals_jax():
    """Seed 4 draws a 23.8 degree skew, degradation, 2 figures and bleed
    on an A4 page: the working-resolution gray page and its packed masks
    are equal."""
    got = synthetic._render_pool_page(np.random.default_rng(4))
    want = jsyn._render_pool_page(np.random.default_rng(4))
    _assert_batches_equal(got, want)
    assert got[0].shape == (4209, 2975)


def test_page_pool_is_the_ports_own(monkeypatch):
    """The port builds its pool from the first caller's rng, apart from the
    JAX module's."""
    calls = []

    def fake_page(rng, kind=None):
        calls.append(int(rng.integers(1000)))
        return np.zeros((4, 4), np.uint8), np.zeros((4, 4), np.uint8)

    monkeypatch.setattr(synthetic, "_PAGE_POOL", None)
    monkeypatch.setattr(synthetic, "_render_pool_page", fake_page)
    pool = synthetic._get_page_pool(np.random.default_rng(0))
    assert len(pool) == synthetic._PAGE_POOL_SIZE == len(calls)
    assert synthetic._get_page_pool(np.random.default_rng(1)) is pool
    assert jsyn._PAGE_POOL is not pool


@pytest.fixture(scope="module")
def native_library(tmp_path_factory):
    """The host library loaded by both bridges. A fresh checkout has no
    build of it, and whether another test file's `make -C native` has
    finished by now depends on how the files fall on the workers: so,
    where it is missing, a private copy of native/ is built in a temporary
    directory (nothing another worker may be writing is touched) and both
    bridges load that."""
    bridges = (native_bridge, jnative)
    if all(b.available() for b in bridges):
        return
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    build = str(tmp_path_factory.mktemp("native_build") / "native")
    shutil.copytree(src, build, ignore=shutil.ignore_patterns("*.o", "*.so"))
    try:
        subprocess.run(["make", "-C", build], check=True,
                       capture_output=True, timeout=600)
    except (OSError, subprocess.CalledProcessError):
        pytest.skip("no C++ toolchain to build libsbbnative.so")
    mp = pytest.MonkeyPatch()
    mp.setenv("SBB_NATIVE_LIB", os.path.join(build, "libsbbnative.so"))
    try:
        for b in bridges:
            if not b.available():
                b._load_attempted = False
        if not all(b.available() for b in bridges):
            pytest.skip("libsbbnative.so failed to load")
    finally:
        mp.undo()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("order", [0, 1, 3])
def test_rotate_image_host_equals_jax(monkeypatch, native_library, order,
                                      native):
    """Both the native dispatch and the numpy path, 2-D and 3-D inputs.
    The port and the JAX package each load the library through their own
    bridge, so the numpy case turns off both."""
    if not native:
        for bridge in (native_bridge, jnative):
            monkeypatch.setattr(bridge, "available", lambda: False)
    rng = np.random.default_rng(order)
    for img in (rng.uniform(size=(37, 52)),
                rng.uniform(size=(30, 24, 3)) * 255.0):
        for ang in (-17.5, 0.0, 3.25, 90.0):
            got = rotate.rotate_image_host(img, ang, order=order)
            want = jrotate.rotate_image_host(img, ang, order=order)
            assert got.shape == want.shape
            np.testing.assert_array_equal(got, want)


def test_rotate_image_host_rejects_other_orders(monkeypatch):
    """The numpy path (the native one serves orders 0, 1 and 3 only)."""
    monkeypatch.setattr(native_bridge, "available", lambda: False)
    with pytest.raises(ValueError):
        rotate.rotate_image_host(np.zeros((4, 4)), 5.0, order=2)
