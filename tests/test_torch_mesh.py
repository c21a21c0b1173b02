"""The port's serving mesh (parallel/mesh.py, `SegmentationModel(mesh=)`)
against the unmeshed port and the JAX package's 8-device CPU mesh: the
counterparts of tests/test_parallel_inference.py. The port's mesh has 8
members on the CPU (one device repeated, each member with its own replica
of the weights), so every page's tile chunks are dealt over 8 modules.

Tolerance: none; every output is a label map, mask or PAGE-XML and must
be EQUAL. The pointwise stubs make that exact by construction. The tiny
float32 dual-head model runs the crops of tests/test_torch_batch.py, whose
stitched pixels all have a top-2 logit gap above 1e-4 (asserted there and
here): meshed chunks have other batch sizes than unmeshed ones, and the
f32 sums may differ by rounding, which such a gap absorbs.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.core.config import RuntimeConfig as JRuntime
from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import runner as jrunner
from sbb_textline_detection_tpu.parallel import mesh as jmesh
from sbb_textline_detection_tpu_torch.core.config import (ModelNames,
                                                          RuntimeConfig)
from sbb_textline_detection_tpu_torch.models import checkpoint, runner
from sbb_textline_detection_tpu_torch.ops import threshold
from sbb_textline_detection_tpu_torch.parallel import mesh as mesh_mod
from sbb_textline_detection_tpu_torch.pipeline import detector

from tests.test_models import TINY, _PointwiseStub
from tests.test_torch_batch import (_assert_results_equal, _cfg, _multi_crops,
                                    _pages)
from tests.test_torch_detector import DUAL_TINY, PAGE_TINY, bundles
from tests.test_torch_fused import models
from tests.test_torch_standard import SHAPING


@pytest.fixture(scope="module")
def mesh8():
    return mesh_mod.make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh8():
    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs the 8-device CPU mesh from conftest")
    return jmesh.make_mesh(devices[:8], model_parallel=1)


class _TorchPointwise(torch.nn.Module):
    """class = channel 0 > 0.5, per pixel (the port's _PointwiseStub)."""

    dtype = torch.float32

    def forward_nchw(self, x):
        b = (x[:, 0] > 0.5).to(torch.float32)
        return torch.stack([1.0 - b, b], 1)


class _TorchDualStub(_TorchPointwise):
    """Region head = raw01 > 0.5, textline head = the binarized channel."""

    def forward_nchw(self, x):
        raw = (x[:, 0] > 0.5).to(torch.float32)
        binz = (x[:, 1] > 0.5).to(torch.float32)
        return torch.stack([1.0 - raw, raw, torch.zeros_like(raw),
                            1.0 - binz, binz], 1)


class _Counting(_TorchPointwise):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def forward_nchw(self, x):
        self.calls += 1
        return super().forward_nchw(x)


def _stub(model, module):
    model.module = module
    model.members = [(dev, module) for dev, _ in model.members]
    return model


def _port_model(spec, mesh):
    spec = runner._as_spec(spec)
    return runner.SegmentationModel(
        spec, checkpoint.random_init(spec, torch.Generator().manual_seed(0)),
        RuntimeConfig(tile_chunk=5), device="cpu", dtype=torch.float32,
        mesh=mesh)


def test_make_mesh_shapes_and_errors():
    m = mesh_mod.make_mesh(["cpu"] * 4, model_parallel=2)
    assert m.shape == {"data": 2, "model": 2}
    assert m.data_members == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="not divisible by model=3"):
        mesh_mod.make_mesh(["cpu"] * 4, model_parallel=3)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="no CUDA device"):
            mesh_mod.make_mesh()


def test_untiled_forward_runs_the_model_on_its_device():
    """A mesh whose first member lies on another device than the model:
    the forwards that no mesh spreads (whole image, page box) run the
    model's own module on its device, as unmeshed. The members here sit
    on the meta device, where a forward on a CPU tensor fails."""
    spec = runner._as_spec(TINY)
    state = checkpoint.random_init(spec, torch.Generator().manual_seed(0))
    plain = runner.SegmentationModel(spec, state, device="cpu",
                                     dtype=torch.float32)
    meshed = runner.SegmentationModel(
        spec, state, device="cpu", dtype=torch.float32,
        mesh=mesh_mod.make_mesh(["meta", "meta"]))
    assert [dev for dev, _ in meshed.members] == [torch.device("meta")] * 2
    assert all(m is not meshed.module for _, m in meshed.members)
    img = np.random.default_rng(0).integers(0, 256, (50, 70, 3), np.uint8)
    np.testing.assert_array_equal(meshed.predict_whole_small(img),
                                  plain.predict_whole_small(img))


def test_sharded_tiled_matches_single_device_stub(mesh8, jmesh8):
    """Pointwise stub network: the meshed and unmeshed tiled paths equal
    the thresholded image, as the JAX package's sharded path does. A
    page of n tiles runs in chunks of at most ceil(n / 8), dealt to
    members 0, 1, ... in turn."""
    m_single = _stub(_port_model(TINY, None), _TorchPointwise())
    m_shard = _port_model(TINY, mesh8)
    counters = [_Counting() for _ in range(8)]
    m_shard.members = [(dev, c) for (dev, _), c in zip(m_shard.members,
                                                        counters)]
    jm = jrunner.SegmentationModel(TINY, jreg.init_variables(TINY, seed=0),
                                   JRuntime(batch_buckets=(2, 4, 8)),
                                   mesh=jmesh8)
    jm._module = _PointwiseStub()
    jm._tiled_cache.clear()
    rng = np.random.default_rng(0)
    want_calls = np.zeros(8, int)
    for shape in [(104, 156), (200, 53), (150, 131)]:
        n = int(np.prod(m_shard.grid_for(*shape)))
        chunk = runner._balanced_chunk(n, min(5, -(-n // 8)))
        want_calls[np.arange(-(-n // chunk)) % 8] += 1
        img = rng.integers(0, 255, shape + (3,)).astype(np.uint8)
        got = m_shard.predict_tiled(img)
        np.testing.assert_array_equal(got, m_single.predict_tiled(img))
        np.testing.assert_array_equal(
            got, (img[:, :, 0] > 127.5).astype(np.uint8))
        if shape == (104, 156):
            np.testing.assert_array_equal(got, jm.predict_tiled(img))
    assert [c.calls for c in counters] == want_calls.tolist()
    assert want_calls.min() >= 1


def test_sharded_tiled_real_model_matches_unsharded_and_jax(models, mesh8,
                                                            jmesh8):
    """The tiny f32 dual-head model over 8 members: equal to the port's
    unmeshed model and to the JAX model sharded over its 8 devices, and
    the same twice."""
    jm, tm = models
    crops = _multi_crops(jm)
    state = {k: v.clone() for k, v in tm.module.state_dict().items()}
    tm8 = runner.SegmentationModel(tm.spec, state, tm.runtime, device="cpu",
                                   dtype=torch.float32, mesh=mesh8)
    jm8 = jrunner.SegmentationModel(jm.spec, jm.variables, jm.runtime,
                                    mesh=jmesh8)
    for crop in crops[:2]:
        got = tm8.predict_dual_tiled(tm8, crop, **SHAPING)
        want = tm.predict_dual_tiled(tm, crop, **SHAPING)
        for g, w, j in zip(got, want,
                           jm8.predict_dual_tiled(jm8, crop, **SHAPING)):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j)
        assert 0 < got[0].sum() < got[0].size
        for g, again in zip(got, tm8.predict_dual_tiled(tm8, crop,
                                                        **SHAPING)):
            np.testing.assert_array_equal(g, again)


def test_bundle_accepts_mesh(mesh8, tmp_path):
    """Every constructor of the bundle takes a mesh; each model holds one
    replica per data member, equal to its own weights, and not shared
    with another member."""
    specs = {"page": PAGE_TINY, "region": DUAL_TINY, "textline": None}
    bundle = runner.ModelBundle.random_init(RuntimeConfig(), device="cpu",
                                            specs=specs, mesh=mesh8)
    assert bundle.region.mesh is mesh8 and bundle.page.mesh is mesh8
    assert bundle.is_dual_head
    mods = [m for _, m in bundle.region.members]
    assert len(mods) == 8 and mods[0] is bundle.region.module
    assert len({id(m) for m in mods}) == 8
    for m in mods[1:]:
        for a, b in zip(m.parameters(), mods[0].parameters()):
            assert a.data_ptr() != b.data_ptr()
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    names = ModelNames()
    for role, model in (("page", bundle.page), ("dualhead", bundle.region)):
        checkpoint.save(checkpoint.npz_path(str(tmp_path),
                                            getattr(names, role)),
                        dataclasses.replace(model.spec,
                                            name=getattr(names, role)),
                        model.module.state_dict())
    loaded = runner.ModelBundle.from_dir(str(tmp_path), device="cpu",
                                         mesh=mesh8)
    assert loaded.region.mesh is mesh8 and len(loaded.region.members) == 8
    jv = jreg.init_variables(PAGE_TINY, seed=0)
    fj = runner.ModelBundle.from_jax_variables(
        (PAGE_TINY, jv), (PAGE_TINY, jv), (PAGE_TINY, jv), device="cpu",
        mesh=mesh8)
    assert fj.textline.mesh is mesh8 and len(fj.textline.members) == 8


def test_multi_page_fused_sharded_matches_unsharded(models, mesh8, jmesh8):
    """Three crops of one grid as one tile batch on the mesh: equal to the
    unmeshed multi-page call and to the JAX package's sharded one."""
    jm, tm = models
    crops = _multi_crops(jm)
    state = {k: v.clone() for k, v in tm.module.state_dict().items()}
    tm8 = runner.SegmentationModel(tm.spec, state, tm.runtime, device="cpu",
                                   dtype=torch.float32, mesh=mesh8)
    jm8 = jrunner.SegmentationModel(jm.spec, jm.variables, jm.runtime,
                                    mesh=jmesh8)
    got = tm8.predict_dual_tiled_multi(tm8, crops, **SHAPING)
    want = tm.predict_dual_tiled_multi(tm, crops, **SHAPING)
    jwant = jm8.predict_dual_tiled_multi(jm8, crops, **SHAPING)
    for g, w, j in zip(got, want, jwant):
        for a, b, c in zip(g, w, j):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)


def test_dualhead_fused_sharded_matches_unsharded(mesh8):
    """The dual-head stub pins the 2-channel input wiring under the mesh:
    head 0 reads raw01, head 1 the page-Otsu binarized channel."""
    spec = runner._as_spec(jreg.ModelSpec(
        "tiny_dual", "tpu_unet", 64, 64, 5, widths=(8, 16), heads=(3, 2),
        in_channels=2))
    rng = np.random.default_rng(21)
    pages = [np.where(rng.uniform(size=(120, 100, 3)) < 0.4, 30, 220
                      ).astype(np.uint8) for _ in range(2)]
    outs = []
    for mesh in (None, mesh8):
        m = _stub(_port_model(spec, mesh), _TorchDualStub())
        outs.append(m.predict_dual_tiled_multi(m, pages, mask_class=1))
    want, got = outs
    for i, page in enumerate(pages):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        np.testing.assert_array_equal(got[i][1], want[i][1])
        np.testing.assert_array_equal(
            want[i][0], (page[:, :, 0] > 127.5).astype(np.uint8))
        t = threshold.otsu_threshold_host(page[:, :, 0])
        np.testing.assert_array_equal(
            want[i][1], (page[:, :, 0].astype(np.int32) > int(t)
                         ).astype(np.uint8))


def _tiny_bundle(mesh):
    return runner.ModelBundle.random_init(
        RuntimeConfig(), device="cpu",
        specs={"page": TINY, "region": TINY, "textline": TINY}, mesh=mesh)


def test_mesh_auto_group_size(mesh8):
    """Group size = the data axis (8) under the mesh with mesh_auto_group,
    pages_per_dispatch (1) without a mesh or with the flag off, as in the
    JAX package."""
    cfg = _cfg()
    meshed = _tiny_bundle(mesh8)
    assert detector.TextlineDetector(meshed, cfg)._effective_group_size() == 8
    assert detector.TextlineDetector(
        _tiny_bundle(None), cfg)._effective_group_size() == 1
    off = _cfg(mesh_auto_group=False)
    assert detector.TextlineDetector(meshed, off)._effective_group_size() == 1
    many = _cfg(pages_per_dispatch=12)
    assert detector.TextlineDetector(
        meshed, many)._effective_group_size() == 12


def test_mesh_auto_group_batch_uses_grouped_path(mesh8):
    """Under the mesh, process_batch hands device_phase_group whole groups
    of data-axis size, not 1-page groups (the pages fail their device
    phase in the spy, so they come out degraded and fast)."""
    det = detector.TextlineDetector(_tiny_bundle(mesh8), _cfg())
    seen = []

    def spy(items):
        items = list(items)
        seen.append(len(items))
        return [None] * len(items)

    det.device_phase_group = spy
    rng = np.random.default_rng(3)
    pages = [(rng.integers(0, 255, (60, 50, 3)).astype(np.uint8), f"p{i}")
             for i in range(9)]
    results = list(det.process_batch(iter(pages)))
    assert len(results) == 9
    assert seen == [8, 1]


def test_meshed_batch_equals_unmeshed(bundles, mesh8):
    """process_batch end to end on an 8-member mesh (group size 8 by
    mesh_auto_group, the grouped path): page boxes, slopes, contours and
    PAGE-XML equal the unmeshed bundle's batch in groups of 8."""
    _, tb = bundles

    def state(m):
        return m.spec, {k: v.clone() for k, v in
                        m.module.state_dict().items()}

    meshed = runner.ModelBundle._from_state(
        state(tb.page), state(tb.region), None, tb.region.runtime, "cpu",
        torch.float32, mesh8)
    det = detector.TextlineDetector(meshed, _cfg())
    assert det._effective_group_size() == 8
    got = list(det.process_batch(iter(_pages())))
    plain = detector.TextlineDetector(tb, _cfg(pages_per_dispatch=8))
    want = list(plain.process_batch(iter(_pages())))
    assert all(len(w.contours) >= 3 for w in want)
    _assert_results_equal(got, want)
    assert det.degraded == 0 and not det.fallbacks
