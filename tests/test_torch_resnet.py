"""The port's ResNet50Unet, its weight maps, the Keras `.h5` import, the
converter and `checkpoint_path` against the JAX package, on the same
seeded inputs, float32 on both sides."""

import os
import shutil

import jax
import numpy as np
import pytest
import torch
from click.testing import CliRunner

from sbb_textline_detection_tpu.models import checkpoint as jckpt
from sbb_textline_detection_tpu.models import convert as jconvert
from sbb_textline_detection_tpu.models import h5_import as jh5
from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import unet as junet
from sbb_textline_detection_tpu_torch.models import (checkpoint, convert,
                                                     h5_import, registry)

from tests.h5_fixture import build_fake_keras_h5

SPEC = jreg.ModelSpec("model_fake_best", "resnet50_unet", 64, 64, 3)


def _tspec(spec):
    return registry.ModelSpec.from_meta(spec.to_meta())


def _busy_stats(variables, rng):
    """BatchNorm statistics and scales away from the identity, so the
    forward exercises every BN term."""
    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("mean", "bias"):
                node[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k in ("var", "scale"):
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)

    walk(variables["params"])
    walk(variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def flax_vars():
    """One Flax ResNet50Unet init (the slowest step of this file)."""
    return jax.tree_util.tree_map(np.array, jreg.init_variables(SPEC, 0))


@pytest.fixture(scope="module")
def fake_h5(tmp_path_factory, flax_vars):
    path = str(tmp_path_factory.mktemp("h5") / "model_fake_best.h5")
    build_fake_keras_h5(path, flax_vars, np.random.default_rng(0),
                        with_model_config=(64, 64))
    return path


def _module(spec, sd):
    m = registry.build_module(_tspec(spec), torch.bfloat16)
    m.load_state_dict(sd)
    return m.eval()


def test_forward_matches_flax(flax_vars):
    """f32 logits of a batch of 4 64x64 tiles agree to 1e-4 of the largest
    logit; bf16 asked of build_module still computes in float32."""
    variables = _busy_stats(jax.tree_util.tree_map(np.array, flax_vars),
                            np.random.default_rng(1))
    x = np.random.default_rng(2).uniform(size=(4, 64, 64, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(junet.ResNet50Unet(3).apply)(variables, x))
    m = _module(SPEC, checkpoint.params_from_flax(variables))
    assert all(p.dtype == torch.float32 for p in m.parameters())
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (4, 64, 64, 3)
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)])
def test_same_max_pool_pads_like_flax(hw):
    """Flax's SAME max-pool pads (0, 1) with -inf on an even size, not
    (1, 1): the stem's pooled map matches `nn.max_pool` exactly."""
    import flax.linen as nn

    x = np.random.default_rng(3).normal(size=(1,) + hw + (4,)).astype(
        np.float32)
    want = np.asarray(nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME"))
    from sbb_textline_detection_tpu_torch.models import unet

    t = torch.from_numpy(x).permute(0, 3, 1, 2)
    ph, pw = unet._same_pad(hw[0], 3, 2), unet._same_pad(hw[1], 3, 2)
    got = torch.nn.functional.max_pool2d(torch.nn.functional.pad(
        t, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf")), 3, 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
    wrong = torch.nn.functional.max_pool2d(t, 3, 2, padding=1)
    assert not np.array_equal(wrong.permute(0, 2, 3, 1).numpy(), want)


def test_weight_maps_roundtrip(flax_vars):
    """params_from_flax covers every state_dict key with its shape, and
    flax_from_params is its exact inverse (params and batch_stats)."""
    sd = checkpoint.params_from_flax(flax_vars)
    shapes = registry.state_shapes(_tspec(SPEC))
    assert {k: tuple(v.shape) for k, v in sd.items()} == shapes
    assert any(k.endswith("running_var") for k in sd)
    back = checkpoint.flax_from_params(sd)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(flax_vars)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(flax_vars)):
        np.testing.assert_array_equal(a, b)
    sd2 = checkpoint.params_from_flax(back)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_random_init_resnet_follows_flax_initialisers(flax_vars):
    sd = checkpoint.random_init(_tspec(SPEC), torch.Generator().manual_seed(0))
    ref = checkpoint.params_from_flax(flax_vars)
    assert set(sd) == set(ref)
    w = sd["res3b.conv_b.weight"]
    std = np.sqrt(1.0 / (w.shape[1] * 9)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    np.testing.assert_allclose(float(w.std()),
                               float(ref["res3b.conv_b.weight"].std()),
                               rtol=0.15)
    for k in sd:
        if sd[k].ndim == 1:
            assert torch.equal(sd[k], ref[k]), k   # ones and zeros


def test_h5_import_matches_jax(fake_h5, flax_vars):
    """Every tensor equals the JAX import's bit for bit after the layout
    transpose; both reports agree and are complete."""
    want, jrep = jh5.import_h5(fake_h5, flax_vars)
    got, rep = h5_import.import_h5(fake_h5, registry.state_shapes(
        _tspec(SPEC)))
    assert rep.complete and jrep.complete
    assert rep.mapped == jrep.mapped and len(rep.mapped) == 117
    ref = checkpoint.params_from_flax(want)
    assert set(got) == set(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def _incomplete_h5(path):
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("model_weights")
        lg = g.create_group("conv1")
        lg.create_dataset("conv1/kernel:0",
                          data=np.zeros((7, 7, 3, 64), np.float32))
        lg.create_dataset("conv1/bias:0", data=np.zeros(64, np.float32))
        lg.attrs["weight_names"] = [b"conv1/kernel:0", b"conv1/bias:0"]
        g.attrs["layer_names"] = [b"conv1"]


def test_incomplete_h5_raises(tmp_path):
    bad = str(tmp_path / "bad.h5")
    _incomplete_h5(bad)
    reports = []
    with pytest.raises(ValueError, match="incomplete import"):
        convert.convert_h5(bad, str(tmp_path / "out"), report_out=reports)
    _, rep = reports[0]
    assert rep.mapped == ["conv1"] and "head.weight" in rep.unfilled_target
    assert not os.path.exists(tmp_path / "out" / "bad.npz")
    res = CliRunner().invoke(convert.main, ["-i", bad, "-o",
                                            str(tmp_path / "cli")])
    assert res.exit_code == 1
    assert "FAILED" in res.output and "unfilled target" in res.output


def test_convert_h5_matches_jax_converter(fake_h5, tmp_path):
    """The port's .npz has the JAX converter's keys, shapes and values, and
    each package loads the other's."""
    assert convert.infer_geometry(fake_h5) == jconvert.infer_geometry(
        fake_h5) == (64, 64, 3)
    got = convert.convert_h5(fake_h5, str(tmp_path / "torch"))
    want = jconvert.convert_h5(fake_h5, str(tmp_path / "jax"))
    assert os.path.basename(got) == os.path.basename(want)
    with np.load(got) as a, np.load(want) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k])
    # the JAX package loads the port's file; the port loads the JAX one
    jspec, jtree = jckpt.load(got)
    assert jspec.to_meta() == SPEC.to_meta()
    jax.tree_util.tree_map(np.testing.assert_array_equal, jtree,
                           jckpt.load(want)[1])
    tspec, tree = checkpoint.load(want)
    _module(tspec, checkpoint.params_from_flax(tree))


def test_convert_cli(fake_h5, tmp_path):
    res = CliRunner().invoke(convert.main,
                             ["-i", os.path.dirname(fake_h5), "-o",
                              str(tmp_path / "out")])
    assert res.exit_code == 0, res.output
    assert "model_fake_best.npz" in res.output
    assert "117 layers mapped, import complete" in res.output
    assert "resnet50_unet 64x64 n_classes=3" in res.output


def test_checkpoint_path_converts_once_and_caches(fake_h5, tmp_path,
                                                  monkeypatch):
    model_dir = tmp_path / "models"
    model_dir.mkdir()
    shutil.copy(fake_h5, model_dir / "model_fake_best.h5")
    path = checkpoint.checkpoint_path(str(model_dir), "model_fake_best.h5")
    assert path == str(model_dir / "model_fake_best.npz")
    assert checkpoint.load(path)[0].arch == "resnet50_unet"

    def boom(*a, **k):
        raise AssertionError("reconverted despite a fresh .npz")

    monkeypatch.setattr(convert, "convert_h5", boom)
    assert checkpoint.checkpoint_path(str(model_dir),
                                      "model_fake_best") == path


def test_checkpoint_path_falls_back_to_user_cache(fake_h5, tmp_path,
                                                  monkeypatch):
    model_dir = tmp_path / "ro_models"
    model_dir.mkdir()
    shutil.copy(fake_h5, model_dir / "model_fake_best.h5")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    real = convert.convert_h5

    def deny_model_dir(h5, out_dir, **kw):
        if os.path.abspath(out_dir) == os.path.abspath(str(model_dir)):
            raise PermissionError(f"read-only: {out_dir}")
        return real(h5, out_dir, **kw)

    monkeypatch.setattr(convert, "convert_h5", deny_model_dir)
    path = checkpoint.checkpoint_path(str(model_dir), "model_fake_best")
    assert path.startswith(str(tmp_path / "home" / ".cache"
                               / "sbb_textline_detection_tpu_torch"))
    assert checkpoint.load(path)[0].n_classes == 3
    assert checkpoint.checkpoint_path(str(model_dir),
                                      "model_fake_best") == path
