"""The PyTorch TpuUnet against the Flax module: same weights (converted by
checkpoint.params_from_flax), same inputs, float32 on both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import unet as junet
from sbb_textline_detection_tpu_torch.models import checkpoint, registry

DUAL_TINY = jreg.ModelSpec("tiny_dual", "tpu_unet", 64, 64, 5,
                           widths=(8, 16), heads=(3, 2), in_channels=2)
PAGE_TINY = jreg.ModelSpec("tiny_page", "tpu_unet", 64, 64, 2,
                           widths=(8, 16))


def _torch_model(spec, variables):
    tspec = registry.ModelSpec.from_meta(spec.to_meta())
    m = registry.build_module(tspec, torch.float32)
    m.load_state_dict(checkpoint.params_from_flax(variables))
    return m.eval()


@pytest.mark.parametrize("spec,hw", [(DUAL_TINY, (64, 64)),
                                     (PAGE_TINY, (64, 64)),
                                     (DUAL_TINY, (48, 80))])
def test_forward_matches_flax(spec, hw):
    """Logits agree at rtol 1e-4 / atol 1e-4 (f32 conv and GroupNorm sums
    are ordered differently by XLA and PyTorch)."""
    variables = jreg.init_variables(spec, seed=1)
    module = junet.TpuUnet(n_classes=spec.n_classes, widths=spec.widths,
                           dtype=jnp.float32)
    x = np.random.default_rng(5).uniform(
        size=(2,) + hw + (spec.in_channels,)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = _torch_model(spec, variables)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_params_from_flax_covers_state_dict():
    variables = jreg.init_variables(DUAL_TINY, seed=0)
    sd = checkpoint.params_from_flax(variables)
    tspec = registry.ModelSpec.from_meta(DUAL_TINY.to_meta())
    ref = registry.build_module(tspec, torch.float32).state_dict()
    assert set(sd) == set(ref)
    for k in ref:
        assert tuple(sd[k].shape) == tuple(ref[k].shape), k


def test_random_init_matches_flax_statistics():
    """Flax's initialisers: truncated lecun-normal kernels (|w| <= 2 std),
    zero biases, unit GroupNorm scales; same std as the Flax init."""
    tspec = registry.ModelSpec.from_meta(DUAL_TINY.to_meta())
    sd = checkpoint.random_init(tspec, torch.Generator().manual_seed(0))
    flax_sd = checkpoint.params_from_flax(jreg.init_variables(DUAL_TINY, 0))
    w = sd["ConvGN_7.conv.weight"]
    std = np.sqrt(1.0 / (w.shape[1] * 9)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std + 1e-6
    np.testing.assert_allclose(float(w.std()),
                               float(flax_sd["ConvGN_7.conv.weight"].std()),
                               rtol=0.15)
    assert float(sd["head.bias"].abs().max()) == 0.0
    assert float((sd["stem.norm.weight"] - 1).abs().max()) == 0.0


def test_checkpoint_npz_roundtrip(tmp_path):
    """The JAX package's .npz writer -> the port's numpy-only reader."""
    from sbb_textline_detection_tpu.models import checkpoint as jckpt

    variables = jreg.init_variables(PAGE_TINY, seed=2)
    path = str(tmp_path / "page.npz")
    jckpt.save(path, PAGE_TINY, variables)
    spec, tree = checkpoint.load(path)
    assert spec.to_meta() == PAGE_TINY.to_meta()
    a = checkpoint.params_from_flax(tree)
    b = checkpoint.params_from_flax(variables)
    for k in b:
        assert torch.equal(a[k], b[k]), k
