"""The PyTorch TpuUnet against the Flax module: same weights (converted by
checkpoint.params_from_flax), same inputs, float32 on both sides; and in
bf16, block by block and end to end, against the JAX package's compiled
bf16 forward."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import unet as junet
from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from tests import torch_bf16_replay

DUAL_TINY = jreg.ModelSpec("tiny_dual", "tpu_unet", 64, 64, 5,
                           widths=(8, 16), heads=(3, 2), in_channels=2)
PAGE_TINY = jreg.ModelSpec("tiny_page", "tpu_unet", 64, 64, 2,
                           widths=(8, 16))
# three levels, and groups of one, two and four channels in GroupNorm
DUAL_3LEVEL = jreg.ModelSpec("dual_3level", "tpu_unet", 128, 128, 5,
                             widths=(32, 64, 128), heads=(3, 2),
                             in_channels=2)


def _torch_model(spec, variables, dtype=torch.float32):
    tspec = registry.ModelSpec.from_meta(spec.to_meta())
    m = registry.build_module(tspec, dtype)
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


# (spec, batch input) of the bf16 cases: uniform noise, and a binary
# page-like input (the dual-head model's thresholded channel)
BF16_CASES = {"dual_tiny": (DUAL_TINY, False), "page_tiny": (PAGE_TINY, False),
              "dual_3level_binary": (DUAL_3LEVEL, True)}


@functools.lru_cache(maxsize=None)
def _bf16_case(case):
    """(spec, input from default_rng(5), the JAX package's bf16 logits and
    ConvGN captures, the port's bf16 model), on the weights of
    checkpoint.random_init(seed 1) (Flax's initialisers, without the cost
    of a jitted Flax init)."""
    spec, binary = BF16_CASES[case]
    variables = checkpoint.flax_from_params(checkpoint.random_init(
        registry.ModelSpec.from_meta(spec.to_meta()),
        torch.Generator().manual_seed(1)))
    x = np.random.default_rng(5).uniform(size=(
        2, spec.input_height, spec.input_width, spec.in_channels))
    x = ((x > 0.5) if binary else x).astype(np.float32)
    logits, blocks = torch_bf16_replay.flax_blocks(spec, variables, x,
                                                   "bfloat16")
    return spec, x, logits, blocks, _torch_model(spec, variables,
                                                 torch.bfloat16)


# Each ConvGN fed the Flax block's own input: at most this share of its
# bf16 outputs may differ from Flax's, and its float32 GroupNorm output by
# at most this much. Measured on the three cases: shares <= 0.0011 and
# |gn| <= 1.8e-4; rounding the conv's sum to bf16 before GroupNorm (as
# the port once did) gives 0.41-0.48 at the stem and 1.6e-2..2.2e-2, and
# statistics from the unrounded sum 0.08-0.16 and 2.0e-3..5.5e-3.
BLOCK_DIFFER_SHARE = 0.005
BLOCK_GN_MAX_ABS = 5e-4


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_blocks_match_flax(case):
    """The bf16 ConvGN rounds where the JAX package's compiled forward
    rounds: operands to bf16, the conv's products summed in float32,
    GroupNorm statistics from that sum rounded to bf16 and the normalised
    values from the unrounded sum (XLA keeps the round trip only in the
    fusions that reduce), GELU in float32, the output in bf16."""
    spec, x, _, blocks, model = _bf16_case(case)
    rows = torch_bf16_replay.layer_rows(
        model, np.ascontiguousarray(x.transpose(0, 3, 1, 2)), blocks)
    assert [r["layer"] for r in rows][0] == "stem" and len(rows) == len(
        blocks)
    for r in rows:
        assert r["differ_share"] <= BLOCK_DIFFER_SHARE, r
        assert r["gn_max_abs"] <= BLOCK_GN_MAX_ABS, r


# End to end (bf16 rounding flips compound over the blocks): the mean
# |logit difference| and each head's argmax disagreement. Measured: mean
# 0.0049 / 0.0053 / 0.0089 and at most 0.51 / 0.29 / 0.62 % disagreement
# (dual_tiny, page_tiny, dual_3level_binary); rounding the conv's sum
# to bf16 before GroupNorm gave 0.0130 / 0.0146 / 0.0189 and 1.17 /
# 0.94 / 1.22 %.
BF16_LOGIT_MEAN = 0.0115
BF16_ARGMAX_DISAGREE = 0.009


@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_logits_match_flax(case):
    spec, x, want, _, model = _bf16_case(case)
    with torch.no_grad():
        got = model.forward_nchw(torch.from_numpy(x).permute(
            0, 3, 1, 2)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).mean() <= BF16_LOGIT_MEAN
    off = 0
    for width in spec.heads or (spec.n_classes,):
        disagree = (got[:, off:off + width].argmax(1)
                    != want[:, off:off + width].argmax(1)).mean()
        assert disagree <= BF16_ARGMAX_DISAGREE, (off, disagree)
        off += width


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
