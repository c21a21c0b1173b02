"""The port's training (loss, AdamW train step, checkpoint writer, Trainer
and training CLI) against the JAX package's, float32 on both sides: the
JAX side builds an f32 TpuUnet through the registry monkeypatch of
tests/test_torch_fused.py, and both sides start from one Flax init carried
across with params_from_flax. Inputs are uniform noise, which keeps
GroupNorm's fast variance E[x^2]-E[x]^2 well conditioned. One step is
also held in bf16, the Trainer's dtype: its loss and its gradients; and
40 bf16 steps against the JAX trainer's own rounding spread. The port's
registry.init_variables is held to the JAX package's initial draw."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from sbb_textline_detection_tpu.models import checkpoint as jckpt
from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.models import unet as junet
from sbb_textline_detection_tpu.training import train as jtrain
from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from sbb_textline_detection_tpu_torch.training import train

PAGE_TINY = jreg.ModelSpec("tiny_page", "tpu_unet", 32, 32, 2,
                           widths=(8, 16))
DUAL_TINY = jreg.ModelSpec("tiny_dual", "tpu_unet", 32, 32, 5,
                           widths=(8, 16), heads=(3, 2), in_channels=2)


def _f32_module(spec):
    return junet.TpuUnet(n_classes=spec.n_classes, widths=spec.widths,
                         dtype=jnp.float32)


@pytest.fixture
def f32_jax(monkeypatch):
    monkeypatch.setattr(jreg, "build_module", _f32_module)


def _port_spec(spec):
    return registry.ModelSpec.from_meta(spec.to_meta())


def _torch_model(spec, variables):
    m = registry.build_module(_port_spec(spec), torch.float32)
    m.load_state_dict(checkpoint.params_from_flax(variables))
    return m


def _noise_batch(rng, spec, n=2):
    """Uniform-noise images and uniform labels ((N,H,W) or, for a
    multi-head spec, (N,H,W,len(heads)) int32)."""
    h, w = spec.input_height, spec.input_width
    imgs = rng.uniform(size=(n, h, w, spec.in_channels)).astype(np.float32)
    if spec.heads:
        labels = np.stack([rng.integers(0, k, (n, h, w))
                           for k in spec.heads], -1)
    else:
        labels = rng.integers(0, spec.n_classes, (n, h, w))
    return imgs, labels.astype(np.int32)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_trees_close(got, want, atol):
    g, w = _flat(got), _flat(want)
    assert set(g) == set(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_allclose(g[k], w[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(weighted):
    """rtol 1e-6: one log-softmax and one reduction on each side."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 5, 6, 4)).astype(np.float32) * 3
    labels = rng.integers(0, 4, (2, 5, 6)).astype(np.int32)
    cw = (rng.uniform(0.1, 3.0, 4).astype(np.float32) if weighted
          else None)
    want = float(jtrain.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels),
        None if cw is None else jnp.asarray(cw)))
    got = float(train.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if cw is None else torch.from_numpy(cw)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cross_entropy_zero_weights_clamped():
    """All-zero weights: the denominator clamps at 1e-6, as in JAX."""
    logits = np.zeros((1, 2, 2, 3), np.float32)
    labels = np.zeros((1, 2, 2), np.int32)
    cw = np.zeros(3, np.float32)
    want = float(jtrain.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(cw)))
    got = float(train.cross_entropy_loss(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(cw)))
    assert got == want == 0.0


def _min_first_grad(opt_state):
    """Smallest |gradient| of the first step, read from optax's first
    moment (mu = 0.1 * g after one step)."""
    return 10.0 * min(float(np.abs(np.asarray(m)).min())
                      for m in jax.tree_util.tree_leaves(opt_state[0].mu))


# Adam's first update is lr * g / (|g| + 1e-8): for |g| near 1e-8 it is
# as sensitive to the ~1e-9 gradient noise between XLA's and PyTorch's f32
# sums as a sign flip (up to 2 * lr apart). The init seeds are chosen so
# that no element's first gradient lies under 3e-8; each test asserts it.
GRAD_FLOOR = 3e-8


@pytest.mark.parametrize("spec,seed", [(PAGE_TINY, 4), (DUAL_TINY, 6)],
                         ids=["single_head", "dual_head"])
def test_train_step_matches_jax(f32_jax, spec, seed):
    """Three AdamW steps (lr 3e-4, wd 1e-4) from one Flax init: the losses
    agree to rtol 1e-5 at every step, and every param after the first and
    the third step to atol 1e-5."""
    variables = jreg.init_variables(spec, seed=seed)
    tx = jtrain.make_optimizer()
    opt_state = tx.init(variables)
    jstep = jax.jit(jtrain.make_train_step(spec, tx))

    model = _torch_model(spec, variables)
    opt = train.make_optimizer(model.parameters())
    step = train.make_train_step(_port_spec(spec), model, opt)

    rng = np.random.default_rng(9)
    for k in range(3):
        imgs, labels = _noise_batch(rng, spec)
        variables, opt_state, jloss = jstep(
            variables, opt_state, jnp.asarray(imgs), jnp.asarray(labels))
        loss = step(torch.from_numpy(imgs), torch.from_numpy(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        if k == 0:
            assert _min_first_grad(opt_state) > GRAD_FLOOR
        if k in (0, 2):
            _assert_trees_close(checkpoint.flax_from_params(
                model.state_dict()), variables, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _bf16_step():
    """One step of the JAX trainer with its bf16 TpuUnet (the registry's
    default dtype) and one of the port's with a bf16 TpuUnet, the
    Trainer's model, from one init on the dual-head spec: (port loss, JAX
    loss, {leaf: |port gradient - JAX gradient|_2 / |JAX gradient|_2}).
    The gradients are read from each optimizer's first moment (0.1 x the
    gradient after one step on both sides)."""
    spec = DUAL_TINY
    variables = checkpoint.flax_from_params(checkpoint.random_init(
        _port_spec(spec), torch.Generator().manual_seed(6)))
    tx = jtrain.make_optimizer()
    jstep = jax.jit(jtrain.make_train_step(spec, tx))
    model = registry.build_module(_port_spec(spec), torch.bfloat16)
    model.load_state_dict(checkpoint.params_from_flax(variables))
    opt = train.make_optimizer(model.parameters())
    step = train.make_train_step(_port_spec(spec), model, opt)
    imgs, labels = _noise_batch(np.random.default_rng(9), spec)
    _, opt_state, jloss = jstep(variables, tx.init(variables),
                                jnp.asarray(imgs), jnp.asarray(labels))
    loss = step(torch.from_numpy(imgs), torch.from_numpy(labels))
    want = _flat(opt_state[0].mu)
    got = _flat(checkpoint.flax_from_params(
        {n: opt.state[p]["exp_avg"] for n, p in model.named_parameters()}))
    assert set(got) == set(want)
    rel = {k: float(np.linalg.norm(got[k] - want[k])
                    / np.linalg.norm(want[k])) for k in want}
    return float(loss), float(jloss), rel


def test_bf16_train_step_loss_matches_jax():
    """The losses of one bf16 step agree to rtol 2e-4 (measured 3.6e-5; a
    loss averages every pixel's bf16 rounding flips)."""
    loss, jloss, _ = _bf16_step()
    np.testing.assert_allclose(loss, jloss, rtol=2e-4)


# The worst parameter's gradient of one bf16 step, port against JAX:
# measured 0.024 here (and 0.023-0.049 on other seeds and on the
# single-head and 3-level specs); rounding the conv's sum to bf16 before
# GroupNorm, as the port once did, gives 0.123 here (0.10-0.21 there).
BF16_GRAD_REL = 0.06


def test_bf16_train_step_grads_match_jax():
    """Every parameter's gradient of one bf16 step within BF16_GRAD_REL
    (relative L2) of the JAX trainer's: the backward of the repaired
    forward, which the loss alone does not discriminate."""
    _, _, rel = _bf16_step()
    worst = max(rel, key=rel.get)
    assert rel[worst] <= BF16_GRAD_REL, (worst, rel[worst])


@functools.lru_cache(maxsize=None)
def _jax_init(spec):
    """jreg.init_variables(spec, seed) as a function of the seed: the same
    jitted `module.init` on the same dummy input, its key an argument as
    there, compiled once for every seed (a compile takes ~5 s on a CPU)."""
    module = jreg.build_module(spec)
    dummy = jnp.zeros((1, spec.input_height, spec.input_width,
                       spec.in_channels), jnp.float32)
    init = jax.jit(module.init)
    return lambda seed: init(jax.random.PRNGKey(seed), dummy)


@functools.lru_cache(maxsize=None)
def _port_init(spec, seed):
    """registry.init_variables(spec, seed), drawn once per test file."""
    return registry.init_variables(spec, seed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("spec", [PAGE_TINY, DUAL_TINY, jreg.DUALHEAD_SPEC],
                         ids=["page_tiny", "dual_tiny", "dualhead"])
def test_init_variables_matches_jax(spec, seed):
    """The port's registry.init_variables draws the JAX package's initial
    weights: every key and shape of params_from_flax(JAX init), at least
    99.9 % of the elements bit-equal and none more than 4 float32 ulps
    apart (measured: all bit-equal)."""
    want = checkpoint.params_from_flax(jax.device_get(_jax_init(spec)(seed)))
    got = _port_init(_port_spec(spec), seed)
    assert list(got) == list(registry.state_shapes(_port_spec(spec)))
    assert set(got) == set(want)
    equal, total = 0, 0
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].shape == w.shape, k
        g, w = got[k].numpy().view(np.int32), w.numpy().view(np.int32)
        ulps = np.abs(g.astype(np.int64) - w)
        assert ulps.max(initial=0) <= 4, k
        equal += int((ulps == 0).sum())
        total += g.size
    assert equal >= 0.999 * total, equal / total


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), os.pardir,
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_init_variables_sha256_pinned():
    """Seed 0's initial states of the bench's two roles hash to the
    constants that chip_smoke.py's bench_phase holds the card's host to:
    the draw is numpy integer and IEEE float arithmetic, the same bits on
    every host."""
    pinned = _chip_smoke().INIT_SHA256
    for spec in (registry.DEFAULT_SPECS["page"], registry.DUALHEAD_SPEC):
        got = checkpoint.state_sha256(_port_init(spec, 0))
        assert got == pinned[spec.name], spec.name


def _bump_bf16(imgs, rng, share=1e-3):
    """`imgs` with a seeded `share` of its values moved one bf16 ulp up
    from their bf16 rounding (the model's first cast)."""
    v = imgs.astype(jnp.bfloat16).astype(np.float32)
    up = (v.view(np.uint32) + np.uint32(0x10000)).view(np.float32)
    return np.where(rng.uniform(size=imgs.shape) < share, up, imgs)


TRAJ_STEPS = 40
TRAJ_MASKS = (1, 2, 3)
# 40 bf16 steps on DUAL_TINY: the port's distance from the JAX trainer
# over the JAX trainer's own spread under 0.1 % of its inputs moved one
# bf16 ulp (a mask each), at steps 5..40. Measured on init seeds 0-2 with
# masks 1-5 (`JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_training.py` prints them): the port 0.43-0.89; with
# the conv's sum rounded to bf16 before GroupNorm (the arithmetic before
# the bf16 repair) 1.42-2.44; with the port's learning rate 10 % too
# high 1.03-1.78 at step 5 and 1.38-2.85 from step 10 on.
TRAJ_RATIO = 1.2


def _trajectory_ratios(init_seed=0, mask_seeds=TRAJ_MASKS, lr=3e-4):
    """40 bf16 AdamW steps on DUAL_TINY from the Flax init of `init_seed`,
    fed seeded _noise_batch batches: (a) the JAX trainer (lr 3e-4), (b)
    the JAX trainer with 0.1 % of each batch's input values moved one bf16
    ulp (a seeded mask each), (c) the port's make_train_step at `lr`.
    {step: (|theta_c - theta_a|, [|theta_b - theta_a| a mask])}, each over
    |theta_a - theta_0| (all parameters), at steps 5, 10, ..., 40."""
    spec = DUAL_TINY
    v0 = checkpoint.flax_from_params(
        registry.init_variables(_port_spec(spec), init_seed))
    rng = np.random.default_rng(9)
    batches = [_noise_batch(rng, spec) for _ in range(TRAJ_STEPS)]
    marks = range(5, TRAJ_STEPS + 1, 5)

    def flat(params):
        return np.concatenate([np.asarray(p, np.float32).ravel()
                               for p in jax.tree_util.tree_leaves(params)])

    tx = jtrain.make_optimizer()
    jstep = jax.jit(jtrain.make_train_step(spec, tx))

    def jax_run(mask_seed=None):
        mask_rng = None if mask_seed is None else np.random.default_rng(
            mask_seed)
        v, opt_state, out = v0, tx.init(v0), {}
        for k, (imgs, labels) in enumerate(batches, 1):
            if mask_rng is not None:
                imgs = _bump_bf16(imgs, mask_rng)
            v, opt_state, _ = jstep(v, opt_state, jnp.asarray(imgs),
                                    jnp.asarray(labels))
            if k in marks:
                out[k] = flat(v["params"])
        return out

    model = registry.build_module(_port_spec(spec), torch.bfloat16)
    model.load_state_dict(checkpoint.params_from_flax(v0))
    opt = train.make_optimizer(model.parameters(), lr)
    step = train.make_train_step(_port_spec(spec), model, opt)
    port = {}
    for k, (imgs, labels) in enumerate(batches, 1):
        step(torch.from_numpy(imgs), torch.from_numpy(labels))
        if k in marks:
            port[k] = flat(checkpoint.flax_from_params(
                model.state_dict())["params"])

    ref = jax_run()
    spread = [jax_run(m) for m in mask_seeds]
    theta0 = flat(v0["params"])
    out = {}
    for k in marks:
        moved = np.linalg.norm(ref[k] - theta0)
        out[k] = (float(np.linalg.norm(port[k] - ref[k]) / moved),
                  [float(np.linalg.norm(b[k] - ref[k]) / moved)
                   for b in spread])
    return out


def test_bf16_training_trajectory_within_jax_spread():
    """40 bf16 steps from one Flax init (_trajectory_ratios): at every
    step 5..40 the port's distance from the JAX trainer is at most
    TRAJ_RATIO times the median over TRAJ_MASKS of the JAX trainer's own
    spread: the port parts from the reference no faster than the
    reference's rounding does."""
    for k, (ours, spread) in _trajectory_ratios().items():
        noise = float(np.median(spread))
        assert ours <= TRAJ_RATIO * noise, (k, ours, noise)


def _calibrate_trajectory():
    """Print the port's ratio over each mask's (TRAJ_RATIO's evidence) on
    init seeds 0-2 and masks 1-5, for the port, for the port with the
    conv's sum rounded to bf16 before GroupNorm, and for the port at a
    learning rate 10 % too high."""
    from sbb_textline_detection_tpu_torch.models import unet
    from sbb_textline_detection_tpu_torch.ops import groupnorm

    def forward_rounded(self, x):
        x = self.conv_sum(self.pad(x)).to(self.dtype).to(torch.float32)
        return torch.nn.functional.gelu(groupnorm.group_norm(x, x, self.norm),
                                        approximate="tanh").to(self.dtype)

    repaired = unet.ConvGN.forward
    for name, lr, forward in (("port", 3e-4, repaired),
                              ("sum rounded to bf16", 3e-4, forward_rounded),
                              ("lr +10 %", 3.3e-4, repaired)):
        unet.ConvGN.forward = forward
        try:
            for seed in (0, 1, 2):
                ratios = _trajectory_ratios(seed, (1, 2, 3, 4, 5), lr)
                for k, (ours, spread) in ratios.items():
                    print(f"{name}, init seed {seed}, step {k}: "
                          + " ".join(f"{ours / b:.2f}" for b in spread))
        finally:
            unet.ConvGN.forward = repaired


def test_optimizer_matches_optax_adamw():
    """The AdamW update itself on fixed gradients over 5 steps: torch's
    AdamW equals optax.adamw (decay on every parameter) to rtol 2e-6, a
    few float32 ulps (torch decays p before the Adam step, optax sums the
    two updates)."""
    rng = np.random.default_rng(1)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(5)]
    tx = optax.adamw(3e-4, weight_decay=1e-4)
    jp = jnp.asarray(p0)
    st = tx.init(jp)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = train.make_optimizer([tp])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp),
                               rtol=2e-6, atol=0)


def test_class_weights_with_heads_raise():
    spec = _port_spec(DUAL_TINY)
    model = registry.build_module(spec, torch.float32)
    opt = train.make_optimizer(model.parameters())
    with pytest.raises(ValueError, match="multi-head"):
        train.make_train_step(spec, model, opt,
                              class_weights=np.ones(5, np.float32))
    with pytest.raises(ValueError, match="multi-head"):
        jtrain.make_train_step(DUAL_TINY, optax.adamw(1e-3),
                               class_weights=np.ones(5, np.float32))


def test_class_weighted_step_matches_jax(f32_jax):
    """One single-head step with class weights: loss to rtol 1e-5, params
    to atol 1e-5."""
    variables = jreg.init_variables(PAGE_TINY, seed=5)
    cw = np.asarray([0.3, 2.5], np.float32)
    tx = jtrain.make_optimizer()
    jstep = jax.jit(jtrain.make_train_step(PAGE_TINY, tx, cw))
    model = _torch_model(PAGE_TINY, variables)
    step = train.make_train_step(_port_spec(PAGE_TINY), model,
                                 train.make_optimizer(model.parameters()), cw)
    imgs, labels = _noise_batch(np.random.default_rng(2), PAGE_TINY)
    variables, opt_state, jloss = jstep(variables, tx.init(variables),
                                        jnp.asarray(imgs),
                                        jnp.asarray(labels))
    loss = step(torch.from_numpy(imgs), torch.from_numpy(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert _min_first_grad(opt_state) > GRAD_FLOOR
    _assert_trees_close(checkpoint.flax_from_params(model.state_dict()),
                        variables, atol=1e-5)


def test_synthetic_batch_equals_jax():
    for seed in (0, 1, 2):
        got = train.synthetic_batch(np.random.default_rng(seed), 2, 32, 40,
                                    3)
        want = jtrain.synthetic_batch(np.random.default_rng(seed), 2, 32,
                                      40, 3)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


# -- checkpoints --------------------------------------------------------------

def test_flax_from_params_inverts_params_from_flax():
    variables = jax.tree_util.tree_map(
        np.asarray, jreg.init_variables(DUAL_TINY, seed=3))
    back = checkpoint.flax_from_params(
        checkpoint.params_from_flax(variables))
    g, w = _flat(back), _flat(variables)
    assert set(g) == set(w)
    for k in w:
        assert g[k].dtype == w[k].dtype == np.float32, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_jax_saved_checkpoint_loads_in_port(tmp_path):
    """JAX-saved -> port load -> params_from_flax -> flax_from_params gives
    the saved tree exactly."""
    variables = jreg.init_variables(DUAL_TINY, seed=5)
    path = str(tmp_path / "dual.npz")
    jckpt.save(path, DUAL_TINY, variables)
    spec, tree = checkpoint.load(path)
    assert spec == _port_spec(DUAL_TINY)
    back = checkpoint.flax_from_params(checkpoint.params_from_flax(tree))
    g, w = _flat(back), _flat(variables)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("spec", [PAGE_TINY, DUAL_TINY],
                         ids=["single_head", "dual_head"])
def test_port_saved_checkpoint_loads_in_jax(tmp_path, spec):
    """Port-saved -> JAX checkpoint.load -> Flax apply: the file has the
    keys, shapes, dtypes and metadata of a JAX-saved one of the same spec,
    and the Flax logits equal the port's within rtol/atol 1e-4 (the f32
    forward tolerance of tests/test_torch_unet.py)."""
    pspec = _port_spec(spec)
    sd = checkpoint.random_init(pspec, torch.Generator().manual_seed(7))
    sd["head.bias"] += torch.linspace(-0.2, 0.3, spec.n_classes)
    port_path = str(tmp_path / "port.npz")
    checkpoint.save(port_path, pspec, sd)
    jax_path = str(tmp_path / "jax.npz")
    jckpt.save(jax_path, spec, jreg.init_variables(spec, seed=0))
    with np.load(port_path) as a, np.load(jax_path) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert bytes(a["__meta__"]) == bytes(b["__meta__"])

    jspec, jvars = jckpt.load(port_path)
    assert jspec == spec
    x = np.random.default_rng(3).uniform(
        size=(2, 32, 32, spec.in_channels)).astype(np.float32)
    want = np.asarray(jax.jit(_f32_module(spec).apply)(jvars,
                                                       jnp.asarray(x)))
    m = registry.build_module(pspec, torch.float32)
    m.load_state_dict(sd)
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# -- Trainer and CLI ----------------------------------------------------------

def test_trainer_reduces_loss_and_saves(tmp_path):
    """bf16 convs on the CPU, 12 steps of the dual-head synthetic task at
    32x32 (under 224 px: no page pool); the checkpoint reloads."""
    from sbb_textline_detection_tpu_torch.training import data as data_mod

    spec = _port_spec(DUAL_TINY)
    tr = train.Trainer(spec, learning_rate=1e-3, seed=0,
                       device=torch.device("cpu"))
    assert tr.model.stem.conv.weight.dtype == torch.float32
    assert tr.model.dtype == torch.bfloat16
    losses = tr.train(data_mod.synthetic_batches("dualhead", 2, 32, 32, 0),
                      12)
    assert len(losses) == 12 and all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    path = str(tmp_path / "d.npz")
    tr.save(path)
    spec2, tree = checkpoint.load(path)
    assert spec2 == spec
    sd = checkpoint.params_from_flax(tree)
    for k, v in tr.model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_trainer_requires_device():
    with pytest.raises(TypeError):
        train.Trainer(_port_spec(PAGE_TINY))


@pytest.fixture
def tiny_roles(monkeypatch):
    """The page and dual-head roles at 32x32, widths (8, 16)."""
    monkeypatch.setitem(registry.DEFAULT_SPECS, "page", registry.ModelSpec(
        "model_page_mixed_best", "tpu_unet", 32, 32, 2, widths=(8, 16)))
    monkeypatch.setattr(registry, "DUALHEAD_SPEC", registry.ModelSpec(
        "model_dualhead", "tpu_unet", 32, 32, 5, widths=(8, 16),
        heads=(3, 2), in_channels=2))


def _train_cli(*args):
    from sbb_textline_detection_tpu_torch.training import cli as tcli

    return CliRunner().invoke(tcli.main, list(args))


def test_training_cli_resume_and_serve(tmp_path, tiny_roles):
    """2 steps, then --resume for 1 more: the sidecar carries the step
    count and the AdamW moments, and ModelBundle.from_dir serves both
    checkpoints."""
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.training import cli as tcli

    out = str(tmp_path)
    for role in ("page", "dualhead"):
        res = _train_cli("--role", role, "--out", out, "--steps", "2",
                         "--batch", "2", "--log-every", "1",
                         "--device", "cpu")
        assert res.exit_code == 0, res.output
        assert "step 1: loss" in res.output
    ckpt = str(tmp_path / "model_dualhead.npz")
    with np.load(ckpt + ".trainstate.npz") as blob:
        assert int(blob["step"]) == 2
        assert float(blob["step::stem.conv.weight"]) == 2.0
        m2 = blob["exp_avg::stem.conv.weight"].copy()
    assert np.abs(m2).max() > 0

    # the sidecar restores the moments into a fresh optimizer
    tr = train.Trainer(registry.DUALHEAD_SPEC, device=torch.device("cpu"))
    assert tcli._load_train_state(ckpt + ".trainstate.npz", tr.model,
                                  tr.optimizer) == 2
    st = tr.optimizer.state[tr.model.stem.conv.weight]
    np.testing.assert_array_equal(st["exp_avg"].numpy(), m2)
    assert float(st["step"]) == 2.0

    res = _train_cli("--role", "dualhead", "--out", out, "--steps", "1",
                     "--batch", "2", "--resume", "--device", "cpu")
    assert res.exit_code == 0, res.output
    assert "resumed from" in res.output and "at step 2" in res.output
    assert "step 2: loss" in res.output
    with np.load(ckpt + ".trainstate.npz") as blob:
        assert int(blob["step"]) == 3
        assert float(blob["step::stem.conv.weight"]) == 3.0

    bundle = ModelBundle.from_dir(out, device="cpu", dtype=torch.float32)
    assert bundle.is_dual_head
    labels = bundle.page.predict_small_prescaled(
        np.zeros((32, 32, 3), np.uint8))
    assert labels.shape == (32, 32)


def test_training_cli_refuses_jax_sidecar(tmp_path, tiny_roles):
    out = str(tmp_path)
    res = _train_cli("--role", "page", "--out", out, "--steps", "1",
                     "--batch", "2", "--device", "cpu")
    assert res.exit_code == 0, res.output
    np.savez(str(tmp_path / "model_page_mixed_best.npz.trainstate.npz"),
             step=np.int64(1), leaf_0=np.zeros(3, np.float32))
    res = _train_cli("--role", "page", "--out", out, "--steps", "1",
                     "--batch", "2", "--resume", "--device", "cpu")
    assert res.exit_code != 0
    assert "optax leaves" in res.output


@pytest.mark.parametrize("role,with_labels", [("page", False),
                                              ("dualhead", True)],
                         ids=["images_without_labels", "dualhead_labeled"])
def test_training_cli_refusals(tmp_path, tiny_roles, role, with_labels):
    """Images without labels, and labeled data with the dual-head role,
    exit 2 as in the JAX CLI."""
    (tmp_path / "img").mkdir()
    (tmp_path / "lab").mkdir()
    args = ["--role", role, "--images", str(tmp_path / "img")]
    if with_labels:
        args += ["--labels", str(tmp_path / "lab")]
    res = _train_cli(*args, "--out", str(tmp_path / "o"), "--steps", "1",
                     "--device", "cpu")
    assert res.exit_code == 2, res.output
    assert not (tmp_path / "o").exists()


def test_training_cli_needs_cuda_unless_told_cpu(tmp_path, monkeypatch,
                                                 tiny_roles):
    """With CUDA hidden and no --device the command stops before training;
    it never moves the work to the CPU on its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    res = _train_cli("--role", "page", "--out", str(tmp_path / "o"),
                     "--steps", "1", "--batch", "2")
    assert res.exit_code != 0
    assert "--device cpu" in res.output
    assert not (tmp_path / "o").exists()


if __name__ == "__main__":
    _calibrate_trajectory()
