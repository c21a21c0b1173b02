"""The port's training mesh (parallel/mesh.py's column-parallel convs and
data-axis gradient average, parallel/dryrun's spawner, the training CLI's
--model-parallel) against the single-process port step and the JAX
package's mesh step, with gloo process groups on the CPU.

One step of a tiny TpuUnet and of a tiny dual-head TpuUnet, float32,
from one Flax init carried across, on a global batch of 4 noise images:
on the meshes (data, model) = (2, 1) and (1, 2) in a group of 2 processes
and (2, 2) in a group of 4 (each group spawned once for the module, both
at once).

  * SGD (lr 1e-2), the step of the JAX package's mesh tests
    (test_mesh_train_step_matches_single_device and its dual-head twin in
    tests/test_training.py): the loss must agree to rtol 1e-5 and every
    parameter to rtol 1e-5, atol 1e-6 with the single-process port step
    and with the JAX step (the JAX package's own mesh step on the (2, 2)
    mesh of its 8 CPU devices, its single-device step for the others).
  * AdamW (lr 3e-4, weight decay 1e-4, the CLI's optimizer) on (2, 2)
    against the single-process port step: loss to rtol 1e-5, parameters
    to rtol 1e-5, atol 1e-6 wherever the first gradient is at least 1e-6
    (the rule of chip_smoke's training check), and within 2 * lr
    elsewhere: Adam's first update lr * g / (|g| + 1e-8) turns the float32
    noise of a near-zero gradient, summed in another order over the data
    slices, into up to a sign flip.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sbb_textline_detection_tpu.models import registry as jreg
from sbb_textline_detection_tpu.parallel import mesh as jmesh
from sbb_textline_detection_tpu.training import train as jtrain
from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from sbb_textline_detection_tpu_torch.models import runner
from sbb_textline_detection_tpu_torch.parallel import dryrun
from sbb_textline_detection_tpu_torch.training import train

from tests import torch_mesh_jobs
from tests.test_torch_training import _f32_module, _noise_batch, _port_spec

TINY = jreg.ModelSpec("dryrun", "tpu_unet", 32, 32, 3, widths=(8, 16))
DUAL = jreg.ModelSpec("tiny_dual", "tpu_unet", 32, 32, 5, widths=(8, 16),
                      heads=(3, 2), in_channels=2)
SEEDS = {TINY.name: 3, DUAL.name: 6}
MESHES = ((2, 1), (1, 2), (2, 2))
SGD_LR = 1e-2
ADAMW_LR = 3e-4
CLI_SPEC = registry.ModelSpec("model_page_mixed_best", "tpu_unet", 32, 32,
                              2, widths=(8, 16))


def _cli_args(out, *extra):
    return ["--role", "page", "--out", str(out), "--steps", "2", "--batch",
            "4", "--model-parallel", "2", "--device", "cpu", "--log-every",
            "1", *extra]


@pytest.fixture(scope="module")
def inputs():
    """Per spec: (Flax variables, the port's state as numpy, images,
    labels)."""
    made = {}
    for spec in (TINY, DUAL):
        variables = jreg.init_variables(spec, seed=SEEDS[spec.name])
        state = {k: v.numpy() for k, v in
                 checkpoint.params_from_flax(variables).items()}
        imgs, labels = _noise_batch(np.random.default_rng(9), spec, n=4)
        made[spec.name] = (variables, state, imgs, labels)
    return made


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """Every sharded step (and two CLI runs in the group of 2), from the
    two spawned groups: {(spec name, mesh, optimizer): rank 0's result},
    plus the CLI outputs and directory under "cli"."""
    cli_dir = tmp_path_factory.mktemp("cli")
    jobs = {2: [], 4: []}
    keys = {2: [], 4: []}
    for spec in (TINY, DUAL):
        _, state, imgs, labels = inputs[spec.name]
        for (d, m), opt, lr in [(s, "sgd", SGD_LR) for s in MESHES] + [
                ((2, 2), "adamw", ADAMW_LR)]:
            jobs[d * m].append((dryrun.sharded_step,
                                (spec.to_meta(), m, state, imgs, labels, opt,
                                 lr)))
            keys[d * m].append((spec.name, (d, m), opt))
    meta = CLI_SPEC.to_meta()
    jobs[2] += [(torch_mesh_jobs.train_cli, (_cli_args(cli_dir), meta)),
                (torch_mesh_jobs.train_cli,
                 (_cli_args(cli_dir, "--resume"), meta))]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {w: pool.submit(dryrun.spawn, torch_mesh_jobs.run_jobs, w,
                               "gloo", (jobs[w],)) for w in jobs}
        # the JAX steps compile meanwhile
        jax_steps = {(spec.name, where): _jax_step(inputs, spec, where)
                     for spec in (TINY, DUAL) for where in ("single", (2, 2))}
        outs = {w: f.result() for w, f in futs.items()}
    got = {}
    for w in jobs:
        rank0 = outs[w][0]
        for rank_out in outs[w][1:]:
            for a, b in zip(rank0[:len(keys[w])], rank_out):
                assert a["loss"] == b["loss"], "ranks disagree on the loss"
        got.update(zip(keys[w], rank0))
    got["cli"] = (outs[2][0][len(keys[2]):], cli_dir)
    got["jax"] = jax_steps
    return got


def _jax_step(inputs, spec, where):
    """The JAX package's SGD step, on its (2, 2) mesh or on one device
    ("single"): (loss, updated variables)."""
    variables, _, imgs, labels = inputs[spec.name]
    mp = pytest.MonkeyPatch()
    mp.setattr(jreg, "build_module", _f32_module)
    try:
        tx = optax.sgd(SGD_LR)
        step = jax.jit(jtrain.make_train_step(spec, tx))
        x, y = jnp.asarray(imgs), jnp.asarray(labels)
        if where == (2, 2):
            mesh = jmesh.make_mesh(jax.devices()[:4], model_parallel=2)
            variables = jmesh.shard_tree(
                variables, jmesh.param_shardings(mesh, variables))
            x = jax.device_put(x, jmesh.batch_sharding(mesh))
            y = jax.device_put(y, jmesh.label_sharding(mesh, y.ndim))
        v, _, loss = step(variables, tx.init(variables), x, y)
        return float(loss), jax.tree_util.tree_map(np.asarray, v)
    finally:
        mp.undo()


def _single_step(inputs, spec, optimizer):
    """The port's single-process step from the same state and batch."""
    _, state, imgs, labels = inputs[spec.name]
    model = registry.build_module(_port_spec(spec), torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    opt = (torch.optim.SGD(model.parameters(), SGD_LR) if optimizer == "sgd"
           else train.make_optimizer(model.parameters(), ADAMW_LR))
    step = train.make_train_step(_port_spec(spec), model, opt)
    loss = step(torch.from_numpy(imgs), torch.from_numpy(labels))
    return float(loss), {k: v.numpy() for k, v in
                         model.state_dict().items()}


def _assert_state_close(got, want, where=None):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        sel = ... if where is None else where[k]
        np.testing.assert_allclose(got[k][sel], want[k][sel], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("spec", [TINY, DUAL], ids=["single_head",
                                                    "dual_head"])
def test_sharded_step_matches_single_process_and_jax(inputs, runs, spec,
                                                     mesh_shape):
    out = runs[(spec.name, mesh_shape, "sgd")]
    assert out["mesh"] == mesh_shape
    if mesh_shape[1] > 1:
        assert out["sharded"], "no conv was sharded over the model axis"
    loss, state = _single_step(inputs, spec, "sgd")
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
    _assert_state_close(out["state"], state)
    jloss, jvars = runs["jax"][(spec.name, mesh_shape if mesh_shape == (2, 2)
                                else "single")]
    np.testing.assert_allclose(out["loss"], jloss, rtol=1e-5)
    _assert_state_close(out["state"], {
        k: v.numpy() for k, v in checkpoint.params_from_flax(jvars).items()})


@pytest.mark.parametrize("spec", [TINY, DUAL], ids=["single_head",
                                                    "dual_head"])
def test_sharded_adamw_step_matches_single_process(inputs, runs, spec):
    out = runs[(spec.name, (2, 2), "adamw")]
    loss, state = _single_step(inputs, spec, "adamw")
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
    _, state0, _, _ = inputs[spec.name]
    _, sgd = _single_step(inputs, spec, "sgd")
    grad = {k: np.abs(state0[k] - sgd[k]) / SGD_LR for k in state0}
    assert np.mean([(g >= 1e-6).mean() for g in grad.values()]) > 0.9
    _assert_state_close(out["state"], state,
                        {k: g >= 1e-6 for k, g in grad.items()})
    for k in state:
        np.testing.assert_allclose(out["state"][k], state[k], rtol=0,
                                   atol=2 * ADAMW_LR, err_msg=k)


def test_model_parallel_shards_what_jax_shards(runs):
    """On a model axis of 2, every conv of the tiny TpuUnet (all widths
    even) keeps half its output channels, and the 3-class head stays
    whole; the JAX package's param_shardings shards the same kernels."""
    out = runs[(TINY.name, (1, 2), "sgd")]
    shapes = registry.state_shapes(_port_spec(TINY))
    convs = sorted(k for k in shapes if k.endswith("conv.weight"))
    assert [k for k in out["sharded"] if k.endswith("conv.weight")] == convs
    assert "head.weight" not in out["sharded"]
    mesh = jmesh.make_mesh(jax.devices()[:2], model_parallel=2)
    jv = jreg.init_variables(TINY, seed=0)
    specs = jmesh.param_shardings(mesh, jv)
    kernels = [jax.tree_util.keystr(p) for p, s in
               jax.tree_util.tree_flatten_with_path(specs)[0]
               if "model" in str(s.spec) and p[-1].key == "kernel"]
    assert len(kernels) == len(convs)


def test_cli_model_parallel_saves_weights_that_load_unsharded(runs):
    """Two CLI runs in a group of 2 with --model-parallel 2: the weights
    and the AdamW sidecar are whole, they load into an unsharded model,
    and the second run resumes from them."""
    (first, second), out = runs["cli"]
    assert "mesh: {'data': 1, 'model': 2} over 2 processes" in first
    assert "saved" in first and "resumed from" in second
    assert "at step 2" in second
    path = checkpoint.npz_path(str(out), CLI_SPEC.name)
    spec, variables = checkpoint.load(path)
    state = checkpoint.params_from_flax(variables)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        registry.state_shapes(CLI_SPEC)
    model = runner.SegmentationModel(spec, state, device="cpu",
                                     dtype=torch.float32)
    labels = model.predict_smalls_prescaled_batch(
        np.zeros((1, 32, 32, 3), np.uint8))
    assert labels.shape == (1, 32, 32)
    with np.load(path + ".trainstate.npz") as blob:
        assert int(blob["step"]) == 4
        for k, shape in registry.state_shapes(CLI_SPEC).items():
            assert blob[f"exp_avg::{k}"].shape == shape, k
