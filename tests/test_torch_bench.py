"""The port's serving bench (sbb_textline_detection_tpu_torch/bench.py)
against the repo's `bench.py`, which runs the JAX package: the checkpoint
recipe, the hard_mix corpus and the JSON line's keys. `bench.py`'s corpus
table and result literal are read from its source with `ast`, so the two
cannot drift apart."""

import ast
import dataclasses
import importlib.util
import math
import pathlib
import subprocess

import numpy as np
import torch

from sbb_textline_detection_tpu.training import train as jtrain
from sbb_textline_detection_tpu.utils import synthetic as jsyn
from sbb_textline_detection_tpu_torch import bench
from sbb_textline_detection_tpu_torch.core.config import (DEFAULT_CONFIG,
                                                          DeskewConfig,
                                                          ResizePolicy)
from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
from sbb_textline_detection_tpu_torch.pipeline.detector import (
    TextlineDetector)
from sbb_textline_detection_tpu_torch.training import train
from sbb_textline_detection_tpu_torch.utils import synthetic

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_BENCH = ROOT / "bench.py"


def _main_assign(name):
    """The value node assigned to `name` inside bench.py's main()."""
    tree = ast.parse(JAX_BENCH.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    return next(n.value for n in ast.walk(main)
                if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == name
                        for t in n.targets))


def _dict_keys(node, prefix=""):
    """Every key of a dict literal, nested ones as 'outer.inner'."""
    keys = []
    for k, v in zip(node.keys, node.values):
        key = prefix + ast.literal_eval(k)
        keys.append(key)
        if isinstance(v, ast.Dict):
            keys += _dict_keys(v, key + ".")
    return keys


def _fake_pool_page(rng, kind=None):
    """A small pool page drawn from the pool's rng, as the real renderer
    draws from it (a rendered A4 pool costs tens of seconds)."""
    return (rng.integers(0, 256, (520, 500)).astype(np.uint8),
            rng.integers(0, 8, (520, 500)).astype(np.uint8))


class _Recorder:
    """Stands in for a Trainer: records its arguments, the steps asked for,
    the first batch of its data and where it was saved."""

    def __init__(self, calls, spec, learning_rate=3e-4, seed=0, **kw):
        self.calls = calls
        self.call = {"spec": spec.name, "lr": learning_rate, "seed": seed}
        self.variables = {}

    def train(self, data_iter, steps):
        images, labels = next(data_iter)
        self.call.update(steps=steps, images=images, labels=labels)
        return [1.0, 0.5]

    def save(self, path):
        self.call["saved"] = pathlib.Path(path).name
        self.calls.append(self.call)


def _load_jax_bench(monkeypatch, tmp_path):
    """Import bench.py without touching the repo: its compile-cache
    variables point at tmp_path first (it only sets them by setdefault),
    and its import-time `make -C native` is recorded, not run (no recipe
    step needs the host library)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
    monkeypatch.setenv("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1.0")
    made = []
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: made.append(cmd))
    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.undo()
    assert made and made[0][:2] == ["make", "-C"]
    return mod


def test_checkpoint_recipe_equals_jax_bench(monkeypatch, tmp_path):
    """(role, spec, steps, lr, seed), the file each role is saved to and
    the first batch of each role's data, bit-equal in both benches."""
    jbench = _load_jax_bench(monkeypatch, tmp_path)
    runs = {}
    for name, mod, syn, train_mod in (("jax", jbench, jsyn, jtrain),
                                      ("torch", bench, synthetic, train)):
        calls = runs[name] = []
        monkeypatch.setattr(train_mod, "Trainer",
                            lambda *a, **kw: _Recorder(calls, *a, **kw))
        monkeypatch.setattr(syn, "_PAGE_POOL", None)
        monkeypatch.setattr(syn, "_render_pool_page", _fake_pool_page)
        out = tmp_path / name
        kw = {} if name == "jax" else {"device": "cpu"}
        assert mod.ensure_bench_checkpoints(str(out), 2, **kw) == str(out)
    got, want = runs["torch"], runs["jax"]
    assert [(c["spec"], c["steps"], c["lr"], c["seed"], c["saved"])
            for c in got] == [
        (registry.DEFAULT_SPECS["page"].name, 2, 3e-4, 0,
         DEFAULT_CONFIG.model_names.page + ".npz"),
        (registry.DUALHEAD_SPEC.name, 12, 3e-4, 0,
         DEFAULT_CONFIG.model_names.dualhead + ".npz")]
    assert [(c["spec"], c["steps"], c["lr"], c["seed"], c["saved"])
            for c in want] == [
        (c["spec"], c["steps"], c["lr"], c["seed"], c["saved"]) for c in got]
    for g, w in zip(got, want):
        for key in ("images", "labels"):
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key], w[key])
    assert got[1]["images"].shape == (8, 448, 448, 2)


def test_existing_checkpoints_are_not_trained_again(monkeypatch, tmp_path):
    """A role whose file exists is skipped; the other one trains."""
    names = DEFAULT_CONFIG.model_names
    (tmp_path / (names.page + ".npz")).write_bytes(b"")
    calls = []
    monkeypatch.setattr(train, "Trainer",
                        lambda *a, **kw: _Recorder(calls, *a, **kw))
    monkeypatch.setattr(synthetic, "_PAGE_POOL", None)
    monkeypatch.setattr(synthetic, "_render_pool_page", _fake_pool_page)
    bench.ensure_bench_checkpoints(str(tmp_path), 1, device="cpu")
    assert [c["spec"] for c in calls] == [registry.DUALHEAD_SPEC.name]
    (tmp_path / (names.dualhead + ".npz")).write_bytes(b"")
    bench.ensure_bench_checkpoints(str(tmp_path), 1, device="cpu")
    assert len(calls) == 1


def test_packed_checkpoints_unpack_bit_for_bit(tmp_path):
    """checkpoint.pack_dir / unpack_dir (how the card's bench checkpoints
    come back for scripts/trained_parity.py) give back every checkpoint of
    a directory bit for bit, and the JAX package loads what comes out."""
    from sbb_textline_detection_tpu.models import checkpoint as jckpt

    src, out = tmp_path / "src", tmp_path / "out"
    src.mkdir()
    for i, spec in enumerate((PAGE_TINY, DUAL_TINY)):
        checkpoint.save(str(src / f"{spec.name}.npz"), spec,
                        checkpoint.random_init(
                            spec, torch.Generator().manual_seed(i)))
    (src / "notes.txt").write_text("not a checkpoint")
    size = checkpoint.pack_dir(str(src), str(tmp_path / "packed.npz"))
    assert size == (tmp_path / "packed.npz").stat().st_size
    assert checkpoint.unpack_dir(str(tmp_path / "packed.npz"), str(out)) == \
        sorted(f"{spec.name}.npz" for spec in (PAGE_TINY, DUAL_TINY))
    for spec in (PAGE_TINY, DUAL_TINY):
        with np.load(src / f"{spec.name}.npz") as a, \
                np.load(out / f"{spec.name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                assert a[key].tobytes() == b[key].tobytes()
        jspec, _ = jckpt.load(str(out / f"{spec.name}.npz"))
        assert jspec.name == spec.name


def test_hard_mix_pages_equal_jax():
    """bench_pages(8, 600, 424): the JAX package's make_page over
    bench.py's hard_mix, in pages and in layouts."""
    hard_mix = ast.literal_eval(_main_assign("hard_mix"))
    assert bench.HARD_MIX == hard_mix
    assert bench.bench_mix(10) == [hard_mix[i % 8] for i in range(10)]
    pages, layouts = bench.bench_pages(8, 600, 424)
    rng = np.random.default_rng(7)
    for i, m in enumerate(hard_mix):
        page, layout = jsyn.make_page(rng, 600, 424, skew_deg=m[0],
                                      degrade=m[1], figures=m[2], bleed=m[3],
                                      vertical=m[4])
        np.testing.assert_array_equal(pages[i], page)
        assert dataclasses.asdict(layouts[i]) == dataclasses.asdict(layout)


# a tiny bundle whose random heads are nudged towards the text classes, so
# that its 600 x 424 pages carry regions and lines that match the layouts
DUAL_TINY = registry.ModelSpec("tiny_dual", "tpu_unet", 64, 64, 5,
                               widths=(8, 16), heads=(3, 2), in_channels=2)
PAGE_TINY = registry.ModelSpec("tiny_page", "tpu_unet", 64, 64, 2,
                               widths=(8, 16))
CFG = dataclasses.replace(
    DEFAULT_CONFIG, resize=ResizePolicy(300, 240, 1.0),
    deskew=DeskewConfig(coarse_steps=6, vertical_steps=4),
    runtime=dataclasses.replace(DEFAULT_CONFIG.runtime,
                                batch_buckets=(2, 4, 8), deskew_canvas=256))
# two pages that cover every category of the quality keys: skewed (high
# skew), degraded, with figures; and vertical
MIX = [(18.0, 0.8, 2, 0.0, False), (0.0, 0.0, 0, 0.0, True)]


def _finite_numbers(value, where=""):
    if isinstance(value, dict):
        for k, v in value.items():
            _finite_numbers(v, f"{where}.{k}")
    elif isinstance(value, list):
        for v in value:
            _finite_numbers(v, where)
    elif not isinstance(value, (str, bool)):
        assert math.isfinite(value), where


def test_run_gives_every_key_of_jax_bench(monkeypatch):
    """run() on the CPU over 2 small pages: warm_up, the warm pass and the
    timed pass happen in that order; the dict has every key of bench.py's
    result literal, and its numbers are finite. The weights are a torch
    generator's draws (seed 1), on which the head-bias nudge below makes
    the tiny nets find text on both pages."""
    def drawn(spec):
        return spec, checkpoint.flax_from_params(checkpoint.random_init(
            spec, torch.Generator().manual_seed(1)))

    bundle = ModelBundle.from_jax_variables(
        drawn(PAGE_TINY), drawn(DUAL_TINY), runtime=CFG.runtime,
        device="cpu", dtype=torch.float32)
    with torch.no_grad():
        bias = bundle.region.module.head.bias
        bias[1] += 0.3
        bias[4] += 0.6
    det = TextlineDetector(bundle, CFG)
    calls = []
    warm_up, batch = det.warm_up, det.process_batch
    monkeypatch.setattr(det, "warm_up", lambda h, w: (
        calls.append(("warm_up", h, w)), warm_up(h, w))[1])
    monkeypatch.setattr(det, "process_batch", lambda pages: (
        calls.append("process_batch"), batch(pages))[1])
    rng = np.random.default_rng(7)
    made = [synthetic.make_page(rng, 600, 424, skew_deg=m[0], degrade=m[1],
                                figures=m[2], bleed=m[3], vertical=m[4])
            for m in MIX]
    # a CPU-sized peak: against the card's 989e12 a CPU run's share of
    # peak rounds to 0 at the key's 5 decimals
    out = bench.run(det, [p for p, _ in made], [lay for _, lay in made], MIX,
                    600, 424, peak_flops=1e9)
    assert calls == [("warm_up", 600, 424), "process_batch", "process_batch"]
    want = set(_dict_keys(_main_assign("result")))
    assert want <= set(_dict_keys_of(out))
    _finite_numbers(out)
    assert out["pages"] == 2 and out["regions_total"] > 0
    assert out["mfu"] > 0 and out["flops_per_page"] > 0
    assert out["quality"]["vertical"] == [False, True]


def _dict_keys_of(d, prefix=""):
    keys = []
    for k, v in d.items():
        keys.append(prefix + k)
        if isinstance(v, dict):
            keys += _dict_keys_of(v, prefix + k + ".")
    return keys
