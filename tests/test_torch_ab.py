"""The port's paired A/B harness (sbb_textline_detection_tpu_torch/ab.py)
against the JAX package's A/B scripts (`scripts/ab_*.py`): each study's
arms, its page set, the paired bookkeeping, the output checks and the
command's device rule. The serving runs use a tiny bundle on the CPU."""

import ast
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu_torch import ab
from sbb_textline_detection_tpu_torch.core.config import (DEFAULT_CONFIG,
                                                          DeskewConfig,
                                                          ResizePolicy)
from sbb_textline_detection_tpu_torch.models import registry
from sbb_textline_detection_tpu_torch.models.runner import ModelBundle

ROOT = pathlib.Path(__file__).resolve().parents[1]

DUAL_TINY = registry.ModelSpec("tiny_dual", "tpu_unet", 64, 64, 5,
                               widths=(8, 16), heads=(3, 2), in_channels=2)
PAGE_TINY = registry.ModelSpec("tiny_page", "tpu_unet", 64, 64, 2,
                               widths=(8, 16))
CFG = dataclasses.replace(
    DEFAULT_CONFIG, resize=ResizePolicy(300, 240, 1.0),
    deskew=DeskewConfig(coarse_steps=6, vertical_steps=4),
    runtime=dataclasses.replace(DEFAULT_CONFIG.runtime,
                                batch_buckets=(2, 4, 8), deskew_canvas=256,
                                deskew_spec_slots=8))


@pytest.mark.parametrize("study, flags, script", [
    ("workers", {"device_phase_workers"}, "ab_workers.py"),
    ("dispatch", {"pages_per_dispatch"}, "ab_workers.py"),
    ("spec", {"spec_deskew"}, "ab_spec.py"),
    ("paths", {"device_page_box", "fused_page_box"}, "ab_paths.py"),
    ("canvas", {"deskew_canvas"}, "ab_deskew_canvas.py")])
def test_arms_change_only_their_flags_and_pages_are_the_scripts(
        study, flags, script):
    """Each arm's config differs from DEFAULT_CONFIG in the study's flags
    alone, the default arm's not at all; `--pages script` renders the JAX
    script's pages (seed, skew and degradation of each page, read from
    the script)."""
    s = ab.STUDIES[study]
    want = dataclasses.asdict(DEFAULT_CONFIG)
    for arm in s.arms:
        got = dataclasses.asdict(ab.arm_config(arm))
        assert {k for k in got if got[k] != want[k]} <= {"runtime"}
        changed = {k for k, v in got["runtime"].items()
                   if v != want["runtime"][k]}
        assert changed <= flags and set(arm.flags) <= flags, arm
        assert (arm.name == s.default) == (not changed and not arm.serial)
    assert sum(a.name == s.default for a in s.arms) == 1

    made, seeds = [], []
    fake_np = types.SimpleNamespace(random=types.SimpleNamespace(
        default_rng=lambda seed: seeds.append(seed) or seed))
    fake_syn = types.SimpleNamespace(make_page=lambda rng, h, w, **kw: (
        made.append((rng, kw["skew_deg"], kw["degrade"])), None))
    tree = ast.parse((ROOT / "scripts" / script).read_text())
    page_set = [n for n in tree.body if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id in ("rng", "skews", "SKEWS", "degs",
                                        "pages")]
    exec(compile(ast.Module(page_set, []), script, "exec"),
         {"np": fake_np, "synthetic": fake_syn})
    seed, skews, degrades = s.script_pages
    assert made == [(seed, sk, d) for sk, d in zip(skews, degrades)]
    assert seeds == [seed] and len(made) == 8


class _FakeDet:
    """process_batch / process_image that return results with the given
    per-page totals and regions, recording which was called."""

    def __init__(self, totals, regions):
        self.totals, self.regions, self.calls = totals, regions, []

    def _result(self, i):
        return types.SimpleNamespace(timings={"total": self.totals[i]},
                                     contours=[0] * self.regions[i])

    def process_batch(self, items):
        self.calls.append("process_batch")
        for i, _ in enumerate(items):
            yield self._result(i)

    def process_image(self, page, name):
        self.calls.append("process_image")
        return self._result(int(name.split("_")[1].split(".")[0]))


def test_paired_bookkeeping_on_a_fake_clock():
    """Min of each pair, the round's winner, wins, pages/s and the p50 of
    the pages' totals, from a clock that steps by the given seconds."""
    arms = {"B": ab.Arm("B", {}), "S": ab.Arm("S", {}, serial=True)}
    dets = {"B": _FakeDet([0.1, 0.3, 0.2], [2, 1, 0]),
            "S": _FakeDet([0.5, 0.4, 0.9], [1, 1, 1])}
    # per run: start, end; rounds: B 4, 3 / S 2, 5, then B 1, 6 / S 2.5, 2.5
    durations = iter([4.0, 3.0, 2.0, 5.0, 1.0, 6.0, 2.5, 2.5])
    state = {"t": 0.0, "start": True}

    def clock():
        if not state["start"]:
            state["t"] += next(durations)
        state["start"] = not state["start"]
        return state["t"]

    lines = []
    records, wins = ab.paired_rounds(
        ["B", "S"], lambda n, tag: ab.serve(dets[n], arms[n], [None] * 3,
                                            "cpu", clock)[0],
        2, lines.append)
    assert wins == {"B": 1, "S": 1}
    assert [r["winner"] for r in records] == ["S", "B"]
    assert records[0]["seconds"] == {"B": [4.0, 3.0], "S": [2.0, 5.0]}
    assert records[0]["min_seconds"] == {"B": 3.0, "S": 2.0}
    assert records[1]["pages_per_s"] == {"B": 3.0, "S": 3 / 2.5}
    assert records[1]["p50_ms"] == pytest.approx({"B": 200.0, "S": 500.0})
    assert records[1]["regions"] == {"B": 3, "S": 3}
    assert dets["B"].calls == ["process_batch"] * 4
    assert dets["S"].calls == ["process_image"] * 12
    assert len(lines) == 2 and lines[0].endswith("-> S")


@pytest.fixture(scope="module")
def spec_run():
    """The spec study on the CPU: 2 small busy pages, one round, a tiny
    bundle; (record, the kept outputs by arm)."""
    bundle = ModelBundle.random_init(
        CFG.runtime, seed=0, device="cpu", dtype=torch.float32,
        specs={"page": PAGE_TINY, "region": DUAL_TINY, "textline": None})
    with torch.no_grad():
        bias = bundle.region.module.head.bias
        bias[1] += 0.3
        bias[4] += 0.6
    study = ab.STUDIES["spec"]
    pages, layouts = ab.study_pages(study, "script", 420, 300, n=2)
    kept = {}
    real = ab.compare_outputs
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ab, "compare_outputs",
                   lambda s, outs: (kept.update(outs), real(s, outs))[1])
        rec = ab.run_study(study, bundle, pages, layouts, rounds=1,
                           device="cpu", base=CFG)
    return rec, kept


@pytest.mark.parametrize("case", ["as_served", "spec_slopes_altered",
                                  "paths_slopes_altered"])
def test_output_checks(spec_run, case):
    """The spec study's arms give bit-equal slopes and PAGE-XML on the
    CPU; one slope moved by one ulp makes the spec check raise, and is
    only reported by another study's check."""
    rec, kept = spec_run
    assert rec["regions"]["S"] == rec["regions"]["N"] and \
        rec["regions"]["N"][0] > 0
    if case == "as_served":
        assert [(r["slopes_equal"], r["xml_equal"], r["mask_moved"])
                for r in rec["checks"]["S"]] == [(True, True, 0.0)] * 2
        assert ab.clean(rec) == []
        return
    page = next(i for i, o in enumerate(kept["S"]) if o.slopes)
    altered = dataclasses.replace(kept["S"][page], slopes=list(
        kept["S"][page].slopes))
    altered.slopes[0] = float(np.nextafter(altered.slopes[0], np.inf))
    outs = {"N": kept["N"], "S": [altered if i == page else o
                                  for i, o in enumerate(kept["S"])]}
    if case == "spec_slopes_altered":
        with pytest.raises(ab.SlopesDiffer, match="slopes differ"):
            ab.compare_outputs(ab.STUDIES["spec"], outs)
    else:
        paths = dataclasses.replace(ab.STUDIES["paths"], default="N")
        rows = ab.compare_outputs(paths, outs)["S"]
        assert [r["slopes_equal"] for r in rows] == [
            i != page for i in range(2)]


def test_record_has_its_keys(spec_run):
    rec = json.loads(json.dumps(spec_run[0]))
    assert set(rec) == {"study", "page_count", "page_hw", "rounds_asked",
                        "arms", "default", "warm_up_seconds", "rounds",
                        "wins", "pages_per_s", "p50_ms", "regions",
                        "fallbacks", "degraded", "checks", "quality"}
    assert rec["page_count"] == 2 and rec["default"] == "N"
    assert set(rec["rounds"][0]) == {"round", "seconds", "min_seconds",
                                     "pages_per_s", "p50_ms", "regions",
                                     "winner"}
    assert sum(rec["wins"].values()) == 1 == len(rec["rounds"])
    assert all(len(v) == 2 for v in rec["rounds"][0]["seconds"].values())


@pytest.mark.parametrize("argv, cuda, rc", [
    ([], False, 2), (["--device", "cuda"], False, 2),
    (["--device", "cpu"], False, 0), (["--device", "cpu", "--bad"], False, 1)])
def test_main_runs_on_the_card_unless_cpu_is_asked(monkeypatch, capsys,
                                                   argv, cuda, rc):
    """The command defaults to cuda and stops without a card; with
    `--device cpu` it prints the card line, then a JSON object per study
    and page set, and exits 1 when an arm fell back."""
    bad = "--bad" in argv
    argv = [a for a in argv if a != "--bad"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cuda)
    monkeypatch.setattr(ab.bench, "ensure_native", lambda: None)
    monkeypatch.setattr(ab, "load_bundle", lambda *a, **kw: "bundle")
    monkeypatch.setattr(ab, "study_pages", lambda *a: ([], []))
    monkeypatch.setattr(ab, "run_study", lambda study, models, pages,
                        layouts, rounds, arms, **kw: {
        "study": study.name, "degraded": {"N": 0}, "arms": arms,
        "fallbacks": {"N": {"host_sweep": 1} if bad else {}}, "wins": {}})
    if rc == 2:
        with pytest.raises(SystemExit) as exc:
            ab.main(["--study", "spec"] + argv)
        assert exc.value.code == 2
        assert "'cuda'" in capsys.readouterr().err
        return
    assert ab.main(["--study", "spec", "canvas", "--pages", "script",
                    "hard_mix", "--arms", "N", "S"] + argv) == rc
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "cpu"
    recs = [json.loads(line) for line in lines[-4:]]
    assert [(r["study"], r["pages"], r["card"], r["arms"])
            for r in recs] == [
        (s, p, "cpu", ["N", "S"]) for s in ("spec", "canvas")
        for p in ("script", "hard_mix")]
