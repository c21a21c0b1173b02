"""The harness on the CPU at a tiny size: each cell of BENCHMARK.json runs
end to end and ends in a last line that meets the contract, an answer
altered where the program produces it makes `correct` false, the run
refuses a host without a card and a tree without the program, the idle
share takes the union of overlapping intervals, and JAX stays unloaded.
The `cuda` test runs a real cell on the card."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from benchmark import run, study, trace
from benchmark.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tree")
    return tmp, tiny.write_tree(tmp)


def _run(tree, capsys, cell, trace_flag=0, seed=2 ** 31 + 7, fault=None,
         limits=None):
    tmp, bench = tree
    if limits is not None:
        (tmp / "bench" / "limits" / f"{cell}.json").write_text(
            json.dumps(limits))
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "2",
            "--trace", str(trace_flag)]
    kwargs = dict(device="cpu", bench_path=str(bench),
                  weights_root=str(tmp / "weights"),
                  pipeline_config=tiny.pipeline_config())
    try:
        if fault:
            with study.planted(fault):
                rc = run.main(argv, **kwargs)
        else:
            rc = run.main(argv, **kwargs)
    finally:
        (tmp / "bench" / "limits" / f"{cell}.json").write_text(
            json.dumps(tiny.LOOSE))
    out, err = capsys.readouterr()
    assert rc == 0, err[-2000:]
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace_flag", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_ends_in_the_contracts_line(tree, capsys, cell, trace_flag):
    line, err = _run(tree, capsys, cell, trace_flag)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True and line["attempted"] > 0
    assert line["failed"] == 0
    assert set(line["checks"]) == set(tiny.LOOSE)
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    assert err.strip().splitlines()[-1].startswith("check ")
    kind = "per_layer" if trace_flag else "end_to_end"
    names = {m["name"] for m in BENCH[kind]
             if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) <= names
    if not trace_flag:
        assert set(line["metrics"]) == names
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    # a CPU run reports no reading of the card
    for base in ("mfu", "segmentation_roofline", "device_idle_share",
                 "radon_kernel_ms_per_page"):
        assert not any(n.startswith(base + ".") for n in line["metrics"])
    if trace_flag:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert line["device"]["window_s"] > 0


def test_an_answer_altered_where_it_is_produced_is_not_correct(
        tree, capsys):
    """Limits just above a sound run's readings hold the sound run and
    fail the run whose region masks the fault altered as the fused
    segmentation returned them."""
    cell = CELLS[0]
    sound, _ = _run(tree, capsys, cell, seed=11)
    limits = {k: (v["value"] * 1.5 + 1e-3) for k, v in
              sound["checks"].items()}
    again, _ = _run(tree, capsys, cell, seed=11, limits=limits)
    broken, _ = _run(tree, capsys, cell, seed=11, fault="fault-mask",
                     limits=limits)
    assert again["correct"] is True
    assert broken["correct"] is False
    assert broken["checks"]["region_px"]["value"] > limits["region_px"]


def test_the_slope_fault_turns_every_slope_the_deskew_returns(monkeypatch):
    from sbb_textline_detection_tpu_torch.pipeline import stages

    monkeypatch.setattr(stages, "slopes_and_lines",
                        lambda *a, **k: ([1.0, -3.5], ["lines"]))
    with study.planted("fault-slope"):
        assert stages.slopes_and_lines() == (
            [1.0 + study.FAULT_TURN_DEG, -3.5 + study.FAULT_TURN_DEG],
            ["lines"])
    assert stages.slopes_and_lines() == ([1.0, -3.5], ["lines"])


def test_study_reads_the_control_and_the_program(tree):
    """The study reads the program and the control; with limits just above
    the program's readings, run.verdict holds the program and fails the
    control put in its place."""
    tmp, bench = tree
    kwargs = dict(device="cpu", bench_path=str(bench),
                  weights_root=str(tmp / "weights"),
                  pipeline_config=tiny.pipeline_config())
    program = study.main(["--workload", CELLS[0], "--seeds", "4",
                          "--seconds", "1"], **kwargs)
    limits_path = tmp / "bench" / "limits" / f"{CELLS[0]}.json"
    limits = {k: program[0][k] * 1.5 + 1e-3 for k in tiny.LOOSE}
    limits_path.write_text(json.dumps(limits))
    try:
        control = study.main(["--workload", CELLS[0], "--seeds", "4",
                              "--modes", "control"], **kwargs)
        again = study.main(["--workload", CELLS[0], "--seeds", "4",
                            "--seconds", "1"], **kwargs)
    finally:
        limits_path.write_text(json.dumps(tiny.LOOSE))
    assert program[0]["pages"] > 0 and again[0]["correct"] is True
    assert control[0]["textline_px"] > program[0]["textline_px"]
    assert set(control[0]) >= set(run.KEPT) and not \
        set(control[0]) & set(run.SERVED)
    assert control[0]["correct"] is False


def test_faults_alter_only_the_pages_they_name(monkeypatch):
    """fault-merge boxes each pair of neighbouring lines; `@j` leaves the
    other pool pages' answers as the program gave them."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.pipeline import stages

    line = [np.array([[[0, 0]], [[10, 0]], [[10, 4]]], np.int32),
            np.array([[[2, 8]], [[12, 8]], [[12, 12]]], np.int32),
            np.array([[[0, 20]], [[5, 24]], [[1, 22]]], np.int32)]
    monkeypatch.setattr(stages, "slopes_and_lines",
                        lambda *a, **k: ([1.0], [line]))
    with study.planted("fault-merge"):
        _, (merged,) = stages.slopes_and_lines()
    assert len(merged) == 2 and merged[0].shape == (4, 1, 2)
    assert merged[0].reshape(-1, 2).tolist() == [[0, 0], [12, 0], [12, 12],
                                                 [0, 12]]
    with study.planted("fault-lines@3"):
        study._PAGE.j = 2
        assert stages.slopes_and_lines() == ([1.0], [line])
        study._PAGE.j = 3
        assert len(stages.slopes_and_lines()[1][0]) == 2
    assert study._pool_index("p3c12") == 3 and study._pool_index("w5") == 5


def test_writer_faults_shrink_regions_and_reverse_the_order(monkeypatch):
    import numpy as np

    from sbb_textline_detection_tpu_torch.pagexml import writer

    monkeypatch.setattr(writer, "build_page_xml", lambda **k: k)
    box = np.array([[[0, 0]], [[8, 0]], [[8, 4]], [[0, 4]]], np.int32)
    with study.planted("fault-regions"):
        out = writer.build_page_xml(contours=[box], order_of_texts=[0])
    assert out["contours"][0].reshape(-1, 2).tolist() == [
        [2, 1], [6, 1], [6, 3], [2, 3]]
    with study.planted("fault-order"):
        out = writer.build_page_xml(contours=[box] * 3,
                                    order_of_texts=[1, 0, 2])
    assert out["order_of_texts"] == [1, 2, 0]


def test_no_card_exits_without_a_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    out, _ = capsys.readouterr()
    assert rc != 0 and out == ""


def test_a_tree_without_the_program_exits_without_a_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    assert run._forbidden_loaded(["sbb_textline_detection_tpu_torch.ops",
                                  "jaxfoo", "flaxen.x", "numpy"]) == []
    assert run._forbidden_loaded(["sbb_textline_detection_tpu.core",
                                  "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "sbb_textline_detection_tpu"]


def test_a_tiny_run_loads_neither_jax_nor_the_jax_package(tree):
    tmp, bench = tree
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark import run; from benchmark.tests import tiny\n"
        "rc = run.main(['--workload', %r, '--seed', '3', '--seconds', '1',"
        " '--trace', '0'], device='cpu', bench_path=%r, weights_root=%r,"
        " pipeline_config=tiny.pipeline_config())\n"
        "print(json.dumps([rc, sorted({m.split('.')[0] for m in"
        " sys.modules})]))\n") % (str(ROOT), CELLS[0], str(bench),
                                  str(tmp / "weights"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600)
    rc, mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rc == 0, proc.stderr[-2000:]
    assert not set(mods) & set(run.FORBIDDEN)
    assert "sbb_textline_detection_tpu_torch" in mods


def test_check_lines_name_the_pool_page_of_each_worst_number():
    """On a fake window of served pages: each worst-of-page layout number
    names the pool page j that set it (the first, on a tie); the kept
    comparisons and the window's means name none."""
    import types

    worst = {3: {"line_recall_gap": 0.1, "line_count_err": 2.0,
                 "reading_order_gap": 0.0, "slope_deg": 0.3},
             1: {"line_recall_gap": 0.6, "line_count_err": 0.5,
                 "reading_order_gap": 0.0, "slope_deg": 15.3},
             4: {"line_recall_gap": 0.6, "line_count_err": 1.0,
                 "reading_order_gap": 0.4, "slope_deg": 0.1}}
    served = [{"j": j, **worst[j], "line_precision_gap": 0.1,
               "region_recall_gap": 0.0, "region_precision_gap": 0.2}
              for j in (3, 1, 4, 3)]
    kept = [{"j": j, "page_labels_px": 1e-4, "region_px": 2e-4,
             "textline_px": 0.0, "page_box_px": 0.0} for j in (1, 3)]
    cell = types.SimpleNamespace(limits=tiny.LOOSE)
    _, checks = run.verdict(cell, run.numbers(kept, served))
    lines = run.check_lines(checks, served)
    assert len(lines) == len(checks)
    setter = {"line_recall_gap": 1, "line_count_err": 3,
              "reading_order_gap": 4, "slope_deg": 1}
    for line, (k, v) in zip(lines, checks.items()):
        head = f"check {k} {v['value']} limit {v['limit']}"
        if k in run.SERVED_WORST:
            assert line == f"{head} pool page {setter[k]}"
        else:
            assert line == head


def test_idle_share_takes_the_union_of_overlapping_streams():
    # two streams: [0, 4] and [2, 6] overlap, [8, 9] after a gap
    device = [("conv", 0.0, 4.0), ("gemm", 2.0, 6.0), ("radon", 8.0, 9.0),
              ("copy", 8.5, 8.7)]
    assert trace.union_length([(s, e) for _, s, e in device]) == 7.0
    assert trace.gaps([(s, e) for _, s, e in device]) == [(6.0, 8.0)]
    host = [("outer", 5.0, 9.0), ("aten::nonzero", 6.5, 7.5)]
    s = trace.summary(device, host)
    assert s["busy_s"] == 7.0
    assert s["idle_gaps"] == [["aten::nonzero", 2.0]]
    assert s["device_ops"][0] == ["conv", 4.0]


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device, capsys):
    rc = run.main(["--workload", CELLS[0], "--seed", "5", "--seconds", "3",
                   "--trace", "1"])
    out, _ = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
