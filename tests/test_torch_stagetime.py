"""The per-stage device-time / FLOP ledger of the port
(utils/stagetime.py), the two PageResult fields it fills, utils/profiling.py
and the CLI's --timings / --profile, against the JAX package where it has
the same thing.

FLOPs: XLA's cost model counts every fused elementwise operation of a
program, the port counts convolutions and matmuls only, so the JAX
PageResult.flops (2.51e9 on the tiny page below against the port's
2.04e9) is not the yardstick. The port's count is held to a hand count
instead: 2 x multiply-adds of every convolution of the TpuUnet, written
out from its architecture, times the forwards a page runs, plus the deskew
chain's projection matmuls.
"""

import dataclasses
import glob
import json
import threading
import time

import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from sbb_textline_detection_tpu.pipeline import detector as jdetector
from sbb_textline_detection_tpu_torch import cli
from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
from sbb_textline_detection_tpu_torch.models import checkpoint
from sbb_textline_detection_tpu_torch.models import registry as treg
from sbb_textline_detection_tpu_torch.pipeline import deskew, detector
from sbb_textline_detection_tpu_torch.utils import profiling, stagetime

from tests.test_torch_detector import (CFG, DUAL_TINY, PAGE_TINY, _page,
                                       bundles)


def _cfg(**flags):
    return dataclasses.replace(
        CFG, runtime=dataclasses.replace(CFG.runtime, **flags))


# -- the hand count ---------------------------------------------------------------

def _conv(cout, cin, k, h, w):
    return 2 * cout * cin * k * k * h * w


def tpu_unet_flops(h, w, in_ch, widths, n_classes, refine=32):
    """Convolution FLOPs of one TpuUnet forward on an (h, w) input, from
    its architecture: a stride-2 stem; per width two 3x3 convs and a
    stride-2 one; two bottleneck convs at twice the last width; per width
    on the way up a conv after the 2x upsample, a conv on the concat with
    the skip and one more; a refine conv at full size and the 1x1 head."""
    h, w = h // 2, w // 2
    total = _conv(widths[0], in_ch, 3, h, w)
    ch = widths[0]
    for wd in widths:
        total += _conv(wd, ch, 3, h, w) + _conv(wd, wd, 3, h, w)
        h, w = h // 2, w // 2
        total += _conv(wd, wd, 3, h, w)
        ch = wd
    mid = 2 * widths[-1]
    total += _conv(mid, ch, 3, h, w) + _conv(mid, mid, 3, h, w)
    ch = mid
    for wd in reversed(widths):
        h, w = 2 * h, 2 * w
        total += (_conv(wd, ch, 3, h, w) + _conv(wd, 2 * wd, 3, h, w)
                  + _conv(wd, wd, 3, h, w))
        ch = wd
    h, w = 2 * h, 2 * w
    return total + _conv(refine, ch, 3, h, w) + _conv(n_classes, refine, 1,
                                                      h, w)


def _meta_forward_flops(spec, batch=1):
    module = treg.build_module(treg.ModelSpec.from_meta(spec.to_meta()),
                               torch.float32).to("meta")
    x = torch.empty((batch, spec.in_channels or 3, spec.input_height,
                     spec.input_width), device="meta")
    with torch.no_grad():
        return stagetime.count_flops(module.forward_nchw, x)[1]


def test_count_flops_equals_the_hand_count_and_torchs_counter():
    from torch.utils.flop_counter import FlopCounterMode

    for spec in (PAGE_TINY, DUAL_TINY):
        module = treg.build_module(treg.ModelSpec.from_meta(spec.to_meta()),
                                   torch.float32).eval()
        x = torch.rand((3, spec.in_channels or 3, 64, 64))
        with torch.no_grad():
            out, got = stagetime.count_flops(module.forward_nchw, x)
            with FlopCounterMode(display=False) as fc:
                want_out = module.forward_nchw(x)
        torch.testing.assert_close(out, want_out, rtol=0, atol=0)
        assert got == fc.get_total_flops()
        assert got == 3 * tpu_unet_flops(64, 64, spec.in_channels or 3,
                                         spec.widths, spec.n_classes)


def test_full_width_counts_agree_with_the_records():
    """Two figures the records hold: ~735 GFLOP per dual-head training
    step of 8 at 448 x 448 (forward + backward, 3 x the forward), and 59.3
    GFLOP per 448 x 448 ResNet50Unet tile."""
    dual = treg.DUALHEAD_SPEC
    fwd = _meta_forward_flops(dual)
    assert fwd == tpu_unet_flops(448, 448, 2, dual.widths, dual.n_classes)
    assert 3 * 8 * fwd == pytest.approx(735e9, rel=0.02)
    resnet = treg.ModelSpec("r", "resnet50_unet", 448, 448, 3)
    assert _meta_forward_flops(resnet) == pytest.approx(59.3e9, rel=0.01)


# -- the ledger -----------------------------------------------------------------

def test_ledger_is_per_thread_and_resets():
    stagetime.reset()
    stagetime.add(1.5, 10.0)
    with stagetime.device_section("cpu", flops=5.0):
        time.sleep(0.02)
    seen = {}

    def other():
        seen["fresh"] = stagetime.snapshot()
        stagetime.add(7.0, 7.0)
        seen["own"] = stagetime.snapshot()

    th = threading.Thread(target=other)
    th.start()
    th.join()
    assert seen == {"fresh": (0.0, 0.0), "own": (7.0, 7.0)}
    seconds, flops = stagetime.snapshot()
    assert 1.52 <= seconds < 2.5 and flops == 15.0
    assert stagetime.snapshot() == (seconds, flops), "reading keeps it"
    stagetime.reset()
    assert stagetime.snapshot() == (0.0, 0.0)


def test_detach_takes_the_ledger_along():
    stagetime.reset()
    stagetime.add(0.25, 3.0)
    led = stagetime.detach()
    assert stagetime.snapshot() == (0.0, 0.0)
    stagetime.add(1.0, 1.0)
    assert led.resolve() == (0.25, 3.0)
    assert stagetime.snapshot() == (1.0, 1.0)
    stagetime.reset()


def test_device_section_counts_after_an_exception():
    stagetime.reset()
    with pytest.raises(RuntimeError):
        with stagetime.device_section(torch.device("cpu"), flops=2.0):
            time.sleep(0.01)
            raise RuntimeError("injected")
    seconds, flops = stagetime.snapshot()
    assert seconds >= 0.01 and flops == 2.0
    stagetime.reset()


# -- the two PageResult fields ------------------------------------------------------

@pytest.fixture(scope="module")
def page_pair(bundles):
    jb, tb = bundles
    image = _page(0, 210, 170)
    want = jdetector.TextlineDetector(jb, CFG).process_image(image, "p.png")
    calls = []
    real = deskew._hat_projection_rows

    def spy(m, h, w, angle, bufH, bufW):
        calls.append((int(m.shape[0]), bufH, bufW))
        return real(m, h, w, angle, bufH, bufW)

    deskew._hat_projection_rows = spy
    try:
        got = detector.TextlineDetector(tb, CFG).process_image(image,
                                                               "p.png")
    finally:
        deskew._hat_projection_rows = real
    return want, got, calls


def _assert_timing_fields(got, want):
    assert set(got.device_timings) == set(want.device_timings) == {
        "page_extraction", "region_extraction", "textlines", "deskew",
        "total"}
    stages_sum = sum(v for k, v in got.device_timings.items()
                     if k != "total")
    assert got.device_timings["total"] == pytest.approx(stages_sum)
    assert 0.0 < got.device_timings["total"] <= got.timings["total"]
    for k in ("page_extraction", "region_extraction", "deskew"):
        assert 0.0 < got.device_timings[k] <= got.timings[k]
    assert got.device_timings["textlines"] == 0.0


def test_device_timings_keys_equal_jax_and_fit_in_the_total(page_pair):
    want, got, _ = page_pair
    assert len(want.contours) >= 3
    _assert_timing_fields(got, want)


def test_page_flops_equal_the_hand_count(bundles, page_pair):
    """One page-model forward, one dual-head forward per tile of the crop's
    grid, and two projection matmul pairs per deskew group: 2 * B * bufH *
    bufW * (bufH + bufW) each."""
    _, tb = bundles
    want, got, calls = page_pair
    pc = got.page_coord
    ny, nx = tb.region.grid_for(pc[1] - pc[0], pc[3] - pc[2],
                                CFG.tiling.margin_ratio)
    assert ny * nx >= 12 and calls
    hand = (tpu_unet_flops(64, 64, 3, PAGE_TINY.widths, PAGE_TINY.n_classes)
            + ny * nx * tpu_unet_flops(64, 64, 2, DUAL_TINY.widths,
                                       DUAL_TINY.n_classes)
            + sum(2 * b * bh * bw * (bh + bw) for b, bh, bw in calls))
    assert got.flops == pytest.approx(hand, rel=1e-9)
    # XLA's cost model counts the elementwise work too: the same order,
    # not the same number
    assert 0.5 < got.flops / want.flops < 1.0


@pytest.mark.parametrize("flags", [
    dict(device_phase_workers=1, page_box_batch=0), {},
    dict(pages_per_dispatch=2), dict(raw_upload=False),
    dict(resident_deskew=False)],
    ids=lambda f: "-".join(f"{k}{v}" for k, v in f.items()) or "default")
def test_batch_fills_both_fields_on_every_path(bundles, page_pair, flags):
    """Every path of the batch reports the same stage keys; the model
    forwards' FLOPs of a batch add up to those of its pages served alone
    (a window's or a group's shared cost is split evenly)."""
    _, tb = bundles
    want = page_pair[0]
    pages = [(_page(s, 210, 170), f"p{s}.png") for s in (0, 3, 5)]
    det = detector.TextlineDetector(tb, _cfg(**flags))
    got = list(det.process_batch(iter(pages)))
    single = [detector.TextlineDetector(tb, _cfg(**flags)).process_image(*p)
              for p in pages]
    for r in got:
        _assert_timing_fields(r, want)
        assert r.flops > 0
    assert sum(r.flops for r in got) == pytest.approx(
        sum(r.flops for r in single), rel=1e-9)


def test_degraded_page_has_empty_fields(bundles, monkeypatch):
    _, tb = bundles
    det = detector.TextlineDetector(tb, CFG)
    monkeypatch.setattr(tb.region, "upload_raw",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    monkeypatch.setattr(detector.stages, "scale_image",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    res = det.process_image(_page(0, 210, 170), "p.png")
    assert res.degraded and res.device_timings == {} and res.flops == 0.0


# -- profiling ------------------------------------------------------------------

def test_trace_writes_a_chrome_trace_and_none_is_a_noop(tmp_path):
    with profiling.trace(None):
        pass
    with profiling.trace(""):
        pass
    assert list(tmp_path.iterdir()) == []
    logdir = tmp_path / "prof"
    spans = []
    with profiling.trace(str(logdir)) as tr:
        with profiling.record_into(spans, "p.png"), \
                profiling.span("a_named_region"):
            torch.ones(8).sum()
        tr.extend(spans)
    files = glob.glob(str(logdir / "trace-*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    span, = [e for e in events if e.get("name") == "a_named_region"]
    assert span["cat"] == "program_span" and span["args"]["page"] == "p.png"
    # the span holds the profiler's record of the op it ran, on the
    # profiler's time base
    op, = [e for e in events if e.get("name") == "aten::ones"]
    assert span["ts"] <= op["ts"] <= op["ts"] + op["dur"] <= \
        span["ts"] + span["dur"]
    assert {"ph": "M", "name": "thread_name", "pid": "program spans",
            "tid": span["tid"], "args": {"name": "MainThread"}} in events


@pytest.fixture
def tiny_model_dir(tmp_path):
    names = DEFAULT_CONFIG.model_names
    for name, spec, seed in ((names.page, PAGE_TINY, 0),
                             (names.dualhead, DUAL_TINY, 1)):
        spec = dataclasses.replace(
            treg.ModelSpec.from_meta(spec.to_meta()), name=name)
        sd = checkpoint.random_init(spec, torch.Generator().manual_seed(seed))
        if spec.heads:
            sd["head.bias"][1] += 0.3
            sd["head.bias"][4] += 0.6
        checkpoint.save(str(tmp_path / f"{name}.npz"), spec, sd)
    return str(tmp_path)


def test_cli_timings_and_profile(tiny_model_dir, tmp_path, monkeypatch):
    """`--timings` prints every stage key of each page, its device seconds,
    FLOPs, tiles and fetches; `--profile DIR` leaves a trace file that
    holds both pages' spans; a directory runs as one batch."""
    monkeypatch.setattr(cli, "DEFAULT_CONFIG", _cfg(compute_dtype="float32"))
    pages = tmp_path / "pages"
    pages.mkdir()
    for seed in (0, 3):
        Image.fromarray(_page(seed, 210, 170)).save(pages / f"s{seed}.png")
    out = tmp_path / "out"
    out.mkdir()
    prof = tmp_path / "prof"
    res = CliRunner().invoke(cli.main, [
        "-i", str(pages), "-o", str(out), "-m", tiny_model_dir,
        "--device", "cpu", "--timings", "--profile", str(prof)])
    assert res.exit_code == 0, res.output
    assert (out / "s0.xml").exists() and (out / "s3.xml").exists()
    for key in ("page_extraction=", "region_extraction=", "deskew=",
                "line_split=", "reading_order=", "total=", "device: ",
                "flops=", "tiles=", "fetches=", "fetch_bytes="):
        assert res.output.count(key) >= 2, (key, res.output)
    assert "tiles=0 " not in res.output and "fetches=0 " not in res.output
    files = glob.glob(str(prof / "trace-*.json"))
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    phases = [e for e in events if e.get("name") == "host.phase"]
    assert sorted(e["args"]["page"] for e in phases) == [
        str(pages / "s0.png"), str(pages / "s3.png")]

    quiet = CliRunner().invoke(cli.main, [
        "-i", str(pages / "s0.png"), "-o", str(out), "-m", tiny_model_dir,
        "--device", "cpu"])
    assert quiet.exit_code == 0, quiet.output
    assert "deskew=" not in quiet.output
