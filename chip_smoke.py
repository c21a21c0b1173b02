#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py [--details PATH]

Phases (any failure raises and the script exits non-zero):
  1. print the card's name and power limit; require CUDA (no CPU fallback);
  2. build the Radon kernel (csrc/radon.cu, sm_90a) from the checkout, and
     the host geometry library (native/, as `pip install .` does), which
     must load: the pages are timed on the native host path;
  3. the kernel against its plain PyTorch version at the main path's
     shapes (8 and 2 regions x 110 angles at S = 512, 8 x 110 at S = 256)
     on binary canvases at ~20% fill and on text-like bands (rtol 1e-4,
     atol 1e-2), each shape launched REPRO_LAUNCHES times with bitwise
     equal outputs, and at the host sweep's shapes (8 x 80 and 8 x 30 angles
     at S = 512, 2 x 80 at S = 256) on canvases that
     DeskewEngine._canvas_into renders from a synthetic page's own
     paragraph crops; on the noise and the page crops the kernel, the
     plain version and the
     library's matrix form (two float32 torch.bmm per pair, A and B built
     in advance; timed only) are timed with CUDA events beside the bound
     (canvas and output bytes at 3.35 TB/s against 8 float32 operations
     per set pixel and angle, 3 more where its value is not 1, at 67
     TFLOP/s); the resident deskew chain on
     the card against the same chain on the CPU (plain version) on drawn
     text lines; the dual-head U-Net forward on the card against the CPU
     in float32; then in bf16, as users run it: every ConvGN's float32
     conv sum on the card against a float64 conv of the same bf16
     operands (within CONV_SUM_RTOL of the sum of |products|), the head's
     logits likewise, once as the forward runs them (TF32 off) and once
     with TF32 on, which must exceed the bound, and the card's bf16
     logits against the CPU's (BF16_LOGIT_MEAN, BF16_LOGIT_MAX,
     BF16_ARGMAX_AGREE), each ConvGN's GroupNorm output against the CPU's
     on the CPU block's input (BF16_GN_MAX_ABS, which the conv's sum
     rounded to bf16 first must exceed in every block), and the bf16
     forward's time as served and inside full_f32;
  4. (every serving run below uses DEFAULT_CONFIG with the deskew buffer
     cap lifted to SMOKE_BUF_MAX, see there; flags_phase also serves the
     reference's cap) a full-width random-weight bundle (the JAX package's
     seed-0 initial weights, ModelBundle.random_init; bf16 compute,
     float32 GroupNorm) runs process_batch over 3 synthetic A4 pages (3508x2480,
     skews 0, 8 and -15 degrees): no page may degrade, the Radon kernel
     must have launched, at least one region must carry a nonzero slope,
     and every PAGE-XML must parse; then the classic three-model bundle:
     three full-size ResNet50Unets (float32; random weights, the text
     classes' head biases recentred where random weights leave them
     lopsided) saved and loaded by ModelBundle.from_dir, their forwards
     timed and counted on a chunk of page tiles, the region model against
     the CPU (limit 1e-4 of the largest logit), and process_image on the
     same 3 pages, the last one tinted so that it goes up as RGB: each
     must reach the deskew chain with a region and Radon launches, and
     its ResNet forwards must have run with TF32 off (the runner's own
     switch: this script sets no global one); one page more with every
     fused call made to raise, which the separate per-model rung must
     serve with the same region mask and PAGE-XML;
 4a. the warm start (warm_phase): this script runs twice more, in fresh
     processes (`--warm-child cold` and `--warm-child warm`), each with
     the bundle and config of phase 4, serving its 3 pages by
     process_image one at a time; the warm child first calls
     TextlineDetector.warm_up(3508, 2480). Both must give phase 4's
     PAGE-XML page for page with no fallback and no degraded page, and
     warm_up must return the expected job keys and launch the Radon
     kernel. Printed: warm_up's seconds by job, each child's first,
     second and third page, cold against after warm_up. Then warm_up in
     this process under DEFAULT_CONFIG, without and with
     warm_fallback_programs, job by job;
  5. the fallback ladder on the full-width dual-head bundle and the skew
     +8 page (fallback_phase): the raw path against the canvas-resident
     and the crop-upload rung (raw_upload / resident_upload off; share of
     differing region-mask pixels at most LADDER_MASK_LIMIT), the host
     sweep (resident_deskew off: Radon launches must rise, slopes against
     the resident chain's within SWEEP_SLOPE_LIMIT degrees), one injected
     resident_collect failure (the page keeps its regions and lines, one
     host_sweep fallback counted), and textline_projection off (the same
     PAGE-XML, reading order included); no page may degrade, and no other
     phase may have counted a fallback;
  6. the Radon kernel against its plain version once more while a second
     thread runs segmentation forwards on the same stream, as the batch's
     workers do (REPRO_LAUNCHES launches bitwise equal to each other and
     to the launch made alone); then the runtime flags of the last paths
     the port took (flags_phase), on the 3 pages of phase 4 against
     the serving config: DEFAULT_CONFIG itself (a page with a region over
     its cap takes the host sweep once), device_page_box and
     fused_page_box (the device
     component box printed beside the host box; on the same box the
     region mask and row projection must equal the raw path's, and the
     fused box the headless one), spec_deskew (speculative and ordinary
     regions counted; slopes bit-equal to the default run's, profiles
     within SPEC_PROFILE_RTOL / _ATOL, and PAGE-XML equal but for the
     lines of regions whose crop buffer differed, printed), and
     deskew_buf_max one below the page's largest region side (at least
     one region over the cap, one host_sweep fallback a page, slopes
     within SWEEP_SLOPE_LIMIT); no page may degrade and no other fallback
     be counted; ops/cc on the card against the CPU on the page model's
     dilated labels and a page's region mask, timed with CUDA events;
  7. the pipelined batch on the same bundle (batch_phase): 8 A4 pages (skews 0, 8, -15 and repeats, one page
     2900 px high so that two tile grids occur) served (a) by
     process_image one after another, (b) by process_batch with one
     worker and no page-box window, (c) under DEFAULT_CONFIG (2 workers,
     windows of 8), also with 3 workers and with a CUDA stream per worker
     (the design the detector does not use: this script puts the workers'
     device phases on streams of their own to keep the comparison
     measured), and (d) with pages_per_dispatch=4; each after one warm-up
     page. Printed: pages per second, Radon launches, each page's
     device_timings, FLOPs and the FLOP/s they imply, and the card's idle
     share for (a) and (c) on the first 4 pages under torch.profiler
     (these servings too must equal (a)'s first). It fails if (b) or (c)
     differ from (a) in a page's PAGE-XML, other than through a page box
     that the batched page forward moved by at most one model-resolution
     pixel a side (printed); if (d) differs
     from (a) in more than BATCH_MASK_LIMIT of a page's region-mask
     pixels or in its region count; if a page degrades, a fallback is
     counted or results come out of order. A slower batch is written
     down, not failed;
 7a. the port's bench (bench_phase), at its full recipe and under
     DEFAULT_CONFIG itself (the reference's deskew cap of 2816):
     sbb_textline_detection_tpu_torch.bench trains the page model for
     BENCH_TRAIN_STEPS and the dual-head model for 6x as many steps on
     the card from nothing, serves BENCH_PAGES hard_mix pages at
     3508x2480 (warm_up, a warm pass, the timed process_batch) and scores
     them; each role's Trainer starts from registry.init_variables(spec,
     0), the JAX package's seed-0 weights, whose SHA-256 must equal
     INIT_SHA256 (the CPU's draw: tests/test_torch_training.py); its JSON
     line is printed, with the quality gates beside the
     JAX package's TPU figures (BENCH_r05.json), the host_sweep count and
     the largest region against the cap. It fails on fewer results than
     pages or results out of order, a degraded page, a fallback other
     than host_sweep, a PAGE-XML that does not parse or a quality value
     that is not finite (the gates are not enforced here). One bench page
     more runs under torch.profiler (the card's idle share on a trained
     page; the Radon kernel held against its plain version on that page's
     canvases, their share of set pixels). Page BENCH_SPECK_PAGE's region
     count and precision are printed on a line of their own. With
     --details, the two
     checkpoints are packed beside the details file
     (models/checkpoint.pack_dir) for scripts/trained_parity.py's
     comparison with the JAX package on the CPU;
  8. training, on the dual-head model at full width (DUALHEAD_SPEC: widths
     (32, 64, 128, 256), 448x448, 2 input channels, heads (3, 2)):
     (a) one float32 AdamW step (TF32 off) from the same random_init
     weights on one seeded dualhead_batch of 2, on the card and on the
     CPU: losses, gradients and updated params are compared; (b) the
     Trainer (bf16 convs, batch 8) for TRAIN_STEPS steps on pre-drawn
     batches, timed with CUDA events after a warm-up, beside the host's
     data ms per batch, a few steps with the data drawn in the loop, and
     the peak device memory: the loss must fall; (c) the bench
     checkpoints of phase 7a, loaded by ModelBundle.from_dir, serve one
     A4 page, which must not degrade or fall back;
  9. the OCR-D processor (ocrd_phase), through the stub OCR-D framework
     of tests/ocrd_stub.py, on two A4 pages (one as scanned, one the crop
     at OCRD_CROP of a larger scan, whose page transform is a
     translation), with the full-width random-weight bundle saved as .npz
     and loaded through its `model` parameter: each merged PAGE-XML must
     have one Border, a ReadingOrder whose refs are the kept regions' ids
     and the processing-step item, every line within its region and every
     region within the Border; the cropped page's coordinates must be the
     detector's own moved by the offset; no page may degrade, and the
     Radon kernel must launch on each; seconds per page and in the merge
     are printed;
 10. the meshes (mesh_phase): (a) a serving mesh of max(2, cards) data
     members (two on the one card) serves the 3 pages of phase 4 through
     process_batch under mesh_auto_group, against the unmeshed bundle in
     groups of the same size: the group size must equal the data axis, no
     page may degrade or fall back, and in float32 (TF32 off) the region
     masks and PAGE-XML must be equal; in bf16 the share of differing
     region-mask pixels is printed, with pages/s of both runs; (b) one
     sharded AdamW step of the full-width dual-head model (float32, TF32
     off, batch 8, cuDNN's deterministic algorithms) in a world-size-1
     NCCL group on a (1, 1) mesh must equal the plain step to
     MESH_TRAIN_RTOL; with two or more cards, `parallel.dryrun --devices 2
     --backend nccl` runs too;
 11. the A/B harness (ab_phase, sbb_textline_detection_tpu_torch/ab.py) on
     the bench checkpoints of phase 7a and its 8 hard_mix pages: the spec
     study's and the paths study's output checks (slopes must be
     bit-equal between spec_deskew on and off; per page and arm, slopes
     and PAGE-XML equal or not and the share of region-mask pixels that
     moved are printed), then one paired round of the workers study with
     only the serial arm (process_image in turn) and the default arm
     (process_batch under DEFAULT_CONFIG); no arm may degrade a page or
     fall back, every PAGE-XML must parse, and the phase's seconds are
     printed.
The line before the last is {"kernels": [...]}; the last line is {"ok": true,
"device": {...}}. The kernel line's launches add up phases 4, 4a (its
children's too), 5, 6 (the flags), 7 (a)-(d), 7a (warm_up and both passes), 8
(c), 9, 10 and 11. With --only batch, phases 4 (classic bundle), 4a, 5, 7a, 8,
9, 10 and 11 are left out (a shorter run while working on the batch); with
--only bench, phase 3's kernel check, 7a and 11 alone run (the default runs
everything).
With --details PATH, the run's details (ptxas report, per-page stage
timings, kernel times) are written there as JSON. After the timed pages, the
second page runs once more under torch.profiler for its device time by op and
the Radon kernel's device time (its launches are not counted in the kernel
line); a spy keeps the inputs of that page's sweeps, on which the kernel is
held against its plain version, and the kernel, the plain version, the library
form and the bound are summed.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
SKEWS = (0.0, 8.0, -15.0)
TRAIN_STEPS = 150     # timed dual-head steps (b), warm-up included
TRAIN_WARMUP = 5
STREAM_STEPS = 10     # steps with the data drawn in the loop
PROFILE_STEPS = 5     # more such steps under torch.profiler
# (a) card vs CPU tolerances of one float32 AdamW step, set from the
# first run on an H100 (loss rel 6.5e-8, gradients 2.1e-4 of the largest,
# params 4.4e-7) with room to spare. Adam's first update is
# lr * g / (|g| + 1e-8): an element whose gradient lies within the two
# devices' f32 noise of zero may step differently (up to 2 * lr), so the
# params are held to PARAM_ATOL where the CPU gradient is at least
# GRAD_FLOOR, and the gradients to GRAD_RTOL of their largest.
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-3
GRAD_FLOOR = 1e-6
PARAM_ATOL = 1e-5
# the classic bundle: (role, classes) of its three ResNet50Unets; the card
# vs CPU limit of the region model's f32 logits (max |err| over the
# largest |logit|) on CLASSIC_PARITY_TILES page tiles; the textline
# model's (low, high, target) class-1 share, recentred to the target when
# random weights leave it outside (low, high); the region model's class-1
# share is kept when it lies in CLASSIC_REGION_SHARE and every page has a
# text region, else CLASSIC_REGION_SHARES are tried in turn until they do
CLASSIC_CLASSES = (("page", 2), ("region", 3), ("textline", 2))
CLASSIC_TILE = 448
CLASSIC_PARITY_TILES = 4
CLASSIC_PARITY_RTOL = 1e-4
CLASSIC_TEXTLINE_SHARE = (0.05, 0.5, 0.25)
CLASSIC_REGION_SHARE = (0.2, 0.8)
CLASSIC_REGION_SHARES = (0.5, 0.7, 0.85, 0.95)


# fallback_phase: the largest share of region-mask pixels by which a rung
# of the standard path may differ from the raw path (the rungs feed the
# same tile batches to the same modules, and the JAX package claims
# bit-identity; the room is for a cuDNN algorithm that differs between two
# calls), and the largest difference in degrees between a region's slope
# from the host sweep and from the resident chain (one step of the coarse
# grid, 50 / 79: both routes score the same canvases at the same angles,
# and a near-tie may go to the neighbouring angle)
LADDER_MASK_LIMIT = 1e-3
SWEEP_SLOPE_LIMIT = 50.0 / 79.0 + 1e-6
# The deskew buffer cap of the script's serving runs (_serve_config):
# above the working page (4209 x 2975 pixels), so that every region a
# random draw makes runs the resident chain. The JAX package's seed-0
# weights (ModelBundle.random_init) give the three smoke pages 306-608
# regions, the largest 271 working pixels a side, all under the
# reference's cap of 2816 (RuntimeConfig.deskew_buf_max); a torch
# generator's draw of the same distribution made the whole page crop one
# region (4209 x 2927) beside hundreds of small ones, which the
# reference's cap sends to the host sweep. flags_phase serves the pages
# under the reference's cap and under one below each page's largest
# region.
SMOKE_BUF_MAX = 8192
# launches of the Radon kernel on the same inputs that must come out
# bitwise equal (its cross-block sums are integer atomics)
REPRO_LAUNCHES = 20
# flags_phase: the speculative slots' profiles against the ordinary
# chain's (a slot's crop buffer is spec_buffer_shape, an ordinary group's
# its largest crop, so the hat's offset K = bufW // 2 rounds them apart)
SPEC_PROFILE_RTOL, SPEC_PROFILE_ATOL = 1e-4, 1e-2
# side of the region-mask square on which ops/cc is held against the CPU
CC_CHECK_SIDE = 1024

# batch_phase: (height, skew) of its 8 A4-wide pages (the sixth is shorter,
# so that its crop lands on another tile grid than the others'); the
# largest share of a page's region-mask pixels by which the grouped
# dispatch (other tile chunks, so cuDNN may pick other algorithms and a
# bf16 argmax tie may flip) may differ from process_image; the pages that
# the profiled runs serve; the H100's dense bf16 peak (NVIDIA's data
# sheet, SXM part at 700 W), against which the FLOP/s of the bf16 bundle
# are stated
BATCH_PAGES = ((3508, 0.0), (3508, 8.0), (3508, -15.0), (3508, 0.0),
               (3508, 8.0), (2900, -15.0), (3508, 0.0), (3508, 8.0))
BATCH_MASK_LIMIT = 1e-3
BATCH_PROFILED_PAGES = 4
BF16_OPS_S = 989e12
# profile_phase: words in the names of the device kernels summed as
# convolutions (cuDNN's implicit-GEMM `fprop` kernels, its `convolve` and
# `conv2d` engines; not its `convert` kernels) and as copies, matched in
# lower case
CONV_KERNELS = ("convol", "conv2d", "fprop")
COPY_KERNELS = ("copy",)
# unet_phase's bf16 part (_unet_bf16), on DUALHEAD_SPEC at 448 x 448
# (random weights from SEED): the largest error of a conv sum on the card
# against float64 over the sum of |products| (a float32 sum of exact bf16
# products; measured 1.7e-6 at most over the 28 ConvGN, the head 3.6e-7,
# and 3.2e-4 with TF32, whose operands round at 2^-11), and the card's
# bf16 logits against the CPU's: mean and max |err| and each head's argmax
# agreement (measured 0.0100, 0.119, and 0.9899 / 0.9933; NVIDIA H100 80GB
# HBM3 at 700 W, PERF.md section 6), with about 2x room
CONV_SUM_RTOL = 1e-5
BF16_LOGIT_MEAN = 0.02
BF16_LOGIT_MAX = 0.25
BF16_ARGMAX_AGREE = 0.98
# and each ConvGN's float32 GroupNorm output, card against CPU, each block
# fed the CPU block's input: measured 2.9e-4 at most (ConvGN_11; 7e-6 at
# the stem), and 1.28e-2 to 2.73e-2 by block with the conv's sum rounded
# to bf16 before GroupNorm (same card, PERF.md section 6)
BF16_GN_MAX_ABS = 1e-3
# the bf16 forward timed as served and inside full_f32, on this many tiles
BF16_TIMED_TILES = 16
# ocrd_phase: (y, x) offset of the second page's crop in its larger scan
OCRD_CROP = (120, 90)
# mesh_phase: the limit of the (1, 1) training mesh against the plain
# step (relative, of the loss and of every parameter)
MESH_TRAIN_RTOL = 1e-6
# warm_phase: the page size warm_up is asked for (the smoke pages'), and
# the seconds a child process may take
WARM_HW = (3508, 2480)
WARM_CHILD_TIMEOUT = 420
# bench_phase: the port's bench (sbb_textline_detection_tpu_torch/bench.py)
# at its full recipe: page-model steps (the dual-head model trains 6x as
# many), timed pages (at WARM_HW), the page profiled afterwards (hard_mix
# page 1: 18 degree skew with figures); the reference's quality gates
# (VERDICT r5, PERF.md section 1), printed and not enforced here; the
# JAX package's figures on them from BENCH_r05.json, a TPU run; and the
# most bytes the packed checkpoints may take beside --details (what a
# card run brings back is limited)
BENCH_TRAIN_STEPS = 300
BENCH_PAGES = 8
BENCH_PROFILED_PAGE = 1
BENCH_GATES = (("region_recall", ">=", 1.0),
               ("region_precision", ">=", 0.97),
               ("line_count_mae", "<=", 0.1))
BENCH_R05_TPU = {"region_recall": 1.0, "region_precision": 0.983,
                 "line_count_mae": 0.025, "line_recall": 0.997,
                 "line_recall_vertical": 0.975}
BENCH_PACK_MAX = 63 * 2 ** 20
# the hard_mix page (clean, 3 figures/rules) whose region count and
# precision are printed on their own: where bf16 on the card made a false
# speck region while the conv's sum was rounded to bf16 before GroupNorm
# (ROADMAP Queue 3)
BENCH_SPECK_PAGE = 6
# SHA-256 (checkpoint.state_sha256) of the initial state that the bench's
# Trainer of each role draws for seed 0 (registry.init_variables: the JAX
# package's seed-0 weights); tests/test_torch_training.py holds the CPU's
# draw to the same constants
INIT_SHA256 = {
    "model_page_mixed_best":
        "fb30d901e431d597c62c0cc0430a47be47ef120a0ee2e61f0aee5266b5efd606",
    "model_dualhead":
        "fa9787c6ae4c028e0046b11e2ca9406ba046c7a359b088e8bddbd3621629c656",
}


def _serve_config(**flags):
    """DEFAULT_CONFIG with the cap SMOKE_BUF_MAX and `flags` on its
    RuntimeConfig."""
    import dataclasses

    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG

    return dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
        DEFAULT_CONFIG.runtime, **{"deskew_buf_max": SMOKE_BUF_MAX,
                                   **flags}))


def build_native(details):
    """`make -C native`: the C++ host geometry library that the host phase
    loads. Without it the pages would run the numpy fallbacks, a different
    host path, so a failed build or load fails the run."""
    from sbb_textline_detection_tpu_torch.utils import host_library_available

    t0 = time.time()
    proc = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                          capture_output=True, text=True, timeout=600)
    details["native_build"] = {"seconds": time.time() - t0,
                               "log": (proc.stdout + proc.stderr)[-2000:]}
    if proc.returncode != 0:
        raise RuntimeError("make -C native failed:\n"
                           + details["native_build"]["log"])
    if not host_library_available():
        raise RuntimeError("the host geometry library was built but does "
                           "not load")
    print(f"host geometry library built in {time.time() - t0:.1f} s",
          flush=True)


# peak rates of one H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s
# and float32 operations/s outside the tensor cores
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
# f32 operations per set (pixel, angle) pair of the Radon sweep: 4 weight
# products, 1 add, 3 accumulates; a pixel whose value is not 1 adds 3
# value products (the main path's canvases are 0/1, and the kernel skips
# the products for a 1)
RADON_OPS_PER_PAIR = 8
RADON_OPS_PER_VALUE = 3


def _radon_bound(canv, n_angles):
    """Least time (ms) for the sweep on these inputs, and its binding side:
    each canvas byte read once, each output float written once, against
    the f32 operations that this run's set pixels need at every angle."""
    r, s = int(canv.shape[0]), int(canv.shape[1])
    nbytes = r * s * s + 4 * n_angles + 4 * r * n_angles * s
    ops = n_angles * (RADON_OPS_PER_PAIR * int((canv != 0).sum())
                      + RADON_OPS_PER_VALUE * int((canv > 1).sum()))
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_S, 1e3 * ops / F32_OPS_S
    return max(by_bytes, by_ops), ("bytes" if by_bytes > by_ops
                                   else "operations")


def _radon_library_ms(canv, cosv, sinv):
    """The matrix form as the library computes it: two float32 torch.bmm
    per pair (TF32 off), with A, B and the canvases built in advance."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import precision, radon_bench

    r, s = int(canv.shape[0]), int(canv.shape[1])
    n = int(cosv.shape[0])
    ridx = torch.arange(r, device=canv.device).repeat_interleave(n)
    aidx = torch.arange(n, device=canv.device).repeat(r)
    c = float(s // 2)
    idx = torch.arange(s, dtype=torch.float32, device=canv.device)
    fy = cosv[aidx][:, None] * (idx - c) + c
    gx = -sinv[aidx][:, None] * (idx - c) + c
    A = (1.0 - (idx[None, :, None] - fy[:, None, :]).abs()).clamp(min=0.0)
    Bt = (1.0 - (idx[None, :, None] - gx[:, None, :]).abs()).clamp(
        min=0.0).transpose(1, 2).contiguous()
    img = canv[ridx].to(torch.float32)
    with precision.full_f32():
        ms = radon_bench.cuda_time(lambda: torch.bmm(torch.bmm(A, img), Bt),
                                   3)
    del A, Bt, img
    torch.cuda.empty_cache()
    return ms


def kernel_phase(dev, details):
    """The kernel against its plain version at the main path's shapes
    (8 and 2 regions x 110 angles at S = 512, 8 x 110 at S = 256) on 20 %
    noise and on text-like bands (rtol 1e-4, atol 1e-2); on the noise, the
    kernel, the plain version and the library's matrix form timed with
    CUDA events, beside the bound. The first shape is the kernel's line."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    angles = torch.from_numpy(radon_bench.sweep_angles()).to(dev)
    cosv, sinv = radon.angle_cos_sin(angles)
    n_angles = int(angles.shape[0])
    rows = []
    for r, s in radon_bench.SHAPES:
        for kind, canv in (("noise", radon_bench.noise(SEED, r, s)),
                           ("lines", radon_bench.text_bands(SEED + 5, r, s))):
            canv = torch.from_numpy(canv).to(dev)
            got = radon.radon_pairs(canv, angles)
            want = radon.radon_pairs_plain(canv, cosv, sinv)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
            _reproducible(got, lambda: radon.radon_pairs(canv, angles),
                          f"{r} x {n_angles} at S={s} on {kind}")
            bound_ms, bound_by = _radon_bound(canv, n_angles)
            row = {"regions": r, "s": s, "pairs": r * n_angles,
                   "canvas": kind, "set_pixels": int((canv != 0).sum()),
                   "bitwise_equal_launches": REPRO_LAUNCHES,
                   "max_abs_err": err, "bound_ms": bound_ms,
                   "bound_by": bound_by,
                   "ms": radon_bench.cuda_time(
                       lambda: radon.radon_pairs(canv, angles), 50)}
            if kind == "noise":
                row["plain_ms"] = radon_bench.cuda_time(
                    lambda: radon.radon_pairs_plain(canv, cosv, sinv), 3)
                row["library_ms"] = _radon_library_ms(canv, cosv, sinv)
            rows.append(row)
            print(f"radon kernel, {row['pairs']} pairs at S={s} on {kind}: "
                  f"{row['ms']:.4f} ms"
                  + (f", plain {row['plain_ms']:.3f} ms, library (2 f32 "
                     f"bmm) {row['library_ms']:.3f} ms" if kind == "noise"
                     else "")
                  + f", bound {bound_ms:.3g} ms by {bound_by}, max |err| "
                  f"{err:.3g} (rtol 1e-4, atol 1e-2)", flush=True)
    rows += _host_sweep_rows(dev)
    details["radon"] = rows
    return rows[0]


def _reproducible(first, launch, what):
    """Fail unless REPRO_LAUNCHES - 1 more launches equal `first` bit for
    bit."""
    import torch

    outs = [launch() for _ in range(REPRO_LAUNCHES - 1)]
    torch.cuda.synchronize()
    differ = sum(not torch.equal(o, first) for o in outs)
    if differ:
        raise AssertionError(f"radon kernel, {what}: {differ} of "
                             f"{REPRO_LAUNCHES - 1} launches differ from the "
                             "first")


def _host_sweep_cases(dev):
    """(name, canvases, angles) at the host sweep's shapes: the coarse (80)
    and the vertical (30) angles apart, on canvases that
    DeskewEngine._canvas_into renders from the paragraph crops of the
    skew +8 page's dark-pixel mask."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.pipeline import deskew
    from sbb_textline_detection_tpu_torch.utils import synthetic

    img, layout = synthetic.make_page(np.random.default_rng(SEED + 1), 3508,
                                      2480, skew_deg=SKEWS[1])
    mask = (img[..., 0] < 128).astype(np.uint8)
    crops = [mask[y0:y1, x0:x1] for x0, y0, x1, y1 in layout.paragraphs]
    crops = [c for c in crops if c.any()]
    if not crops:
        raise AssertionError("the synthetic page has no paragraph crop")
    eng = deskew.DeskewEngine(deskew.DeskewConfig(), device=dev)
    cases = []
    for r, s, name in ((8, 512, "_coarse"), (8, 512, "_vertical"),
                       (2, 256, "_coarse")):
        buf = np.zeros((r, s, s), np.uint8)
        for i in range(r):
            eng._canvas_into(crops[i % len(crops)], buf[i])
        cases.append(("page crops, host sweep " + name[1:],
                      torch.from_numpy(buf).to(dev),
                      torch.from_numpy(getattr(eng, name)).to(dev)))
    return cases


def _host_sweep_rows(dev):
    """The kernel against its plain version at the host sweep's shapes
    (_host_sweep_cases)."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    rows = []
    for name, canv, angles in _host_sweep_cases(dev):
        r, s = int(canv.shape[0]), int(canv.shape[1])
        cosv, sinv = radon.angle_cos_sin(angles)
        got = radon.radon_pairs(canv, angles)
        want = radon.radon_pairs_plain(canv, cosv, sinv)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
        n_angles = int(angles.shape[0])
        bound_ms, bound_by = _radon_bound(canv, n_angles)
        row = {"regions": r, "s": s, "pairs": r * n_angles,
               "canvas": name,
               "set_pixels": int((canv != 0).sum()), "max_abs_err": err,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "ms": radon_bench.cuda_time(
                   lambda: radon.radon_pairs(canv, angles), 50),
               "plain_ms": radon_bench.cuda_time(
                   lambda: radon.radon_pairs_plain(canv, cosv, sinv), 3),
               "library_ms": _radon_library_ms(canv, cosv, sinv)}
        rows.append(row)
        print(f"radon kernel, {r} x {n_angles} pairs at S={s} on "
              f"{row['canvas']}: {row['ms']:.4f} ms, plain "
              f"{row['plain_ms']:.3f} ms, library (2 f32 bmm) "
              f"{row['library_ms']:.3f} ms, bound {bound_ms:.3g} "
              f"ms by {bound_by}, {row['set_pixels']} set pixels, max |err| "
              f"{err:.3g} (rtol 1e-4, atol 1e-2)", flush=True)
    return rows


def deskew_phase(dev, details):
    """The resident chain on the card (kernel) vs on the CPU (plain)."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.pipeline import deskew

    mask = np.zeros((700, 1400), np.uint8)
    boxes = []
    for i, deg in enumerate((0.0, 4.0, -9.0, 17.0)):
        x, y, w, h = 20 + 340 * i, 30, 320, 600
        t = np.tan(np.deg2rad(deg))
        xs = np.arange(w)
        for y0 in range(20, h - 40, 44):
            for k in range(24):
                ys = np.round(y0 + k + t * (xs - w / 2)).astype(int)
                ok = (ys >= 0) & (ys < h)
                mask[y + ys[ok], x + xs[ok]] = 1
        boxes.append((x, y, w, h))
    eng = deskew.DeskewEngine(deskew.DeskewConfig(), max_canvas=512)
    cpu = eng.resident_collect(eng.resident_dispatch(
        torch.from_numpy(mask), boxes))
    gpu = eng.resident_collect(eng.resident_dispatch(
        torch.from_numpy(mask).to(dev), boxes))
    if cpu[0] != gpu[0]:
        raise AssertionError(f"slopes differ: cpu {cpu[0]} gpu {gpu[0]}")
    for (a0, a1), (b0, b1) in zip(cpu[1], gpu[1]):
        np.testing.assert_allclose(b0, a0, rtol=1e-4, atol=1e-2)
        np.testing.assert_allclose(b1, a1, rtol=1e-4, atol=1e-2)
    details["deskew_check_slopes"] = gpu[0]
    print(f"resident deskew chain card == cpu: slopes {gpu[0]}", flush=True)


def unet_phase(dev, details):
    """Dual-head forward on the card vs the CPU, float32, TF32 off; then
    the bf16 forward (_unet_bf16)."""
    import torch

    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.ops import precision

    spec = registry.DUALHEAD_SPEC
    sd = checkpoint.random_init(spec, torch.Generator().manual_seed(SEED))
    x = torch.rand((2, 448, 448, 2), generator=torch.Generator()
                   .manual_seed(SEED + 1))
    outs = []
    for d in ("cpu", dev):
        m = registry.build_module(spec, torch.float32)
        m.load_state_dict(sd)
        with torch.no_grad(), precision.full_f32():
            outs.append(m.to(d).eval()(x.to(d)).cpu())
    err = float((outs[0] - outs[1]).abs().max())
    details["unet_f32_max_abs_err"] = err
    torch.testing.assert_close(outs[1], outs[0], rtol=1e-3, atol=1e-3)
    print(f"dual-head forward card == cpu (f32): max |err| {err:.3g}",
          flush=True)
    _unet_bf16(dev, details, spec, sd, x)


def _sum_error(got, xp, w, stride, bias=None):
    """The largest |got - exact| over the sum of |products| of a conv of
    `xp` with `w` (float64 on the card; the |bias| adds to the sum). An
    output whose products are all 0 must be exactly 0, or the ratio is
    huge."""
    import torch.nn.functional as F

    x64, w64 = xp.double(), w.double()
    b64 = None if bias is None else bias.double()
    exact = F.conv2d(x64, w64, b64, stride=stride)
    mag = F.conv2d(x64.abs(), w64.abs(), None if b64 is None
                   else b64.abs(), stride=stride)
    return float(((got.double() - exact).abs() / mag.clamp_min(1e-300))
                 .max())


def _unet_bf16(dev, details, spec, sd, x):
    """The bf16 forward that users run, on the same weights and input, as
    runner._logits serves it: (a) every ConvGN's float32 conv sum on the
    card (ConvGN.conv_sum, on the block's own input, recorded by
    unet.trace_blocks) against a float64 conv of the same bf16 operands,
    within CONV_SUM_RTOL of the sum of |products|, on cuDNN's TF32
    kernels (its default) and on its float32 ones; the head's logits
    likewise against float64 on the refine block's output, once as the
    forward ran them (no TF32) and once more with cuDNN's TF32 switched
    on for that call alone, which must exceed the bound (the witness
    that the check sees a 10-bit rounding); (b) the card's logits
    against the CPU's bf16 forward: mean and max |err| within
    BF16_LOGIT_MEAN and BF16_LOGIT_MAX, and each head's argmax agreement
    at least BF16_ARGMAX_AGREE; (c) each ConvGN's float32 GroupNorm
    output on the card against the CPU's, each card block fed the CPU
    block's own input (trace_blocks carrying the CPU's outputs), within
    BF16_GN_MAX_ABS; the same blocks with the conv's sum rounded to bf16
    before GroupNorm (the port's arithmetic before the repair) must exceed
    it in every block (the witness that the check sees that rounding). The
    forward of BF16_TIMED_TILES tiles is timed as served (cuDNN's switch
    as it is) and inside precision.full_f32, as a bundle that also holds
    a float32 model serves it."""
    import torch
    import torch.nn.functional as F

    from sbb_textline_detection_tpu_torch.models import registry, unet
    from sbb_textline_detection_tpu_torch.ops import precision, radon_bench

    logits = []
    for d in ("cpu", dev):
        m = registry.build_module(spec, torch.bfloat16)
        m.load_state_dict(sd)
        m = m.to(d).eval()
        with torch.no_grad():
            if not logits:
                out, cpu_rec = unet.trace_blocks(m, x.permute(0, 3, 1, 2))
                logits.append(out)
                continue
            # as runner._logits serves a bf16 model: TF32 as it is
            out, rec = unet.trace_blocks(m, x.to(d).permute(0, 3, 1, 2))
            logits.append(out.cpu())
            gn_err, gn_err_rounded = _gn_errors(m, x.to(d), cpu_rec)
            tiles = x.to(d).permute(0, 3, 1, 2).repeat(
                BF16_TIMED_TILES // x.shape[0], 1, 1, 1)
            fwd_ms = radon_bench.cuda_time(lambda: m.forward_nchw(tiles), 5)
            with precision.full_f32():
                fwd_ms_f32 = radon_bench.cuda_time(
                    lambda: m.forward_nchw(tiles), 5)
            worst, worst_tf32 = {}, {}
            for name, (inp, _, _) in rec.items():
                block = m.get_submodule(name)
                xp = block.pad(inp)
                w = block.conv.weight.to(torch.bfloat16)
                # cuDNN's TF32 kernels (its default), as served and trained
                worst_tf32[name] = _sum_error(block.conv_sum(xp), xp, w,
                                              block.stride)
                # its float32 kernels, as beside a float32 model
                with precision.full_f32():
                    worst[name] = _sum_error(block.conv_sum(xp), xp, w,
                                             block.stride)
            head_in = rec["refine"][2].to(torch.float32)
            head = m.head
            head_err = _sum_error(out, head_in, head.weight, 1, head.bias)
            saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                tf32 = F.conv2d(head_in, head.weight, head.bias)
            finally:
                torch.backends.cudnn.allow_tf32 = saved
            tf32_err = _sum_error(tf32, head_in, head.weight, 1, head.bias)
    a, b = logits
    diff = (a - b).abs()
    agree, off = [], 0
    for width in spec.heads:
        agree.append(float((a[:, off:off + width].argmax(1)
                            == b[:, off:off + width].argmax(1))
                           .float().mean()))
        off += width
    row = {"conv_sum_rel_err": worst, "conv_sum_rel_err_max":
           max(worst.values()), "conv_sum_rel_err_tf32": worst_tf32,
           "conv_sum_rel_err_tf32_max": max(worst_tf32.values()),
           "head_rel_err": head_err,
           "head_rel_err_tf32": tf32_err, "logits_mean_abs_err":
           float(diff.mean()), "logits_max_abs_err": float(diff.max()),
           "argmax_agree": agree, "gn_max_abs_err": gn_err,
           "gn_max_abs_err_max": max(gn_err.values()),
           "gn_max_abs_err_conv_rounded": gn_err_rounded,
           "forward_ms": fwd_ms, "forward_ms_full_f32": fwd_ms_f32,
           "timed_tiles": int(tiles.shape[0]), "limits": {
               "conv_sum_rtol": CONV_SUM_RTOL,
               "logit_mean": BF16_LOGIT_MEAN, "logit_max": BF16_LOGIT_MAX,
               "argmax_agree": BF16_ARGMAX_AGREE,
               "gn_max_abs": BF16_GN_MAX_ABS}}
    details["unet_bf16"] = row
    print(f"bf16 dual-head forward: conv sums vs float64 of the bf16 "
          f"operands, float32 kernels: max rel "
          f"{row['conv_sum_rel_err_max']:.3g} over "
          f"{len(worst)} ConvGN (limit {CONV_SUM_RTOL:g}; worst "
          f"{max(worst, key=worst.get)}), on cuDNN's TF32 kernels "
          f"{row['conv_sum_rel_err_tf32_max']:.3g}; head {head_err:.3g}, "
          f"with TF32 "
          f"{tf32_err:.3g}; card vs cpu logits mean |err| "
          f"{row['logits_mean_abs_err']:.4g} (limit {BF16_LOGIT_MEAN:g}), "
          f"max {row['logits_max_abs_err']:.4g} (limit {BF16_LOGIT_MAX:g}),"
          f" argmax agreement by head {[round(v, 6) for v in agree]} "
          f"(limit {BF16_ARGMAX_AGREE:g})", flush=True)
    print(f"bf16 GroupNorm outputs card vs cpu, each block fed the cpu's "
          f"input: max |err| {row['gn_max_abs_err_max']:.3g} (limit "
          f"{BF16_GN_MAX_ABS:g}; worst {max(gn_err, key=gn_err.get)}); with "
          f"the conv's sum rounded to bf16 first: "
          f"{min(gn_err_rounded.values()):.3g} to "
          f"{max(gn_err_rounded.values()):.3g}", flush=True)
    print(f"bf16 dual-head forward of {row['timed_tiles']} tiles: "
          f"{fwd_ms:.3f} ms as served, {fwd_ms_f32:.3f} ms inside full_f32 "
          f"(a bundle that also holds a float32 model)", flush=True)
    bad = [n for n in worst if not max(worst[n], worst_tf32[n])
           <= CONV_SUM_RTOL]
    if bad:
        raise AssertionError(f"conv sums beyond {CONV_SUM_RTOL:g} of "
                             f"float64: {bad}")
    if not head_err <= CONV_SUM_RTOL:
        raise AssertionError(f"the head is not full float32 on the card: "
                             f"{head_err:.3g}")
    if not tf32_err > CONV_SUM_RTOL:
        raise AssertionError(f"the TF32 head stays within {CONV_SUM_RTOL:g}"
                             f" ({tf32_err:.3g}): the check cannot see TF32")
    if not (row["logits_mean_abs_err"] <= BF16_LOGIT_MEAN
            and row["logits_max_abs_err"] <= BF16_LOGIT_MAX
            and min(agree) >= BF16_ARGMAX_AGREE):
        raise AssertionError("the card's bf16 forward differs from the "
                             "CPU's beyond the limits")
    bad = [n for n, e in gn_err.items() if not e <= BF16_GN_MAX_ABS]
    if bad:
        raise AssertionError(f"GroupNorm outputs beyond {BF16_GN_MAX_ABS:g}"
                             f" of the CPU's: {bad}")
    blind = [n for n, e in gn_err_rounded.items()
             if not e > BF16_GN_MAX_ABS]
    if blind:
        raise AssertionError("rounding the conv's sum to bf16 before "
                             f"GroupNorm stays within {BF16_GN_MAX_ABS:g} "
                             f"in {blind}: the check cannot see it there")


def _gn_errors(m, x, cpu_rec):
    """({block: max |GroupNorm output - the CPU's|}, the same with the
    conv's sum rounded to bf16 before GroupNorm) of the card's bf16 model
    `m`, each block fed the CPU block's own input."""
    import torch

    from sbb_textline_detection_tpu_torch.models import unet

    carry = {name: out for name, (_, _, out) in cpu_rec.items()}
    _, rec = unet.trace_blocks(m, x.permute(0, 3, 1, 2), carry)
    err, rounded = {}, {}
    for name, (inp, gn, _) in rec.items():
        want = cpu_rec[name][1].to(gn.device)
        err[name] = float((gn - want).abs().max())
        block = m.get_submodule(name)
        r = block.conv_sum(block.pad(inp)).to(torch.bfloat16).float()
        rounded[name] = float((unet.group_norm(r, r, block.norm) - want)
                              .abs().max())
    return err, rounded


def _smoke_pages():
    """The serving smoke's 3 synthetic A4 pages (SKEWS), as (image, name)."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.utils import synthetic

    pages = []
    for i, skew in enumerate(SKEWS):
        img, _ = synthetic.make_page(np.random.default_rng(SEED + i),
                                     3508, 2480, skew_deg=skew)
        pages.append((img, f"a4_skew{skew:+.0f}.png"))
    return pages


def _serving_bundle(dev):
    """The serving smoke's bundle: the page and dual-head TpuUnet at
    FLAGSHIP widths, random weights from SEED."""
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle

    return ModelBundle.random_init(DEFAULT_CONFIG.runtime, seed=SEED,
                                   device=dev, dual_head=True)


def pipeline_phase(dev, details):
    """process_batch over 3 full-width A4 pages through the kernel.
    Returns (Radon launches, the detector, the pages, their results)."""
    import xml.etree.ElementTree as ET

    import torch

    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    det = TextlineDetector(_serving_bundle(dev), _serve_config())
    pages = _smoke_pages()

    radon.launches = 0
    secs, results = [], []
    t0 = time.time()
    for res in det.process_batch(pages):
        torch.cuda.synchronize()
        t1 = time.time()
        secs.append(t1 - t0)
        results.append(res)
        t0 = t1
    launches = radon.launches

    per_page = []
    for (img, name), res, sec in zip(pages, results, secs):
        root = ET.fromstring(ET.tostring(res.xml_tree.getroot()))
        n_regions = sum(1 for el in root.iter() if el.tag.endswith(
            "TextRegion"))
        n_lines = sum(1 for el in root.iter() if el.tag.endswith("TextLine"))
        if n_regions != len(res.contours):
            raise AssertionError(f"{name}: XML regions {n_regions} != "
                                 f"{len(res.contours)} contours")
        nonzero = sum(1 for s in res.slopes if s != 0.0)
        per_page.append({"page": name, "seconds": sec,
                         "regions": len(res.contours),
                         "nonzero_slopes": nonzero, "textlines": n_lines,
                         "degraded": res.degraded,
                         "timings": res.timings})
        print(f"{name}: {sec:.2f} s, {len(res.contours)} regions, "
              f"{nonzero} with nonzero slope, {n_lines} lines, timings "
              + " ".join(f"{k}={v:.3f}" for k, v in res.timings.items()),
              flush=True)
    details["pages"] = per_page
    details["radon_launches"] = launches
    if det.degraded:
        raise AssertionError(f"{det.degraded} page(s) degraded")
    _no_fallbacks(det, "the main path's pages")
    if launches == 0:
        raise AssertionError("the main path never launched the radon kernel")
    if not any(p["nonzero_slopes"] for p in per_page):
        raise AssertionError("no region was deskewed")
    warm = secs[1:]
    print(f"per-page seconds excluding the first: "
          f"{', '.join(f'{s:.2f}' for s in warm)} "
          f"(mean {sum(warm) / len(warm):.2f})", flush=True)
    return launches, det, pages, results


def _no_fallbacks(det, what):
    """Fail when a page of a normal phase took a rung of the fallback
    ladder that nobody asked for."""
    if det.fallbacks:
        raise AssertionError(f"{what} fell back: {dict(det.fallbacks)}")


def _xml_body(res):
    """A result's PAGE-XML without <Metadata> (its time stamps)."""
    import re
    import xml.etree.ElementTree as ET

    return re.sub(rb"<Metadata>.*?</Metadata>", b"",
                  ET.tostring(res.xml_tree.getroot()), flags=re.S)


def _watched_page(det, page):
    """process_image(page) on `det`: (result, the device phase's state,
    seconds, Radon launches)."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon

    states = []
    real = det.device_phase

    def device_phase(image, name="", pre_box=None):
        states.append(real(image, name, pre_box=pre_box))
        return states[-1]

    det.device_phase = device_phase
    try:
        torch.cuda.synchronize()
        radon.launches = 0
        t0 = time.time()
        res = det.process_image(*page)
        torch.cuda.synchronize()
        return res, states[0], time.time() - t0, radon.launches
    finally:
        del det.device_phase


def fallback_phase(details, models, page):
    """The single-page fallback ladder on the full-width dual-head bundle
    and one A4 page: every rung and both deskew routes against the raw
    path with the resident chain. Returns the Radon launches of its
    pages."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    def detector(**flags):
        return TextlineDetector(models, _serve_config(**flags))

    def collect_fails_once(det):
        real = det.deskew.resident_collect

        def collect(handle):
            det.deskew.resident_collect = real
            raise RuntimeError("injected: resident_collect fails once")

        det.deskew.resident_collect = collect

    runs = [("raw path, resident chain", {}, None, {}),
            ("canvas-resident rung", {"raw_upload": False}, None, {}),
            ("crop-upload rung", {"resident_upload": False}, None, {}),
            ("host sweep", {"resident_deskew": False}, None, {}),
            ("resident_collect fails once", {}, collect_fails_once,
             {"host_sweep": 1}),
            ("no projection", {"textline_projection": False}, None, {})]
    rows, ref, total = [], None, 0
    for what, flags, inject, want_fallbacks in runs:
        det = detector(**flags)
        if ref is None:
            _watched_page(det, page)      # untimed: first use of each op
        if inject is not None:
            inject(det)
        res, st, sec, launches = _watched_page(det, page)
        total += launches
        n_lines = sum(len(t) for t in res.textlines)
        if ref is None:
            ref = (res, st)
        diff = float(np.mean(st.region_mask != ref[1].region_mask)) \
            if st.region_mask.shape == ref[1].region_mask.shape else 1.0
        dslope = (max((abs(a - b) for a, b in zip(res.slopes,
                                                  ref[0].slopes)),
                      default=0.0)
                  if len(res.slopes) == len(ref[0].slopes) else float("inf"))
        row = {"run": what, "flags": flags, "seconds": sec,
               "regions": len(res.contours), "textlines": n_lines,
               "radon_launches": launches, "degraded": res.degraded,
               "fallbacks": dict(det.fallbacks),
               "mask_diff_share": diff, "max_slope_diff": dslope,
               "slopes_differing": sum(
                   1 for a, b in zip(res.slopes, ref[0].slopes) if a != b),
               "xml_equal": _xml_body(res) == _xml_body(ref[0]),
               "timings": res.timings}
        rows.append(row)
        print(f"fallback ladder, {what}: {sec:.3f} s, {row['regions']} "
              f"regions, {n_lines} lines, {launches} radon launches, "
              f"fallbacks {row['fallbacks']}, region mask differs from the "
              f"raw path's on a share of {diff:.3g} (limit "
              f"{LADDER_MASK_LIMIT:g}), slopes differ on "
              f"{row['slopes_differing']} regions by at most {dslope:.4g} "
              f"deg (limit {SWEEP_SLOPE_LIMIT:.4g}), PAGE-XML "
              f"{'equal' if row['xml_equal'] else 'differs'}; timings "
              + " ".join(f"{k}={v:.3f}" for k, v in res.timings.items()),
              flush=True)
        if res.degraded or det.degraded:
            raise AssertionError(f"{what}: the page degraded")
        if dict(det.fallbacks) != want_fallbacks:
            raise AssertionError(f"{what}: fallbacks {dict(det.fallbacks)}, "
                                 f"expected {want_fallbacks}")
        if not res.contours or n_lines == 0:
            raise AssertionError(f"{what}: the page has no regions or lines")
        if not diff <= LADDER_MASK_LIMIT:
            raise AssertionError(f"{what}: region mask differs on {diff:.3g}")
        if not dslope <= SWEEP_SLOPE_LIMIT:
            raise AssertionError(f"{what}: slopes differ by {dslope}")
    by = {r["run"]: r for r in rows}
    if not by["host sweep"]["radon_launches"] > 0:
        raise AssertionError("the host sweep never launched the radon kernel")
    if not by["resident_collect fails once"]["radon_launches"] > \
            by["raw path, resident chain"]["radon_launches"]:
        raise AssertionError("the host sweep behind the failed chain "
                             "launched no kernel of its own")
    if not by["no projection"]["xml_equal"]:
        raise AssertionError("reading order from the fetched mask differs "
                             "from the projection's")
    print(f"deskew stage: resident chain "
          f"{by['raw path, resident chain']['timings']['deskew']:.3f} s "
          f"({by['raw path, resident chain']['radon_launches']} launches), "
          f"host sweep {by['host sweep']['timings']['deskew']:.3f} s "
          f"({by['host sweep']['radon_launches']} launches)", flush=True)
    details["fallback_ladder"] = rows
    return total


def _profiled(fn):
    """torch.profiler over fn(): its wall, the summed time of its device
    kernels, the host ops whose kernels take most device time, and the
    device ms of each kernel by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0

    def device_ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3

    # kernel events sum to the device time; each host op carries the
    # device time of the kernels it launched itself
    events = prof.key_averages()
    device = sum(device_ms(e) for e in events
                 if e.device_type == DeviceType.CUDA) / 1e3
    rows = sorted(({"op": e.key, "calls": e.count, "device_ms": device_ms(e)}
                   for e in events if e.device_type == DeviceType.CPU),
                  key=lambda r: -r["device_ms"])
    if device <= 0:
        raise RuntimeError("torch.profiler recorded no device kernels")
    kernels = {e.key: device_ms(e) for e in events
               if e.device_type == DeviceType.CUDA}
    return wall, device, rows, kernels


def _print_profile(what, wall, device, rows, kernels):
    print(f"profiled {what}: wall {wall:.4f} s under the profiler, "
          f"device kernel time {device:.4f} s, idle share "
          f"{1 - device / wall:.3f}", flush=True)
    for r in rows[:10]:
        print(f"  {r['device_ms']:10.3f} ms {r['calls']:6d}x {r['op']}",
              flush=True)


def profile_phase(det, page, details, key="profile"):
    """One more pass of `page` under torch.profiler; the Radon kernel's
    device ms on it. A spy on ops/radon.radon_pairs keeps the inputs of
    the page's sweeps, on which the kernel, its plain version, the library
    form and the bound are then summed (_page_sweeps)."""
    from sbb_textline_detection_tpu_torch.ops import radon

    real = radon.radon_pairs
    sweeps = []

    def spy(canvases, angles):
        sweeps.append((canvases, angles))
        return real(canvases, angles)

    before = radon.launches
    radon.radon_pairs = spy
    try:
        wall, device, rows, kernels = _profiled(
            lambda: det.process_image(*page))
    finally:
        radon.radon_pairs = real
    launched = radon.launches - before
    radon_ms = sum(ms for k, ms in kernels.items() if "radon" in k)
    conv_ms, copy_ms = (sum(ms for k, ms in kernels.items()
                            if any(w in k.lower() for w in words))
                        for words in (CONV_KERNELS, COPY_KERNELS))
    details[key] = {"page": page[1], "wall_s": wall,
                    "device_s": device, "top_ops": rows[:25],
                    "radon_kernel_ms": radon_ms,
                    "radon_launches": launched,
                    "conv_kernel_ms": conv_ms, "copy_kernel_ms": copy_ms}
    _print_profile(page[1], wall, device, rows, kernels)
    print(f"  the Radon kernel: {radon_ms:.3f} ms of device time over "
          f"{launched} launches on this page; convolution kernels "
          f"{conv_ms:.3f} ms, copy kernels {copy_ms:.3f} ms", flush=True)
    if radon_ms <= 0:
        raise RuntimeError("the profile shows no Radon kernel time")
    if len(sweeps) != launched:
        raise AssertionError(f"the spy saw {len(sweeps)} sweeps, the "
                             f"kernel counted {launched} launches")
    details[key]["sweeps"] = _page_sweeps(sweeps, radon_ms)


def _page_sweeps(sweeps, device_ms):
    """The profiled page's sweeps, each on its own recorded inputs: the
    kernel held against its plain version (rtol 1e-4, atol 1e-2), and the
    plain version (CUDA events, 1 call), the library form
    (_radon_library_ms) and the bound (_radon_bound), each summed over
    the page's sweeps, beside the kernel's device time under the profiler
    (`device_ms`). `launch_ms` sums CUDA-event times of 5 back-to-back
    launches of the wrapper a sweep: on these sparse canvases the host's
    launch path, not the kernel, sets it."""
    import collections

    import torch

    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    row = {"launches": len(sweeps), "ms": device_ms, "launch_ms": 0.0,
           "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "set_pixels": 0, "canvas_pixels": 0}
    sides = collections.Counter()
    shapes = collections.Counter()
    for canv, angles in sweeps:
        cosv, sinv = radon.angle_cos_sin(angles)
        got = radon.radon_pairs_cuda(canv, cosv, sinv)
        want = radon.radon_pairs_plain(canv, cosv, sinv)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
        row["max_abs_err"] = max(row["max_abs_err"],
                                 float((got - want).abs().max()))
        row["launch_ms"] += radon_bench.cuda_time(
            lambda: radon.radon_pairs_cuda(canv, cosv, sinv), 5)
        row["plain_ms"] += radon_bench.cuda_time(
            lambda: radon.radon_pairs_plain(canv, cosv, sinv), 1)
        row["library_ms"] += _radon_library_ms(canv, cosv, sinv)
        bound, side = _radon_bound(canv, int(angles.shape[0]))
        row["bound_ms"] += bound
        sides[side] += 1
        shapes[f"{canv.shape[0]} x {angles.shape[0]} at "
               f"{canv.shape[1]}"] += 1
        row["set_pixels"] += int((canv != 0).sum())
        row["canvas_pixels"] += int(canv.numel())
    row["density"] = row["set_pixels"] / max(row["canvas_pixels"], 1)
    row["bound_by"] = sides.most_common(1)[0][0] if sides else None
    row["shapes"] = dict(shapes)
    print(f"  its {row['launches']} sweeps ({dict(shapes)}, "
          f"{row['set_pixels']} set pixels, a share of "
          f"{row['density']:.4f} of the canvases) on their own inputs, "
          f"summed: "
          f"kernel {row['ms']:.4f} ms on the device (back-to-back "
          f"launches {row['launch_ms']:.4f} ms by CUDA events), plain "
          f"{row['plain_ms']:.3f} ms, "
          f"library (2 f32 bmm) {row['library_ms']:.3f} ms, bound "
          f"{row['bound_ms']:.4g} ms ({dict(sides)}), max |err| "
          f"{row['max_abs_err']:.3g} (rtol 1e-4, atol 1e-2)", flush=True)
    return row


def _device_busy(fn):
    """torch.profiler (device activities only) over fn(): its wall, the
    summed time of its device kernels and copies, and the time in which at
    least one of them ran (streams overlap, so the sum may exceed it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        raise RuntimeError("torch.profiler recorded no device kernels")
    total = sum(end - start for start, end in spans) / 1e6
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    busy = (busy + hi - lo) / 1e6
    return {"wall_s": wall, "device_sum_s": total, "device_busy_s": busy,
            "idle_share": 1.0 - busy / wall, "device_events": len(spans)}


def radon_busy_phase(det, page, details):
    """The Radon kernel beside a busy second thread: while a thread runs
    the page's device phase again and again (what a device-phase worker
    of the batch does, on the same default stream), the kernel is held
    against its plain version at the chain's first shape and timed."""
    import threading

    import torch

    from sbb_textline_detection_tpu_torch.ops import radon, radon_bench

    dev = det.models.region.device
    angles = torch.from_numpy(radon_bench.sweep_angles()).to(dev)
    cosv, sinv = radon.angle_cos_sin(angles)
    r, s = radon_bench.SHAPES[0]
    canv = torch.from_numpy(radon_bench.noise(SEED, r, s)).to(dev)
    quiet = radon.radon_pairs(canv, angles)
    quiet_ms = radon_bench.cuda_time(lambda: radon.radon_pairs(canv, angles),
                                     50)
    stop, passes, errors = threading.Event(), [], []

    def busy():
        try:
            while not stop.is_set():
                det._device_phase_raw(*page)
                passes.append(1)
        except Exception as exc:    # shown by the main thread below
            errors.append(exc)

    th = threading.Thread(target=busy, name="busy-segmentation")
    th.start()
    try:
        while not passes and not errors:
            time.sleep(0.01)
        before = len(passes)
        got = radon.radon_pairs(canv, angles)
        want = radon.radon_pairs_plain(canv, cosv, sinv)
        torch.cuda.synchronize()
        # beside the busy thread: bitwise equal to each other and to the
        # launch made alone
        _reproducible(quiet, lambda: radon.radon_pairs(canv, angles),
                      "beside a busy thread")
        if not torch.equal(got, quiet):
            raise AssertionError("radon kernel: the launch beside a busy "
                                 "thread differs from the one made alone")
        # rounds of 50 launches until two whole segmentation passes have
        # gone by beside them
        rounds = []
        while len(passes) - before < 3 and not errors:
            rounds.append(radon_bench.cuda_time(
                lambda: radon.radon_pairs(canv, angles), 50))
        busy_ms = sorted(rounds)[len(rounds) // 2]
        during = len(passes) - before
    finally:
        stop.set()
        th.join(120)
    if errors or th.is_alive():
        raise RuntimeError(f"the busy thread failed: {errors}")
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-2)
    bound_ms, bound_by = _radon_bound(canv, int(angles.shape[0]))
    row = {"regions": r, "s": s, "pairs": r * int(angles.shape[0]),
           "canvas": "noise, beside a thread running segmentation",
           "max_abs_err": err, "ms": busy_ms, "quiet_ms": quiet_ms,
           "bitwise_equal_launches": REPRO_LAUNCHES,
           "rounds_of_50": len(rounds), "ms_min": min(rounds),
           "ms_max": max(rounds),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "segmentation_passes_meanwhile": during}
    details["radon_beside_busy_thread"] = row
    print(f"radon kernel beside a busy thread ({during} segmentation passes "
          f"of {page[1]} meanwhile), {row['pairs']} pairs at S={s}: "
          f"median {busy_ms:.4f} ms ({min(rounds):.4f}-{max(rounds):.4f} "
          f"over {len(rounds)} rounds of 50) against {quiet_ms:.4f} ms "
          f"alone, bound "
          f"{bound_ms:.3g} ms by {bound_by}, max |err| {err:.3g} (rtol "
          f"1e-4, atol 1e-2)", flush=True)
    if during < 1:
        raise AssertionError("no segmentation pass ran beside the kernel")


def _region_buffers(handle):
    """The crop buffer (bufH, bufW) each region of a page was projected in,
    from the handle resident_collect consumed."""
    from sbb_textline_detection_tpu_torch.pipeline import deskew

    if isinstance(handle, deskew._SpecResolved):
        fb = iter(_region_buffers(handle.fallback)
                  if handle.fallback is not None else ())
        return [(handle.pending.bufH, handle.pending.bufW) if j >= 0
                else next(fb) for j in handle.mapping]
    return [(bufH, int(out.shape[1]) - 1 - bufH)
            for out, group, bufH in handle for _ in group]


def _spied(det):
    """Record on `det` each page's (slopes, profiles, region buffers) from
    its deskew engine's outermost resident_collect, and each
    spec_finalize resolution."""
    eng = det.deskew
    collect, finalize = eng.resident_collect, eng.spec_finalize
    det.collected, det.resolved, depth = [], [], [0]

    def resident_collect(handle):
        depth[0] += 1
        try:
            out = collect(handle)
        finally:
            depth[0] -= 1
        if depth[0] == 0:
            det.collected.append(out + (_region_buffers(handle),))
        return out

    def spec_finalize(pending, boxes):
        det.resolved.append(finalize(pending, boxes))
        return det.resolved[-1]

    eng.resident_collect = resident_collect
    eng.spec_finalize = spec_finalize
    return det


def _cc_times(dev, models, page, region_mask, details):
    """ops/cc on the card against the CPU (equal labels and boxes; on the
    region mask its top-left CC_CHECK_SIDE square, the CPU being slow on a
    whole page) and its CUDA-event times: on the page model's dilated
    label map and on a page's region mask (the crop)."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.ops import cc, morphology
    from sbb_textline_detection_tpu_torch.ops import radon_bench
    from sbb_textline_detection_tpu_torch.pipeline import stages
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG)

    img = page[0]
    th, tw = stages.working_dims(img, DEFAULT_CONFIG)
    mh, mw = models.page.input_hw
    labels = models.page.predict_small_prescaled(
        stages.page_model_input_from_raw(img, th, tw, mh, mw))
    masks = {"page model labels, dilated": morphology.dilate(
        torch.from_numpy((labels != 0).astype(np.uint8)), 3, 1),
        "region mask of " + page[1]: torch.from_numpy(region_mask)}
    rows = []
    for what, mask in masks.items():
        area = float(mask.numel())
        lo = 0.5 * DEFAULT_CONFIG.region.min_area_ratio * area
        gpu = mask.to(dev)
        lab = cc.label_components(gpu)
        part = mask[:CC_CHECK_SIDE, :CC_CHECK_SIDE].contiguous()
        if not (torch.equal(cc.label_components(part.to(dev)).cpu(),
                            cc.label_components(part))
                and torch.equal(
                    cc.component_boxes_topk(part.to(dev), 16, lo, area).cpu(),
                    cc.component_boxes_topk(part, 16, lo, area))
                and torch.equal(cc.largest_component_box(part.to(dev))[0]
                                .cpu(), cc.largest_component_box(part)[0])):
            raise AssertionError(f"ops/cc on the card differs from the CPU "
                                 f"on the {what}")
        row = {"mask": what, "shape": list(mask.shape),
               "components": int((lab.reshape(-1) == torch.arange(
                   lab.numel(), device=dev, dtype=lab.dtype)).sum()),
               "label_components_ms": radon_bench.cuda_time(
                   lambda: cc.label_components(gpu), 3),
               "component_boxes_topk_ms": radon_bench.cuda_time(
                   lambda: cc.component_boxes_topk(gpu, 16, lo, area), 3),
               "largest_component_box_ms": radon_bench.cuda_time(
                   lambda: cc.largest_component_box(gpu), 3)}
        rows.append(row)
        print(f"ops/cc on the {what} {tuple(mask.shape)}, "
              f"{row['components']} components (equal to the CPU on the "
              f"top-left {CC_CHECK_SIDE} square): "
              f"label_components {row['label_components_ms']:.3f} ms, "
              f"component_boxes_topk(16) "
              f"{row['component_boxes_topk_ms']:.3f} ms, "
              f"largest_component_box "
              f"{row['largest_component_box_ms']:.3f} ms", flush=True)
    details["cc"] = rows


def flags_phase(details, models, pages):
    """The three SKEWS pages under the runtime flags the port took last
    (see the module docstring, phase 6). Returns the Radon launches of its
    servings."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.pipeline import deskew, stages
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG, TextlineDetector)

    cfg = _serve_config()

    def detector(config=None, **flags):
        return _spied(TextlineDetector(models,
                                       config or _serve_config(**flags)))

    def box_of(st):
        """[x, y, w, h] of a state's page box."""
        y0, y1, x0, x1 = st.page_coord
        return [x0, y0, x1 - x0, y1 - y0]

    total, rows = 0, []
    base = detector()
    ref = []
    for page in pages:
        res, st, sec, launches = _watched_page(base, page)
        total += launches
        boxes = stages.region_contours_and_boxes(st.region_mask, cfg)[1]
        ref.append((res, st, base.collected[-1], boxes))
        rows.append({"run": "default", "page": page[1], "seconds": sec,
                     "regions": len(res.contours), "radon_launches": launches,
                     "largest_region_side": max(max(b[2], b[3])
                                                for b in boxes)})
    _no_fallbacks(base, "flags phase, the serving config")

    # the reference's own cap: a page with a region above it takes the
    # host sweep, once
    det = detector(DEFAULT_CONFIG)
    for i, page in enumerate(pages):
        want_st, boxes = ref[i][1], ref[i][3]
        capH, capW = det.deskew.resident_buffer_shape(
            tuple(want_st.textline_dev.shape))
        over = sum(1 for x, y, w, h in boxes if h > capH or w > capW)
        before = det.fallbacks["host_sweep"]
        res, st, sec, launches = _watched_page(det, page)
        total += launches
        took = det.fallbacks["host_sweep"] - before
        rows.append({"run": "DEFAULT_CONFIG", "page": page[1],
                     "seconds": sec, "regions": len(res.contours),
                     "regions_over_cap": over, "host_sweeps": took,
                     "radon_launches": launches})
        print(f"flags, DEFAULT_CONFIG (cap {capH} x {capW}), {page[1]}: "
              f"{sec:.3f} s, {over} of {len(boxes)} regions over the cap, "
              f"{took} host sweep(s), {launches} radon launches",
              flush=True)
        if res.degraded or took != (over > 0):
            raise AssertionError(f"DEFAULT_CONFIG {page[1]}: {over} regions "
                                 f"over the cap, {took} host sweeps")
    if set(det.fallbacks) - {"host_sweep"}:
        raise AssertionError(f"DEFAULT_CONFIG fell back: {det.fallbacks}")

    fetchfree_boxes = {}
    for flag in ("device_page_box", "fused_page_box"):
        det = detector(**{flag: True})
        for i, page in enumerate(pages):
            res, st, sec, launches = _watched_page(det, page)
            total += launches
            want_res, want_st = ref[i][0], ref[i][1]
            # the raw path on the same box: the default run's own state,
            # or a raw phase handed the device box
            raw = want_st if st.page_coord == want_st.page_coord else \
                det._device_phase_raw(*page, pre_box=(box_of(st), 0.0, 0.0,
                                                      0.0))
            same = (np.array_equal(raw.region_mask, st.region_mask)
                    and np.array_equal(raw.textline_proj, st.textline_proj))
            fetchfree_boxes.setdefault(i, []).append(st.page_coord)
            row = {"run": flag, "page": page[1], "seconds": sec,
                   "regions": len(res.contours), "radon_launches": launches,
                   "page_box": st.page_coord,
                   "host_page_box": want_st.page_coord,
                   "masks_equal_raw_path_on_this_box": same,
                   "xml_equal_default": _xml_body(res) == _xml_body(
                       want_res)}
            rows.append(row)
            print(f"flags, {flag}, {page[1]}: {sec:.3f} s, {row['regions']} "
                  f"regions; device box {st.page_coord}, host box "
                  f"{want_st.page_coord}"
                  + ("" if st.page_coord == want_st.page_coord else
                     " (differs: DEVIATIONS #12)")
                  + f"; region mask and row projection equal to the raw "
                  f"path's on this box: {same}; PAGE-XML equal to the "
                  f"default run's: {row['xml_equal_default']}", flush=True)
            if res.degraded or not same or not res.contours:
                raise AssertionError(f"{flag} {page[1]}: degraded, no "
                                     "regions, or masks differ from the raw "
                                     "path's on the same box")
        _no_fallbacks(det, f"flags phase, {flag}")
    for i, (headless, fused) in fetchfree_boxes.items():
        if headless != fused:
            raise AssertionError(f"{pages[i][1]}: the fused page box "
                                 f"{fused} differs from the headless one "
                                 f"{headless}")

    det = detector(spec_deskew=True)
    for i, page in enumerate(pages):
        res, st, sec, launches = _watched_page(det, page)
        total += launches
        want_res, _, (w_slopes, w_profiles, w_bufs), _ = ref[i]
        slopes, profiles, bufs = det.collected[-1]
        if len(det.resolved) != i + 1:
            raise AssertionError(f"spec_deskew {page[1]}: no speculative "
                                 "dispatch was resolved (see the log)")
        resolved = det.resolved[-1]
        if isinstance(resolved, deskew._SpecResolved):
            matched = sum(j >= 0 for j in resolved.mapping)
        else:
            matched = 0      # the page's canvas bucket is not the slots'
        err = max((float(np.max(np.abs(a - b) / (SPEC_PROFILE_ATOL
                                                 + SPEC_PROFILE_RTOL
                                                 * np.abs(b))))
                   for p, q in zip(profiles, w_profiles)
                   for a, b in zip(p, q) if a.size), default=0.0)
        differ = [k for k, (a, b) in enumerate(zip(bufs, w_bufs)) if a != b]
        same_rest = (res.page_coord == want_res.page_coord
                     and len(res.contours) == len(want_res.contours)
                     and all(np.array_equal(a, b) for a, b in
                             zip(res.contours, want_res.contours))
                     and all(len(res.textlines[k]) == len(
                         want_res.textlines[k]) and all(
                         np.array_equal(a, b) for a, b in zip(
                             res.textlines[k], want_res.textlines[k]))
                             for k in range(len(res.contours))
                             if k not in differ))
        xml_equal = _xml_body(res) == _xml_body(want_res)
        row = {"run": "spec_deskew", "page": page[1], "seconds": sec,
               "regions": len(res.contours), "radon_launches": launches,
               "matched_slots": matched,
               "fallback_regions": len(res.contours) - matched,
               "slopes_equal": slopes == w_slopes,
               "profile_err_over_tolerance": err,
               "regions_with_another_buffer": differ,
               "rest_equal": same_rest, "xml_equal_default": xml_equal}
        rows.append(row)
        print(f"flags, spec_deskew, {page[1]}: {sec:.3f} s, "
              f"{row['regions']} regions, {matched} served by speculative "
              f"slots, {row['fallback_regions']} by the ordinary dispatch; "
              f"slopes bit-equal to the default run's: "
              f"{row['slopes_equal']}; profiles at most {err:.3g} of the "
              f"tolerance (rtol {SPEC_PROFILE_RTOL:g}, atol "
              f"{SPEC_PROFILE_ATOL:g}); regions whose crop buffer differs "
              f"from the default run's: {differ}; PAGE-XML equal: "
              f"{xml_equal}, equal outside those regions' lines: "
              f"{same_rest}", flush=True)
        if res.degraded or not row["slopes_equal"] or err > 1.0 \
                or not same_rest or (not differ and not xml_equal):
            raise AssertionError(f"spec_deskew {page[1]}: differs from the "
                                 "default run")
    _no_fallbacks(det, "flags phase, spec_deskew")
    if not any(r.get("matched_slots") for r in rows):
        raise AssertionError("no region was served by a speculative slot")

    for i, page in enumerate(pages):
        want_res, want_st, _, boxes = ref[i]
        cap = max(max(b[2], b[3]) for b in boxes) - 1
        det = detector(deskew_buf_max=cap)
        capH, capW = det.deskew.resident_buffer_shape(
            tuple(want_st.textline_dev.shape))
        over = sum(1 for x, y, w, h in boxes if h > capH or w > capW)
        res, st, sec, launches = _watched_page(det, page)
        total += launches
        dslope = max((abs(a - b) for a, b in zip(res.slopes,
                                                 want_res.slopes)),
                     default=0.0) \
            if len(res.slopes) == len(want_res.slopes) else float("inf")
        row = {"run": "deskew_buf_max", "page": page[1], "cap": cap,
               "seconds": sec, "regions": len(res.contours),
               "regions_over_cap": over, "radon_launches": launches,
               "fallbacks": dict(det.fallbacks), "max_slope_diff": dslope}
        rows.append(row)
        print(f"flags, deskew_buf_max={cap}, {page[1]}: {sec:.3f} s, "
              f"{over} of {len(boxes)} regions over the cap, fallbacks "
              f"{row['fallbacks']}, slopes within {dslope:.4g} deg of the "
              f"default run's (limit {SWEEP_SLOPE_LIMIT:.4g})", flush=True)
        if res.degraded or over < 1 or row["fallbacks"] != {"host_sweep": 1} \
                or not dslope <= SWEEP_SLOPE_LIMIT:
            raise AssertionError(f"deskew_buf_max {page[1]}: {row}")
    _cc_times(models.region.device, models, pages[0], ref[0][1].region_mask,
              details)
    details["flags"] = rows
    return total


def _batch_pages():
    import numpy as np

    from sbb_textline_detection_tpu_torch.utils import synthetic

    pages = []
    for i, (height, skew) in enumerate(BATCH_PAGES):
        img, _ = synthetic.make_page(np.random.default_rng(SEED + 20 + i),
                                     height, 2480, skew_deg=skew)
        pages.append((img, f"batch{i}_h{height}_skew{skew:+.0f}.png"))
    return pages


def _box_moved(a, b, model_px):
    """Per side of two page boxes [y0, y1, x0, x1], the move in
    model-resolution pixels (`model_px`: working pixels per model pixel
    down and across)."""
    return [abs(p - q) / model_px[i // 2] for i, (p, q) in
            enumerate(zip(a, b))]


def _mask_diff_share(mask, coord, ref_mask, ref_coord):
    """Share of differing region-mask pixels over the two page boxes'
    common part, in working coordinates."""
    import numpy as np

    y0, x0 = max(coord[0], ref_coord[0]), max(coord[2], ref_coord[2])
    y1, x1 = min(coord[1], ref_coord[1]), min(coord[3], ref_coord[3])
    a = mask[y0 - coord[0]:y1 - coord[0], x0 - coord[2]:x1 - coord[2]]
    b = ref_mask[y0 - ref_coord[0]:y1 - ref_coord[0],
                 x0 - ref_coord[2]:x1 - ref_coord[2]]
    if a.shape != b.shape or a.size == 0:
        return 1.0
    return float(np.mean(a != b))


def _regions_that_differ(res, want):
    """(regions whose slope differs, whether everything else is equal:
    page box, contours, and the lines of every region whose slope is the
    same) of two results of one page."""
    import numpy as np

    if res.page_coord != want.page_coord \
            or len(res.contours) != len(want.contours) \
            or not all(np.array_equal(a, b)
                       for a, b in zip(res.contours, want.contours)):
        return None, False
    flipped = [i for i, (a, b) in enumerate(zip(res.slopes, want.slopes))
               if a != b]
    same = all(len(res.textlines[i]) == len(want.textlines[i])
               and all(np.array_equal(a, b) for a, b in
                       zip(res.textlines[i], want.textlines[i]))
               for i in range(len(want.contours)) if i not in flipped)
    return len(flipped), same


def batch_phase(details, models):
    """The pipelined batch against sequential process_image on 8 A4 pages
    (see the module docstring, phase 7). Returns the Radon launches of its
    runs (a)-(d)."""
    import threading

    import torch

    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline import stages
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    cfg = _serve_config()
    pages = _batch_pages()
    names = [name for _, name in pages]

    def detector(**flags):
        return TextlineDetector(models, _serve_config(**flags))

    def serve(det, batched, some=None):
        """(results, region masks, seconds, Radon launches) of the pages
        after one untimed warm-up page."""
        masks = []
        real = det.host_phase

        def host_phase(st, pre=None):
            masks.append(st.region_mask)
            return real(st, pre)

        todo = pages if some is None else pages[:some]
        if batched:
            list(det.process_batch(iter(pages[:1])))
        else:
            det.process_image(*pages[0])
        det.host_phase = host_phase
        try:
            torch.cuda.synchronize()
            radon.launches = 0
            t0 = time.time()
            if batched:
                results = list(det.process_batch(iter(todo)))
            else:
                results = [det.process_image(*p) for p in todo]
            torch.cuda.synchronize()
            return results, masks, time.time() - t0, radon.launches
        finally:
            del det.host_phase

    def stream_per_worker(det):
        """The other stream design, put on from outside: each worker
        thread runs its device phases on a CUDA stream of its own and
        waits for it before it hands the pages over; the main thread,
        on the default stream, tells the allocator that it reads the
        textline canvases which those streams allocated."""
        group, dispatch = det.device_phase_group, det.host_phase_dispatch
        tls = threading.local()

        def device_phase_group(items):
            if not hasattr(tls, "stream"):
                tls.stream = torch.cuda.Stream()
            with torch.cuda.stream(tls.stream):
                states = group(items)
                tls.stream.synchronize()
            return states

        def host_phase_dispatch(st):
            if st.textline_dev is not None:
                st.textline_dev.record_stream(torch.cuda.current_stream())
            return dispatch(st)

        det.device_phase_group = device_phase_group
        det.host_phase_dispatch = host_phase_dispatch
        return det

    runs = [
        ("a", "process_image, one after another", detector(), False),
        ("b", "process_batch, 1 worker, no page-box window",
         detector(device_phase_workers=1, page_box_batch=0), True),
        ("c", "process_batch under the default runtime (2 workers, "
         "windows of 8)", detector(), True),
        ("c-3-workers", "as (c), 3 workers",
         detector(device_phase_workers=3), True),
        ("c-streams", "as (c), a CUDA stream per worker",
         stream_per_worker(detector()), True),
        ("d", "process_batch, pages_per_dispatch=4",
         detector(pages_per_dispatch=4), True)]
    rows, ref, total = [], None, 0
    for key, what, det, batched in runs:
        results, masks, sec, launches = serve(det, batched)
        if key in ("a", "b", "c", "d"):
            total += launches
        found = [ET_page_name(r) for r in results]
        if found != names:
            raise AssertionError(f"({key}) results out of order: {found}")
        if det.degraded or any(r.degraded for r in results):
            raise AssertionError(f"({key}) {det.degraded} page(s) degraded")
        _no_fallbacks(det, f"batch run ({key})")
        if ref is None:
            ref = (results, masks)
        per_page = []
        for i, (res, mask) in enumerate(zip(results, masks)):
            want, want_mask = ref[0][i], ref[1][i]
            th, tw = stages.working_dims(pages[i][0], cfg)
            mh, mw = models.page.input_hw
            moved = _box_moved(res.page_coord, want.page_coord,
                               (th / mh, tw / mw))
            dev_s = res.device_timings["total"]
            flipped, rest_equal = _regions_that_differ(res, want)
            per_page.append({
                "page": names[i], "regions": len(res.contours),
                "xml_equal": _xml_body(res) == _xml_body(want),
                "slopes_differing": flipped, "rest_equal": rest_equal,
                "page_box": res.page_coord,
                "page_box_moved_model_px": max(moved),
                "mask_diff_share": _mask_diff_share(
                    mask, res.page_coord, want_mask, want.page_coord),
                "regions_equal": len(res.contours) == len(want.contours),
                "timings": res.timings,
                "device_timings": res.device_timings, "flops": res.flops,
                "flops_per_device_s": res.flops / dev_s if dev_s else None})
        row = {"run": key, "what": what, "seconds": sec,
               "pages_per_s": len(pages) / sec, "radon_launches": launches,
               "pages": per_page}
        rows.append(row)
        moved = [p for p in per_page if p["page_box_moved_model_px"] > 0]
        print(f"batch ({key}) {what}: {len(pages)} pages in {sec:.3f} s, "
              f"{row['pages_per_s']:.3f} pages/s, {launches} radon "
              f"launches; against (a): PAGE-XML equal on "
              f"{sum(p['xml_equal'] for p in per_page)}, every slope on "
              f"{sum(p['slopes_differing'] == 0 for p in per_page)} (slopes "
              f"that differ: {[p['slopes_differing'] for p in per_page]}), "
              f"page box on "
              f"{len(pages) - len(moved)} of {len(pages)} pages; largest "
              f"share of differing region-mask pixels "
              f"{max(p['mask_diff_share'] for p in per_page):.3g}",
              flush=True)
        for p in moved:
            print(f"  {p['page']}: the page box moved by "
                  f"{p['page_box_moved_model_px']:.2f} model-resolution "
                  f"pixels: {p['page_box']}", flush=True)
            if p["page_box_moved_model_px"] > 1.0:
                raise AssertionError(f"({key}) {p['page']}: the page box "
                                     "moved by more than one model pixel")
        for p in per_page:
            if key == "d":
                if not (p["mask_diff_share"] <= BATCH_MASK_LIMIT
                        and p["regions_equal"]):
                    raise AssertionError(
                        f"(d) {p['page']}: region mask differs on "
                        f"{p['mask_diff_share']:.3g} (limit "
                        f"{BATCH_MASK_LIMIT:g}), regions "
                        f"{p['regions']}")
            elif not p["page_box_moved_model_px"] and not p["xml_equal"]:
                raise AssertionError(
                    f"({key}) {p['page']}: PAGE-XML differs from "
                    f"process_image's: {p['slopes_differing']} slopes "
                    f"differ, the rest equal: {p['rest_equal']}")
    grids = {models.region.grid_for(p["page_box"][1] - p["page_box"][0],
                                    p["page_box"][3] - p["page_box"][2],
                                    cfg.tiling.margin_ratio)
             for p in rows[0]["pages"]}
    print(f"batch pages: tile grids {sorted(grids)}; regions "
          f"{[p['regions'] for p in rows[0]['pages']]}", flush=True)
    if len(grids) < 2:
        raise AssertionError("the batch pages share one tile grid")
    for key in ("a", "c"):
        row = next(r for r in rows if r["run"] == key)
        for p in row["pages"][:3]:
            d = p["device_timings"]
            print(f"  ({key}) {p['page']}: device seconds "
                  + " ".join(f"{k}={v:.3f}" for k, v in d.items())
                  + f" of total={p['timings']['total']:.3f} s wall; "
                  f"{p['flops'] / 1e12:.3f} TFLOP, "
                  f"{p['flops_per_device_s'] / 1e12:.2f} TFLOP/s over the "
                  f"device seconds ({p['flops_per_device_s'] / BF16_OPS_S:.4f}"
                  f" of the {details['card'].split(',')[0]}'s dense bf16 "
                  f"peak of {BF16_OPS_S / 1e12:.0f} TFLOP/s)", flush=True)
    # the card's idle share, sequential against pipelined, on fewer pages
    # (the profiler slows the host)
    profiles = {}
    for key, det, batched in (("a", detector(), False),
                              ("c", detector(), True)):
        served = []
        profiles[key] = _device_busy(lambda: served.append(
            serve(det, batched, BATCH_PROFILED_PAGES)[0]))
        p = profiles[key]
        p["slopes_differing_from_a"] = [
            _regions_that_differ(r, w)[0]
            for r, w in zip(served[0], ref[0])]
        p["xml_equal_to_a"] = [_xml_body(r) == _xml_body(w)
                               for r, w in zip(served[0], ref[0])]
        print(f"batch ({key}) under torch.profiler, a warm-up page and "
              f"{BATCH_PROFILED_PAGES} pages: wall {p['wall_s']:.3f} s, "
              f"device busy {p['device_busy_s']:.3f} s (kernels and copies "
              f"add up to {p['device_sum_s']:.3f} s), idle share "
              f"{p['idle_share']:.3f}; slopes that differ from the first "
              f"serving by (a): {p['slopes_differing_from_a']}, PAGE-XML "
              f"equal to it: {p['xml_equal_to_a']}", flush=True)
        # (c)'s batched page forward may move a box by a model pixel
        same_box = [r.page_coord == w.page_coord
                    for r, w in zip(served[0], ref[0])]
        if not all(eq or (key == "c" and not box) for eq, box in
                   zip(p["xml_equal_to_a"], same_box)):
            raise AssertionError(f"({key}) served again under the profiler: "
                                 "a PAGE-XML differs from the first serving "
                                 "by (a)")
    a = rows[0]["pages_per_s"]
    print("batch summary, pages/s: " + ", ".join(
        f"({r['run']}) {r['pages_per_s']:.3f} ({r['pages_per_s'] / a:.2f}x)"
        for r in rows), flush=True)
    details["batch"] = {"runs": rows, "profiles": profiles,
                        "tile_grids": sorted(grids)}
    return total


def ET_page_name(res):
    """The imageFilename a result's PAGE-XML carries."""
    for el in res.xml_tree.getroot().iter():
        if el.tag.endswith("}Page") or el.tag == "Page":
            return el.get("imageFilename")
    return None


def _tint(img):
    """A sepia tint: the page's channels differ, so the detector uploads
    RGB and the fused program gathers three channels."""
    import numpy as np

    out = img.astype(np.float32)
    out[..., 1] *= 0.92
    out[..., 2] *= 0.78
    return out.astype(np.uint8)


def _chunk_of_tiles(models, img, cfg):
    """The first tile chunk of `img` at working size, cut on the fused
    program's grid (uint8, on the card), and the page's Otsu threshold."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models.runner import _balanced_chunk
    from sbb_textline_detection_tpu_torch.ops import threshold
    from sbb_textline_detection_tpu_torch.pipeline import stages

    th, tw = stages.working_dims(img, cfg)
    scaled = stages.LazyScaledImage(img, th, tw).image
    ny, nx = models.region.grid_for(th, tw, cfg.tiling.margin_ratio)
    chunk = _balanced_chunk(ny * nx, cfg.runtime.tile_chunk)
    mh, mw = models.region.input_hw
    margin = int(cfg.tiling.margin_ratio * mw)
    sh, sw = mh - 2 * margin, mw - 2 * margin
    starts = [(min(j * sh, th - mh), min(i * sw, tw - mw))
              for j in range(ny) for i in range(nx)][:chunk]
    tiles = np.stack([scaled[y:y + mh, x:x + mw] for y, x in starts])
    return (torch.from_numpy(tiles).to(models.region.device),
            threshold.otsu_threshold_host(scaled[..., 0]))


def _class1_margin(logits):
    """Per pixel (every 7th), class 1's logit over the best other's: its
    share above 0 is class 1's share of the argmax, and adding d to class
    1's head bias moves every margin by d."""
    import torch

    others = torch.cat([logits[:, :1], logits[:, 2:]], 1).amax(1)
    return (logits[:, 1] - others).flatten()[::7].float()


def _set_class1_share(model, margin, bias0, target):
    """Class 1's head bias set so that its share of the margin sample's
    argmax becomes `target`; returns the shift from `bias0`."""
    import torch

    shift = -float(torch.quantile(margin, 1.0 - target))
    with torch.no_grad():
        model.module.head.bias[1] = bias0 + shift
    return shift


def classic_phase(dev, details):
    """The classic three-model bundle: three full-size ResNet50Unets
    (page 2 classes, region 3, textline 2; 448x448, float32, seeded
    random_init) written with checkpoint.save and loaded by
    ModelBundle.from_dir. On a chunk of the first page's tiles: the
    forwards timed with CUDA events, their FLOPs counted, the region
    model's logits on the card against the CPU (TF32 off), and the text
    classes' shares recentred where random weights leave them lopsided or
    a page without a text region. Then process_image on 3 A4 pages, the
    last tinted (RGB upload); each must reach the deskew chain with at
    least one region and Radon launches."""
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import (precision, radon,
                                                     radon_bench)
    from sbb_textline_detection_tpu_torch.pipeline import detector, stages
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)
    from sbb_textline_detection_tpu_torch.utils import synthetic

    cfg = _serve_config()
    names = cfg.model_names
    out = os.path.join(ROOT, "build", "smoke_classic")
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    for role, n_classes in CLASSIC_CLASSES:
        spec = registry.ModelSpec(getattr(names, role), "resnet50_unet",
                                  CLASSIC_TILE, CLASSIC_TILE, n_classes)
        checkpoint.save(os.path.join(out, spec.name + ".npz"), spec,
                        checkpoint.random_init(
                            spec, torch.Generator().manual_seed(SEED)))
    save_s = time.time() - t0
    t0 = time.time()
    models = ModelBundle.from_dir(out, cfg.runtime, dev, names)
    load_s = time.time() - t0
    if models.is_dual_head or models.region.spec.arch != "resnet50_unet":
        raise AssertionError("from_dir did not load the classic bundle")
    pages = []
    for i, skew in enumerate(SKEWS):
        img, _ = synthetic.make_page(np.random.default_rng(SEED + i), 3508,
                                     2480, skew_deg=skew)
        pages.append((_tint(img) if i == 2 else img,
                      f"classic_a4_skew{skew:+.0f}.png"))

    tiles, t = _chunk_of_tiles(models, pages[0][0], cfg)
    x = {"region": (tiles[..., 0].to(torch.int32) > t).to(torch.float32)
         [:, None].expand(-1, 3, -1, -1),
         "textline": (tiles.to(torch.float32) / 255.0).permute(0, 3, 1, 2)}
    fwd, shares = {}, {}
    # the module is called directly here, so TF32 is switched off as the
    # runner switches it off around its own calls
    with torch.no_grad(), precision.full_f32():
        for role in ("region", "textline"):
            m = getattr(models, role)
            with FlopCounterMode(display=False) as fc:
                m.module.forward_nchw(x[role][:1])
            fwd[role] = {"chunk": int(tiles.shape[0]),
                         "flops_per_tile": fc.get_total_flops(),
                         "ms_per_chunk": radon_bench.cuda_time(
                             lambda: m.module.forward_nchw(x[role]), 3)}
        cpu = registry.build_module(models.region.spec)
        cpu.load_state_dict(models.region.module.state_dict())
        sample = x["region"][:CLASSIC_PARITY_TILES]
        want = cpu.eval().forward_nchw(sample.cpu())
        got = models.region.module.forward_nchw(sample).cpu()
        parity = float((got - want).abs().max() / want.abs().max())
        del cpu, want, got
        margins = {role: _class1_margin(getattr(models, role).module
                                        .forward_nchw(x[role]))
                   for role in ("region", "textline")}
    del tiles, x
    torch.cuda.empty_cache()
    for role, f in fwd.items():
        f["tflop_per_s"] = f["flops_per_tile"] * f["chunk"] / (
            f["ms_per_chunk"] * 1e9)
        print(f"classic {role} ResNet50Unet forward (f32, TF32 off): "
              f"{f['ms_per_chunk']:.2f} ms per {f['chunk']}-tile chunk, "
              f"{f['flops_per_tile'] / 1e9:.2f} GFLOP a tile, "
              f"{f['tflop_per_s']:.1f} TFLOP/s", flush=True)
    print(f"classic bundle saved in {save_s:.1f} s, loaded by from_dir in "
          f"{load_s:.1f} s", flush=True)
    print(f"classic region model card vs cpu (f32, {CLASSIC_PARITY_TILES} "
          f"page tiles): max |err| / max |logit| {parity:.3g} (limit "
          f"{CLASSIC_PARITY_RTOL:g})", flush=True)
    if not parity <= CLASSIC_PARITY_RTOL:
        raise AssertionError(f"classic forward parity {parity:.3g} above "
                             f"{CLASSIC_PARITY_RTOL:g}")

    # seeded random weights rarely pick the text classes in proportion
    # (the CPU tests nudge the same biases): the textline share is
    # recentred when it lies outside CLASSIC_TEXTLINE_SHARE, and the
    # region share, unless it lies in CLASSIC_REGION_SHARE, set through
    # CLASSIC_REGION_SHARES until every page's region mask holds a text
    # region
    det = TextlineDetector(models, cfg)
    for role in ("region", "textline"):
        share = float((margins[role] > 0).float().mean())
        shares[role] = {"share": share, "bias_shift": 0.0}
    lo, hi, target = CLASSIC_TEXTLINE_SHARE
    if not lo < shares["textline"]["share"] < hi:
        shares["textline"]["bias_shift"] = _set_class1_share(
            models.textline, margins["textline"],
            float(models.textline.module.head.bias[1].detach()), target)
    bias0 = float(models.region.module.head.bias[1].detach())
    lo, hi = CLASSIC_REGION_SHARE
    for target in ([None] if lo < shares["region"]["share"] < hi else []) \
            + list(CLASSIC_REGION_SHARES):
        if target is not None:
            shares["region"]["bias_shift"] = _set_class1_share(
                models.region, margins["region"], bias0, target)
        n_regions = [len(stages.region_contours_and_boxes(
            det._device_phase_raw(*page).region_mask, cfg)[0])
            for page in pages]
        if min(n_regions) > 0:
            break
    else:
        raise AssertionError("no text region at any class-1 share")
    for role, f in fwd.items():
        sh = shares[role]
        print(f"classic {role}: class-1 share {sh['share']:.3f} on the "
              f"chunk" + (f"; seeded random weights, head bias nudged by "
                          f"{sh['bias_shift']:+.4f}" if sh["bias_shift"]
                          else "; weights as drawn"), flush=True)
    shipped, chunks, tf32_seen = [], [], set()
    upload, pair = models.region.upload_raw, models.region._forward_pair
    for role in ("page", "region", "textline"):
        module = getattr(models, role).module

        def forward_nchw(x, real=module.forward_nchw):
            tf32_seen.add((torch.backends.cuda.matmul.allow_tf32,
                           torch.backends.cudnn.allow_tf32))
            return real(x)

        module.forward_nchw = forward_nchw

    def record_upload(image):
        shipped.append(image.ndim)
        return upload(image)

    def record_chunk(other, batch, tb, member=0):
        chunks.append(int(batch.shape[0]))
        return pair(other, batch, tb, member)

    models.region.upload_raw = record_upload
    models.region._forward_pair = record_chunk
    # one page at a time: the counts below are per page, and a pipelined
    # batch would run the next page's forwards meanwhile
    per_page, total = [], 0
    for (img, name) in pages:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        chunks.clear()
        radon.launches = 0
        t0 = time.time()
        res = det.process_image(img, name)
        torch.cuda.synchronize()
        sec = time.time() - t0
        launches = radon.launches
        total += launches
        peak = torch.cuda.max_memory_allocated(dev)
        root = ET.fromstring(ET.tostring(res.xml_tree.getroot()))
        n_lines = sum(1 for el in root.iter() if el.tag.endswith("TextLine"))
        rgb = shipped[-1] == 3
        n_tiles = sum(chunks)
        flops = n_tiles * sum(f["flops_per_tile"] for f in fwd.values())
        page = {"page": name, "seconds": sec, "regions": len(res.contours),
                "nonzero_slopes": sum(1 for s in res.slopes if s != 0.0),
                "textlines": n_lines, "radon_launches": launches,
                "degraded": res.degraded, "peak_bytes": peak,
                "rgb_upload": rgb, "tiles": n_tiles, "chunks": len(chunks),
                "resnet_tflop": flops / 1e12, "timings": res.timings}
        per_page.append(page)
        print(f"{name}: {sec:.2f} s, {page['regions']} regions, "
              f"{page['nonzero_slopes']} with nonzero slope, {n_lines} "
              f"lines, {launches} radon launches, degraded {res.degraded}, "
              f"peak {peak / 2**30:.2f} GiB, "
              f"{'RGB' if rgb else 'one-plane'} upload, {n_tiles} tiles in "
              f"{len(chunks)} chunks x 2 ResNet forwards "
              f"({flops / 1e12:.2f} TFLOP; region "
              f"{fwd['region']['ms_per_chunk']:.1f} + textline "
              f"{fwd['textline']['ms_per_chunk']:.1f} ms per "
              f"{fwd['region']['chunk']}-tile chunk), timings "
              + " ".join(f"{k}={v:.3f}" for k, v in res.timings.items()),
              flush=True)
        if res.degraded or not res.contours or launches == 0:
            raise AssertionError(f"{name}: the classic page did not reach "
                                 f"the deskew chain (degraded "
                                 f"{res.degraded}, {len(res.contours)} "
                                 f"regions, {launches} launches)")
        if rgb != (not detector._channels_identical(img)):
            raise AssertionError(f"{name}: wrong upload ({shipped[-1]}-d)")
    if not per_page[2]["rgb_upload"]:
        raise AssertionError("the tinted page did not go up as RGB")
    _no_fallbacks(det, "the classic pages")
    print(f"classic pages: (matmul, cuDNN) TF32 switches seen inside the "
          f"ResNet forwards: {sorted(tf32_seen)}", flush=True)
    if tf32_seen != {(False, False)}:
        raise AssertionError(f"a float32 forward ran with TF32 on: "
                             f"{sorted(tf32_seen)}")

    # the separate per-model rung: every fused call raises, so the region
    # and the textline model run one after the other (the dual-head model
    # cannot serve this rung: it reads two channels, as in the JAX package)
    ref, ref_st, _, ref_launches = _watched_page(det, pages[0])
    total += ref_launches

    def fused_fails(*a, **k):
        raise RuntimeError("injected: the fused call fails")

    sep_det = TextlineDetector(models, cfg)
    for name in ("predict_dual_tiled_resident_raw",
                 "predict_dual_tiled_resident", "predict_dual_tiled"):
        setattr(models.region, name, fused_fails)
    try:
        sep, sep_st, sep_s, sep_launches = _watched_page(sep_det, pages[0])
    finally:
        for name in ("predict_dual_tiled_resident_raw",
                     "predict_dual_tiled_resident", "predict_dual_tiled"):
            delattr(models.region, name)
    total += sep_launches
    sep_diff = float(np.mean(sep_st.region_mask != ref_st.region_mask))
    sep_row = {"seconds": sep_s, "regions": len(sep.contours),
               "radon_launches": sep_launches,
               "fallbacks": dict(sep_det.fallbacks),
               "mask_diff_share": sep_diff,
               "xml_equal": _xml_body(sep) == _xml_body(ref),
               "slopes_equal": sep.slopes == ref.slopes,
               "timings": sep.timings}
    print(f"fallback ladder, separate per-model rung (classic bundle, "
          f"{pages[0][1]}): {sep_s:.3f} s, {len(sep.contours)} regions, "
          f"fallbacks {sep_row['fallbacks']}, region mask differs from the "
          f"fused program's on a share of {sep_diff:.3g} (limit "
          f"{LADDER_MASK_LIMIT:g}), PAGE-XML "
          f"{'equal' if sep_row['xml_equal'] else 'differs'}; timings "
          + " ".join(f"{k}={v:.3f}" for k, v in sep.timings.items()),
          flush=True)
    if sep.degraded or not sep.contours or dict(sep_det.fallbacks) != {
            "standard_path": 1, "separate_models": 1}:
        raise AssertionError("the separate per-model rung did not serve "
                             f"the page: {sep_row}")
    if not sep_diff <= LADDER_MASK_LIMIT:
        raise AssertionError(f"separate rung: region mask differs on "
                             f"{sep_diff:.3g}")
    details["classic"] = {"save_s": save_s, "load_s": load_s,
                          "forward": fwd, "parity_rel_err": parity,
                          "class1_share_and_nudge": shares,
                          "pages": per_page, "radon_launches": total,
                          "separate_rung": sep_row}
    return total


def train_parity_phase(dev, details):
    """(a) One float32 AdamW step of the full-width dual-head model from
    the same weights on the same batch, on the card and on the CPU."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.ops import precision
    from sbb_textline_detection_tpu_torch.training import train
    from sbb_textline_detection_tpu_torch.utils import synthetic

    spec = registry.DUALHEAD_SPEC
    sd = checkpoint.random_init(spec, torch.Generator().manual_seed(SEED))
    imgs, labels = synthetic.dualhead_batch(
        np.random.default_rng(SEED + 1), 2, spec.input_height,
        spec.input_width)
    out = {}
    for d in ("cpu", dev):
        m = registry.build_module(spec, torch.float32)
        m.load_state_dict(sd)
        m.to(d).train()
        step = train.make_train_step(spec, m, train.make_optimizer(
            m.parameters()))
        # float32 is this comparison's configuration, not the Trainer's
        # (bf16 convs): TF32 is switched off for it here
        with precision.full_f32():
            loss = step(torch.from_numpy(imgs).to(d),
                        torch.from_numpy(labels).to(d))
        out[str(d)] = (float(loss), {
            n: (p.detach().cpu(), p.grad.detach().cpu())
            for n, p in m.named_parameters()})
    (loss_cpu, cpu), (loss_gpu, gpu) = out["cpu"], out[str(dev)]
    loss_rel = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    g_scale = max(float(g.abs().max()) for _, g in cpu.values())
    g_err = {n: float((gpu[n][1] - g).abs().max())
             for n, (_, g) in cpu.items()}
    grad_err = max(g_err.values()) / g_scale
    d_all, d_cond, n_small, n_big = 0.0, 0.0, 0, 0
    for n, (p, g) in cpu.items():
        diff = (gpu[n][0] - p).abs()
        small = g.abs() < GRAD_FLOOR
        d_all = max(d_all, float(diff.max()))
        if not bool(small.all()):
            d_cond = max(d_cond, float(diff[~small].max()))
        n_small += int(small.sum())
        n_big += int((diff > PARAM_ATOL).sum())
    n_params = sum(p.numel() for p, _ in cpu.values())
    details["train_parity"] = {
        "loss_cpu": loss_cpu, "loss_card": loss_gpu, "loss_rel": loss_rel,
        "grad_rel_err": grad_err, "max_dparam": d_all,
        "max_dparam_grad_above_floor": d_cond, "grad_floor": GRAD_FLOOR,
        "n_grad_below_floor": n_small, "n_dparam_above_atol": n_big,
        "n_params": n_params, "grad_scale": g_scale,
        "grad_err_top": sorted(
            ({"param": n, "max_abs_err": e,
              "max_abs_grad": float(cpu[n][1].abs().max())}
             for n, e in g_err.items()), key=lambda r: -r["max_abs_err"])[:8]}
    print(f"train step card vs cpu (f32, TF32 off, batch 2 at "
          f"{spec.input_height}x{spec.input_width}): loss "
          f"{loss_gpu:.7f} vs {loss_cpu:.7f} (rel {loss_rel:.3g}); grad "
          f"max |err| / max |g| {grad_err:.3g}; max |dparam| {d_all:.3g} "
          f"over {n_params} params, {d_cond:.3g} where |g| >= "
          f"{GRAD_FLOOR:g} ({n_small} below), {n_big} above {PARAM_ATOL:g}",
          flush=True)
    for r in details["train_parity"]["grad_err_top"][:3]:
        print(f"  gradient error {r['max_abs_err']:.3g} in {r['param']} "
              f"(its max |g| {r['max_abs_grad']:.3g})", flush=True)
    if not (loss_rel <= LOSS_RTOL and grad_err <= GRAD_RTOL
            and d_cond <= PARAM_ATOL):
        raise AssertionError(
            f"train step parity: loss rel {loss_rel:.3g} (tol {LOSS_RTOL}), "
            f"grad {grad_err:.3g} (tol {GRAD_RTOL}), dparam {d_cond:.3g} "
            f"(tol {PARAM_ATOL})")


def train_phase(dev, details):
    """(b) The Trainer at full width, bf16 convs, batch 8: device ms per
    step, host data ms per batch, peak memory; the loss must fall."""
    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models import registry
    from sbb_textline_detection_tpu_torch.training import data, train
    from sbb_textline_detection_tpu_torch.utils import synthetic

    spec = registry.DUALHEAD_SPEC
    it = data.synthetic_batches("dualhead", 8, spec.input_height,
                                spec.input_width, SEED)
    pool_was_built = synthetic._PAGE_POOL is not None
    batches, secs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        batches.append(next(it))
        secs.append(time.perf_counter() - t0)
    if synthetic._PAGE_POOL is None:
        raise AssertionError("no page crop was drawn: the pool is empty")
    data_ms = 1e3 * sum(secs[1:]) / (len(secs) - 1)
    print(f"dual-head data (host, batch 8 at {spec.input_height}x"
          f"{spec.input_width}): first batch {secs[0]:.2f} s"
          + ("" if pool_was_built else
             f" (the page-pool render of {len(synthetic._PAGE_POOL)} "
             "pages included)")
          + f", then {data_ms:.1f} ms per batch", flush=True)

    tr = train.Trainer(spec, 3e-4, SEED, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = tr.train(iter(batches[:TRAIN_WARMUP]), TRAIN_WARMUP)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    losses += tr.train(iter(batches[TRAIN_WARMUP:]),
                       TRAIN_STEPS - TRAIN_WARMUP)
    end.record()
    torch.cuda.synchronize()
    n = TRAIN_STEPS - TRAIN_WARMUP
    step_ms = start.elapsed_time(end) / n
    wall_ms = 1e3 * (time.perf_counter() - t0) / n
    peak = torch.cuda.max_memory_allocated(dev)
    del batches

    t0 = time.perf_counter()
    tr.train(it, STREAM_STEPS)
    stream_ms = 1e3 * (time.perf_counter() - t0) / STREAM_STEPS
    prof = _profiled(lambda: tr.train(it, PROFILE_STEPS))
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    details["train"] = {
        "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP, "batch": 8,
        "step_ms": step_ms, "step_wall_ms": wall_ms,
        "data_ms_per_batch": data_ms, "first_batch_s": secs[0],
        "stream_ms_per_step": stream_ms, "peak_bytes": peak,
        "losses": losses, "profile": {
            "steps": PROFILE_STEPS, "wall_s": prof[0], "device_s": prof[1],
            "top_ops": prof[2][:25]}}
    print(f"dual-head training (bf16 convs, batch 8 at {spec.input_height}"
          f"x{spec.input_width}): "
          f"{step_ms:.2f} ms per step on the card over {n} steps (host "
          f"wall {wall_ms:.2f} ms), {stream_ms:.1f} ms per step with the "
          f"data drawn in the loop; peak memory {peak / 2**30:.2f} GiB; "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 10 "
          f"{first:.4f}, of the last 10 {last:.4f})", flush=True)
    _print_profile(f"{PROFILE_STEPS} streamed training steps", *prof)
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError("the training loss did not fall")


def _cap_spied(det):
    """Record, for each resident_dispatch of `det`'s deskew engine, the
    largest region box (h, w) against the buffer cap (h, w) of its canvas
    (a region above the cap makes the chain raise, and the page takes the
    host sweep)."""
    eng = det.deskew
    real = eng.resident_dispatch
    det.cap_calls = []

    def resident_dispatch(mask_dev, boxes_xywh):
        if len(boxes_xywh):
            det.cap_calls.append((
                max(int(b[3]) for b in boxes_xywh),
                max(int(b[2]) for b in boxes_xywh),
                eng.resident_buffer_shape(tuple(mask_dev.shape))))
        return real(mask_dev, boxes_xywh)

    eng.resident_dispatch = resident_dispatch
    return det


def _pack_checkpoints(ckpt, details_path):
    """Pack the bench checkpoints beside `details_path`
    (checkpoint.pack_dir), for scripts/trained_parity.py's comparison with
    the JAX package on the CPU; dropped when larger than BENCH_PACK_MAX."""
    from sbb_textline_detection_tpu_torch.models import checkpoint

    path = os.path.join(os.path.dirname(os.path.abspath(details_path)),
                        "bench_ckpts.npz")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    size = checkpoint.pack_dir(ckpt, path)
    if size > BENCH_PACK_MAX:
        os.remove(path)
        print(f"the packed bench checkpoints take {size} bytes, above "
              f"{BENCH_PACK_MAX}: not kept", flush=True)
        return None
    print(f"bench checkpoints packed into {path} ({size} bytes)", flush=True)
    return {"path": path, "bytes": size}


def bench_phase(dev, details, details_path=None):
    """The port's bench at its full recipe: ensure_bench_checkpoints trains
    the page model for BENCH_TRAIN_STEPS steps and the dual-head model for
    6x as many on the card (from nothing: the cache directory is emptied
    first), then warm_up, the warm pass and the timed process_batch of
    BENCH_PAGES hard_mix pages under DEFAULT_CONFIG (the reference's
    deskew cap of 2816), and the quality score. Its JSON line is printed.
    It fails on fewer results than pages or results out of order, a
    degraded page, a fallback other than host_sweep (a region above the
    cap), a PAGE-XML that does not parse, or a quality value that is not
    finite; the gates are printed beside BENCH_r05.json's TPU figures.
    Then one page more under torch.profiler (profile_phase): the card's
    idle share on a trained page, and the Radon kernel on that page's
    canvases. Returns (Radon launches of the served passes, the checkpoint
    directory)."""
    import math
    import shutil
    import xml.etree.ElementTree as ET

    from sbb_textline_detection_tpu_torch import bench
    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)
    from sbb_textline_detection_tpu_torch.utils import synthetic

    # the dual-head stream builds its page-crop pool from its own rng at
    # its first page crop; a pool another phase built would change the
    # stream that follows
    if synthetic._PAGE_POOL is not None:
        raise AssertionError("the page-crop pool exists before the bench "
                             "trains: its data would differ from a fresh "
                             "process's")
    ckpt = os.path.join(ROOT, "build", "bench_ckpts")
    shutil.rmtree(ckpt, ignore_errors=True)
    # each role's initial state, hashed as the Trainer draws it
    drawn = {}
    draw = registry.init_variables

    def hashed_draw(spec, seed=0):
        sd = draw(spec, seed)
        drawn[spec.name] = {"seed": seed,
                            "sha256": checkpoint.state_sha256(sd)}
        return sd

    registry.init_variables = hashed_draw
    t0 = time.time()
    try:
        bench.ensure_bench_checkpoints(ckpt, BENCH_TRAIN_STEPS, device=dev)
    finally:
        registry.init_variables = draw
    train_s = time.time() - t0
    print(f"bench checkpoints trained in {train_s:.1f} s "
          f"({BENCH_TRAIN_STEPS} page-model steps, "
          f"{6 * BENCH_TRAIN_STEPS} dual-head steps, batch 8)", flush=True)
    pinned = {name: {"seed": 0, "sha256": h}
              for name, h in INIT_SHA256.items()}
    for name, d in drawn.items():
        same = "equal to" if d == pinned.get(name) else "NOT"
        print(f"bench initial state {name} (seed {d['seed']}): sha256 "
              f"{d['sha256']}, {same} the pinned seed-0 draw", flush=True)
    models = ModelBundle.from_dir(ckpt, DEFAULT_CONFIG.runtime, dev,
                                  DEFAULT_CONFIG.model_names)
    det = _cap_spied(TextlineDetector(models, DEFAULT_CONFIG))
    mix = bench.bench_mix(BENCH_PAGES)
    pages, layouts = bench.bench_pages(BENCH_PAGES, *WARM_HW)
    radon.launches = 0
    served = bench.serve(det, pages, *WARM_HW)
    launches = radon.launches
    scores = bench.page_scores(served, layouts)
    out = bench.result(served, scores, layouts, mix)
    print(json.dumps(out), flush=True)

    results = served.results
    names = [ET_page_name(r) for r in results]
    want = [f"bench_{i}.png" for i in range(BENCH_PAGES)]
    cap = DEFAULT_CONFIG.runtime.deskew_buf_max
    # the dispatch that held the largest region, with the buffer it had
    largest_h, largest_w, largest_buf = max(
        det.cap_calls, key=lambda c: max(c[0], c[1]),
        default=(0, 0, (0, 0)))
    over = sum(h > ch or w > cw for h, w, (ch, cw) in det.cap_calls)
    rows = [{"skew": m[0], "regions": len(r.contours),
             "lines": sum(len(t) for t in r.textlines),
             "seconds": r.timings.get("total"), "timings": r.timings,
             "device_timings": r.device_timings, "flops": r.flops,
             "region_recall": sc.region_recall,
             "region_precision": sc.region_precision,
             "line_count_mae": sc.line_count_mae,
             "line_recall": sc.line_recall}
            for r, sc, m in zip(results, scores, mix)]
    gates = [{"key": k, "op": op, "limit": lim, "value": out["quality"][k],
              "met": (out["quality"][k] >= lim if op == ">="
                      else out["quality"][k] <= lim),
              "tpu_r05": BENCH_R05_TPU[k]} for k, op, lim in BENCH_GATES]
    details["bench"] = {
        "result": out, "train_seconds": train_s, "pages": rows,
        "seconds": served.seconds, "warm_up": served.warm_timings,
        "warm_page_walls": served.warm_page_walls,
        "warm_up_seconds": served.warm_up_seconds,
        "radon_launches": launches, "fallbacks": dict(det.fallbacks),
        "degraded": det.degraded, "gates": gates,
        "init_sha256": drawn,
        "resident_dispatches": len(det.cap_calls),
        "over_cap_dispatches": over,
        "largest_region_hw": [largest_h, largest_w],
        "largest_region_buffer_hw": list(largest_buf),
        "deskew_buf_max": cap}
    print(f"bench ({BENCH_PAGES} hard_mix pages at {WARM_HW[0]}x"
          f"{WARM_HW[1]}, DEFAULT_CONFIG): {out['value']} pages/s, p50 "
          f"{out['p50_latency_ms']} ms, warm-up {out['warm_up_seconds']} s, "
          f"{out['regions_total']} regions and {out['lines_total']} lines, "
          f"{launches} radon launches", flush=True)
    print(f"bench deskew: {len(det.cap_calls)} resident dispatches, {over} "
          f"with a region above the cap; largest region {largest_h}x"
          f"{largest_w} in a buffer of {largest_buf[0]}x{largest_buf[1]} "
          f"(deskew_buf_max {cap}); "
          f"host_sweep fallbacks {det.fallbacks.get('host_sweep', 0)}",
          flush=True)
    for g in gates:
        print(f"bench gate {g['key']} {g['op']} {g['limit']}: "
              f"{g['value']} ({'met' if g['met'] else 'NOT met'}; the JAX "
              f"package's TPU run, BENCH_r05.json: {g['tpu_r05']})",
              flush=True)
    if BENCH_SPECK_PAGE < len(rows):
        p6 = rows[BENCH_SPECK_PAGE]
        print(f"bench page {BENCH_SPECK_PAGE}: {p6['regions']} regions, "
              f"precision {p6['region_precision']}, recall "
              f"{p6['region_recall']}", flush=True)
    print(f"bench line recall {out['quality']['line_recall']} (TPU r05 "
          f"{BENCH_R05_TPU['line_recall']}), vertical "
          f"{out['quality']['line_recall_vertical']} (TPU r05 "
          f"{BENCH_R05_TPU['line_recall_vertical']})", flush=True)

    if drawn != pinned:
        raise AssertionError(f"the bench's initial states {drawn} are not "
                             f"the pinned seed-0 draws {pinned}")
    if names != want:
        raise AssertionError(f"bench results {names}, expected {want}")
    if det.degraded or any(r.degraded for r in results):
        raise AssertionError("a bench page degraded")
    if set(det.fallbacks) - {"host_sweep"}:
        raise AssertionError(f"the bench fell back: {dict(det.fallbacks)}")
    for r in results:
        ET.fromstring(ET.tostring(r.xml_tree.getroot()))
    for k, v in out["quality"].items():
        if not isinstance(v, list) and not math.isfinite(v):
            raise AssertionError(f"bench quality {k} is {v}")
    if launches < 1:
        raise AssertionError("the bench launched no Radon kernel")

    del det.deskew.resident_dispatch
    profile_phase(det, (pages[BENCH_PROFILED_PAGE],
                        f"bench_{BENCH_PROFILED_PAGE}.png"), details,
                  key="bench_profile")
    if details_path:
        details["bench"]["packed"] = _pack_checkpoints(ckpt, details_path)
    return launches, ckpt


def serve_trained_phase(dev, details, ckpt, random_regions):
    """(c) The bench checkpoints (bench_phase), loaded by
    ModelBundle.from_dir, serve one A4 page under the serving config."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG, TextlineDetector)
    from sbb_textline_detection_tpu_torch.training import eval as layout_eval
    from sbb_textline_detection_tpu_torch.utils import synthetic

    models = ModelBundle.from_dir(ckpt, DEFAULT_CONFIG.runtime, dev,
                                  DEFAULT_CONFIG.model_names)
    det = TextlineDetector(models, _serve_config())
    img, layout = synthetic.make_page(np.random.default_rng(SEED), 3508,
                                      2480, skew_deg=SKEWS[0])
    radon.launches = 0
    t0 = time.time()
    res = det.process_image(img, "a4_trained.png")
    sec = time.time() - t0
    launches = radon.launches
    score = layout_eval.evaluate_layout(res, layout)
    details["serve_trained"] = {
        "seconds": sec,
        "regions": len(res.contours), "random_weight_regions":
        random_regions, "radon_launches": launches,
        "degraded": res.degraded, "region_recall": score.region_recall,
        "region_precision": score.region_precision,
        "timings": res.timings}
    print(f"bench checkpoints ({BENCH_TRAIN_STEPS} page-model steps, "
          f"{6 * BENCH_TRAIN_STEPS} dual-head steps) serve a4_trained.png: "
          f"{sec:.2f} s, "
          f"{len(res.contours)} regions (random weights: "
          f"{', '.join(map(str, random_regions))}), region recall "
          f"{score.region_recall:.3f}, precision "
          f"{score.region_precision:.3f}, {launches} radon launches",
          flush=True)
    if det.degraded:
        raise AssertionError("the page served by the trained checkpoints "
                             "degraded")
    _no_fallbacks(det, "the page served by the trained checkpoints")
    return launches


def ab_phase(dev, details, ckpt):
    """(11) The A/B harness (sbb_textline_detection_tpu_torch/ab.py) on the
    bench checkpoints and the BENCH_PAGES hard_mix pages: the spec and the
    paths study's output checks (each arm warmed and served once, no timed
    round), then one round of the workers study with its serial and its
    default arm. It fails when the spec study's slopes are not bit-equal
    (ab.SlopesDiffer), an arm degrades a page or falls back, or a PAGE-XML
    does not parse. Returns the Radon launches of its servings."""
    from sbb_textline_detection_tpu_torch import ab, bench
    from sbb_textline_detection_tpu_torch.ops import radon

    t0 = time.time()
    models = ab.load_bundle(ckpt, BENCH_TRAIN_STEPS, dev)
    pages, layouts = bench.bench_pages(BENCH_PAGES, *WARM_HW)
    radon.launches = 0
    records = [ab.run_study(ab.STUDIES[name], models, pages, layouts,
                            rounds, arms, device=dev)
               for name, rounds, arms in (("spec", 0, None),
                                          ("paths", 0, None),
                                          ("workers", 1, ("serial", "w2")))]
    launches = radon.launches
    seconds = time.time() - t0
    details["ab"] = {"seconds": seconds, "radon_launches": launches,
                     "records": records}
    for rec in records:
        for arm, rows in rec["checks"].items():
            moved = [r["mask_moved"] for r in rows]
            print(f"ab {rec['study']} {arm} vs {rec['default']} on "
                  f"{len(rows)} hard_mix pages: slopes equal on "
                  f"{sum(r['slopes_equal'] for r in rows)}, PAGE-XML equal "
                  f"on {sum(r['xml_equal'] for r in rows)}, region mask "
                  f"moved at most {max(moved):.6f}", flush=True)
    work = records[-1]
    print("ab workers, one round: " + ", ".join(
        f"{n} {work['rounds'][0]['min_seconds'][n]:.3f} s "
        f"({work['pages_per_s'][n]:.3f} pages/s, p50 {work['p50_ms'][n]:.1f}"
        " ms)" for n in work["arms"]) + f"; ab phase {seconds:.1f} s, "
        f"{launches} radon launches", flush=True)
    bad = [f"{r['study']}: {b}" for r in records for b in ab.clean(r)]
    if bad:
        raise AssertionError("the A/B phase: " + "; ".join(bad))
    if launches < 1:
        raise AssertionError("the A/B phase launched no Radon kernel")
    return launches


def _within(points, parent, tol=1.0):
    """Every vertex of `points` inside the convex hull of `parent` (the
    window the merge clips to) or within `tol` pixels of its edges (the
    merge rounds clipped vertices to whole pixels)."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.ops import contours
    from sbb_textline_detection_tpu_torch.ops import polygon

    hull = polygon.convex_hull(parent)
    pts = np.asarray(points, float)
    inside = contours.points_in_polygon(hull, pts[:, 0], pts[:, 1])
    a, b = hull, np.roll(hull, -1, axis=0)
    ab = b - a
    t = np.clip(((pts[:, None] - a) * ab).sum(-1)
                / np.maximum((ab * ab).sum(-1), 1e-12), 0, 1)
    dist = np.linalg.norm(pts[:, None] - (a + t[..., None] * ab), axis=-1)
    return bool(np.all(inside | (dist.min(1) <= tol)))


def _merged_coords(root):
    """(Border points, [(region id, points, [line points])]) of a merged
    PAGE document, as float arrays."""
    from sbb_textline_detection_tpu_torch.ocrd import merge

    page = merge.find_child(root, "Page")
    border = merge.find_child(page, "Border")

    def pts(el):
        return merge.points_to_polygon(
            merge.find_child(el, "Coords").get("points"))

    return (None if border is None else pts(border),
            [(r.get("id"), pts(r), [pts(tl) for tl in
                                    merge.find_children(r, "TextLine")])
             for r in merge.find_children(page, "TextRegion")])


def ocrd_phase(dev, details):
    """The OCR-D processor of the port on the card, through the stub OCR-D
    framework of tests/ocrd_stub.py: the full-width random-weight bundle
    saved as .npz and loaded through the `model` parameter, two A4 pages
    (one as scanned, one the crop at OCRD_CROP of a larger scan). Returns
    the Radon launches of the two pages."""
    import tempfile
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.ocrd import merge, processor
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.utils import synthetic

    # by its path: another `tests` package may come first on sys.path
    stub_spec = importlib.util.spec_from_file_location(
        "ocrd_stub", os.path.join(ROOT, "tests", "ocrd_stub.py"))
    ocrd_stub = importlib.util.module_from_spec(stub_spec)
    stub_spec.loader.exec_module(ocrd_stub)
    cfg = _serve_config()
    names = cfg.model_names
    pages = []
    for i, skew in enumerate(SKEWS[:2]):
        img, _ = synthetic.make_page(np.random.default_rng(SEED + 40 + i),
                                     3508, 2480, skew_deg=skew)
        pages.append(img)
    y0, x0 = OCRD_CROP
    h, w = pages[1].shape[:2]
    scan = np.full((h + 2 * y0, w + 2 * x0, 3), 200, np.uint8)
    scan[y0:y0 + h, x0:x0 + w] = pages[1]
    stub_pages = [("PHYS_0001", pages[0], None),
                  ("PHYS_0002", scan, (y0, x0, h, w))]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        model_dir = os.path.join(tmp, "models")
        os.makedirs(model_dir)
        for spec, name in ((registry.DEFAULT_SPECS["page"], names.page),
                           (registry.DUALHEAD_SPEC, names.dualhead)):
            checkpoint.save(checkpoint.npz_path(model_dir, name), spec,
                            checkpoint.random_init(
                                spec, torch.Generator().manual_seed(SEED)))
        ws = ocrd_stub.StubWorkspace(tmp, stub_pages)
        cwd = os.getcwd()
        os.chdir(tmp)
        with ocrd_stub.installed():
            try:
                proc = processor.OcrdSbbTextlineDetectorRecognize(
                    ws, ocrd_stub.INPUT_GRP, "OCR-D-SEG",
                    {"model": model_dir}, config=cfg, device=dev)
                det = proc._get_detector(model_dir)
                per_page, merge_s = [], []
                real_process, real_merge = (det.process_image,
                                            merge.merge_detection_into_page)

                def process_image(img, name):
                    torch.cuda.synchronize()
                    radon.launches = 0
                    t0 = time.time()
                    res = real_process(img, name)
                    torch.cuda.synchronize()
                    per_page.append({"seconds": time.time() - t0,
                                     "radon_launches": radon.launches,
                                     "degraded": res.degraded,
                                     "regions": len(res.contours),
                                     "xml": res.xml_tree.getroot()})
                    return res

                def merge_into(*a, **k):
                    t0 = time.time()
                    out = real_merge(*a, **k)
                    merge_s.append(time.time() - t0)
                    return out

                det.process_image = process_image
                merge.merge_detection_into_page = merge_into
                t0 = time.time()
                proc.process()
                total = time.time() - t0
            finally:
                merge.merge_detection_into_page = real_merge
                os.chdir(cwd)
        docs = [ET.parse(path).getroot() for path in ws.added]
    tool = next(iter(processor.ocrd_tool()["tools"]))
    for i, (root, row) in enumerate(zip(docs, per_page)):
        page = merge.find_child(root, "Page")
        borders = merge.find_children(page, "Border")
        ro = merge.find_child(page, "ReadingOrder")
        refs = [el.get("regionRef") for el in ro.iter()
                if el.get("regionRef")] if ro is not None else []
        border, regions = _merged_coords(root)
        ids = [rid for rid, _, _ in regions]
        steps = [el for el in root.iter() if el.tag.endswith("MetadataItem")
                 and el.get("type") == "processingStep"
                 and el.get("value") == tool]
        lines_in = all(_within(line, reg) for _, reg, lines in regions
                       for line in lines)
        regions_in = border is not None and all(
            _within(reg, border) for _, reg, _ in regions)
        row.update({"page": stub_pages[i][0], "borders": len(borders),
                    "regions_kept": len(ids), "refs_equal_ids":
                    sorted(refs) == sorted(ids) and len(refs) == len(ids),
                    "processing_steps": len(steps), "lines_within_regions":
                    lines_in, "regions_within_border": regions_in,
                    "textlines": sum(len(lines) for _, _, lines in regions),
                    "merge_seconds": merge_s[i]})
        print(f"ocrd {row['page']}: {row['seconds']:.2f} s detection, "
              f"{merge_s[i] * 1e3:.1f} ms merge, {row['regions']} regions "
              f"detected, {len(ids)} kept with {row['textlines']} lines, "
              f"{row['radon_launches']} radon launches; one Border "
              f"{len(borders) == 1}, ReadingOrder refs = region ids "
              f"{row['refs_equal_ids']}, processing step "
              f"{len(steps) == 1}, lines within regions {lines_in}, "
              f"regions within the Border {regions_in}", flush=True)
        if not (len(borders) == 1 and row["refs_equal_ids"] and ids
                and len(steps) == 1 and lines_in and regions_in):
            raise AssertionError(f"ocrd {row['page']}: merged PAGE fails "
                                 "its checks")
        if row["radon_launches"] == 0 or row["degraded"]:
            raise AssertionError(f"ocrd {row['page']}: no radon launch or "
                                 "degraded")
    # the cropped page: its merged coordinates are the detector's own
    # moved by the crop's offset, as merging the detector's PAGE-XML with
    # every point moved by the offset (and no transform) into the scan's
    # page gives them: both clip in the scan's frame
    import copy

    moved = copy.deepcopy(per_page[1]["xml"])
    for el in moved.iter():
        if el.tag.split("}")[-1] == "Coords":
            pts = merge.points_to_polygon(el.get("points")) + [x0, y0]
            el.set("points", merge.polygon_to_points(pts))
    own = ET.Element(f"{{{ocrd_stub.NS}}}PcGts")
    own_page = ET.SubElement(own, f"{{{ocrd_stub.NS}}}Page")
    own_page.set("imageHeight", str(scan.shape[0]))
    own_page.set("imageWidth", str(scan.shape[1]))
    merge.merge_detection_into_page(own, moved)
    want_border, want = _merged_coords(own)
    got_border, got = _merged_coords(docs[1])
    shifted = (np.array_equal(got_border, want_border)
               and len(got) == len(want) and all(
                   gid == wid and np.array_equal(g, w) and len(gl) == len(wl)
                   and all(np.array_equal(a, b) for a, b in zip(gl, wl))
                   for (gid, g, gl), (wid, w, wl) in zip(got, want)))
    print(f"ocrd: the cropped page's coordinates are the detector's own "
          f"plus the offset (x, y) = ({x0}, {y0}): {shifted}; "
          f"{total:.2f} s for both pages through process()", flush=True)
    if not shifted:
        raise AssertionError("ocrd: the cropped page's coordinates are not "
                             "the detector's own plus the offset")
    if det.degraded:
        raise AssertionError("ocrd: a page degraded")
    _no_fallbacks(det, "the OCR-D pages")
    for row in per_page:
        del row["xml"]
    details["ocrd"] = {"pages": per_page, "seconds": total,
                       "crop_offset_yx": [y0, x0]}
    return sum(row["radon_launches"] for row in per_page)


def _served(det, pages, warm=None):
    """process_batch over `pages` after one untimed warm-up page:
    (results, region masks, seconds, Radon launches)."""
    import torch

    from sbb_textline_detection_tpu_torch.ops import radon

    if warm is not None:
        det.process_image(*warm)
    masks = []
    real = det.host_phase

    def host_phase(st, pre=None):
        masks.append(st.region_mask)
        return real(st, pre)

    det.host_phase = host_phase
    try:
        torch.cuda.synchronize()
        radon.launches = 0
        t0 = time.time()
        results = list(det.process_batch(iter(pages)))
        torch.cuda.synchronize()
        return results, masks, time.time() - t0, radon.launches
    finally:
        del det.host_phase


def mesh_phase(dev, details, pages):
    """(a) The serving mesh: max(2, cards) data members (on one card, two
    members on it), the three SKEWS pages through process_batch under
    mesh_auto_group, against the unmeshed bundle in groups of the same
    size: float32 (TF32 off) must give equal region masks and PAGE-XML,
    bf16 prints the share of differing region-mask pixels. (An A4 page
    has n > tile_chunk tiles, so the unmeshed page runs in chunks of
    ceil(n / 2) too: both runs feed cuDNN the same batches, and only the
    member that runs a chunk differs.) (b) The training
    mesh: one sharded AdamW step of the full-width dual-head model, batch
    8, in a world-size-1 NCCL group on a (1, 1) mesh, against the plain
    step. Returns the Radon launches of the served pages."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from sbb_textline_detection_tpu_torch.models import checkpoint, registry
    from sbb_textline_detection_tpu_torch.models.runner import ModelBundle
    from sbb_textline_detection_tpu_torch.ops import precision
    from sbb_textline_detection_tpu_torch.parallel import mesh as mesh_mod
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        DEFAULT_CONFIG, TextlineDetector)
    from sbb_textline_detection_tpu_torch.training import train
    from sbb_textline_detection_tpu_torch.utils import synthetic

    cards = torch.cuda.device_count()
    members = max(2, cards)
    mesh = mesh_mod.make_mesh([torch.device("cuda", i % cards)
                               for i in range(members)])
    print(f"mesh: {members} data members on {cards} card(s): "
          f"{[str(d) for d in mesh.data_members]}"
          + (" (one card: its members take turns on it, so no multi-card "
             "figure comes from this run)" if cards == 1 else ""),
          flush=True)
    total_launches = 0
    out = {"members": [str(d) for d in mesh.data_members], "runs": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        runs = {}
        for meshed in (False, True):
            models = ModelBundle.random_init(
                DEFAULT_CONFIG.runtime, seed=SEED, device=dev, dtype=dtype,
                dual_head=True, mesh=mesh if meshed else None)
            flags = {} if meshed else {"pages_per_dispatch": members}
            det = TextlineDetector(models, _serve_config(**flags))
            group = det._effective_group_size()
            if group != members:
                raise AssertionError(f"mesh {name}: group size {group} != "
                                     f"{members}")
            res, masks, sec, launches = _served(det, pages, pages[0])
            total_launches += launches
            if det.degraded or any(r.degraded for r in res):
                raise AssertionError(f"mesh {name}: a page degraded")
            _no_fallbacks(det, f"the mesh phase's {name} pages")
            if launches == 0:
                raise AssertionError(f"mesh {name}: no radon launch")
            runs[meshed] = (res, masks, sec, launches)
        (r0, m0, s0, l0), (r1, m1, s1, l1) = runs[False], runs[True]
        margin = DEFAULT_CONFIG.tiling.margin_ratio
        tiles = [int(np.prod(models.region.grid_for(
            r.page_coord[1] - r.page_coord[0],
            r.page_coord[3] - r.page_coord[2], margin))) for r in r1]
        shares = [_mask_diff_share(a, ra.page_coord, b, rb.page_coord)
                  for a, b, ra, rb in zip(m1, m0, r1, r0)]
        xml_equal = [_xml_body(a) == _xml_body(b) for a, b in zip(r1, r0)]
        masks_equal = [a.shape == b.shape and bool(np.array_equal(a, b))
                       for a, b in zip(m1, m0)]
        out["runs"][name] = {
            "seconds_unmeshed": s0,
            "seconds_meshed": s1, "pages_per_s_unmeshed": len(pages) / s0,
            "pages_per_s_meshed": len(pages) / s1, "mask_diff_share": shares,
            "masks_equal": masks_equal, "xml_equal": xml_equal,
            "regions": [len(r.contours) for r in r1], "tiles": tiles,
            "radon_launches": [l0, l1]}
        print(f"mesh {name}, {len(pages)} pages of {tiles} tiles in "
              f"groups of {members}: unmeshed {len(pages) / s0:.3f} pages/s, "
              f"meshed {len(pages) / s1:.3f} pages/s on "
              f"{details['card']}; region masks equal {masks_equal}, "
              f"PAGE-XML equal {xml_equal}, share of differing region-mask "
              f"pixels {[f'{x:.3g}' for x in shares]}", flush=True)
        if dtype == torch.float32 and not (all(masks_equal)
                                           and all(xml_equal)):
            raise AssertionError("mesh f32: the meshed pages differ from "
                                 "the unmeshed ones")

    # (b) the training mesh in a world-size-1 NCCL group
    spec = registry.DUALHEAD_SPEC
    sd = checkpoint.random_init(spec, torch.Generator().manual_seed(SEED))
    imgs, labels = synthetic.dualhead_batch(
        np.random.default_rng(SEED + 3), 8, spec.input_height,
        spec.input_width)
    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    results = {}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            pmesh = mesh_mod.make_process_mesh(1, "cuda")
            # both steps take cuDNN's deterministic algorithms, so that
            # only the mesh can make them differ
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            for sharded in (False, True):
                m = registry.build_module(spec, torch.float32)
                m.load_state_dict(sd)
                m.to(dev).train()
                if sharded:
                    mesh_mod.shard_module(m, pmesh)
                step = train.make_train_step(
                    spec, m, train.make_optimizer(m.parameters()),
                    mesh=pmesh if sharded else None)
                with precision.full_f32():
                    torch.cuda.synchronize()
                    t0 = time.time()
                    loss = float(step(torch.from_numpy(imgs).to(dev),
                                      torch.from_numpy(labels).to(dev)))
                    torch.cuda.synchronize()
                    sec = time.time() - t0
                state = (mesh_mod.gather_state_dict(m, pmesh) if sharded
                         else m.state_dict())
                results[sharded] = (loss, {k: v.detach().clone()
                                           for k, v in state.items()}, sec,
                                    len(getattr(m, "tp_sharded", ())))
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = saved
            dist.destroy_process_group()
    (loss0, st0, sec0, _), (loss1, st1, sec1, n_sharded) = (results[False],
                                                            results[True])
    loss_rel = abs(loss1 - loss0) / abs(loss0)
    param_rel = max(float(((st1[k] - v).abs()
                           / v.abs().clamp_min(1e-30)).max())
                    for k, v in st0.items())
    out["train"] = {"loss_plain": loss0, "loss_mesh": loss1,
                    "loss_rel": loss_rel, "max_param_rel": param_rel,
                    "step_s_plain": sec0, "step_s_mesh": sec1,
                    "sharded_params": n_sharded, "batch": 8}
    print(f"mesh train: one AdamW step of {spec.name} (f32, TF32 off, "
          f"batch 8 at {spec.input_height}x{spec.input_width}) on the "
          f"(1, 1) NCCL mesh, {n_sharded} parameters column-parallel: loss "
          f"{loss1:.7f} vs plain {loss0:.7f} (rel {loss_rel:.3g}), largest "
          f"relative parameter difference {param_rel:.3g}; step "
          f"{sec1:.3f} s vs {sec0:.3f} s (first steps, cold)", flush=True)
    if not (loss_rel <= MESH_TRAIN_RTOL and param_rel <= MESH_TRAIN_RTOL):
        raise AssertionError(f"mesh train: the (1, 1) mesh step differs "
                             f"from the plain one (loss rel {loss_rel:.3g},"
                             f" params {param_rel:.3g}; limit "
                             f"{MESH_TRAIN_RTOL:g})")
    if cards >= 2:
        t0 = time.time()
        run = subprocess.run(
            [sys.executable, "-m",
             "sbb_textline_detection_tpu_torch.parallel.dryrun",
             "--devices", "2", "--backend", "nccl"], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        print(run.stdout.strip(), flush=True)
        if run.returncode != 0:
            raise AssertionError(f"parallel.dryrun on 2 cards failed: "
                                 f"{run.stderr[-2000:]}")
        out["dryrun_seconds"] = time.time() - t0
    else:
        print("mesh: parallel.dryrun --devices 2 --backend nccl skipped: "
              "this machine has one card, and NCCL needs a card per "
              "process", flush=True)
    details["mesh"] = out
    return total_launches


def _warm_keys(cfg, region):
    """The job keys warm_up must return for the serving smoke's bundle at
    WARM_HW under `cfg` (the raw path primary): the fixed jobs and one
    raw_single_<w> per crop-grid bucket from the typical A4 crop (8 tile
    strides) to the whole working width."""
    import numpy as np

    from sbb_textline_detection_tpu_torch.pipeline import stages

    th, tw = stages.working_dims(np.zeros(WARM_HW + (3,), np.uint8), cfg)
    mw = region.input_hw[1]
    sw = mw - 2 * int(cfg.tiling.margin_ratio * mw)
    widths = {min(tw, nx * sw)
              for nx in range(-(-min(tw, 8 * sw) // sw), -(-tw // sw) + 1)}
    return ({"page_model", "dual_multi", "dual_single", "deskew",
             "headless", "fullfused"}
            | {f"raw_single_{w}" for w in widths})


def warm_child(mode, dev):
    """One child process of warm_phase (`--warm-child warm|cold`): the
    serving smoke's bundle and config; with "warm", warm_up(*WARM_HW)
    first; then the 3 pages by process_image, one at a time, each timed
    to a synchronize. Returns what the parent checks and prints."""
    import hashlib

    import torch

    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)
    from sbb_textline_detection_tpu_torch.utils import host_library_available

    if not host_library_available():
        raise RuntimeError("the host geometry library does not load")
    pages = _smoke_pages()
    t0 = time.time()
    det = TextlineDetector(_serving_bundle(dev), _serve_config())
    torch.cuda.synchronize()
    out = {"mode": mode, "bundle_s": time.time() - t0}
    if mode == "warm":
        radon.launches = 0
        t0 = time.time()
        out["warm_up"] = det.warm_up(*WARM_HW)
        out["warm_up_s"] = time.time() - t0
        out["warm_up_launches"] = radon.launches
        print(f"warm child: warm_up {out['warm_up_s']:.3f} s, "
              f"{out['warm_up_launches']} radon launches: "
              + ", ".join(f"{k} {v:.3f} s"
                          for k, v in out["warm_up"].items()), flush=True)
    out.update(page_s=[], xml_sha256=[], regions=[])
    radon.launches = 0
    for page in pages:
        torch.cuda.synchronize()
        t0 = time.time()
        res = det.process_image(*page)
        torch.cuda.synchronize()
        out["page_s"].append(time.time() - t0)
        out["xml_sha256"].append(hashlib.sha256(_xml_body(res)).hexdigest())
        out["regions"].append(len(res.contours))
        print(f"{mode} child: {page[1]}: {out['page_s'][-1]:.3f} s, "
              f"{len(res.contours)} regions", flush=True)
    out.update(page_launches=radon.launches, fallbacks=dict(det.fallbacks),
               degraded=det.degraded)
    return out


def warm_phase(details, models, results):
    """The warm start: two fresh processes of this script (a fresh process
    is the only way to see a cold CUDA context), one that serves the 3
    smoke pages cold and one that calls warm_up(*WARM_HW) first; both
    must give the PAGE-XML of pipeline_phase's `results` page for page,
    with no fallback and no degraded page, and warm_up must return the
    expected keys and launch the Radon kernel. Then, here, warm_up under
    DEFAULT_CONFIG with and without warm_fallback_programs. Returns the
    Radon launches of all of it."""
    import dataclasses
    import hashlib

    from sbb_textline_detection_tpu_torch.core.config import DEFAULT_CONFIG
    from sbb_textline_detection_tpu_torch.ops import radon
    from sbb_textline_detection_tpu_torch.pipeline.detector import (
        TextlineDetector)

    want = [hashlib.sha256(_xml_body(r)).hexdigest() for r in results]
    runs = {}
    for mode in ("cold", "warm"):
        t0 = time.time()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--warm-child",
             mode], capture_output=True, text=True, cwd=ROOT,
            timeout=WARM_CHILD_TIMEOUT)
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:
            print(f"  {line}", flush=True)
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"warm child {mode!r} exited "
                               f"{proc.returncode}:\n{proc.stderr[-4000:]}")
        run = runs[mode] = json.loads(lines[-1])
        run["process_s"] = time.time() - t0
        if run["xml_sha256"] != want:
            raise AssertionError(
                f"{mode} child: PAGE-XML differs from the batch's on pages "
                f"{[i for i, (a, b) in enumerate(zip(run['xml_sha256'], want)) if a != b]}"
                f" (regions {run['regions']} against "
                f"{[len(r.contours) for r in results]})")
        if run["fallbacks"] or run["degraded"]:
            raise AssertionError(f"{mode} child fell back "
                                 f"{run['fallbacks']} or degraded "
                                 f"{run['degraded']} page(s)")
    warm, cold = runs["warm"], runs["cold"]
    if set(warm["warm_up"]) != _warm_keys(_serve_config(), models.region):
        raise AssertionError(f"warm_up returned {sorted(warm['warm_up'])}")
    if warm["warm_up_launches"] == 0:
        raise AssertionError("warm_up never launched the radon kernel")
    launches = (warm["warm_up_launches"] + warm["page_launches"]
                + cold["page_launches"])

    # here, after every path has run: warm_up under DEFAULT_CONFIG, then
    # with warm_fallback_programs (the canvas-resident rung and the host
    # sweep on top)
    here = {}
    for flag in (False, True):
        cfg = dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
            DEFAULT_CONFIG.runtime, warm_fallback_programs=flag))
        det = TextlineDetector(models, cfg)
        radon.launches = 0
        t0 = time.time()
        timings = det.warm_up(*WARM_HW)
        here[flag] = {"seconds": time.time() - t0, "jobs": timings,
                      "radon_launches": radon.launches}
        launches += radon.launches
        if set(timings) != _warm_keys(cfg, models.region):
            raise AssertionError(f"warm_up returned {sorted(timings)}")
        if det.fallbacks or det.degraded:
            raise AssertionError(f"warm_up counted {dict(det.fallbacks)} "
                                 f"and {det.degraded} degraded")
    details["warm"] = {"children": runs, "here": {
        "default": here[False], "warm_fallback_programs": here[True]}}

    print(f"warm start: warm_up {warm['warm_up_s']:.3f} s in a fresh "
          f"process ({warm['warm_up_launches']} radon launches): "
          + ", ".join(f"{k} {v:.3f}" for k, v in warm["warm_up"].items()),
          flush=True)
    for name, run in (("cold", cold), ("after warm_up", warm)):
        p = run["page_s"]
        print(f"warm start, {name}: first page {p[0]:.3f} s, second "
              f"{p[1]:.3f} s, third {p[2]:.3f} s, first - third "
              f"{p[0] - p[2]:.3f} s (bundle {run['bundle_s']:.3f} s, "
              f"process {run['process_s']:.1f} s)", flush=True)
    print(f"warm start: first page cold {cold['page_s'][0]:.3f} s against "
          f"{warm['page_s'][0]:.3f} s after warm_up; PAGE-XML equal to the "
          f"batch's on 3 of 3 pages in both children, 0 fallbacks, 0 "
          f"degraded", flush=True)
    for flag, name in ((False, "DEFAULT_CONFIG"),
                       (True, "with warm_fallback_programs")):
        h = here[flag]
        print(f"warm_up here, {name}: {h['seconds']:.3f} s, "
              f"{h['radon_launches']} radon launches: "
              + ", ".join(f"{k} {v:.3f}" for k, v in h["jobs"].items()),
              flush=True)
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--details", help="write the run's details (JSON) "
                        "to this path")
    parser.add_argument("--only", choices=["batch", "bench"],
                        help="a shorter run: `batch` leaves out the fallback "
                        "ladder, the classic bundle, the bench and training; "
                        "`bench` runs the kernel phase, the bench and the A/B "
                        "phase only")
    parser.add_argument("--warm-child", choices=["warm", "cold"],
                        help="run as one of warm_phase's child processes "
                        "and print its result as the last line")
    args = parser.parse_args()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs the "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from sbb_textline_detection_tpu_torch.ops import radon
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 1
    if args.warm_child:
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        print(json.dumps(warm_child(args.warm_child, dev)), flush=True)
        return 0

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    details = {"card": smi, "torch": torch.__version__,
               "cuda": torch.version.cuda, "seed": SEED,
               "skews": list(SKEWS)}

    t0 = time.time()
    radon.build()
    details["build_seconds"] = time.time() - t0
    details["ptxas"] = radon.build_log
    print(f"radon kernel built in {details['build_seconds']:.1f} s",
          flush=True)
    build_native(details)

    try:
        return _phases(args, dev, details, torch)
    finally:
        if args.details:
            os.makedirs(os.path.dirname(os.path.abspath(args.details)),
                        exist_ok=True)
            with open(args.details, "w") as f:
                json.dump(details, f, indent=1, default=str)


def _phases(args, dev, details, torch) -> int:
    """Every phase after the builds, then the two result lines."""
    kernel = kernel_phase(dev, details)
    if args.only == "bench":
        launches, ckpt = bench_phase(dev, details, args.details)
        launches += ab_phase(dev, details, ckpt)
    else:
        launches = _serving_phases(args, dev, details)
    print(json.dumps({"kernels": [{
        "name": "radon_pairs", "route": "cuda",
        "source": "sbb_textline_detection_tpu_torch/csrc/radon.cu",
        "replaces": "sbb_textline_detection_tpu/ops/pallas_radon.py:72",
        "launches": launches, "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"], "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
        "library_ms": kernel["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _serving_phases(args, dev, details) -> int:
    """The phases after kernel_phase; their Radon launches."""
    deskew_phase(dev, details)
    unet_phase(dev, details)
    launches, det, pages, results = pipeline_phase(dev, details)
    profile_phase(det, pages[1], details)
    if not args.only:
        launches += warm_phase(details, det.models, results)
        launches += fallback_phase(details, det.models, pages[1])
    radon_busy_phase(det, pages[1], details)
    launches += flags_phase(details, det.models, pages)
    launches += batch_phase(details, det.models)
    random_regions = [p["regions"] for p in details["pages"]]
    del det
    if not args.only:
        # before any other training: the bench's dual-head stream builds
        # the page-crop pool from its own rng, as in a fresh process
        bench_launches, ckpt = bench_phase(dev, details, args.details)
        launches += bench_launches
        launches += ocrd_phase(dev, details)
        launches += mesh_phase(dev, details, pages)
        launches += classic_phase(dev, details)
        train_parity_phase(dev, details)
        train_phase(dev, details)
        launches += serve_trained_phase(dev, details, ckpt, random_regions)
        launches += ab_phase(dev, details, ckpt)
    return launches


if __name__ == "__main__":
    sys.exit(main())
