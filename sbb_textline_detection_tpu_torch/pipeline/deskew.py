"""Deskew angle search and deskewed line profiles (counterpart of
sbb_textline_detection_tpu/pipeline/deskew.py; see that module for the
derivation and the reference quirks the scorer reproduces). Two routes
reach the Radon kernel: the resident chain, and the host sweep that serves
a page when the chain is switched off or fails.

Resident chain.

For each group of up to `region_batch` regions of a page, one chain of
device work reads the textline canvas where the fused segmentation left
it: crop gather -> erode -> sweep canvases -> coarse + vertical Radon
sweeps (ops/radon.py: the hand-written CUDA kernel on the card) -> scores
-> slope decision -> morph OPEN + CLOSE -> exact rotated projections at
the decided slope. The host then fetches one small float32 block per
group: [slope | row profile | col profile] per slot.

The chain's values do not depend on the slot count B or on the crop
buffer's height (the JAX package's _resident_chain docstring), so eager
PyTorch sizes each group's buffer to its largest crop rounded up to 256.
The reference's cap stays: a region taller or wider than
`resident_buffer_shape` (the canvas rounded up to 256, at most `buf_max`,
runtime.deskew_buf_max) raises ValueError where the reference raises, and
the page takes the host sweep. The row and column profiles are rounded at
the buffer's half width / half height (the shear-bin offset K), as in the
JAX program.

Speculative chain (runtime.spec_deskew). Dispatched right behind the
fused segmentation, before the host has the region mask: the region
boxes come from the device (ops/cc.component_boxes_topk on the region
canvas, with pixel-count areas, DEVIATIONS #12), their canvas index maps
are computed on the device (_canvas_maps_graph), and the same chain runs
on `deskew_spec_slots` slots at the largest canvas bucket and one crop
buffer (spec_buffer_shape). The host then matches its contour boxes
against the device boxes BY VALUE (spec_finalize): a slot is used only
for an identical box on the same canvas bucket whose maps equal the host
maps, which makes its slope bit-equal to the ordinary chain's (the Radon
kernel's sums do not depend on the batch, nor on launch order); every
other region goes to an ordinary dispatch. A slot's profiles are rounded
at its own buffer's K, so they agree with the ordinary chain's to f32
rounding where the two buffers differ.

Host sweep (`DeskewEngine.best_angles`). The host renders each region's
eroded crop into an S x S uint8 canvas (`_canvas_into`, the same index
maps as the chain's gather), uploads a group's (R, S, S) canvases to the
engine's device, and there runs the coarse sweep and the vertical sweep as
two Radon launches per group plus the scorer; the host picks the angles.
Every group is dispatched before the first result is fetched. The JAX
package's 1-bit canvas packing and its ahead-of-time program cache are
not carried over: canvases go up as plain uint8 and PyTorch runs eagerly.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.core.config import DeskewConfig
from sbb_textline_detection_tpu_torch.ops import cc as cc_ops
from sbb_textline_detection_tpu_torch.ops import (morphology, precision,
                                                 profiles, radon)
from sbb_textline_detection_tpu_torch.utils import profiling, stagetime

_BUCKETS = (256, 512, 1024, 1536, 2048)


def _hat(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - torch.abs(x), min=0.0)


def _score_profiles_impl(P: torch.Tensor, sigma: float = 2.0,
                         multiplier: float = 20.3, pos_min: float = 10.0
                         ) -> torch.Tensor:
    """Stacked (2, ...) float32: [valid (0/1), score] per profile (the
    reference's get_standard_deviation_of_summed_textline_patch_along_
    width, main.py:1545-1599, quirks included)."""
    s_len = P.shape[-1]
    z = profiles.gaussian_filter1d(P, sigma)

    pad = torch.nn.functional.pad
    y_help = pad(P, (10, 10))
    zneg_rev = torch.amax(y_help, dim=-1, keepdim=True) - y_help
    zneg = profiles.gaussian_filter1d(pad(zneg_rev, (10, 10)), sigma)

    pmask = profiles.peak_mask(z)
    nmask = profiles.peak_mask(zneg)

    pos_sel = pmask & (z > pos_min)
    pos_cnt = pos_sel.sum(dim=-1)
    mpp = torch.where(
        pos_cnt > 0,
        (z * pos_sel).sum(dim=-1) / torch.clamp(pos_cnt, min=1),
        torch.full_like(z[..., 0], float("nan")))
    grenze = mpp - mpp / multiplier

    q = torch.arange(s_len + 40, device=P.device) - 20  # z-index per zneg pos
    oob = nmask & (q >= s_len)
    any_oob = oob.any(dim=-1)
    # q % s_len with numpy wrap semantics: [-20..-1] -> tail, [s_len..] ->
    # head
    zq = torch.take_along_dim(
        z, torch.remainder(q, s_len).expand(z.shape[:-1] + q.shape), dim=-1)
    neg_sel = nmask & (zq < grenze[..., None])
    neg_cnt = neg_sel.sum(dim=-1)

    var = torch.std(z, dim=-1, correction=0)
    valid = (pos_cnt > 0) & (neg_cnt > 0) & ~any_oob
    # upstream: an indexing error is caught and the angle is kept with
    # variance 0 (main.py:1647-1650)
    score = torch.where(any_oob, torch.zeros_like(var), var)
    return torch.stack([(valid | any_oob).to(torch.float32), score])


def _canvas_index_maps(h: int, w: int, s: int, pad_factor: float
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis source-index maps of the sweep-canvas render: entry i of
    cy is the crop row rendered at canvas row i (-1 = blank), including
    the 1.4x-pad downscale decision (exact integer floors) and the
    centered placement."""
    target = int(max(h, w) * pad_factor)
    if target > s:
        nh = max(1, (h * s) // max(target, 1))
        nw = max(1, (w * s) // max(target, 1))
        iy = (np.arange(nh, dtype=np.int64) * h) // nh
        ix = (np.arange(nw, dtype=np.int64) * w) // nw
    else:
        nh, nw = h, w
        iy = np.arange(h, dtype=np.int64)
        ix = np.arange(w, dtype=np.int64)
    cy = np.full(s, -1, np.int32)
    cx = np.full(s, -1, np.int32)
    y0 = s // 2 - nh // 2
    x0 = s // 2 - nw // 2
    cy[y0:y0 + nh] = iy
    cx[x0:x0 + nw] = ix
    return cy, cx


def _min_sep_u8(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable k x k min filter over the trailing two axes of (B, H, W)
    uint8 (erode; the border never wins)."""
    return morphology.min_filter(x, k)


def _max_sep_u8(x: torch.Tensor, k: int) -> torch.Tensor:
    """Separable k x k max filter (dilate; the border never wins)."""
    return morphology.max_filter(x, k)


def _hat_projection_rows(m: torch.Tensor, h: torch.Tensor, w: torch.Tensor,
                         angle_deg: torch.Tensor, bufH: int,
                         bufW: int) -> torch.Tensor:
    """Row profiles of the (B, bufH, bufW) float32 masks `m` rotated by
    `angle_deg` about (w//2, h//2): P[r] = mass landing in dst row r (cv2
    convention, dst_row = -sin*dx + cos*dy + cy). Exact row sums at angle
    0. Zero mass outside each (h, w) crop. Float32 matmuls, TF32 off."""
    rad = torch.deg2rad(angle_deg.to(torch.float32))
    a = torch.cos(rad)[:, None]
    b = torch.sin(rad)[:, None]
    cy0 = torch.div(h, 2, rounding_mode="floor").to(torch.float32)[:, None]
    cx0 = torch.div(w, 2, rounding_mode="floor").to(torch.float32)[:, None]
    K = bufW // 2
    sy = torch.arange(bufH, dtype=torch.float32, device=m.device)
    sx = torch.arange(bufW, dtype=torch.float32, device=m.device)
    fy = a * (sy - cy0) + cy0                          # (B, bufH)
    A = _hat(sy[None, :, None] - fy[:, None, :])      # (B, s_bin, y)
    gx = -b * (sx - cx0) + float(K)                    # (B, bufW)
    Bm = _hat(sx[None, :, None] - gx[:, None, :])     # (B, u_bin, x)
    with precision.full_f32(convs=False):
        U = torch.bmm(torch.bmm(A, m), Bm.transpose(1, 2))
    n = m.shape[0]
    stagetime.add(0.0, 2.0 * n * bufH * bufW * (bufH + bufW))
    L = bufH + bufW
    Wp = torch.nn.functional.pad(U, (0, L - bufW))
    flat = Wp.reshape(n, -1)[:, : bufH * (L - 1)].reshape(n, bufH, L - 1)
    D = flat.sum(dim=1)                                # D[t] = sum_s U[s, t-s]
    return D[:, K:K + bufH]


def _resident_chain(mask, boxes, cy, cx, angles, *, B, ac_n, s, cfg,
                    erode_eff, morph_k, bufH, bufW):
    """The per-group device chain. `mask`: (H, W) uint8 textline canvas on
    the device; `boxes`: (B, 4) int [y, x, h, w] (zero rows = empty
    slots), host array or device tensor; `cy`/`cx`: (B, s) canvas index
    maps, the same; `angles`: (A,) float32, the coarse range first.
    Returns (B, 1 + bufH + bufW) float32 [slope | row profile | col
    profile]."""
    dev = mask.device
    boxes = torch.as_tensor(boxes, device=dev).to(torch.int64).reshape(B, 4)
    a_all = int(angles.shape[0])
    binm = (mask != 0).to(torch.uint8)
    H, W = binm.shape
    hs, ws = boxes[:, 2], boxes[:, 3]
    ar_h = torch.arange(bufH, device=dev)
    ar_w = torch.arange(bufW, device=dev)
    inside = ((ar_h[None, :, None] < hs[:, None, None])
              & (ar_w[None, None, :] < ws[:, None, None]))
    # crop at origin; out-of-crop = 1 (erode neutral, main.py:1734
    # semantics); in-box pixels beyond the canvas read 0
    ys = boxes[:, :1] + ar_h                           # (B, bufH)
    xs = boxes[:, 1:2] + ar_w                          # (B, bufW)
    on = inside & (ys < H)[:, :, None] & (xs < W)[:, None, :]
    vals = binm[ys.clamp(max=H - 1)[:, :, None], xs.clamp(max=W - 1)[:, None]]
    crops = torch.where(on, vals, (~inside).to(torch.uint8))
    e2 = _min_sep_u8(crops, erode_eff)

    cy_t = torch.as_tensor(cy, device=dev).to(torch.int64)
    cx_t = torch.as_tensor(cx, device=dev).to(torch.int64)
    slot = torch.arange(B, device=dev)[:, None, None]
    canv = e2[slot, cy_t.clamp(0, bufH - 1)[:, :, None],
              cx_t.clamp(0, bufW - 1)[:, None, :]]
    ok = (cy_t >= 0)[:, :, None] & (cx_t >= 0)[:, None, :]
    canv = torch.where(ok, canv, torch.zeros_like(canv))

    P = radon.radon_pairs(canv, angles)
    vs = _score_profiles_impl(
        P, sigma=float(cfg.sigma),
        multiplier=float(cfg.peak_threshold_multiplier),
        pos_min=float(cfg.pos_peak_min_value))
    valid = vs[0].reshape(B, a_all) != 0.0
    score = vs[1].reshape(B, a_all)

    def pick(v, sc, ang):
        masked = torch.where(v, sc, torch.full_like(sc, float("-inf")))
        best = ang[torch.argmax(masked, dim=1)]
        return (torch.where(v.any(dim=1), best, torch.zeros_like(best)),
                masked.amax(dim=1))

    slope_c, score_c = pick(valid[:, :ac_n], score[:, :ac_n], angles[:ac_n])
    slope_v, score_v = pick(valid[:, ac_n:], score[:, ac_n:], angles[ac_n:])
    if cfg.vertical_resweep_guard:
        # DEVIATIONS #15: take the vertical-range result exactly when it
        # out-scores the coarse one
        take_v = score_v > score_c
    else:
        take_v = torch.abs(slope_c) > cfg.vertical_trigger_angle
    raw = torch.where(take_v, slope_v, slope_c)
    final = torch.where(torch.abs(raw) > cfg.slope_reject_abs,
                        torch.zeros_like(raw), raw).to(torch.float32)

    def insided(x, fill):
        return torch.where(inside, x, torch.full_like(x, fill))

    # OPEN then CLOSE (main.py:1478-1479) with the host path's
    # neutral-border discipline per primitive
    post = insided(e2, 1)
    post = _min_sep_u8(post, morph_k)
    post = insided(post, 0)
    post = _max_sep_u8(post, morph_k)
    post = insided(post, 0)
    post = _max_sep_u8(post, morph_k)
    post = insided(post, 1)
    post = _min_sep_u8(post, morph_k)
    post = insided(post, 0)

    m = post.to(torch.float32)
    p1 = _hat_projection_rows(m, hs, ws, final, bufH, bufW)
    p0 = _hat_projection_rows(m.transpose(1, 2).contiguous(), ws, hs, -final,
                              bufW, bufH)
    return torch.cat([final[:, None], p1, p0], dim=1)


def _canvas_maps_graph(h: torch.Tensor, w: torch.Tensor, s: int,
                       target_table: torch.Tensor):
    """_canvas_index_maps on the device for (B,) crop heights and widths
    (deskew.py:350-374 of the JAX package): (B, s) int64 maps cy, cx, the
    crop row / column rendered at each canvas row / column (-1 = blank).
    `target_table[m] = int(m * pad_factor)` is built on the host, so the
    downscale trigger is exact; the downscale indices are the same integer
    floors."""
    h, w = h.to(torch.int64), w.to(torch.int64)
    mx = torch.maximum(h, w).clamp(0, target_table.shape[0] - 1)
    target = target_table[mx].to(torch.int64).clamp(min=1)
    down = target > s
    nh = torch.where(down, torch.div(h * s, target, rounding_mode="floor"
                                     ).clamp(min=1), h)
    nw = torch.where(down, torch.div(w * s, target, rounding_mode="floor"
                                     ).clamp(min=1), w)
    i = torch.arange(s, device=h.device)

    def axis_map(n, d):
        j = i[None, :] - (s // 2 - torch.div(n, 2, rounding_mode="floor")
                          )[:, None]
        src = torch.div(j * d[:, None], n.clamp(min=1)[:, None],
                        rounding_mode="floor").clamp(min=0)
        src = torch.minimum(src, (d - 1).clamp(min=0)[:, None])
        ok = (j >= 0) & (j < n[:, None]) & (d[:, None] > 0)
        return torch.where(ok, src, torch.full_like(src, -1))

    return axis_map(nh, h), axis_map(nw, w)


def _canvas_maps_graph_host(h: int, w: int, s: int, pad_factor: float
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy twin of _canvas_maps_graph: what the speculative chain
    renders for an (h, w) crop. spec_finalize holds it against
    _canvas_index_maps per matched region (equal by construction today;
    the check guards against either drifting)."""
    target = max(int(max(h, w) * pad_factor), 1)
    if target > s:
        nh = max(1, (h * s) // target)
        nw = max(1, (w * s) // target)
    else:
        nh, nw = h, w

    def axis_map(n, d):
        out = np.full(s, -1, np.int32)
        j = np.arange(s, dtype=np.int64) - (s // 2 - n // 2)
        ok = (j >= 0) & (j < n) & (d > 0)
        src = np.clip((j * d) // max(n, 1), 0, max(d - 1, 0))
        out[ok] = src[ok]
        return out

    return axis_map(nh, h), axis_map(nw, w)


class _SpecPending:
    """One speculative dispatch: its output rows [box5 | slope | row
    profile | col profile] stay on the device until spec_finalize."""

    def __init__(self, out_dev, s, bufH, bufW, slots, mask_dev):
        self.out_dev = out_dev
        self.s = s
        self.bufH = bufH
        self.bufW = bufW
        self.slots = slots
        self.mask_dev = mask_dev


class _SpecResolved:
    """spec_finalize's result, for resident_collect: per region its slot
    in the fetched speculative output, or -1, and the ordinary dispatch
    (or None) that serves the regions without a slot."""

    def __init__(self, pending: _SpecPending, out, mapping, boxes_xywh,
                 fallback):
        self.pending = pending
        self.out = out                    # (slots, 6 + bufH + bufW)
        self.mapping = mapping
        self.boxes = boxes_xywh
        self.fallback = fallback


class DeskewEngine:
    """Deskew sweeps on `device`: one chain of device work per group of
    regions (resident_dispatch / resident_collect), or batched sweeps of
    host-rendered canvases (best_angles)."""

    def __init__(self, cfg: DeskewConfig = DeskewConfig(),
                 max_canvas: int = 2048, region_batch: int = 8, morph_kernel: int = 5,
                 crop_erode_iterations: int = 2, device="cuda",
                 buf_max: int = 2816):
        self.cfg = cfg
        # the largest crop side the resident chain takes (resident_buffer_
        # shape); larger regions raise, and the host sweep serves the page
        self.buf_max = buf_max
        # where best_angles uploads its canvases; the resident chain runs
        # where its textline canvas lies
        self.device = torch.device(device)
        self.max_canvas = max_canvas
        self.region_batch = max(1, region_batch)
        # crop erode (main.py:1734) and the line separator's OPEN/CLOSE
        # kernel (main.py:1478-1479)
        self._erode_eff = (morph_kernel - 1) * crop_erode_iterations + 1
        self._morph_k = morph_kernel
        self._coarse = np.linspace(cfg.coarse_range[0], cfg.coarse_range[1],
                                   cfg.coarse_steps).astype(np.float32)
        self._vertical = np.linspace(cfg.vertical_range[0],
                                     cfg.vertical_range[1],
                                     cfg.vertical_steps).astype(np.float32)

    # -- host sweep ------------------------------------------------------------
    def _canvas_into(self, crop: np.ndarray, out: np.ndarray) -> None:
        """Center `crop` (binarized, downscaled if needed) into square
        `out`: exactly the _canvas_index_maps gather, so the host sweep
        and the resident chain render identical canvases."""
        s = out.shape[0]
        h, w = crop.shape
        cy, cx = _canvas_index_maps(h, w, s, self.cfg.pad_factor)
        oky = cy >= 0
        okx = cx >= 0
        out[np.ix_(oky, okx)] = crop[np.ix_(cy[oky], cx[okx])] != 0

    def _bucket_for(self, crops: Sequence[np.ndarray]) -> int:
        return self._bucket_for_sizes([c.shape for c in crops])

    @torch.no_grad()
    def _sweep_dispatch(self, canvases: np.ndarray, s: int,
                        angles: np.ndarray) -> torch.Tensor:
        """Upload one group's (R, S, S) uint8 canvases and enqueue its
        sweep: the Radon projections of every (region, angle) pair
        (ops/radon.radon_pairs: the CUDA kernel on the card) and their
        scores. Returns the stacked [valid, score] tensor on the device;
        the fetch is deferred so that several groups queue before the
        first result is pulled back."""
        with stagetime.device_section(self.device):
            canv = torch.from_numpy(np.ascontiguousarray(canvases, np.uint8)
                                    ).to(self.device)
            ang = torch.from_numpy(np.asarray(angles, np.float32)).to(
                self.device)
            P = radon.radon_pairs(canv, ang)
            return _score_profiles_impl(
                P, sigma=float(self.cfg.sigma),
                multiplier=float(self.cfg.peak_threshold_multiplier),
                pos_min=float(self.cfg.pos_peak_min_value))

    def _sweep_collect(self, vs_dev: torch.Tensor, r: int,
                       angles: np.ndarray) -> List[Tuple[float, float]]:
        """Fetch one group's [valid, score] result and pick per-region
        (best angle, best score) pairs: the first maximizer among the
        valid angles (the score rides along for the vertical re-sweep
        guard, DEVIATIONS #15)."""
        a = angles.shape[0]
        with stagetime.device_section(vs_dev.device):
            vs = profiling.fetch(vs_dev)
        valid = vs[0].reshape(r, a) != 0.0
        score = vs[1].reshape(r, a)
        out = []
        for i in range(r):
            v = valid[i]
            if not v.any():
                # upstream: argmax of empty -> except -> 0
                out.append((0.0, float("-inf")))
            else:
                j = int(np.argmax(score[i][v]))
                out.append((float(angles[v][j]), float(score[i][v][j])))
        return out

    def _sweep_batched(self, canvases: np.ndarray, s: int,
                       angles: np.ndarray) -> List[Tuple[float, float]]:
        """(R, S, S) canvases -> per-region (best angle, best score)."""
        return self._sweep_collect(self._sweep_dispatch(canvases, s, angles),
                                   canvases.shape[0], angles)

    def best_angles(self, crops: Sequence[np.ndarray]) -> List[float]:
        """Reference return_deskew_slope (main.py:1601-1718) for every
        region of a page in batched sweeps: coarse [-25, 25] plus the
        vertical [-90, -50] range, combined per DEVIATIONS #15 (score
        comparison by default; reference-faithful trigger + replace at
        vertical_resweep_guard=False)."""
        crops = list(crops)
        if not crops:
            return []
        s = self._bucket_for(crops)
        coarse = self._sweep_grouped(crops, s, self._coarse)
        angles = [a for a, _ in coarse]
        if self.cfg.vertical_resweep_guard:
            # DEVIATIONS #15: sweep the vertical range for EVERY region and
            # take its result exactly when it out-scores the coarse one
            # (the resident chain computes both sweeps unconditionally;
            # this keeps the two routes decision-identical)
            vert = self._sweep_grouped(crops, s, self._vertical)
            for i, (va, vsc) in enumerate(vert):
                if vsc > coarse[i][1]:
                    angles[i] = va
            return angles
        # reference-faithful: re-sweep only the steep regions and replace
        # unconditionally (main.py:1669-1714)
        steep = [i for i, a in enumerate(angles)
                 if abs(a) > self.cfg.vertical_trigger_angle]
        if steep:
            vert = self._sweep_grouped([crops[i] for i in steep], s,
                                       self._vertical)
            for i, (va, _) in zip(steep, vert):
                angles[i] = va
        return angles

    def _batch_buckets(self) -> List[int]:
        """Region-batch sizes: powers of two up to region_batch. A page's
        regions are split greedily into the smallest size that holds the
        rest, so a 1-2 region tail (or a 1-2 region vertical re-sweep)
        does not sweep a full region_batch of empty slots."""
        b, buckets = 1, []
        while b < self.region_batch:
            buckets.append(b)
            b *= 2
        buckets.append(self.region_batch)
        return buckets

    def _sweep_grouped(self, crops: Sequence[np.ndarray], s: int,
                       angles: np.ndarray) -> List[Tuple[float, float]]:
        """Render and dispatch every group's sweep, then collect: the
        groups queue back to back on the device. Empty canvas slots score
        all-invalid and are dropped."""
        buckets = self._batch_buckets()
        pending = []
        start = 0
        while start < len(crops):
            remaining = len(crops) - start
            b = next((bb for bb in buckets if bb >= remaining), buckets[-1])
            group = crops[start:start + b]
            buf = np.zeros((b, s, s), dtype=np.uint8)
            for i, crop in enumerate(group):
                self._canvas_into(crop, buf[i])
            pending.append((self._sweep_dispatch(buf, s, angles), b,
                            len(group)))
            start += b
        out: List[Tuple[float, float]] = []
        for vs_dev, b, n_real in pending:
            out.extend(self._sweep_collect(vs_dev, b, angles)[:n_real])
        return out

    def best_angle(self, crop: np.ndarray) -> float:
        return self.best_angles([crop])[0]

    # -- device-resident chain --------------------------------------------------
    def _bucket_for_sizes(self, sizes) -> int:
        target = 32
        for h, w in sizes:
            target = max(target, int(max(h, w) * self.cfg.pad_factor))
        return next((b for b in _BUCKETS if b >= target and
                     b <= self.max_canvas), self.max_canvas)

    @staticmethod
    def group_buffer_shape(group: Sequence[Sequence[int]]) -> Tuple[int, int]:
        """(bufH, bufW) of a group of (x, y, w, h) boxes: its largest crop,
        rounded up to 256."""
        bh = max(b[3] for b in group)
        bw = max(b[2] for b in group)
        return -(-bh // 256) * 256, -(-bw // 256) * 256

    def resident_buffer_shape(self, mask_shape) -> Tuple[int, int]:
        """The largest crop (h, w) the chain takes from a canvas of
        `mask_shape`: its sides rounded up to 256, at most buf_max (the
        reference's static buffer, deskew.py:838-841)."""
        H, W = mask_shape
        return (min(-(-H // 256) * 256, self.buf_max),
                min(-(-W // 256) * 256, self.buf_max))

    def _check_cap(self, mask_shape, boxes_xywh) -> None:
        capH, capW = self.resident_buffer_shape(mask_shape)
        for x, y, w, h in boxes_xywh:
            if h > capH or w > capW:
                raise ValueError(
                    f"region {h}x{w} exceeds the resident deskew buffer "
                    f"{capH}x{capW}; host path required")

    @torch.no_grad()
    def resident_dispatch(self, mask_dev: torch.Tensor, boxes_xywh):
        """Enqueue the chain for every group of regions; returns a handle
        for resident_collect. `boxes_xywh`: per region (x, y, w, h) in the
        textline canvas. Raises ValueError when a region exceeds
        resident_buffer_shape (the caller falls back to the host sweep)."""
        boxes_xywh = [list(map(int, b)) for b in boxes_xywh]
        n = len(boxes_xywh)
        if n == 0:
            return []
        self._check_cap(tuple(mask_dev.shape), boxes_xywh)
        s = self._bucket_for_sizes([(b[3], b[2]) for b in boxes_xywh])
        angles = torch.from_numpy(np.concatenate(
            [self._coarse, self._vertical])).to(mask_dev.device)
        with stagetime.device_section(mask_dev.device):
            return self._resident_groups(mask_dev, boxes_xywh, s, angles)

    def _resident_groups(self, mask_dev, boxes_xywh, s, angles):
        """resident_dispatch's loop: one chain per group of regions."""
        n = len(boxes_xywh)
        pending = []
        start = 0
        while start < n:
            B = self.region_batch if n - start > 2 else min(
                2, self.region_batch)
            group = boxes_xywh[start:start + B]
            bufH, bufW = self.group_buffer_shape(group)
            boxes_arr = np.zeros((B, 4), np.int64)
            cy = np.full((B, s), -1, np.int32)
            cx = np.full((B, s), -1, np.int32)
            for i, (x, y, w, h) in enumerate(group):
                boxes_arr[i] = (y, x, h, w)
                cy[i], cx[i] = _canvas_index_maps(h, w, s,
                                                  self.cfg.pad_factor)
            out_dev = _resident_chain(
                mask_dev, boxes_arr, cy, cx, angles, B=B,
                ac_n=self._coarse.shape[0], s=s, cfg=self.cfg,
                erode_eff=self._erode_eff, morph_k=self._morph_k,
                bufH=bufH, bufW=bufW)
            pending.append((out_dev, group, bufH))
            start += B
        return pending

    def resident_collect(self, pending):
        """(slopes, profiles) of resident_dispatch's groups, or of a
        spec_finalize resolution: slopes are final (vertical re-sweep +
        reject applied); profiles[i] = (row_profile[:h], col_profile[:w])
        float32."""
        if isinstance(pending, _SpecResolved):
            return self._spec_collect(pending)
        slopes: List[float] = []
        profiles_out = []
        for out_dev, group, bufH in pending:
            with stagetime.device_section(out_dev.device):
                out = profiling.fetch(out_dev)
            for i, (x, y, w, h) in enumerate(group):
                slopes.append(float(out[i, 0]))
                profiles_out.append((out[i, 1:1 + h],
                                     out[i, 1 + bufH:1 + bufH + w]))
        return slopes, profiles_out

    # -- speculative chain -----------------------------------------------------
    def spec_canvas(self) -> int:
        """The speculative sweep's canvas bucket: the largest the engine
        can pick. A page whose regions pick a smaller one falls back as a
        whole (scores depend on the canvas)."""
        return next((b for b in reversed(_BUCKETS) if b <= self.max_canvas),
                    self.max_canvas)

    def spec_buffer_shape(self, mask_shape) -> Tuple[int, int]:
        """The speculative chain's one crop buffer (it runs before the
        region sizes are known): resident_buffer_shape with the height
        capped at 1024; taller regions take the ordinary dispatch."""
        capH, capW = self.resident_buffer_shape(mask_shape)
        return min(1024, capH), capW

    @torch.no_grad()
    def spec_dispatch(self, region_dev: torch.Tensor, mask_dev: torch.Tensor,
                      crop_hw, min_area: float, max_area: float,
                      slots: int = 16) -> _SpecPending:
        """Enqueue the speculative chain behind the fused segmentation that
        made `region_dev` (the shaped 0/1 region canvas, the page crop
        `crop_hw` at its top-left) and `mask_dev` (the textline canvas of
        the same shape): the first `slots` region components of the crop
        whose pixel count lies in [min_area, max_area] (permissive bounds,
        see stages.deskew_spec_dispatch), their canvas maps and the chain,
        all on the device. Labelling the components reads one flag back
        per sweep (ops/cc.label_components), so this waits for the
        segmentation to finish; the chain itself is only enqueued."""
        big_hw = tuple(region_dev.shape)
        if tuple(mask_dev.shape) != big_hw:
            raise ValueError(f"textline canvas {tuple(mask_dev.shape)} != "
                             f"region canvas {big_hw}")
        H, W = big_hw
        s = self.spec_canvas()
        bufH, bufW = self.spec_buffer_shape(big_hw)
        dev = mask_dev.device
        with stagetime.device_section(dev):
            # outside the crop the canvas holds white-tile predictions the
            # host never sees; they would mint or merge components
            ins = ((torch.arange(H, device=dev)[:, None] < int(crop_hw[0]))
                   & (torch.arange(W, device=dev)[None, :] < int(crop_hw[1])))
            m = torch.where(ins, region_dev, torch.zeros_like(region_dev))
            boxes5 = cc_ops.component_boxes_topk(m, slots, min_area,
                                                 max_area)
            # target_table[m] = int(m * pad_factor), built on the host so
            # that the downscale trigger is the host's
            table = torch.from_numpy(
                (np.arange(max(H, W) + 1, dtype=np.float64)
                 * float(self.cfg.pad_factor)).astype(np.int64)).to(dev)
            cy, cx = _canvas_maps_graph(boxes5[:, 2], boxes5[:, 3], s, table)
            angles = torch.from_numpy(np.concatenate(
                [self._coarse, self._vertical])).to(dev)
            out = _resident_chain(
                mask_dev, boxes5[:, :4], cy, cx, angles, B=slots,
                ac_n=self._coarse.shape[0], s=s, cfg=self.cfg,
                erode_eff=self._erode_eff, morph_k=self._morph_k,
                bufH=bufH, bufW=bufW)
            out = torch.cat([boxes5.to(torch.float32), out], dim=1)
        return _SpecPending(out, s, bufH, bufW, slots, mask_dev)

    def spec_finalize(self, pending: _SpecPending, boxes_xywh):
        """Match the host contour boxes against the speculative device
        boxes; returns a handle for resident_collect. A region takes its
        speculative slot only when (a) the page's canvas bucket is the
        speculative one, (b) its box fits the speculative crop buffer, (c)
        the device canvas maps for its (h, w) equal the host maps, and (d)
        a valid slot holds the identical box; every other region goes to
        an ordinary dispatch (all of them when (a) fails). Raises
        ValueError where resident_dispatch would (a region over the
        cap)."""
        boxes_xywh = [list(map(int, b)) for b in boxes_xywh]
        n = len(boxes_xywh)
        if n == 0:
            return []
        self._check_cap(tuple(pending.mask_dev.shape), boxes_xywh)
        s_host = self._bucket_for_sizes([(b[3], b[2]) for b in boxes_xywh])
        if s_host != pending.s:
            return self.resident_dispatch(pending.mask_dev, boxes_xywh)
        with stagetime.device_section(pending.out_dev.device):
            out = profiling.fetch(pending.out_dev)
        dev_boxes = out[:, :5].astype(np.int64)
        mapping = [-1] * n
        used = set()
        for i, (x, y, w, h) in enumerate(boxes_xywh):
            if h > pending.bufH or w > pending.bufW:
                continue
            gm = _canvas_maps_graph_host(h, w, pending.s,
                                         self.cfg.pad_factor)
            hm = _canvas_index_maps(h, w, pending.s, self.cfg.pad_factor)
            if not (np.array_equal(gm[0], hm[0])
                    and np.array_equal(gm[1], hm[1])):
                continue
            for j in range(pending.slots):
                if j in used or dev_boxes[j, 4] == 0:
                    continue
                if tuple(dev_boxes[j, :4]) == (y, x, h, w):
                    mapping[i] = j
                    used.add(j)
                    break
        fb_idx = [i for i, j in enumerate(mapping) if j < 0]
        fallback = (self.resident_dispatch(
            pending.mask_dev, [boxes_xywh[i] for i in fb_idx])
            if fb_idx else None)
        return _SpecResolved(pending, out, mapping, boxes_xywh, fallback)

    def _spec_collect(self, r: _SpecResolved):
        fb = iter(zip(*self.resident_collect(r.fallback))
                  if r.fallback is not None else ())
        bufH = r.pending.bufH
        slopes: List[float] = []
        profiles_out = []
        for (x, y, w, h), j in zip(r.boxes, r.mapping):
            if j < 0:
                sl, pr = next(fb)
                slopes.append(sl)
                profiles_out.append(pr)
                continue
            row = r.out[j]
            slopes.append(float(row[5]))
            profiles_out.append((row[6:6 + h], row[6 + bufH:6 + bufH + w]))
        return slopes, profiles_out
