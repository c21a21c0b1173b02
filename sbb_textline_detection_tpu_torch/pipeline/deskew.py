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
PyTorch sizes each group's buffer to its largest crop rounded up to 256:
there is no buffer cap and no "region exceeds the buffer" exit. The row
and column profiles are rounded at the buffer's half width / half height
(the shear-bin offset K), as in the JAX program.

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
from sbb_textline_detection_tpu_torch.ops import (morphology, precision,
                                                 profiles, radon)
from sbb_textline_detection_tpu_torch.utils import stagetime

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
    with precision.full_f32():
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
    the device; `boxes`: (B, 4) int [y, x, h, w] (zero rows = empty slots);
    `cy`/`cx`: (B, s) canvas index maps; `angles`: (A,) float32, the coarse
    range first. Returns (B, 1 + bufH + bufW) float32 [slope | row profile
    | col profile]."""
    dev = mask.device
    boxes = np.asarray(boxes, np.int64).reshape(B, 4)
    a_all = int(angles.shape[0])
    binm = (mask != 0).to(torch.uint8)
    H, W = binm.shape
    # crop at origin; out-of-crop = 1 (erode neutral, main.py:1734
    # semantics); in-box pixels beyond the canvas read 0
    crops = torch.ones((B, bufH, bufW), dtype=torch.uint8, device=dev)
    for i, (y, x, h, w) in enumerate(boxes):
        if h <= 0 or w <= 0:
            continue
        crops[i, :h, :w] = 0
        sub = binm[y:min(y + h, H), x:min(x + w, W)]
        crops[i, :sub.shape[0], :sub.shape[1]] = sub
    e2 = _min_sep_u8(crops, erode_eff)

    cy_t = torch.from_numpy(np.asarray(cy, np.int64)).to(dev)
    cx_t = torch.from_numpy(np.asarray(cx, np.int64)).to(dev)
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

    hs = torch.from_numpy(boxes[:, 2]).to(dev)
    ws = torch.from_numpy(boxes[:, 3]).to(dev)
    inside = ((torch.arange(bufH, device=dev)[None, :, None]
               < hs[:, None, None])
              & (torch.arange(bufW, device=dev)[None, None, :]
                 < ws[:, None, None]))

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


class DeskewEngine:
    """Deskew sweeps on `device`: one chain of device work per group of
    regions (resident_dispatch / resident_collect), or batched sweeps of
    host-rendered canvases (best_angles)."""

    def __init__(self, cfg: DeskewConfig = DeskewConfig(),
                 max_canvas: int = 2048, region_batch: int = 8, morph_kernel: int = 5,
                 crop_erode_iterations: int = 2, device="cuda"):
        self.cfg = cfg
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
            vs = vs_dev.cpu().numpy()
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

    @torch.no_grad()
    def resident_dispatch(self, mask_dev: torch.Tensor, boxes_xywh):
        """Enqueue the chain for every group of regions; returns a handle
        for resident_collect. `boxes_xywh`: per region (x, y, w, h) in the
        textline canvas."""
        boxes_xywh = [list(map(int, b)) for b in boxes_xywh]
        n = len(boxes_xywh)
        if n == 0:
            return []
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
        """(slopes, profiles) of resident_dispatch's groups: slopes are
        final (vertical re-sweep + reject applied); profiles[i] =
        (row_profile[:h], col_profile[:w]) float32."""
        slopes: List[float] = []
        profiles_out = []
        for out_dev, group, bufH in pending:
            with stagetime.device_section(out_dev.device):
                out = out_dev.cpu().numpy()
            for i, (x, y, w, h) in enumerate(group):
                slopes.append(float(out[i, 0]))
                profiles_out.append((out[i, 1:1 + h],
                                     out[i, 1 + bufH:1 + bufH + w]))
        return slopes, profiles_out
