"""Inference engine for the single-page main path (counterpart of
sbb_textline_detection_tpu/models/runner.py, limited to what
TextlineDetector's raw-upload path runs).

  * `SegmentationModel.predict_small_prescaled`: the page model's whole-
    image forward at model resolution (label map back to host);
  * `SegmentationModel.upload_raw` + `predict_dual_tiled_resident_raw`:
    the fused segmentation program of the dual-head model — nearest
    gather of the working canvas from the resident raw page, whitening
    outside the page box, masked Otsu, tile gather, the dual-head forward
    in `_balanced_chunk` chunks with a per-head argmax, stitch, region
    morphology + class mask, and the textline row sum.

PyTorch runs eagerly, so there is no compile cache and no shape bucketing
beyond the tile grid; the JAX package's 1-/2-bit transfer packing
(ops/pack.py) is dropped.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.core.config import RuntimeConfig
from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from sbb_textline_detection_tpu_torch.models.registry import ModelSpec
from sbb_textline_detection_tpu_torch.ops import morphology
from sbb_textline_detection_tpu_torch.ops import resize as resize_ops
from sbb_textline_detection_tpu_torch.ops import threshold

# tuple of ("erode"|"dilate"|"open"|"close", kernel_size, iterations)
MorphSpec = Tuple[Tuple[str, int, int], ...]


def _balanced_chunk(total: int, cap: int) -> int:
    """Largest chunk <= cap that splits the tile batch into equal-size
    steps with (near-)zero remainder: ceil(total/steps) for the smallest
    step count whose chunk fits the cap."""
    steps = -(-total // max(1, min(cap, total)))
    return -(-total // steps)


def _as_spec(spec) -> ModelSpec:
    return spec if isinstance(spec, ModelSpec) else \
        ModelSpec.from_meta(spec.to_meta())


def _pad_white(img: np.ndarray, bottom: int, right: int) -> np.ndarray:
    h, w = img.shape[:2]
    out = np.full((h + bottom, w + right) + img.shape[2:], 255, img.dtype)
    out[:h, :w] = img
    return out


class SegmentationModel:
    """One loaded TpuUnet on a device."""

    def __init__(self, spec, state_dict, runtime: RuntimeConfig | None = None,
                 device="cuda", dtype: torch.dtype | None = None):
        self.spec = _as_spec(spec)
        self.runtime = runtime or RuntimeConfig()
        self.device = torch.device(device)
        self.dtype = dtype or getattr(torch, self.runtime.compute_dtype)
        self.module = registry.build_module(self.spec, self.dtype)
        # strict: a checkpoint that does not match the architecture fails
        # here, not as a degraded page later
        self.module.load_state_dict(state_dict)
        self.module.to(self.device).eval()

    @property
    def input_hw(self) -> Tuple[int, int]:
        return self.spec.input_height, self.spec.input_width

    # -- page model --------------------------------------------------------
    @torch.no_grad()
    def predict_small_prescaled(self, small_u8: np.ndarray) -> np.ndarray:
        """(model_h, model_w, 3) uint8 page-model input -> (model_h,
        model_w) uint8 label map on the host."""
        mh, mw = self.input_hw
        if small_u8.shape[:2] != (mh, mw):
            raise ValueError(f"expected {(mh, mw)} input, got "
                             f"{small_u8.shape[:2]}")
        x = torch.from_numpy(np.ascontiguousarray(small_u8)).to(self.device)
        x = x[None].to(torch.float32) / 255.0
        logits = self.module.forward_nchw(x.permute(0, 3, 1, 2))
        return torch.argmax(logits[0], dim=0).to(torch.uint8).cpu().numpy()

    # -- geometry ----------------------------------------------------------
    def grid_for(self, h: int, w: int, margin_ratio: float = 0.1
                 ) -> Tuple[int, int]:
        """(ny, nx) tile grid for an (h, w) crop: ny rounds up to
        runtime.grid_bucket, nx to runtime.grid_bucket_x."""
        mh, mw = self.input_hw
        margin = int(margin_ratio * mw)
        sh, sw = mh - 2 * margin, mw - 2 * margin
        gb = max(1, self.runtime.grid_bucket)
        gbx = max(1, getattr(self.runtime, "grid_bucket_x", gb))
        ny = -(-max(1, -(-h // sh)) // gb) * gb
        nx = -(-max(1, -(-w // sw)) // gbx) * gbx
        return ny, nx

    def canvas_shape_for(self, scaled_h: int, scaled_w: int,
                         margin_ratio: float = 0.1) -> Tuple[int, int]:
        """Working canvas: the scaled page plus `margin` context top/left
        and one tile stride + margin of slack bottom/right, rounded up to
        128."""
        mh, mw = self.input_hw
        margin = int(margin_ratio * mw)
        sh, sw = mh - 2 * margin, mw - 2 * margin
        ch = margin + scaled_h + sh + margin
        cw = margin + scaled_w + sw + margin
        return (-(-ch // 128) * 128, -(-cw // 128) * 128)

    # -- fused dual-head program ---------------------------------------------
    def upload_raw(self, image: np.ndarray) -> torch.Tensor:
        """Pad the ORIGINAL page to 128-multiples (white) and copy it to
        the device. The dual-head program reads channel 0 only, so an RGB
        page ships its first plane; the working canvas is gathered on the
        device by predict_dual_tiled_resident_raw."""
        plane = image[..., 0] if image.ndim == 3 else image
        h, w = plane.shape
        ph, pw = -(-h // 128) * 128, -(-w // 128) * 128
        if (ph, pw) != (h, w):
            plane = _pad_white(plane, ph - h, pw - w)
        return torch.from_numpy(np.ascontiguousarray(plane)).to(self.device)

    def _is_dual_head_pair(self, other: "SegmentationModel") -> bool:
        return other is self and bool(self.spec.heads)

    @torch.no_grad()
    def predict_dual_tiled_resident_raw(self, other: "SegmentationModel",
                                        raws, boxes, scaled_hws,
                                        margin_ratio: float = 0.1,
                                        morph: Optional[MorphSpec] = None,
                                        mask_class: Optional[int] = None,
                                        post_morph: Optional[MorphSpec] = None,
                                        raw_hws=None):
        """Fused region + textline segmentation of K resident raw pages
        (upload_raw). `boxes`: per page [by, bx, crop_h, crop_w] in working
        coordinates; `scaled_hws`: per page working (h, w), all equal;
        `raw_hws`: the original page dims before upload_raw's padding.
        Returns per page (region_mask uint8 (h, w) on the host, textline
        row sum int32 (h,) on the host, textline canvas uint8 on the
        device)."""
        if not self._is_dual_head_pair(other):
            raise ValueError("the fused program serves the dual-head model "
                             "(region and textline roles on one model)")
        if mask_class is None:
            raise ValueError("the fused program needs mask_class")
        k = len(raws)
        boxes = np.asarray(boxes, np.int32).reshape(k, 4)
        mh, mw = self.input_hw
        margin = int(margin_ratio * mw)
        sh, sw = mh - 2 * margin, mw - 2 * margin
        if len({tuple(s) for s in scaled_hws}) != 1:
            raise ValueError("pages span multiple working sizes; group "
                             "before fusing")
        th, tw = scaled_hws[0]
        grids = {self.grid_for(int(b[2]), int(b[3]), margin_ratio)
                 for b in boxes}
        if len(grids) != 1:
            raise ValueError(f"pages span multiple tile grids "
                             f"{sorted(grids)}")
        ny, nx = grids.pop()
        if len({tuple(r.shape) for r in raws}) != 1:
            raise ValueError("raw shapes differ")
        if raw_hws is None:
            raw_hws = [tuple(r.shape[:2]) for r in raws]
        if len({tuple(s) for s in raw_hws}) != 1:
            raise ValueError("pages span multiple raw sizes; group first")
        raw_h, raw_w = raw_hws[0]
        pad_h, pad_w = raws[0].shape[:2]
        ch, cw = self.canvas_shape_for(th, tw, margin_ratio)
        dev = self.device

        # canvas row i -> raw row (or -1 = white): margin offset baked in
        iy = np.full(ch, -1, np.int64)
        ix = np.full(cw, -1, np.int64)
        iy[margin:margin + th] = resize_ops._nearest_indices(th, raw_h)
        ix[margin:margin + tw] = resize_ops._nearest_indices(tw, raw_w)
        iy_t = torch.from_numpy(iy).to(dev)
        ix_t = torch.from_numpy(ix).to(dev)
        ok = (iy_t[:, None] >= 0) & (ix_t[None, :] >= 0)
        cy = torch.arange(ch, device=dev)[:, None]
        cx = torch.arange(cw, device=dev)[None, :]
        white = torch.tensor(255, dtype=torch.uint8, device=dev)

        n = ny * nx
        jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        tiles, ts = [], []
        for raw, (by, bx, bh, bw) in zip(raws, boxes):
            cv = raw.index_select(0, iy_t.clamp(0, pad_h - 1)).index_select(
                1, ix_t.clamp(0, pad_w - 1))
            inside = ((cy >= margin + by) & (cy < margin + by + bh)
                      & (cx >= margin + bx) & (cx < margin + bx + bw))
            img = torch.where(ok & inside, cv, white)
            ts.append(threshold.otsu_threshold_masked(img, inside))
            # tile starts clamp into the canvas like lax.dynamic_slice
            y0 = np.clip(by + jj.ravel() * sh, 0, ch - mh)
            x0 = np.clip(bx + ii.ravel() * sw, 0, cw - mw)
            rows = torch.from_numpy(y0[:, None] + np.arange(mh)).to(dev)
            cols = torch.from_numpy(x0[:, None] + np.arange(mw)).to(dev)
            tiles.append(img[rows[:, :, None], cols[:, None, :]])
        tiles = torch.cat(tiles)                              # (k*n, mh, mw)
        t_tiles = torch.stack(ts).repeat_interleave(n)

        total = k * n
        chunk = _balanced_chunk(total, self.runtime.tile_chunk)
        h0 = int(self.spec.heads[0])
        labels_r, labels_t = [], []
        for c0 in range(0, total, chunk):
            batch = tiles[c0:c0 + chunk]
            tb = t_tiles[c0:c0 + chunk]
            ch0 = (batch.to(torch.int32) > tb[:, None, None]).to(
                torch.float32)
            rawf = batch.to(torch.float32) / 255.0
            logits = self.module.forward_nchw(torch.stack([rawf, ch0], 1))
            labels_r.append(torch.argmax(logits[:, :h0], 1).to(torch.uint8))
            labels_t.append(torch.argmax(logits[:, h0:], 1).to(torch.uint8))

        def stitch(labels):
            slabs = torch.cat(labels)[:, margin:margin + sh,
                                      margin:margin + sw]
            return (slabs.reshape(k, ny, nx, sh, sw).permute(0, 1, 3, 2, 4)
                    .reshape(k, ny * sh, nx * sw))

        canvas_r, canvas_t = stitch(labels_r), stitch(labels_t)
        big_h, big_w = ny * sh, nx * sw
        rr = torch.arange(big_h, device=dev)[:, None]
        cc = torch.arange(big_w, device=dev)[None, :]
        out = []
        for i, (_, _, bh, bw) in enumerate(boxes):
            ins = (rr < int(bh)) & (cc < int(bw))
            c = morphology.apply_morph(canvas_r[i], morph or (), ins)
            c = (c == mask_class).to(torch.uint8)
            c = morphology.apply_morph(c, post_morph or (), ins)
            tl = canvas_t[i]
            rowsum = torch.where(cc < int(bw), tl,
                                 torch.zeros_like(tl)).to(torch.int32).sum(1)
            out.append((c[:bh, :bw].cpu().numpy(),
                        rowsum[:bh].to(torch.int32).cpu().numpy(), tl))
        return out


class ModelBundle:
    """The page model plus the dual-head model, which serves both the
    region and textline roles."""

    def __init__(self, page: SegmentationModel, region: SegmentationModel,
                 textline: SegmentationModel):
        self.page = page
        self.region = region
        self.textline = textline

    @property
    def is_dual_head(self) -> bool:
        return (self.region is self.textline
                and bool(self.region.spec.heads))

    @staticmethod
    def _from_state(page_spec, page_sd, dual_spec, dual_sd, runtime, device,
                    dtype) -> "ModelBundle":
        dual_spec = _as_spec(dual_spec)
        if not dual_spec.heads:
            raise ValueError(f"model {dual_spec.name!r} carries no head "
                             "split; the port serves the dual-head bundle")
        page = SegmentationModel(page_spec, page_sd, runtime, device, dtype)
        dual = SegmentationModel(dual_spec, dual_sd, runtime, device, dtype)
        return ModelBundle(page, dual, dual)

    @staticmethod
    def random_init(runtime: RuntimeConfig | None = None, seed: int = 0,
                    device="cuda", dtype: torch.dtype | None = None,
                    page_spec=None, dual_spec=None) -> "ModelBundle":
        """Randomly initialized bundle (tests / smoke runs): each model's
        weights are drawn from torch.Generator().manual_seed(seed)."""
        page_spec = _as_spec(page_spec or registry.DEFAULT_SPECS["page"])
        dual_spec = _as_spec(dual_spec or registry.DUALHEAD_SPEC)
        return ModelBundle._from_state(
            page_spec, checkpoint.random_init(
                page_spec, torch.Generator().manual_seed(seed)),
            dual_spec, checkpoint.random_init(
                dual_spec, torch.Generator().manual_seed(seed)),
            runtime, device, dtype)

    @staticmethod
    def from_jax_variables(page_variables, dual_variables, page_spec=None,
                           dual_spec=None,
                           runtime: RuntimeConfig | None = None,
                           device="cuda", dtype: torch.dtype | None = None
                           ) -> "ModelBundle":
        """Bundle from Flax variable trees (nested dicts of arrays) of the
        page model and the dual-head model."""
        return ModelBundle._from_state(
            page_spec or registry.DEFAULT_SPECS["page"],
            checkpoint.params_from_flax(page_variables),
            dual_spec or registry.DUALHEAD_SPEC,
            checkpoint.params_from_flax(dual_variables),
            runtime, device, dtype)

    @staticmethod
    def from_dir(model_dir: str, runtime: RuntimeConfig | None = None,
                 device="cuda", model_names=None,
                 dtype: torch.dtype | None = None) -> "ModelBundle":
        """`<model_dir>/<page>.npz` + `<model_dir>/<dualhead>.npz` in the
        JAX package's checkpoint format."""
        import os

        from sbb_textline_detection_tpu_torch.core.config import ModelNames

        names = model_names or ModelNames()
        page_spec, page_vars = checkpoint.load(
            os.path.join(model_dir, names.page + ".npz"))
        dual_spec, dual_vars = checkpoint.load(
            os.path.join(model_dir, names.dualhead + ".npz"))
        return ModelBundle.from_jax_variables(page_vars, dual_vars,
                                              page_spec, dual_spec, runtime,
                                              device, dtype)
