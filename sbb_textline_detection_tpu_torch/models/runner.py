"""Inference engine for the single-page main path (counterpart of
sbb_textline_detection_tpu/models/runner.py, limited to what
TextlineDetector's raw-upload path runs).

  * `SegmentationModel.predict_small_prescaled`: the page model's whole-
    image forward at model resolution (label map back to host);
  * `SegmentationModel.upload_raw` + `predict_dual_tiled_resident_raw`:
    the fused segmentation program — nearest gather of the working canvas
    from the resident raw page (one plane or RGB), whitening outside the
    page box, masked Otsu, tile gather, in `_balanced_chunk` chunks either
    the dual-head forward with a per-head argmax or the classic region and
    textline forwards, stitch, region morphology + class mask, and the
    textline row sum.

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
    """One loaded TpuUnet or ResNet50Unet on a device."""

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

    # -- fused region + textline program -------------------------------------
    def upload_raw(self, image: np.ndarray) -> torch.Tensor:
        """Pad the ORIGINAL page to 128-multiples (white) and copy it to
        the device. `image` is (h, w, 3) RGB or one (h, w) plane: the
        detector ships a plane when the page's channels are byte-identical
        or the dual-head model (which reads channel 0 only) serves it. The
        working canvas is gathered on the device by
        predict_dual_tiled_resident_raw."""
        h, w = image.shape[:2]
        ph, pw = -(-h // 128) * 128, -(-w // 128) * 128
        if (ph, pw) != (h, w):
            image = _pad_white(image, ph - h, pw - w)
        return torch.from_numpy(np.ascontiguousarray(image)).to(self.device)

    def _is_dual_head_pair(self, other: "SegmentationModel") -> bool:
        """True when `self` (region role) and `other` (textline role) are
        the same dual-head model: one forward yields both label maps."""
        return other is self and bool(self.spec.heads)

    def textline_n_classes(self, other: "SegmentationModel") -> int:
        """Class count of the textline label map the fused program emits:
        the last head's width on a dual-head model, else `other`'s."""
        if self._is_dual_head_pair(other):
            return int(self.spec.heads[-1])
        return int(other.spec.n_classes)

    def _forward_pair(self, other: "SegmentationModel", batch: torch.Tensor,
                      tb: torch.Tensor):
        """(region labels, textline labels) uint8 (n, mh, mw) of a uint8
        tile batch, (n, mh, mw) or (n, mh, mw, 3), with per-tile Otsu
        thresholds `tb` (runner.py:483-556 in the JAX package).

        Dual-head model: one forward on [raw01 (channel 0 / 255), channel 0
        thresholded] and an argmax per head. Classic pair: the region model
        sees channel 0 thresholded as 0.0 / 1.0 on all 3 channels (otsu_copy,
        main.py:191-193) and the textline model the tiles / 255
        (main.py:490-503), a plane repeated to 3 channels."""
        plane = batch[..., 0] if batch.ndim == 4 else batch
        ch0 = (plane.to(torch.int32) > tb[:, None, None]).to(torch.float32)
        if self._is_dual_head_pair(other):
            h0 = int(self.spec.heads[0])
            rawf = plane.to(torch.float32) / 255.0
            logits = self.module.forward_nchw(torch.stack([rawf, ch0], 1))
            return (torch.argmax(logits[:, :h0], 1).to(torch.uint8),
                    torch.argmax(logits[:, h0:], 1).to(torch.uint8))
        x = batch.to(torch.float32) / 255.0
        x = x.permute(0, 3, 1, 2) if batch.ndim == 4 \
            else x[:, None].expand(-1, 3, -1, -1)
        logits_r = self.module.forward_nchw(ch0[:, None].expand(-1, 3, -1, -1))
        labels_r = torch.argmax(logits_r, 1).to(torch.uint8)
        del logits_r
        logits_t = other.module.forward_nchw(x)
        return labels_r, torch.argmax(logits_t, 1).to(torch.uint8)

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
        device). `other` is the textline model: `self` for the dual-head
        model, else the classic textline model of the same tile size."""
        if self.input_hw != other.input_hw:
            raise ValueError("dual tiled predict needs identical geometry")
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
            keep = ok & inside
            img = torch.where(keep[..., None] if cv.ndim == 3 else keep, cv,
                              white)
            ts.append(threshold.otsu_threshold_masked(
                img[..., 0] if img.ndim == 3 else img, inside))
            # tile starts clamp into the canvas like lax.dynamic_slice
            y0 = np.clip(by + jj.ravel() * sh, 0, ch - mh)
            x0 = np.clip(bx + ii.ravel() * sw, 0, cw - mw)
            rows = torch.from_numpy(y0[:, None] + np.arange(mh)).to(dev)
            cols = torch.from_numpy(x0[:, None] + np.arange(mw)).to(dev)
            tiles.append(img[rows[:, :, None], cols[:, None, :]])
        tiles = torch.cat(tiles)                   # (k*n, mh, mw[, 3])
        t_tiles = torch.stack(ts).repeat_interleave(n)

        total = k * n
        chunk = _balanced_chunk(total, self.runtime.tile_chunk)
        labels_r, labels_t = [], []
        for c0 in range(0, total, chunk):
            lr, lt = self._forward_pair(other, tiles[c0:c0 + chunk],
                                        t_tiles[c0:c0 + chunk])
            labels_r.append(lr)
            labels_t.append(lt)

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
    """The page model plus either the dual-head model, which serves both
    the region and textline roles, or the classic region and textline
    models (the upstream three-model layout, main.py:58-60). Each classic
    model may be a TpuUnet or a ResNet50Unet."""

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
    def _from_state(page, region, textline, runtime, device,
                    dtype) -> "ModelBundle":
        """Each role a (spec, state_dict) pair; `textline` None means
        `region` is the dual-head model and serves both roles."""
        def build(spec_sd):
            return SegmentationModel(spec_sd[0], spec_sd[1], runtime, device,
                                     dtype)

        region_model = build(region)
        if textline is None:
            if not region_model.spec.heads:
                raise ValueError(f"model {region_model.spec.name!r} carries "
                                 "no head split; it cannot serve the "
                                 "textline role too")
            return ModelBundle(build(page), region_model, region_model)
        return ModelBundle(build(page), region_model, build(textline))

    @staticmethod
    def random_init(runtime: RuntimeConfig | None = None, seed: int = 0,
                    device="cuda", dtype: torch.dtype | None = None,
                    specs=None, dual_head: bool = False) -> "ModelBundle":
        """Randomly initialized bundle (tests / smoke runs): each model's
        weights are drawn from torch.Generator().manual_seed(seed).
        `specs` maps the roles page / region / textline to specs (default
        registry.DEFAULT_SPECS); with `dual_head`, one DUALHEAD_SPEC model
        serves the region and textline roles."""
        specs = dict(specs or registry.DEFAULT_SPECS)
        if dual_head:
            specs["region"] = registry.DUALHEAD_SPEC
            specs["textline"] = None

        def pair(spec):
            if spec is None:
                return None
            spec = _as_spec(spec)
            return spec, checkpoint.random_init(
                spec, torch.Generator().manual_seed(seed))

        return ModelBundle._from_state(
            pair(specs["page"]), pair(specs["region"]),
            pair(specs["textline"]), runtime, device, dtype)

    @staticmethod
    def from_jax_variables(page, region, textline=None,
                           runtime: RuntimeConfig | None = None,
                           device="cuda", dtype: torch.dtype | None = None
                           ) -> "ModelBundle":
        """Bundle from (spec, Flax variable tree) pairs, the trees nested
        dicts of arrays: the page model, the region model and the textline
        model, or with `textline` None, the dual-head model as `region`."""
        def state(pair):
            return None if pair is None else (
                pair[0], checkpoint.params_from_flax(pair[1]))

        return ModelBundle._from_state(state(page), state(region),
                                       state(textline), runtime, device,
                                       dtype)

    @staticmethod
    def from_dir(model_dir: str, runtime: RuntimeConfig | None = None,
                 device="cuda", model_names=None,
                 dtype: torch.dtype | None = None) -> "ModelBundle":
        """Load a bundle from `model_dir` (runner.py:1731-1764 in the JAX
        package). A dual-head `.npz` checkpoint (names.dualhead), when
        present, serves both the region and textline roles beside the
        page model; otherwise the three classic checkpoints load. Each
        name resolves to `<name>.npz`, converted from `<name>.h5` when the
        directory holds upstream Keras checkpoints
        (checkpoint.checkpoint_path)."""
        import os

        from sbb_textline_detection_tpu_torch.core.config import ModelNames

        names = model_names or ModelNames()

        def load(name):
            return checkpoint.load(
                checkpoint.checkpoint_path(model_dir, name))

        if os.path.exists(checkpoint.npz_path(model_dir, names.dualhead)):
            return ModelBundle.from_jax_variables(
                load(names.page), load(names.dualhead), None, runtime,
                device, dtype)
        return ModelBundle.from_jax_variables(
            load(names.page), load(names.region), load(names.textline),
            runtime, device, dtype)
