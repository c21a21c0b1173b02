"""Inference engine (counterpart of
sbb_textline_detection_tpu/models/runner.py, limited to what
TextlineDetector's paths run).

  * `SegmentationModel.predict_small_prescaled` / `predict_whole_small`:
    the page model's whole-image forward at model resolution (label map
    back to host); `predict_smalls_prescaled_batch` /
    `predict_whole_small_batch`: K pages in one forward;
  * the fused segmentation program, in three forms that differ only in
    how the working canvas reaches the device and share everything after
    it (`_dual_tiled`: whitening outside the page box, masked Otsu, tile
    gather, in `_balanced_chunk` chunks either the dual-head forward with
    a per-head argmax or the classic region and textline forwards,
    stitch, region morphology + class mask, and the textline canvas, its
    crop or its row sum):
      - `upload_raw` + `predict_dual_tiled_resident_raw`: the original
        page goes up and the canvas is a nearest gather on the device;
      - `upload_canvas` + `predict_dual_tiled_resident`: the host scales
        the page and uploads the whole working canvas;
      - `predict_dual_tiled`: the host crops the page box and uploads the
        padded crop; `predict_dual_tiled_multi`: the same for K page
        crops of one tile grid at once;
  * `predict_tiled`: the same tiling for one model alone (the separate
    per-model path);
  * the fetch-free page box: `page_box_dev` (page forward, dilate, largest
    device component, upscale index math: a (1, 5) int32 device tensor),
    and the raw form fed by it (`predict_dual_tiled_resident_raw_headless`)
    or by the page forward run inline on the resident raw page
    (`predict_dual_tiled_resident_raw_fullfused`). The JAX program runs
    the grid of the whole working page because the box is unknown when it
    is dispatched; the port reads the five ints back (one small copy) and
    runs the box-sized grid, so every chunk holds the tiles it holds on
    the raw path and the values equal that path's;
  * `predict_dual_tiled_resident_raw(defer_fetch=True)`: the raw form's
    outputs left on the device (`DeferredFusedRaw`), for the speculative
    deskew to read before the host takes the region mask;
  * `mesh=` (parallel/mesh.make_mesh): the weights are replicated onto
    every data member, and each page's tile chunks are dealt to the
    members in turn (`_tile_labels`).

Float32 modules run inside `ops/precision.full_f32` (no TF32; see
`SegmentationModel._logits` for the bf16 ones). Every entry point is a `utils/stagetime.device_section`, and every forward adds
its FLOPs to the calling thread's stage ledger.

PyTorch runs eagerly, so there is no compile cache and no shape bucketing
beyond the tile grid; the JAX package's 1-/2-bit transfer packing
(ops/pack.py) is dropped.
"""

from __future__ import annotations

import contextlib
import copy
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from sbb_textline_detection_tpu_torch.core.config import RuntimeConfig
from sbb_textline_detection_tpu_torch.models import checkpoint, registry
from sbb_textline_detection_tpu_torch.models.registry import ModelSpec
from sbb_textline_detection_tpu_torch.ops import cc as cc_ops
from sbb_textline_detection_tpu_torch.ops import morphology, precision
from sbb_textline_detection_tpu_torch.ops import resize as resize_ops
from sbb_textline_detection_tpu_torch.ops import threshold
from sbb_textline_detection_tpu_torch.utils import profiling, stagetime

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


def _pad_white(img: np.ndarray, bottom: int, right: int, top: int = 0,
               left: int = 0) -> np.ndarray:
    if not (top or bottom or left or right):
        return img
    h, w = img.shape[:2]
    out = np.full((top + h + bottom, left + w + right) + img.shape[2:], 255,
                  img.dtype)
    out[top:top + h, left:left + w] = img
    return out


def _binarized_plane(batch: torch.Tensor, tb: torch.Tensor):
    """(channel 0 of a uint8 tile batch (n, mh, mw[, 3]), that plane
    thresholded at the per-tile Otsu thresholds `tb` as float32 0.0 / 1.0):
    the otsu_copy binarization (main.py:191-193)."""
    plane = batch[..., 0] if batch.ndim == 4 else batch
    return plane, (plane.to(torch.int32) > tb[:, None, None]).to(
        torch.float32)


class DeferredFusedRaw:
    """The single-page raw form's outputs, still on the device
    (predict_dual_tiled_resident_raw(defer_fetch=True); counterpart of the
    JAX package's DeferredFusedRaw): the shaped region canvas
    (`region_dev`, (big_h, big_w) 0/1 uint8, the crop at its top-left
    (crop_h, crop_w)), the textline canvas (`textline_dev`) and its
    crop-masked row sum. Made right behind the fused work: the region
    crop and the row sum start their copy to the host at once (into
    pinned memory, with an event), so that work enqueued after this
    handle (the speculative deskew chain) does not delay them; fetch()
    waits for that copy only."""

    def __init__(self, region_dev: torch.Tensor, textline_dev: torch.Tensor,
                 crop_hw: Tuple[int, int]):
        self.region_dev = region_dev
        self.textline_dev = textline_dev
        self.crop_hw = crop_hw
        bh, bw = crop_hw
        rowsum = textline_dev[:bh, :bw].sum(1, dtype=torch.int32)
        self._host = [_to_host_async(t) for t in (region_dev[:bh, :bw],
                                                  rowsum)]
        self._event = None
        if region_dev.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record()

    @property
    def big_hw(self) -> Tuple[int, int]:
        return tuple(self.region_dev.shape)

    def fetch(self):
        """(region_mask, row_projection, textline canvas on the device):
        the tuple the non-deferred call returns."""
        with profiling.span("fetch",
                            bytes=sum(t.numel() * t.element_size()
                                      for t in self._host)):
            if self._event is not None:
                self._event.synchronize()
            region, rowsum = (t.numpy() for t in self._host)
        return region, rowsum, self.textline_dev


def _to_host_async(t: torch.Tensor) -> torch.Tensor:
    """Start copying `t` to pinned host memory without waiting (a plain
    copy on the CPU)."""
    if t.device.type != "cuda":
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t, non_blocking=True)
    return out


def _page_box_from_small(page: "SegmentationModel", small: torch.Tensor,
                         th: int, tw: int) -> torch.Tensor:
    """Page forward and the whole border-box decision on the device
    (runner.py:127-166 of the JAX package): argmax, 3x3 dilate, largest
    pixel-count component (DEVIATIONS.md #12), its box mapped through the
    exact nearest-upscale index math to the (th, tw) working page.
    `small`: (mh, mw, 3) uint8 on the device. Returns (1, 5) int32
    [[by, bx, h, w, valid]]; an empty mask gives the whole page with the
    reference's shape quirk, [0, 0, th - 1, tw - 1, 0]."""
    x = small[None].to(torch.float32) / 255.0
    labels = torch.argmax(page._logits(x.permute(0, 3, 1, 2))[0], 0)
    mh, mw = labels.shape
    dil = morphology.dilate((labels != 0).to(torch.uint8), 3, 1)
    box, valid = cc_ops.largest_component_box(dil)
    bx, by, bw, bh = (box[i].to(torch.int64) for i in range(4))

    def ceil_div(a, b):
        return -torch.div(-a, b, rounding_mode="floor")

    # working pixels whose nearest source index is j span
    # [ceil(j*W/mw), ceil((j+1)*W/mw) - 1]
    x0 = ceil_div(bx * tw, mw)
    x1 = ceil_div((bx + bw) * tw, mw) - 1
    y0 = ceil_div(by * th, mh)
    y1 = ceil_div((by + bh) * th, mh) - 1
    found = torch.stack([y0, x0, (y1 - y0 + 1).clamp(min=1),
                         (x1 - x0 + 1).clamp(min=1), torch.ones_like(y0)])
    whole = torch.tensor([0, 0, th - 1, tw - 1, 0], dtype=torch.int64,
                         device=small.device)
    return torch.where(valid, found, whole).to(torch.int32)[None]


def _device_entry(fn):
    """A SegmentationModel entry point that puts work on the model's
    device: it builds no autograd graph (torch.no_grad is thread-local, so
    each entry point sets it for whichever thread calls it) and is one
    stagetime.device_section. Entry points do not call each other."""
    @functools.wraps(fn)
    def entry(self, *args, **kwargs):
        with torch.no_grad(), stagetime.device_section(self.device):
            return fn(self, *args, **kwargs)
    return entry


class SegmentationModel:
    """One loaded TpuUnet or ResNet50Unet on a device."""

    def __init__(self, spec, state_dict, runtime: RuntimeConfig | None = None,
                 device="cuda", dtype: torch.dtype | None = None, mesh=None):
        """`mesh`: optional parallel/mesh.Mesh. The weights are replicated
        onto the first device of each of its data rows once, here, and
        every tiled path spreads a page's tile chunks over those members
        (_tile_labels); the results come back to `device`. Every other
        forward runs the model on `device`. Without a mesh the one member
        is the model on `device`."""
        self.spec = _as_spec(spec)
        self.runtime = runtime or RuntimeConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # "cuda" names the current card; a mesh lists cards by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.mesh = mesh
        self.dtype = dtype or getattr(torch, self.runtime.compute_dtype)
        self.module = registry.build_module(self.spec, self.dtype)
        # strict: a checkpoint that does not match the architecture fails
        # here, not as a degraded page later
        self.module.load_state_dict(state_dict)
        self.module.to(self.device).eval()
        # (device, module) per data member
        self.members = [(self.device, self.module)]
        if mesh is not None:
            self.members = [
                (dev, self.module if i == 0 and dev == self.device
                 else copy.deepcopy(self.module).to(dev))
                for i, dev in enumerate(mesh.data_members)]
        # FLOPs of one forward per sample, by input shape without the batch
        self._flops_per_sample: Dict[tuple, float] = {}
        # serve every forward inside precision.full_f32 (_logits); a
        # ModelBundle that mixes dtypes sets it on its bf16 models too
        self.without_tf32 = self.computes_f32

    @property
    def input_hw(self) -> Tuple[int, int]:
        return self.spec.input_height, self.spec.input_width

    # -- precision -----------------------------------------------------------
    @property
    def computes_f32(self) -> bool:
        """True when the module's convolutions run in float32: a TpuUnet
        built with dtype float32, and every ResNet50Unet."""
        return getattr(self.module, "dtype", torch.float32) == torch.float32

    def _logits(self, x: torch.Tensor,
                member: Optional[int] = None) -> torch.Tensor:
        """The forward of data member `member`'s module on an NCHW batch
        on its device (of the model on `device` when `member` is None).
        A float32 model runs inside precision.full_f32, as the reference
        computes it in full float32; so does a bf16 TpuUnet whose bundle
        also holds a float32 model (`without_tf32`). Other bf16 TpuUnets
        run on the kernels cuDNN's TF32 switch picks: their convs are
        float32 sums of bf16 values either way, but the TF32 and the
        float32 kernels add them in different orders, so the switch must
        not flip during their forwards. Only float32 forwards flip it
        (the deskew matmuls leave it alone: full_f32(convs=False)), and
        only a mixed bundle has both kinds. Its FLOPs go to the calling
        thread's stage ledger: counted on the first forward of each input
        shape (stagetime.count_flops), then scaled by the batch."""
        forward = (self.module if member is None
                   else self.members[member][1]).forward_nchw
        key = tuple(x.shape[1:])
        per_sample = self._flops_per_sample.get(key)
        with (precision.full_f32() if self.without_tf32
              else contextlib.nullcontext()):
            if per_sample is None:
                logits, flops = stagetime.count_flops(forward, x)
                per_sample = self._flops_per_sample[key] = flops / x.shape[0]
            else:
                logits = forward(x)
        stagetime.add(0.0, per_sample * x.shape[0])
        return logits

    # -- page model --------------------------------------------------------
    def predict_small_prescaled(self, small_u8: np.ndarray) -> np.ndarray:
        """(model_h, model_w, 3) uint8 page-model input -> (model_h,
        model_w) uint8 label map on the host."""
        mh, mw = self.input_hw
        if small_u8.shape[:2] != (mh, mw):
            raise ValueError(f"expected {(mh, mw)} input, got "
                             f"{small_u8.shape[:2]}")
        return self.predict_smalls_prescaled_batch(small_u8[None])[0]

    @_device_entry
    def predict_smalls_prescaled_batch(self, smalls_u8,
                                       pad_to: Optional[int] = None
                                       ) -> np.ndarray:
        """K (model_h, model_w, 3) uint8 page-model inputs in ONE forward
        and one fetch -> (K, model_h, model_w) uint8 label maps on the
        host: the batched page-box stage of process_batch. `pad_to` is
        accepted for the reference's callers and not used: the reference
        pads a short window with white pages so that every window runs one
        compiled program, and PyTorch compiles nothing per batch size, so
        the port runs the K inputs it was given. The label maps equal K
        single forwards up to argmax ties where cuDNN picks another
        algorithm for another batch size."""
        smalls = np.asarray(smalls_u8)
        mh, mw = self.input_hw
        if smalls.ndim != 4 or smalls.shape[1:] != (mh, mw, 3):
            raise ValueError(f"expected (k, {mh}, {mw}, 3) input, got "
                             f"{smalls.shape}")
        x = self._to_device(smalls).to(torch.float32) / 255.0
        logits = self._logits(x.permute(0, 3, 1, 2))
        return profiling.fetch(torch.argmax(logits, dim=1).to(torch.uint8))

    def predict_whole_small(self, img_u8: np.ndarray) -> np.ndarray:
        """Whole-image forward without the final upscale: nearest-resize
        to model size on the host, predict, argmax; returns the (model_h,
        model_w) label map."""
        mh, mw = self.input_hw
        return self.predict_small_prescaled(
            resize_ops.resize_nearest_host(img_u8, mh, mw))

    def predict_whole_small_batch(self, imgs_u8) -> np.ndarray:
        """K pages' whole-image forwards in one: each is nearest-resized
        to model size on the host; returns the (K, model_h, model_w)
        label maps."""
        mh, mw = self.input_hw
        return self.predict_smalls_prescaled_batch(np.stack([
            resize_ops.resize_nearest_host(np.asarray(im), mh, mw)
            for im in imgs_u8]))

    @_device_entry
    def page_box_dev(self, small_u8: np.ndarray, target_h: int,
                     target_w: int) -> torch.Tensor:
        """The page forward and the border-box decision on the device: a
        (1, 5) int32 device tensor [[by, bx, h, w, valid]] in (target_h,
        target_w) working coordinates, with no fetch. Box semantics of
        stages._page_box_model_res, with pixel-count component areas
        (DEVIATIONS.md #12)."""
        mh, mw = self.input_hw
        if small_u8.shape[:2] != (mh, mw):
            raise ValueError(f"expected {(mh, mw)} input, got "
                             f"{small_u8.shape[:2]}")
        return _page_box_from_small(self, self._to_device(small_u8),
                                    int(target_h), int(target_w))

    # -- geometry ----------------------------------------------------------
    def _stride(self, margin_ratio: float) -> Tuple[int, int, int]:
        """(margin, stride_h, stride_w): every tile keeps its central
        stride_h x stride_w slab."""
        mh, mw = self.input_hw
        margin = int(margin_ratio * mw)
        return margin, mh - 2 * margin, mw - 2 * margin

    def grid_for(self, h: int, w: int, margin_ratio: float = 0.1
                 ) -> Tuple[int, int]:
        """(ny, nx) tile grid for an (h, w) crop: ny rounds up to
        runtime.grid_bucket, nx to runtime.grid_bucket_x."""
        _, sh, sw = self._stride(margin_ratio)
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
        margin, sh, sw = self._stride(margin_ratio)
        ch = margin + scaled_h + sh + margin
        cw = margin + scaled_w + sw + margin
        return (-(-ch // 128) * 128, -(-cw // 128) * 128)

    # -- uploads -------------------------------------------------------------
    @_device_entry
    def upload_raw(self, image: np.ndarray) -> torch.Tensor:
        """Pad the ORIGINAL page to 128-multiples (white) and copy it to
        the device. `image` is (h, w, 3) RGB or one (h, w) plane: the
        detector ships a plane when the page's channels are byte-identical
        or the dual-head model (which reads channel 0 only) serves it. The
        working canvas is gathered on the device by
        predict_dual_tiled_resident_raw."""
        h, w = image.shape[:2]
        ph, pw = -(-h // 128) * 128, -(-w // 128) * 128
        return self._to_device(_pad_white(image, ph - h, pw - w))

    @_device_entry
    def upload_canvas(self, scaled_img: np.ndarray,
                      margin_ratio: float = 0.1) -> torch.Tensor:
        """Pad the working-resolution page into its white canvas on the
        host (`margin` top/left, canvas_shape_for's slack bottom/right)
        and copy it to the device, for predict_dual_tiled_resident."""
        margin = self._stride(margin_ratio)[0]
        h, w = scaled_img.shape[:2]
        ch, cw = self.canvas_shape_for(h, w, margin_ratio)
        return self._to_device(_pad_white(
            scaled_img, ch - h - margin, cw - w - margin, margin, margin))

    def _to_device(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    # -- forwards on tile batches ------------------------------------------------
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

    def _forward_labels(self, batch: torch.Tensor,
                        tb: Optional[torch.Tensor] = None,
                        member: int = 0) -> torch.Tensor:
        """uint8 labels (n, mh, mw) of a uint8 tile batch, (n, mh, mw) or
        (n, mh, mw, 3), on data member `member`'s device. With per-tile
        Otsu thresholds `tb`, the model sees channel 0 thresholded as
        0.0 / 1.0 on all 3 channels (otsu_copy, main.py:191-193); else the
        tiles / 255 (main.py:490-503), a plane repeated to 3 channels."""
        if tb is not None:
            x = _binarized_plane(batch, tb)[1][:, None].expand(-1, 3, -1, -1)
        else:
            x = batch.to(torch.float32) / 255.0
            x = x.permute(0, 3, 1, 2) if batch.ndim == 4 \
                else x[:, None].expand(-1, 3, -1, -1)
        return torch.argmax(self._logits(x, member), 1).to(torch.uint8)

    def _forward_pair(self, other: "SegmentationModel", batch: torch.Tensor,
                      tb: torch.Tensor, member: int = 0):
        """(region labels, textline labels) uint8 (n, mh, mw) of a uint8
        tile batch, (n, mh, mw) or (n, mh, mw, 3), with per-tile Otsu
        thresholds `tb` (runner.py:483-556 in the JAX package), on data
        member `member`'s device.

        Dual-head model: one forward on [raw01 (channel 0 / 255), channel 0
        thresholded] and an argmax per head. Classic pair: the region model
        sees the thresholded tiles and the textline model the tiles / 255
        (_forward_labels)."""
        if self._is_dual_head_pair(other):
            plane, ch0 = _binarized_plane(batch, tb)
            h0 = int(self.spec.heads[0])
            rawf = plane.to(torch.float32) / 255.0
            logits = self._logits(torch.stack([rawf, ch0], 1), member)
            return (torch.argmax(logits[:, :h0], 1).to(torch.uint8),
                    torch.argmax(logits[:, h0:], 1).to(torch.uint8))
        return (self._forward_labels(batch, tb, member),
                other._forward_labels(batch, None, member))

    # -- tiled segmentation ------------------------------------------------------
    def _tile_labels(self, canvases, boxes, ny: int, nx: int,
                     margin_ratio: float, forward, valid=None):
        """The section every tiled path shares. `canvases`: K uint8 device
        canvases (ch, cw) or (ch, cw, 3) of one shape, whose working-image
        origin lies at (margin, margin); `boxes`: (K, 4) [by, bx, crop_h,
        crop_w] in working coordinates. Per page: whiten everything
        outside the crop box (and outside `valid`, a (ch, cw) bool map of
        the canvas pixels that hold page data), take the Otsu threshold
        of channel 0 over the box, gather the ny x nx tiles from the box
        origin (starts clamp into the canvas). Then `forward(batch, tb,
        member)` -> a tuple of uint8 label batches runs page by page in the
        `_balanced_chunk` chunks of ONE page's tiles, and each label
        stream is stitched into (K, ny * stride_h, nx * stride_w): every
        output pixel lies in exactly one tile's central slab, so stitching
        is one reshape.

        With d data members (mesh=), a page's chunk is capped at ceil(n /
        d) tiles as well, so that one page spreads over every member, and
        its chunks are dealt to the members in turn (chunk j to member j
        mod d): each goes to its member's device with a non-blocking copy,
        runs there, and its labels come back to `self.device` in tile
        order. Where ceil(n / d) lies below the unmeshed chunk, a page's
        chunks have another size than unmeshed, and its bf16 labels may
        differ from the unmeshed page's by the argmax tie flips described
        below (an A4 page's 108 tiles run in chunks of 54 either way on
        two members).

        A chunk never holds tiles of two pages: every forward of a group
        then has the batch size it has when the page is served alone, so
        cuDNN runs the same algorithms and a grouped page's labels equal
        its own. (The reference chunks the K pages' tiles together; its
        compiler gives the same values for any batch size, cuDNN does
        not: on full-width random bf16 weights, chunks of 87 tiles of 4
        pages against 54 of one moved 1.6 % of a page's region-mask
        pixels, PERF.md section 6.)"""
        mh, mw = self.input_hw
        margin, sh, sw = self._stride(margin_ratio)
        k = len(canvases)
        ch, cw = canvases[0].shape[:2]
        dev = self.device
        cy = torch.arange(ch, device=dev)[:, None]
        cx = torch.arange(cw, device=dev)[None, :]
        white = torch.tensor(255, dtype=torch.uint8, device=dev)
        n = ny * nx
        jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
        tiles, ts = [], []
        for cv, (by, bx, bh, bw) in zip(canvases, boxes):
            inside = ((cy >= margin + by) & (cy < margin + by + bh)
                      & (cx >= margin + bx) & (cx < margin + bx + bw))
            keep = inside if valid is None else valid & inside
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
        profiling.note("tiles", k * n)
        t_tiles = torch.stack(ts).repeat_interleave(n)

        d = len(self.members)
        chunk = _balanced_chunk(n, min(self.runtime.tile_chunk, -(-n // d)))
        streams = None
        for p0 in range(0, k * n, n):
            for j, c0 in enumerate(range(p0, p0 + n, chunk)):
                c1 = min(c0 + chunk, p0 + n)
                member = j % d
                mdev = self.members[member][0]
                out = forward(tiles[c0:c1].to(mdev, non_blocking=True),
                              t_tiles[c0:c1].to(mdev, non_blocking=True),
                              member)
                streams = streams or [[] for _ in out]
                for stream, labels in zip(streams, out):
                    stream.append(labels.to(dev, non_blocking=True))

        def stitch(labels):
            slabs = torch.cat(labels)[:, margin:margin + sh,
                                      margin:margin + sw]
            return (slabs.reshape(k, ny, nx, sh, sw).permute(0, 1, 3, 2, 4)
                    .reshape(k, ny * sh, nx * sw))

        return [stitch(stream) for stream in streams]

    def _shape_labels(self, canvas: torch.Tensor, bh: int, bw: int,
                      morph: Optional[MorphSpec], mask_class: Optional[int],
                      post_morph: Optional[MorphSpec]) -> torch.Tensor:
        """Label morphology on a stitched (big_h, big_w) canvas whose crop
        is its top-left (bh, bw); with `mask_class`, the binary class mask
        and `post_morph` on it (main.py:2074-2075, 457-464)."""
        dev = canvas.device
        ins = ((torch.arange(canvas.shape[0], device=dev)[:, None] < int(bh))
               & (torch.arange(canvas.shape[1], device=dev)[None, :]
                  < int(bw)))
        c = morphology.apply_morph(canvas, morph or (), ins)
        if mask_class is not None:
            c = (c == mask_class).to(torch.uint8)
            c = morphology.apply_morph(c, post_morph or (), ins)
        return c

    def _padded_crop(self, img_u8: np.ndarray, margin_ratio: float):
        """The crop-upload form of a canvas: `img_u8` padded white by
        `margin` top/left and up to the tile grid plus `margin`
        bottom/right, on the device, with its box and grid."""
        h, w = img_u8.shape[:2]
        margin, sh, sw = self._stride(margin_ratio)
        ny, nx = self.grid_for(h, w, margin_ratio)
        canvas = self._to_device(_pad_white(
            img_u8, ny * sh - h + margin, nx * sw - w + margin, margin,
            margin))
        return canvas, np.asarray([[0, 0, h, w]], np.int32), ny, nx

    @_device_entry
    def predict_tiled(self, img_u8: np.ndarray, margin_ratio: float = 0.1,
                      morph: Optional[MorphSpec] = None,
                      pre_otsu: bool = False,
                      mask_class: Optional[int] = None,
                      post_morph: Optional[MorphSpec] = None) -> np.ndarray:
        """Patch mode (main.py:231-364) of one model over an (h, w, 3)
        image: returns the (h, w) uint8 label map after the `morph` ops,
        or with `mask_class` the 0/1 class mask after `post_morph`. With
        `pre_otsu` the model sees the otsu_copy binarization of the image
        (main.py:178-194). The page is padded white so that each output
        pixel lies in one tile's central slab (see the JAX package's
        predict_tiled on how that differs from the reference grid within
        `margin` of the page border)."""
        canvas, boxes, ny, nx = self._padded_crop(img_u8, margin_ratio)

        def forward(batch, tb, member):
            return (self._forward_labels(batch, tb if pre_otsu else None,
                                         member),)

        labels, = self._tile_labels([canvas], boxes, ny, nx, margin_ratio,
                                    forward)
        h, w = img_u8.shape[:2]
        out = self._shape_labels(labels[0], h, w, morph, mask_class,
                                 post_morph)
        return profiling.fetch(out[:h, :w])

    def _dual_tiled_device(self, other: "SegmentationModel", canvases,
                           boxes, margin_ratio, morph, mask_class,
                           post_morph, valid=None):
        """Fused region + textline segmentation of K canvases (see
        _tile_labels), left on the device: per page (the shaped region
        canvas, the textline canvas), each (ny * stride_h, nx * stride_w)
        with the page crop at its top-left."""
        if self.input_hw != other.input_hw:
            raise ValueError("dual tiled predict needs identical geometry")
        grids = {self.grid_for(int(b[2]), int(b[3]), margin_ratio)
                 for b in boxes}
        if len(grids) != 1:
            raise ValueError(f"pages span multiple tile grids "
                             f"{sorted(grids)}; group pages by grid_for() "
                             "before fusing")
        ny, nx = grids.pop()
        if len({tuple(c.shape) for c in canvases}) != 1:
            raise ValueError("canvas shapes differ")
        canvas_r, canvas_t = self._tile_labels(
            canvases, boxes, ny, nx, margin_ratio,
            functools.partial(self._forward_pair, other), valid)
        return [(self._shape_labels(canvas_r[i], int(bh), int(bw), morph,
                                    mask_class, post_morph), canvas_t[i])
                for i, (_, _, bh, bw) in enumerate(boxes)]

    def _dual_tiled(self, other: "SegmentationModel", canvases, boxes,
                    margin_ratio, morph, mask_class, post_morph,
                    return_device_textline: bool, textline_projection: bool,
                    valid=None):
        """Fused region + textline segmentation of K canvases (see
        _tile_labels). Per page: (region, textline labels) on the host,
        plus the textline canvas on the device with
        `return_device_textline`; with `textline_projection` the textline
        canvas does not cross to the host and the crop-masked row sum
        (int32, what reading order consumes, main.py:1809-1822) stands in
        its place."""
        if textline_projection and not return_device_textline:
            raise ValueError("textline_projection requires "
                             "return_device_textline")
        pages = self._dual_tiled_device(other, canvases, boxes,
                                        margin_ratio, morph, mask_class,
                                        post_morph, valid)
        out = []
        for (region, tl), (_, _, bh, bw) in zip(pages, boxes):
            bh, bw = int(bh), int(bw)
            region = profiling.fetch(region[:bh, :bw])
            if textline_projection:
                rowsum = tl[:bh, :bw].sum(1, dtype=torch.int32)
                out.append((region, profiling.fetch(rowsum), tl))
            elif return_device_textline:
                out.append((region, profiling.fetch(tl[:bh, :bw]), tl))
            else:
                out.append((region, profiling.fetch(tl[:bh, :bw])))
        return out

    @_device_entry
    def predict_dual_tiled(self, other: "SegmentationModel",
                           img_u8: np.ndarray, margin_ratio: float = 0.1,
                           morph: Optional[MorphSpec] = None,
                           mask_class: Optional[int] = None,
                           post_morph: Optional[MorphSpec] = None,
                           return_device_textline: bool = False,
                           textline_projection: bool = False):
        """Both segmentation passes of the page crop `img_u8` (h, w, 3),
        uploaded padded (the crop-upload path): `self` (the region model)
        sees the Otsu-binarized tiles with its label morph / class mask /
        mask morph applied, `other` (the textline model) the raw tiles;
        the dual-head model serves both in one forward. Returns
        (region_mask_01, textline_labels[, textline canvas on the
        device]), or in projection mode (region_mask_01,
        row_projection[:h], textline canvas on the device)."""
        canvas, boxes, _, _ = self._padded_crop(img_u8, margin_ratio)
        return self._dual_tiled(other, [canvas], boxes, margin_ratio, morph,
                                mask_class, post_morph,
                                return_device_textline,
                                textline_projection)[0]

    @_device_entry
    def predict_dual_tiled_multi(self, other: "SegmentationModel", imgs,
                                 margin_ratio: float = 0.1,
                                 morph: Optional[MorphSpec] = None,
                                 mask_class: Optional[int] = None,
                                 post_morph: Optional[MorphSpec] = None,
                                 return_device_textline: bool = False,
                                 textline_projection: bool = False):
        """predict_dual_tiled for K page crops at once: each crop goes up
        padded, and the K pages' tiles are gathered, run (in each page's
        own chunks, see _tile_labels) and stitched together. Every page
        keeps its own Otsu threshold and its own white border, so each
        result equals its predict_dual_tiled. All crops must map to ONE
        tile grid (grid_for): a smaller page on a larger grid would see
        its canvas border moved, and ValueError says so. Returns one tuple
        per page, in input order."""
        crops = [self._padded_crop(im, margin_ratio) for im in imgs]
        return self._dual_tiled(other, [c[0] for c in crops],
                                np.concatenate([c[1] for c in crops]),
                                margin_ratio, morph, mask_class, post_morph,
                                return_device_textline, textline_projection)

    @_device_entry
    def predict_dual_tiled_resident(self, other: "SegmentationModel",
                                    canvases, boxes,
                                    margin_ratio: float = 0.1,
                                    morph: Optional[MorphSpec] = None,
                                    mask_class: Optional[int] = None,
                                    post_morph: Optional[MorphSpec] = None,
                                    return_device_textline: bool = False,
                                    textline_projection: bool = False):
        """predict_dual_tiled reading the page crops out of RESIDENT
        margin-padded working canvases (upload_canvas) of one shape, with
        per-page box offsets [by, bx, crop_h, crop_w] in working
        coordinates. Equal to predict_dual_tiled on the cropped page:
        tiles read white outside the crop box exactly like the padded
        crop, and the Otsu histogram covers the same crop pixels. Returns
        one tuple per page."""
        boxes = np.asarray(boxes, np.int32).reshape(len(canvases), 4)
        return self._dual_tiled(other, canvases, boxes, margin_ratio, morph,
                                mask_class, post_morph,
                                return_device_textline, textline_projection)

    @_device_entry
    def predict_dual_tiled_resident_raw(self, other: "SegmentationModel",
                                        raws, boxes, scaled_hws,
                                        margin_ratio: float = 0.1,
                                        morph: Optional[MorphSpec] = None,
                                        mask_class: Optional[int] = None,
                                        post_morph: Optional[MorphSpec] = None,
                                        return_device_textline: bool = False,
                                        raw_hws=None,
                                        textline_projection: bool = False,
                                        defer_fetch: bool = False):
        """predict_dual_tiled_resident reading K resident raw pages
        (upload_raw, one plane or RGB): each working canvas is gathered on
        the device through the exact nearest index maps. `boxes`: per page
        [by, bx, crop_h, crop_w] in working coordinates; `scaled_hws`: per
        page working (h, w), all equal; `raw_hws`: the original page dims
        before upload_raw's padding. `other` is the textline model: `self`
        for the dual-head model, else the classic textline model of the
        same tile size. With `defer_fetch` (one page, a class mask and the
        projection mode) the result is a DeferredFusedRaw whose fetch()
        returns the page's tuple."""
        k = len(raws)
        boxes = np.asarray(boxes, np.int32).reshape(k, 4)
        if len({tuple(s) for s in scaled_hws}) != 1:
            raise ValueError("pages span multiple working sizes; group "
                             "before fusing")
        if len({tuple(r.shape) for r in raws}) != 1:
            raise ValueError("raw shapes differ")
        if raw_hws is None:
            raw_hws = [tuple(r.shape[:2]) for r in raws]
        if len({tuple(s) for s in raw_hws}) != 1:
            raise ValueError("pages span multiple raw sizes; group first")
        canvases, valid = self._raw_canvases(raws, scaled_hws[0], raw_hws[0],
                                             margin_ratio)
        if defer_fetch:
            if k != 1 or mask_class is None or not (
                    return_device_textline and textline_projection):
                raise ValueError("defer_fetch is for one page in the "
                                 "projection mode with a class mask")
            (region, tl), = self._dual_tiled_device(
                other, canvases, boxes, margin_ratio, morph, mask_class,
                post_morph, valid)
            return DeferredFusedRaw(region, tl, (int(boxes[0, 2]),
                                                 int(boxes[0, 3])))
        return self._dual_tiled(other, canvases, boxes, margin_ratio, morph,
                                mask_class, post_morph,
                                return_device_textline, textline_projection,
                                valid)

    def _raw_canvases(self, raws, scaled_hw, raw_hw, margin_ratio):
        """The working canvases of resident raw pages of one shape, gathered
        on the device through the exact nearest index maps (stages.
        scale_image's resize, main.py:196-214), and the (ch, cw) bool map
        of the canvas pixels that hold page data."""
        th, tw = scaled_hw
        raw_h, raw_w = raw_hw
        pad_h, pad_w = raws[0].shape[:2]
        margin = self._stride(margin_ratio)[0]
        ch, cw = self.canvas_shape_for(th, tw, margin_ratio)
        dev = self.device
        # canvas row i -> raw row (or -1 = white): margin offset baked in
        iy = np.full(ch, -1, np.int64)
        ix = np.full(cw, -1, np.int64)
        iy[margin:margin + th] = resize_ops._nearest_indices(th, raw_h)
        ix[margin:margin + tw] = resize_ops._nearest_indices(tw, raw_w)
        iy_t = torch.from_numpy(iy).to(dev)
        ix_t = torch.from_numpy(ix).to(dev)
        valid = (iy_t[:, None] >= 0) & (ix_t[None, :] >= 0)
        rows = iy_t.clamp(0, pad_h - 1)
        cols = ix_t.clamp(0, pad_w - 1)
        return [raw.index_select(0, rows).index_select(1, cols)
                for raw in raws], valid

    def _raw_from_box(self, other, raw, box5, scaled_hw, margin_ratio, morph,
                      mask_class, post_morph, raw_hw):
        """The raw form of one page from a device box5 [[by, bx, h, w,
        valid]]: the five ints are read back (one small copy), and the
        page runs the box-sized grid of the raw path (so its chunks hold
        the raw path's tiles). Returns (region_mask, row_projection,
        textline canvas on the device, box5 as a host int32 array)."""
        if mask_class is None:
            raise ValueError("the fetch-free forms need mask_class")
        if tuple(box5.shape) != (1, 5):
            raise ValueError(f"box5 must be (1, 5), got {tuple(box5.shape)}")
        b = profiling.fetch(box5).reshape(5).astype(np.int32)
        if raw_hw is None:
            raw_hw = tuple(raw.shape[:2])
        canvases, valid = self._raw_canvases([raw], scaled_hw, raw_hw,
                                             margin_ratio)
        region, proj, tl = self._dual_tiled(
            other, canvases, b[None, :4], margin_ratio, morph, mask_class,
            post_morph, True, True, valid)[0]
        return region, proj, tl, b

    @_device_entry
    def predict_dual_tiled_resident_raw_headless(
            self, other: "SegmentationModel", raw, boxes5_dev,
            scaled_hw, margin_ratio: float = 0.1,
            morph: Optional[MorphSpec] = None,
            mask_class: Optional[int] = None,
            post_morph: Optional[MorphSpec] = None,
            raw_hw=None):
        """predict_dual_tiled_resident_raw of one resident raw page with
        its page box as a device input (page_box_dev's (1, 5) result), in
        the projection mode with a class mask. Returns (region_mask,
        row_projection, textline canvas on the device, box5) with box5
        the host [by, bx, h, w, valid] (runner.py:1028-1094 of the JAX
        package; see _raw_from_box on the grid)."""
        return self._raw_from_box(other, raw, boxes5_dev, scaled_hw,
                                  margin_ratio, morph, mask_class,
                                  post_morph, raw_hw)

    @_device_entry
    def predict_dual_tiled_resident_raw_fullfused(
            self, other: "SegmentationModel", page: "SegmentationModel",
            raw, small_ys, small_xs, scaled_hw, margin_ratio: float = 0.1,
            morph: Optional[MorphSpec] = None,
            mask_class: Optional[int] = None,
            post_morph: Optional[MorphSpec] = None,
            raw_hw=None):
        """The page's whole device phase from its resident raw page: the
        page model's input is gathered on the device (`small_ys` /
        `small_xs`, the composed two-stage nearest index maps of ops/
        resize.compose_nearest_indices; a one-plane page is repeated to 3
        channels), the page forward and box decision run there
        (_page_box_from_small), and the box feeds the fused segmentation.
        Returns what predict_dual_tiled_resident_raw_headless returns
        (runner.py:1096-1164 of the JAX package)."""
        pmh, pmw = page.input_hw
        ys = torch.from_numpy(np.asarray(small_ys, np.int64).reshape(pmh)
                              ).to(raw.device)
        xs = torch.from_numpy(np.asarray(small_xs, np.int64).reshape(pmw)
                              ).to(raw.device)
        small = raw.index_select(0, ys).index_select(1, xs)
        if small.ndim == 2:
            small = small[..., None].expand(pmh, pmw, 3)
        th, tw = scaled_hw
        box5 = _page_box_from_small(page, small, int(th), int(tw))
        return self._raw_from_box(other, raw, box5, scaled_hw, margin_ratio,
                                  morph, mask_class, post_morph, raw_hw)


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
        # a float32 model's forwards switch cuDNN's TF32 off on the
        # pipelined batch's threads; beside one, the bf16 models are
        # served with it off too (SegmentationModel._logits)
        models = (page, region, textline)
        if len({m.computes_f32 for m in models}) > 1:
            for m in models:
                m.without_tf32 = True

    @property
    def is_dual_head(self) -> bool:
        return (self.region is self.textline
                and bool(self.region.spec.heads))

    @staticmethod
    def _from_state(page, region, textline, runtime, device, dtype,
                    mesh=None) -> "ModelBundle":
        """Each role a (spec, state_dict) pair; `textline` None means
        `region` is the dual-head model and serves both roles. Every model
        takes `mesh`."""
        def build(spec_sd):
            return SegmentationModel(spec_sd[0], spec_sd[1], runtime, device,
                                     dtype, mesh)

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
                    specs=None, dual_head: bool = False,
                    mesh=None) -> "ModelBundle":
        """Randomly initialized bundle (tests / smoke runs): each model
        holds the JAX package's initial weights for `seed`
        (registry.init_variables).
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
            return spec, registry.init_variables(spec, seed)

        return ModelBundle._from_state(
            pair(specs["page"]), pair(specs["region"]),
            pair(specs["textline"]), runtime, device, dtype, mesh)

    @staticmethod
    def from_jax_variables(page, region, textline=None,
                           runtime: RuntimeConfig | None = None,
                           device="cuda", dtype: torch.dtype | None = None,
                           mesh=None) -> "ModelBundle":
        """Bundle from (spec, Flax variable tree) pairs, the trees nested
        dicts of arrays: the page model, the region model and the textline
        model, or with `textline` None, the dual-head model as `region`."""
        def state(pair):
            return None if pair is None else (
                pair[0], checkpoint.params_from_flax(pair[1]))

        return ModelBundle._from_state(state(page), state(region),
                                       state(textline), runtime, device,
                                       dtype, mesh)

    @staticmethod
    def from_dir(model_dir: str, runtime: RuntimeConfig | None = None,
                 device="cuda", model_names=None,
                 dtype: torch.dtype | None = None,
                 mesh=None) -> "ModelBundle":
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
                device, dtype, mesh)
        return ModelBundle.from_jax_variables(
            load(names.page), load(names.region), load(names.textline),
            runtime, device, dtype, mesh)
