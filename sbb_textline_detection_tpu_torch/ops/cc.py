"""Connected components on the device (counterpart of
sbb_textline_detection_tpu/ops/cc.py): the page-box decision's largest
component and the speculative deskew's region boxes, without a trip of the
mask to the host.

Output contract, as in the JAX package: labels are 8-connected, each
foreground pixel holds its component's smallest flat index and the
background holds H*W; component areas are PIXEL COUNTS (DEVIATIONS.md #12:
the host oracle ranks contours by their polygon area); boxes are
`[y, x, h, w, valid]` with the passing components compacted to the front
in scan order.

Algorithm: min-label propagation to a fixpoint. Every foreground pixel
starts with its own flat index; one sweep takes the min over each
horizontal and each vertical run of foreground pixels (a label crosses a
whole straight run at once), then the min over the 3x3 neighbourhood (the
diagonal links of 8-connectivity), then one pointer jump (a pixel takes
the label its label's pixel holds, which lies in the same component). The
sweep count grows with the bends of the worst component, not its length.
The JAX package's Hillis-Steele doubling and hand-rolled cumsum worked
around its TPU compiler; `torch.cumsum` and `scatter_reduce` need no such
help. Plain PyTorch throughout: the JAX package computes this in XLA, not
in a Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _run_min(lab: torch.Tensor, fg: torch.Tensor) -> torch.Tensor:
    """Min of `lab` over each horizontal run of `fg` pixels, at every pixel
    of the run; background pixels keep their value."""
    h, w = fg.shape
    start = fg.clone()
    start[:, 1:] &= ~fg[:, :-1]
    run = torch.cumsum(start.reshape(-1), 0) - 1        # run id per pixel
    n = int(h * w)
    ids = torch.where(fg.reshape(-1), run, torch.full_like(run, n))
    mins = torch.full((n + 1,), n, dtype=lab.dtype, device=lab.device)
    mins.scatter_reduce_(0, ids, lab.reshape(-1), "amin", include_self=True)
    return torch.where(fg, mins[ids].reshape(h, w), lab)


def _min3x3(lab: torch.Tensor, big: int) -> torch.Tensor:
    """3x3 neighbourhood min of an int tensor, `big` outside the image."""
    h, w = lab.shape
    p = torch.nn.functional.pad(lab[None, None].to(torch.int64),
                                (1, 1, 1, 1), value=big)[0, 0]
    out = lab.to(torch.int64)
    for dy in range(3):
        for dx in range(3):
            out = torch.minimum(out, p[dy:dy + h, dx:dx + w])
    return out.to(lab.dtype)


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of `mask != 0`, on the mask's device:
    (H, W) int32, each foreground pixel its component's smallest flat
    index, the background H*W (the host oracle ops/contours.
    label_components induces the same partition with dense ids).

    Syncs with the host once per sweep, to read whether any label changed
    (`bool(changed)`); the sweeps before that read are queued back to
    back."""
    fg = mask != 0
    h, w = fg.shape
    big = int(h * w)
    iota = torch.arange(big, dtype=torch.int32, device=mask.device
                        ).reshape(h, w)
    lab = torch.where(fg, iota, torch.full_like(iota, big))
    fg_t = fg.t().contiguous()
    while True:
        new = _run_min(lab, fg)
        new = _run_min(new.t().contiguous(), fg_t).t().contiguous()
        new = torch.where(fg, _min3x3(new, big), new)
        flat = new.reshape(-1)
        jump = flat[flat.clamp(max=big - 1).to(torch.int64)].reshape(h, w)
        new = torch.where(fg, torch.minimum(new, jump), new)
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            return lab


def _slot_extents(slot: torch.Tensor, k: int, h: int, w: int):
    """Per slot 0..k-1 of an (h, w) slot map (k = none): pixel count and
    the extents y0, y1, x0, x1 (h, -1, w, -1 where the slot is empty)."""
    dev = slot.device
    flat = slot.reshape(-1).to(torch.int64)
    ys = torch.arange(h, device=dev, dtype=torch.int64
                      )[:, None].expand(h, w).reshape(-1)
    xs = torch.arange(w, device=dev, dtype=torch.int64
                      )[None, :].expand(h, w).reshape(-1)
    area = torch.bincount(flat, minlength=k + 1)[:k]

    def reduce(src, fill, how):
        out = torch.full((k + 1,), fill, dtype=torch.int64, device=dev)
        return out.scatter_reduce_(0, flat, src, how, include_self=True)[:k]

    return (area, reduce(ys, h, "amin"), reduce(ys, -1, "amax"),
            reduce(xs, w, "amin"), reduce(xs, -1, "amax"))


def component_boxes_topk(mask: torch.Tensor, k: int, min_area: float,
                         max_area: float) -> torch.Tensor:
    """Bounding boxes of the first `k` 8-connected components of
    `mask != 0` in row-major scan order (of each component's
    topmost-leftmost pixel), filtered by PIXEL-COUNT area in [min_area,
    max_area], compared in float32 as the JAX program does. Returns (k, 5)
    int32 rows [y, x, h, w, valid] with the passing components compacted
    to the front in scan order and the other rows all zero; components
    beyond the first k are absent (cc.py:136-191 of the JAX package)."""
    h, w = mask.shape
    dev = mask.device
    lab = label_components(mask)
    big = int(h * w)
    iota = torch.arange(big, dtype=torch.int32, device=dev).reshape(h, w)
    # a pixel is its component's representative iff its label is its own
    # index; a rep's rank among the reps is its component's scan order
    rank = torch.cumsum((lab == iota).reshape(-1).to(torch.int64), 0)
    n_found = rank[-1] if big else torch.zeros((), dtype=torch.int64,
                                               device=dev)
    flat = lab.reshape(-1).to(torch.int64)
    slot = torch.where(flat < big, rank[flat.clamp(max=big - 1)] - 1,
                       torch.full_like(flat, k)).clamp(max=k).reshape(h, w)
    area, y0, y1, x0, x1 = _slot_extents(slot, k, h, w)
    seq = torch.arange(k, dtype=torch.int64, device=dev)
    af = area.to(torch.float32)
    ok = ((seq < n_found)
          & (af >= torch.tensor(min_area, dtype=torch.float32, device=dev))
          & (af <= torch.tensor(max_area, dtype=torch.float32, device=dev)))
    box = torch.stack([y0, x0, y1 - y0 + 1, x1 - x0 + 1, ok.to(torch.int64)],
                      dim=1)
    box = torch.where(ok[:, None], box, torch.zeros_like(box))
    order = torch.argsort(torch.where(ok, seq, k + seq))
    return box[order].to(torch.int32)


def largest_component_box(mask: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bounding box of the largest (pixel-count; the first in scan order
    among equals) 8-connected component: ((4,) int32 [x, y, w, h], the
    cv2.boundingRect layout, and a bool scalar `valid`). An empty mask
    gives an all-zero box and valid False, for the caller's fallback."""
    h, w = mask.shape
    big = int(h * w)
    lab = label_components(mask)
    counts = torch.bincount(lab.reshape(-1).to(torch.int64),
                            minlength=big + 1)
    counts[big] = 0                       # the background sentinel
    best = torch.argmax(counts)
    valid = counts[best] > 0
    hit = lab == best
    ys = torch.arange(h, device=mask.device)
    xs = torch.arange(w, device=mask.device)
    rows, cols = hit.any(dim=1), hit.any(dim=0)
    y0 = torch.where(rows, ys, h).min()
    y1 = torch.where(rows, ys, -1).max()
    x0 = torch.where(cols, xs, w).min()
    x1 = torch.where(cols, xs, -1).max()
    box = torch.stack([x0, y0, x1 - x0 + 1, y1 - y0 + 1])
    return torch.where(valid, box, torch.zeros_like(box)).to(torch.int32), \
        valid
