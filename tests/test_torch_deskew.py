"""The port's resident deskew chain against the JAX package's
_resident_chain: same textline canvas, boxes, canvas maps and buffer
shape; slopes equal, deskewed profiles close."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sbb_textline_detection_tpu.core.config import DeskewConfig
from sbb_textline_detection_tpu.pipeline import deskew as jdeskew
from sbb_textline_detection_tpu_torch.ops import radon
from sbb_textline_detection_tpu_torch.pipeline import deskew

CFG = DeskewConfig(coarse_steps=6, vertical_steps=4)
S = 256
# profile bins are f32 sums of hat products taken in another order than
# XLA's einsum, and a hat argument at a coordinate near 3000 carries ~2.4e-4
# of f32 rounding that XLA may round differently (a fused multiply-add):
# the Radon tests' tolerance. Exact at slope 0.
RTOL, ATOL = 1e-4, 1e-2


def _draw_lines(mask, x, y, w, h, deg, pitch=26, thick=13):
    """Text-line bars at `deg` degrees inside the box (x, y, w, h), thick
    enough to survive the chain's 9x9 crop erode."""
    t = np.tan(np.deg2rad(deg))
    xs = np.arange(w)
    for y0 in range(4, h - 4, pitch):
        for k in range(thick):
            ys = np.round(y0 + k + t * (xs - w / 2)).astype(int)
            ok = (ys >= 0) & (ys < h)
            mask[y + ys[ok], x + xs[ok]] = 1


def _page():
    """(mask, boxes) with a skewed, a vertical-text and a thin region wider
    than the JAX package's 2816-pixel buffer cap."""
    mask = np.zeros((420, 3000), np.uint8)
    boxes = [(10, 10, 200, 150), (250, 20, 120, 260), (20, 320, 2900, 80),
             (600, 30, 120, 90)]
    _draw_lines(mask, *boxes[0], deg=6.0)
    sub = np.zeros((120, 260), np.uint8)  # (w, h): lines across, then .T
    _draw_lines(sub, 0, 0, 260, 120, deg=0.0)
    x, y, w, h = boxes[1]
    mask[y:y + h, x:x + w] = sub.T                   # vertical text lines
    _draw_lines(mask, *boxes[2], deg=-1.0, pitch=20, thick=11)
    _draw_lines(mask, *boxes[3], deg=-14.0, pitch=20, thick=11)
    return mask, boxes


def _jax_chain(mask, boxes_yxhw, cy, cx, angles, bufH, bufW):
    B = len(boxes_yxhw)
    a_all = len(angles)
    f = B * a_all
    chunk = 8
    f_pad = -(-f // chunk) * chunk
    ridx = np.concatenate([np.repeat(np.arange(B), a_all),
                           np.zeros(f_pad - f, np.int64)])
    aidx = np.concatenate([np.tile(np.arange(a_all), B),
                           np.zeros(f_pad - f, np.int64)])
    fn = jax.jit(functools.partial(
        jdeskew._resident_chain, B=B, ac_n=CFG.coarse_steps, f=f,
        ridx=ridx, aidx=aidx, s=S, chunk=chunk, use_pallas=False, cfg=CFG,
        erode_eff=9, morph_k=5, bufH=bufH, bufW=bufW))
    return np.asarray(fn(jnp.asarray(mask), jnp.asarray(boxes_yxhw,
                                                        jnp.int32),
                         jnp.asarray(cy), jnp.asarray(cx),
                         jnp.asarray(angles)))


@pytest.fixture(scope="module")
def page():
    return _page()


def _group(idx, page):
    mask, boxes = page
    group = [boxes[i] for i in idx]
    eng = deskew.DeskewEngine(CFG, max_canvas=S)
    s = eng._bucket_for_sizes([(b[3], b[2]) for b in boxes])
    assert s == S
    bufH, bufW = eng.group_buffer_shape(group)
    yxhw = np.array([(y, x, h, w) for x, y, w, h in group], np.int32)
    maps = [deskew._canvas_index_maps(h, w, S, CFG.pad_factor)
            for x, y, w, h in group]
    cy = np.stack([m[0] for m in maps])
    cx = np.stack([m[1] for m in maps])
    angles = np.concatenate([eng._coarse, eng._vertical])
    return mask, yxhw, cy, cx, angles, bufH, bufW


@pytest.mark.parametrize("idx", [(0, 1, 3), (2, 0)])
def test_resident_chain_matches_jax(page, idx):
    mask, yxhw, cy, cx, angles, bufH, bufW = _group(idx, page)
    want = _jax_chain(mask, yxhw, cy, cx, angles, bufH, bufW)
    got = deskew._resident_chain(
        torch.from_numpy(mask), yxhw, cy, cx, torch.from_numpy(angles),
        B=len(idx), ac_n=CFG.coarse_steps, s=S, cfg=CFG,
        erode_eff=9, morph_k=5, bufH=bufH, bufW=bufW).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    assert np.any(want[:, 0] != 0.0)
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=RTOL,
                               atol=ATOL)
    if 2 in idx:
        assert bufW > 2816, "the wide region exceeds the JAX buffer cap"


def test_engine_dispatch_collect_matches_chain(page):
    """resident_dispatch groups (8 slots, or 2 for a 1-2 region tail) and
    per-group buffers; collect slices each region's profiles. The cap is
    raised above the wide region (under the default 2816 it would raise:
    tests/test_torch_deskew_spec.py)."""
    mask, boxes = page
    eng = deskew.DeskewEngine(CFG, max_canvas=S, region_batch=2,
                              buf_max=3072)
    slopes, profs = eng.resident_collect(
        eng.resident_dispatch(torch.from_numpy(mask), boxes))
    assert len(slopes) == len(profs) == len(boxes)
    for i, (x, y, w, h) in enumerate(boxes):
        _, yxhw, cy, cx, angles, bufH, bufW = _group((i,), page)
        want = _jax_chain(mask, yxhw, cy, cx, angles, bufH, bufW)[0]
        assert slopes[i] == want[0]
        assert profs[i][0].shape == (h,) and profs[i][1].shape == (w,)
        np.testing.assert_allclose(profs[i][0], want[1:1 + h], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(profs[i][1],
                                   want[1 + bufH:1 + bufH + w], rtol=RTOL,
                                   atol=ATOL)


def test_values_independent_of_slot_count(page):
    """A region's row of the chain output does not change with B."""
    mask, yxhw, cy, cx, angles, bufH, bufW = _group((0, 3), page)
    kw = dict(ac_n=CFG.coarse_steps, s=S, cfg=CFG, erode_eff=9,
              morph_k=5, bufH=bufH, bufW=bufW)
    m = torch.from_numpy(mask)
    a = torch.from_numpy(angles)
    two = deskew._resident_chain(m, yxhw, cy, cx, a, B=2, **kw).numpy()
    one = deskew._resident_chain(m, yxhw[:1], cy[:1], cx[:1], a, B=1,
                                 **kw).numpy()
    np.testing.assert_array_equal(one[0], two[0])


def test_empty_page_dispatches_nothing():
    eng = deskew.DeskewEngine(CFG, max_canvas=S)
    radon.launches = 0
    assert eng.resident_dispatch(torch.zeros((64, 64), dtype=torch.uint8),
                                 []) == []
    assert eng.resident_collect([]) == ([], [])
