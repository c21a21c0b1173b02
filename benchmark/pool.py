"""A traffic mix's page pool, rendered from the run's seed: page j of the
pool is synthetic.make_page of the mix's j-th kind, drawn from
np.random.default_rng([seed, j]), so a seed gives the same pages in any
order and in any number of worker processes."""

from __future__ import annotations

import multiprocessing
from typing import List, Sequence, Tuple

import numpy as np

from benchmark import synthetic

# (skew_deg, degrade, figures, bleed, vertical) of a page kind
Kind = Tuple[float, float, int, float, bool]


def render(seed: int, j: int, kind: Kind, h: int, w: int):
    """(RGB uint8 page, PageLayout) of pool page j."""
    rng = np.random.default_rng([seed % 2 ** 63, j])
    skew, degrade, figures, bleed, vertical = kind
    return synthetic.make_page(rng, h, w, skew_deg=float(skew),
                               degrade=float(degrade), figures=int(figures),
                               bleed=float(bleed), vertical=bool(vertical))


def _render_args(args):
    return render(*args)


class PoolRender:
    """The pool rendered in `workers` spawned processes while the caller
    goes on; `result()` waits and returns (pages, layouts)."""

    def __init__(self, seed: int, kinds: Sequence[Kind], h: int, w: int,
                 workers: int = 4):
        args = [(seed, j, tuple(k), h, w) for j, k in enumerate(kinds)]
        if workers <= 1:
            self._pool = None
            self._made = [render(*a) for a in args]
            return
        self._pool = multiprocessing.get_context("spawn").Pool(workers)
        self._async = self._pool.map_async(_render_args, args)

    def close(self) -> None:
        """Stop the workers if the pages were never collected."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def result(self) -> Tuple[List[np.ndarray], list]:
        if self._pool is not None:
            try:
                self._made = self._async.get()
            finally:
                self._pool.close()
                self._pool.join()
                self._pool = None
        return [p for p, _ in self._made], [lay for _, lay in self._made]
