"""The recipe's training streams on the CPU: each stream's first batches
stay as they are, since every configuration's weights rest on them."""

import hashlib

import numpy as np
import pytest

from benchmark import synthetic

# sha256 of the first two batches (4 patches of 64 x 64, images then
# labels) of each stream from np.random.default_rng(0)
PINNED = {
    "page": "74ab556d411da9955b399505b43d0fae49843bf2cd5ba5502fc6c8049d88e50a",
    "region":
        "d32268819ba10694e6a41b539ba609ae3d976fbf5e81480676818853f152b1e4",
    "textline":
        "93c48472d10996f6149a4945fa3c2804f566dff9f601581b1a7b40bf96480a4e",
    "dualhead":
        "a1f0205108a4c09a01c67a2e409dc9219db50cb4d6e1d14a6a0b03474b069bc9",
}


def test_every_stream_is_pinned():
    assert set(synthetic.BATCH_FNS) == set(PINNED)


@pytest.mark.parametrize("key", list(PINNED))
def test_existing_streams_draw_as_before(key):
    rng = np.random.default_rng(0)
    digest = hashlib.sha256()
    for _ in range(2):
        imgs, labels = synthetic.BATCH_FNS[key](rng, 4, 64, 64)
        digest.update(imgs.tobytes())
        digest.update(labels.tobytes())
    assert digest.hexdigest() == PINNED[key]
