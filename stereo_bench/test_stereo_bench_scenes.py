"""The scene generator repeats bit for bit by seed, and every seed gives
the same sizes."""
from __future__ import annotations

import numpy as np

from stereo_bench import scenes

BIG = 2 ** 31 + 12345  # seeds run past 32 signed bits


def test_video_repeats_by_seed():
    a = scenes.video(BIG, 6, 30, 50, (2, 4))
    b = scenes.video(BIG, 6, 30, 50, (2, 4))
    c = scenes.video(BIG + 1, 6, 30, 50, (2, 4))
    for x, y in zip(a, b):
        assert x.dtype == np.uint8 and x.shape == (6, 30, 50, 3)
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    dep = a[1]
    assert (dep[..., 0] == dep[..., 1]).all() and (dep[..., 1] == dep[..., 2]).all()


def test_video_pans():
    bgr, _ = scenes.video(7, 4, 40, 60, (3, 3))
    np.testing.assert_array_equal(bgr[1][:, :-3], bgr[0][:, 3:])

