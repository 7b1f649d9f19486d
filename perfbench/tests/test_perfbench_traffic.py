"""The traffic generators repeat from ``--seed`` and keep their shares."""

import numpy as np
import pytest

from perfbench.drivers import train, upscale
from perfbench.harness import load_named


def test_train_pool_repeats_from_the_seed():
    t = load_named("traffic", "train-b16-x234")
    t.update(batch=2, patch=8, pool=3)
    a, b = (train.make_pool(t, 2**31 + 11, pin=False) for _ in range(2))
    c = train.make_pool(t, 2**31 + 12, pin=False)
    assert len(a) == 3
    for x, y, z in zip(a, b, c):
        assert list(x) == t["scales"]
        for s in t["scales"]:
            for i in (0, 1):
                assert np.array_equal(x[s][i], y[s][i])
                assert not np.array_equal(x[s][i], z[s][i])
            side = round(8 * s)
            assert x[s][0].shape == (2, 8, 8, 3)
            assert x[s][1].shape == (2, side, side, 3)
    assert not np.array_equal(a[0][2][0], a[1][2][0])   # every batch differs


def test_train_hr_pixels():
    t = load_named("traffic", "train-b16-x234")
    assert train.hr_pixels(t) == 1_069_056


def test_upscale_images_and_order_repeat_from_the_seed():
    t = load_named("traffic", "upscale-192x256")
    imgs = upscale.make_images(t, 7)
    assert all(np.array_equal(x, y)
               for x, y in zip(imgs, upscale.make_images(t, 7)))
    assert imgs[0].shape == (1, 192, 256, 3) and imgs[0].dtype == np.float32
    a, b, c = (upscale.schedule(t, s) for s in (7, 7, 8))
    seq = [a(i) for i in range(400)]
    assert seq == [b(i) for i in range(400)]
    assert seq != [c(i) for i in range(400)]
    # every block of four requests holds each scale once
    for k in range(0, 400, 4):
        assert sorted(s for _, s in seq[k:k + 4]) == sorted(t["scales"])
    assert [img for img, _ in seq[:9]] == [0, 1, 2, 3, 4, 5, 6, 7, 0]


def test_upscale_output_sizes():
    t = load_named("traffic", "upscale-192x256")
    px = [h * w for h, w in (upscale.out_size(t, s) for s in t["scales"])]
    assert px == [196_608, 484_812, 786_432, 3_145_728]
    assert sum(px) / 4 == pytest.approx(1_153_395)


def test_sample_keeps_a_seeded_uniform_sample_of_each_scale():
    kept = []
    for seed in (1, 1, 2):
        s = upscale.Sample(2, seed)
        for i in range(100):
            s.offer(i % 2, i)
        kept.append(s.items())
    assert kept[0] == kept[1] != kept[2]
    assert len(kept[0]) == 4
    assert sorted(x % 2 for x in kept[0]) == [0, 0, 1, 1]
