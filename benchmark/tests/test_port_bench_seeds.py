"""The inputs repeat from a seed: weights, archives and the loop's draws."""
from __future__ import annotations

import numpy as np
import torch

from benchmark import common
from benchmark.reference import models
from benchmark.tests.conftest import small_config
from benchmark.traffic.train_loop import Draws

BIG = 2**31 + 12345  # the driver's seeds pass 32 signed bits


def test_weights_repeat():
    cfg = small_config("fpe2d_unet")
    a, b, c = (common.draw_leaves(models.leaves(cfg), common.generator(s, 1, "cpu"), "cpu")
               for s in (BIG, BIG, BIG + 1))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["convs.1.weight"], c["convs.1.weight"])


def test_archive_repeats():
    cfg = small_config("fpe2d_nio")
    (x1, y1), (x2, y2), (x3, _) = (common.archive(cfg, 5, s, 2, "cpu") for s in (BIG, BIG, 7))
    assert np.array_equal(x1, x2) and np.array_equal(y1, y2) and not np.array_equal(x1, x3)
    assert x1.shape == (5, 4, 61, 61) and y1.shape == (5, 61, 61, 2)


def test_draws_repeat():
    def draws(seed):
        return Draws(seed, 512, 16, 8, 100, 50, torch.device("cpu"), lambda e: None)

    a, b = draws(BIG).host(3, 32), draws(BIG).host(3, 32)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    positions, elements, indices, masks = a
    assert positions.shape == (32, 16) and len(set(positions.flatten().tolist())) == 512
    assert 0 <= int(elements.min()) and int(elements.max()) < 8
    assert indices.shape == (32, 100) and masks.sum(1).min() >= 50 and masks.sum(1).max() < 100
    assert not torch.equal(draws(BIG).host(4, 32)[0], positions)
