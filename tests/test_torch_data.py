"""The port's fpe2d data path against the JAX package's, exactly: loading and
normalization, denormalization, the train/test split and the padded eval batches."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import blindno.data.datasets as jd
import blindno_torch.data.datasets as td


def _fpe2d_dict(m=10, l=6, n=9, seed=0):
    """Raw fields at the magnitudes the scales undo (traj ~ 1e-10, potential ~ 1e-21,
    drag ~ 1e-6), from a numpy seed."""
    rng = np.random.default_rng(seed)
    s = td.FPE2D_SCALES
    return {"trajectories": (rng.random((m, l, n, n)) / s["trajectories"]).astype(np.float32),
            "potential": (-rng.random((m, n, n)) / s["potential"]).astype(np.float32),
            "drag": ((1 + rng.random((m, n, n))) / s["drag"]).astype(np.float32)}


def test_scales_are_the_jax_packages():
    assert td.FPE2D_SCALES == jd.FPE2D_SCALES


def test_load_fpe2d_equals_jax_bit_for_bit():
    d = _fpe2d_dict()
    got, want = td.load_fpe2d(d), jd.load_fpe2d(d)
    assert got.inputs.shape == (10, 6, 9, 9) and got.targets.shape == (10, 9, 9, 2)
    np.testing.assert_array_equal(got.inputs, want.inputs)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.inputs.dtype == want.inputs.dtype == np.float32
    assert got.stats.keys() == want.stats.keys() == {"traj", "potential", "drag"}
    for k in got.stats:
        assert got.stats[k].scale == want.stats[k].scale
        np.testing.assert_array_equal(got.stats[k].mean, want.stats[k].mean)
        np.testing.assert_array_equal(got.stats[k].std, want.stats[k].std)


@pytest.mark.parametrize("field", ["traj", "potential", "drag"])
def test_normalize_and_denormalize_equal_jax(field):
    """``normalize`` is numpy on both sides, ``denormalize`` jnp in the JAX package;
    the port's numpy and tensor versions give the same numbers bit for bit, and undo
    ``normalize`` within float32 rounding of the field's scale."""
    d = _fpe2d_dict()
    other = _fpe2d_dict(m=4, seed=1)
    key = {"traj": "trajectories"}.get(field, field)
    got, want = td.load_fpe2d(d).stats[field], jd.load_fpe2d(d).stats[field]
    norm = got.normalize(other[key])
    np.testing.assert_array_equal(norm, want.normalize(other[key]))
    want_raw = np.asarray(want.denormalize(jnp.asarray(norm)))
    raw = got.denormalize(norm)
    assert raw.dtype == want_raw.dtype == np.float32
    np.testing.assert_array_equal(raw, want_raw)
    back = got.denormalize(torch.from_numpy(norm))
    assert isinstance(back, torch.Tensor)
    np.testing.assert_array_equal(back.numpy(), want_raw)
    scale = np.abs(other[key]).max()
    np.testing.assert_allclose(raw, other[key], rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("n,frac,seed", [(10, 0.8, 0), (12, 0.8, 3), (400, 0.75, 1)])
def test_train_test_split_equals_jax(n, frac, seed):
    for a, b in zip(td.train_test_split(n, frac, seed), jd.train_test_split(n, frac, seed)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,batch", [(3, 2), (8, 4), (13, 16)])
def test_eval_batches_equal_jax(n, batch):
    got, want = td.eval_batches(n, batch), jd.eval_batches(n, batch)
    assert len(got) == len(want) == -(-n // batch)
    for (gi, gm), (wi, wm) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gm, wm)
        assert gi.dtype == wi.dtype and gm.dtype == wm.dtype
