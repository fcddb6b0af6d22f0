"""The port's fpe2d and ncfpe2d data paths against the JAX package's, exactly: loading
and normalization, denormalization, the train/test split, the padded eval batches, and
the suite eval's target branches and statistics sidecar."""
import os

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


# ------------------------------------------------------------------ the ncfpe2d suite


def _ncfpe2d_dict(m=10, l=6, n=9, seed=0):
    """Raw ncfpe2d fields as the datagen writes them: trajectories (m, l, n, n) ~ 1e-10
    and the force F (m, 2, n, n) ~ 1e-12, from a numpy seed."""
    rng = np.random.default_rng(seed)
    s = td.NCFPE2D_SCALES
    return {"trajectories": (rng.random((m, l, n, n)) / s["trajectories"]).astype(np.float32),
            "F": (rng.standard_normal((m, 2, n, n)) / s["F"]).astype(np.float32)}


def test_ncfpe2d_scales_are_the_jax_packages():
    assert td.NCFPE2D_SCALES == jd.NCFPE2D_SCALES


def test_load_ncfpe2d_equals_jax_bit_for_bit():
    d = _ncfpe2d_dict()
    got, want = td.load_ncfpe2d(d), jd.load_ncfpe2d(d)
    assert got.inputs.shape == (10, 6, 9, 9) and got.targets.shape == (10, 9, 9, 2)
    np.testing.assert_array_equal(got.inputs, want.inputs)
    np.testing.assert_array_equal(got.targets, want.targets)
    assert got.targets.dtype == want.targets.dtype == np.float32
    assert got.stats.keys() == want.stats.keys() == {"traj", "F"}
    assert got.stats["F"].mean.shape == (1, 2, 9, 9)
    for k in got.stats:
        assert got.stats[k].scale == want.stats[k].scale
        np.testing.assert_array_equal(got.stats[k].mean, want.stats[k].mean)
        np.testing.assert_array_equal(got.stats[k].std, want.stats[k].std)


SUITE_DATA = {"fpe2d": (_fpe2d_dict, td.load_fpe2d, jd.load_fpe2d),
              "ncfpe2d": (_ncfpe2d_dict, td.load_ncfpe2d, jd.load_ncfpe2d)}


@pytest.mark.parametrize("suite", SUITE_DATA)
def test_test_targets_and_denormalization_equal_jax(suite):
    """``_normalized_test_targets`` and ``denormalize_predictions`` of the suite eval,
    the fpe2d branch and the ncfpe2d ``F`` branch, equal the JAX package's bit for bit
    on train statistics from either loader; the denormalization undoes the targets'
    normalization within float32 rounding."""
    import blindno.eval.field_eval as jfe
    import blindno_torch.eval.field_eval as tfe

    make, load, jload = SUITE_DATA[suite]
    train, test = make(), make(m=4, seed=1)
    ts, jts = (mod.TrainStats(ld(train).stats, 2) for mod, ld in ((tfe, load), (jfe, jload)))
    targets = tfe._normalized_test_targets(None, ts, test)
    want = jfe._normalized_test_targets(None, jts, test)
    assert targets.shape == (4, 9, 9, 2) and targets.dtype == np.float32
    np.testing.assert_array_equal(targets, want)
    preds = np.random.default_rng(2).standard_normal(targets.shape).astype(np.float32)
    phys = tfe.denormalize_predictions(None, ts, preds)
    np.testing.assert_array_equal(phys, np.asarray(jfe.denormalize_predictions(None, jts, preds)))
    raw = (np.moveaxis(test["F"], 1, -1) if suite == "ncfpe2d"
           else np.stack([test["potential"], test["drag"]], -1))
    back = tfe.denormalize_predictions(None, ts, targets)
    for f in range(2):
        np.testing.assert_allclose(back[..., f], raw[..., f], rtol=1e-5,
                                   atol=1e-5 * np.abs(raw[..., f]).max())


def test_sidecar_round_trips_ncfpe2d_stats(tmp_path):
    """``cached_train_stats`` writes the ncfpe2d statistics (``F`` with its (1, 2, n, n)
    mean and std) to the sidecar, the JAX package's file byte for byte in its arrays,
    and reads them back equal."""
    from types import SimpleNamespace

    import blindno.eval.field_eval as jfe
    import blindno_torch.eval.field_eval as tfe

    os.makedirs(tmp_path / "data")
    np.savez(tmp_path / "data" / "ncfpe2d_train.npz", **_ncfpe2d_dict())
    sidecar = tmp_path / "data" / "ncfpe2d.stats.npz"
    spec = SimpleNamespace(name="ncfpe2d", train_file="ncfpe2d_train.npz")
    jfe.cached_train_stats(SimpleNamespace(**vars(spec), loader=jd.load_ncfpe2d), str(tmp_path))
    with np.load(sidecar) as z:
        want = {k: z[k] for k in z.files}
    os.remove(sidecar)
    spec.loader = td.load_ncfpe2d
    written = tfe.cached_train_stats(spec, str(tmp_path))
    with np.load(sidecar) as z:
        assert set(z.files) == set(want)
        for k in z.files:
            np.testing.assert_array_equal(z[k], want[k], err_msg=k)
    read = tfe.cached_train_stats(spec, str(tmp_path))
    assert read.n_fields == written.n_fields == 2 and read.stats.keys() == {"traj", "F"}
    for k, s in written.stats.items():
        assert read.stats[k].scale == s.scale
        np.testing.assert_array_equal(read.stats[k].mean, s.mean)
        np.testing.assert_array_equal(read.stats[k].std, s.std)


def test_sidecar_is_renamed_into_place_whole(tmp_path, monkeypatch):
    """``cached_train_stats`` writes the sidecar to a file of its own and renames it into
    place: a write that fails midway leaves no sidecar and no partial file (a concurrent
    reader, as the time-error stage's CPU reference beside the card's, could take a
    partial sidecar for a broken zip), and a whole one is read back."""
    from types import SimpleNamespace

    import blindno_torch.eval.field_eval as tfe

    os.makedirs(tmp_path / "data")
    np.savez(tmp_path / "data" / "ncfpe2d_train.npz", **_ncfpe2d_dict())
    spec = SimpleNamespace(name="ncfpe2d", train_file="ncfpe2d_train.npz", loader=td.load_ncfpe2d)

    def savez_then_fail(fh, **arrays):
        fh.write(b"PK")  # the start of a zip file, as a write cut short leaves it
        raise OSError("disk full")

    with monkeypatch.context() as m:
        m.setattr(tfe.np, "savez", savez_then_fail)
        with pytest.raises(OSError):
            tfe.cached_train_stats(spec, str(tmp_path))
    assert os.listdir(tmp_path / "data") == ["ncfpe2d_train.npz"]
    written = tfe.cached_train_stats(spec, str(tmp_path))
    assert sorted(os.listdir(tmp_path / "data")) == ["ncfpe2d.stats.npz", "ncfpe2d_train.npz"]
    assert tfe.cached_train_stats(spec, str(tmp_path)).n_fields == written.n_fields == 2
