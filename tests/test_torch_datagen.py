"""The port's dataset generation and time-error stage against the JAX package's on the
CPU.

- Each generator (``blindno_torch/data/generate.py``) at a few sets against JAX's with
  the same seed: the parameter arrays (``potential``, ``drag``, ``F``, ``V``, ``time``,
  ``grid``, ``g``, ``kappa``) bit for bit, the trajectories within 1e-3 relative L2 per
  set; the 2-D ones on coarse grids through their ``extent`` keyword. The ncfpe2d mass
  check raises.
- ``--stage datagen`` for fpe1d and gpe1d through the CLI against JAX's CLI archives, and
  for every suite through the port's CLI (the 2-D generators on coarse grids): the
  archives' keys and shapes, an existing archive kept, ``--force`` remaking it.
- ``time_error_suite`` on the committed fpe1d NIO and gpe1d FNO-branch checkpoints
  against JAX's on the same archives and predicted fields, within 1e-4 relative, and the
  CLI's ``--stage time-error``, which prints and saves the same report.
"""
import dataclasses
import functools
import json
import os
import shutil

import numpy as np
import pytest
import torch

import blindno.suites.registry as jax_registry
import blindno.suites.run as jax_run
import blindno_torch.suites.registry as registry
from blindno.data import generate as JG
from blindno.eval.time_error import time_error_suite as jax_time_error_suite
from blindno_torch.data import generate as G
from blindno_torch.eval.time_error import time_error_suite
from blindno_torch.suites.run import main
from test_torch_suites import _port_best_from_jax

NM = 1e-9
TRAJ_TOL = 1e-3    # relative L2 per set
METRIC_TOL = 1e-4  # the time-averaged errors, relative
CKPT = os.path.join(os.path.dirname(__file__), "..", "runs", "ckpt")
# coarse 2-D grids: 16x16 (fpe2d) and 20x20 (ncfpe2d), fewer steps and snapshots
FPE2D_SMALL = dict(extent=(150 * NM, 150 * NM), nsteps=200, n_snapshots=20)
NCFPE2D_SMALL = dict(extent=(200 * NM, 200 * NM), nsteps=100, n_snapshots=20,
                     init_center=(-50 * NM, -50 * NM))
TRAJ_KEYS = ("trajectories", "y", "Pt")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_archives_match(got, want):
    """Every key: the parameter arrays bit for bit, the trajectories within TRAJ_TOL."""
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        if k in TRAJ_KEYS:
            axes = tuple(range(1, want[k].ndim))
            norm = lambda a: np.sqrt((a.astype(np.float64) ** 2).sum(axis=axes))
            err = norm(got[k] - want[k]) / norm(want[k])
            assert err.max() < TRAJ_TOL, (k, err)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


GENERATORS = [  # (name, JAX call, port call)
    ("fpe1d", lambda: JG.generate_fpe1d(3, 3, store_pt=True),
     lambda: G.generate_fpe1d(3, 3, store_pt=True, device="cpu")),
    ("gpe1d", lambda: JG.generate_gpe1d(3, 4, 2.0, 2.0),
     lambda: G.generate_gpe1d(3, 4, 2.0, 2.0, device="cpu")),
    ("schrodinger1d", lambda: JG.generate_gpe1d(4, 3, 0.0, 0.0, t_final=1.0),
     lambda: G.generate_gpe1d(4, 3, 0.0, 0.0, t_final=1.0, device="cpu")),
    ("fpe2d", lambda: JG.generate_fpe2d(3, 3, **FPE2D_SMALL),
     lambda: G.generate_fpe2d(3, 3, device="cpu", **FPE2D_SMALL)),
    ("ncfpe2d", lambda: JG.generate_ncfpe2d(3, 3, **NCFPE2D_SMALL),
     lambda: G.generate_ncfpe2d(3, 3, device="cpu", **NCFPE2D_SMALL)),
]


@pytest.mark.parametrize("name,jax_make,make", GENERATORS, ids=[g[0] for g in GENERATORS])
def test_generator_matches_jax(name, jax_make, make):
    got, want = make(), jax_make()
    _assert_archives_match(got, want)
    if name.endswith("fpe2d") or name == "fpe1d":  # unit masses
        axes = tuple(range(2, got["trajectories"].ndim))
        np.testing.assert_allclose(got["trajectories"].sum(axis=axes), 1.0, rtol=1e-4)
    if name == "fpe1d":
        assert got["Pt"].shape == (3, 400, 80)


def test_ncfpe2d_mass_check_raises(monkeypatch):
    """A propagator that loses mass stops the ncfpe2d generator at its first batch."""
    solve = G.propagate_expm
    monkeypatch.setattr(G, "propagate_expm", lambda *a, **kw: 0.9 * solve(*a, **kw))
    with pytest.raises(RuntimeError, match="mass drift"):
        G.generate_ncfpe2d(0, 2, device="cpu", **NCFPE2D_SMALL)


def test_ncfpe2d_float64_solve_agrees_with_float32():
    """The float64 solve (the card's reference for ncfpe2d) within TRAJ_TOL of float32."""
    a = G.generate_ncfpe2d(1, 2, device="cpu", **NCFPE2D_SMALL)
    b = G.generate_ncfpe2d(1, 2, device="cpu", dtype=torch.float64, **NCFPE2D_SMALL)
    assert b["trajectories"].dtype == np.float64
    _assert_archives_match({**b, "trajectories": b["trajectories"].astype(np.float32)}, a)


# ------------------------------------------------------------------ the datagen stage


def _run_jax_cli(argv):
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr("sys.argv", ["run", *argv])
        jax_run.main()
    finally:
        mp.undo()


def _load(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("suite", ["fpe1d", "gpe1d"])
def test_datagen_stage_matches_the_jax_cli(suite, tmp_path):
    """``--stage datagen --m 3 --m-test 2 --seed 5``: the train archive from seed 5, the
    test archive from seed 1005, each as JAX's CLI writes it."""
    jw, w = str(tmp_path / "jax"), str(tmp_path / "port")
    argv = ["--suite", suite, "--stage", "datagen", "--m", "3", "--m-test", "2", "--seed", "5"]
    _run_jax_cli(argv + ["--workdir", jw])
    main(argv + ["--workdir", w, "--device", "cpu"])
    for split in ("train", "test"):
        name = f"{suite}_{split}.npz"
        _assert_archives_match(_load(os.path.join(w, "data", name)),
                               _load(os.path.join(jw, "data", name)))


def _small_datagen_specs(monkeypatch):
    """The 2-D suites' generators on coarse grids, in the port's registry."""
    for suite, small in (("fpe2d", FPE2D_SMALL), ("ncfpe2d", NCFPE2D_SMALL)):
        spec = registry.SUITES[suite]
        make = functools.partial(spec.datagen_train, **small)
        monkeypatch.setitem(registry.SUITES, suite,
                            dataclasses.replace(spec, datagen_train=make, datagen_test=make))


@pytest.mark.parametrize("suite", sorted(registry.SUITES))
def test_datagen_stage_runs_for_every_suite(suite, tmp_path, monkeypatch, capsys):
    """Each suite's archives in its files and keys (the 2-D ones on coarse grids; the GPE
    runs cut to 1 time unit); a second run keeps them, ``--force`` remakes them."""
    _small_datagen_specs(monkeypatch)
    spec = registry.SUITES[suite]
    if "gpe" in suite or suite == "schrodinger1d":
        short = lambda make: lambda *a, **kw: make(*a, t_final=1.0, **kw)
        spec = dataclasses.replace(spec, datagen_train=short(spec.datagen_train),
                                   datagen_test=short(spec.datagen_test))
        monkeypatch.setitem(registry.SUITES, suite, spec)
    w = str(tmp_path)
    argv = ["--suite", suite, "--stage", "datagen", "--workdir", w, "--m", "2", "--m-test", "1",
            "--device", "cpu"]
    main(argv)
    paths = [os.path.join(w, "data", f) for f in (spec.train_file, spec.test_file)]
    keys = {"y", "g", "kappa", "V"} if "gpe" in spec.train_file or suite == "schrodinger1d" else (
        {"time", "grid", "trajectories", "F"} if suite == "ncfpe2d"
        else {"time", "grid", "trajectories", "potential", "drag"})
    train, test = (_load(p) for p in paths)
    assert set(train) == set(test) == keys
    assert len(next(iter(train.values()))) == 2 and len(next(iter(test.values()))) == 1
    traj = train.get("trajectories", train.get("y"))
    assert np.isfinite(traj).all() and traj.min() >= -1e-6
    mtimes = [os.path.getmtime(p) for p in paths]
    main(argv)
    assert "train set exists" in capsys.readouterr().out
    assert [os.path.getmtime(p) for p in paths] == mtimes
    main(argv + ["--force", "--m", "3"])
    assert len(_load(paths[0])["g" if "y" in train else "time"]) == 3


# ------------------------------------------------------------------ time-error


@pytest.mark.parametrize("suite,model", [("fpe1d", "nio"), ("gpe1d", "fno")])
def test_time_error_suite_matches_jax(suite, model, tmp_path, capsys):
    """The committed ``runs/ckpt/{suite}_{model}`` on JAX datagen archives (10 train and 4
    test sets): JAX's ``time_error_suite`` and the port's, through ``from_flax``, on the
    4 test sets of the seed-42 choice: mean and spread within 1e-4 relative. Then the
    CLI's ``--stage time-error --m 4`` prints and saves the same report."""
    jw, w = str(tmp_path / "jax"), str(tmp_path / "port")
    spec, jspec = registry.SUITES[suite], jax_registry.SUITES[suite]
    os.makedirs(os.path.join(jw, "data"))
    for split, seed, m in (("train", 0, 10), ("test", 1, 4)):
        np.savez(os.path.join(jw, "data", getattr(spec, f"{split}_file")),
                 **jspec.datagen_train(seed, m))
    shutil.copytree(os.path.join(jw, "data"), os.path.join(w, "data"))
    name = f"{suite}_{model}"
    shutil.copytree(os.path.join(CKPT, name), os.path.join(jw, "ckpt", name))
    _port_best_from_jax(os.path.join(jw, "ckpt", name), os.path.join(w, "ckpt", name),
                        lambda: spec.models[model](device="cpu"))
    want = jax_time_error_suite(jspec, model, jw, num_samples=4)
    got = time_error_suite(spec, model, w, num_samples=4, device="cpu")
    assert got.keys() == want.keys() and got["num_samples"] == want["num_samples"] == 4
    assert want["mean_err_l2"] > 0.01
    for k in ("mean_err_l2", "std_err_l2"):
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_TOL, err_msg=k)
    capsys.readouterr()
    report = main(["--suite", suite, "--model", model, "--stage", "time-error", "--workdir", w,
                   "--m", "4", "--device", "cpu"])
    assert report == got
    assert capsys.readouterr().out.rstrip().endswith(json.dumps(got, indent=1))
    with open(os.path.join(w, "eval", name, "time_error.json")) as fh:
        assert json.load(fh) == got
