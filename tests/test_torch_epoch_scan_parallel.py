"""``TrainConfig(epoch_scan=True)`` across ranks on the CPU: the epoch program
(``blindno_torch/train/scan.py``) run uncaptured in gloo ranks, on a ``(data, model)``
mesh of DP 2 (two ranks, or three whose third idles: a batch of 2 or 4 leaves a data axis
of 2, as JAX's ``data_mesh`` leaves it on its 8 virtual devices) or 2 x 2 at tp=2 (four),
as ``device="cpu"`` asks. The idle rank's result is held as the training ranks' are.

- Against the port's per-step loop on the same ranks, with no augmentation and with
  ``d4_scalar`` (and bfloat16 input storage), a small UNet: bit for bit,
  the histories, the final parameters and running statistics (gathered over ``model``)
  and Adam's moments and step counts as the resume file holds them (gathered). Both
  paths run the same operations in the same order on each rank's rows.
- Against JAX's ``lax.scan`` epochs on one device (``tests/test_torch_loop.py``'s
  ``_jax_loop(..., scan=True)``; JAX's DP x TP step equals its one-device step), the
  draws injected: the tolerances of
  ``tests/test_torch_epoch_scan.py:test_epoch_scan_matches_jax_lax_scan_epochs``.
- Two bfloat16 ``all`` epochs on the 2 x 2 mesh against the one-process bfloat16
  program, within rtol 2e-4, as
  ``tests/test_torch_parallel.py:test_train_model_low_precision_across_ranks_matches_one_process``
  holds the per-step loop.
- A run checkpointed under one mode at tp=2 resumes under the other, equal to an
  unbroken run bit for bit (the UNet); a stop file stops every rank under the program.

The ranks are ``tests/test_torch_parallel.py``'s: spawned workers of one ``RankPool``,
each on one torch thread, running ``blindno_torch.parallel.dryrun.train_model_ranks``
(which imports no JAX) on numpy inputs from a seed. The encoders are narrowed as in
``tests/test_torch_epoch_scan.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

import blindno.models.nio2d as jax_nio2d
from blindno.data.datasets import load_fpe2d as jax_load_fpe2d
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.nn.cnn import Encoder2D as JEncoder2D
from blindno_torch.convert import from_flax
from blindno_torch.data.datasets import load_fpe2d
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.models.nio1d import NIOFNO1D, NIOFP1D
from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.nn.cnn import Encoder2D
from blindno_torch.parallel import dryrun
from blindno_torch.parallel.mesh import RankPool
from blindno_torch.train.checkpoint import RESUME, load_resume
from blindno_torch.train.jax_checkpoint import read_msgpack
from blindno_torch.train.loop import TrainConfig, train_model
from test_torch_epoch_scan import ENC_DIMS, _data_2d, _fixed_draws, _same_run
from test_torch_loop import (L_MIN, M, PARITY_CFG, SMALL, _draw_source, _jax_loop, _rel,
                             fpe2d_archive)
from test_torch_nio3d import seeded_variables
from test_torch_parallel import GRID_1D, RUN_TIMEOUT, SMALL_1D, _fpe1d_data, _np
from test_torch_train import ENCODER_GRAD_TOL, STEP_TOL, _grid

# mesh -> (ranks, tp); in dp2_idle1 the third rank idles (neither batch divides by 3)
MESHES = {"dp2": (2, 1), "dp2_tp2": (4, 2), "dp2_idle1": (3, 1)}


@pytest.fixture(scope="module")
def ranks():
    """Four spawned ranks for the whole file; each run takes the first ``world``."""
    with RankPool(4) as pool:
        yield lambda fn, world, *args: pool.run(fn, world, *args, timeout=RUN_TIMEOUT)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The single-process runs on one torch thread, as the ranks run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _narrow_nio2d(kwargs):
    """A NIOFP2D factory for the ranks, its Encoder2D narrowed to ENC_DIMS."""
    return (NIOFP2D, dict(**kwargs, l_min=L_MIN, device="cpu"),
            {"deeponet.branch": (Encoder2D, dict(n_out=kwargs["n_basis"], dims=ENC_DIMS))})


N_UNET = 32  # the UNet's grid
UNET = (PermInvUNetAttn, dict(input_size=(N_UNET, N_UNET), depth=2, width=4, fno_modes=4,
                              fno_layers=2, subsample=True, l_min=L_MIN, device="cpu"))


def _unet_data():
    """A synthetic fpe2d archive on the UNet's grid, and a grid (the UNet ignores it)."""
    return load_fpe2d(fpe2d_archive(n=N_UNET)), np.zeros((N_UNET, N_UNET, 2), np.float32)


# case -> the UNet's TrainConfig fields
LOOP_CASES = {"none": dict(), "d4_scalar": dict(augment="d4_scalar", compress_inputs=True)}


def _opt_state(path):
    """optax's Adam state in the resume file, as written."""
    return read_msgpack(str(path / RESUME))["opt_state"]


def _same_tree(got, want):
    """Keys, dtypes, shapes and bytes equal."""
    if isinstance(want, dict):
        return isinstance(got, dict) and got.keys() == want.keys() and all(
            _same_tree(got[k], want[k]) for k in want)
    return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def jax_scan_run(ranks):
    """JAX's ``lax.scan`` epochs on one device for the loop-parity run (PARITY_CFG with
    ``epoch_scan``) of the small NIOFP2D, the Encoder2D narrowed on both sides: (draws
    table, flax variables, history, final params and batch statistics). Set up after
    ``ranks``, so that the workers start while JAX compiles."""
    cfg = dataclasses.replace(PARITY_CFG, epoch_scan=True)
    jdata, grid = jax_load_fpe2d(fpe2d_archive()), _grid()
    source = _draw_source()
    steps = int(cfg.train_frac * M) // cfg.batch_size
    table = {epoch: source(epoch, steps) for epoch in range(1, cfg.epochs + 1)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_nio2d, "Encoder2D", lambda n, fk: JEncoder2D(n, fk, *ENC_DIMS))
        jmodel = JNIOFP2D(**SMALL, l_min=L_MIN)
        variables = seeded_variables(jmodel, np.random.default_rng(7), jdata.inputs[:2], grid)
        hist, params, stats = _jax_loop(jmodel, variables, jdata, grid, cfg,
                                        lambda epoch, steps: table[epoch], mp, scan=True)
    return table, variables, hist, params, stats


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_program_across_ranks_matches_jax_lax_scan_epochs(ranks, jax_scan_run, mesh):
    """The loop-parity run (8 steps over 2 epochs at batch 2, ``d4_scalar`` with all 8
    elements drawn, bfloat16 input storage, StepLR decaying after epoch 1, an eval after
    each epoch) under ``epoch_scan=True`` on the ranks, the draws injected, against JAX's
    ``lax.scan`` epochs from the same weights: the history within STEP_TOL = 2e-3
    relative, every parameter within STEP_TOL and, in the Encoder2D, ENCODER_GRAD_TOL =
    1e-2 (relative L2; its running means left out), as the one-process test holds it.
    Each data rank holds one set of a batch: the synced BatchNorm's statistics are the
    pair's."""
    table, variables, want_hist, jparams, jstats = jax_scan_run
    world, tp = MESHES[mesh]
    cfg = dataclasses.replace(PARITY_CFG, epoch_scan=True, tp=tp)
    state = _np(from_flax(variables["params"], variables["batch_stats"]))
    out = ranks(dryrun.train_model_ranks, world, _narrow_nio2d(SMALL), state,
                _data_2d()[0], _grid(), cfg, "cpu", table)
    want_state = from_flax(jparams, jstats)
    for res in out:
        assert [h["epoch"] for h in res.history] == [1, 2] and res.finished
        for got, want in zip(res.history, want_hist, strict=True):
            for k in ("train_loss", "test_loss"):
                assert abs(got[k] - want[k]) <= STEP_TOL * abs(want[k]), (got, want)
            assert _rel(got["field_rel_l2"], want["field_rel_l2"]) <= STEP_TOL, (got, want)
        got_state = {**res.params, **res.batch_stats}
        errs = {k: _rel(got_state[k], v) for k, v in want_state.items()
                if not k.endswith("num_batches_tracked")
                and not (k.startswith("deeponet.branch.") and k.endswith("running_mean"))}
        bad = {k: e for k, e in errs.items()
               if not e <= (ENCODER_GRAD_TOL if k.startswith("deeponet.branch.") else STEP_TOL)}
        assert not bad, bad
        assert _rel(got_state["heads.0.fc0.weight"], state["heads.0.fc0.weight"]) > \
            10 * errs["heads.0.fc0.weight"]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("case", sorted(LOOP_CASES))
def test_program_across_ranks_equals_the_per_step_loop(ranks, case, mesh, tmp_path):
    """Two epochs of 2 steps at batch 4 from the same weights and seed on the same ranks,
    the model drawing its own set subsamples from the loop's generator (the same seed on
    every rank): ``epoch_scan=True`` and ``False`` give every rank the same history, the
    same final state and the same Adam state in the resume file, bit for bit."""
    world, tp = MESHES[mesh]
    fields, state = LOOP_CASES[case], _np(dryrun.built(UNET, None, "cpu").state_dict())
    data, grid = _unet_data()
    cfg = TrainConfig(epochs=2, batch_size=4, lr=1e-3, save_interval=1, seed=3, tp=tp, **fields)
    runs = {}
    for scan in (False, True):
        ck = tmp_path / str(scan)
        runs[scan] = ranks(dryrun.train_model_ranks, world, UNET, state, data, grid,
                           dataclasses.replace(cfg, epoch_scan=scan, ckpt_dir=str(ck)))
        runs[scan, "opt"] = _opt_state(ck)
    for r in runs[False] + runs[True]:
        assert r.finished and len(r.history) == 2 and _same_run(r, runs[False][0])
    assert runs[False][0].history[0]["train_loss"] != runs[False][0].history[1]["train_loss"]
    want, got = runs[False, "opt"], runs[True, "opt"]
    assert int(want["0"]["count"]) == 4 and _same_tree(got, want)


def test_low_precision_program_across_ranks_matches_one_process(ranks):
    """``epoch_scan=True`` in bfloat16 under ``all`` on the 2 x 2 mesh at tp=2 (DDP over
    ``data``, the FNO layers column-parallel over ``model``, each layer's kernel inside
    the cast): two epochs whose losses equal the one-process bfloat16 program's within
    rtol 2e-4, the bound the per-step loop is held to across ranks. oneDNN is off in the
    reference, as in the other bfloat16 CPU tests; the ranks convolve nothing."""
    kw = dict(width=8, modes=8, l_min=4, device="cpu")
    model, data = NIOFNO1D(**kw), _fpe1d_data()
    cfg = TrainConfig(epochs=2, batch_size=8, save_interval=1, lr=1e-3, epoch_scan=True,
                      compute_dtype="bfloat16", amp_policy="all")
    out = ranks(dryrun.train_model_ranks, 4, (NIOFNO1D, kw), _np(model.state_dict()), data,
                GRID_1D, dataclasses.replace(cfg, tp=2))
    with torch.backends.mkldnn.flags(enabled=False):
        single = train_model(model, data, GRID_1D, cfg, device="cpu")
    for res in out:
        assert res.finished and [h["epoch"] for h in res.history] == [1, 2]
        for a, b in zip(single.history, res.history):
            np.testing.assert_allclose(b["train_loss"], a["train_loss"], rtol=2e-4)
            np.testing.assert_allclose(b["test_loss"], a["test_loss"], rtol=2e-4)


RESUME_CFG = TrainConfig(epochs=3, batch_size=4, lr=1e-3, save_interval=1, augment="d4_scalar",
                         lr_step_epochs=2, tp=2)


@pytest.fixture(scope="module")
def unbroken_run(ranks):
    """The UNet's state, draws that depend on the epoch alone (the subsamples injected),
    and an unbroken 3-epoch per-step run from them on the 2 x 2 mesh."""
    state = _np(dryrun.built(UNET, None, "cpu").state_dict())
    source = _fixed_draws(int(0.8 * M))
    table = {epoch: source(epoch, 2) for epoch in (1, 2, 3)}
    run = lambda c: ranks(dryrun.train_model_ranks, 4, UNET, state, *_unet_data(), c, "cpu",
                          table)
    return run, run(RESUME_CFG)


@pytest.mark.parametrize("first,then", [(True, False), (False, True)])
def test_a_checkpoint_resumes_across_modes_at_tp2(unbroken_run, first, then, tmp_path):
    """On the 2 x 2 mesh at tp=2: epoch 1 under ``epoch_scan=first`` with a resume
    checkpoint (rank 0 writes it whole), then epochs 2-3 resumed under
    ``epoch_scan=then``: every rank's history of epochs 2-3 and final state equal an
    unbroken 3-epoch run's bit for bit. The draws depend on the epoch alone and inject
    the subsamples, so a resumed segment draws what the unbroken run draws."""
    run, whole = unbroken_run
    cfg, ck = RESUME_CFG, dict(ckpt_dir=str(tmp_path / "ck"))
    part = run(dataclasses.replace(cfg, epochs=1, epoch_scan=first, **ck))
    saved = load_resume(tmp_path / "ck")
    adam = saved["opt_state"]
    assert adam["0"]["count"].dtype == np.int32 and int(adam["0"]["count"]) == int(adam["1"]["count"]) > 0
    assert saved["params"].keys() == whole[0].params.keys()
    assert all(saved["params"][k].shape == v.shape for k, v in whole[0].params.items())
    rest = run(dataclasses.replace(cfg, epoch_scan=then, **ck))
    for p, r, w in zip(part, rest, whole):
        assert [h["epoch"] for h in p.history + r.history] == [1, 2, 3]
        assert _same_run(dataclasses.replace(r, history=p.history + r.history), w)


def test_stop_file_stops_every_rank_under_the_program(ranks, tmp_path):
    """A stop file that rank 0 finds ends the program's run on all four ranks (tp=2)
    after the first epoch, with resume state written and nothing left waiting."""
    stop = tmp_path / "STOP"
    stop.write_text("")
    cfg = TrainConfig(epochs=3, batch_size=8, save_interval=2, lr=1e-3, tp=2, epoch_scan=True,
                      ckpt_dir=str(tmp_path / "ck"), stop_file=str(stop))
    out = ranks(dryrun.train_model_ranks, 4, (NIOFP1D, SMALL_1D),
                _np(NIOFP1D(**SMALL_1D).state_dict()), _fpe1d_data(), GRID_1D, cfg)
    assert all(not r.finished and r.history == [] for r in out)
    assert load_resume(tmp_path / "ck")["epoch"] == 1
