"""``TrainConfig(epoch_scan=True)`` on the CPU: the port's epoch program
(``blindno_torch/train/scan.py``) run uncaptured, as ``device="cpu"`` asks.

- Against JAX's ``epoch_scan`` path, each epoch one ``lax.scan`` of the step
  (``_jax_loop(..., scan=True)``, restated from the package's pieces as
  ``tests/test_torch_loop.py`` restates the per-step path): the same weights and draws,
  ``d4_scalar`` and bfloat16 input storage, 2 epochs.
- Against the port's own per-step loop with its seeded draws, for each augment kind, no
  augmentation and bfloat16 ``all``: bit for bit. The group element there is a gather
  by a device index into tables of the branches' permutations, where the loop calls the
  branch (``torch.rot90``, ``torch.flip``, the vector mix): both move the same values.
- A run checkpointed under one mode and resumed under the other equals an unbroken run.
- What stays refused across ranks (a gloo group on a card), and the optimizer state a
  capturable Adam saves. The program across ranks: ``tests/test_torch_epoch_scan_parallel.py``.

The encoders are narrowed (``ENC_DIMS``, ``ENC_DIMS_1D``) on both sides, as the float16
loop test narrows them, so that the file runs in well under a minute on one thread.
"""
import dataclasses

import numpy as np
import pytest
import torch

import blindno.models.nio2d as jax_nio2d
from blindno.data.datasets import load_fpe2d as jax_load_fpe2d
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.nn.cnn import Encoder2D as JEncoder2D
from blindno_torch.convert import adam_to_optax, from_flax
from blindno_torch.data.datasets import SetToFieldData, load_fpe2d
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.models.nio1d import NIOFP1D
from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.nn.cnn import Encoder1D, Encoder2D
from blindno_torch.train import loop
from blindno_torch.train.checkpoint import RESUME
from blindno_torch.train.jax_checkpoint import read_msgpack
from blindno_torch.train.loop import TrainConfig, make_augment, train_model
from blindno_torch.train.scan import GroupTables
from blindno_torch.train.step import make_capturable, make_optimizer
from test_torch_loop import (L, L_MIN, M, PARITY_CFG, SMALL, _draw_source, _jax_loop, _rel,
                             fpe2d_archive)
from test_torch_nio3d import seeded_variables
from test_torch_train import CFG, ENCODER_GRAD_TOL, STEP_TOL, _grid

ENC_DIMS = (16, 32, 32, 32, 32)  # the Encoder2D's five widths, narrowed
ENC_DIMS_1D = (16, 32, 32)
N1D = 80


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as ``tests/test_torch_loop.py`` sets it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nio2d(**kw):
    model = NIOFP2D(**{**SMALL, **kw}, l_min=L_MIN, device="cpu")
    model.deeponet.branch = Encoder2D(SMALL["n_basis"], dims=ENC_DIMS)
    return model


def _unet():
    return PermInvUNetAttn(input_size=(61, 61), depth=2, width=4, fno_modes=4, fno_layers=2,
                           subsample=True, l_min=L_MIN, device="cpu")


def _nio1d():
    model = NIOFP1D(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1, l_min=L_MIN,
                    device="cpu")
    model.deeponet.branch = Encoder1D(3, dims=ENC_DIMS_1D)
    return model


def _data_1d(m=M, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, 1, N1D)) + 0.5 * rng.standard_normal((m, L, N1D)))
    y = rng.standard_normal((m, N1D, 2))
    grid = np.linspace(0, 1, N1D, dtype=np.float32).reshape(-1, 1)
    return SetToFieldData(x.astype(np.float32), y.astype(np.float32)), grid


def _data_2d():
    return load_fpe2d(fpe2d_archive()), _grid()


def _same_run(a, b):
    """Whether two TrainResults are equal bit for bit: history and final state."""
    keys = ("epoch", "train_loss", "test_loss", "field_rel_l2")
    hist = [{k: h[k] for k in keys} for h in a.history] == [{k: h[k] for k in keys}
                                                            for h in b.history]
    state = all(torch.equal(a.params[k], b.params[k]) for k in a.params) and all(
        torch.equal(a.batch_stats[k], b.batch_stats[k]) for k in a.batch_stats)
    return hist and state


def test_epoch_scan_matches_jax_lax_scan_epochs(monkeypatch):
    """The loop-parity run of ``tests/test_torch_loop.py`` (8 steps over 2 epochs at
    batch 2, ``d4_scalar`` with all 8 elements drawn, bfloat16 input storage, StepLR
    decaying after epoch 1, an eval after each epoch) with the Encoder2D narrowed on both
    sides: the port's ``epoch_scan=True`` against JAX's ``lax.scan`` epochs from the same
    seeded weights and draws. The history within STEP_TOL = 2e-3 relative, every
    parameter within STEP_TOL and, in the Encoder2D, ENCODER_GRAD_TOL = 1e-2 (relative
    L2; its running means are left out, as the loop-parity test leaves them out)."""
    cfg = dataclasses.replace(PARITY_CFG, epoch_scan=True)
    data, jdata, grid = load_fpe2d(fpe2d_archive()), jax_load_fpe2d(fpe2d_archive()), _grid()
    monkeypatch.setattr(jax_nio2d, "Encoder2D", lambda n, fk: JEncoder2D(n, fk, *ENC_DIMS))
    jmodel = JNIOFP2D(**CFG, l_min=L_MIN)
    variables = seeded_variables(jmodel, np.random.default_rng(7), data.inputs[:2], grid)
    want_hist, jparams, jstats = _jax_loop(jmodel, variables, jdata, grid, cfg, _draw_source(),
                                           monkeypatch, scan=True)
    model = NIOFP2D(**CFG, l_min=L_MIN, device="cpu")
    model.deeponet.branch = Encoder2D(CFG["n_basis"], dims=ENC_DIMS)
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    res = train_model(model, data, grid, cfg, device="cpu", draws=_draw_source())

    assert [h["epoch"] for h in res.history] == [1, 2] and res.finished
    for got, want in zip(res.history, want_hist, strict=True):
        for k in ("train_loss", "test_loss"):
            assert abs(got[k] - want[k]) <= STEP_TOL * abs(want[k]), (got, want)
        assert _rel(got["field_rel_l2"], want["field_rel_l2"]) <= STEP_TOL, (got, want)
    want_state = from_flax(jparams, jstats)
    got_state = {**res.params, **res.batch_stats}
    errs = {k: _rel(got_state[k], v) for k, v in want_state.items()
            if not k.endswith("num_batches_tracked")
            and not (k.startswith("deeponet.branch.") and k.endswith("running_mean"))}
    bad = {k: e for k, e in errs.items()
           if not e <= (ENCODER_GRAD_TOL if k.startswith("deeponet.branch.") else STEP_TOL)}
    assert not bad, bad
    initial = from_flax(variables["params"], variables["batch_stats"])
    assert _rel(got_state["heads.0.fc0.weight"], initial["heads.0.fc0.weight"]) > \
        10 * errs["heads.0.fc0.weight"]


# case -> (model, data, TrainConfig fields)
CASES = {
    "d4_scalar": (_nio2d, _data_2d, dict(augment="d4_scalar", compress_inputs=True)),
    "c4_vector": (_unet, _data_2d, dict(augment="c4_vector")),
    "flip1d": (_nio1d, _data_1d, dict(augment="flip1d")),
    "none": (_unet, _data_2d, dict()),
    "bf16_all": (_unet, _data_2d, dict(augment="d4_scalar", compute_dtype="bfloat16",
                                       amp_policy="all", compress_inputs=True)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_scan_equals_the_per_step_loop(case):
    """Two epochs of 2 steps at batch 4 from the same weights and seed, the model
    drawing its own set subsamples from the loop's generator: ``epoch_scan=True`` and
    ``False`` give the same history and final state bit for bit. The same operations run
    in the same order (the group element's gather moves the values ``torch.rot90`` and
    ``torch.flip`` move), so nothing is left to a tolerance. bfloat16 runs with oneDNN
    off, as ``tests/test_torch_amp.py`` runs it."""
    factory, data_fn, fields = CASES[case]
    data, grid = data_fn()
    cfg = TrainConfig(epochs=2, batch_size=4, lr=1e-3, save_interval=1, seed=3, **fields)
    with torch.backends.mkldnn.flags(enabled=False):
        runs = [train_model(factory(), data, grid, dataclasses.replace(cfg, epoch_scan=scan),
                            device="cpu") for scan in (False, True)]
    assert all(r.finished and len(r.history) == 2 for r in runs)
    assert np.isfinite(runs[0].history[-1]["train_loss"])
    assert runs[0].history[0]["train_loss"] != runs[0].history[1]["train_loss"]
    assert _same_run(*runs)


def _fixed_draws(n_train, steps_seed=5):
    """Draws that depend on the epoch alone, subsamples injected: a resumed segment
    draws what an unbroken run draws at the same epoch."""

    def draw(epoch, steps):
        rng = np.random.default_rng([steps_seed, epoch])
        batch_idx = rng.permutation(n_train)[: 4 * steps].reshape(steps, 4)
        elements = rng.integers(0, 8, steps).tolist()
        subs = [(rng.integers(0, L, L), (np.arange(L) < rng.integers(L_MIN, L)).astype(np.float32))
                for _ in range(steps)]
        return batch_idx, elements, subs

    return draw


@pytest.mark.parametrize("first,then", [(True, False), (False, True)])
def test_a_checkpoint_resumes_across_modes(first, then, tmp_path):
    """Epoch 1 under ``epoch_scan=first`` with a resume checkpoint, then epochs 2-3
    resumed under ``epoch_scan=then``: the history of epochs 2-3 and the final state
    equal an unbroken 3-epoch run's bit for bit. The checkpoint's optimizer state is
    optax's either way (both counts 0-d int32 arrays at Adam's step)."""
    data, grid = _data_2d()
    n_train = int(0.8 * M)
    cfg = TrainConfig(epochs=3, batch_size=4, lr=1e-3, save_interval=1, augment="d4_scalar",
                      lr_step_epochs=2)
    whole = train_model(_nio2d(), data, grid, cfg, device="cpu", draws=_fixed_draws(n_train))
    ck = dict(ckpt_dir=str(tmp_path / "ck"))
    part = train_model(_nio2d(), data, grid, dataclasses.replace(cfg, epochs=1, epoch_scan=first, **ck),
                       device="cpu", draws=_fixed_draws(n_train))
    adam = read_msgpack(str(tmp_path / "ck" / RESUME))["opt_state"]
    counts = [adam["0"]["count"], adam["1"]["count"]]
    assert all(c.dtype == np.int32 and c.shape == () and int(c) == 2 for c in counts)
    rest = train_model(_nio2d(), data, grid, dataclasses.replace(cfg, epoch_scan=then, **ck),
                       device="cpu", draws=_fixed_draws(n_train))
    assert [h["epoch"] for h in part.history + rest.history] == [1, 2, 3]
    resumed = dataclasses.replace(rest, history=part.history + rest.history)
    assert _same_run(resumed, whole)


def test_epoch_scan_is_refused_across_ranks(monkeypatch):
    """What stays refused across ranks: a gloo group whose ranks train on a CUDA card,
    since the program captures the step's collectives in a CUDA graph and gloo's run on
    the host. Driven on the CPU: two ranks by ``WORLD_SIZE``, the group's join returning
    a CUDA device and the group's backend gloo; the check raises before anything moves
    to the device, naming the reason and NCCL. The same group on the CPU passes it."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(loop, "init_distributed", lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(loop.dist, "get_backend", lambda group=None: "gloo")
    data, grid = _data_2d()
    cfg = TrainConfig(epochs=1, batch_size=4, epoch_scan=True)
    with pytest.raises(ValueError, match="'gloo' collectives cannot be captured.*NCCL"):
        train_model(_nio2d(), data, grid, cfg, device="cpu")
    loop._check_scan_backend(torch.device("cpu"))
    monkeypatch.setattr(loop.dist, "get_backend", lambda group=None: "nccl")
    loop._check_scan_backend(torch.device("cuda"))


@pytest.mark.parametrize("kind,spatial,fields", [("d4_scalar", (5, 5), 2), ("c4_vector", (4, 4), 2),
                                                 ("flip1d", (7,), 3)])
def test_group_tables_gather_what_the_branches_make(kind, spatial, fields):
    """Each element's gather equals ``make_augment``'s branch on a random batch, bit for
    bit; only ``c4_vector`` mixes the targets' components."""
    fns = make_augment(kind)
    tables = GroupTables(fns, spatial, fields, "cpu")
    assert tables.xperm.shape[0] == len(fns) and tables.mixes == (kind == "c4_vector")
    g = torch.Generator().manual_seed(0)
    x, y = torch.randn(3, 2, *spatial, generator=g), torch.randn(3, *spatial, fields, generator=g)
    for e, fn in enumerate(fns):
        got = tables.apply(x, y, torch.tensor([e]))
        for a, b in zip(got, fn(x, y)):
            assert torch.equal(a, b)


def _same_tree(got, want):
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(_same_tree(got[k], want[k]) for k in want)
    return got.dtype == want.dtype and got.shape == want.shape and got.tobytes() == want.tobytes()


def test_a_capturable_adams_state_maps_to_optax_as_the_host_adams():
    """What the loop saves of the program's optimizer: a capturable Adam's state dict
    (``capturable`` True, ``lr`` a tensor, as the program leaves it) maps through
    ``adam_to_optax`` to the host Adam's optax state bit for bit. A capturable Adam
    needs its parameters on a card."""
    model = _nio2d()
    opt = make_optimizer(model, lr=1e-3)
    for p in opt.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    opt.step()
    params = dict(model.named_parameters())
    names = [k for k, p in params.items() if p.requires_grad]
    want = adam_to_optax(opt.state_dict(), params, names)
    with pytest.raises(ValueError, match="CUDA"):
        make_capturable(opt)
    for group in opt.param_groups:
        group["capturable"], group["lr"] = True, torch.tensor(1e-3)
    got = adam_to_optax(opt.state_dict(), params, names)
    assert int(got["0"]["count"]) == 1 and _same_tree(got, want)