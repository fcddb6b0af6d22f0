"""The port's checkpoints keep every behaviour of ``blindno/train/checkpoint.py`` in the
JAX package's own formats (orbax ``best_*`` directories, ``resume.msgpack``): exact round
trips, the numerically best of several ``best_*``, a replayed name moved aside as
``.old`` and removed after the save, atomic resume writes, quarantine of non-finite
params, the warm restart from ``best_*``, and an earlier port version's ``torch.save``
files read and then replaced."""
import os

import pytest
import torch

from blindno_torch.convert import adam_from_optax, adam_to_optax, to_flax
from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.train import checkpoint as ck
from blindno_torch.train import jax_checkpoint as jc
from blindno_torch.train.loop import TrainConfig, _state, train_model
from blindno_torch.train.step import make_optimizer

SMALL = dict(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1)


def _model(seed, **kw):
    """A small NIOFP2D drawn from ``seed``, its running statistics drawn too."""
    model = NIOFP2D(**{**SMALL, **kw}, generator=torch.Generator().manual_seed(seed),
                    device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    for name, b in model.named_buffers():
        if name.endswith("running_mean"):
            b.copy_(torch.randn(b.shape, generator=g))
        elif name.endswith("running_var"):
            b.copy_(torch.rand(b.shape, generator=g) + 0.5)
        else:
            b.fill_(seed + 3)  # num_batches_tracked
    return model


def _tree(seed):
    """(params, batch_stats) of :func:`_model`."""
    return _state(_model(seed))


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def _same_stats(got, want):
    """The running statistics bit for bit; ``num_batches_tracked``, which flax does not
    keep, restored as 0."""
    counts = [k for k in want if k.endswith("num_batches_tracked")]
    return got.keys() == want.keys() and all(int(got[k]) == 0 for k in counts) and all(
        torch.equal(got[k], want[k]) for k in want if k not in counts)


def _optax(opt, model):
    params = dict(model.named_parameters())
    return adam_to_optax(opt.state_dict(), params,
                         [k for k, p in params.items() if p.requires_grad])


def test_best_round_trip_is_exact(tmp_path):
    params, stats = _tree(0)
    path = ck.save_best(str(tmp_path), params, stats, epoch=7, test_loss=0.1234567)
    assert os.path.basename(path) == "best_0.123457_e7" and jc.is_orbax(path)
    raw = ck.load_best(str(tmp_path))
    assert _equal(raw["params"], params) and _same_stats(raw["batch_stats"], stats)
    assert raw["epoch"] == 7 and raw["test_loss"] == 0.1234567
    assert sorted(os.listdir(tmp_path)) == ["best_0.123457_e7"]  # no temporary left
    flax_params, flax_stats = to_flax({**params, **stats})
    got = jc.read_orbax(path)
    assert got["params"].keys() == flax_params.keys() and got["batch_stats"].keys() == \
        flax_stats.keys()


def test_a_new_best_replaces_the_old_one(tmp_path):
    d = str(tmp_path)
    ck.save_best(d, *_tree(0), epoch=400, test_loss=0.0053151)
    ck.save_best(d, *_tree(1), epoch=410, test_loss=0.0053148)  # same 6-decimal loss
    assert os.listdir(d) == ["best_0.005315_e410"]
    raw = ck.load_best(d)
    assert raw["epoch"] == 410 and _equal(raw["params"], _tree(1)[0])


def test_load_best_picks_the_smallest_loss_not_the_first_name(tmp_path):
    """Several best_* survive a crash, orbax directories and an earlier port version's
    files; lexicographic order would pick 0.9."""
    for loss, seed in ((0.9, 0), (0.25, 1), (0.5, 2), (10.0, 3)):
        params, stats = _tree(seed)
        path = tmp_path / f"best_{loss:.6f}_e{seed}"
        if seed % 2:
            flax_params, flax_stats = to_flax({**params, **stats})
            jc.write_orbax(str(path), {"params": flax_params, "batch_stats": flax_stats,
                                       "epoch": seed, "test_loss": loss})
        else:
            torch.save({"params": params, "batch_stats": stats, "epoch": seed,
                        "test_loss": loss}, path)
    raw = ck.load_best(str(tmp_path))
    assert raw["test_loss"] == 0.25 and _equal(raw["params"], _tree(1)[0])
    os.rename(tmp_path / "best_0.250000_e1", tmp_path / "best_0.950000_e1")
    raw = ck.load_best(str(tmp_path))  # now a file: 0.5
    assert raw["test_loss"] == 0.5 and _equal(raw["params"], _tree(2)[0])
    with pytest.raises(FileNotFoundError):
        ck.load_best(str(tmp_path / "empty"))


def test_replayed_name_goes_aside_and_is_removed_after_the_save(tmp_path, monkeypatch):
    d = str(tmp_path)
    ck.save_best(d, *_tree(0), epoch=7, test_loss=0.25)
    seen = []
    write = jc.write_orbax

    def spy(directory, tree):  # what the directory holds while the new best is written
        seen.append(sorted(os.listdir(d)))
        write(directory, tree)

    monkeypatch.setattr(ck.jax_checkpoint, "write_orbax", spy)
    ck.save_best(d, *_tree(1), epoch=7, test_loss=0.25)
    assert seen == [["best_0.250000_e7.old"]]  # the old one still parses as a fallback
    assert os.listdir(d) == ["best_0.250000_e7"]
    assert _equal(ck.load_best(d)["params"], _tree(1)[0])


def _stepped(seed):
    """A small NIOFP2D and its Adam after one step of a seeded gradient."""
    model = _model(seed)
    opt = make_optimizer(model)
    g = torch.Generator().manual_seed(seed)
    for p in opt.param_groups[0]["params"]:
        p.grad = torch.randn(p.shape, generator=g)
    opt.step()
    return model, opt


def test_resume_writes_atomically(tmp_path, monkeypatch):
    """A crash while writing leaves the previous resume.msgpack whole."""
    d = str(tmp_path)
    model, opt = _stepped(0)
    ck.save_resume(d, *_state(model), _optax(opt, model), epoch=2, best_loss=0.5)

    def crash(path, state):
        with open(path, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.jax_checkpoint, "write_msgpack", crash)
    with pytest.raises(OSError):
        ck.save_resume(d, *_tree(1), _optax(opt, model), epoch=3, best_loss=0.4)
    state = ck.load_resume(d)
    assert state["epoch"] == 2 and state["best_loss"] == 0.5
    assert _equal(state["params"], dict(model.named_parameters()))
    assert ck.load_resume(str(tmp_path / "none")) is None


def test_resume_round_trips_the_optimizer(tmp_path):
    """resume.msgpack is flax's msgpack: its Adam state, mapped back onto a fresh
    optimizer, equals the saved one bit for bit, and its BatchNorm counts are Adam's
    step."""
    model, opt = _stepped(0)
    ck.save_resume(str(tmp_path), *_state(model), _optax(opt, model), epoch=4, best_loss=1.5)
    assert os.listdir(tmp_path) == [ck.RESUME]
    state = ck.load_resume(str(tmp_path))
    fresh = make_optimizer(NIOFP2D(**SMALL, device="cpu"))
    names = [k for k, p in model.named_parameters() if p.requires_grad]
    fresh.load_state_dict(adam_from_optax(state["opt_state"], names,
                                          fresh.state_dict()["param_groups"]))
    for a, b in zip(opt.state.values(), fresh.state.values()):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert _equal(state["params"], dict(model.named_parameters()))
    stats = dict(model.named_buffers())
    for k, v in state["batch_stats"].items():
        assert torch.equal(v, torch.tensor(1) if k.endswith("num_batches_tracked") else stats[k])
    assert (state["epoch"], state["best_loss"]) == (4, 1.5)


def test_non_finite_resume_is_quarantined(tmp_path):
    model, opt = _stepped(0)
    params, stats = _state(model)
    params = {k: v.detach().clone() for k, v in params.items()}
    params["heads.0.fc0.weight"][0, 1] = float("nan")
    ck.save_resume(str(tmp_path), params, stats, _optax(opt, model), epoch=3, best_loss=0.5)
    assert ck.load_resume(str(tmp_path)) is None
    assert os.listdir(tmp_path) == [ck.RESUME + ".poisoned"]


def test_warm_restart_returns_the_best_or_refuses(tmp_path):
    model = NIOFP2D(**SMALL, device="cpu")
    params, stats = _state(model)
    d = str(tmp_path)
    assert ck.load_best_as_warm_restart(d, params, stats) is None  # nothing saved
    ck.save_best(d, params, stats, epoch=5, test_loss=0.75)
    best = ck.load_best_as_warm_restart(d, params, stats)
    assert best["epoch"] == 5 and best["test_loss"] == 0.75
    assert _equal(best["params"], params) and _equal(best["batch_stats"], stats)
    # a different-sized model with the same module tree
    other = NIOFP2D(**{**SMALL, "width": 6}, device="cpu")
    assert ck.load_best_as_warm_restart(d, *_state(other)) is None
    # a model with other modules
    deeper = NIOFP2D(**{**SMALL, "fno_layers": 2}, device="cpu")
    assert ck.load_best_as_warm_restart(d, *_state(deeper)) is None
    # non-finite params
    bad = {k: v.clone() for k, v in params.items()}
    bad["deeponet.b0"] = torch.tensor(float("inf"))
    ck.save_best(d, bad, stats, epoch=6, test_loss=0.5)
    assert ck.load_best_as_warm_restart(d, params, stats) is None


def test_warm_restart_zeroes_the_moments_and_advances_step(tmp_path, monkeypatch):
    """train_model without a resume file but with a best_* at epoch 3: Adam's moments
    start at zero and every parameter's step at (start_epoch - 1) * steps_per_epoch."""
    from test_torch_loop import tiny_data

    data, grid = tiny_data()
    model = NIOFP2D(**SMALL, l_min=2, device="cpu")
    ck.save_best(str(tmp_path), *_state(model), epoch=3, test_loss=0.5)
    seen = {}
    step = torch.optim.Adam.step

    def spy(opt, *a, **k):
        if not seen:
            seen.update({id(p): {n: v.clone() for n, v in opt.state[p].items()}
                         for p in opt.param_groups[0]["params"]})
            seen["lr"] = opt.param_groups[0]["lr"]
        return step(opt, *a, **k)

    monkeypatch.setattr(torch.optim.Adam, "step", spy)
    cfg = TrainConfig(epochs=4, batch_size=4, lr=1e-3, lr_step_epochs=2, save_interval=1,
                      ckpt_dir=str(tmp_path))
    res = train_model(model, data, grid, cfg, device="cpu")
    assert [h["epoch"] for h in res.history] == [4]
    states = [v for k, v in seen.items() if k != "lr"]
    assert len(states) == len(list(p for p in model.parameters() if p.requires_grad))
    for s in states:  # 9 train samples at batch 4: 2 steps an epoch, 3 epochs done
        assert float(s["step"]) == 6.0
        assert not s["exp_avg"].any() and not s["exp_avg_sq"].any()
    assert seen["lr"] == 5e-4  # step 6 is in epoch 4, past the decay at epoch 3


def test_an_earlier_ports_files_are_read_then_replaced(tmp_path):
    """An earlier port version's ``best_*`` file and ``resume.pt`` (``torch.save``) are
    read: the loop resumes from them bit for bit. Its next ``save_best`` and
    ``save_resume`` replace them with the JAX formats, and no ``.pt`` stays."""
    from test_torch_loop import tiny_data

    data, grid = tiny_data()
    d = str(tmp_path)
    model, opt = _stepped(0)
    params, stats = _state(model)
    torch.save({"params": params, "batch_stats": stats, "epoch": 1, "test_loss": 9.5},
               os.path.join(d, "best_9.500000_e1"))
    torch.save({"params": params, "batch_stats": stats, "opt_state": opt.state_dict(),
                "epoch": 1, "best_loss": 9.5}, os.path.join(d, ck.OLD_RESUME))
    raw = ck.load_best(d)
    assert raw["epoch"] == 1 and _equal(raw["params"], params) and _equal(raw["batch_stats"], stats)
    state = ck.load_resume(d)
    assert state["path"] == os.path.join(d, ck.OLD_RESUME) and state["epoch"] == 1
    assert _equal(state["opt_state"]["state"][0], opt.state_dict()["state"][0])

    loaded = {}
    load = torch.optim.Adam.load_state_dict

    def spy(optimizer, sd):
        load(optimizer, sd)
        loaded.update({i: {k: v.clone() for k, v in s.items()}
                       for i, s in optimizer.state_dict()["state"].items()})

    cfg = TrainConfig(epochs=2, batch_size=4, lr=1e-3, save_interval=1, ckpt_dir=d)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.optim.Adam, "load_state_dict", spy)
        res = train_model(_model(5, l_min=2), data, grid, cfg, device="cpu")
    assert [h["epoch"] for h in res.history] == [2]
    want = opt.state_dict()["state"]
    assert loaded.keys() == want.keys() and all(_equal(loaded[i], want[i]) for i in want)
    names = sorted(os.listdir(d))
    assert names == [f"best_{res.history[0]['test_loss']:.6f}_e2", ck.RESUME]
    assert jc.is_orbax(os.path.join(d, names[0]))
    assert ck.load_resume(d)["epoch"] == 2
