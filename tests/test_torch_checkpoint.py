"""The port's checkpoints keep every behaviour of ``blindno/train/checkpoint.py`` in a
torch-native format: exact round trips, the numerically best of several ``best_*``, a
replayed name moved aside as ``.old`` and removed after the save, atomic resume
writes, quarantine of non-finite params, and the warm restart from ``best_*``."""
import os

import pytest
import torch

from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.train import checkpoint as ck
from blindno_torch.train.loop import TrainConfig, _state, train_model
from blindno_torch.train.step import make_optimizer

SMALL = dict(width=4, modes=4, n_basis=3, neurons=8, fno_layers=1)


def _tree(seed, n=3):
    g = torch.Generator().manual_seed(seed)
    return {f"w{i}": torch.randn(2, i + 1, generator=g) for i in range(n)}


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_best_round_trip_is_exact(tmp_path):
    params, stats = _tree(0), {"running_var": torch.rand(5), "num_batches_tracked": torch.tensor(3)}
    path = ck.save_best(str(tmp_path), params, stats, epoch=7, test_loss=0.1234567)
    assert os.path.basename(path) == "best_0.123457_e7"
    raw = ck.load_best(str(tmp_path))
    assert _equal(raw["params"], params) and _equal(raw["batch_stats"], stats)
    assert raw["epoch"] == 7 and raw["test_loss"] == 0.1234567
    assert sorted(os.listdir(tmp_path)) == ["best_0.123457_e7"]  # no temporary left


def test_a_new_best_replaces_the_old_one(tmp_path):
    d = str(tmp_path)
    ck.save_best(d, _tree(0), {}, epoch=400, test_loss=0.0053151)
    ck.save_best(d, _tree(1), {}, epoch=410, test_loss=0.0053148)  # same 6-decimal loss
    assert os.listdir(d) == ["best_0.005315_e410"]
    raw = ck.load_best(d)
    assert raw["epoch"] == 410 and _equal(raw["params"], _tree(1))


def test_load_best_picks_the_smallest_loss_not_the_first_name(tmp_path):
    """Several best_* survive a crash; lexicographic order would pick 0.9."""
    for loss, seed in ((0.9, 0), (0.25, 1), (0.5, 2), (10.0, 3)):
        torch.save({"params": _tree(seed), "batch_stats": {}, "epoch": seed, "test_loss": loss},
                   tmp_path / f"best_{loss:.6f}_e{seed}")
    raw = ck.load_best(str(tmp_path))
    assert raw["test_loss"] == 0.25 and _equal(raw["params"], _tree(1))
    with pytest.raises(FileNotFoundError):
        ck.load_best(str(tmp_path / "empty"))


def test_replayed_name_goes_aside_and_is_removed_after_the_save(tmp_path, monkeypatch):
    d = str(tmp_path)
    ck.save_best(d, _tree(0), {}, epoch=7, test_loss=0.25)
    seen = []
    save = torch.save

    def spy(obj, f):  # what the directory holds while the new best is written
        seen.append(sorted(os.listdir(d)))
        save(obj, f)

    monkeypatch.setattr(ck.torch, "save", spy)
    ck.save_best(d, _tree(1), {}, epoch=7, test_loss=0.25)
    assert seen == [["best_0.250000_e7.old"]]  # the old one still parses as a fallback
    assert os.listdir(d) == ["best_0.250000_e7"]
    assert _equal(ck.load_best(d)["params"], _tree(1))


def test_resume_writes_atomically(tmp_path, monkeypatch):
    """A crash while writing leaves the previous resume.pt whole."""
    d = str(tmp_path)
    ck.save_resume(d, _tree(0), {}, {"state": {}, "param_groups": []}, epoch=2, best_loss=0.5)

    def crash(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ck.torch, "save", crash)
    with pytest.raises(OSError):
        ck.save_resume(d, _tree(1), {}, {}, epoch=3, best_loss=0.4)
    state = ck.load_resume(d)
    assert state["epoch"] == 2 and state["best_loss"] == 0.5 and _equal(state["params"], _tree(0))
    assert ck.load_resume(str(tmp_path / "none")) is None


def test_resume_round_trips_the_optimizer(tmp_path):
    model = NIOFP2D(**SMALL, device="cpu")
    opt = make_optimizer(model)
    for p in opt.param_groups[0]["params"]:
        p.grad = torch.ones_like(p)
    opt.step()
    ck.save_resume(str(tmp_path), *_state(model), opt.state_dict(), epoch=4, best_loss=1.5)
    state = ck.load_resume(str(tmp_path))
    fresh = make_optimizer(NIOFP2D(**SMALL, device="cpu"))
    fresh.load_state_dict(state["opt_state"])
    for a, b in zip(opt.state.values(), fresh.state.values()):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert _equal(state["params"], dict(model.named_parameters()))


def test_non_finite_resume_is_quarantined(tmp_path):
    params = _tree(0)
    params["w1"][0, 1] = float("nan")
    ck.save_resume(str(tmp_path), params, {}, {}, epoch=3, best_loss=0.5)
    assert ck.load_resume(str(tmp_path)) is None
    assert os.listdir(tmp_path) == ["resume.pt.poisoned"]


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
    """train_model without resume.pt but with a best_* at epoch 3: Adam's moments start
    at zero and every parameter's step at (start_epoch - 1) * steps_per_epoch."""
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
