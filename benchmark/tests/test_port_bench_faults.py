"""A run's verdict with the timed path broken underneath: the harness's look for a chip
skipped, the rest of a run driven on the CPU at a small size, and ``correct`` read. A
sound run comes out correct; each fault that a cell can have comes out not correct: a
step that leaves the state unchanged, half of the batch left out (the mean taken over the
rest), an answer altered where it is produced. (One chip: no exchange between chips to
leave out.)"""
from __future__ import annotations

import pytest
import torch

from benchmark import common, run
from benchmark.tests.conftest import small_run

SPEC = common.benchmark_spec()


def _correct(cell, tmp_path) -> bool:
    return run.execute(small_run(cell, tmp_path), SPEC)["correct"]


def _no_update(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def _half_batch(monkeypatch):
    from blindno_torch.train import loop

    step = loop.train_step

    def half(net, opt, x, y, grid, **kw):
        return step(net, opt, x[: len(x) // 2], y[: len(y) // 2], grid, **kw)

    monkeypatch.setattr(loop, "train_step", half)


def _altered_answer(monkeypatch):
    from blindno_torch.eval import field_eval

    predict = field_eval.predict_fields

    def altered(*args, **kw):
        out = predict(*args, **kw)
        out[0, ..., 0] *= 1.01
        return out

    monkeypatch.setattr(field_eval, "predict_fields", altered)


@pytest.mark.parametrize("cell", ["fpe2d_unet.train", "fpe2d_unet.eval", "fpe2d_nio.eval"])
def test_sound_run_is_correct(cell, tmp_path):
    assert _correct(cell, tmp_path)


@pytest.mark.parametrize("cell,fault", [
    ("fpe2d_unet.train", _no_update), ("fpe2d_unet.train", _half_batch),
    ("fpe2d_nio.train", _no_update), ("fpe2d_nio.train", _half_batch),
    ("fpe2d_unet.eval", _altered_answer), ("fpe2d_nio.eval", _altered_answer)],
    ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_fault_is_not_correct(cell, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    assert not _correct(cell, tmp_path)
