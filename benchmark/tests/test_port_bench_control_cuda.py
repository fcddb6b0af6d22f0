"""The control on the card, at each cell's own size: the plain reference computed with
TF32 on (the nearest precision below the configurations' float32 with TF32 off) in the
program's place must come out not correct under the cell's limits, while the program
comes out correct. Run on a card: ``python -m pytest -q benchmark/tests -m cuda``."""
from __future__ import annotations

import pytest

from benchmark import check, common
from benchmark.tests.conftest import small_run
from benchmark.traffic import predict_closed, train_loop

CELLS = [w["name"] for w in common.benchmark_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [2**31 + 101, 2**31 + 102, 2**31 + 103])
def test_control_is_not_correct(cell, seed, cuda, tmp_path):
    r = small_run(cell, tmp_path, seed=seed, device=cuda, full=True)
    common.set_precision(r.config)
    if r.traffic["driver"] == "train_loop":
        out = train_loop.first_steps_numbers(r, ("tf32",))
    else:
        out = predict_closed.calibrate(r, r.traffic["sample_calls"], tf32=True)
    print(cell, seed, out)
    assert check.verdict(out["program"], r.limits)[0]
    assert not check.verdict(out["tf32"], r.limits)[0]
