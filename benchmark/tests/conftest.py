"""Shared fixtures of the benchmark's tests: small CPU runs of a cell, and the card
check of the tests marked ``cuda``."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from benchmark import common


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    """Skips the test without a CUDA card (decided here, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_config(name: str) -> dict:
    """The configuration at its published widths with a small set, batch and archive."""
    cfg = copy.deepcopy(common.load_json(common.BENCH / "configs" / f"{name}.json"))
    cfg["snapshots"] = 4
    cfg["model"]["kwargs"]["l_min"] = 2
    cfg["m_train"], cfg["m_test"] = 10, 6
    cfg["train"]["batch_size"] = 2
    return cfg


def small_run(cell: str, tmpdir, seed=2**31 + 11, seconds=0.2, device="cpu", full=False) -> common.Run:
    """A run of ``cell`` on the CPU at :func:`small_config`'s size (``full``: the cell's
    own size, for a card)."""
    spec = common.benchmark_spec()
    c, config, traffic, limits = common.cell_files(spec, cell)
    if not full:
        config = small_config(c["config"])
        traffic = dict(traffic)
        if "batch" in traffic:
            traffic.update(batch=2, warm_calls=1, sample_calls=2, trace_calls=2)
    return common.Run(cell=c, config=config, traffic=traffic, limits=limits, seed=seed,
                      seconds=seconds, trace=False, device=torch.device(device),
                      tmpdir=str(tmpdir), t_start=time.perf_counter(),
                      flops=common.flops_module(config))
