"""The plain reference against the port on the CPU, at each configuration's published
widths with a small set and batch: the leaves, the eval forward, the train-mode forward
and one training step."""
from __future__ import annotations

import pytest
import torch

from benchmark import check, common
from benchmark.reference import models
from benchmark.reference.train import predict, replay
from benchmark.tests.conftest import small_config

CONFIGS = ["fpe2d_unet", "fpe2d_nio"]


def _setup(name, seed=5):
    cfg = small_config(name)
    weights = common.draw_leaves(models.leaves(cfg), common.generator(seed, 1, "cpu"), "cpu")
    return cfg, weights, common.build_model(cfg, weights, "cpu"), common.grid(cfg)


@pytest.mark.parametrize("name", CONFIGS)
def test_leaves_are_the_port_state(name):
    cfg, _, model, _ = _setup(name)
    state = model.state_dict()
    leaves = models.leaves(cfg)
    assert sorted(leaves) == sorted(state)
    assert all(tuple(state[k].shape) == tuple(shape) for k, (shape, _) in leaves.items())
    trained = {k for k, (_, kind) in leaves.items() if kind in models.TRAINED}
    assert trained == {k for k, p in model.named_parameters() if p.requires_grad}


@pytest.mark.parametrize("name", CONFIGS)
def test_eval_forward(name):
    from blindno_torch.eval.field_eval import predict_fields

    cfg, weights, model, grid = _setup(name)
    sets, _ = common.archive(cfg, 3, 9, 4, "cpu")
    port = predict_fields(model, sets, grid, batch=2, device="cpu")
    ref = predict(cfg, weights, sets, grid, "cpu", batch_size=2)
    assert port.shape == ref.shape == (3, 61, 61, 2)
    assert check.eval_numbers(port, ref)["field_gap"] < 1e-4


@pytest.mark.parametrize("name", CONFIGS)
def test_train_forward(name):
    cfg, weights, model, grid = _setup(name)
    x = torch.randn(2, 4, 61, 61, generator=torch.Generator().manual_seed(3))
    sub = (torch.tensor([0, 2, 3, 3]), torch.tensor([True, True, True, False]))
    g = torch.as_tensor(grid)
    with torch.no_grad():
        port = model.train()(x, g, subsample=sub)
        ref = models.forward(cfg, weights, x, g, train=True, subsample=sub)
    assert torch.allclose(port, ref, rtol=1e-4, atol=1e-4 * float(ref.abs().max()))


@pytest.mark.parametrize("name", CONFIGS)
def test_one_training_step(name):
    """One step of the port's train_step against the reference's replay of it."""
    from blindno_torch.train.step import make_optimizer, train_step

    cfg, weights, model, grid = _setup(name)
    inputs, targets = common.archive(cfg, 10, 4, 2, "cpu")
    positions = torch.tensor([[1, 6]])
    draws = (positions, torch.tensor([5]), torch.tensor([[0, 2, 3, 3]]),
             torch.tensor([[True, True, True, False]]))
    ref = replay(cfg, weights, inputs, targets, grid, draws, "cpu")
    from benchmark.reference.train import batch, train_split

    rows = train_split(10, cfg["train"]["train_frac"], cfg["train"]["split_seed"])[[1, 6]]
    x, y = batch(cfg, inputs, targets, rows, 5, "cpu")
    opt = make_optimizer(model.train(), cfg["train"]["lr"])
    loss = train_step(model, opt, x, y, torch.as_tensor(grid), subsample=(draws[2][0], draws[3][0]))
    grads = {k: p.grad for k, p in model.named_parameters() if p.requires_grad}
    change = {k: p.detach() - weights[k] for k, p in model.named_parameters() if p.requires_grad}
    numbers = check.train_numbers({"losses": [float(loss)], "grads": grads, "change": change}, ref)
    assert numbers["loss1_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-2
    assert numbers["change_median_gap"] < 1e-3
