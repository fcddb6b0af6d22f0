"""The port's symmetry augmentation, its test-time average and the StepLR schedule
against the JAX package's: ``make_augment`` element by element (exactly), the inverse
table ``tta_indices``, ``step_lr`` at every step across two decay boundaries, and
``predict_fields_tta`` of a small ``NIOFP2D`` on weights moved over from flax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindno.eval.field_eval import predict_fields_tta as jax_predict_fields_tta
from blindno.eval.field_eval import tta_indices as jax_tta_indices
from blindno.models.nio2d import NIOFP2D as JNIOFP2D
from blindno.train.loop import make_augment as jax_make_augment
from blindno.train.loop import step_lr as jax_step_lr
from blindno_torch.convert import from_flax
from blindno_torch.eval.field_eval import predict_fields_tta, tta_indices
from blindno_torch.models.nio2d import NIOFP2D
from blindno_torch.train.loop import make_augment, step_lr
from test_nio2d_torch_parity import _randomize_bn
from test_torch_train import CFG, NX, _grid

KINDS = {"d4_scalar": 8, "c4_vector": 4, "flip1d": 2}
TTA_TOL = 2e-3  # the NIO parity bound, tests/test_nio2d_torch_parity.py:190


def _xy(kind, rng):
    """x (B, L, H, W) and y (B, H, W, F) on a square grid, or (B, L, N) and (B, N, F)
    for the 1-D kind; two target components for the vector rule."""
    if kind == "flip1d":
        return rng.standard_normal((2, 3, 7)), rng.standard_normal((2, 7, 2))
    return rng.standard_normal((2, 3, 5, 5)), rng.standard_normal((2, 5, 5, 2))


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_every_group_element_equals_jax(kind):
    x, y = (a.astype(np.float32) for a in _xy(kind, np.random.default_rng(0)))
    got, want = make_augment(kind), jax_make_augment(kind)
    assert len(got) == len(want) == KINDS[kind]
    outs = []
    for i, (f, g) in enumerate(zip(got, want)):
        gx, gy = f(torch.from_numpy(x), torch.from_numpy(y))
        wx, wy = g(jnp.asarray(x), jnp.asarray(y))
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx), err_msg=f"x, element {i}")
        np.testing.assert_array_equal(gy.numpy(), np.asarray(wy), err_msg=f"y, element {i}")
        outs.append(gy.numpy())
    # the elements are distinct transforms of a generic input
    assert len({o.tobytes() for o in outs}) == len(outs)


def test_unknown_kind_raises_and_none_is_no_augmentation():
    assert make_augment(None) is None
    with pytest.raises(ValueError):
        make_augment("d8")
    with pytest.raises(ValueError):
        tta_indices("d8")


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_tta_indices_equal_jax_and_invert(kind):
    inv = tta_indices(kind)
    assert inv == jax_tta_indices(kind)
    fns = make_augment(kind)
    x, y = (torch.from_numpy(a.astype(np.float32)) for a in _xy(kind, np.random.default_rng(1)))
    for i, f in enumerate(fns):
        bx, by = fns[inv[i]](*f(x, y))
        torch.testing.assert_close(bx, x, rtol=0, atol=0)
        torch.testing.assert_close(by, y, rtol=0, atol=0)


def test_step_lr_equals_jax_across_two_decays():
    """lr 5e-4, gamma 0.5, a decay every 3 epochs of 4 steps: steps 0..35 cross the
    boundaries at steps 12 and 24. The port's python floats equal JAX's for python
    steps, and equal in float32 the values optax reads from an int32 step count."""
    args = (5e-4, 0.5, 3, 4)
    got, want = step_lr(*args), jax_step_lr(*args)
    values = [got(s) for s in range(36)]
    assert values == [want(s) for s in range(36)]
    assert sorted(set(values), reverse=True) == [5e-4, 2.5e-4, 1.25e-4]
    assert values.index(2.5e-4) == 12 and values.index(1.25e-4) == 24
    traced = np.asarray(jax.vmap(want)(jnp.arange(36, dtype=jnp.int32)))
    np.testing.assert_array_equal(np.float32(values), traced)


def test_predict_fields_tta_matches_jax():
    """The small NIOFP2D of tests/test_torch_train.py with randomized BatchNorm: the
    D4 average over 8 forwards of a batch of 2 sets, within 2e-3 of JAX's."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, NX, NX)).astype(np.float32)
    grid = _grid()
    jmodel = JNIOFP2D(**CFG)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(grid))
    variables = jax.tree.map(np.asarray, _randomize_bn(variables, np.random.default_rng(7)))
    want = jax_predict_fields_tta(jmodel, variables["params"], variables["batch_stats"], x,
                                  jnp.asarray(grid), "d4_scalar", batch=2)
    model = NIOFP2D(**CFG, device="cpu")
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    got = predict_fields_tta(model, x, grid, "d4_scalar", batch=2, device="cpu")
    assert got.shape == want.shape == (2, NX, NX, 2)
    assert np.std(want) > 1e-3
    np.testing.assert_allclose(got, want, rtol=TTA_TOL, atol=TTA_TOL)
    # the average differs from the single pass: the model is not D4-equivariant
    single = np.asarray(jmodel.apply(variables, jnp.asarray(x), jnp.asarray(grid)))
    assert np.abs(single - want).max() > 2 * TTA_TOL
