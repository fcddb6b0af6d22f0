"""The port's vestigial blocks and models against the JAX package on the CPU.

The ODE-observation NIO ``NIOFPOde`` (its FNO1d head on the ``fno1d_layer`` path) and
its ``EncoderODE``, the Helmholtz-era ``EncoderHelm2``, ``ConvBlockTanh``,
``DeconvBlock``, ``ResizeBlock``, ``ConvBlock``'s three norms, the ten activations,
``FourierFeatures``, ``FeedForwardNN`` and the registry's ``VESTIGIAL_MODELS``: each
with flax's weights carried over (``blindno_torch.convert.from_flax``) and the same
seeded inputs, within 2e-3 of the output's scale (the NIO parity bound,
``tests/test_nio2d_torch_parity.py:190``) or 1e-6 for the elementwise functions.
"""
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blindno.models.nio1d import NIOFPOde as JNIOFPOde
from blindno.nn import cnn as jcnn
from blindno.nn import deeponet as jdeeponet
from blindno.suites.registry import VESTIGIAL_MODELS as JVESTIGIAL
from blindno_torch.convert import from_flax
from blindno_torch.models.nio1d import NIOFPOde
from blindno_torch.nn import cnn
from blindno_torch.nn import deeponet
from blindno_torch.ops.spectral_cuda import fno1d_layer_cuda
from blindno_torch.suites.registry import VESTIGIAL_MODELS
from test_torch_nio3d import TOL, _scale_err, seeded_variables, sub_state
from test_torch_train import _TwoPassBatchNorm

N_GRID = 100


def _grid():
    return np.linspace(0.0, 1.0, N_GRID, dtype=np.float32).reshape(N_GRID, 1)


def _block_state(variables):
    """A ConvBlock-like module's flax tree (TorchConv_0, then TorchBatchNorm_0 or
    LayerNorm_0) as the port's block's state dict, through the encoder's rules."""
    wrap = lambda t: {"Encoder2D_0": {"ConvBlock_0": t}}
    stats = variables.get("batch_stats")
    state = from_flax(wrap(variables["params"]), wrap(stats) if stats else {})
    return {k[len("deeponet.branch.blocks.0."):]: v for k, v in state.items()}


def _channel_last(x):
    return np.moveaxis(x, 1, -1)


def _run(jmodel, variables, x_cl, training):
    """JAX's output of a channel-last block, moved to channel-first."""
    out = jmodel.apply(variables, jnp.asarray(x_cl), training=training,
                       mutable=["batch_stats"] if training else False)
    return np.moveaxis(np.asarray(out[0] if training else out), -1, 1)


def test_niofpode_matches_jax():
    """``tests/test_models_1d.py:68-78``'s shapes: (2, 20, 11) observations, a grid of 100
    points, width 8, 8 modes, 5 basis functions, 16 neurons; eval mode with randomized
    BatchNorm statistics. The head's layers run through ``fno1d_layer_cuda``, its plain
    version here on the CPU (no launch counted)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 11)).astype(np.float32)
    cfg = dict(width=8, modes=8, n_basis=5, neurons=16)
    jmodel = JNIOFPOde(**cfg)
    variables = seeded_variables(jmodel, rng, x, _grid())
    model = NIOFPOde(**cfg, device="cpu")
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x), jnp.asarray(_grid()))
    before = fno1d_layer_cuda.launches
    with torch.no_grad():
        got = model(torch.tensor(x), torch.tensor(_grid()))
    assert fno1d_layer_cuda.launches == before
    assert got.shape == (2, N_GRID, 1)
    assert _scale_err(got, want) < TOL


def test_vestigial_models_are_the_jax_registry_s():
    """The same names; ``nio_ode`` builds ``NIOFPOde`` at its defaults (width 30, 15
    modes, 3 layers, 25 basis functions, 100 neurons), whose parameters match the flax
    tree's leaf for leaf in shape."""
    assert VESTIGIAL_MODELS.keys() == JVESTIGIAL.keys()
    model = VESTIGIAL_MODELS["nio_ode"](device="cpu")
    x = jnp.zeros((1, 5, 11), jnp.float32)
    shapes = jax.eval_shape(JVESTIGIAL["nio_ode"]().init, jax.random.PRNGKey(0), x,
                            jnp.asarray(_grid()))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_flax(zeros["params"], zeros["batch_stats"])
    assert {k: tuple(v.shape) for k, v in state.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_encoder_ode_matches_jax(training, monkeypatch):
    """Eleven observations per snapshot collapse to one point; narrow channels."""
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 11)).astype(np.float32)
    jmodel = jcnn.EncoderODE(5, 4, 6, 8)
    variables = seeded_variables(jmodel, rng, x)
    model = cnn.EncoderODE(5, 11, (4, 6, 8)).train(training)
    model.load_state_dict(sub_state("EncoderODE_0", variables, "deeponet.branch."))
    want = jmodel.apply(variables, jnp.asarray(x), training=training,
                        mutable=["batch_stats"] if training else False)
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert _scale_err(got, want[0] if training else want) < TOL


def test_encoder_helm2_matches_jax():
    """3 x 70 snapshots leave a (2, 2) map: ``fc`` takes its 4 x 8 features in flax's
    channel-last order, the in-features worked out from ``input_size``."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 3, 70)).astype(np.float32)
    jmodel = jcnn.EncoderHelm2(5, 4, 6, 8)
    variables = seeded_variables(jmodel, rng, x)
    model = cnn.EncoderHelm2(5, (3, 70), (4, 6, 8)).eval()
    assert model.out_features == 4 * 8
    model.load_state_dict(sub_state("EncoderHelm2_0", variables, "deeponet.branch."))
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert _scale_err(got, jmodel.apply(variables, jnp.asarray(x))) < TOL
    with pytest.raises(ValueError, match="leaves no point"):
        cnn.EncoderHelm2(5, (3, 48), (4, 6, 8))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("norm", ["bn", "ln", "in"])
def test_conv_block_norms_match_jax(norm, ndim):
    """``ConvBlock`` with BatchNorm (randomized statistics, eval mode), flax's LayerNorm
    over the channels (a randomized scale and bias) or the instance norm, in 1-, 2- and
    3-D."""
    rng = np.random.default_rng(3)
    spatial = (9, 7, 6)[:ndim]
    x = rng.standard_normal((2, 3, *spatial)).astype(np.float32)
    jmodel = jcnn.ConvBlock(5, (3,) * ndim, (2,) * ndim, 1, norm=norm)
    variables = seeded_variables(jmodel, rng, _channel_last(x))
    model = cnn.ConvBlock(3, 5, 3, 2, 1, torch.Generator(), ndim=ndim, norm=norm).eval()
    model.load_state_dict(_block_state(variables))
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert _scale_err(got, _run(jmodel, variables, _channel_last(x), False)) < TOL


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("block", ["tanh", "deconv", "resize"])
def test_blocks_match_jax(block, training, monkeypatch):
    """``ConvBlockTanh``, ``DeconvBlock`` (the transposed conv's flip, output padding
    zeros) and ``ResizeBlock`` (nearest upsampling by 2), 2-D, BatchNorm randomized
    (eval) or on batch statistics (train, flax's two-pass variance)."""
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 7, 6)).astype(np.float32)
    g = torch.Generator()
    if block == "tanh":
        jmodel, model = jcnn.ConvBlockTanh(5, (3, 3), None, 1), cnn.ConvBlockTanh(3, 5, 3, 1, 1, g)
    elif block == "deconv":
        jmodel = jcnn.DeconvBlock(5, (2, 3), (2, 2), (1, 0))
        model = cnn.DeconvBlock(3, 5, g, (2, 3), (2, 2), (1, 0))
    else:
        jmodel, model = jcnn.ResizeBlock(5), cnn.ResizeBlock(3, 5, g)
    variables = seeded_variables(jmodel, rng, _channel_last(x))
    if block == "deconv":
        wrap = {"TorchConvTranspose_0": variables["params"]["TorchConvTranspose_0"],
                "TorchBatchNorm_0": variables["params"]["TorchBatchNorm_0"]}
        state = from_flax(wrap, variables["batch_stats"])
        state = {k.replace("transposes.0.", "deconv.").replace("skip_norms.0.", "bn."): v
                 for k, v in state.items()}
    else:
        state = _block_state(variables)
    model.load_state_dict(state)
    model.train(training)
    with torch.no_grad():
        got = model(torch.tensor(x))
    want = _run(jmodel, variables, _channel_last(x), training)
    assert got.shape == want.shape
    assert _scale_err(got, want) < TOL


ACTIVATIONS = ["tanh", "relu", "leaky_relu", "sigmoid", "softplus", "celu", "elu", "swish",
               "mish", "sin"]


@pytest.mark.parametrize("name", ACTIVATIONS)
def test_activation_matches_jax(name):
    """Each of the ten on [-6, 6] and at 0, within 1e-6 absolute; any case of the name."""
    x = np.concatenate([np.linspace(-6.0, 6.0, 241), [0.0]]).astype(np.float32)
    want = np.asarray(jdeeponet.activation(name)(jnp.asarray(x)))
    got = deeponet.activation(name.upper())(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_activation_table_is_complete_and_refuses_other_names():
    assert set(deeponet._ACTIVATIONS) == set(ACTIVATIONS)
    with pytest.raises(ValueError, match="Unknown activation"):
        deeponet.activation("gelu")


def test_fourier_features_match_jax():
    """``B`` carried over from flax: the same sin and cos features."""
    rng = np.random.default_rng(5)
    x = rng.random((7, 2)).astype(np.float32)
    jmodel = jdeeponet.FourierFeatures(scale=3.0, mapping_size=6)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    model = deeponet.FourierFeatures(3.0, 6)
    assert model.B.shape == (6, 2)
    model.load_state_dict({"B": torch.tensor(np.asarray(variables["params"]["B"]))})
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert got.shape == (7, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(jmodel.apply(variables, jnp.asarray(x))),
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("act", ["tanh", "sin", "softplus"])
def test_feed_forward_nn_matches_jax(act, monkeypatch):
    """``FeedForwardNN`` with its dropout off, in train mode (batch statistics) and in
    eval mode (randomized statistics; first, before train mode moves the port's), flax's
    BatchNorm with its two-pass variance (:class:`~test_torch_train._TwoPassBatchNorm`)."""
    monkeypatch.setattr(flax.linen, "BatchNorm", _TwoPassBatchNorm)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((12, 2)).astype(np.float32)
    jmodel = jdeeponet.FeedForwardNN(2, 3, 3, 16, act_string=act)
    variables = seeded_variables(jmodel, rng, x)
    model = deeponet.FeedForwardNN(2, 3, 3, 16, act_string=act)
    wrap = lambda t: {"FFN_0": t["FFN_0"]}
    state = from_flax(wrap(variables["params"]), wrap(variables["batch_stats"]))
    model.load_state_dict({k[len("deeponet.trunk."):]: v for k, v in state.items()})
    for training in (False, True):
        model.train(training)
        want = jmodel.apply(variables, jnp.asarray(x), training=training,
                            mutable=["batch_stats"] if training else False)
        with torch.no_grad():
            got = model(torch.tensor(x))
        assert _scale_err(got, want[0] if training else want) < TOL


def test_ffn_dropout_draws_from_the_generator():
    """Train-mode dropout: the same generator state, the same mask; another, another;
    kept units scaled by 1 / (1 - rate) (the rate of zeros near 0.5); none without a
    generator, and none in eval mode."""
    x = torch.randn(64, 2, generator=torch.Generator().manual_seed(0))
    model = deeponet.FFN(2, 3, 3, 200, act_string="relu", dropout_rate=0.5).train()
    draw = lambda seed: model(x, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        a, b, c = draw(0), draw(0), draw(1)
        assert torch.equal(a, b) and not torch.equal(a, c)
        h = model.layers[1](model.act(model.layers[0](x)))
        dropped = model._dropout(h, torch.Generator().manual_seed(2))
        zero = dropped == 0
        assert 0.4 < zero.float().mean() < 0.6
        torch.testing.assert_close(dropped[~zero], 2 * h[~zero])
        with pytest.raises(ValueError, match="Generator"):
            model(x)
        model.eval()
        torch.testing.assert_close(model(x), model(x, torch.Generator().manual_seed(3)))
