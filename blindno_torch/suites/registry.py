"""Suite registry (counterpart of ``blindno/suites/registry.py``): the (suite x model)
configurations the port trains and evaluates, with the JAX package's hyperparameters.

Every suite and model of the JAX registry is here: the four 1-D suites (fpe1d,
schrodinger1d, gpe1d, gpe1d_vgk) with their NIO, FNO-branch NIO and BlinDNO UNets; fpe2d
with its NIO, FNO-branch NIO, the two Transolver NIOs, the two attention NIOs and the
BlinDNO UNet; and ncfpe2d with its NIO, FNO-branch NIO and plain-block UNet. Each suite's
``datagen_train`` and ``datagen_test`` make its archives (``blindno_torch.data.generate``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from blindno_torch.data import generate as G
from blindno_torch.data.datasets import load_fpe1d, load_fpe2d, load_gpe1d, load_ncfpe2d
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.models.nio1d import NIOFNO1D, NIOFP1D, NIOFPOde
from blindno_torch.models.nio2d import (NIOAttn2D, NIOFNO2D, NIOFNOAttn2D, NIOFP2D,
                                        NIOTrans2D, NIOTransAttn2D)
from blindno_torch.nn.cnn import ENC_FPE80, ENC_GPE128
from blindno_torch.train.loop import TrainConfig


def _grid_1d(n):
    return np.linspace(0.0, 1.0, n, dtype=np.float32).reshape(n, 1)


def _grid_2d(n):
    gx, gy = np.meshgrid(
        np.linspace(-1, 1, n, dtype=np.float32), np.linspace(-1, 1, n, dtype=np.float32), indexing="ij"
    )
    return np.stack([gx, gy], axis=2)


@dataclass
class SuiteSpec:
    """``models`` maps a name to a factory taking the model's ``generator`` and
    ``device`` keywords; ``datagen_train`` and ``datagen_test`` take ``(seed, m)`` and a
    ``device`` keyword and return an archive's dict."""

    name: str
    grid: np.ndarray
    datagen_train: Callable  # (seed, m, device=...) -> dict
    datagen_test: Callable
    loader: Callable  # dict -> SetToFieldData
    models: dict
    train_cfg: TrainConfig
    m_train: int
    m_test: int
    train_file: str = ""
    test_file: str = ""

    def __post_init__(self):
        self.train_file = self.train_file or f"{self.name}_train.npz"
        self.test_file = self.test_file or f"{self.name}_test.npz"


SUITES: dict[str, SuiteSpec] = {}

# Models the reference defines but no script trains (``blindno/suites/registry.py:62-69``):
# no suite's archive has their ODE-observation input (B, L, 11), so no SuiteSpec and no
# CLI choice names them. Factories take ``generator`` and ``device`` as a suite's do.
VESTIGIAL_MODELS: dict[str, Callable] = {
    "nio_ode": lambda **kw: NIOFPOde(**kw),
}


def _register(spec: SuiteSpec):
    SUITES[spec.name] = spec
    return spec


# ---------------------------------------------------------------- 1D FPE
# blindno/suites/registry.py:77-107: batch 32, lr 1e-3, StepLR(100, 0.5), 400 epochs, eval
# every 10, the parity flip; the bag UNet of depth 5 and the full-set UNet of depth 6
_register(
    SuiteSpec(
        name="fpe1d",
        grid=_grid_1d(80),
        datagen_train=G.generate_fpe1d,
        datagen_test=G.generate_fpe1d,
        loader=load_fpe1d,
        models={
            "nio": lambda **kw: NIOFP1D(width=30, modes=15, encoder_final_convs=ENC_FPE80, **kw),
            "fno": lambda **kw: NIOFNO1D(width=30, modes=15, **kw),
            "unet": lambda **kw: PermInvUNetAttn(input_size=(80,), depth=5, width=30,
                                                 fno_modes=15, head_dims=(1, 1), subsample=True,
                                                 **kw),
            "unet_nobag": lambda **kw: PermInvUNetAttn(input_size=(80,), depth=6, width=30,
                                                       fno_modes=15, head_dims=(1, 1),
                                                       subsample=False, **kw),
        },
        train_cfg=TrainConfig(epochs=400, batch_size=32, lr=1e-3, save_interval=10,
                              augment="flip1d"),
        m_train=8000,
        m_test=100,
    )
)

# ---------------------------------------------------------------- 1D Schrodinger (g = kappa = 0)
# blindno/suites/registry.py:109-133: width 10, 30 modes, 128 points, V over a third of
# the maxima
_register(
    SuiteSpec(
        name="schrodinger1d",
        grid=_grid_1d(128),
        datagen_train=lambda seed, m, **kw: G.generate_gpe1d(seed, m, g=0.0, kappa=0.0, **kw),
        datagen_test=lambda seed, m, **kw: G.generate_gpe1d(seed, m, g=0.0, kappa=0.0, **kw),
        loader=lambda d: load_gpe1d(d, thirds=True, include_gk=False),
        models={
            "nio": lambda **kw: NIOFP1D(width=10, modes=30, head_dims=(1,),
                                        encoder_final_convs=ENC_GPE128, **kw),
            "fno": lambda **kw: NIOFNO1D(width=10, modes=30, head_dims=(1,), **kw),
            "unet": lambda **kw: PermInvUNetAttn(input_size=(128,), depth=4, width=10,
                                                 fno_modes=30, head_dims=(1,), subsample=True,
                                                 **kw),
        },
        train_cfg=TrainConfig(epochs=400, batch_size=32, lr=1e-3, save_interval=10,
                              augment="flip1d"),
        m_train=6000,
        m_test=1200,
    )
)

# ---------------------------------------------------------------- 1D GPE (g = kappa = 2)
# blindno/suites/registry.py:135-159: width 20, 40 modes
_register(
    SuiteSpec(
        name="gpe1d",
        grid=_grid_1d(128),
        datagen_train=lambda seed, m, **kw: G.generate_gpe1d(seed, m, g=2.0, kappa=2.0, **kw),
        datagen_test=lambda seed, m, **kw: G.generate_gpe1d(seed, m, g=2.0, kappa=2.0, **kw),
        loader=lambda d: load_gpe1d(d, thirds=True, include_gk=False),
        models={
            "nio": lambda **kw: NIOFP1D(width=20, modes=40, head_dims=(1,),
                                        encoder_final_convs=ENC_GPE128, **kw),
            "fno": lambda **kw: NIOFNO1D(width=20, modes=40, head_dims=(1,), **kw),
            "unet": lambda **kw: PermInvUNetAttn(input_size=(128,), depth=4, width=20,
                                                 fno_modes=40, head_dims=(1,), subsample=True,
                                                 **kw),
        },
        train_cfg=TrainConfig(epochs=400, batch_size=32, lr=1e-3, save_interval=10,
                              augment="flip1d"),
        m_train=6000,
        m_test=1200,
    )
)

# ---------------------------------------------------------------- 1D GPE with (V, g, kappa) heads
# blindno/suites/registry.py:161-182: 4 layers, width 25, 32 modes, 1000 epochs, plain
# maxima; it trains on the gpe1d suite's archives (the same g = kappa = 2 orbits)
_register(
    SuiteSpec(
        name="gpe1d_vgk",
        grid=_grid_1d(128),
        datagen_train=lambda seed, m, **kw: G.generate_gpe1d(seed, m, g=2.0, kappa=2.0, **kw),
        datagen_test=lambda seed, m, **kw: G.generate_gpe1d(seed, m, g=2.0, kappa=2.0, **kw),
        loader=lambda d: load_gpe1d(d, thirds=False, include_gk=True),
        models={
            "nio": lambda **kw: NIOFP1D(width=25, modes=32, fno_layers=4, head_dims=(1, 2),
                                        encoder_final_convs=ENC_GPE128, **kw),
        },
        train_cfg=TrainConfig(epochs=1000, batch_size=32, lr=1e-3, save_interval=10,
                              augment="flip1d"),
        m_train=6000,
        m_test=1200,
        train_file="gpe1d_train.npz",
        test_file="gpe1d_test.npz",
    )
)

# ---------------------------------------------------------------- 2D FPE
# blindno/suites/registry.py:186-220: the DDP-equivalent global batch 16 at the
# reference's lr 5e-4, StepLR(100, 0.5), 400 epochs, eval every 5; bfloat16 input
# storage (m=8000 is 11.9 GB in float32) and D4 augmentation
_register(
    SuiteSpec(
        name="fpe2d",
        grid=_grid_2d(61),
        datagen_train=G.generate_fpe2d,
        datagen_test=G.generate_fpe2d,
        loader=load_fpe2d,
        models={
            "nio": lambda **kw: NIOFP2D(width=12, modes=32, encoder_final_kernel=(2, 1), **kw),
            "fno": lambda **kw: NIOFNO2D(width=12, modes=32, **kw),
            "unet": lambda **kw: PermInvUNetAttn(input_size=(61, 61), depth=4, width=12,
                                                 fno_modes=32, head_dims=(1, 1), subsample=True,
                                                 **kw),
            "trans": lambda **kw: NIOTrans2D(width=12, modes=32, **kw),
            "trans_attn": lambda **kw: NIOTransAttn2D(width=12, modes=32, **kw),
            "fno_attn": lambda **kw: NIOFNOAttn2D(width=12, modes=32, **kw),
            "attn": lambda **kw: NIOAttn2D(width=12, modes=32, encoder_final_kernel=(2, 1), **kw),
        },
        train_cfg=TrainConfig(epochs=400, batch_size=16, lr=5e-4, save_interval=5,
                              compress_inputs=True, augment="d4_scalar"),
        m_train=8000,
        m_test=400,
    )
)

# ---------------------------------------------------------------- 2D non-conservative FPE
# blindno/suites/registry.py:222-253: batch 4 at lr 5e-4, 80x80, m=2400; the UNet of depth
# 5 with plain blocks; C4 rotations of the force field (the spiral family is axisymmetric)
_register(
    SuiteSpec(
        name="ncfpe2d",
        grid=_grid_2d(80),
        datagen_train=G.generate_ncfpe2d,
        datagen_test=G.generate_ncfpe2d,
        loader=load_ncfpe2d,
        models={
            "nio": lambda **kw: NIOFP2D(width=12, modes=32, encoder_final_kernel=(3, 2), **kw),
            "fno": lambda **kw: NIOFNO2D(width=12, modes=32, **kw),
            "unet": lambda **kw: PermInvUNetAttn(input_size=(80, 80), depth=5, width=12,
                                                 fno_modes=32, head_dims=(1, 1), subsample=True,
                                                 block="plain", **kw),
        },
        train_cfg=TrainConfig(epochs=400, batch_size=4, lr=5e-4, save_interval=5,
                              augment="c4_vector"),
        m_train=2400,
        m_test=400,
    )
)
