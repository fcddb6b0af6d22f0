"""Suite registry (counterpart of ``blindno/suites/registry.py``): the (suite x model)
configurations the port trains and evaluates, with the JAX package's hyperparameters.

The two 2-D suites are ported: fpe2d with its NIO, FNO-branch NIO, the two attention NIOs
and the BlinDNO UNet, and ncfpe2d with its NIO, FNO-branch NIO and plain-block UNet.
:data:`NOT_PORTED` names the ``ROADMAP.md`` item of every other suite, model and stage of
the JAX CLI.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np

from blindno_torch.data.datasets import load_fpe2d, load_ncfpe2d
from blindno_torch.models.blindno_unet import PermInvUNetAttn
from blindno_torch.models.nio2d import NIOAttn2D, NIOFNO2D, NIOFNOAttn2D, NIOFP2D
from blindno_torch.train.loop import TrainConfig


def _grid_2d(n):
    gx, gy = np.meshgrid(
        np.linspace(-1, 1, n, dtype=np.float32), np.linspace(-1, 1, n, dtype=np.float32), indexing="ij"
    )
    return np.stack([gx, gy], axis=2)


@dataclass
class SuiteSpec:
    """``models`` maps a name to a factory taking the model's ``generator`` and
    ``device`` keywords."""

    name: str
    grid: np.ndarray
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

# What the JAX CLI runs and the port does not yet, with its ROADMAP.md item.
NOT_PORTED = {
    "suites": {"fpe1d": "A.7", "schrodinger1d": "A.7", "gpe1d": "A.7", "gpe1d_vgk": "A.7"},
    "models": {"fpe2d": {"trans": "A.6", "trans_attn": "A.6"}},
    "stages": {"datagen": "A.8", "time-error": "A.8"},
}


def _register(spec: SuiteSpec):
    SUITES[spec.name] = spec
    return spec


# ---------------------------------------------------------------- 2D FPE
# blindno/suites/registry.py:186-220: the DDP-equivalent global batch 16 at the
# reference's lr 5e-4, StepLR(100, 0.5), 400 epochs, eval every 5; bfloat16 input
# storage (m=8000 is 11.9 GB in float32) and D4 augmentation
_register(
    SuiteSpec(
        name="fpe2d",
        grid=_grid_2d(61),
        loader=load_fpe2d,
        models={
            "nio": lambda **kw: NIOFP2D(width=12, modes=32, encoder_final_kernel=(2, 1), **kw),
            "fno": lambda **kw: NIOFNO2D(width=12, modes=32, **kw),
            "unet": lambda **kw: PermInvUNetAttn(input_size=(61, 61), depth=4, width=12,
                                                 fno_modes=32, head_dims=(1, 1), subsample=True,
                                                 **kw),
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
