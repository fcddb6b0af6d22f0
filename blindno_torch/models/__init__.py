"""Composite set-to-field models."""


def check_eval_only(name, training, module):
    """The models run in eval mode only until the training slice lands: raise when asked
    to train or when ``module`` is in train mode."""
    if training or module.training:
        raise NotImplementedError(f"{name} runs in eval mode only; training (set "
                                  "subsampling, batch-statistics BN, the backward) comes "
                                  "with the training slice")
