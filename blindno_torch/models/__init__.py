"""Composite set-to-field models."""


def check_eval_only(name, training, module):
    """The 1-D models run in eval mode only until 1-D training lands (the FNO1d layer's
    backward): raise when asked to train or when ``module`` is in train mode."""
    if training or module.training:
        raise NotImplementedError(f"{name} runs in eval mode only; 1-D training (the FNO1d "
                                  "layer's backward) comes with a later training slice")
