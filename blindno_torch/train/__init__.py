"""Training: the step of ``bench.py``, the epoch loop, its schedule and augmentation, and checkpoints."""
