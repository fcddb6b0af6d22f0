"""Training: the step of ``bench.py`` and its mixed-precision mode."""
