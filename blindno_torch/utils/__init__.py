"""Initializers with PyTorch-default semantics, and metrics logging and tracing."""
