"""Composite set-to-field models."""
