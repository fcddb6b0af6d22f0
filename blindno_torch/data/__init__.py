"""Datasets: loaders, normalization statistics, the split and eval batches."""
